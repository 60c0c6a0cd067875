"""Mesh-sharded generation, twin of ``ml_conformer_generator_tpu/parallel/sampler.py``.

The whole reverse-diffusion sampler runs on every rank of the mesh: the
sample batch is split along ``data`` and every graph's (N, N) edge set
along ``edge`` (:mod:`.edge_shard`), with the per-layer j-aggregation
completed by an all-reduce over the edge row. The functions take and return
GLOBAL tensors, as JAX's do: each rank cuts its batch shard and its edge
slab, samples, and gathers (x, h) over the data axis.

Draws: ranks of one data row draw the same stream (they hold the same
samples' different edge slabs); data rows draw independent streams
(:func:`data_stream`, the counterpart of JAX's ``fold_in`` of the data
index).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import DiffusionConfig, EGNNConfig
from ..diffusion.edm import EDMSampler
from ..utils.metrics import span
from .edge_shard import dynamics_forward_sharded
from .mesh import Mesh, data_sharding

__all__ = ["ShardedEDMSampler", "all_gather_data", "data_stream",
           "make_sharded_generate", "make_sharded_inpaint",
           "make_sharded_merge"]

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def data_stream(generator: torch.Generator, data_index: int,
                device) -> torch.Generator:
    """The draws of data row ``data_index``: one draw of a 62-bit base seed
    from ``generator`` (which advances it, the same on every rank whose
    generator is in the same state), then a generator on ``device`` seeded
    with splitmix64((base << 20 | data_index) mod 2^64), cut to 63 bits.
    Distinct data rows (< 2^20) get distinct seeds."""
    if not 0 <= data_index < 1 << 20:
        raise ValueError(f"data index {data_index} out of range")
    with span("mlcg.train.seed_sync"):
        base = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                 device=generator.device).item())
    seed = _splitmix64(((base << 20) | data_index) & _MASK64) >> 1
    return torch.Generator(device=device).manual_seed(seed)


def all_gather_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's batch shard gathered over the data axis into the global
    batch (shards in data order); the identity on a data axis of size 1."""
    if mesh.n_data == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts, dim=0)


class ShardedEDMSampler(EDMSampler):
    """EDMSampler whose denoiser is the edge-sharded EGNN (``edge_mask``
    arguments are the local j-column slab)."""

    # The trajectories stay the loop, on the card too: every forward
    # all-reduces over the edge row through gloo, which stages CUDA tensors
    # through the host and cannot be captured into a CUDA graph.
    _graphed = False

    def __init__(self, dynamics, diff_cfg: DiffusionConfig, mesh: Mesh,
                 egnn_cfg: Optional[EGNNConfig] = None):
        super().__init__(dynamics, diff_cfg)
        self.mesh = mesh
        self.egnn_cfg = egnn_cfg

    def phi(self, z, t, node_mask, edge_mask_l, context):
        return dynamics_forward_sharded(self.dynamics, t, z, node_mask,
                                        edge_mask_l, context, self.egnn_cfg,
                                        self.mesh)


def _shard(mesh: Mesh, generator, node_mask, edge_mask, *batched):
    """This rank's data stream and its shards of the global inputs."""
    rows = data_sharding(mesh)
    return (data_stream(generator, mesh.data_index, mesh.device),
            rows(node_mask), data_sharding(mesh, None, "edge")(edge_mask),
            *(rows(t) for t in batched))


def _gather(mesh: Mesh, x, h):
    return all_gather_data(x, mesh), all_gather_data(h, mesh)


def make_sharded_generate(mesh: Mesh, egnn_cfg: EGNNConfig,
                          diff_cfg: DiffusionConfig, resample_steps: int = 0):
    """The sharded sampler.

    Returns ``fn(dynamics, generator, gamma, node_mask, edge_mask, context,
    dtype=torch.float32) -> (x, h)`` taking GLOBAL tensors: node_mask (B,
    N, 1), edge_mask (B, N, N, 1), context (B, N, C); B must divide over
    the data axis and N over the edge axis. ``dynamics``: the
    :class:`EGNNDynamics` on the mesh's device, the same weights on every
    rank; ``generator`` in the same state on every rank; ``gamma`` the (T+1,)
    CPU schedule.
    """
    def fn(dynamics, generator, gamma, node_mask, edge_mask, context,
           dtype=torch.float32):
        gen, nm, em, ctx = _shard(mesh, generator, node_mask, edge_mask,
                                  context)
        sampler = ShardedEDMSampler(dynamics, diff_cfg, mesh, egnn_cfg)
        return _gather(mesh, *sampler.generate(
            gen, gamma, nm, em, ctx, resample_steps=resample_steps,
            dtype=dtype))

    return fn


def make_sharded_inpaint(mesh: Mesh, egnn_cfg: EGNNConfig,
                         diff_cfg: DiffusionConfig, resample_steps: int = 1,
                         blend_power: int = 3):
    """Sharded fragment inpainting (reference ``equivariant_diffusion.py:423``).

    Returns ``fn(dynamics, generator, gamma, node_mask, edge_mask, context,
    z_known, fixed_mask, dtype=torch.float32) -> (x, h)`` over GLOBAL
    tensors; sharding as in :func:`make_sharded_generate`, with the
    fragment latent and fixed mask batch-sharded along ``data``.
    """
    def fn(dynamics, generator, gamma, node_mask, edge_mask, context,
           z_known, fixed_mask, dtype=torch.float32):
        gen, nm, em, ctx, zk, fm = _shard(mesh, generator, node_mask,
                                          edge_mask, context, z_known,
                                          fixed_mask)
        sampler = ShardedEDMSampler(dynamics, diff_cfg, mesh, egnn_cfg)
        return _gather(mesh, *sampler.inpaint(
            gen, gamma, nm, em, ctx, zk, fm, resample_steps=resample_steps,
            blend_power=blend_power, dtype=dtype))

    return fn


def make_sharded_merge(mesh: Mesh, egnn_cfg: EGNNConfig,
                       diff_cfg: DiffusionConfig, diffusion_level: int = 50,
                       resample_steps: int = 1, blend_power: int = 3):
    """Sharded fragment merging (reference ``equivariant_diffusion.py:515``).

    Returns ``fn(dynamics, generator, gamma, node_mask, edge_mask,
    fixed_mask, context, z_known, dtype=torch.float32) -> (x, h)`` over
    GLOBAL tensors (the IFM merge stage).
    """
    def fn(dynamics, generator, gamma, node_mask, edge_mask, fixed_mask,
           context, z_known, dtype=torch.float32):
        gen, nm, em, fm, ctx, zk = _shard(mesh, generator, node_mask,
                                          edge_mask, fixed_mask, context,
                                          z_known)
        sampler = ShardedEDMSampler(dynamics, diff_cfg, mesh, egnn_cfg)
        return _gather(mesh, *sampler.merge_fragments(
            gen, gamma, nm, em, fm, ctx, zk,
            diffusion_level=diffusion_level, resample_steps=resample_steps,
            blend_power=blend_power, dtype=dtype))

    return fn
