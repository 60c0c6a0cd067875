"""Ahead-of-time export of the port's compilation units (``torch.export``).

Twin of ``ml_conformer_generator_tpu/export.py``: the same three units, the
EGNN denoiser, the whole T-step sampler and the bond predictor (AdjMatSeer),
exported as ``torch.export`` programs and saved as ``.pt2`` files, which a
process loads and runs without the model code
(:class:`~ml_conformer_generator_tpu_torch.generator_aot.MLConformerGeneratorAOT`).

* ``export_denoiser``: one eps-prediction step, its weights an input (a
  flat dict under the port's state-dict names);
* ``export_sampler``: the T reverse steps as ONE ``scan`` over a (T, 4)
  table of the steps' schedule scalars (JAX: ``lax.scan``), then the decode.
  The loop is not unrolled, so the export takes the same time whatever T
  is. JAX's sampler takes a PRNG key; a ``torch.Generator`` is not a value
  a program can take, so the port's takes its noise: ``draws`` (T + 2, B,
  N, 3 + atom classes) of standard normals, in the eager sampler's order
  (the initial latent, the T steps, the decode), masked and centred in the
  program as :meth:`~.diffusion.edm.EDMSampler.sample_noise` does.

The fused edge pass is the registered op ``mlcg_torch::fused_edge_pass``
(``ops/gcl_kernel.py``), one graph node per pass; on the card the loaded
program launches the Hopper kernels through it. A program runs on the
device type it was exported on (its weights and constants live there);
:func:`export_generator_artifacts` writes that type into the manifest and
the AOT generator refuses another, as JAX's ``Exported`` refuses a platform
it was not exported for.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional

import torch
from torch import nn
from torch._higher_order_ops.scan import scan

from .config import AdjMatSeerConfig, DiffusionConfig, EGNNConfig
from .diffusion.edm import (decode_scalars, decode_xh, mask_noise,
                            reverse_step, step_scalars, time_array)
from .diffusion.schedule import gamma_schedule
from .ops import gcl_kernel  # noqa: F401  (registers the edge pass op)

__all__ = [
    "export_denoiser", "export_sampler", "export_adj_mat_seer",
    "save_exported", "load_exported", "export_generator_artifacts",
]

_MANIFEST = "manifest.json"


class _Program(nn.Module):
    """One unit as a program: ``forward(params, *inputs)``, ``params`` a
    dict under ``module``'s state-dict names, or ``forward(*inputs)`` when
    ``bake`` makes the weights the program's constants (buffers here).
    Either way the module runs through ``functional_call``; ``run(net,
    *inputs, **tables)`` says what the unit does with it (default: call
    it), ``tables`` are CPU buffers it reads."""

    def __init__(self, module: nn.Module, bake: bool, run=None, **tables):
        super().__init__()
        self._module = (module,)        # not a submodule: holds no weights
        self._baked = list(module.state_dict()) if bake else None
        for i, w in enumerate(module.state_dict().values() if bake else ()):
            self.register_buffer(f"w{i}", w)
        for name, table in tables.items():
            self.register_buffer(name, table)
        self._tables = list(tables)
        self._run = run

    def forward(self, *inputs):
        if self._baked is None:
            params, *inputs = inputs
        else:
            params = {k: getattr(self, f"w{i}")
                      for i, k in enumerate(self._baked)}

        def net(*args):
            return torch.func.functional_call(self._module[0], params, args)

        if self._run is None:
            return net(*inputs)
        return self._run(net, *inputs,
                         **{k: getattr(self, k) for k in self._tables})


def _sample(net, draws, node_mask, edge_mask, context, *, schedule, decode,
            diff_cfg: DiffusionConfig):
    """The reverse loop as one ``scan`` over ``schedule``'s rows and the
    steps' draws, then the decode."""
    nd = diff_cfg.n_dims
    B = node_mask.shape[0]
    dtype = schedule.dtype

    def denoise(z, t):
        return net(t, z, node_mask, edge_mask, context)

    def step(z, xs):
        row, raw = xs
        eps_t = denoise(z, time_array(row[0], B, dtype, z.device))
        z = reverse_step(z, eps_t, mask_noise(raw, node_mask, nd),
                         row[1], row[2], row[3], node_mask, nd)
        return z, ()

    z = mask_noise(draws[0], node_mask, nd)
    z, _ = scan(step, z, (schedule, draws[1:-1]))
    net_out = denoise(z, torch.zeros((B,), dtype=dtype, device=z.device))
    return decode_xh(z, net_out, mask_noise(draws[-1], node_mask, nd),
                     *decode, node_mask, diff_cfg)


def _check_cfg(dynamics, cfg: EGNNConfig) -> None:
    """The programs run ``dynamics`` under its own config; ``cfg`` (kept
    for JAX's signature) must be that config."""
    if cfg != dynamics.cfg:
        raise ValueError(f"cfg {cfg} is not the module's config "
                         f"{dynamics.cfg}")


def _where(module: nn.Module):
    """The module's device and the type of the tensors it takes: float64
    for a float64 module, else float32 (the bf16 denoiser's geometry and
    latent stay float32)."""
    p = next(module.parameters())
    return p.device, (torch.float64 if p.dtype == torch.float64
                      else torch.float32)


def _export(program: nn.Module, args) -> torch.export.ExportedProgram:
    """Inference export: nothing requires grad, so every edge pass traces as
    the registered op. The nodes' stack traces are dropped: in the scan's
    body each held the whole scan call, which made the sampler's file
    hundreds of times larger than its graph. The example inputs stay (for
    the denoiser a copy of its weights): the loaded program matches a
    weights dict given in another key order through them."""
    with torch.no_grad():
        exp = torch.export.export(program.eval(), tuple(args))
    for gm in exp.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                node.meta.pop("stack_trace", None)
    return exp


def export_denoiser(dynamics, cfg: EGNNConfig, batch: int, n_nodes: int
                    ) -> torch.export.ExportedProgram:
    """Export one eps-prediction step: (params, t, xh, node_mask, edge_mask,
    context) -> eps, with ``params`` the plain dict
    ``dict(dynamics.state_dict())`` (JAX :56-72; the reference's EGNN ONNX
    unit's named I/O). The inputs are float32 (float64 for a float64
    module), on the module's device.
    """
    _check_cfg(dynamics, cfg)
    dev, dt = _where(dynamics)
    B, N = batch, n_nodes
    nf = cfg.n_dims + cfg.in_node_nf - 1
    z = dict(device=dev, dtype=dt)
    return _export(_Program(dynamics, bake=False), (
        dict(dynamics.state_dict()), torch.zeros(B, **z), torch.zeros(B, N, nf, **z),
        torch.ones(B, N, 1, **z), torch.ones(B, N, N, 1, **z),
        torch.zeros(B, N, cfg.context_node_nf, **z)))


def export_sampler(dynamics, egnn_cfg: EGNNConfig, diff_cfg: DiffusionConfig,
                   batch: int, n_nodes: int, bake_params: bool = False
                   ) -> torch.export.ExportedProgram:
    """Export the T-step reverse-diffusion sampler and the decode as one
    program: (params, draws, node_mask, edge_mask, context) -> (x, h), or
    without ``params`` when ``bake_params`` makes the weights program
    constants (JAX :75-106). ``draws``: (T + 2, B, N, n_dims + atom classes)
    standard normals. The latent is float32 (float64 for a float64 module),
    as ``EDMSampler.generate`` takes it from the generator.
    """
    _check_cfg(dynamics, egnn_cfg)
    dev, dt = _where(dynamics)
    B, N, T = batch, n_nodes, diff_cfg.timesteps
    gamma = torch.from_numpy(gamma_schedule(T, diff_cfg.noise_precision,
                                            diff_cfg.schedule_power))
    # One row per reverse step, in the loop's order (s = T-1 .. 0); the
    # table stays on the CPU, so that each step's 0-d scalars reach the
    # device arithmetic as the eager loop's Python floats do, and in
    # float64, which holds each of them exactly (the reciprocals are
    # rounded for the latent's type, not gamma's).
    schedule = torch.tensor([step_scalars(gamma, s, T, dt)
                             for s in range(T - 1, -1, -1)],
                            dtype=torch.float64)
    program = _Program(dynamics, bake_params,
                       functools.partial(_sample,
                                         decode=decode_scalars(gamma, dt),
                                         diff_cfg=diff_cfg),
                       schedule=schedule)
    z = dict(device=dev, dtype=dt)
    args = [torch.zeros(T + 2, B, N, diff_cfg.n_dims + diff_cfg.in_node_nf,
                        **z),
            torch.ones(B, N, 1, **z), torch.ones(B, N, N, 1, **z),
            torch.zeros(B, N, egnn_cfg.context_node_nf, **z)]
    params = [] if bake_params else [dict(dynamics.state_dict())]
    return _export(program, params + args)


def export_adj_mat_seer(model, cfg: AdjMatSeerConfig, batch: int,
                        bake_params: bool = False
                        ) -> torch.export.ExportedProgram:
    """Export the bond predictor: ([params,] elements, dist_mat, adj_mat) ->
    logits, elements int64 (JAX :109-126; reference unit
    ``onnx_export_utils.py:114-153``)."""
    dev, dt = _where(model)
    B, D = batch, cfg.dimension
    args = [torch.zeros(B, D, dtype=torch.int64, device=dev),
            torch.ones(B, D, D, dtype=dt, device=dev),
            torch.ones(B, D, D, dtype=dt, device=dev)]
    params = [] if bake_params else [dict(model.state_dict())]
    return _export(_Program(model, bake_params), params + args)


def save_exported(exp: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exp, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """A saved program; call it through ``.module()``."""
    return torch.export.load(path)


def export_generator_artifacts(generator, out_dir: str, batch: int = 32,
                               n_nodes: Optional[int] = None
                               ) -> Dict[str, str]:
    """Export a generator's sampler (weights baked), denoiser and bond
    predictor (weights baked) to ``out_dir`` as ``.pt2`` files with a
    manifest (JAX :139-181; reference ``onnx_export.py:10-43``).

    The manifest has JAX's keys, plus ``device``, the device type the
    programs were exported on and run on, and ``draws``, the shape of the
    sampler's noise input.
    """
    os.makedirs(out_dir, exist_ok=True)
    egnn_cfg: EGNNConfig = generator.egnn_cfg
    diff_cfg: DiffusionConfig = generator.diff_cfg
    dynamics = generator.sampler.dynamics
    N = n_nodes or generator.dimension

    paths = {
        "sampler": os.path.join(out_dir, "edm_sampler.pt2"),
        "denoiser": os.path.join(out_dir, "egnn_denoiser.pt2"),
        "adj_mat_seer": os.path.join(out_dir, "adj_mat_seer.pt2"),
    }
    save_exported(export_sampler(dynamics, egnn_cfg, diff_cfg, batch, N,
                                 bake_params=True), paths["sampler"])
    save_exported(export_denoiser(dynamics, egnn_cfg, batch, N),
                  paths["denoiser"])
    save_exported(export_adj_mat_seer(generator.adj_model, generator.adj_cfg,
                                      batch, bake_params=True),
                  paths["adj_mat_seer"])

    manifest = {
        "batch": batch,
        "n_nodes": N,
        "baked_params": ["sampler", "adj_mat_seer"],
        "min_n_nodes": generator.min_n_nodes,
        "max_n_nodes": generator.max_n_nodes,
        "diffusion_steps": generator.diffusion_steps,
        "egnn": {"hidden_nf": egnn_cfg.hidden_nf,
                 "n_blocks": egnn_cfg.n_blocks,
                 "compute_dtype": egnn_cfg.compute_dtype},
        "artifacts": {k: os.path.basename(v) for k, v in paths.items()},
        "device": generator.device.type,
        "draws": [diff_cfg.timesteps + 2, batch, N,
                  diff_cfg.n_dims + diff_cfg.in_node_nf],
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return paths
