"""Training loop, PyTorch twin of ``ml_conformer_generator_tpu/training/loop.py``.

Epochs of EDM steps with prefetch, an EMA of the weights and periodic
checkpoints: data pipeline (:mod:`.data`) -> mesh-sharded train step
(:mod:`.step`) -> ``.npz`` checkpoints in the JAX package's layout
(``checkpoint.save_params`` of ``to_jax_params``), which both packages'
generators load.

On the card the step (``step.py``) and the EMA update each run as a
captured CUDA graph replayed once a step, as JAX jits each of them; the
host makes the batch, the draws and the EMA's decay between them.
"""

from __future__ import annotations

import copy
import functools
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import load_jax_params, save_params, to_jax_params
from ..config import DiffusionConfig, EGNNConfig
from ..diffusion.schedule import gamma_schedule
from ..models.egnn import EGNNDynamics
from ..parallel.mesh import make_mesh
from ..utils.cuda_graph import GraphCache, step_graph
from ..utils.metrics import spanned
from . import step as _step
from .data import AllAtomDataset, MoleculeDataset, batches, prefetch
from .step import init_train_state, make_optimizer, make_train_step

__all__ = ["train"]


def ema_decay_at(decay: float, t: int) -> float:
    """The EMA's decay at step ``t`` (counted before the step's increment,
    so the first update has t = 0), ``min(decay, (1 + t) / (10 + t))`` in
    float32 as the JAX loop computes it. Without the warmup a run of S
    steps keeps decay^S of the initial random weights in the average
    (0.999^1200 ~= 30%), which destroys sample quality on short runs."""
    t32 = np.float32(t)
    return float(np.minimum(np.float32(decay),
                            (np.float32(1.0) + t32) / (np.float32(10.0) + t32)))


#: Captured EMA updates, by the addresses, shapes and types of both
#: modules' parameters (a graph reads them by address); a run has one.
_EMA_GRAPHS = GraphCache(2)


def ema_graph_body(ema_params, params, decay: torch.Tensor):
    """The EMA update a graph captures: ``ema <- d ema + (1 - d) model`` in
    place, the pair (d, 1 - d) read from the device tensor ``decay``, each
    product and the sum rounded as :func:`ema_update_`'s loop rounds them.
    Returns nothing to copy out."""
    torch._foreach_mul_(ema_params, decay[0])
    torch._foreach_add_(ema_params, torch._foreach_mul(params, decay[1]))
    return ()


@spanned("mlcg.train.ema")
@torch.no_grad()
def ema_update_(ema: torch.nn.Module, model: torch.nn.Module, decay: float,
                t: int) -> None:
    """``ema <- d ema + (1 - d) model`` in place, d = :func:`ema_decay_at`.

    On the card one captured graph (:func:`ema_graph_body`) reads the pair
    (d, 1 - d) as a tensor of the weights' type: exactly the float32 values
    that the loop's Python floats become in its float32 products."""
    d = ema_decay_at(decay, t)
    ema_params, params = list(ema.parameters()), list(model.parameters())
    if ema_params[0].device.type == "cuda" and _step._graphed:
        pair = torch.tensor([d, 1.0 - d], dtype=ema_params[0].dtype,
                            device=ema_params[0].device)
        key = tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                    for p in ema_params + params)
        step_graph(_EMA_GRAPHS, key, None,
                   functools.partial(ema_graph_body, ema_params, params),
                   {"decay": pair}, ema_params)
        return
    for e, p in zip(ema_params, params):
        e.copy_(d * e + (1.0 - d) * p)


def train(dataset: Union[MoleculeDataset, AllAtomDataset], *,
          egnn_cfg: EGNNConfig,
          diff_cfg: Optional[DiffusionConfig] = None, batch_size: int = 64,
          epochs: int = 1, lr: float = 1e-4, seed: int = 0, device=None,
          mesh=None, params=None, checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 500, log_every: int = 50,
          ema_decay: float = 0.0, cosine_lr: bool = False,
          warmup_steps: int = 0,
          log_fn: Callable[[str], None] = print) -> Dict:
    """Train the EGNN denoiser; returns {params, ema_params, opt_state,
    history}: the trained :class:`EGNNDynamics`, its EMA copy (or None), the
    :class:`~.step.TrainState` and the logged losses. ``dataset``'s
    batches come padded as it pads them (an :class:`AllAtomDataset`: each
    to its largest molecule's bucket; the step keeps a graph per shape).

    ``mesh``: the (data, edge) mesh of the sharded step (default
    ``make_mesh(device=device)``: every rank on the data axis, on one card
    the (1, 1) mesh); ``device``: this rank's device when ``mesh`` is None
    (``None``: the CUDA device; without one, raise). Every rank iterates
    the same global batches; rank 0 writes the checkpoints. ``params``: an
    :class:`EGNNDynamics` to train in place, a JAX-layout tree (or ``.npz``
    path) to start from, or None for a random init from ``seed``.
    ``ema_decay`` > 0 maintains an exponential moving average of the
    parameters (the standard EDM inference weights; e.g. 0.999) — when
    enabled, checkpoints save the EMA parameters. ``cosine_lr`` decays the
    learning rate over the planned step budget (``make_optimizer``).
    """
    mesh = mesh or make_mesh(device=device)
    device = mesh.device
    diff_cfg = diff_cfg or DiffusionConfig()
    if isinstance(params, EGNNDynamics):
        model = params.to(device)
    else:
        model = EGNNDynamics(egnn_cfg, torch.Generator().manual_seed(seed))
        if params is not None:
            load_jax_params(params, model)
        model = model.to(device)
    generator = torch.Generator(device=device).manual_seed(seed)

    steps_per_epoch = max(len(dataset) // max(batch_size, 1), 1)
    optimizer = make_optimizer(
        lr=lr, total_steps=epochs * steps_per_epoch if cosine_lr else 0,
        warmup_steps=warmup_steps)
    state = init_train_state(model, optimizer)
    step_fn = make_train_step(mesh, egnn_cfg, diff_cfg, optimizer,
                              batch_shapes=dataset.batch_shapes)

    ema = None
    if ema_decay > 0:
        ema = copy.deepcopy(model).requires_grad_(False)
    gamma = torch.as_tensor(gamma_schedule(diff_cfg.timesteps,
                                           diff_cfg.noise_precision,
                                           diff_cfg.schedule_power),
                            dtype=torch.float32)

    def save():
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        save_params(checkpoint_path, to_jax_params(model if ema is None
                                                   else ema))

    rng = np.random.default_rng(seed)
    history = []
    step = 0
    t0 = time.perf_counter()
    for epoch in range(epochs):
        for batch in prefetch(batches(dataset, batch_size, rng=rng)):
            metrics = step_fn(model, state, generator, batch, gamma)
            if ema is not None:
                ema_update_(ema, model, ema_decay, step)
            step += 1
            if step % log_every == 0:
                loss = float(metrics["loss"])
                history.append({"step": step, "epoch": epoch, "loss": loss})
                rate = step * batch_size / (time.perf_counter() - t0)
                log_fn(f"[train] epoch {epoch} step {step} "
                       f"loss {loss:.5f} ({rate:.1f} mol/s)")
            if checkpoint_path and step % checkpoint_every == 0:
                save()
    if checkpoint_path:
        save()
    return {"params": model, "ema_params": ema, "opt_state": state,
            "history": history}
