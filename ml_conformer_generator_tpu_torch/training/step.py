"""Sharded EDM training step, PyTorch twin of ``ml_conformer_generator_tpu/training/step.py``.

Data parallel (``data``) x edge-partitioned (``edge``), one process per
device: each rank holds a batch shard and a j-column slab of the edge set,
computes the local loss through the model's forward on its slab
(``parallel/edge_shard.py``; on an edge axis of one rank, the dense
forward of ``models/egnn.py`` itself), and the parameter gradients are
reduced over both mesh axes before every rank applies the same AdamW
update. On the card
every edge pass of the step, forward and backward, runs in the port's
float32 kernels (``ops/gcl_kernel.py``), on the rank's slab.

JAX runs a step as one compiled program (``jax.jit`` of the loss, its
``value_and_grad``, the ``pmean`` and the optax update). The port splits a
step into host work (the batch and the draws, in the loop's order) and a
device body of tensors only (the loss from the draws, its backward with
remat, the gradients' reduction and the AdamW update). On the card, on the
(1, 1) mesh, the body is one captured CUDA graph (``utils/cuda_graph.py``),
replayed once a step; its first call is the capture's warm-up step. On CPU
tensors, and on a mesh of more than one rank, the body runs eagerly.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Iterable

import torch
import torch.distributed as dist

from ..config import DiffusionConfig, EGNNConfig
from ..models.egnn import EGNNDynamics
from ..parallel.edge_shard import dynamics_forward_sharded
from ..parallel.mesh import Mesh, data_sharding
from ..parallel.sampler import data_stream
from ..utils.cuda_graph import GraphCache, step_graph
from ..utils.metrics import span, spanned
from . import loss as _loss

#: Whether a step on CUDA tensors on the (1, 1) mesh runs as its captured
#: graph; the EMA update (``loop.py``) and AdjMatSeer's step (``bonds.py``)
#: read it too. Not a switch for callers: the loop on the card exists for
#: comparison only (``chip_smoke.py``'s ``train_loop``).
_graphed = True
#: Captured steps kept per step function at the least. A run of one batch
#: shape (``MoleculeDataset``) keeps one graph a model; a run whose batches
#: take more shapes keeps one a shape (``make_train_step``'s
#: ``batch_shapes``). The graphs share one memory pool
#: (``GraphCache(shared_pool=True)``): the pool holds the largest step's
#: working set, not the sum (PERF.md gives the peak on the H100).
GRAPHS_KEPT = 2


@dataclasses.dataclass
class TrainState:
    """The optimizer's state: the torch optimizer bound to the parameters
    and its learning-rate schedule (optax keeps both in its opt_state)."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR


def _warmup_cosine(count: int, init: float, peak: float, warmup: int,
                   decay_steps: int, end: float) -> float:
    """optax's ``warmup_cosine_decay_schedule`` at step ``count``: linear
    from ``init`` to ``peak`` over ``warmup`` steps, then cosine decay to
    ``end`` at ``decay_steps`` (warmup included)."""
    if count < warmup:
        frac = 1.0 - max(count, 0) / warmup
        return (init - peak) * frac + peak
    alpha = 0.0 if peak == 0.0 else end / peak
    span = decay_steps - warmup
    c = min(count - warmup, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
    return peak * ((1.0 - alpha) * cosine + alpha)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-12, *,
                   total_steps: int = 0, warmup_steps: int = 0,
                   end_lr_frac: float = 0.1
                   ) -> Callable[[Iterable[torch.nn.Parameter]], TrainState]:
    """AdamW; with ``total_steps`` > 0, linear warmup + cosine decay to
    ``lr * end_lr_frac`` (the denoiser's sample quality is sensitive to the
    final-LR noise floor — a constant LR leaves the overfit regime orbiting
    the minimum instead of settling into it).

    optax's transformation holds no parameters; a torch optimizer does. So
    this returns the recipe, a function of the parameters that builds the
    :class:`TrainState` (``init_train_state`` calls it). The schedule is a
    ``LambdaLR`` equal to optax's: the first update uses ``schedule(0)``,
    which is 0 with a warmup. The recipe's ``schedule`` attribute is the
    learning rate by step.

    The AdamW is torch's fused one, on the CPU and on the card (one
    algorithm, which the CPU tests hold; on the card ``capturable``), with
    the learning rate a tensor on the parameters' device that the schedule
    fills in place: a captured step reads it there. It is float32 on the
    card, which the fused kernel reads, and float64 on the CPU, where the
    fused update reads it as the Python float it would otherwise be.
    """
    if total_steps > 0:
        # optax requires decay_steps - warmup_steps > 0; clamp so short
        # runs (small corpora / few epochs) degrade to a shorter warmup
        # instead of raising at startup
        warmup_steps = min(warmup_steps, max(total_steps - 1, 0))
        init = 0.0 if warmup_steps else lr

        def schedule(count: int) -> float:
            return _warmup_cosine(count, init, lr, warmup_steps, total_steps,
                                  lr * end_lr_frac)
    else:
        def schedule(count: int) -> float:
            return lr

    def build(params: Iterable[torch.nn.Parameter]) -> TrainState:
        params = list(params)
        device = params[0].device
        lr_t = torch.tensor(lr, device=device, dtype=(
            torch.float32 if device.type == "cuda" else torch.float64))
        opt = torch.optim.AdamW(params, lr=lr_t, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay,
                                fused=True, capturable=device.type == "cuda")
        # The fused update writes the parameters without moving their
        # version counters, which the packed-W1 cache (ops/gcl_kernel.py)
        # and a sampler's weights token read: move them after each step, as
        # the single-tensor update's in-place ops do.
        opt.register_step_post_hook(
            lambda *_: torch.autograd.graph.increment_version(params))
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count: schedule(count) / lr if lr else 0.0)
        return TrainState(opt, sched)

    build.schedule = schedule
    return build


def init_train_state(model: torch.nn.Module, optimizer=None) -> TrainState:
    """The optimizer state of ``model``'s parameters (``optimizer``: a
    recipe from :func:`make_optimizer`, default ``make_optimizer()``)."""
    if optimizer is None:
        optimizer = make_optimizer()
    return optimizer(model.parameters())


def _reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Reduce every parameter's gradient over the mesh in place, as JAX's
    step does (one flat all-reduce per axis).

    Over ``edge``, the mean: each rank back-propagated the same replicated
    loss, and the edge all-reduce's backward summed the slabs' gradients
    over the row, so the sum over the row counts every term n_edge times
    (see ``parallel/edge_shard.py``). Over ``data``, the sum of the data
    rows' gradients of their local losses: that is what JAX's step applies.
    Its ``pmean`` over "data" comes after ``shard_map``'s transpose of the
    replicated parameters, which has already summed the rows' gradients
    over "data", so the mean of equal values leaves the sum
    (``tests/test_torch_parallel.py`` holds the port's update to JAX's).
    Under AdamW the factor n_data moves an update only where a gradient is
    near the optimizer's eps.
    """
    if mesh.n_edge == 1 and mesh.n_data == 1:
        return
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    if mesh.n_edge > 1:
        dist.all_reduce(flat, group=mesh.edge_group)
        flat /= mesh.n_edge
    if mesh.n_data > 1:
        dist.all_reduce(flat, group=mesh.data_group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def _data_mean(metrics: Dict[str, torch.Tensor], mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """The metrics' ``pmean`` over the data column (they are equal across
    an edge row)."""
    if mesh.n_data == 1:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.n_data
    return dict(zip(keys, flat.unbind()))


def make_train_step(mesh: Mesh, egnn_cfg: EGNNConfig,
                    diff_cfg: DiffusionConfig, optimizer=None,
                    batch_shapes: int = 1
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the sharded train step on ``mesh`` (``parallel.make_mesh``; its
    device is the step's: on one card, ``make_mesh()``).

    Returns ``step(model, state, generator, batch, gamma) -> metrics``:
    ``model`` an :class:`EGNNDynamics` on the mesh's device, the same
    weights on every rank; ``state`` its :class:`TrainState`, which
    carries its optimizer (``optimizer`` is kept for JAX's signature and
    unused: build the state with ``init_train_state(model, optimizer)``);
    ``generator`` a ``torch.Generator`` in the same state on every rank;
    ``batch`` the GLOBAL batch, a dict of x (B,N,3), h (B,N,F), node_mask
    (B,N,1), edge_mask (B,N,N,1), context (B,N,C) (numpy or tensors), B
    divisible over the data axis and N over the edge axis; ``gamma`` the
    (T+1,) schedule. Each rank cuts its batch shard and edge slab and draws
    from its data row's stream (``parallel.sampler.data_stream``, JAX's
    ``fold_in`` of the data index); the gradients are reduced over both
    axes as JAX's step reduces them (:func:`_reduce_gradients`) and every
    rank applies the same update in place, leaving the reduced gradients in
    ``.grad``. metrics are {"loss", "mean_t"}, their mean over the data
    axis, as device tensors.

    On the card, on the (1, 1) mesh, the device body of the step is a
    captured CUDA graph, one per model, optimizer and batch shape, up to
    ``batch_shapes`` (the shapes the run's batches take: a dataset's
    ``batch_shapes``) or ``GRAPHS_KEPT``, whichever is more, in one shared
    memory pool: the first step of each is eager (the capture's warm-up)
    and records it, the later ones copy the batch and the draws into it and
    replay it. A capture that fails raises. ``step.graphs`` is the cache of
    graphs. The draws are made on the host side of the step, before the
    replay, as the loop makes them.

    The forward is ``dynamics_forward_sharded``: the model's forward with
    the rank's edge slab, or on the (1, 1) mesh and any mesh of one edge
    rank the model's dense forward. Per-block rematerialisation is forced on
    (``EGNNConfig.remat``), as in the JAX step. Like JAX's step, it reads
    no ``compute_dtype``: the forward computes in the weights' type, so a
    "bfloat16" config trains float32 weights in float32.
    """
    if not egnn_cfg.remat:
        egnn_cfg = dataclasses.replace(egnn_cfg, remat=True)
    device = mesh.device
    rows, slab = data_sharding(mesh), data_sharding(mesh, None, "edge")
    dynamics_fn = functools.partial(dynamics_forward_sharded, mesh=mesh)
    graphs = GraphCache(max(GRAPHS_KEPT, batch_shapes), shared_pool=True)

    def body(model, state, *, x, h, node_mask, edge_mask, context, gamma,
             t_int, eps):
        """The step's device work, a function of tensors only: the loss
        from the draws, its backward, the reduction and the update."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = _loss._loss_from_draws(
            model, t_int, eps, x, h, node_mask, edge_mask, context, gamma,
            egnn_cfg, diff_cfg, dynamics_fn=dynamics_fn)
        loss.backward()
        _reduce_gradients(model, mesh)
        state.optimizer.step()
        return metrics["loss"], metrics["mean_t"]

    @spanned("mlcg.train.step")
    def step(model: EGNNDynamics, state: TrainState,
             generator: torch.Generator, batch, gamma):
        with span("mlcg.train.batch"):
            inputs = {k: rows(batch[k]) for k in ("x", "h", "node_mask",
                                                  "context")}
            inputs["edge_mask"] = slab(batch["edge_mask"])
            inputs["gamma"] = torch.as_tensor(gamma, device=device)
        x = inputs["x"]
        with span("mlcg.train.draws"):
            inputs["t_int"], inputs["eps"] = _loss._draws(
                data_stream(generator, mesh.data_index, device), x.shape[0],
                x.shape[1], inputs["node_mask"], diff_cfg, x.dtype)
        groups = state.optimizer.param_groups
        lrs = [g["lr"] for g in groups]
        graphed = _graphed_on(mesh) and _graphed
        with span("mlcg.train.body"):
            if graphed:
                loss, mean_t = _graph_step(graphs, functools.partial(
                    body, model, state), model, state, inputs)
            else:
                loss, mean_t = body(model, state, **inputs)
            state.scheduler.step()
        if graphed and any(g["lr"] is not lr for g, lr in zip(groups, lrs)):
            raise RuntimeError("the learning-rate schedule replaced the lr "
                               "tensor that the captured step reads")
        return _data_mean({"loss": loss, "mean_t": mean_t}, mesh)

    #: the step's captured graphs (``GraphCache.captures_by_key``: captures
    #: by (model, optimizer, batch shapes))
    step.graphs = graphs
    return step


def _graphed_on(mesh: Mesh) -> bool:
    """Whether steps on ``mesh`` run as a captured graph: on the card, on
    one rank. More than one rank keeps the loop: its gradients and edge
    aggregates all-reduce through gloo, which stages CUDA tensors through
    the host and cannot be captured into a CUDA graph (NCCL across several
    cards could be; not done)."""
    return mesh.device.type == "cuda" and mesh.n_data * mesh.n_edge == 1


def _graph_step(graphs: GraphCache, body: Callable, model: EGNNDynamics,
                state: TrainState, inputs: Dict[str, torch.Tensor]):
    """``body(**inputs)`` through the step's graph of ``model`` and
    ``state``, captured again when a parameter or buffer moves to other
    storage or the optimizer's state or groups are replaced (a graph reads
    them by address). The graph's backward writes the gradients into its
    own memory: after each call ``.grad`` is that memory, and after a
    capture it holds the warm-up step's gradients."""
    params = list(model.parameters())
    opt = state.optimizer
    key = (id(model), id(opt),
           tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
    token = (tuple(t.data_ptr() for t in (*params, *model.buffers())),
             id(opt.state), tuple(id(g) for g in opt.param_groups))
    warm_grads = []

    def warmup(**static):
        out = body(**static)
        warm_grads.extend(p.grad for p in params)
        return out

    graph, out, captured = step_graph(graphs, key, token, body, inputs,
                                      params, warmup)
    if captured:
        # the capture's backward left .grad in the graph's memory, not yet
        # written: the warm-up was this call's step, its gradients go there
        stream = torch.cuda.current_stream(graph.device)
        graph.grads = [p.grad for p in params]
        for g, w in zip(graph.grads, warm_grads):
            if g is not None:
                w.record_stream(stream)
                g.copy_(w)
    for p, g in zip(params, graph.grads):
        p.grad = g
    return out
