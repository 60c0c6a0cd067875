"""Bond-predictor (AdjMatSeer) training, PyTorch twin of
``ml_conformer_generator_tpu/training/bonds.py``: masked cross-entropy on
bond types.

Targets replay the inference-time featurisation exactly: inputs come from
``chem/featurize.py::prepare_adj_mat_seer_input`` (re-perceived single-bond
connectivity, canonical-SMILES writer atom order, padded distance/adjacency
matrices — reference ``mol_utils.py:146-194``), and the (B, 42, 42, 5)
one-hot bond-type targets are the molecules' TRUE bonds renumbered into that
same canonical order, so position statistics match what the model will see
at inference. ``bond_training_batch`` is a numpy copy; the training is
``torch.optim.Adam`` over the port's :class:`AdjMatSeer` (plain PyTorch and
cuBLAS under autograd: the JAX package has no kernel here either). JAX jits
its step; on the card the port's step (loss, backward, Adam) is one captured
CUDA graph replayed once a step (``utils/cuda_graph.py``), with a sampled
batch gathered on the host side of the step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..checkpoint import load_jax_params
from ..chem.featurize import prepare_adj_mat_seer_input
from ..chem.mol import Molecule
from ..config import AdjMatSeerConfig
from ..models.adj_mat_seer import AdjMatSeer, adj_mat_seer_forward
from ..utils.cuda_graph import GraphCache, step_graph
from ..utils.device import resolve_device
from . import step as _step

__all__ = ["bond_training_batch", "train_adj_mat_seer"]


def bond_training_batch(mols: Sequence[Molecule],
                        cfg: AdjMatSeerConfig = AdjMatSeerConfig()) -> Dict:
    """Featurise molecules WITH known bonds into an AdjMatSeer batch.

    Returns {elements, dist, adj, target, pair_mask}: inputs exactly as the
    inference path builds them, targets as one-hot true bond types in the
    identical canonical order, pair_mask selecting real off-diagonal atom
    pairs (loss is not computed over padding or the diagonal).
    """
    heavy = [m.remove_hs() for m in mols]
    elements, dist, adj, _, orders = prepare_adj_mat_seer_input(
        list(heavy), cfg.dimension, return_orders=True)
    D = cfg.dimension
    target = np.zeros((len(heavy), D, D, cfg.num_bond_types),
                      dtype=np.float32)
    target[..., 0] = 1.0                      # default: "no bond" channel
    pair_mask = np.zeros((len(heavy), D, D), dtype=np.float32)
    for b, m in enumerate(heavy):
        # the IDENTICAL permutation the input featurisation applied (native
        # batched ranks when available) — not an independent recomputation
        true_canon = m.renumber(orders[b])
        for i, j, o in true_canon.bonds:
            t = min(int(o), cfg.num_bond_types - 1)
            target[b, i, j, 0] = target[b, j, i, 0] = 0.0
            target[b, i, j, t] = target[b, j, i, t] = 1.0
        n = m.num_atoms
        pair_mask[b, :n, :n] = 1.0 - np.eye(n, dtype=np.float32)
    return {"elements": elements, "dist": dist, "adj": adj,
            "target": target, "pair_mask": pair_mask}


def _bond_loss(model: AdjMatSeer, d: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masked cross-entropy; the log-softmax in float32, as JAX's."""
    logits = adj_mat_seer_forward(model, d["elements"], d["dist"], d["adj"])
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ce = -(d["target"] * logp).sum(-1)                   # (B, D, D)
    m = d["pair_mask"]
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def train_adj_mat_seer(mols: Sequence[Molecule], *, steps: int = 500,
                       lr: float = 3e-4, batch_size: int = 0, seed: int = 0,
                       cfg: AdjMatSeerConfig = AdjMatSeerConfig(),
                       params=None, log_every: int = 100, log_fn=print,
                       device=None) -> Dict:
    """Train AdjMatSeer on molecules with known bonds; returns
    {params, history}, ``params`` the trained :class:`AdjMatSeer`.
    ``batch_size`` 0 trains full-batch (the overfit regime); otherwise each
    step samples a random subset. ``params``: an :class:`AdjMatSeer` to
    train in place, a JAX-layout tree to start from, or None for a random
    init from ``seed``. ``device``: ``None`` means the CUDA device (without
    one, raise). The distance and adjacency inputs take the model's type;
    targets and masks stay float32, as in the JAX loss."""
    device = resolve_device(device)
    batch = bond_training_batch(mols, cfg)
    if isinstance(params, AdjMatSeer):
        model = params.to(device)
    else:
        model = AdjMatSeer(cfg, torch.Generator().manual_seed(seed))
        if params is not None:
            load_jax_params(params, model)
        model = model.to(device)
    dtype = model.resize.weight.dtype
    data = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    data["dist"] = data["dist"].to(dtype)
    data["adj"] = data["adj"].to(dtype)

    # fused: one algorithm on the CPU and the card; capturable on the card
    params = list(model.parameters())
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 fused=True,
                                 capturable=device.type == "cuda")

    def body(**d):
        """One step on the batch ``d``, tensors only."""
        optimizer.zero_grad(set_to_none=True)
        loss = _bond_loss(model, d)
        loss.backward()
        optimizer.step()
        return loss.detach()

    graphs = GraphCache(1)
    graphed = device.type == "cuda" and _step._graphed
    rng = np.random.default_rng(seed)
    history: List[Dict] = []
    n = data["elements"].shape[0]
    for step in range(1, steps + 1):
        if batch_size and batch_size < n:
            idx = torch.as_tensor(rng.choice(n, size=batch_size,
                                             replace=False), device=device)
            d = {k: v[idx] for k, v in data.items()}
        else:
            d = data
        if graphed:
            _, loss, _ = step_graph(graphs, "step", None, body, d, params)
        else:
            loss = body(**d)
        if step % log_every == 0 or step == steps:
            loss = float(loss)
            history.append({"step": step, "loss": loss})
            log_fn(f"[train-bonds] step {step} loss {loss:.5f}")
    return {"params": model, "history": history}
