"""Plain reference of EDM's training step on GEOM-Drugs with hydrogens
(Hoogeboom, Satorras, Vignac, Welling, ICML 2022, arXiv:2203.17003,
Algorithm 1; github.com/ehoogeboom/e3_diffusion_for_molecules,
``main_geom_drugs.py``), with AdamW (Loshchilov and Hutter 2019) and an
exponential moving average of the weights.

A batch of all-atom molecules is featurised as the model reads it:
positions at zero centre of mass, one-hot atom types over the
configuration's ``atom_decoder`` (hydrogens included), no context, padded
to the batch's largest molecule rounded up to ``node_bucket``. A step draws
t and the noise (the program's documented stream, as ``train.step_draws``
draws it, over the decoder's types), forward-diffuses the clean latent,
regresses the noise with the masked L2 loss (the sum of squared errors
over the real atoms' coordinates and types, over their count times the
latent's width), and updates the weights; the moving average follows. The
denoiser is ``edm_drugs.dynamics``; AdamW and the average are
``train.AdamW`` and ``train.ema_update``.

Departures from EDM's script, none of which changes the edge work: its l2
loss normalises each molecule's error by its own size and adds an L0 term
at t = 0, and its optimizer is AdamW with AMSGrad and an adaptive
gradient-norm clip (the configuration's ``assumed`` lists them).

The batch runs in blocks of at most ``rows`` molecules, each cut to its own
largest molecule (padding adds exact zeros), so that the dense edges fit
the device; each block's loss is its sum over the whole batch's count, so
the blocks' gradients add up to the batch's, each weighted by its share of
the batch's real atoms. Written in plain PyTorch, float32 with TF32 off
(``precision.exact_float32`` around a call) or a control's format; it
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import edm_drugs, train
from .edm import gamma_schedule
from .egnn import remove_mean

#: Atomic numbers of the element symbols GEOM-Drugs' decoder holds.
ATOMIC_NUMBERS = {"H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Al": 13,
                  "Si": 14, "P": 15, "S": 16, "Cl": 17, "As": 33, "Br": 35,
                  "I": 53, "Hg": 80, "Bi": 83}


def pad_of(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


def featurize(mols, cfg, device, n_pad=None):
    """mols: [(atomic numbers (n,), coordinates (n, 3))] -> the batch,
    padded to ``n_pad`` (default the largest molecule's bucket)."""
    classes = {ATOMIC_NUMBERS[s]: c for c, s in enumerate(cfg["atom_decoder"])}
    B, F = len(mols), len(classes)
    N = n_pad or pad_of(max(len(z) for z, _ in mols), cfg["node_bucket"])
    x = np.zeros((B, N, 3))
    h = np.zeros((B, N, F))
    mask = np.zeros((B, N, 1))
    for b, (z, pos) in enumerate(mols):
        n = len(z)
        c = np.asarray(pos, dtype=np.float64)
        x[b, :n] = c - c.mean(axis=0)
        h[b, np.arange(n), [classes[int(a)] for a in z]] = 1.0
        mask[b, :n] = 1.0
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in dict(x=x, h=h, node_mask=mask).items()}
    nm = t["node_mask"]
    eye = torch.eye(N, device=device)[None, :, :, None]
    t["edge_mask"] = nm[:, :, None, :] * nm[:, None, :, :] * (1 - eye)
    return t


def step_draws(generator, B, N, node_mask, T, F):
    """(t (B,), noise (B, N, 3 + F)) of one step from its generator: one
    base seed from it, a generator seeded with splitmix64(base << 20 | data
    row 0) >> 1, then t, the positions' noise and the types' noise, in
    ``node_mask``'s type."""
    dev, dt = node_mask.device, node_mask.dtype
    base = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())
    g = torch.Generator(device=dev).manual_seed(
        train.splitmix64((base << 20) & train._MASK64) >> 1)
    t = torch.randint(0, T + 1, (B,), generator=g, device=dev)
    x = torch.randn((B, N, 3), generator=g, device=dev, dtype=dt) * node_mask
    h = torch.randn((B, N, F), generator=g, device=dev, dtype=dt) * node_mask
    return t, torch.cat([remove_mean(x, node_mask), h], dim=-1)


def squared_error(w, cfg, batch, t, noise, fmt="float32"):
    """Sum over the batch's real atoms of the squared error of the noise
    prediction (coordinates and types), in the batch's type (the schedule's
    scalars from float64)."""
    T = cfg["timesteps"]
    dt = batch["x"].dtype
    gamma = torch.tensor(gamma_schedule(T, cfg["noise_precision"],
                                        cfg["schedule_power"]),
                         dtype=torch.float64, device=t.device)[t]
    B = t.shape[0]
    alpha = torch.sqrt(torch.sigmoid(-gamma)).to(dt).reshape(B, 1, 1)
    sigma = torch.sqrt(torch.sigmoid(gamma)).to(dt).reshape(B, 1, 1)
    nm = batch["node_mask"]
    z0 = torch.cat([batch["x"] / cfg["norm_values"][0],
                    batch["h"] / cfg["norm_values"][1]], dim=-1)
    zt = alpha * z0 + sigma * noise
    zt = torch.cat([remove_mean(zt[..., :3], nm), zt[..., 3:]], dim=-1)
    pred = edm_drugs.dynamics(w, cfg, t.to(dt) / T, zt, nm,
                              batch["edge_mask"], fmt)
    return ((pred - noise) ** 2 * nm).sum()


def loss_and_grads(params, cfg, batch, t, noise, fmt="float32", rows=8):
    """The batch's loss and its gradients by leaf, block by block of at
    most ``rows`` molecules, each block cut to its largest molecule."""
    nm = batch["node_mask"]
    denom = nm.sum() * noise.shape[-1]
    sizes = nm.sum(dim=(1, 2)).long().tolist()
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    value = 0.0
    for r in range(0, nm.shape[0], rows):
        n = max(sizes[r:r + rows])
        part = {"x": batch["x"][r:r + rows, :n],
                "h": batch["h"][r:r + rows, :n],
                "node_mask": nm[r:r + rows, :n],
                "edge_mask": batch["edge_mask"][r:r + rows, :n, :n]}
        term = squared_error(params, cfg, part, t[r:r + rows],
                             noise[r:r + rows, :n], fmt) / denom
        for k, g in zip(params, torch.autograd.grad(
                term, list(params.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        value += float(term.detach())
    return value, grads


def run_steps(w0, cfg, batches, generator, n_steps, lr, weight_decay,
              ema_decay_value, fmt="float32", rows=8, forced=None):
    """The first ``n_steps`` steps from weights ``w0`` on ``batches``
    (featurised). ``forced``: another run's weights before each step and
    after the last (``n_steps`` + 1 dicts, the first ``w0``): each step
    then starts from that run's weights, its loss, gradients and update
    taken there (the optimizer's moments are this run's own), and the
    average follows that run's weights; so each step is held against the
    other run's from where that run stood, and a gap does not compound
    from step to step. Returns (losses, each step's gradients by leaf, the
    weights after each step, moving average after)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w0.items()}
    ema = {k: v.detach().clone() for k, v in w0.items()}
    opt = train.AdamW(params, lr, weight_decay)
    losses, grads_by_step, weights = [], [], []
    F = len(cfg["atom_decoder"])
    for s in range(n_steps):
        if forced is not None:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(forced[s][k])
        batch = batches[s]
        B, N, _ = batch["node_mask"].shape
        t, noise = step_draws(generator, B, N, batch["node_mask"],
                              cfg["timesteps"], F)
        value, grads = loss_and_grads(params, cfg, batch, t, noise, fmt,
                                      rows)
        grads_by_step.append({k: g.detach().clone()
                              for k, g in grads.items()})
        opt.step(params, grads)
        weights.append({k: v.detach().clone() for k, v in params.items()})
        train.ema_update(ema, params if forced is None else forced[s + 1],
                         ema_decay_value, s)
        losses.append(value)
    return losses, grads_by_step, weights, ema
