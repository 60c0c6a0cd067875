"""Plain reference of the EDM training step (Hoogeboom et al. 2022,
arXiv:2203.17003, Algorithm 1) with AdamW (Loshchilov and Hutter 2019) and
an exponential moving average of the weights.

A batch of molecules is featurised as the published model reads it:
positions at zero centre of mass, one-hot atom classes over the permitted
elements in order of atomic number, and on every real node the normalised
principal moments of inertia (unit masses). A step draws t and the noise,
forward-diffuses the clean latent, regresses the noise with the masked L2
loss, and updates the weights; the moving average follows.

The draws follow the program's documented stream: one 62-bit base seed
from the step's generator, a new generator seeded with
splitmix64(base << 20 | data row) >> 1 (data row 0 on one device), then t
for every molecule and the noise, positions first.
"""

from __future__ import annotations

import numpy as np
import torch

from .edm import gamma_schedule
from .egnn import dynamics, remove_mean

_MASK64 = (1 << 64) - 1


def splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def featurize(mols, n_pad, cfg, device):
    """mols: [(atomic numbers (n,), coordinates (n, 3))] -> the batch."""
    classes = {z: i for i, z in enumerate(sorted(cfg["permitted_elements"]))}
    mean = np.asarray(cfg["context_norms"]["mean"])
    mad = np.asarray(cfg["context_norms"]["mad"])
    B, F = len(mols), len(classes)
    x = np.zeros((B, n_pad, 3))
    h = np.zeros((B, n_pad, F))
    mask = np.zeros((B, n_pad, 1))
    ctx = np.zeros((B, n_pad, 3))
    for b, (z, pos) in enumerate(mols):
        n = len(z)
        c = np.asarray(pos, dtype=np.float64)
        c = c - c.mean(axis=0)
        x[b, :n] = c
        h[b, np.arange(n), [classes[int(a)] for a in z]] = 1.0
        mask[b, :n] = 1.0
        inertia = np.eye(3) * (c * c).sum() - c.T @ c
        ctx[b, :n] = (np.linalg.eigvalsh(inertia) - mean) / mad
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in dict(x=x, h=h, node_mask=mask, context=ctx).items()}
    nm = t["node_mask"]
    eye = torch.eye(n_pad, device=device)[None, :, :, None]
    t["edge_mask"] = nm[:, :, None, :] * nm[:, None, :, :] * (1 - eye)
    return t


def step_draws(generator, B, N, node_mask, T):
    """(t (B,), noise (B, N, 3 + F)) of one step from its generator."""
    dev = node_mask.device
    base = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())
    g = torch.Generator(device=dev).manual_seed(
        splitmix64((base << 20) & _MASK64) >> 1)
    t = torch.randint(0, T + 1, (B,), generator=g, device=dev)
    x = torch.randn((B, N, 3), generator=g, device=dev) * node_mask
    h = torch.randn((B, N, 8), generator=g, device=dev) * node_mask
    return t, torch.cat([remove_mean(x, node_mask), h], dim=-1)


def loss(w, cfg, batch, t, noise, fmt="float32"):
    """The masked L2 noise-regression loss of one batch."""
    T = cfg["timesteps"]
    gamma = torch.tensor(gamma_schedule(T, cfg["noise_precision"],
                                        cfg["schedule_power"]),
                         dtype=torch.float64, device=t.device)[t]
    B = t.shape[0]
    alpha = torch.sqrt(torch.sigmoid(-gamma)).float().reshape(B, 1, 1)
    sigma = torch.sqrt(torch.sigmoid(gamma)).float().reshape(B, 1, 1)
    nm = batch["node_mask"]
    z0 = torch.cat([batch["x"] / cfg["norm_values"][0],
                    batch["h"] / cfg["norm_values"][1]], dim=-1)
    zt = alpha * z0 + sigma * noise
    zt = torch.cat([remove_mean(zt[..., :3], nm), zt[..., 3:]], dim=-1)
    pred = dynamics(w, cfg, t.float() / T, zt, nm, batch["edge_mask"],
                    batch["context"], fmt)
    return ((pred - noise) ** 2 * nm).sum() / (nm.sum() * noise.shape[-1])


class AdamW:
    """AdamW with bias correction, decoupled weight decay first."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / np.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def ema_decay(decay: float, t: int) -> float:
    """The average's decay at update t (from 0): min(decay, (1+t)/(10+t))
    in float32."""
    t32 = np.float32(t)
    return float(min(np.float32(decay),
                     (np.float32(1) + t32) / (np.float32(10) + t32)))


@torch.no_grad()
def ema_update(ema, params, decay: float, t: int):
    d = ema_decay(decay, t)
    for k in ema:
        ema[k].copy_(d * ema[k] + (1.0 - d) * params[k])


def run_steps(w0, cfg, batches, generator, n_steps, lr, weight_decay,
              ema_decay_value, fmt="float32", keep=None):
    """The first ``n_steps`` steps from weights ``w0`` on ``batches``.
    ``keep``: the molecules of each batch that count (a fault's: the rest
    left out after the draws). Returns (losses, first gradients by leaf,
    weights after, moving average after)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w0.items()}
    ema = {k: v.detach().clone() for k, v in w0.items()}
    opt = AdamW(params, lr, weight_decay)
    losses, first = [], None
    for s in range(n_steps):
        batch = batches[s]
        nm = batch["node_mask"]
        B, N, _ = nm.shape
        t, noise = step_draws(generator, B, N, nm, cfg["timesteps"])
        if keep is not None:
            batch = {k: v[keep] for k, v in batch.items()}
            t, noise = t[keep], noise[keep]
        value = loss(params, cfg, batch, t, noise, fmt)
        grads = dict(zip(params, torch.autograd.grad(
            value, list(params.values()), allow_unused=True)))
        grads = {k: g if g is not None else torch.zeros_like(params[k])
                 for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        ema_update(ema, params, ema_decay_value, s)
        losses.append(float(value.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}, ema
