"""Plain reference of the EDM reverse sampler (Hoogeboom et al. 2022,
arXiv:2203.17003, Algorithm 2), with its polynomial noise schedule.

The schedule and every step's scalars are computed in float64 from the
equations; the latent is float32. Draws are given, not made: ``noise[k]``
is the k-th draw of the trajectory (the initial latent, one a step, the
decode's), each masked and its positions moved to zero centre of mass
(:func:`mask_noise`). The atom types come from the last latent's feature
channels without the last class, as the published sampler decodes them.
"""

from __future__ import annotations

import numpy as np
import torch

from .egnn import dynamics, remove_mean


def gamma_schedule(T: int, precision: float, power: int) -> np.ndarray:
    """gamma_t = -log(alpha_t^2 / sigma_t^2), t = 0..T (float64)."""
    steps = T + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = np.concatenate([np.ones(1), alphas2])
    alphas2 = np.cumprod(np.clip(alphas2[1:] / alphas2[:-1], 0.001, 1.0))
    alphas2 = (1 - 2 * precision) * alphas2 + precision
    return -(np.log(alphas2) - np.log(1 - alphas2))


def _sigmoid(g):
    return 1.0 / (1.0 + np.exp(-g))


def mask_noise(raw, node_mask):
    """A draw (B, N, 3 + F) of standard normals made into the sampler's
    noise: masked, positions at zero centre of mass."""
    x = remove_mean(raw[..., :3] * node_mask, node_mask)
    return torch.cat([x, raw[..., 3:] * node_mask], dim=-1)


def sample(w, cfg, noise, node_mask, edge_mask, context, fmt="float32"):
    """(x (B, N, 3), class scores (B, N, F - 1)) of one trajectory.

    ``noise``: (T + 2, B, N, 3 + F) masked draws; ``context``: (B, N, C),
    the normalised context on every real node."""
    T = cfg["timesteps"]
    gamma = gamma_schedule(T, cfg["noise_precision"], cfg["schedule_power"])
    B = node_mask.shape[0]
    dev = node_mask.device

    def eps(z, t):
        tt = torch.full((B,), t, dtype=torch.float32, device=dev)
        return dynamics(w, cfg, tt, z, node_mask, edge_mask, context, fmt)

    z = noise[0]
    for k, s in enumerate(range(T - 1, -1, -1), start=1):
        g_s, g_t = gamma[s], gamma[s + 1]
        sigma2_ts = -np.expm1(np.logaddexp(0, g_s) - np.logaddexp(0, g_t))
        alpha_ts = np.sqrt(_sigmoid(-g_t) / _sigmoid(-g_s))
        sigma_s, sigma_t = np.sqrt(_sigmoid(g_s)), np.sqrt(_sigmoid(g_t))
        coef = float(sigma2_ts / alpha_ts / sigma_t)
        mu = z / float(alpha_ts) - coef * eps(z, (s + 1) / T)
        z = mu + float(np.sqrt(sigma2_ts) * sigma_s / sigma_t) * noise[k]
        z = torch.cat([remove_mean(z[..., :3], node_mask), z[..., 3:]], -1)
    g0 = gamma[0]
    sigma_0 = float(np.sqrt(_sigmoid(g0)))
    alpha_0 = float(np.sqrt(_sigmoid(-g0)))
    sigma_x = float(np.exp(0.5 * g0))
    x = ((z - sigma_0 * eps(z, 0.0)) / alpha_0 + sigma_x * noise[T + 1])
    x = x[..., :3] * cfg["norm_values"][0]
    scores = z[..., 3:-1] * cfg["norm_values"][1] * node_mask
    return x, scores
