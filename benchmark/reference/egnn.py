"""Plain reference of the EGNN denoiser (Satorras et al. 2021, as EDM uses
it: Hoogeboom et al. 2022, arXiv:2203.17003), dense and masked.

Written from the equations, in float32 (or a control's format through
``precision.linear``), from a dict of weights named as the published
checkpoint names them. Every edge MLP takes the concatenation
[h_i, h_j, |x_i - x_j|^2, |x_i^0 - x_j^0|^2] of its target node i, its
source node j and the two edge scalars. It imports nothing of the program.

Shapes: xh (B, N, 3 + F) positions then features; node_mask (B, N, 1);
edge_mask (B, N, N, 1), zero on the diagonal; context (B, N, C); t (B,).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import linear


def remove_mean(x, node_mask):
    """Masked positions (..., N, 3) moved to zero centre of mass."""
    n = node_mask.sum(dim=-2, keepdim=True)
    return x - (x.sum(dim=-2, keepdim=True) / n) * node_mask


def _sq_dist(x):
    d = x[:, :, None, :] - x[:, None, :, :]
    return (d * d).sum(-1)


def _lin(w, name, x, fmt, bias=True):
    return linear(x, w[f"{name}.weight"], w[f"{name}.bias"] if bias else None,
                  fmt)


def _edge_input(h, edge_feat):
    B, N, H = h.shape
    hi = h[:, :, None, :].expand(B, N, N, H)
    hj = h[:, None, :, :].expand(B, N, N, H)
    return torch.cat([hi, hj, edge_feat], dim=-1)


def _gcl(w, p, h, edge_feat, node_mask, edge_mask, norm, fmt):
    e_in = _edge_input(h, edge_feat)
    m = F.silu(_lin(w, f"{p}.edge_mlp.2",
                    F.silu(_lin(w, f"{p}.edge_mlp.0", e_in, fmt)), fmt))
    gate = torch.sigmoid(_lin(w, f"{p}.att_mlp.0", m, fmt))
    agg = (m * gate * edge_mask).sum(dim=2) / norm
    upd = _lin(w, f"{p}.node_mlp.2",
               F.silu(_lin(w, f"{p}.node_mlp.0", torch.cat([h, agg], -1), fmt)),
               fmt)
    return (h + upd) * node_mask


def _coord(w, p, h, x, edge_feat, coord_diff, node_mask, edge_mask, norm,
           fmt):
    e_in = _edge_input(h, edge_feat)
    s = F.silu(_lin(w, f"{p}.coord_mlp.0", e_in, fmt))
    s = F.silu(_lin(w, f"{p}.coord_mlp.2", s, fmt))
    s = _lin(w, f"{p}.coord_mlp.4", s, fmt, bias=False)
    agg = (coord_diff * s * edge_mask).sum(dim=2) / norm
    return (x + agg) * node_mask


def dynamics(w, cfg, t, xh, node_mask, edge_mask, context, fmt="float32"):
    """The denoiser's eps prediction (B, N, 3 + F) at normalised time t."""
    B, N, _ = xh.shape
    xh = xh * node_mask
    x0 = xh[..., :3]
    h = torch.cat([xh[..., 3:], t.reshape(B, 1, 1).expand(B, N, 1),
                   context], dim=-1)
    d0 = _sq_dist(x0)[..., None]
    norm = float(cfg["normalization_factor"])
    h = _lin(w, "egnn.embedding", h, fmt)
    x = x0
    for b in range(cfg["n_blocks"]):
        p = f"egnn.e_block_{b}"
        radial = _sq_dist(x)[..., None]
        coord_diff = (x[:, :, None, :] - x[:, None, :, :]) / torch.sqrt(
            radial + 1e-8)
        edge_feat = torch.cat([radial, d0], dim=-1)
        h = _gcl(w, f"{p}.gcl_0", h, edge_feat, node_mask, edge_mask, norm,
                 fmt)
        h = _gcl(w, f"{p}.gcl_1", h, edge_feat, node_mask, edge_mask, norm,
                 fmt)
        x = _coord(w, f"{p}.gcl_equiv", h, x, edge_feat, coord_diff,
                   node_mask, edge_mask, norm, fmt)
        h = h * node_mask
    h = _lin(w, "egnn.embedding_out", h, fmt) * node_mask
    vel = remove_mean((x - x0) * node_mask, node_mask)
    return torch.cat([vel, h[..., :-(cfg["context_node_nf"] + 1)]], dim=-1)
