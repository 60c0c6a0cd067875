"""Plain reference of the bond-order predictor (AdjMatSeer of the
published ML Conformer Generator): two stacks of Kipf graph convolutions,
``D^-1/2 A D^-1/2 (X W + b)`` with ReLU, on the padded distance matrix and
on the adjacency, and a symmetrised bond-type head.

elements (B, D) atomic numbers, 0 for padding; dist (B, D, D) and adj
(B, D, D) with the identity added. Returns (B, D, D, bond types) logits.
"""

from __future__ import annotations

import torch

from .precision import linear, matmul


def _norm_adj(a):
    deg = a.sum(-1)
    inv = torch.rsqrt(deg.clamp(min=1e-12))
    return inv[..., :, None] * a * inv[..., None, :]


def _conv(w, name, x, a, fmt):
    return torch.relu(matmul(a, linear(x, w[f"{name}.linear.weight"],
                                       w[f"{name}.linear.bias"], fmt), fmt))


def forward(w, cfg, elements, dist, adj, fmt="float32"):
    D, E = cfg["dimension"], cfg["embedding_dim"]
    B = elements.shape[0]
    a = _norm_adj(dist)
    c = w["dm_nodes_embedding.weight"][elements]
    for name in ("gcn1_dm", "gcn2_dm", "gcn3_dm"):
        c = _conv(w, name, c, a, fmt)
    bottleneck = linear(c, w["dm_resize.weight"], w["dm_resize.bias"],
                        fmt)[..., 0]
    placed = linear(bottleneck, w["nodes_coord_fc.weight"],
                    w["nodes_coord_fc.bias"], fmt).reshape(B, D, E)
    c = w["nodes_embedding.weight"][elements] + placed
    a = _norm_adj(adj)
    for name in ("gcn1", "gcn2", "gcn3", "gcn4"):
        c = _conv(w, name, c, a, fmt)
    logits = linear(c, w["resize.weight"], w["resize.bias"], fmt).reshape(
        B, D, D, cfg["num_bond_types"])
    return logits + logits.transpose(1, 2)
