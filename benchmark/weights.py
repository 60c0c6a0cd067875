"""Weights of the benchmark: random, from the run's seed, made on the
device in three calls (one uniform draw for every linear layer of both
models, one normal draw for the embeddings) and cut into float32 tensors
named as the published checkpoints name them.

Linear layers: U(+-1/sqrt(fan_in)) for weight and bias (PyTorch's default);
the EGNN's last coordinate layer xavier-uniform with gain 0.001, as the
published EGNN initialises it. Embeddings: N(0, 1). Both the program and
the reference get these tensors; the program casts them to its own types.
"""

from __future__ import annotations

import math

import torch


def egnn_layout(cfg):
    """[(name, (out, in), bias, limit)] of the EGNN denoiser's linear
    layers."""
    H, E = cfg["hidden_nf"], cfg["edge_feat_nf"]
    nf = cfg["in_node_nf"] + cfg["context_node_nf"]
    lim = lambda fan_in: 1.0 / math.sqrt(fan_in)
    out = [("egnn.embedding", (H, nf), True, lim(nf))]
    for b in range(cfg["n_blocks"]):
        p = f"egnn.e_block_{b}"
        for g in ("gcl_0", "gcl_1"):
            out += [(f"{p}.{g}.edge_mlp.0", (H, 2 * H + E), True,
                     lim(2 * H + E)),
                    (f"{p}.{g}.edge_mlp.2", (H, H), True, lim(H)),
                    (f"{p}.{g}.node_mlp.0", (H, 2 * H), True, lim(2 * H)),
                    (f"{p}.{g}.node_mlp.2", (H, H), True, lim(H)),
                    (f"{p}.{g}.att_mlp.0", (1, H), True, lim(H))]
        out += [(f"{p}.gcl_equiv.coord_mlp.0", (H, 2 * H + E), True,
                 lim(2 * H + E)),
                (f"{p}.gcl_equiv.coord_mlp.2", (H, H), True, lim(H)),
                (f"{p}.gcl_equiv.coord_mlp.4", (1, H), False,
                 0.001 * math.sqrt(6.0 / (H + 1)))]
    out.append(("egnn.embedding_out", (nf, H), True, lim(H)))
    return out


def adj_layout(cfg):
    """([(name, (out, in), bias, limit)] of the bond predictor's linear
    layers, [(name, (rows, dim))] of its embeddings)."""
    D, Hd, E = cfg["dimension"], cfg["n_hidden"], cfg["embedding_dim"]
    lim = lambda fan_in: 1.0 / math.sqrt(fan_in)
    lin = [("gcn1.linear", (Hd, E)), ("gcn2.linear", (Hd, Hd)),
           ("gcn3.linear", (Hd, Hd)), ("gcn4.linear", (Hd, Hd)),
           ("resize", (D * cfg["num_bond_types"], Hd)),
           ("nodes_coord_fc", (D * E, D)),
           ("gcn1_dm.linear", (Hd, E)), ("gcn2_dm.linear", (Hd, Hd)),
           ("gcn3_dm.linear", (Hd, Hd)), ("dm_resize", (1, Hd))]
    emb = [("nodes_embedding", (cfg["num_embeddings"], E)),
           ("dm_nodes_embedding", (cfg["num_embeddings"], E))]
    return [(n, s, True, lim(s[1])) for n, s in lin], emb


def make_weights(cfg, seed: int, device):
    """(EGNN weights, bond-predictor weights): dicts of float32 tensors on
    ``device`` by state-dict name."""
    g = torch.Generator(device=device).manual_seed(seed)
    adj_lin, adj_emb = adj_layout(cfg)
    layers = [("egnn", *t) for t in egnn_layout(cfg)] + [
        ("adj", *t) for t in adj_lin]
    sizes = []
    for _, _, (o, i), bias, _ in layers:
        sizes += [o * i] + ([o] if bias else [])
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    nrm = torch.randn(sum(r * d for _, (r, d) in adj_emb), generator=g,
                      device=device)
    out = {"egnn": {}, "adj": {}}
    at = 0
    for model, name, (o, i), bias, limit in layers:
        out[model][f"{name}.weight"] = (u[at:at + o * i] * limit).view(o, i)
        at += o * i
        if bias:
            out[model][f"{name}.bias"] = u[at:at + o] * limit
            at += o
    at = 0
    for name, (r, d) in adj_emb:
        out["adj"][f"{name}.weight"] = nrm[at:at + r * d].view(r, d)
        at += r * d
    return out["egnn"], out["adj"]
