"""Operations and bytes of the work, from shapes, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s on the bfloat16 tensor cores, 3.35 TB/s of HBM3. A
float32 configuration's products are taken as 3xTF32, three TF32
tensor-core products (495 TFLOP/s) for each float32-accurate one, so its
peak is 495 / 3 = 165 TFLOP/s: that is how the port's float32 edge kernels
compute, and at the 67 TFLOP/s of float32 outside the tensor cores their
share would read over 100%.
"""

from __future__ import annotations

PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_BYTES = 3.35e12


def edge_pass_bound(B, N, H, E, dtype_name, mode, backward=False, NL=None):
    """Least seconds of one fused edge pass of (B graphs, N target by NL
    source nodes, width H, E edge scalars), and what bounds it.

    Forward operations: the per-edge products (edge scalars through W_e,
    m1 through W1, m2 through the head), 2 B N NL H (H + E + 1), at the
    rate of the configuration's products. Bytes: each input read once (u,
    v, edge scalars, weights, in "gcl" the edge mask), the float32 output
    written once. ``backward``: the float32 backward call, its three
    products of the edge chain (the recompute s0 W1^T, dpre1 W1, dW1 =
    dpre1^T s0), 3 x 2 B N NL H^2, bytes of its inputs and outputs."""
    NL = N if NL is None else NL
    edges = B * N * NL
    nodes = B * (N + NL) * H
    if backward:
        ops = 3 * 2.0 * edges * H * H
        n_in = (nodes + edges * E + H * E + H * H + 3 * H
                + (edges + 1 + B * N * H if mode == "gcl" else edges))
        n_out = (nodes + edges * E + H * E + H * H + 3 * H
                 + (1 if mode == "gcl" else 0))
        t_ops = ops / PEAK_OPS["float32"]
        t_bytes = (n_in + n_out) * 4 / PEAK_BYTES
    else:
        el = 2 if dtype_name == "bfloat16" else 4
        ops = 2.0 * edges * H * (H + E + 1)
        n_in = nodes + edges * E + H * E + H * H + 3 * H
        if mode == "gcl":
            n_in += edges + 1
        n_out = B * N * H if mode == "gcl" else edges
        t_ops = ops / PEAK_OPS[dtype_name]
        t_bytes = (n_in * el + n_out * 4) / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def egnn_forward_flops(cfg, n: int) -> float:
    """Operations one denoiser forward needs for one molecule of ``n``
    atoms: the edge MLPs on its n (n - 1) edges (2 gcl and 1 coordinate
    pass a block; the first layer taken per node, as [h_i, h_j] W splits),
    the per-node products, the embeddings in and out."""
    H, E = cfg["hidden_nf"], cfg["edge_feat_nf"]
    nf = cfg["in_node_nf"] + cfg["context_node_nf"]
    edges = n * (n - 1)
    edge = 3 * 2.0 * edges * H * (H + E + 1)
    node = (3 * 2 * 2.0 * n * H * H                # u, v of each pass
            + 2 * (2.0 * n * 2 * H * H + 2.0 * n * H * H))   # node MLPs
    return cfg["n_blocks"] * (edge + node) + 2 * 2.0 * n * nf * H


def adj_mat_seer_flops(cfg, B: int) -> float:
    """Operations of one bond-predictor forward on B padded graphs."""
    D, Hd, E = cfg["dimension"], cfg["n_hidden"], cfg["embedding_dim"]
    per = (2.0 * D * E * Hd + 2 * 2.0 * D * Hd * Hd + 3 * 2.0 * D * D * Hd
           + 2.0 * D * Hd                              # distance branch
           + 2.0 * D * D * E                            # coordinate fc
           + 2.0 * D * E * Hd + 3 * 2.0 * D * Hd * Hd + 4 * 2.0 * D * D * Hd
           + 2.0 * D * Hd * D * cfg["num_bond_types"])  # main branch, head
    return B * per


def request_flops(cfg, atoms) -> float:
    """Model operations of one sampling request whose samples have
    ``atoms`` real atoms: T + 1 denoiser forwards each, and the bond
    predictor on the batch. Host chemistry and the force field count
    nothing."""
    fwd = sum(egnn_forward_flops(cfg, n) for n in atoms)
    return (cfg["timesteps"] + 1) * fwd + adj_mat_seer_flops(cfg, len(atoms))


def train_step_flops(cfg, atoms) -> float:
    """Model operations of one training step on molecules of ``atoms``
    real atoms: the forward and a backward of twice its work; neither the
    recompute of rematerialisation nor the optimizer counts."""
    return 3 * sum(egnn_forward_flops(cfg, n) for n in atoms)
