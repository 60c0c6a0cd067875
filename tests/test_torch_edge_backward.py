"""The edge pass's gradient: the plain backward against ``jax.vjp`` of the
JAX package's dense edge pass, and the autograd Function on CPU tensors.

JAX's dense path is ``models/egnn.py`` ``_edge_stack_apply`` with the gate
and masked j-sum of ``gcl_forward`` (mode "gcl") or the head of
``coord_update_forward`` (mode "coord"); it takes h and the first layer's
full weight, so the port's u = h W_src, v = h W_tgt are chained through by
hand. float64 holds every gradient to 1e-10. The backward kernel itself
runs only on the card (``tests/test_torch_gcl_kernel_cuda.py``); here its
pack of W1 and the wrapper's reduction of what it writes are held, the
latter fed a plain-torch emulation of its outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_conformer_generator_tpu.models import egnn as jegnn
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
from test_torch_edge_pack_f32 import _unpack

NORM = 100.0
NAMES = ["du", "dv", "de", "dw_e", "db0", "dw1", "db1", "dwh", "dbh"]


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _case(B, N, H, E, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(N - 3, N + 1, size=B)
    nm = (np.arange(N)[None] < n[:, None]).astype(np.float64)
    em = nm[:, :, None] * nm[:, None, :] * (1 - np.eye(N))
    f = lambda *s, sc=1.0: rng.standard_normal(s) * sc
    return dict(h=f(B, N, H), ef=f(B, N, N, E), em=em[..., None],
                w0=f(2 * H + E, H, sc=H ** -0.5), b0=f(H, sc=0.1),
                w1=f(H, H, sc=H ** -0.5), b1=f(H, sc=0.1),
                wh=f(H, 1, sc=H ** -0.5), bh=f(1), g_gcl=f(B, N, H),
                g_coord=f(B, N, N, 1))


def _jax_edge(mode, h, w0, b0, w1, b1, wh, bh, ef, em):
    m = jegnn._edge_stack_apply({"w": w0, "b": b0}, {"w": w1, "b": b1}, h, ef)
    if mode == "coord":
        return m @ wh                                        # (B, N, N, 1)
    gate = jax.nn.sigmoid(m @ wh + bh)
    return jnp.sum(m * gate * em, axis=2) / NORM             # (B, N, H)


def _port_args(c, mode):
    B, N, H = c["h"].shape
    E = c["ef"].shape[-1]
    t = torch.tensor
    h, w0 = t(c["h"]), t(c["w0"])
    args = dict(u=h @ w0[:H], v=h @ w0[H:2 * H],
                ef=t(c["ef"]).reshape(B, N * N, E),
                em=t(c["em"]).reshape(B, N * N, 1), w_e=w0[2 * H:].t(),
                b0=t(c["b0"]), w1=t(c["w1"]).t(), b1=t(c["b1"]),
                wh=t(c["wh"]).reshape(H), bh=t(c["bh"]))
    if mode == "coord":
        args["em"], args["bh"] = None, None
    g = t(c["g_gcl"]) if mode == "gcl" else t(c["g_coord"]).reshape(
        B, N * N, 1)
    return args, g


@pytest.mark.parametrize("shape", [(2, 7, 16, 2), (3, 12, 24, 2),
                                   (2, 9, 32, 3)])
@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_plain_backward_matches_jax_vjp_f64(x64, mode, shape):
    """Every input and weight gradient of the plain backward equals
    ``jax.vjp`` of JAX's dense edge pass to 1e-10 in float64 (du and dv
    through u = h W_src, v = h W_tgt)."""
    B, N, H, E = shape
    c = _case(B, N, H, E, seed=sum(shape))
    diff = ["h", "w0", "b0", "w1", "b1", "wh", "bh", "ef"]
    fn = lambda *a: _jax_edge(mode, *a, jnp.asarray(c["em"]))
    _, vjp = jax.vjp(fn, *(jnp.asarray(c[k]) for k in diff))
    g_jax = c["g_gcl"] if mode == "gcl" else c["g_coord"]
    jg = dict(zip(diff, (np.asarray(a) for a in vjp(jnp.asarray(g_jax)))))

    args, g = _port_args(c, mode)
    got = dict(zip(NAMES, gk.fused_edge_pass_backward_reference(
        **args, g=g, mode=mode)))
    h = torch.tensor(c["h"])
    w0 = torch.tensor(c["w0"])
    hf = h.reshape(-1, H)
    dh = got["du"] @ w0[:H].t() + got["dv"] @ w0[H:2 * H].t()
    port = {
        "h": dh,
        "w0": torch.cat([hf.t() @ got["du"].reshape(-1, H),
                         hf.t() @ got["dv"].reshape(-1, H),
                         got["dw_e"].t()]),
        "b0": got["db0"], "w1": got["dw1"].t(), "b1": got["db1"],
        "wh": got["dwh"].reshape(H, 1),
        "ef": got["de"].reshape(B, N, N, E)}
    if mode == "gcl":
        port["bh"] = got["dbh"]
    else:
        assert got["dbh"] is None
        np.testing.assert_array_equal(jg["bh"], 0.0)   # no head bias
    for k, v in port.items():
        np.testing.assert_allclose(v.numpy(), jg[k], rtol=1e-10, atol=1e-10,
                                   err_msg=k)
    assert all(np.abs(jg[k]).max() > 0 for k in port)


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_function_on_cpu_equals_autograd_of_plain(mode):
    """On CPU tensors the autograd Function's forward is the plain version
    and its backward the plain backward: every gradient equals autograd of
    the plain version exactly, and no kernel is launched."""
    c = _case(2, 8, 16, 2, seed=3)
    args, g = _port_args(c, mode)
    args = {k: (v.float() if v is not None else None)
            for k, v in args.items()}
    g = g.float()

    def leaves():
        return {k: (v.clone().requires_grad_(k != "em")
                    if v is not None else None) for k, v in args.items()}

    gk.reset_launch_counts()
    a = leaves()
    out = gk._EdgePassFunction.apply(
        a["u"], a["v"], a["ef"], a["em"], a["w_e"], a["b0"], a["w1"],
        a["b1"], a["wh"], a["bh"], mode, NORM)
    out.backward(g)
    b = leaves()
    ref = gk.fused_edge_pass_reference(**b, mode=mode)
    ref.backward(g)
    assert torch.equal(out, ref)
    for k in ("u", "v", "ef", "w_e", "b0", "w1", "b1", "wh", "bh"):
        if a[k] is None:
            continue
        assert torch.equal(a[k].grad, b[k].grad), k
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 0}


def test_backward_reference_returns_the_wrappers_outputs():
    """The plain backward's outputs have its inputs' shapes, and the CPU
    wrapper is the plain backward."""
    c = _case(2, 6, 16, 2, seed=5)
    for mode in ("gcl", "coord"):
        args, g = _port_args(c, mode)
        ref = gk.fused_edge_pass_backward_reference(**args, g=g, mode=mode)
        got = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
        want = [args["u"], args["v"], args["ef"], args["w_e"], args["b0"],
                args["w1"], args["b1"], args["wh"], args["bh"]]
        for r, x, w in zip(ref, got, want):
            if w is None:
                assert r is None and x is None
                continue
            assert r.shape == w.shape and torch.equal(r, x)


def test_pack_w1_bwd_layouts():
    """The backward's pack of W1 is the forward's layout of W1^T (the
    second product's [out][in] operand): unpacked, its TF32 parts and
    residuals are W1^T's bit for bit, zero-padded."""
    H = 20
    w1 = torch.randn(H, H)
    fwd, bwd = gk.packed_w1(w1, backward=True)
    assert torch.equal(fwd, gk.pack_w1(w1))
    assert bwd.shape == fwd.shape
    hi, lo = _unpack(bwd, H)
    want_hi = gk.round_tf32(w1.t())
    assert torch.equal(hi[:H, :H], want_hi)
    assert torch.equal(lo[:H, :H], gk.round_tf32(w1.t() - want_hi))
    assert hi[H:].abs().max() == 0 and hi[:, H:].abs().max() == 0
    assert lo[H:].abs().max() == 0 and lo[:, H:].abs().max() == 0
    with pytest.raises(ValueError):
        gk.pack_w1(torch.randn(H, H + 1))


def test_packed_w1_backward_layouts_come_in_the_same_pack():
    """A pack asked for with its backward layouts is one pack; a later
    forward-only request hits it; an in-place update repacks both."""
    w1 = torch.randn(16, 16)
    gk.reset_pack_count()
    fwd, bwd = gk.packed_w1(w1, backward=True)
    assert gk.PACKS == 1
    assert gk.packed_w1(w1) is fwd and gk.PACKS == 1
    assert gk.packed_w1(w1, backward=True)[1] is bwd and gk.PACKS == 1
    with torch.no_grad():
        w1.add_(1.0)
    fwd2, bwd2 = gk.packed_w1(w1, backward=True)
    assert gk.PACKS == 2
    assert torch.equal(fwd2, gk.pack_w1(w1))
    assert torch.equal(bwd2, gk.pack_w1(w1.t()))
    # a forward-only pack is extended, not served, when the backward asks
    w2 = torch.randn(16, 16)
    gk.packed_w1(w2)
    gk.packed_w1(w2, backward=True)
    assert gk.PACKS == 4


def test_backward_tiles_hold_whole_nodes():
    """The backward kernel's tiles: whole target nodes of one graph, at most
    128 edge rows, as few tiles a graph as that allows."""
    for n in range(1, 129):
        ti, tpg = gk.backward_tiles(n)
        assert ti * n <= 128 and ti * tpg >= n > ti * (tpg - 1)
    assert gk.backward_tiles(39) == (3, 13)
    assert gk.backward_tiles(40) == (3, 14)
    assert gk.backward_tiles(128) == (1, 128)


def _kernel_outputs(args, g, mode, blocks=3, warps=8):
    """What the backward kernel writes (``gk._reduce_backward``'s input),
    made in plain torch in its layout: s0 with its column of ones, dpre1,
    du, the dv partials by tile of whole target nodes, de, sum_j dpre0 e per
    target node, dhead per edge, and the dwh sums spread over blocks and
    warps (edges dealt round the rows of ``part``)."""
    u, v, ef, w_e, w1, wh = (args[k] for k in
                             ("u", "v", "ef", "w_e", "w1", "wh"))
    B, N, H = u.shape
    E = ef.shape[-1]
    e = ef.reshape(B, N, N, E)
    dsilu = lambda x: torch.sigmoid(x) * (1 + x * (1 - torch.sigmoid(x)))
    pre0 = u[:, :, None] + v[:, None] + e @ w_e.t() + args["b0"]
    s0 = torch.nn.functional.silu(pre0)
    pre1 = s0 @ w1.t() + args["b1"]
    m = torch.nn.functional.silu(pre1)
    if mode == "gcl":
        gate = torch.sigmoid(m @ wh + args["bh"])
        scale = args["em"].reshape(B, N, N) / NORM
        gi = g[:, :, None, :]
        dhead = (gi * m).sum(-1) * scale * gate * (1 - gate)
        dm = gi * (scale * gate)[..., None] + dhead[..., None] * wh
    else:
        dhead = g.reshape(B, N, N)
        dm = dhead[..., None] * wh
    dpre1 = dm * dsilu(pre1)
    dpre0 = (dpre1 @ w1) * dsilu(pre0)
    ti, tpg = gk.backward_tiles(N)
    dvp = torch.stack([dpre0[:, t * ti:(t + 1) * ti].sum(1)
                       for t in range(tpg)], 1)
    M = B * N * N
    part = torch.zeros(blocks * warps, 448, dtype=u.dtype)
    rows = (dhead[..., None] * m).reshape(M, H)
    for k in range(blocks * warps):
        part[k, :H] = rows[k::blocks * warps].sum(0)
    s0_ext = torch.zeros(M, H + 4, dtype=u.dtype)
    s0_ext[:, :H] = s0.reshape(M, H)
    s0_ext[:, H] = 1.0
    return dict(s0=s0_ext, dpre1=dpre1.reshape(M, H), du=dpre0.sum(2),
                dvp=dvp, de=(dpre0 @ w_e).reshape(B, N * N, E),
                dwe=torch.einsum("bijh,bijq->biqh", dpre0, e),
                dhead=dhead.reshape(M),
                part=part.reshape(blocks, warps, 448))


@pytest.mark.parametrize("shape", [(2, 40, 16, 2), (1, 70, 12, 3),
                                   (3, 9, 20, 2)])
@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_reduce_backward_matches_plain_backward(mode, shape):
    """The wrapper's reduction of the kernel's outputs (dv partials added
    over tiles, dW_e from the per-node sums, db0 from du, [dW1 | db1] from
    s0's column of ones, dwh over blocks and warps, dbh over edges) gives
    the plain backward's gradients to 1e-10 in float64, when fed what the
    kernel writes, emulated in plain torch. Shapes: a last tile of one node
    (N = 40), one node a tile (N = 70), E = 3."""
    B, N, H, E = shape
    c = _case(B, N, H, E, seed=N + H)
    args, g = _port_args(c, mode)
    ref = gk.fused_edge_pass_backward_reference(**args, g=g, mode=mode)
    raw = _kernel_outputs(args, g, mode)
    assert raw["dvp"].shape == (B, gk.backward_tiles(N)[1], N, H)
    got = gk._reduce_backward(raw, args["bh"] is not None)
    for name, x, r in zip(NAMES, got, ref):
        if r is None:
            assert x is None and mode == "coord", name
            continue
        assert x.shape == r.shape, name
        torch.testing.assert_close(x, r, rtol=1e-10, atol=1e-10, msg=name)
