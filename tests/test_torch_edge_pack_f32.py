"""The split, packed float32 W1 that the float32 edge-pass kernel reads, its
cache, and the precision of the kernel's 3xTF32 product.

``pack_w1`` is plain torch on any device, so the layout is held here on the
CPU; the kernel's view of it (tile, row, swizzled 16-byte chunk, the TF32
part and residual, the column order its A fragments need) is spelled out
below independently of the function. The kernel's product, hi.hi + hi.lo +
lo.hi in TF32 with f32 sums, is emulated in plain torch and held against
the plain float32 version with the bar ``chip_smoke.py`` holds the kernel to.
"""

import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

NP, NH, KT = 448, 224, 16   # padded rows, rows per tile, columns per K-tile
ATOL, RTOL = 1e-5, 1e-4     # the float32 bar of chip_smoke.py


def _position(kk):
    """Place of K-tile column kk in a row's 16 hi (or lo) values: thread t
    of a quad builds columns 4 t .. 4 t + 3; its column 4 t + 2 s + h is
    the A fragment's logical column 8 s + 4 h + t."""
    t, c = divmod(kk, 4)
    s, h = divmod(c, 2)
    return 8 * s + 4 * h + t


def _unpack(packed, H):
    """The (hi, lo) planes, each the padded (NP, 16 ceil(H / 16)) matrix,
    that ``pack_w1`` laid out: tiles by (half, K-tile), rows of 8 chunks of
    4 values, chunk d of row r at d ^ (r % 8); a row is 16 hi then 16 lo
    values, column kk of the K-tile at place ``_position(kk)``."""
    nkt = -(-H // KT)
    tiles = packed.view(2, nkt, NH, 8, 4)
    idx = (torch.arange(8)[None, :] ^ (torch.arange(NH)[:, None] % 8))
    idx = idx[None, None, :, :, None].expand_as(tiles)
    rows = (torch.gather(tiles, 3, idx).permute(0, 2, 1, 3, 4)
            .reshape(NP, nkt, 2, KT))
    places = torch.tensor([_position(kk) for kk in range(KT)])
    planes = rows[..., places]            # column kk from its place
    return (planes[:, :, 0].reshape(NP, nkt * KT),
            planes[:, :, 1].reshape(NP, nkt * KT))


def _w1(H, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor((rng.standard_normal((H, H)) * H ** -0.5)
                        .astype(np.float32))


@pytest.mark.parametrize("H", [64, 420])
def test_pack_splits_w1_into_tf32_parts(H):
    """hi is exact TF32 (its low 13 bits are zero), so is lo, and hi + lo
    gives W1 back to within 2^-22 |W1|."""
    w1 = _w1(H)
    packed = gk.pack_w1(w1)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert packed.numel() == 2 * (NP * KT * -(-H // KT))
    hi, lo = _unpack(packed, H)
    for plane in (hi, lo):
        assert (plane.view(torch.int32) & 0x1FFF).abs().sum().item() == 0
    w, h, l = w1.double(), hi[:H, :H].double(), lo[:H, :H].double()
    assert ((w - h - l).abs() <= 2.0 ** -22 * w.abs()).all()
    assert ((w - h).abs() <= 2.0 ** -11 * w.abs()).all()
    assert (l != 0).float().mean().item() > 0.9   # lo carries information


@pytest.mark.parametrize("H", [64, 420])
def test_unpack_gives_zero_padded_w1(H):
    w1 = _w1(H, seed=1)
    hi, lo = _unpack(gk.pack_w1(w1), H)
    HP = KT * -(-H // KT)
    assert hi.shape == (NP, HP)
    assert torch.equal(hi[:H, :H] + lo[:H, :H], (hi + lo)[:H, :H])
    assert torch.equal(hi[:H, :H], gk.round_tf32(w1))
    assert hi[H:].abs().sum() == 0 and hi[:, H:].abs().sum() == 0
    assert lo[H:].abs().sum() == 0 and lo[:, H:].abs().sum() == 0


def test_packed_layout_is_the_kernels():
    """Element (n, k) has its TF32 part in tile (n // 224) * nkt + k // 16,
    row n % 224 of 128 bytes, value _position(k % 16) of the row, and its
    residual 16 values on; value p of a row sits in 16-byte chunk
    (p // 4) ^ (row % 8), place p % 4."""
    H = 420
    w1 = _w1(H, seed=2)
    nkt = -(-H // KT)
    packed = gk.pack_w1(w1)
    rng = np.random.default_rng(3)
    for n, k in zip(rng.integers(0, H, 300), rng.integers(0, H, 300)):
        half, row = divmod(int(n), NH)
        kt, kk = divmod(int(k), KT)
        base = ((half * nkt + kt) * NH + row) * 32
        at = [base + ((p // 4) ^ (row % 8)) * 4 + p % 4
              for p in (_position(kk), 16 + _position(kk))]
        hi, lo = packed[at[0]].item(), packed[at[1]].item()
        want_hi = gk.round_tf32(w1[n, k].reshape(1)).item()
        assert hi == want_hi
        assert abs(float(w1[n, k]) - hi - lo) <= 2.0 ** -22 * abs(float(w1[n, k]))


def test_round_tf32_is_round_to_nearest_ties_away():
    bits = torch.tensor([0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F801FFF,
                         0xBF801000 - 2 ** 32, 0x00000000], dtype=torch.int32)
    got = gk.round_tf32(bits.view(torch.float32)).view(torch.int32).tolist()
    assert got == [0x3F800000, 0x3F800000, 0x3F802000, 0x3F802000,
                   0xBF802000 - 2 ** 32, 0]


def test_cache_packs_a_float32_weight_once():
    lin = torch.nn.Linear(64, 64)
    gk.reset_pack_count()
    first = gk.packed_w1(lin.weight)
    assert gk.packed_w1(lin.weight) is first and gk.PACKS == 1
    assert first.dtype == torch.float32


def test_cache_repacks_a_float32_weight_after_an_inplace_update():
    lin = torch.nn.Linear(64, 64)
    gk.reset_pack_count()
    first = gk.packed_w1(lin.weight)
    with torch.no_grad():
        lin.weight.mul_(2.0)
    second = gk.packed_w1(lin.weight)
    assert second is not first and gk.PACKS == 2
    hi, _ = _unpack(second, 64)
    assert torch.equal(hi[:64, :64], gk.round_tf32(lin.weight.detach()))


def test_cache_repacks_a_float32_weight_after_to():
    lin = torch.nn.Linear(64, 64)
    gk.reset_pack_count()
    first = gk.packed_w1(lin.weight)
    lin = lin.to(torch.float64).to(torch.float32)   # new storage
    second = gk.packed_w1(lin.weight)
    assert second is not first and gk.PACKS == 2
    bf = lin.to(torch.bfloat16)
    assert gk.packed_w1(bf.weight).dtype == torch.bfloat16 and gk.PACKS == 3
    gc.collect()


# ---- the precision of the kernel's product ----------------------------------

def _edge_inputs(B=8, N=40, H=420, E=2, seed=0):
    """Operands with chip_smoke.py's distributions: graphs of 15 to 39
    nodes, unit-normal u, v and edge scalars, weights scaled by H^-1/2."""
    rng = np.random.default_rng(seed)
    n = rng.integers(15, 40, size=B).clip(max=N)
    nm = (np.arange(N)[None] < n[:, None]).astype(np.float32)
    em = nm[:, :, None] * nm[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    f = lambda *s, sc=1.0: torch.tensor(
        (rng.standard_normal(s) * sc).astype(np.float32))
    return dict(u=f(B, N, H), v=f(B, N, H), ef=f(B, N * N, E),
                em=torch.tensor(em.reshape(B, N * N, 1)),
                w_e=f(H, E, sc=H ** -0.5), b0=f(H, sc=0.1),
                w1=f(H, H, sc=H ** -0.5), b1=f(H, sc=0.1),
                wh=f(H, sc=H ** -0.5), bh=f(1))


def _emulated(a, mode, passes):
    """The fused pass with m1 . W1^T taken as the kernel takes it: m1 split
    as the kernel splits it (cvt.rna, then the residual rounded), W1's parts
    from the pack, TF32 products (exact in f32) summed in f32. passes=3:
    hi.hi + hi.lo + lo.hi (the kernel); passes=1: hi.hi alone (plain
    TF32)."""
    u, v, ef, w_e = a["u"], a["v"], a["ef"], a["w_e"]
    B, N, H = u.shape
    pre = (u[:, :, None, :] + v[:, None, :, :]
           + ef.reshape(B, N, N, -1) @ w_e.t() + a["b0"])
    m1 = F.silu(pre)
    m1_hi = gk.round_tf32(m1)
    m1_lo = gk.round_tf32(m1 - m1_hi)
    w_hi, w_lo = (p[:H, :H] for p in _unpack(gk.pack_w1(a["w1"]), H))
    prod = m1_hi @ w_hi.t()
    if passes == 3:
        prod = prod + m1_hi @ w_lo.t() + m1_lo @ w_hi.t()
    m = F.silu(prod + a["b1"])
    head = m @ a["wh"]
    if mode == "coord":
        return head.reshape(B, N * N, 1)
    gate = torch.sigmoid(head + a["bh"])[..., None]
    return (m * gate * a["em"].reshape(B, N, N, 1)).sum(2) / 100.0


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_3xtf32_meets_the_f32_bar_and_1xtf32_does_not(mode):
    """At the production width the split product stays inside the float32
    bar (1e-5 + 1e-4 |ref|) by a wide margin, and one TF32 pass falls
    outside it: the bar tells the two schemes apart."""
    a = _edge_inputs()
    args = dict(a)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    ref = gk.fused_edge_pass_reference(**args, mode=mode)
    excess = {}
    for passes in (3, 1):
        got = _emulated(a, mode, passes)
        assert got.shape == ref.shape
        excess[passes] = (got - ref).abs() - ATOL - RTOL * ref.abs()
    assert excess[3].max().item() < -0.5 * ATOL
    assert excess[1].max().item() > 0.0
