"""The CUDA edge-pass kernels (forward and float32 backward) against their
plain versions, on the card.

Imports torch only, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_gcl_kernel_cuda.py -q

Without a CUDA device every test skips.
"""

import re

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread)
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, B=3, N=42, H=64, E=2, seed=0, n_min=15):
    """Operands as the model passes them; w_e a column block of the first
    edge layer (row stride 2H + E); graph sizes drawn from [n_min, N]."""
    rng = np.random.default_rng(seed)
    n = rng.integers(min(n_min, N), N + 1, size=B)
    nm = (np.arange(N)[None] < n[:, None]).astype(np.float32)
    em = nm[:, :, None] * nm[:, None, :] * (1 - np.eye(N, dtype=np.float32))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32)).to("cuda", dtype)

    f = lambda *s, sc=1.0: rng.standard_normal(s) * sc
    w0 = t(f(H, 2 * H + E, sc=H ** -0.5))
    args = dict(u=t(f(B, N, H)), v=t(f(B, N, H)), ef=t(f(B, N * N, E)),
                em=t(em.reshape(B, N * N, 1)), w_e=w0[:, 2 * H:],
                b0=t(f(H, sc=0.1)), w1=t(f(H, H, sc=H ** -0.5)),
                b1=t(f(H, sc=0.1)), wh=t(f(H, sc=H ** -0.5)), bh=t(f(1)))
    return args, torch.tensor(nm, device="cuda")


# (B, N, H): nodes that do not fill a tile (42, 24), the full width (420),
# more than 48 and more than 64 nodes, and the most nodes a tile holds; the
# sampling cells' node buckets at 64 samples (several tiles a block), 10
# samples at N = 40 (one partly filled wave), an odd N past 64 (one node a
# tile, the second m-tile partly filled) and a full tile of one node; the
# drugs cell's requests at 48 and 96 atoms (H = 256: half 1 32 columns wide,
# every consumer thread building m1).
BF16_SHAPES = [(3, 42, 64), (3, 40, 420), (5, 24, 420), (2, 64, 420),
               (1, 100, 64), (64, 24, 420), (64, 32, 420), (64, 40, 420),
               (10, 40, 420), (2, 65, 420), (1, 128, 420), (16, 48, 256),
               (16, 96, 256)]
F32_SHAPES = [(3, 42, 64), (3, 40, 420), (2, 64, 420), (1, 100, 64),
              (2, 128, 420)]


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize(
    "dtype,shape",
    [(torch.bfloat16, s) for s in BF16_SHAPES]
    + [(torch.float32, s) for s in F32_SHAPES])
def test_cuda_tensors_launch_the_kernel(card, mode, dtype, shape):
    """A CUDA tensor launches the kernel (never the plain version), and the
    kernel matches the plain version: f32 1e-5/1e-4 (the j-sum order
    differs); bf16 gcl 5e-3/1e-2 (its outputs are j-sums / 100, mostly below
    0.1), bf16 coord 5e-2 (the f32 order of the head's sum differs too);
    masked rows are exactly 0."""
    B, N, H = shape
    args, nm = _inputs(dtype, B=B, N=N, H=H)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    gk.reset_launch_counts()
    out = gk.fused_edge_pass(**args, mode=mode)
    ref = gk.fused_edge_pass_reference(**args, mode=mode).float()
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gcl": int(mode == "gcl"),
                           "coord": int(mode == "coord"), "gcl_bwd": 0,
                           "coord_bwd": 0}
    if dtype == torch.float32:
        atol, rtol = 1e-5, 1e-4
    else:
        atol, rtol = (5e-3, 1e-2) if mode == "gcl" else (5e-2, 5e-2)
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    if mode == "gcl":
        assert out[nm == 0].abs().max().item() == 0.0


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_bf16_launches_are_bit_equal(card, mode):
    """Two launches with the same inputs give the same bits: each node's
    j-sum is added in a fixed order, with no atomics (the sampler's graphs
    rely on it)."""
    args, _ = _inputs(torch.bfloat16, B=64, N=40, H=420)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    first = gk.fused_edge_pass(**args, mode=mode)
    second = gk.fused_edge_pass(**args, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (B, N, H, smallest graph): GEOM-Drugs' largest molecules at 32 samples
# (N = 184, sizes from 15 up: graphs wholly inside the first slab too), 144
# atoms, a second slab of 8 source nodes at the MLCG width, and the most
# nodes the kernel takes (the second slab one whole m-tile).
WIDE_SHAPES = [(32, 184, 256, 15), (32, 144, 256, 129), (4, 136, 420, 129),
               (1, 192, 256, 192)]


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=str)
def test_bf16_wide_kernel_matches_plain(card, mode, shape):
    """Past 128 nodes the bfloat16 kernel's wide path (each target node's
    source nodes in two slabs, the j-sum carried across them) against the
    plain version at the bars of the N <= 128 shapes; one launch, counted
    as a wide pass; masked rows exactly 0."""
    B, N, H, n_min = shape
    args, nm = _inputs(torch.bfloat16, B=B, N=N, H=H, seed=N, n_min=n_min)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    gk.reset_launch_counts()
    out = gk.fused_edge_pass(**args, mode=mode)
    ref = gk.fused_edge_pass_reference(**args, mode=mode).float()
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gcl": int(mode == "gcl"),
                           "coord": int(mode == "coord"), "gcl_bwd": 0,
                           "coord_bwd": 0}
    assert gk.PASSES == {"gcl": 0, "coord": 0,
                         "gcl_wide": int(mode == "gcl"),
                         "coord_wide": int(mode == "coord")}
    atol, rtol = (5e-3, 1e-2) if mode == "gcl" else (5e-2, 5e-2)
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    if mode == "gcl" and (nm == 0).any():
        assert out[nm == 0].abs().max().item() == 0.0


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_bf16_wide_launches_are_bit_equal(card, mode):
    """Two launches of the wide path give the same bits: the j-sum runs on
    across the slabs in a fixed order, with no atomics."""
    args, _ = _inputs(torch.bfloat16, B=32, N=184, H=256)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    first = gk.fused_edge_pass(**args, mode=mode)
    second = gk.fused_edge_pass(**args, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("H,N1,sizes", [(256, 32, (96, 184)),
                                         (420, 200, (40, 136))])
def test_bf16_instantiation_is_chosen_by_width(card, H, N1, sizes):
    """Which instantiation runs is decided by H alone: a device trace names
    half 1's width N1 in both modes and both bodies (N <= 128 and wide),
    32 at GEOM-Drugs' 256 and 200 at MLCG's 420."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for N in sizes:
            args, _ = _inputs(torch.bfloat16, B=2, N=N, H=H, seed=N)
            gk.fused_edge_pass(**args, mode="gcl")
            gk.fused_edge_pass(**dict(args, em=None, bh=None), mode="coord")
        torch.cuda.synchronize()
    pattern = re.compile(r"edge_mlp_bf16(_wide)?_kernel<(true|false), (\d+)>")
    found = {m.groups() for e in prof.key_averages()
             for m in [pattern.search(e.key)] if m}
    assert found == {(wide, gcl, str(N1)) for wide in (None, "_wide")
                     for gcl in ("true", "false")}


def test_f32_kernel_refuses_a_wide_graph(card):
    """The float32 kernels take at most 192 nodes, and j-slabs at most 128:
    a larger graph, or a slab of a GEOM-Drugs-sized graph, raises, naming
    the limit, before any launch."""
    gk.reset_launch_counts()
    with pytest.raises(ValueError, match="float32 kernel takes N <= 192"):
        gk.fused_edge_pass(**_inputs(torch.float32, B=2, N=193, H=64)[0],
                           mode="gcl")
    args, _ = _inputs(torch.float32, B=2, N=184, H=64)
    NL = 92
    slab = dict(args, v=args["v"][:, :NL].contiguous(),
                ef=args["ef"].reshape(2, 184, 184, -1)[:, :, :NL]
                .reshape(2, 184 * NL, -1).contiguous(),
                em=args["em"].reshape(2, 184, 184, 1)[:, :, :NL]
                .reshape(2, 184 * NL, 1).contiguous())
    with pytest.raises(ValueError, match="j-slabs at N <= 128"):
        gk.fused_edge_pass(**slab, mode="gcl")
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 0}


# (B, N, H, smallest graph) of the float32 wide paths: the drugs training
# cell's largest pad at 16 molecules (graphs wholly inside the first slab
# too) and at 144 nodes, a second slab of one source node, and the most
# nodes the paths take.
F32_WIDE_SHAPES = [(16, 184, 256, 24), (64, 144, 256, 24),
                   (2, 129, 256, 129), (1, 192, 256, 192)]


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("shape", F32_WIDE_SHAPES, ids=str)
def test_f32_wide_kernels_match_plain(card, mode, shape):
    """Past 128 nodes the float32 forward and backward kernels' wide paths
    (``edge_mlp_f32_wide_kernel``, ``edge_mlp_bwd_f32_wide_kernel``)
    against the plain versions at the N <= 128 bars: the forward within
    1e-5 + 1e-4 |ref|, du, dv and de likewise, the edge-summed weight
    gradients within 1e-4 of their largest entry; one launch each, the
    forward counted as a wide pass; masked rows exactly 0; a second call
    of each bit-equal to the first."""
    B, N, H, n_min = shape
    args, nm = _inputs(torch.float32, B=B, N=N, H=H, seed=N, n_min=n_min)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    gk.reset_launch_counts()
    out = gk.fused_edge_pass(**args, mode=mode)
    torch.cuda.synchronize()
    assert gk.PASSES == {"gcl": 0, "coord": 0,
                         "gcl_wide": int(mode == "gcl"),
                         "coord_wide": int(mode == "coord")}
    ref = gk.fused_edge_pass_reference(**args, mode=mode)
    assert ((out - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all()
    if mode == "gcl" and (nm == 0).any():
        assert out[nm == 0].abs().max().item() == 0.0
    assert torch.equal(out, gk.fused_edge_pass(**args, mode=mode))
    del out, ref
    rng = np.random.default_rng(N + 1)
    g_shape = (B, N, H) if mode == "gcl" else (B, N * N, 1)
    g = torch.tensor(rng.standard_normal(g_shape), dtype=torch.float32,
                     device="cuda")
    gk.reset_launch_counts()
    got = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0,
                           "gcl_bwd": int(mode == "gcl"),
                           "coord_bwd": int(mode == "coord")}
    again = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
    ref = gk.fused_edge_pass_backward_reference(**args, g=g, mode=mode)
    for name, x, y, r in zip(GRAD_NAMES, got, again, ref):
        if r is None:
            assert x is None and mode == "coord"
            continue
        assert torch.equal(x, y), name
        err = (x - r).abs()
        if name in ("du", "dv", "de"):
            assert (err <= 1e-5 + 1e-4 * r.abs()).all(), (name, err.max())
        else:
            assert err.max() <= 1e-4 * r.abs().max(), (name, err.max())


def test_f32_wide_kernels_have_names_of_their_own(card):
    """A device trace names the wide launches apart from the N <= 128
    ones, in both modes, forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for N in (96, 144):
            args, _ = _inputs(torch.float32, B=2, N=N, H=256, seed=N)
            for mode in ("gcl", "coord"):
                a = args if mode == "gcl" else dict(args, em=None, bh=None)
                gk.fused_edge_pass(**a, mode=mode)
                g = (torch.ones(2, N, 256, device="cuda") if mode == "gcl"
                     else torch.ones(2, N * N, 1, device="cuda"))
                gk.fused_edge_pass_backward(**a, g=g, mode=mode)
        torch.cuda.synchronize()
    pattern = re.compile(r"edge_mlp_(f32|bwd_f32)(_wide)?_kernel<(true|false)")
    found = {m.groups() for e in prof.key_averages()
             for m in [pattern.search(e.key)] if m}
    assert found == {(k, w, gcl) for k in ("f32", "bwd_f32")
                     for w in (None, "_wide") for gcl in ("true", "false")}


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    args, _ = _inputs(torch.bfloat16)
    gk.reset_launch_counts()
    with pytest.raises(TypeError):
        gk.fused_edge_pass(**dict(args, b0=args["b0"].float()), mode="gcl")
    with pytest.raises(ValueError):
        gk.fused_edge_pass(**dict(args, v=args["v"].transpose(1, 2)
                                  .contiguous().transpose(1, 2)), mode="gcl")
    with pytest.raises(ValueError):
        gk.fused_edge_pass(**dict(args, em=None), mode="gcl")
    with pytest.raises(ValueError):
        gk.fused_edge_pass(**dict(args, v=args["v"].cpu()), mode="gcl")
    # both types take at most 192 nodes, both H <= 448
    with pytest.raises(ValueError, match="N <= 192"):
        gk.fused_edge_pass(**_inputs(torch.bfloat16, B=1, N=193, H=64)[0],
                           mode="gcl")
    with pytest.raises(ValueError, match="N <= 192"):
        gk.fused_edge_pass(**_inputs(torch.float32, B=1, N=194, H=64)[0],
                           mode="gcl")
    with pytest.raises(ValueError, match="H <= 448"):
        gk.fused_edge_pass(**_inputs(torch.bfloat16, B=1, N=8, H=452)[0],
                           mode="coord")
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 0}


def _packs_once(dtype, atol, rtol):
    """The packed W1 is cached per weight tensor; an in-place change packs
    again, and the kernel then follows the new weight."""
    args, _ = _inputs(dtype, B=2, N=32, H=420)
    gk.reset_pack_count()
    first = gk.fused_edge_pass(**args, mode="gcl")
    second = gk.fused_edge_pass(**args, mode="gcl")
    assert gk.PACKS == 1 and torch.equal(first, second)
    args["w1"].mul_(0.5)
    third = gk.fused_edge_pass(**args, mode="gcl")
    ref = gk.fused_edge_pass_reference(**args, mode="gcl").float()
    assert gk.PACKS == 2
    torch.testing.assert_close(third, ref, atol=atol, rtol=rtol)
    assert (third - first).abs().max().item() > 1e-3


def test_w1_is_packed_once_per_weight(card):
    _packs_once(torch.bfloat16, 5e-3, 1e-2)


def test_f32_w1_is_packed_once_per_weight(card):
    """The float32 kernel's split W1 (TF32 parts and residuals) likewise."""
    _packs_once(torch.float32, 1e-5, 1e-4)


def test_inpaint_through_the_kernel_equals_plain(card, monkeypatch):
    """A short float32 inpaint (T = 2) at full width: every edge pass in the
    kernel against the same trajectory, same draws, through the plain
    version; x within 1e-3, the same atom types. The kernel's run is a
    replay of the trajectory's captured graph (the first call captures it),
    whose launches are credited; the plain run is the sampler's loop."""
    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.utils.fragments import \
        prepare_fragment
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    T, B, N = 2, 4, 24
    dyn = EGNNDynamics(EGNNConfig(compute_dtype="float32"),
                       torch.Generator().manual_seed(0)).to("cuda").eval()
    sampler = EDMSampler(dyn, DiffusionConfig(timesteps=T))
    nm, em = prepare_masks(torch.tensor([24, 20, 22, 17], device="cuda"), N)
    rng = np.random.default_rng(1)
    ctx = torch.tensor(rng.standard_normal((B, N, 3)), device="cuda",
                       dtype=torch.float32) * nm
    frag_x = torch.tensor(rng.standard_normal((6, 3)), device="cuda",
                          dtype=torch.float32)
    frag_h = torch.eye(8, device="cuda")[torch.tensor([0, 0, 1, 2, 0, 3])]
    z_known, fixed_mask = prepare_fragment(B, frag_x, frag_h, N, 15)
    gamma = torch.from_numpy(gamma_schedule(T))

    def run():
        g = torch.Generator(device="cuda").manual_seed(5)
        return sampler.inpaint(g, gamma, nm, em, ctx, z_known, fixed_mask)

    run()                                  # captures the graph
    gk.reset_launch_counts()
    xk, hk = run()
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gcl": 18 * (2 * T + 1), "coord": 9 * (2 * T + 1),
                           "gcl_bwd": 0, "coord_bwd": 0}
    monkeypatch.setattr(gk, "fused_edge_pass", gk.fused_edge_pass_reference)
    monkeypatch.setattr(sampler, "_graphed", False)
    xp, hp = run()
    assert torch.isfinite(xk).all()
    torch.testing.assert_close(xk, xp, atol=1e-3, rtol=1e-3)
    assert torch.equal(hk, hp)


def test_forward_under_grad_raises(card):
    """The bf16 kernel has no backward: on the card, a bf16 call that
    autograd would record (grad mode on, an input or weight that requires
    grad) raises before launching, naming ROADMAP M13b; under ``no_grad``,
    or with nothing that requires grad, it launches."""
    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    args, _ = _inputs(torch.bfloat16)
    gk.reset_launch_counts()
    for name in ("u", "w1", "bh"):
        a = dict(args, **{name: args[name].clone().requires_grad_(True)})
        with torch.enable_grad(), pytest.raises(RuntimeError, match="M13b"):
            gk.fused_edge_pass(**a, mode="gcl")
        with torch.no_grad():
            gk.fused_edge_pass(**a, mode="gcl")
    assert gk.LAUNCHES == {"gcl": 3, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 0}
    with torch.enable_grad():
        gk.fused_edge_pass(**args, mode="coord")
    assert gk.LAUNCHES == {"gcl": 3, "coord": 1, "gcl_bwd": 0,
                           "coord_bwd": 0}

    dyn = EGNNDynamics(EGNNConfig(hidden_nf=64, n_blocks=2,
                                  compute_dtype="bfloat16")).cuda()
    dyn = dyn.to(torch.bfloat16)
    assert all(p.requires_grad for p in dyn.parameters())
    nm, em = prepare_masks(torch.tensor([10, 7], device="cuda"), 10)
    xh = torch.randn(2, 10, 11, device="cuda") * nm
    ctx = torch.randn(2, 10, 3, device="cuda") * nm
    t = torch.full((2,), 0.5, device="cuda")
    gk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="M13b"):
        dyn(t, xh, nm, em, ctx)
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 0}
    with torch.no_grad():
        assert torch.isfinite(dyn(t, xh, nm, em, ctx)).all()
    assert gk.LAUNCHES == {"gcl": 4, "coord": 2, "gcl_bwd": 0,
                           "coord_bwd": 0}


GRAD_NAMES = ["du", "dv", "de", "dw_e", "db0", "dw1", "db1", "dwh", "dbh"]


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("shape", [(64, 39, 420), (5, 40, 420),
                                   (8, 128, 420), (3, 42, 64)])
def test_backward_kernel_matches_plain_backward(card, mode, shape):
    """The float32 backward kernel against its plain version (autograd of
    the plain forward) on the same inputs: du, dv and de per element within
    1e-5 + 1e-4 |ref| (the forward's f32 bar); the edge-summed weight
    gradients within 1e-4 max |ref| (sums over up to 10^5 edges in another
    order). One backward launch, no forward launch."""
    B, N, H = shape
    args, _ = _inputs(torch.float32, B=B, N=N, H=H, seed=B + N)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    rng = np.random.default_rng(N)
    g_shape = (B, N, H) if mode == "gcl" else (B, N * N, 1)
    g = torch.tensor(rng.standard_normal(g_shape), dtype=torch.float32,
                     device="cuda")
    gk.reset_launch_counts()
    got = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0,
                           "gcl_bwd": int(mode == "gcl"),
                           "coord_bwd": int(mode == "coord")}
    ref = gk.fused_edge_pass_backward_reference(**args, g=g, mode=mode)
    for name, x, r in zip(GRAD_NAMES, got, ref):
        if r is None:
            assert x is None and mode == "coord"
            continue
        assert x.shape == r.shape and torch.isfinite(x).all(), name
        err = (x - r).abs()
        if name in ("du", "dv", "de"):
            assert (err <= 1e-5 + 1e-4 * r.abs()).all(), (name, err.max())
        else:
            assert err.max() <= 1e-4 * r.abs().max(), (name, err.max())


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("shape", [(64, 39, 420), (3, 42, 64)])
def test_backward_kernel_is_deterministic(card, mode, shape):
    """Two backward calls on the same inputs give equal gradients bit for
    bit: every sum of the kernel and its wrapper is taken in a fixed
    order (no atomics)."""
    B, N, H = shape
    args, _ = _inputs(torch.float32, B=B, N=N, H=H, seed=B + N)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    rng = np.random.default_rng(N + 1)
    g_shape = (B, N, H) if mode == "gcl" else (B, N * N, 1)
    g = torch.tensor(rng.standard_normal(g_shape), dtype=torch.float32,
                     device="cuda")
    first = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
    second = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
    torch.cuda.synchronize()
    for name, x, y in zip(GRAD_NAMES, first, second):
        if x is None:
            assert y is None and mode == "coord", name
            continue
        assert torch.equal(x, y), name


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_f32_forward_under_grad_goes_through_the_function(card, mode):
    """A float32 call under grad on the card launches the forward kernel,
    and backward() launches the backward kernel, with W1 packed once for
    both: the gradients of every input and weight equal the plain
    backward's within its bars."""
    args, _ = _inputs(torch.float32, B=4, N=24, H=420, seed=7)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    keys = ["u", "v", "ef", "w_e", "b0", "w1", "b1", "wh", "bh"]
    leaves = {k: (args[k].clone().requires_grad_(True)
                  if args[k] is not None else None) for k in keys}
    g_shape = (4, 24, 420) if mode == "gcl" else (4, 24 * 24, 1)
    g = torch.randn(g_shape, device="cuda")
    gk.reset_launch_counts()
    gk.reset_pack_count()
    out = gk.fused_edge_pass(**leaves, em=args["em"], mode=mode)
    assert out.requires_grad
    out.backward(g)
    torch.cuda.synchronize()
    assert gk.PACKS == 1   # both layouts of W1 in one pack
    assert gk.LAUNCHES == {"gcl": int(mode == "gcl"),
                           "coord": int(mode == "coord"),
                           "gcl_bwd": int(mode == "gcl"),
                           "coord_bwd": int(mode == "coord")}
    ref = gk.fused_edge_pass_backward_reference(**args, g=g, mode=mode)
    for name, k, r in zip(GRAD_NAMES, keys, ref):
        if r is None:
            continue
        err = (leaves[k].grad - r).abs()
        assert err.max() <= 1e-5 + 1e-4 * r.abs().max(), name


def test_train_step_launches_and_packs_once_per_weight(card):
    """A float32 train step on the card (remat forced): each edge pass's
    forward kernel runs twice (again in the backward), its backward kernel
    once, and each W1 is packed once a step, both layouts together, also
    after the optimizer has moved it."""
    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import (init_train_state,
                                                           make_train_step)
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    blocks = 2
    cfg = EGNNConfig(hidden_nf=64, n_blocks=blocks)
    dyn = EGNNDynamics(cfg, torch.Generator().manual_seed(0)).cuda()
    step = make_train_step(make_mesh(device="cuda"), cfg,
                           DiffusionConfig(timesteps=10))
    state = init_train_state(dyn)
    rng = np.random.default_rng(0)
    B, N = 4, 20
    nm, em = prepare_masks(torch.tensor([20, 18, 16, 15]), N)
    x = torch.tensor(rng.standard_normal((B, N, 3)), dtype=torch.float32)
    batch = {"x": x * nm, "h": torch.eye(8)[torch.zeros(B, N).long()] * nm,
             "node_mask": nm, "edge_mask": em,
             "context": torch.tensor(rng.standard_normal((B, N, 3)),
                                     dtype=torch.float32) * nm}
    gamma = torch.linspace(-8.0, 8.0, 11)
    for seed in (1, 2):
        gk.reset_launch_counts()
        gk.reset_pack_count()
        m = step(dyn, state, torch.Generator(device="cuda").manual_seed(seed),
                 batch, gamma)
        torch.cuda.synchronize()
        assert torch.isfinite(m["loss"])
        assert gk.LAUNCHES == {"gcl": 4 * blocks, "coord": 2 * blocks,
                               "gcl_bwd": 2 * blocks, "coord_bwd": blocks}
        assert gk.PACKS == 3 * blocks


def _slab(args, n_local, index, mode):
    """The j-slab ``index`` of N_l = ``n_local`` source nodes of a square
    edge pass's operands: v's rows and the edges (i, j) of the slab."""
    B, N, H = args["u"].shape
    cols = slice(index * n_local, (index + 1) * n_local)
    out = dict(args, v=args["v"][:, cols].contiguous())
    E = args["ef"].shape[-1]
    out["ef"] = args["ef"].reshape(B, N, N, E)[:, :, cols].reshape(
        B, N * n_local, E).contiguous()
    if mode == "gcl":
        out["em"] = args["em"].reshape(B, N, N, 1)[:, :, cols].reshape(
            B, N * n_local, 1).contiguous()
    return out


# (B, N, N_l, H): slabs of a half, a quarter and a third, a last tile that
# is not full, and the most nodes a tile holds.
SLAB_SHAPES = [(4, 32, 16, 420), (4, 32, 8, 420), (5, 40, 20, 420),
               (3, 39, 13, 64), (2, 128, 64, 420)]


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("shape", SLAB_SHAPES, ids=str)
def test_f32_kernels_take_a_j_slab(card, mode, shape):
    """The float32 forward and backward kernels on each j-slab of an edge
    set (u for all N target nodes, v for N_l source nodes) against their
    plain versions on the same slab (the forward's and the backward's
    bars), and the slabs put back together (gcl sums and du summed, coord,
    de and dv concatenated, weight sums summed) against the N_l = N call
    within the same bars. One launch a call."""
    B, N, nl, H = shape
    args, _ = _inputs(torch.float32, B=B, N=N, H=H, seed=N + nl)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    rng = np.random.default_rng(nl)
    g_full = torch.tensor(rng.standard_normal(
        (B, N, H) if mode == "gcl" else (B, N, N)), dtype=torch.float32,
        device="cuda")
    fwd, bwd = [], []
    for i in range(N // nl):
        a = _slab(args, nl, i, mode)
        g = (g_full if mode == "gcl" else g_full[:, :, i * nl:(i + 1) * nl]
             .reshape(B, N * nl, 1).contiguous())
        gk.reset_launch_counts()
        out = gk.fused_edge_pass(**a, mode=mode)
        grads = gk.fused_edge_pass_backward(**a, g=g, mode=mode)
        torch.cuda.synchronize()
        assert gk.LAUNCHES == {"gcl": int(mode == "gcl"),
                               "coord": int(mode == "coord"),
                               "gcl_bwd": int(mode == "gcl"),
                               "coord_bwd": int(mode == "coord")}
        torch.testing.assert_close(
            out, gk.fused_edge_pass_reference(**a, mode=mode).float(),
            atol=1e-5, rtol=1e-4)
        _assert_backward_close(
            grads, gk.fused_edge_pass_backward_reference(**a, g=g, mode=mode),
            mode)
        fwd.append(out)
        bwd.append(grads)
    full = gk.fused_edge_pass(**args, mode=mode)
    g = g_full if mode == "gcl" else g_full.reshape(B, N * N, 1)
    full_grads = gk.fused_edge_pass_backward(**args, g=g, mode=mode)
    if mode == "gcl":
        together = sum(fwd)
    else:
        together = torch.cat([o.reshape(B, N, nl) for o in fwd],
                             2).reshape(B, N * N, 1)
    torch.testing.assert_close(together, full, atol=1e-5, rtol=1e-4)
    parts = list(zip(*bwd))
    E = args["ef"].shape[-1]
    joined = [sum(parts[0]), torch.cat(parts[1], 1),
              torch.cat([d.reshape(B, N, nl, E) for d in parts[2]],
                        2).reshape(B, N * N, E)]
    joined += [None if p[0] is None else sum(p) for p in parts[3:]]
    _assert_backward_close(joined, full_grads, mode)


def _assert_backward_close(got, ref, mode):
    for name, x, r in zip(GRAD_NAMES, got, ref):
        if r is None:
            assert x is None and mode == "coord", name
            continue
        assert x.shape == r.shape and torch.isfinite(x).all(), name
        err = (x - r).abs()
        if name in ("du", "dv", "de"):
            assert (err <= 1e-5 + 1e-4 * r.abs()).all(), (name, err.max())
        else:
            assert err.max() <= 1e-4 * r.abs().max(), (name, err.max())


def test_bf16_kernel_refuses_a_j_slab(card):
    """The bfloat16 kernel takes the square edge set only: a slab raises,
    naming the limit, before any launch (no fallback to the plain
    version)."""
    args, _ = _inputs(torch.bfloat16, B=2, N=32, H=64)
    gk.reset_launch_counts()
    with pytest.raises(ValueError, match="square edge set"):
        gk.fused_edge_pass(**_slab(args, 16, 1, "gcl"), mode="gcl")
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 0}


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_registered_op_is_the_kernel(card, mode, dtype):
    """``torch.ops.mlcg_torch.fused_edge_pass`` (what exported programs and
    ``debug_mode`` call) on CUDA tensors launches the kernel and equals
    ``fused_edge_pass`` bit for bit."""
    args, _ = _inputs(dtype, B=4, N=40, H=420)
    if mode == "coord":
        args["em"], args["bh"] = None, None
    want = gk.fused_edge_pass(**args, mode=mode)
    gk.reset_launch_counts()
    got = torch.ops.mlcg_torch.fused_edge_pass(
        *(args[k] for k in ("u", "v", "ef", "em", "w_e", "b0", "w1", "b1",
                            "wh", "bh")), mode, 100.0)
    torch.cuda.synchronize()
    assert gk.LAUNCHES[mode] == 1
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trajectory", ["generate", "inpaint", "merge"])
def test_trajectory_graph_is_the_loop(card, trajectory, dtype):
    """Each trajectory on the card runs as one captured CUDA graph; two
    requests in a row from one generator equal the sampler's loop run from
    an equally seeded generator bit for bit (x and h), and leave both
    generators in one state. The first request captures (its warm-up, one
    reverse step and the decode, launches for real); the second replays,
    and the launches it is credited are the loop's exactly."""
    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.utils.fragments import \
        prepare_fragment
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    T, B, N, blocks = 3, 4, 24, 2
    cfg = EGNNConfig(hidden_nf=64, n_blocks=blocks, compute_dtype=dtype)
    dyn = EGNNDynamics(cfg, torch.Generator().manual_seed(0))
    dyn = dyn.to("cuda", getattr(torch, dtype)).eval()
    sampler = EDMSampler(dyn, DiffusionConfig(timesteps=T))
    nm, em = prepare_masks(torch.tensor([24, 20, 22, 17], device="cuda"), N)
    rng = np.random.default_rng(1)
    ctx = torch.tensor(rng.standard_normal((B, N, 3)), device="cuda",
                       dtype=torch.float32) * nm
    frag_x = torch.tensor(rng.standard_normal((6, 3)), device="cuda",
                          dtype=torch.float32)
    frag_h = torch.eye(8, device="cuda")[torch.tensor([0, 0, 1, 2, 0, 3])]
    z_known, fixed_mask = prepare_fragment(B, frag_x, frag_h, N, 15)
    gamma = torch.from_numpy(gamma_schedule(T))

    def request(g):
        if trajectory == "generate":
            return sampler.generate(g, gamma, nm, em, ctx)
        if trajectory == "inpaint":
            return sampler.inpaint(g, gamma, nm, em, ctx, z_known, fixed_mask)
        return sampler.merge_fragments(g, gamma, nm, em, fixed_mask, ctx,
                                       z_known, diffusion_level=2)

    forwards = {"generate": T + 1, "inpaint": 2 * T + 1,
                "merge": 3 + 1}[trajectory]
    g_graph = torch.Generator(device="cuda").manual_seed(5)
    runs = {"graph": [], "loop": []}
    for k in range(2):
        gk.reset_launch_counts()
        runs["graph"].append(request(g_graph))
        torch.cuda.synchronize()
        if k == 1:
            assert gk.LAUNCHES == {"gcl": 2 * blocks * forwards,
                                   "coord": blocks * forwards,
                                   "gcl_bwd": 0, "coord_bwd": 0}
    assert len(sampler._graphs) == 1
    sampler._graphed = False
    g_loop = torch.Generator(device="cuda").manual_seed(5)
    for _ in range(2):
        runs["loop"].append(request(g_loop))
    for (xg, hg), (xl, hl) in zip(runs["graph"], runs["loop"]):
        assert torch.isfinite(xl).all()
        assert torch.equal(xg, xl) and torch.equal(hg, hl)
    assert torch.equal(g_graph.get_state(), g_loop.get_state())


def test_a_graph_outlives_the_backward_pack(card):
    """A float32 sampler's captured trajectory reads each block's packed W1
    by address. A forward and backward through the same module (which adds
    W1^T's pack to each weight's cache entry), then tensors of the packs'
    size written full of NaN, leave the graph's replay equal to the loop
    bit for bit: the forward packs are the ones the graph holds."""
    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    T, B, N = 3, 4, 24
    dyn = EGNNDynamics(EGNNConfig(hidden_nf=64, n_blocks=2,
                                  compute_dtype="float32"),
                       torch.Generator().manual_seed(0)).to("cuda").eval()
    sampler = EDMSampler(dyn, DiffusionConfig(timesteps=T))
    nm, em = prepare_masks(torch.tensor([24, 20, 22, 17], device="cuda"), N)
    ctx = torch.randn(B, N, 3, device="cuda") * nm
    gamma = torch.from_numpy(gamma_schedule(T))

    def request(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return sampler.generate(g, gamma, nm, em, ctx)

    request(5)                                     # captures the graph
    (graph,) = [entry[1] for entry in sampler._graphs._graphs.values()]
    assert graph.reads
    packs = gk.PACKS
    t = torch.full((B,), 0.5, device="cuda")
    xh = torch.randn(B, N, 11, device="cuda") * nm
    with torch.enable_grad():
        dyn(t, xh, nm, em, ctx).square().sum().backward()
    assert gk.PACKS > packs                        # W1^T packed
    junk = [torch.full_like(p, float("nan")) for p in graph.reads
            for _ in range(4)]
    x_graph, h_graph = request(7)
    sampler._graphed = False
    x_loop, h_loop = request(7)
    del junk
    assert torch.isfinite(x_loop).all()
    assert torch.equal(x_graph, x_loop) and torch.equal(h_graph, h_loop)


def test_a_graph_refuses_tensors_off_its_device(card):
    """A captured graph copies its inputs in on its own device: a tensor
    elsewhere raises rather than being moved."""
    from ml_conformer_generator_tpu_torch.utils.cuda_graph import capture

    graph = capture(lambda x: x * 2, {"x": torch.ones(3, device="cuda")})
    assert torch.equal(graph(x=torch.full((3,), 2.0, device="cuda")),
                       torch.full((3,), 4.0, device="cuda"))
    with pytest.raises(ValueError):
        graph(x=torch.ones(3))


def _train_batches(n, B=4, N=20, seed=0):
    """``n`` float32 training batches of B graphs of up to N nodes."""
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nm, em = prepare_masks(torch.tensor(rng.integers(12, N + 1, B)), N)
        x = torch.tensor(rng.standard_normal((B, N, 3)),
                         dtype=torch.float32) * nm
        x = (x - x.sum(1, keepdim=True) / nm.sum(1, keepdim=True)) * nm
        out.append({
            "x": x, "node_mask": nm, "edge_mask": em,
            "h": torch.eye(8)[torch.tensor(rng.integers(0, 8, (B, N)))] * nm,
            "context": torch.tensor(rng.standard_normal((B, N, 3)),
                                    dtype=torch.float32) * nm})
    return out


def _held_forward(monkeypatch, calls):
    """Each forward kernel launch held against the plain version on the same
    inputs at the float32 bar, counted into ``calls``."""
    launch = gk._launch_forward

    def held(u, v, ef, em, w_e, b0, w1, b1, wh, bh, *, mode, norm, **kw):
        out = launch(u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode=mode,
                     norm=norm, **kw)
        ref = gk.fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1,
                                           wh, bh, mode=mode, norm=norm)
        assert ((out - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all(), mode
        calls.append(mode)
        return out

    monkeypatch.setattr(gk, "_launch_forward", held)


def test_train_step_graph_is_the_loop(card, monkeypatch):
    """The (1, 1) mesh's train step and the EMA update on the card run as
    captured graphs; over five steps with a warmup-cosine that crosses its
    warmup they equal the loop (the comparison's route, ``step._graphed``
    off) bit for bit: losses, parameters, gradients, AdamW moments and
    counts, the EMA; the learning-rate tensor is the one the graph reads.
    Every step launches 4 / 2 forward and 2 / 1 backward kernels a block
    and packs each W1 once, a replay's credited from its capture. An eager
    forward after the replays packs every W1 afresh (the replays moved
    their versions) and agrees with the plain version."""
    import copy

    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.models.egnn import (
        EGNNDynamics, dynamics_forward)
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import (init_train_state,
                                                           make_optimizer,
                                                           make_train_step)
    from ml_conformer_generator_tpu_torch.training import step as tstep
    from ml_conformer_generator_tpu_torch.training.loop import ema_update_

    blocks = 2
    cfg = EGNNConfig(hidden_nf=64, n_blocks=blocks)
    recipe = make_optimizer(lr=1e-3, total_steps=8, warmup_steps=2)
    gamma = torch.linspace(-8.0, 8.0, 11)
    routes = ("graph", "loop")
    models = {r: EGNNDynamics(cfg, torch.Generator().manual_seed(0)).cuda()
              for r in routes}
    emas = {r: copy.deepcopy(m).requires_grad_(False)
            for r, m in models.items()}
    states = {r: init_train_state(m, recipe) for r, m in models.items()}
    step = make_train_step(make_mesh(device="cuda"), cfg,
                           DiffusionConfig(timesteps=10))
    gens = {r: torch.Generator(device="cuda").manual_seed(3) for r in routes}
    lr = states["graph"].optimizer.param_groups[0]["lr"]
    want = {"gcl": 4 * blocks, "coord": 2 * blocks, "gcl_bwd": 2 * blocks,
            "coord_bwd": blocks}
    for t, batch in enumerate(_train_batches(5)):
        got = {}
        for r in routes:
            monkeypatch.setattr(tstep, "_graphed", r == "graph")
            gk.reset_launch_counts()
            gk.reset_pack_count()
            m = step(models[r], states[r], gens[r], batch, gamma)
            ema_update_(emas[r], models[r], 0.999, t)
            torch.cuda.synchronize()
            got[r] = m
            assert gk.LAUNCHES == want and gk.PACKS == 3 * blocks, (r, t)
        monkeypatch.setattr(tstep, "_graphed", True)
        for k in ("loss", "mean_t"):
            assert torch.equal(got["graph"][k], got["loop"][k]), (k, t)
        pairs = zip(models["graph"].parameters(), models["loop"].parameters(),
                    emas["graph"].parameters(), emas["loop"].parameters())
        for p, q, e, f in pairs:
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), t
            assert torch.equal(e, f), t
            a = states["graph"].optimizer.state[p]
            b = states["loop"].optimizer.state[q]
            assert all(torch.equal(a[k], b[k])
                       for k in ("exp_avg", "exp_avg_sq", "step")), t
        assert states["graph"].optimizer.param_groups[0]["lr"] is lr
        assert torch.equal(lr, states["loop"].optimizer.param_groups[0]["lr"])
        if t == 1:
            # an eager forward between replays: its packs must not be served
            # after the next replay
            with torch.no_grad():
                dynamics_forward(models["graph"], gamma[:4].cuda() * 0,
                                 torch.cat([batch["x"], batch["h"]], -1).cuda(),
                                 batch["node_mask"].cuda(),
                                 batch["edge_mask"].cuda(),
                                 batch["context"].cuda(), cfg)
    calls = []
    _held_forward(monkeypatch, calls)
    gk.reset_pack_count()
    with torch.no_grad():
        dynamics_forward(models["graph"], torch.full((4,), 0.5, device="cuda"),
                         torch.cat([batch["x"], batch["h"]], -1).cuda(),
                         batch["node_mask"].cuda(), batch["edge_mask"].cuda(),
                         batch["context"].cuda(), cfg)
    torch.cuda.synchronize()
    assert len(calls) == 3 * blocks and gk.PACKS == 3 * blocks


def test_drugs_train_steps_by_shape_are_the_loop(card, monkeypatch):
    """EDM GEOM-Drugs' train step on all-atom batches padded to 16 and to
    136 nodes (the wide float32 kernels, forward and backward), in turns:
    the graph route keeps one captured graph per shape, in one pool, and
    replays it when the shape comes again; losses, parameters and
    gradients equal the loop's bit for bit."""
    import dataclasses

    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.config import edm_geom_drugs
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import (
        AllAtomDataset, init_train_state, make_optimizer, make_train_step)
    from ml_conformer_generator_tpu_torch.training import step as tstep

    egnn_cfg, diff_cfg = edm_geom_drugs("float32", timesteps=10)
    egnn_cfg = dataclasses.replace(egnn_cfg, hidden_nf=64, n_blocks=2)
    rng = np.random.default_rng(0)
    mols = [Molecule(rng.choice([1, 6, 8], size=n),
                     np.cumsum(rng.standard_normal((n, 3)), 0), [])
            for n in (9, 14, 5, 12, 131, 20, 60, 8)]
    ds = AllAtomDataset(mols)
    feed = [ds.featurize(idx) for idx in ([0, 1, 2, 3], [4, 5, 6, 7])] * 2
    assert [b["x"].shape[1] for b in feed] == [16, 136, 16, 136]
    gamma = torch.linspace(-8.0, 8.0, 11)
    routes = ("graph", "loop")
    models = {r: EGNNDynamics(egnn_cfg, torch.Generator().manual_seed(0))
              .cuda() for r in routes}
    states = {r: init_train_state(m, make_optimizer(lr=1e-3))
              for r, m in models.items()}
    steps = {r: make_train_step(make_mesh(device="cuda"), egnn_cfg, diff_cfg,
                                batch_shapes=ds.batch_shapes)
             for r in routes}
    gens = {r: torch.Generator(device="cuda").manual_seed(3) for r in routes}
    for t, batch in enumerate(feed):
        got = {}
        for r in routes:
            monkeypatch.setattr(tstep, "_graphed", r == "graph")
            gk.reset_launch_counts()
            got[r] = steps[r](models[r], states[r], gens[r], batch, gamma)
            torch.cuda.synchronize()
            wide = batch["x"].shape[1] > 128
            assert gk.PASSES["gcl_wide" if wide else "gcl"] == 4, (r, t)
            assert gk.LAUNCHES["gcl_bwd"] == 2, (r, t)
        monkeypatch.setattr(tstep, "_graphed", True)
        assert torch.equal(got["graph"]["loss"], got["loop"]["loss"]), t
        for p, q in zip(models["graph"].parameters(),
                        models["loop"].parameters()):
            assert torch.equal(p, q) and torch.equal(p.grad, q.grad), t
    graphs = steps["graph"].graphs
    assert len(graphs) == 2 and graphs.captures == 2
    assert sorted({n: s for n, s, _ in k[2]}["x"][1]
                  for k in graphs.captures_by_key) == [16, 136]
    assert steps["loop"].graphs.captures == 0


def test_drugs_training_loop_at_published_widths(card, monkeypatch):
    """``training.train`` trains EDM GEOM-Drugs at its published widths on
    an all-atom dataset, each batch padded to its largest molecule's
    bucket (184 and 144: the wide float32 kernels): one captured graph a
    batch shape, replayed when the shape comes again; finite losses."""
    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.config import edm_geom_drugs
    from ml_conformer_generator_tpu_torch.training import AllAtomDataset, loop

    egnn_cfg, diff_cfg = edm_geom_drugs("float32")
    rng = np.random.default_rng(2)
    mols = [Molecule(rng.choice([1, 6, 7, 8], size=n),
                     np.cumsum(rng.standard_normal((n, 3)), 0), [])
            for n in (181, 30, 140, 44, 25, 60, 33, 96)]
    steps = []
    make = loop.make_train_step
    monkeypatch.setattr(loop, "make_train_step",
                        lambda *a, **k: steps.append(make(*a, **k))
                        or steps[-1])
    out = loop.train(AllAtomDataset(mols), egnn_cfg=egnn_cfg,
                     diff_cfg=diff_cfg, batch_size=2, epochs=3,
                     device="cuda", log_every=1, log_fn=lambda s: None,
                     ema_decay=0.9999, seed=5)
    assert len(out["history"]) == 12
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    graphs = steps[0].graphs
    pads = sorted({n: s for n, s, _ in k[2]}["x"][1]
                  for k in graphs.captures_by_key)
    assert len(pads) == len(graphs) == graphs.captures >= 4
    assert pads[-1] == 184 and set(pads) <= {32, 40, 48, 64, 96, 144, 184}


@pytest.mark.parametrize("batch_size", [0, 3], ids=["full", "sampled"])
def test_adj_mat_seer_graph_is_the_loop(card, monkeypatch, batch_size):
    """``train_adj_mat_seer`` on the card: its step as a captured graph
    against the loop, full batch and sampled subsets from one rng, every
    loss and weight bit for bit."""
    from ml_conformer_generator_tpu_torch.chem.smiles import from_smiles
    from ml_conformer_generator_tpu_torch.config import AdjMatSeerConfig
    from ml_conformer_generator_tpu_torch.training import (
        step as tstep, train_adj_mat_seer)

    mols = [from_smiles(s).remove_hs() for s in
            ("CC(=O)Nc1ccc(O)cc1", "c1ccncc1", "CCOC(=O)C", "OCC(N)C(=O)O")]
    cfg = AdjMatSeerConfig(n_hidden=64)
    out = {}
    for graphed in (True, False):
        monkeypatch.setattr(tstep, "_graphed", graphed)
        out[graphed] = train_adj_mat_seer(
            mols, steps=6, lr=3e-3, batch_size=batch_size, seed=1, cfg=cfg,
            log_every=1, log_fn=lambda s: None, device="cuda")
    assert out[True]["history"] == out[False]["history"]
    for p, q in zip(out[True]["params"].parameters(),
                    out[False]["params"].parameters()):
        assert torch.equal(p, q)
