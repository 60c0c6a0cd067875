"""The CUDA edge-pass kernel against its plain version, on the card.

Imports torch only, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_gcl_kernel_cuda.py -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dtype, B=3, N=42, H=64, E=2, seed=0):
    """Operands as the model passes them; w_e a column block of the first
    edge layer (row stride 2H + E)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(min(15, N), N + 1, size=B)
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
# more than 48 and more than 64 nodes, and the most nodes a tile holds.
BF16_SHAPES = [(3, 42, 64), (3, 40, 420), (5, 24, 420), (2, 64, 420),
               (1, 100, 64)]
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
                           "coord": int(mode == "coord")}
    if dtype == torch.float32:
        atol, rtol = 1e-5, 1e-4
    else:
        atol, rtol = (5e-3, 1e-2) if mode == "gcl" else (5e-2, 5e-2)
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    if mode == "gcl":
        assert out[nm == 0].abs().max().item() == 0.0


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
    # both types take at most 128 nodes and H <= 448
    with pytest.raises(ValueError, match="N <= 128"):
        gk.fused_edge_pass(**_inputs(torch.bfloat16, B=1, N=130, H=64)[0],
                           mode="gcl")
    with pytest.raises(ValueError, match="N <= 128"):
        gk.fused_edge_pass(**_inputs(torch.float32, B=1, N=130, H=64)[0],
                           mode="gcl")
    with pytest.raises(ValueError, match="H <= 448"):
        gk.fused_edge_pass(**_inputs(torch.bfloat16, B=1, N=8, H=452)[0],
                           mode="coord")
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0}


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
