"""The port's fused edge pass against the JAX Pallas kernel (interpret mode).

On CPU tensors the port's ``fused_edge_pass`` is its plain PyTorch version;
the CUDA kernel itself is compared with that plain version on the card by
``chip_smoke.py``. Inputs are made with numpy from a seed and fed to both.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_conformer_generator_tpu.ops.gcl_kernel import \
    fused_edge_pass as jax_fused_edge_pass
from ml_conformer_generator_tpu.utils.masks import prepare_masks
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

B, H, E = 3, 64, 2


def _inputs(seed=0, N=42, sizes=None):
    """B graphs on a node axis of N: of ``sizes`` nodes, or of 15 to 39."""
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = rng.integers(15, 40, size=B)
    node_mask, edge_mask = prepare_masks(jnp.asarray(sizes), N)
    nm = np.asarray(node_mask)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return {
        "u": f(B, N, H) * nm, "v": f(B, N, H) * nm,
        "ef": f(B, N * N, E),
        "em": np.asarray(edge_mask).reshape(B, N * N, 1),
        "w_e": f(E, H, sc=0.3), "b0": f(H, sc=0.1),
        "w1": f(H, H, sc=H ** -0.5), "b1": f(H, sc=0.1),
        "wh": f(H, sc=H ** -0.5), "bh": f(1),
    }, nm


def _run_both(mode, jdt, tdt, seed=0, N=42, sizes=None):
    a, nm = _inputs(seed, N, sizes)
    J = {k: jnp.asarray(v, jdt) for k, v in a.items()}
    bh = J["bh"].reshape(1, 1) if mode == "gcl" else jnp.zeros((1, 1), jdt)
    ref = jax_fused_edge_pass(
        J["u"], J["v"], J["ef"], J["em"], J["w_e"], J["b0"].reshape(1, H),
        J["w1"], J["b1"].reshape(1, H), J["wh"].reshape(H, 1), bh,
        mode=mode, interpret=True)
    T = {k: torch.tensor(v).to(tdt) for k, v in a.items()}
    # torch layout: w_e (H, E), w1 [out][in]
    out = gk.fused_edge_pass(
        T["u"], T["v"], T["ef"], T["em"], T["w_e"].t().contiguous(), T["b0"],
        T["w1"].t().contiguous(), T["b1"], T["wh"],
        T["bh"] if mode == "gcl" else None, mode=mode)
    return out.float().numpy(), np.asarray(ref, np.float32), nm


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_edge_pass_f32_matches_jax_kernel(mode):
    out, ref, _ = _run_both(mode, jnp.float32, torch.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["gcl", "coord"])
@pytest.mark.parametrize("n_nodes", [56, 64])
def test_edge_pass_f32_matches_jax_kernel_at_more_nodes(mode, n_nodes):
    """Node counts past 48: the JAX kernel takes any N, and so does the
    port. Every graph has live nodes past index 48, one fills the axis."""
    out, ref, _ = _run_both(mode, jnp.float32, torch.float32, N=n_nodes,
                            sizes=[n_nodes, n_nodes - 3, 50])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_edge_pass_f32_matches_jax_kernel_past_64_nodes(mode):
    """N = 96, the range the float32 kernel takes on the card since it
    tiles like the bf16 one (N <= 128): every graph has live nodes past
    index 64, one fills the axis."""
    out, ref, _ = _run_both(mode, jnp.float32, torch.float32, N=96,
                            sizes=[96, 93, 70])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["gcl", "coord"])
def test_edge_pass_bf16_matches_jax_kernel(mode):
    out, ref, _ = _run_both(mode, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(out, ref, atol=5e-2, rtol=5e-2)


def test_edge_pass_masked_rows_are_zero():
    out, _, nm = _run_both("gcl", jnp.float32, torch.float32, seed=3)
    assert np.abs(out[nm[..., 0] == 0]).max() == 0.0


def test_cpu_tensors_do_not_launch():
    gk.reset_launch_counts()
    _run_both("gcl", jnp.float32, torch.float32)
    _run_both("coord", jnp.float32, torch.float32)
    assert gk.LAUNCHES == {"gcl": 0, "coord": 0}


def test_module_imports_without_nvcc():
    code = ("import os; os.environ['PATH'] = ''; "
            "import ml_conformer_generator_tpu_torch.ops.gcl_kernel as gk; "
            "assert gk._libs is None; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
