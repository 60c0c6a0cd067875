"""The port's force field on the card against its CPU run.

Imports torch only, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_forcefield_cuda.py -q

Without a CUDA device every test skips. The bars are ``chip_smoke.py``'s:
on a well-conditioned molecule the card's relaxation ends within ``FF_BAR``
of the CPU's in float32, as the pipeline runs it, and within ``FF64_BAR``
in float64 with the same FIRE branch history (the steps where P < 0). A
molecule is well-conditioned when its float32 relaxation on the CPU ends
within ``WELL_CONDITIONED`` of its float64 relaxation; an exactly planar
start sits on a saddle of the out-of-plane terms, where round-off decides
the way down on any device, and is not.
"""

import numpy as np
import pytest
import torch

from ml_conformer_generator_tpu_torch.chem import forcefield as tff
from ml_conformer_generator_tpu_torch.chem.mol import Molecule
from ml_conformer_generator_tpu_torch.chem.perception import \
    determine_connectivity
from ml_conformer_generator_tpu_torch.chem.standardize import \
    standardize_batch

pytestmark = pytest.mark.cuda

# Angstrom, max over atoms (chip_smoke.py)
FF_BAR, FF64_BAR, WELL_CONDITIONED = 1e-3, 1e-6, 1e-4

# Benzamide-like ring with a methoxy group, far from the force field's
# equilibrium; its unjittered copy starts exactly planar.
_RING = ([6, 6, 6, 6, 6, 6, 6, 8, 7, 8, 6],
         [(1.390, 0.000, 0.000), (0.695, 1.204, 0.000),
          (-0.695, 1.204, 0.000), (-1.390, 0.000, 0.000),
          (-0.695, -1.204, 0.000), (0.695, -1.204, 0.000),
          (2.880, 0.000, 0.000), (3.500, 1.060, 0.000),
          (3.560, -1.160, 0.000), (-1.375, 2.382, 0.000),
          (-2.805, 2.382, 0.000)])
# A drug-like reference near equilibrium (25 heavy atoms, Angstrom).
_REFERENCE = ([6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 6, 6, 8, 6, 6, 8, 7, 6, 6, 6,
               16, 17, 9, 6, 6],
              [(1.390, 0.000, 0.000), (0.695, 1.204, 0.067),
               (-0.695, 1.204, 0.073), (-1.390, 0.000, 0.011),
               (-0.695, -1.204, -0.061), (0.695, -1.204, -0.077),
               (2.880, 0.000, -0.022), (3.575, -1.204, 0.053),
               (4.965, -1.204, 0.079), (5.660, -0.000, 0.033),
               (4.965, 1.204, -0.044), (3.575, 1.204, -0.080),
               (-1.375, 2.382, -0.043), (-2.805, 2.382, 0.034),
               (-1.445, -2.503, 0.079), (-2.675, -2.503, 0.052),
               (-0.775, -3.663, -0.023), (-1.505, -4.928, -0.077),
               (-0.740, -6.253, -0.060), (-1.505, -7.578, 0.012),
               (7.430, 0.000, 0.067), (2.705, 2.711, -0.068),
               (2.900, -2.373, -0.072), (5.720, -2.511, -0.011),
               (7.250, -2.511, 0.061)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    return torch.device("cuda")


def _copies(source, n, seed, jitter):
    """Rotated copies of ``source``, sanitised; the first unjittered, the
    others with a jitter drawn from ``jitter``."""
    rng = np.random.default_rng(seed)
    z, xyz = source
    mols = []
    for k in range(n):
        q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        j = 0.0 if k == 0 else rng.uniform(*jitter)
        c = np.asarray(xyz) @ q.T + rng.standard_normal((len(z), 3)) * j
        mols.append(determine_connectivity(Molecule(z, c, [])))
    out = standardize_batch(mols, optimize_geometry_flag=False, device="cpu")
    assert all(m is not None for m in out)
    return out


def _relax(mols, device, dtype):
    n_pad = tff._pad8(max(m.num_atoms for m in mols))
    ff = tff.build_ff_batch(mols, n_pad)
    x0 = np.zeros((len(mols), n_pad, 3))
    for b, m in enumerate(mols):
        x0[b, :m.num_atoms] = m.coords
    steps = []
    with torch.no_grad():
        x = tff.relax(torch.tensor(x0, device=device, dtype=dtype),
                      tff.to_device(ff, device, dtype), uphill_log=steps)
    return x.double().cpu().numpy(), torch.stack(steps).cpu().numpy(), x0


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 4)])
def test_relax_on_the_card_matches_its_cpu_run(card, seed, n):
    mols = _copies(_RING, n, seed, (0.05, 0.2))
    c32, _, x0 = _relax(mols, "cuda", torch.float32)
    p32, _, _ = _relax(mols, "cpu", torch.float32)
    c64, u64, _ = _relax(mols, "cuda", torch.float64)
    p64, v64, _ = _relax(mols, "cpu", torch.float64)
    assert np.isfinite(c32).all() and np.isfinite(c64).all()
    assert np.abs(p64 - x0).max() > 1e-2                   # it moved
    assert v64.shape == (200, n) and v64.any()
    cond = np.abs(p32 - p64).max((1, 2))
    well = [k for k in range(n) if cond[k] <= WELL_CONDITIONED]
    assert len(well) >= n - 1           # all but the planar start, at most
    for k in well:
        np.testing.assert_array_equal(u64[:, k], v64[:, k])
        assert np.abs(c64[k] - p64[k]).max() <= FF64_BAR
        assert np.abs(c32[k] - p32[k]).max() <= FF_BAR


def test_optimize_geometry_float32_on_the_card(card):
    mols = _copies(_REFERENCE, 16, 2, (0.05, 0.3))
    card_out = tff.optimize_geometry(mols, device="cuda")
    cpu_out = tff.optimize_geometry(mols, device="cpu")
    moved = 0.0
    for m, a, b in zip(mols, card_out, cpu_out):
        assert a.bonds == b.bonds
        assert np.isfinite(a.coords).all()
        assert np.abs(a.coords - b.coords).max() <= FF_BAR
        moved = max(moved, np.abs(b.coords - m.coords).max())
    assert moved > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_relax_graph_is_the_loop(card, dtype):
    """On the card ``relax`` replays a captured CUDA graph of one step: its
    coordinates and branch history equal the loop of the same steps
    (``fire_steps``) bit for bit, at the capture and at a replay; the
    card's gradient sums in a fixed order, so the loop repeats itself."""
    mols = _copies(_REFERENCE, 16, 2, (0.05, 0.3))
    n_pad = tff._pad8(max(m.num_atoms for m in mols))
    ff = tff.to_device(tff.build_ff_batch(mols, n_pad), "cuda", dtype)
    x0 = np.zeros((len(mols), n_pad, 3))
    for b, m in enumerate(mols):
        x0[b, :m.num_atoms] = m.coords
    x0 = torch.tensor(x0, device="cuda", dtype=dtype)
    with torch.no_grad():
        graphed = []
        for _ in range(2):
            log = []
            graphed.append((tff.relax(x0, ff, uphill_log=log),
                            torch.stack(log)))
        loops = []
        for _ in range(2):
            log = []
            x = tff.fire_steps(x0, ff, 200,
                               lambda k, uphill: log.append(uphill))
            loops.append((x, torch.stack(log)))
    for x, up in graphed + loops[1:]:
        assert torch.equal(x, loops[0][0])
        assert torch.equal(up, loops[0][1])
    assert (loops[0][0] - x0).abs().max() > 1e-2
