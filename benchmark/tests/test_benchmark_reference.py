"""The plain reference against the program's plain path on the CPU, at a
tiny width: the denoiser, the sampler's trajectory, the bond predictor
and the training steps, on the benchmark's weights."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import TINY_CONFIG

from benchmark import harness
from benchmark.drivers import common
from benchmark.reference import adj_mat_seer, edm, egnn
from benchmark.weights import make_weights


@pytest.fixture(scope="module")
def cfg():
    with open(os.path.join(harness.BENCH, "configs",
                           "mlcg-chembl-f32.json")) as f:
        c = json.load(f)
    c.update(TINY_CONFIG)
    return c


def _masks(n, N):
    nm = (torch.arange(N)[None] < torch.tensor(n)[:, None]).float()[..., None]
    em = nm[:, :, None] * nm[:, None] * (1 - torch.eye(N))[None, :, :, None]
    return nm, em


def test_denoiser_and_sampler(cfg):
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics

    w, _ = make_weights(cfg, 11, "cpu")
    dyn = EGNNDynamics(common.egnn_config(cfg))
    dyn.load_state_dict(w)
    B, N = 3, 8
    nm, em = _masks([8, 5, 3], N)
    ctx = torch.randn(1, 1, 3).expand(B, N, 3) * nm
    xh = torch.randn(B, N, 11) * nm
    t = torch.tensor([0.0, 0.5, 1.0])
    with torch.no_grad():
        assert torch.allclose(dyn(t, xh, nm, em, ctx),
                              egnn.dynamics(w, cfg, t, xh, nm, em, ctx),
                              atol=1e-5, rtol=1e-4)
        g = torch.Generator().manual_seed(5)
        state = g.get_state()
        x, h = EDMSampler(dyn, common.diffusion_config(cfg)).generate(
            g, torch.from_numpy(gamma_schedule(cfg["timesteps"], 1e-5)),
            nm, em, ctx)
        g.set_state(state)
        draws = torch.stack([torch.cat([torch.randn((B, N, 3), generator=g),
                                        torch.randn((B, N, 8), generator=g)],
                                       -1)
                             for _ in range(cfg["timesteps"] + 2)])
        xr, scores = edm.sample(w, cfg, edm.mask_noise(draws, nm), nm, em,
                                ctx)
    assert (x - xr).abs().max() <= 1e-5 * xr.abs().max()
    assert torch.equal(h[..., :7].argmax(-1) * nm[..., 0].long(),
                       scores.argmax(-1) * nm[..., 0].long())


def test_bond_predictor(cfg):
    from ml_conformer_generator_tpu_torch.config import AdjMatSeerConfig
    from ml_conformer_generator_tpu_torch.models.adj_mat_seer import \
        AdjMatSeer

    _, w = make_weights(cfg, 12, "cpu")
    model = AdjMatSeer(AdjMatSeerConfig(n_hidden=cfg["n_hidden"]))
    model.load_state_dict(w)
    D = cfg["dimension"]
    el = torch.zeros(2, D, dtype=torch.long)
    el[0, :20] = 6
    el[1, :9] = torch.tensor([6, 7, 8, 6, 6, 16, 6, 9, 6])
    rng = np.random.default_rng(0)
    dist = torch.tensor(rng.uniform(1, 5, (2, D, D)), dtype=torch.float32)
    dist = (dist + dist.transpose(1, 2)) / 2 + torch.eye(D)
    adj = (dist < 2.0).float() + torch.eye(D)
    with torch.no_grad():
        assert torch.allclose(model(el, dist, adj),
                              adj_mat_seer.forward(w, cfg, el, dist, adj),
                              atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cell", ["sample-f32-protocol", "train-f32-b64"])
def test_float32_run_agrees_with_the_reference(run_tiny, cell):
    out, run = run_tiny(cell)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
