"""The comparison that decides ``correct`` fails what it must: each cell's
control (the reference in the program's place, one precision below the
configuration's) and each fault a cell can have, planted under a whole
tiny run on the CPU. A run of one card exchanges nothing between cards, so
that fault has no case here."""

import numpy as np
import pytest
import torch

from benchmark.drivers import train

SAMPLING = ["sample-bf16-protocol", "sample-f32-protocol",
            "sample-bf16-interactive"]


def _failed(out):
    assert out["correct"] is False, out["checks"]
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", SAMPLING)
def test_sound_run_is_correct(run_tiny, cell):
    out, _ = run_tiny(cell, seed=98765432101)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", SAMPLING)
def test_sampling_control_fails(run_tiny, cell):
    out, _ = run_tiny(cell, control=True)
    assert _failed(out)


def _unchanged_step(monkeypatch):
    from ml_conformer_generator_tpu_torch.diffusion import edm

    monkeypatch.setattr(edm, "reverse_step", lambda z, *a, **k: z)


def _half_batch(monkeypatch):
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler

    generate = EDMSampler.generate

    def half(self, *a, **k):
        x, h = generate(self, *a, **k)
        B = x.shape[0]
        x[B // 2:] = x[:B - B // 2]
        h[B // 2:] = h[:B - B // 2]
        return x, h

    monkeypatch.setattr(EDMSampler, "generate", half)


def _altered_answer(monkeypatch):
    from ml_conformer_generator_tpu_torch import generator

    to_mols = generator.samples_to_molecules

    def altered(*a, **k):
        mols = to_mols(*a, **k)
        for m in mols:
            m.atomic_nums[0] = 7 if m.atomic_nums[0] != 7 else 8
        return mols

    monkeypatch.setattr(generator, "samples_to_molecules", altered)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch,
                                   _altered_answer])
def test_sampling_faults_fail(run_tiny, monkeypatch, fault):
    out, _ = run_tiny("sample-bf16-protocol",
                      before_setup=lambda d: fault(monkeypatch))
    assert _failed(out)


def _optimizer_skipped(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, *a, **k: None)


def _half_molecules(monkeypatch):
    from ml_conformer_generator_tpu_torch.training import MoleculeDataset

    featurize = MoleculeDataset.featurize

    def half(self, idx, n_pad):
        return featurize(self, idx[:len(idx) // 2], n_pad)

    monkeypatch.setattr(MoleculeDataset, "featurize", half)


def _average_skipped(monkeypatch):
    from ml_conformer_generator_tpu_torch.training import loop

    monkeypatch.setattr(loop, "ema_update_", lambda *a, **k: None)


@pytest.mark.parametrize("fault", [_optimizer_skipped, _half_molecules,
                                   _average_skipped])
def test_training_faults_fail(run_tiny, monkeypatch, fault):
    out, _ = run_tiny("train-f32-b64",
                      before_setup=lambda d: fault(monkeypatch))
    assert _failed(out)


def test_training_control_fails(run_tiny):
    _, run = run_tiny("train-f32-b64")
    cfg, wl = run.config, run.workload
    ref = train.reference_steps(cfg, wl, run.seed, "cpu")
    got = train.reference_steps(cfg, wl, run.seed, "cpu",
                                cfg["control_formats"][0])
    checks = train.compare(*got, *ref, w0=train.make_weights(
        cfg, train.derive_seed(run.seed, 10), "cpu")[0], lim=wl["limits"])
    assert any(v > lim for v, lim in checks.values()), checks
    assert np.isfinite([v for v, _ in checks.values()]).all()
