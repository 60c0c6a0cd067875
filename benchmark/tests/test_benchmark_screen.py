"""The screening cell: its entries, and tiny runs on the CPU of the
library's batch API (``ScreeningDriver.screen``): sound, traced, under the
control and under faults planted in the screen's own sampling and
chemistry path."""

import json
import os

import pytest
import torch

from conftest import BENCH, ROOT, TINY_CONFIG

from benchmark import harness
from benchmark.traffic import request_order

CELL = "screen-bf16-protocol"
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
with open(os.path.join(BENCH, "workloads", f"{CELL}.json")) as f:
    WL = json.load(f)
#: The cell cut to a tiny size: 6 references, 2 a unit, 3 samples each.
TINY = dict(references=6, n_samples=3, refs_per_unit=2, judge_within=3,
            judge_requests=2, judge_rows=2, trace_units=1)


def test_cell_entries():
    cell = [w for w in SPEC["workloads"] if w["name"] == CELL][0]
    assert (cell["config"], cell["chips"]) == ("mlcg-chembl-bf16", 1)
    spec = harness.Spec(CELL)
    assert spec.workload["driver"] == "screen"
    assert {m["name"] for m in spec.end_to_end} == {"samples_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in spec.per_layer} == {
        "mfu.sample", "device_idle.sample", "sampling_ms",
        "bond_prediction_ms", "host_chem_ms"}
    assert (WL["references"], WL["refs_seed"], WL["refs_per_unit"],
            WL["n_samples"], WL["variance"], WL["score"],
            WL["queue_depth"]) == (25, 0, 5, 64, 2, True, 1)
    # the protocol cell's limits, the type gap's reset from this cell's
    # seeds and its fp8 control (PERF.md §2)
    with open(os.path.join(BENCH, "workloads",
                           "sample-bf16-protocol.json")) as f:
        assert WL["limits"] == dict(json.load(f)["limits"],
                                    type_gap_mean=1.8e-3)


@pytest.fixture(scope="module")
def tiny_screen(tmp_path_factory):
    """The cell at a tiny width and size, as files of its own."""
    dest = str(tmp_path_factory.mktemp("screen"))
    bench = json.loads(json.dumps(SPEC))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        c["file"] = f"cfg_{c['name']}.json"
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(dict(cfg, **TINY_CONFIG), f)
    os.makedirs(os.path.join(dest, "workloads"))
    with open(os.path.join(dest, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(dict(WL, **TINY), f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def _execute(tiny_screen, trace=False, control=False, before_setup=None,
             seed=3100000019 + 104729):
    torch.set_num_threads(4)
    spec = harness.Spec(CELL, os.path.join(tiny_screen, "BENCHMARK.json"),
                        os.path.join(tiny_screen, "workloads"))
    return harness.execute(spec, seed, 0.3, trace, "cpu", control=control,
                           before_setup=before_setup)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_on_the_cpu(tiny_screen, trace):
    out, run = _execute(tiny_screen, trace)
    assert out["correct"] is True and out["failed"] == 0, out
    assert set(out["checks"]) == {"x_ratio", "type_gap_mean", "bond_err",
                                  "size_mismatch", "featurize_mismatch"}
    # each unit screens the next references of the seeded order, cycled
    units = run.traced_units + run.units
    order = request_order(run.workload, run.seed, 6)
    assert [u["refs"] for u in units] == [
        [order[(2 * i + p) % len(order)] for p in range(2)]
        for i in range(len(units))]
    assert all(u["samples"] == 2 * 3 for u in units)
    # a request's stages: the worker's sampling, the caller's chemistry
    stages = ("edm_sampling_s", "featurize_s", "bond_prediction_s",
              "standardize_s")
    assert all(u["stages"][s] > 0 for u in units for s in stages)
    if trace:
        # the device's idle share needs a device trace: none on the CPU
        assert set(out["metrics"]) == {"mfu.sample", "sampling_ms",
                                       "bond_prediction_ms", "host_chem_ms"}
        assert out["metrics"]["sampling_ms"]["value"] > 0
    else:
        assert set(out["metrics"]) == {"samples_per_s", "setup_s"}


def _failed(out):
    assert out["correct"] is False, out["checks"]
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_tiny_control_fails(tiny_screen):
    """The reference in fp8 in the program's sampling place reads beyond a
    limit."""
    out, _ = _execute(tiny_screen, control=True)
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
        x[B // 2:] = x[:B - B // 2].clone()
        h[B // 2:] = h[:B - B // 2].clone()
        return x, h

    monkeypatch.setattr(EDMSampler, "generate", half)


def _altered_answer(monkeypatch):
    from ml_conformer_generator_tpu_torch.parallel import screening

    to_mols = screening.samples_to_molecules

    def altered(*a, **k):
        mols = to_mols(*a, **k)
        for m in mols:
            m.atomic_nums[0] = 7 if m.atomic_nums[0] != 7 else 8
        return mols

    monkeypatch.setattr(screening, "samples_to_molecules", altered)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch,
                                   _altered_answer])
def test_tiny_faults_fail(tiny_screen, monkeypatch, fault):
    out, _ = _execute(tiny_screen,
                      before_setup=lambda d: fault(monkeypatch))
    assert _failed(out)
