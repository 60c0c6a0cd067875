"""The EDM GEOM-Drugs training cell: its configuration and cell entries,
the corpus, the float32 roofline readers' arithmetic on fixed inputs
(launches matched to steps by the program's counts, not by time), and
tiny runs on the CPU: sound, under the control and under faults."""

import json
import os
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT

from benchmark import devtrace, drugs, drugs_train, flops, harness
from benchmark.drivers import train_drugs

CELL = "train-drugs-f32-b64"
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
with open(os.path.join(BENCH, "configs", "edm-geom-drugs-f32.json")) as f:
    CFG = json.load(f)
with open(os.path.join(BENCH, "configs", "edm-geom-drugs-bf16.json")) as f:
    BF16 = json.load(f)
with open(os.path.join(BENCH, "workloads", f"{CELL}.json")) as f:
    WL = json.load(f)


def test_configuration_is_the_published_one():
    entry = [c for c in SPEC["configs"] if c["name"] == CFG["name"]][0]
    assert entry["reduced"] == [] and entry["source"] == CFG["source"]
    # every number of the sampling configuration's, the type aside
    for k, v in BF16.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert CFG[k] == v, k
    assert CFG["atom_decoder"] == BF16["atom_decoder"]
    assert CFG["compute_dtype"] == "float32"
    assert CFG["control_formats"] == ["tf32"]
    assert {"loss", "optimizer", "ema_decay", "corpus"} <= set(
        CFG["assumed"])


def test_cell_entries():
    cell = [w for w in SPEC["workloads"] if w["name"] == CELL][0]
    assert (cell["config"], cell["chips"]) == ("edm-geom-drugs-f32", 1)
    spec = harness.Spec(CELL)
    assert spec.workload["driver"] == "train_drugs"
    assert {m["name"] for m in spec.end_to_end} == {"train_mol_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in spec.per_layer} == {
        "edge_wide_fwd_roofline.drugs_train",
        "edge_wide_bwd_roofline.drugs_train",
        "edge_fwd_roofline.drugs_train", "edge_bwd_roofline.drugs_train",
        "mfu.drugs_train", "device_idle.train", "train_host_ms",
        "idle_host.train"}
    assert (WL["batch"], WL["lr"], WL["weight_decay"], WL["ema_decay"]) == (
        64, 1e-4, 1e-12, 0.9999)
    # the wide kernels take about 68% of the edge work by N^2
    pads = [-(-n // 8) * 8 for n in WL["largest"]]
    assert pads == [96, 128, 144, 184]
    assert sum(p * p for p in pads if p > 128) / sum(p * p for p in pads) \
        == pytest.approx(0.68, abs=0.01)
    # the judged steps are two cycles: one at each pad eager (the
    # captures' warm-ups), then one at each pad replayed; the traced units
    # one cycle
    assert WL["judge_steps"] == 2 * len(WL["largest"]) == 2 * WL[
        "trace_units"]
    assert set(WL["limits"]) == {"loss_gap", "grad_gap", "change_gap",
                                 "ema_gap"}


def test_corpus():
    seed = 2 ** 40 + 17
    corpus = drugs_train.corpus(WL, seed)
    assert len(corpus) == WL["batches"]
    order = drugs_train.size_order(WL, seed)
    assert sorted(order) == sorted(WL["largest"])
    sizes = []
    for k, mols in enumerate(corpus):
        n = [len(z) for z, _ in mols]
        assert len(n) == 64 and max(n) == order[k % 4]
        sizes += sorted(n)[:-1]
        for z, pos in mols:
            np.testing.assert_allclose(pos.mean(0), 0.0, atol=1e-9)
            steps = np.linalg.norm(np.diff(pos, axis=0), axis=1)
            assert (steps >= 1.0 - 1e-9).all() and (steps <= 1.5 + 1e-9).all()
            assert set(z.tolist()) <= {1, 6, 7, 8, 9, 16, 17, 35}
    assert min(sizes) >= 24 and max(sizes) <= 64
    assert np.mean(sizes) == pytest.approx(44, abs=1.0)
    z = np.concatenate([z for mols in corpus for z, _ in mols])
    assert np.mean(z == 1) == pytest.approx(0.45, abs=0.02)
    # the same seed, the same corpus
    again = drugs_train.corpus(WL, seed)
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(corpus[3],
                                                          again[3]))


def _run(units, trace):
    spec = types.SimpleNamespace(config=CFG, workload={}, cell={"chips": 1},
                                 per_layer=[], end_to_end=[])
    run = harness.Run(spec, 1, 10.0, True, "cpu", 0.0)
    run.units, run.window, run.trace = units, (0.0, 10.0), trace
    run.traced_units = units[:len(trace.units)]
    return run


def test_roofline_readers_match_launches_to_steps_by_count():
    """Two steps, at 96 nodes (the N <= 128 kernels) and at 184 (the wide
    ones), whose device work runs after their host spans: each launch is
    reckoned at its step's shape by the step's counts, each backward with
    the GEMM launched after it."""
    spec = harness.Spec(CELL)
    fwd = "void edge_mlp_f32{}_kernel<{}, 2>(int)"
    bwd = "void edge_mlp_bwd_f32{}_kernel<{}, 2>(int)"
    dev = [(fwd.format("", "true"), 1.0, 1.1),
           (fwd.format("", "false"), 1.1, 1.2),
           (bwd.format("", "true"), 1.2, 1.5),
           ("sm90_xmma_gemm_f32f32", 1.5, 1.6),
           ("void elementwise_kernel", 1.6, 1.7),
           (fwd.format("_wide", "true"), 2.0, 2.4),
           (bwd.format("_wide", "false"), 2.4, 3.0),
           ("void elementwise_kernel", 3.0, 3.1),
           ("sm90_xmma_gemm_f32f32", 3.1, 3.3)]
    tr = devtrace.Trace(dev, [], (0.0, 4.0), [(0.0, 0.5), (0.5, 1.0)])
    units = [{"shape": (64, 96), "atoms": [44] * 64, "molecules": 64,
              "launches": {"gcl": 1, "coord": 1, "gcl_bwd": 1,
                           "coord_bwd": 0}},
             {"shape": (64, 184), "atoms": [44] * 64, "molecules": 64,
              "launches": {"gcl": 1, "coord": 0, "gcl_bwd": 0,
                           "coord_bwd": 1}}]
    run = _run(units, tr)

    def bound(N, mode, back=False):
        return flops.edge_pass_bound(64, N, 256, 2, "float32", mode,
                                     backward=back)[0]

    read = lambda name: spec.reader(name).read(run)
    assert read("edge_wide_fwd_roofline.drugs_train") == pytest.approx(
        100 * bound(184, "gcl") / 0.4)
    assert read("edge_wide_bwd_roofline.drugs_train") == pytest.approx(
        100 * bound(184, "coord", True) / 0.8)
    assert read("edge_fwd_roofline.drugs_train") == pytest.approx(
        100 * (bound(96, "gcl") + bound(96, "coord") + bound(184, "gcl"))
        / 0.6)
    assert read("edge_bwd_roofline.drugs_train") == pytest.approx(
        100 * (bound(96, "gcl", True) + bound(184, "coord", True)) / 1.2)
    # busy 1.0-1.7 and 2.0-3.3 of the 4 s window
    assert read("device_idle.train") == pytest.approx(
        100 * (1 - 2.0 / 4.0))
    run.window = (0.0, 2.0)
    assert read("mfu.drugs_train") == pytest.approx(
        100 * 2 * 3 * 64 * drugs.forward_flops(CFG, 44) / (2.0 * 165e12))
    # launches the counts do not account for, or no counts (a program
    # without them), read nothing, never 0
    units[1]["launches"]["gcl"] = 2
    assert read("edge_fwd_roofline.drugs_train") is None
    del units[1]["launches"]
    assert read("edge_wide_fwd_roofline.drugs_train") is None


@pytest.fixture(scope="module")
def tiny_train(tmp_path_factory):
    """The cell cut to a tiny width, batch and sizes, as files of its own."""
    dest = str(tmp_path_factory.mktemp("drugs_train"))
    cfg = dict(CFG, hidden_nf=16, n_blocks=2)
    path = os.path.join(dest, "benchmark", "configs", "drugs.json")
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench = json.loads(json.dumps(SPEC))
    for c in bench["configs"]:
        if c["name"] == CFG["name"]:
            c["file"] = "benchmark/configs/drugs.json"
    wl = dict(WL, batch=4, batches=4, largest=[10, 14, 18, 12], smallest=3,
              largest_other=8, reference_rows=2)
    os.makedirs(os.path.join(dest, "workloads"))
    with open(os.path.join(dest, "workloads", f"{CELL}.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def _execute(tiny_train, trace=False, control=False, before_setup=None,
             seed=3100000019 + 7919):
    torch.set_num_threads(4)
    spec = harness.Spec(CELL, os.path.join(tiny_train, "BENCHMARK.json"),
                        os.path.join(tiny_train, "workloads"))
    return harness.execute(spec, seed, 0.3, trace, "cpu", control=control,
                           before_setup=before_setup)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_on_the_cpu(tiny_train, trace):
    out, run = _execute(tiny_train, trace)
    assert out["correct"] is True and out["failed"] == 0, out
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "ema_gap"}
    # each judged step's gaps are reported; the check is the worst step's
    for k in ("loss_gap", "grad_gap", "change_gap"):
        by_step = run.info[f"{k}_by_step"]
        assert len(by_step) == 8
        assert max(by_step) == out["checks"][k]["value"]
    # set-up took two steps at each pad (the tiny corpus's 4 batches,
    # cycled); the window goes on with the batches after them, each padded
    # to its own largest molecule's bucket
    order = drugs_train.size_order(run.workload, run.seed)
    assert [u["shape"] for u in run.units] == [
        (4, -(-order[k % 4] // 8) * 8) for k in range(8, 8 + len(run.units))]
    if trace:
        assert "mfu.drugs_train" in out["metrics"]
        assert "edge_fwd_roofline.drugs_train" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_mol_per_s", "setup_s"}


def _failed(out):
    assert out["correct"] is False, out["checks"]
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_tiny_control_fails(tiny_train):
    """The reference in TF32 in the program's place fails to come near the
    program: its gradient and its change read far beyond the program's on
    the same seed. The cell's limits do not refuse it: at an ill-conditioned
    step the float32 program reads as far out as TF32 does (PERF.md §2), so
    those limits lie between the program's readings and 1."""
    prog, _ = _execute(tiny_train)
    out, _ = _execute(tiny_train, control=True)
    for k in ("grad_gap", "change_gap"):
        assert out["checks"][k]["value"] > 10 * prog["checks"][k]["value"]
        assert out["checks"][k]["value"] < out["checks"][k]["limit"]


def _optimizer_skipped(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, *a, **k: None)


def _half_molecules(monkeypatch):
    from ml_conformer_generator_tpu_torch.training import AllAtomDataset

    featurize = AllAtomDataset.featurize

    def half(self, idx, n_pad=None):
        return featurize(self, idx[:len(idx) // 2], n_pad)

    monkeypatch.setattr(AllAtomDataset, "featurize", half)


def _average_skipped(monkeypatch):
    from ml_conformer_generator_tpu_torch.training import loop

    monkeypatch.setattr(loop, "ema_update_", lambda *a, **k: None)


def _hydrogens_dropped(monkeypatch):
    from ml_conformer_generator_tpu_torch.training import AllAtomDataset

    init = AllAtomDataset.__init__

    def heavy(self, mols, *a, **k):
        init(self, [m.remove_hs() for m in mols], *a, **k)
        self.mols = self.mols + self.mols[:1] * (len(mols) - len(self.mols))

    monkeypatch.setattr(AllAtomDataset, "__init__", heavy)


@pytest.mark.parametrize("fault", [_optimizer_skipped, _half_molecules,
                                   _average_skipped, _hydrogens_dropped])
def test_tiny_faults_fail(tiny_train, monkeypatch, fault):
    out, _ = _execute(tiny_train,
                      before_setup=lambda d: fault(monkeypatch))
    assert _failed(out)


def test_reference_is_plain():
    """The reference imports nothing of the program or of JAX."""
    import ast

    for name in ("train_drugs.py",):
        with open(os.path.join(BENCH, "reference", name)) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        assert not any(m.split(".")[0] in harness.FORBIDDEN for m in mods)
