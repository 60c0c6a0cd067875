"""The result line, the refusals, and the check that no run loads JAX or
the JAX package (top-level module names compared whole)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

from benchmark import harness


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(run_tiny, trace):
    out, run = run_tiny("sample-bf16-interactive", trace=trace)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == len(run.units) + len(run.traced_units) > 0
    spec = run.spec
    names = {m["name"] for m in (spec.per_layer if trace else
                                 spec.end_to_end)}
    assert set(out["metrics"]) <= names
    for name, m in out["metrics"].items():
        assert isinstance(m["value"], float) and m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][key]) <= 10
        # the CPU has no device trace: the shares read nothing, never 0
        assert "edge_fwd_roofline.sample" not in out["metrics"]
    else:
        assert {"samples_per_s", "request_p95_s",
                "setup_s"} == set(out["metrics"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import ml_conformer_generator_tpu_torch  # noqa: F401

    clean = set(harness.forbidden_modules())
    for name in ("jaxtyping", "ml_conformer_generator_tpu_torch.config",
                 "ml_conformer_generator_tpu_torchx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == clean
    for name in ("jax", "jaxlib.xla_client", "ml_conformer_generator_tpu",
                 "ml_conformer_generator_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == clean | {
        "jax", "jaxlib", "ml_conformer_generator_tpu"}


def test_a_run_loads_no_jax(tiny):
    """A whole tiny run in a fresh process leaves no forbidden module."""
    code = (
        "import os, sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "spec = harness.Spec('train-f32-b64', %r, %r)\n"
        "out, run = harness.execute(spec, 3, 0.2, False, 'cpu')\n"
        "print(out['correct'], harness.forbidden_modules())\n"
    ) % (ROOT, tiny, os.path.join(os.path.dirname(tiny), "workloads"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"


def _command(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sample-bf16-protocol", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd)


def test_no_cuda_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _command(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    (no program) exits with an error and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    res = _command(str(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ""
