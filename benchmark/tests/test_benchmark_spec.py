"""BENCHMARK.json and the files it names: every configuration, traffic and
metric is found by name, and one added as new files is picked up without
an existing file edited."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT

from benchmark import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec = harness.Spec(cell)
    assert spec.config["name"] == spec.cell["config"]
    assert spec.driver().Driver
    assert any(m["name"] == "setup_s" for m in spec.end_to_end)
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.reader(m["name"]).read)
    assert set(spec.workload["limits"]) and spec.workload["trace_units"] > 0


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                      "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
    assert "kernels" in layers
    # each configuration is used by some cell
    assert {c["name"] for c in SPEC["configs"]} == {
        w["config"] for w in SPEC["workloads"]}


def test_added_files_are_picked_up(tmp_path):
    """A new configuration, cell and per-layer metric arrive as new files
    and new entries: the harness finds them, no existing file changed."""
    before = {p: open(p, "rb").read() for p in (
        os.path.join(ROOT, "BENCHMARK.json"),
        *[os.path.join(BENCH, "workloads", f) for f in
          os.listdir(os.path.join(BENCH, "workloads"))])}
    bench = json.loads(json.dumps(SPEC))
    cfg_path = os.path.join(tmp_path, "benchmark", "configs", "new.json")
    os.makedirs(os.path.dirname(cfg_path))
    src = [c for c in SPEC["configs"] if c["name"] == "mlcg-chembl-bf16"][0]
    shutil.copy(os.path.join(ROOT, src["file"]), cfg_path)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["name"] = "new-config"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    bench["configs"].append(dict(src, name="new-config",
                                 file="benchmark/configs/new.json"))
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "new_metric.sample", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "sampler and denoiser",
                               "moves": "samples_per_s",
                               "workloads": ["new-cell"]})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    wl_dir = os.path.join(tmp_path, "workloads")
    os.makedirs(wl_dir)
    with open(os.path.join(BENCH, "workloads",
                           "sample-bf16-interactive.json")) as f:
        wl = json.load(f)
    wl["n_samples"] = 20
    with open(os.path.join(wl_dir, "new-cell.json"), "w") as f:
        json.dump(wl, f)
    metrics_dir = os.path.join(tmp_path, "metrics")
    shutil.copytree(os.path.join(BENCH, "metrics"), metrics_dir)
    with open(os.path.join(metrics_dir, "new_metric.sample.py"), "w") as f:
        f.write("def read(run):\n    return 42.0\n")
    path = os.path.join(tmp_path, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)

    spec = harness.Spec("new-cell", path, wl_dir, metrics_dir)
    assert spec.config["name"] == "new-config"
    assert spec.workload["n_samples"] == 20
    assert [m["name"] for m in spec.per_layer] == ["new_metric.sample"]
    assert spec.reader("new_metric.sample").read(None) == 42.0
    assert "samples_per_s" in [m["name"] for m in spec.end_to_end]
    assert before == {p: open(p, "rb").read() for p in before}
