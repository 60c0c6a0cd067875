"""The benchmark's run: one cell, one seed, one window.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (a JSON file of sizes) and its
traffic (``workloads/<cell>.json``, whose ``driver`` names a file of
``drivers/``); each metric is a reader in ``metrics/<metric>.py``. A run:

1. set-up: the driver builds the program from the configuration and the
   benchmark's weights, and makes one untimed unit of work for each shape
   the traffic uses (every CUDA graph the window replays is captured here);
2. the window: units one after another (a closed loop with one client)
   until ``--seconds`` have passed and the unit in flight has ended; with
   ``--trace 1``, first ``trace_units`` units under ``torch.profiler``,
   then the window;
3. the judgement: the peak memory is read, the program's state freed, and
   the driver compares what the window produced with the plain reference
   (``reference/``); every compared number is printed beside its limit.

The result is the last line of standard output, one JSON object.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
#: Top-level module names that no run may have loaded: JAX and the JAX
#: package the port was made from (compared whole: the port's name begins
#: with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_conformer_generator_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    Called before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Spec:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    metrics, read from their files (``workloads_dir`` and ``metrics_dir``
    default to the benchmark's own)."""

    def __init__(self, cell: str, bench_json: Optional[str] = None,
                 workloads_dir: Optional[str] = None,
                 metrics_dir: Optional[str] = None):
        bench_json = bench_json or os.path.join(ROOT, "BENCHMARK.json")
        with open(bench_json) as f:
            bench = json.load(f)
        root = os.path.dirname(os.path.abspath(bench_json))
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in {bench_json}")
        self.name = cell
        self.cell = cells[cell]
        entry = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        with open(os.path.join(root, entry["file"])) as f:
            self.config = json.load(f)
        workloads_dir = workloads_dir or os.path.join(BENCH, "workloads")
        with open(os.path.join(workloads_dir, f"{cell}.json")) as f:
            self.workload = json.load(f)
        self.metrics_dir = metrics_dir or os.path.join(BENCH, "metrics")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, cell)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, cell)]

    def driver(self):
        """The module of ``drivers/`` that the traffic names."""
        return importlib.import_module(
            f"benchmark.drivers.{self.workload['driver']}")

    def reader(self, metric: str):
        """The module of ``metrics/`` named by the metric."""
        return _load(os.path.join(self.metrics_dir, f"{metric}.py"),
                     "benchmark_metric_" + metric.replace(".", "_"))


class Run:
    """What one run records: the spec, the set-up and window times, one
    record per unit of work (a dict the driver fills; the harness adds
    ``start`` and ``end``, host seconds), the trace, and the checks."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool,
                 device: str, t0: float):
        self.spec, self.seed, self.seconds = spec, seed, seconds
        self.traced, self.device, self.t0 = trace, device, t0
        self.config, self.workload = spec.config, spec.workload
        #: the window's units, and before them a traced run's traced ones
        self.units: List[dict] = []
        self.traced_units: List[dict] = []
        self.window: Tuple[float, float] = (0.0, 0.0)
        self.setup_s = 0.0
        self.trace = None
        self.attempted = self.failed = 0
        self.checks: Dict[str, Tuple[float, float]] = {}
        #: readings a driver reports beside its checks, compared with nothing
        self.info: Dict[str, float] = {}
        self.captures = {"setup": 0, "window": 0}
        self.memory_peak = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def done(self) -> List[dict]:
        """Records of the window's units that ended without an error."""
        return [u for u in self.units if not u.get("error")]


class _Captures:
    """Counts CUDA graph captures in this process (``torch.cuda.CUDAGraph``
    capture_begin), whoever makes them."""

    def __init__(self, torch):
        self.n = 0
        cls = torch.cuda.CUDAGraph
        orig = cls.capture_begin

        def counted(graph, *a, **k):
            self.n += 1
            return orig(graph, *a, **k)

        cls.capture_begin = counted


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def execute(spec: Spec, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: Optional[float] = None,
            control: bool = False, before_setup=None) -> Tuple[dict, Run]:
    """One run of ``spec``'s cell on ``device``; returns (result, run).
    ``control``: the plain reference in the program's place, in the
    configuration's ``control_formats`` (a sampling driver's control; the
    benchmark's own runs never set it). ``before_setup``: called with the
    driver before its set-up (the tests plant faults through it)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    run = Run(spec, seed, seconds, trace, device, t0)
    run.control = spec.config["control_formats"] if control else None
    captures = _Captures(torch) if device == "cuda" else None
    driver = spec.driver().Driver(run)
    if before_setup is not None:
        before_setup(driver)
    driver.setup()
    _sync(torch, device)
    if captures:
        run.captures["setup"] = captures.n

    # a traced run profiles its first ``trace_units`` units, then measures
    # a whole window after them: the profiler's start and stop stay out
    n_traced = spec.workload["trace_units"] if trace else 0
    run.setup_s = time.perf_counter() - t0
    if n_traced:
        prof = _profiler(torch, device)
        prof.start()
        with torch.profiler.record_function("bench.window"):
            for i in range(n_traced):
                with torch.profiler.record_function("bench.unit"):
                    run.traced_units.append(_unit(run, driver, i))
            driver.sync()
        prof.stop()
        from . import devtrace
        run.trace = devtrace.read(prof)
        del prof
    start = time.perf_counter()
    i = n_traced
    while True:
        run.units.append(_unit(run, driver, i))
        i += 1
        if run.units[-1]["end"] - start >= seconds:
            break
    driver.sync()
    run.window = (start, time.perf_counter())
    if captures:
        run.captures["window"] = captures.n - run.captures["setup"]

    driver.finish()
    if device == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    driver.release()
    run.checks = driver.judge()
    return result(run), run


def _unit(run: Run, driver, i: int) -> dict:
    """One unit of work, timed on the host; a unit that raises is
    counted as failed, and the run goes on."""
    rec = {"start": time.perf_counter()}
    try:
        rec.update(driver.unit(i))
    except Exception:
        rec["error"] = traceback.format_exc(limit=4)
        sys.stderr.write(rec["error"])
    rec["end"] = time.perf_counter()
    run.attempted += 1
    run.failed += bool(rec.get("error"))
    return rec


def _profiler(torch, device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def result(run: Run) -> dict:
    """The result line of a finished run (its metrics by the readers)."""
    import torch

    metrics = {}
    for m in (run.spec.per_layer if run.traced else run.spec.end_to_end):
        value = run.spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in run.checks.items()}
    correct = (run.attempted > 0 and run.failed == 0 and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": (torch.cuda.get_device_name(0)
                       if run.device == "cuda" else "cpu"),
              "count": run.spec.cell["chips"],
              "memory_peak_bytes": run.memory_peak}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def card_line(run: Run) -> str:
    """The card, its power limit, torch, and the graph captures made."""
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi gave nothing"
    return (f"# card: {smi}; torch {torch.__version__} (CUDA "
            f"{torch.version.cuda}); graph captures: set-up "
            f"{run.captures['setup']}, window {run.captures['window']}; "
            f"set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
            f"{run.attempted} units"
            + (f", {sum(u['valid'] for u in run.done())} valid samples"
               if run.done() and "valid" in run.done()[0] else ""))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec(args.workload)
    import torch

    need = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        sys.stderr.write(f"no result: the cell needs {need} CUDA device(s), "
                         f"this machine has "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 2
    out, run = execute(spec, args.seed, args.seconds, bool(args.trace),
                       "cuda", t0)
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"no result: the run loaded {', '.join(bad)}\n")
        return 3
    print(card_line(run), flush=True)
    if run.info:
        print(f"# info: {json.dumps(run.info)}", flush=True)
    for name, c in out["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit "
                         f"{c['limit']!r})\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
