"""Fixtures of the benchmark's CPU tests: the benchmark's own cells cut to
a tiny width and depth (the same files, numbers changed), written into a
temporary folder, and a runner of one cell on the CPU."""

from __future__ import annotations

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: The tiny cut: widths and depths of the models, the sampler's steps, and
#: the traffic's sizes.
TINY_CONFIG = dict(hidden_nf=16, n_blocks=2, timesteps=4, n_hidden=32)
TINY_SAMPLE = dict(references=3, n_samples=4, judge_within=3,
                   judge_requests=2, judge_rows=2, trace_units=1)
TINY_TRAIN = dict(references=3, copies=12, batch=4, trace_units=2)


def write_tiny(dest: str) -> str:
    """The benchmark's BENCHMARK.json, configurations and workload files,
    cut to the tiny sizes, under ``dest``; returns the BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(os.path.join(dest, "workloads"), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(TINY_CONFIG)
        path = os.path.join(dest, c["file"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "workloads",
                               f"{w['name']}.json")) as f:
            wl = json.load(f)
        wl.update(TINY_SAMPLE if wl["driver"] == "sample" else TINY_TRAIN)
        with open(os.path.join(dest, "workloads",
                               f"{w['name']}.json"), "w") as f:
            json.dump(wl, f)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return write_tiny(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def run_tiny(tiny):
    """run_tiny(cell, seed, trace=False, control=None, before_setup=None)
    -> (result, run) of one tiny run on the CPU."""
    import torch

    from benchmark import harness

    def go(cell, seed=1234567890123, trace=False, control=False,
           before_setup=None):
        torch.set_num_threads(4)
        spec = harness.Spec(cell, tiny, os.path.join(os.path.dirname(tiny),
                                                     "workloads"))
        return harness.execute(spec, seed, 0.5, trace, "cpu",
                               control=control, before_setup=before_setup)

    return go
