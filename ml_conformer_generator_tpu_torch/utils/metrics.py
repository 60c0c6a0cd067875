"""Per-request stage metrics and the program's spans on the profiler's clock
(SURVEY.md §5: tracing/observability plan).

The reference has no observability beyond wall-clock prints in research
scripts (``research_scripts/evaluation.py:98-104``). Here every generation
request records per-stage latency and yield counters in a
:class:`StageTimer`, exposed as ``generator.last_metrics`` (and the
screening driver's ``last_metrics``). Readers: the benchmark's sampling
driver (``benchmark/drivers/sample.py``, whose ``sampling_ms``,
``bond_prediction_ms`` and ``host_chem_ms`` are the means of its stages),
``chip_smoke.py``, ``scripts_torch/train_overfit_validity.py`` and the
tests. The HTTP app times its calls itself.

:func:`span` opens a host range named ``mlcg.<layer>...`` while
``torch.profiler`` runs, and nothing otherwise: the spans share the
profiler's clock with the device's events, so the time the device waits
can be set against what the host was doing. Each stage of a
:class:`StageTimer` is also such a span, under the same boundaries. Spans
nest on the calling thread; a request's root span (``mlcg.request``; a
train step's ``mlcg.train.step``) is the identity its children share: each
child lies inside exactly one root on its thread. PERF.md lists the spans
and the metrics that read them.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

__all__ = ["StageTimer", "span", "spanned"]

#: What :func:`span` returns while no profiler runs: one shared object.
_OFF = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager over a host range ``name`` on the profiler's clock
    while ``torch.profiler`` runs; otherwise the one shared no-op.

    The range is function-scoped (``_RecordFunctionFast``), not a
    ``record_function`` user range: the profiler mirrors user ranges onto
    the device lanes as annotations, which a trace reader would count as
    device work. Off, a span costs one flag check."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Range(name)


def spanned(name: str):
    """Decorator: the whole call is one :func:`span` named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Stage:
    __slots__ = ("timer", "name", "range", "start")

    def __init__(self, timer: "StageTimer", name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.range = span("mlcg." + self.name)
        self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        stages = self.timer.stages
        stages[self.name] = (stages.get(self.name, 0.0)
                             + time.perf_counter() - self.start)
        self.range.__exit__(*exc)
        return False


class StageTimer:
    """Context-manager stage clock: ``with timer.stage("edm"): ...``; each
    stage is also the span ``mlcg.<stage>``."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def stage(self, name: str) -> _Stage:
        return _Stage(self, name)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = value

    def summary(self) -> Dict[str, float]:
        out = {f"{k}_s": round(v, 4) for k, v in self.stages.items()}
        out.update(self.counters)
        out["total_s"] = round(time.perf_counter() - self._t0, 4)
        return out
