"""The program's spans in a traced window, and the device's idle time
attributed to them.

The port opens host ranges named ``mlcg.*`` at its layer boundaries while
the profiler runs (``utils/metrics.py``). :func:`devtrace.read` keeps them
among the host events of the harness's thread, on the profiler's clock,
which the device's events share. The idle intervals of the traced window
are the complement of the union of its device events. Each part of an
idle interval goes to the innermost ``mlcg.*`` span open over that part;
idle time with no span open goes to none. So an idle gap that starts
inside one span and ends inside the next is split between them by time,
not named by its start.

Every reader here returns None where the trace holds no span of the
names it reads: a program without them reads nothing, never 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "mlcg."
#: A train step's host work outside its device body: the wait for the
#: prefetched batch, its copies, the draws, the EMA update.
TRAIN_HOST = ("mlcg.data.wait", "mlcg.train.batch", "mlcg.train.draws",
              "mlcg.train.ema")

Interval = Tuple[float, float]
#: The names of the spans open over a stretch of time, outermost first.
Chain = Tuple[str, ...]


def program_spans(trace) -> List[Tuple[str, float, float]]:
    """The ``mlcg.*`` spans of the harness's thread, clipped to the
    traced window, by start (the outer of two equal starts first)."""
    a, b = trace.window
    spans = [(n, max(s, a), min(e, b)) for n, s, e in trace.host
             if n.startswith(PREFIX) and e > a and s < b]
    return sorted(spans, key=lambda x: (x[1], -x[2]))


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint, sorted intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(trace) -> List[Interval]:
    """The traced window less the union of its device events."""
    a, b = trace.window
    idle, at = [], a
    for s, e in union((s, e) for _, s, e in trace.in_window()):
        if s > at:
            idle.append((at, s))
        at = max(at, e)
    if b > at:
        idle.append((at, b))
    return idle


def chains(spans) -> List[Tuple[float, float, Chain]]:
    """Disjoint stretches of time, each with the chain of spans open over
    it (the stack of nested spans of one thread), the empty chain where
    none is; together they cover from the first span's start to the last
    span's end."""
    edges = sorted({t for _, s, e in spans for t in (s, e)})
    out = []
    for lo, hi in zip(edges, edges[1:]):
        # spans of one thread nest: those open over [lo, hi], by start
        open_ = [n for n, s, e in spans if s <= lo and e >= hi]
        out.append((lo, hi, tuple(open_)))
    return out


def idle_by_chain(trace) -> Optional[Dict[Chain, float]]:
    """Idle seconds of the traced window by the chain of program spans
    open over them (the innermost last; ``()``: no span open); None where
    the trace has no device event or no program span."""
    spans = program_spans(trace)
    if not spans or not trace.device:
        return None
    idle = idle_intervals(trace)
    total = sum(e - s for s, e in idle)
    out: Dict[Chain, float] = {}
    i = 0
    for lo, hi, chain in chains(spans):
        if not chain:
            continue
        while i < len(idle) and idle[i][1] <= lo:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < hi:
            part = min(hi, idle[j][1]) - max(lo, idle[j][0])
            if part > 0:
                out[chain] = out.get(chain, 0.0) + part
            j += 1
    out[()] = total - sum(out.values())
    return out


def idle_share(trace, names: Iterable[str]) -> Optional[float]:
    """100 x the idle seconds attributed to the spans ``names`` and the
    spans inside them, over the traced window's seconds; None where the
    trace has no span of those names (or no device event)."""
    names = set(names)
    by_chain = idle_by_chain(trace)
    if by_chain is None or trace.window_s <= 0 or not any(
            n in names for n, _, _ in program_spans(trace)):
        return None
    idle = sum(t for chain, t in by_chain.items()
               if names.intersection(chain))
    return 100.0 * idle / trace.window_s


def mean_span_ms(trace, names: Iterable[str]) -> Optional[float]:
    """Mean over the traced units (the harness's ``bench.unit`` spans) of
    the time covered by the spans ``names`` inside each, in ms; None where
    the trace has no unit or no span of those names."""
    names = set(names)
    spans = [(s, e) for n, s, e in program_spans(trace) if n in names]
    if not spans or not trace.units:
        return None
    per_unit = [sum(e - s for s, e in union(
        (max(s, a), min(e, b)) for s, e in spans if e > a and s < b))
        for a, b in trace.units]
    return 1e3 * sum(per_unit) / len(per_unit)
