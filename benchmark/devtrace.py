"""Reading a ``torch.profiler`` run: device events, the host spans the
harness records around each unit of work, busy time, and the breakdown.

The profiler records every device event (kernels, copies, sets), including
those a CUDA graph replay launches, and the host ops and
``record_function`` spans of the process. The harness opens a span named
:data:`WINDOW` around the traced part of the window and one named
:data:`UNIT` around each request or step in it; both are on the host's
clock, which the profiler aligns with the device's. Busy time is the union
of device event intervals inside the window span (``device_busy_s`` of
``chip_smoke.py``); kernels are sorted into categories by name
(``scripts_torch/trace_breakdown.py``); an idle gap is named by the
innermost host op or span open at its start on the harness's thread.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

WINDOW, UNIT = "bench.window", "bench.unit"
EDGE = "edge kernels (edge_mlp_*)"
_KERNEL = re.compile(r"edge_mlp_(bf16|f32|bwd_f32)_kernel<(true|false)")


def categorize(name: str) -> str:
    """The category of a device event's name."""
    n = name.lower()
    if "edge_mlp" in n:
        return EDGE
    if n.startswith(("memcpy", "memset")) or any(
            k in n for k in ("copy", "cat_array", "catarray")):
        return "copy/layout"
    if "nccl" in n:
        return "collective"
    if any(k in n for k in ("gemm", "sm90_xmma", "cutlass", "xmma_")):
        return "matmul (GEMM)"
    if any(k in n for k in ("philox", "normal", "uniform")):
        return "rng"
    if "reduce" in n:
        return "reduction"
    if any(k in n for k in ("elementwise", "vectorized")):
        return "elementwise"
    return "other"


def edge_kernel(name: str) -> Optional[Tuple[str, str]]:
    """(kind, mode) of an edge kernel's event name: kind "bf16", "f32" or
    "bwd_f32", mode "gcl" or "coord"; None for any other event."""
    m = _KERNEL.search(name)
    if m is None:
        return None
    return m.group(1), "gcl" if m.group(2) == "true" else "coord"


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


@dataclasses.dataclass
class Trace:
    """What a traced window holds, in seconds on the profiler's clock."""

    device: List[Tuple[str, float, float]]        # (name, start, end)
    host: List[Tuple[str, float, float]]          # harness thread's ops
    window: Tuple[float, float]
    units: List[Tuple[float, float]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self):
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device
                if e > a and s < b]

    def busy_s(self) -> float:
        busy, end = 0.0, None
        for _, s, e in sorted(self.in_window(), key=lambda d: d[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def unit_events(self, k: int):
        """Device events that start inside unit k's span."""
        a, b = self.units[k]
        return [d for d in self.device if a <= d[1] < b]

    def breakdown(self, top: int = 10):
        """{"device_ops": [[kernel, seconds]], "idle_gaps": [[what the host
        was doing, seconds]]}, the largest first."""
        by_name = {}
        for n, s, e in self.in_window():
            k = short_name(n)
            by_name[k] = by_name.get(k, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        events = sorted(self.in_window(), key=lambda d: d[1])
        end = self.window[0]
        for n, s, e in events + [("", self.window[1], self.window[1])]:
            if s > end:
                gaps.append((s - end, end))
            end = max(end, e)
        gaps.sort(reverse=True)
        named = [[self.host_at(at), dur] for dur, at in gaps[:top]]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

    def host_at(self, t: float) -> str:
        """The innermost host op or span open at ``t``."""
        best = None
        for n, s, e in self.host:
            if s <= t < e and n not in (WINDOW,) and (
                    best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "(no host op open)"


def read(prof) -> Optional[Trace]:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    window span the harness opened; None if it holds none."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    device, host, window, units, thread = [], [], None, [], None
    for e in events:
        if e.name() == WINDOW and e.device_type() != cuda:
            window = (e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            thread = e.start_thread_id()
    if window is None:
        return None
    for e in events:
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == cuda:
            # the device lanes also carry the harness's spans: not work
            if d > 0 and not e.name().startswith("bench."):
                device.append((e.name(), s, s + d))
        elif e.start_thread_id() == thread:
            if e.name() == UNIT:
                units.append((s, s + d))
            host.append((e.name(), s, s + d))
    units.sort()
    return Trace(device, host, window, units)
