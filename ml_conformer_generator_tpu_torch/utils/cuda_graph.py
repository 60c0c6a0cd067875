"""Captured CUDA graphs: the port's twin of a jitted ``lax.scan``.

The JAX package compiles each trajectory (the sampler's three, FIRE's
relaxation) into one XLA program, cached per static configuration and
retraced per shape. On the card the port records the same work once into a
``torch.cuda.CUDAGraph`` and replays it: one launch from the host for a
whole sampler trajectory in place of thousands, and one for each FIRE step
(a graph of one step, replayed once a step: the relaxation's batch shape
changes with nearly every request, and a step captures in milliseconds
where the whole relaxation took about a second).

:func:`capture` records ``fn(**inputs)`` into a graph over static copies of
``inputs`` and returns a :class:`CapturedGraph`, which a call copies new
inputs into, replays on the caller's current stream and returns copies of
the outputs of. The idiom, and why:

* ``fn`` runs once eagerly first (``warmup``, by default ``fn`` itself) on
  a side stream of the calling thread's own: first-call work (a library
  handle's workspace for that stream, the edge kernels' packed W1 and
  shared-memory attributes) happens outside the graph;
* the capture runs on that same side stream with
  ``capture_error_mode="thread_local"``: the screening driver samples on a
  worker thread while the caller's thread relaxes on the default stream, so
  two threads may capture at once. ``torch.cuda.graph`` is not used: it
  captures on a stream shared by every thread, and synchronises the device
  and empties the allocator's cache on entry;
* a call replays on the caller's current stream, after the graph's last
  call has finished with the static buffers (an event), under a lock;
* launches of the edge kernels recorded by the capture
  (``ops/gcl_kernel.py``'s tally of the capturing stream, which the
  autograd engine's device thread also records a captured backward into)
  are credited to ``LAUNCHES`` on every replay, so a replayed request
  counts the launches it makes, and W1 packs so recorded to ``PACKS``; the
  packed W1 those launches read is held by the graph, so that a repack
  (the backward's, or a weight's new version) cannot free what a replay
  reads;
* a graph that updates tensors in place (``writes``: a train step's
  parameters, an EMA's) increments their version counters on every
  replay, as the eager in-place ops would: whatever is keyed by a
  tensor's version (the packed W1, a sampler's weights token) sees the
  change, though a replay runs no Python.

The JAX package's train steps are jitted functions of their state; the
port's step updates its state in place. Its graph is captured by
:func:`step_graph`, whose warm-up is the step itself: a first call makes
one step, eagerly, and records the graph; later calls replay it.

What a graph holds: its static inputs and outputs, and a private memory
pool with every intermediate tensor the capture allocated (the allocator
reuses a block freed within the capture, so this is about one step's
working set, not the trajectory's). The pool lives as long as the graph.
:class:`GraphCache` bounds how many graphs are kept (PERF.md gives what a
sampler's and FIRE's graphs hold on the H100). A cache made with
``shared_pool`` captures all its graphs into one pool instead: a later
capture reuses the blocks an earlier one freed (its intermediates), so the
pool holds the largest graph's working set and not the sum. That is safe
for graphs that are never replayed at once, such as a train step's graphs
by batch shape, replayed one after another on one stream: each replay
writes its intermediates before it reads them, and what a graph keeps
(its static inputs and outputs, the gradients it writes) stays allocated
while the graph lives.

Everything here needs CUDA tensors: a CPU tensor raises. Nothing here
falls back to running ``fn`` eagerly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..ops import gcl_kernel
from .metrics import span

__all__ = ["CapturedGraph", "GraphCache", "capture", "step_graph"]

#: Per thread: the side stream that thread warms up and captures on, by
#: device.
_SIDE = threading.local()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _cuda_device(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"a CUDA graph takes tensors on one CUDA device, "
                         f"got {sorted(map(str, devices))}")
    return next(iter(devices))


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(_map(fn, t) for t in tree)


class CapturedGraph:
    """A captured graph, its static inputs (by name) and outputs (a tensor
    or a tuple of them), and the edge-kernel launches one replay makes."""

    def __init__(self, graph: torch.cuda.CUDAGraph,
                 inputs: Dict[str, torch.Tensor], outputs,
                 launches: Dict[str, int], device: torch.device,
                 reads: Tuple[torch.Tensor, ...] = (),
                 writes: Tuple[torch.Tensor, ...] = ()):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.device = device
        self.reads = reads
        self.writes = writes
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()

    def __call__(self, *, replays: int = 1, **inputs):
        """Copy ``inputs`` into the static inputs of the same names (each
        static input must be given, on the graph's device), replay
        ``replays`` times, and return copies of the outputs, all on the
        caller's current stream; the versions of ``writes`` move on."""
        if set(inputs) != set(self.inputs):
            raise ValueError(f"the graph takes {sorted(self.inputs)}, got "
                             f"{sorted(inputs)}")
        if _cuda_device(inputs.values()) != self.device:
            raise ValueError(f"the graph was captured on {self.device}, got "
                             f"tensors on {_cuda_device(inputs.values())}")
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            stream.wait_event(self._done)
            for name, value in inputs.items():
                self.inputs[name].copy_(value)
            for _ in range(replays):
                self.graph.replay()
            out = _map(torch.clone, self.outputs)
            self._done.record(stream)
            for _ in range(replays):
                gcl_kernel.credit_launches(self.launches)
            if self.writes:
                torch.autograd.graph.increment_version(self.writes)
        return out


def capture(fn: Callable, inputs: Dict[str, torch.Tensor],
            warmup: Optional[Callable] = None,
            writes: Sequence[torch.Tensor] = (),
            pool: Optional[tuple] = None) -> CapturedGraph:
    """Record ``fn(**inputs)`` into a CUDA graph over static copies of
    ``inputs`` (CUDA tensors, all on one device), after one eager call of
    ``warmup`` (default ``fn``) on the same copies. ``fn`` must return a
    tensor or a tuple of tensors, make no host synchronisation and read no
    CPU tensor; ``writes``: the tensors other than its inputs that it
    updates in place; ``pool``: a memory pool handle to capture into
    (``torch.cuda.graph_pool_handle()``; default a private pool). Raises if
    the capture fails."""
    device = _cuda_device(inputs.values())
    static = {name: t.clone() for name, t in inputs.items()}
    caller = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        (warmup or fn)(**static)
        graph = torch.cuda.CUDAGraph()
        tally = gcl_kernel.captured_launches(side.cuda_stream)
        before = dict(tally)
        kept = gcl_kernel.captured_reads(side.cuda_stream)
        n_kept = len(kept)
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outputs = fn(**static)
        except BaseException:
            del kept[n_kept:]
            try:
                graph.capture_end()
            except RuntimeError:
                pass     # the capture was already invalidated: report fn's
            raise
        graph.capture_end()
    caller.wait_stream(side)
    launches = {k: n - before.get(k, 0) for k, n in tally.items()
                if n != before.get(k, 0)}
    reads = tuple(kept[n_kept:])
    del kept[n_kept:]
    return CapturedGraph(graph, static, outputs, launches, device, reads,
                         tuple(writes))


def step_graph(cache: "GraphCache", key: Hashable, token: Hashable,
               fn: Callable, inputs: Dict[str, torch.Tensor],
               writes: Sequence[torch.Tensor] = (),
               warmup: Optional[Callable] = None):
    """One call of ``fn(**inputs)``, a step that updates ``writes`` in
    place (an optimizer's, an EMA's) or a pure call (a loaded program's),
    through ``cache``'s graph under ``key``. Where ``cache`` has no graph under ``key`` and ``token``, the
    capture's warm-up, ``warmup`` (default ``fn``) on the static copies of
    ``inputs``, is this call's step, made eagerly, and the graph is
    recorded after it; otherwise the graph is replayed. Returns (the graph,
    the step's outputs, whether this call captured)."""
    first = []

    def warm(**static):
        first.append((warmup or fn)(**static))

    graph = cache.get(key, token, lambda: capture(fn, inputs, warm, writes,
                                                  cache.pool_handle()))
    if not first:
        return graph, graph(**inputs), False
    # the warm-up's outputs were made on the capture's side stream
    stream = torch.cuda.current_stream(graph.device)
    _map(lambda t: t.record_stream(stream), first[0])
    return graph, first[0], True


class GraphCache:
    """Captured graphs by key, at most ``maxsize`` (least recently used
    first out), each valid while the ``token`` it was captured under holds
    (e.g. the weights' storage and version). The twin of the JAX
    generator's dicts of compiled trajectories plus jit's retrace per
    shape. ``shared_pool``: :func:`step_graph` captures every graph of the
    cache into one memory pool (see the notes at the top); for graphs that
    are never replayed at once."""

    def __init__(self, maxsize: int, shared_pool: bool = False):
        self.maxsize = maxsize
        self.shared_pool = shared_pool
        #: Graphs captured through this cache since it was made, in all and
        #: by key.
        self.captures = 0
        self.captures_by_key: Dict[Hashable, int] = {}
        self._pool = None
        self._graphs: "OrderedDict[Hashable, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def pool_handle(self) -> Optional[tuple]:
        """The memory pool this cache's graphs share (made at the first
        capture), or None: each graph its own."""
        if self.shared_pool and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key: Hashable, token: Hashable,
            make: Callable[[], CapturedGraph]) -> CapturedGraph:
        """The graph under ``key`` if it was captured under ``token``, else
        ``make()``'s, kept under ``key``."""
        with self._lock:
            hit = self._graphs.get(key)
            if hit is not None and hit[0] == token:
                self._graphs.move_to_end(key)
                return hit[1]
        with span("mlcg.graph.capture"):
            graph = make()
        with self._lock:
            self.captures += 1
            self.captures_by_key[key] = self.captures_by_key.get(key, 0) + 1
            self._graphs[key] = (token, graph)
            self._graphs.move_to_end(key)
            while len(self._graphs) > self.maxsize:
                self._graphs.popitem(last=False)
        return graph
