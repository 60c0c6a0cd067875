"""Fused EGNN edge pass: the Hopper CUDA kernel, its wrapper and its plain version.

The kernels (``csrc/edge_mlp.cu`` in bfloat16, ``csrc/edge_mlp_f32.cu`` in
float32) replace the TPU kernel
``ml_conformer_generator_tpu/ops/gcl_kernel.py::_edge_kernel``. Per graph and
edge it computes ``m = SiLU(SiLU(u_i + v_j + e_ij W_e + b0) W1^T + b1)`` and
the scalar head ``m . wh + bh``; mode "gcl" returns the sigmoid-gated, masked
f32 j-sum ``out_i = sum_j m_ij gate_ij mask_ij / norm`` (B, N, H), mode
"coord" the raw per-edge head (B, N^2, 1).

What bounds it on an H100: the per-edge product with W1 (2 B N^2 H^2
operations) against a few MB of per-node inputs, so tensor-core operations,
not device memory; the SiLUs per edge element load the f32 and
special-function units about as much. Both kernels give a persistent block
tiles of 128 edge rows, whole target nodes each, run the product on
``wgmma`` with f32 accumulators in registers, and have one producer warp
stream W1 through a ring of shared memory slots with one bulk copy per tile,
completing on an ``mbarrier``. For that, W1 is packed once per weight
(:func:`pack_w1`, cached by :func:`packed_w1`) into the padded, tiled and
swizzled form the kernel consumes. The bf16 kernel (the main path) keeps m1
in swizzled shared memory. The f32 kernel takes the product as 3xTF32: each
operand split into a TF32 part and a TF32 residual, hi.hi + hi.lo + lo.hi,
which keeps f32 accuracy; its pack holds both parts of W1, and it builds m1
in registers. The head, the gate and the masked j-sum stay inside the block.
Both take N <= 128 and, on the square edge set, 128 < N <= 192 (all-atom
drug molecules) under kernel names of their own, ``edge_mlp_bf16_wide_kernel``,
``edge_mlp_f32_wide_kernel`` and ``edge_mlp_bwd_f32_wide_kernel``: a tile
for each target node's first 128 source nodes, one more for the tails of up
to 8 nodes, the sums that span a node's two tiles carried between them in a
fixed order. See the notes at the top of the CUDA sources.

The float32 kernels, forward and backward, also take a j-slab of the edge
set at N <= 128: u for N target nodes, v for N_l <= N source nodes, the edges
(B, N * N_l) in the order (i, j). The edge-sharded EGNN
(``parallel/edge_shard.py``) gives each rank one. The bfloat16 kernel takes
the square edge set only (N_l = N).

Dispatch: a CPU tensor goes to :func:`fused_edge_pass_reference`; a CUDA
tensor launches the kernel or raises. There is no fallback on the card. On
the card, a float32 call that autograd would record (grad mode on and an
input or weight that requires grad) goes through :class:`_EdgePassFunction`:
its forward launches the float32 kernel and saves only the inputs, its
backward launches the backward kernel (``csrc/edge_mlp_bwd_f32.cu``, see
:func:`fused_edge_pass_backward`), which recomputes each edge's chain. The
bfloat16 kernel has no backward yet: such a call in bfloat16 raises.

The three sources (``csrc/edge_mlp.cu`` for bfloat16, ``csrc/edge_mlp_f32.cu``
and ``csrc/edge_mlp_bwd_f32.cu`` for float32) are built with ``nvcc`` at
first use, side by side, into ``build/kernels/`` at the repository root, or
into the directory given to :func:`set_build_dir` (``utils/cache.py``'s
``enable_compile_cache``); plain C interfaces, loaded with ``ctypes``.

The forward is also the registered op ``mlcg_torch::fused_edge_pass``
(``torch.ops.mlcg_torch.fused_edge_pass``): its CPU implementation is the
plain version, its CUDA implementation launches the kernels, and its fake
implementation gives the output's shape and type, so that ``torch.export``
can trace the denoiser and keep each edge pass as one node (``export.py``).
The op costs host time a call, so :func:`fused_edge_pass` goes through it
only where a tracer or a dispatch mode has to see the edge pass as one op
(see there); the op has no autograd formula, so never under grad.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The kernel sources by library name: bfloat16 (the main path), float32,
#: and the float32 backward.
_SOURCES = {name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
            for name in ("edge_mlp", "edge_mlp_f32", "edge_mlp_bwd_f32")}
#: Where the libraries are built and found (:func:`set_build_dir`).
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_MODES = {"gcl": 0, "coord": 1}
_DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches per mode since import (or since the caller reset them):
#: the forward kernels under the mode's name, the backward kernel under the
#: mode's name and "_bwd". A launch recorded into a CUDA graph under capture
#: is not a launch: it goes to the capturing stream's tally
#: (:func:`captured_launches`), and each replay of the graph credits what its
#: capture recorded (:func:`credit_launches`, ``utils/cuda_graph.py``).
LAUNCHES: Dict[str, int] = {"gcl": 0, "coord": 0, "gcl_bwd": 0,
                            "coord_bwd": 0}
#: Forward edge passes per mode since import (or since the caller reset
#: them), one a forward launch: those at N <= 128 under the mode's name,
#: those at N > 128 (the kernels' wide paths) under the mode's name and
#: "_wide". Counted, captured and credited as LAUNCHES is; a graph's tally
#: holds them under "pass." and the key.
PASSES: Dict[str, int] = {"gcl": 0, "coord": 0, "gcl_wide": 0,
                          "coord_wide": 0}
#: Edge rows of a kernel tile: a pass at more nodes is a wide one.
TILE_ROWS = 128
#: By capturing stream (its handle): launches, and W1 packs under "packs",
#: recorded into graphs captured on it, and the tensors their launches read.
#: By stream, not by thread: a captured backward (a train step's) runs on
#: the autograd engine's device thread, on the capturing stream.
_CAPTURED: Dict[int, Dict[str, int]] = {}
_CAPTURED_READS: Dict[int, List[torch.Tensor]] = {}

#: Times W1 was packed since import (or since the caller reset it). A
#: weight is packed once and then served from the cache; a forward that
#: autograd records packs the backward's layouts with it, in the same pack.
#: A pack recorded into a graph is counted as its launches are: by each
#: replay.
PACKS = 0

#: Packed W1 layout, as the kernels consume it: output rows padded to _NP and
#: cut in halves of _NH, input columns in K-tiles; a tile is _NH rows of 128
#: bytes whose 16-byte chunks are XOR-swizzled with the row. A bf16 K-tile is
#: _KT input columns; a float32 K-tile is _KT32 input columns, a row holding
#: their 16 TF32 parts and then their 16 TF32 residuals. Where _NH < H <=
#: _NH + _SLIM the bf16 kernel runs half 1 _SLIM columns wide, and the bf16
#: pack's half 1 has _SLIM rows (:func:`_half1_rows`).
_NP, _NH, _KT, _KT32, _SLIM = 448, 224, 64, 16, 32
#: Position p of a float32 K-tile row holds input column _K_PERM[p] of the
#: K-tile: the wgmma A fragment's logical column 8 s + 4 h + t is what
#: thread t of a quad builds as input column 4 t + 2 s + h, so that a thread's
#: four columns are contiguous in u and v.
_K_PERM = [4 * (p % 4) + 2 * (p // 8) + (p // 4) % 2 for p in range(_KT32)]
#: The float32 backward kernel's tiles (edge rows) and consumer warps, each
#: warp with its own row of the dwh sums; past _BWD_ROWS nodes, the target
#: nodes of a wide work item whose tails share a tile, at most _WIDE_PACK.
_BWD_ROWS, _BWD_WARPS, _WIDE_PACK = 128, 8, 8

_libs: Optional[Dict[str, ctypes.CDLL]] = None
#: (max nodes in f32, max nodes in bf16, max hidden, max edge scalars) the
#: built kernels take.
_LIMITS = (0, 0, 0, 0)
#: id(w1) -> (weak reference, the data that was packed, version, packed
#: for the forward, packed for the backward or None).
_PACK_CACHE: Dict[int, Tuple[weakref.ref, torch.Tensor, int, torch.Tensor,
                             Optional[torch.Tensor]]] = {}
#: Output of the last build: {"seconds": float, "logs": {source name: str},
#: "paths": dict}.
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    """LAUNCHES and PASSES back to 0."""
    for counts in (LAUNCHES, PASSES):
        for k in counts:
            counts[k] = 0


def reset_pack_count() -> None:
    global PACKS
    PACKS = 0


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _current_stream() -> int:
    return (torch.cuda.current_stream().cuda_stream
            if torch.cuda.is_available() else 0)


def _count_launch(key: str, reads: Tuple[torch.Tensor, ...] = ()) -> None:
    """One launch of the kernel counted under ``key`` (a LAUNCHES key, or
    "pass." and a PASSES key): into its dict, or, while the current stream
    is capturing a CUDA graph, into that stream's tally of captured
    launches, and ``reads`` (what the kernel reads that its caller does not
    hold: the packed W1) into the stream's list of tensors the graph must
    keep alive."""
    if _capturing():
        tally = captured_launches()
        tally[key] = tally.get(key, 0) + 1
        captured_reads().extend(reads)
    else:
        credit_launches({key: 1})


def captured_launches(stream: Optional[int] = None) -> Dict[str, int]:
    """The tally of launches (and W1 packs, under "packs") recorded into
    CUDA graphs on ``stream`` (a handle; default the current stream), by
    LAUNCHES key (the live dict)."""
    return _CAPTURED.setdefault(
        _current_stream() if stream is None else stream, {})


def captured_reads(stream: Optional[int] = None) -> List[torch.Tensor]:
    """The tensors read by launches recorded into CUDA graphs on ``stream``
    (default the current stream) and not yet taken by their graph (the
    live list): a replay reads them by address, so the graph holds them."""
    return _CAPTURED_READS.setdefault(
        _current_stream() if stream is None else stream, [])


def credit_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (a graph's recorded launches, its edge passes under
    "pass." and the PASSES key, and packs under "packs") to LAUNCHES,
    PASSES and PACKS: one replay of that graph."""
    global PACKS
    for key, n in counts.items():
        if key == "packs":
            PACKS += n
        elif key.startswith("pass."):
            PASSES[key[5:]] += n
        else:
            LAUNCHES[key] += n


def _half1_rows(H: int) -> int:
    """Output rows of half 1 of the bf16 pack of a W1 of width H: _SLIM
    where _NH < H <= _NH + _SLIM (GEOM-Drugs' 256), else _NH."""
    return _SLIM if _NH < H <= _NH + _SLIM else _NH


def _chunk_swizzle(rows: int, device) -> torch.Tensor:
    """(rows, 8) index: position d of row r holds chunk d ^ (r % 8). The
    permutation is its own inverse."""
    r = torch.arange(rows, device=device)[:, None] % 8
    return torch.arange(8, device=device)[None, :] ^ r


def _k_perm(device) -> torch.Tensor:
    """``_K_PERM`` as an index on ``device``, computed there: no host copy,
    so that a pack can be recorded into a CUDA graph."""
    p = torch.arange(_KT32, device=device)
    return 4 * (p % 4) + 2 * (p // 8) + (p // 4) % 2


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (nearest, ties away from zero), as
    ``cvt.rna.tf32.f32`` does: the low 13 bits of each result are zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """W1 (H, H), torch layout [out][in], in the form the kernel of its type
    reads, flat. Plain torch, on any device.

    bfloat16: zero-padded to (_NH + _half1_rows(H), HP) with HP = 64 ceil(H /
    64), laid out tile by tile in the order the kernel consumes them: (half,
    K-tile, row, swizzled chunk, 8 values), a tile of half 0 _NH rows, one
    of half 1 _half1_rows(H). float32: zero-padded to (_NP, 16 ceil(H /
    16)) and split into hi = round_tf32(W1) and lo = round_tf32(W1 - hi);
    a tile row is the K-tile's 16 hi values and then its 16 lo values, both
    in the column order ``_K_PERM``, then (half, K-tile, row, swizzled
    chunk, 4 values). Either way a tile is one contiguous block of rows of
    128 bytes.
    """
    H = w1.shape[0]
    if w1.shape != (H, H) or H > _NP:
        raise ValueError(f"pack_w1 takes a square W1 of at most {_NP} rows, "
                         f"got {tuple(w1.shape)}")
    if w1.dtype == torch.float32:
        nkt = -(-H // _KT32)
        wp = w1.new_zeros(_NP, nkt * _KT32)
        wp[:H, :H] = w1
        hi = round_tf32(wp)
        lo = round_tf32(wp - hi)
        perm = _k_perm(w1.device)
        rows = torch.stack((hi.view(_NP, nkt, _KT32)[..., perm],
                            lo.view(_NP, nkt, _KT32)[..., perm]), 2)
        rows, rows1 = rows.view(_NP, nkt, 8, 4), _NH
    else:
        nkt, rows1 = -(-H // _KT), _half1_rows(H)
        wp = w1.new_zeros(_NH + rows1, nkt * _KT)
        wp[:H, :H] = w1
        rows = wp.view(_NH + rows1, nkt, 8, 8)
    halves = []
    for half in rows.split([_NH, rows1]):      # (row, K-tile, chunk, values)
        tiles = half.permute(1, 0, 2, 3)
        idx = _chunk_swizzle(half.shape[0], w1.device)[None, :, :, None]
        halves.append(torch.gather(tiles, 2, idx.expand_as(tiles)).reshape(-1))
    return torch.cat(halves)


def packed_w1(w1: torch.Tensor, backward: bool = False):
    """The packed form of ``w1``, made once per weight: ``pack_w1(w1)``, or
    with ``backward`` the pair (``pack_w1(w1)``, ``pack_w1(w1.t())``) that
    the float32 backward kernel reads (its second product, dpre1 . W1,
    takes W1^T as its [out][in] operand), made in one pack.

    The cache entry belongs to the tensor object and is valid while its data
    pointer and version counter stand: an in-place update (an optimizer
    step, ``load_state_dict``) or new storage (``.to()``) repacks. The entry
    holds on to the storage it packed, so that new storage cannot come to
    lie at the same address. The entry goes when the tensor does, so nothing
    accumulates per call.

    Under a CUDA graph's capture the pack is recorded too: a train step's
    graph, whose optimizer writes W1, packs the W1 of each replay (the
    capture's warm-up step moved W1's version, so the capture misses).
    Such a graph increments its weights' versions on each replay
    (``utils/cuda_graph.py``), so an eager call after a replay packs
    afresh.
    """
    global PACKS
    key = id(w1)
    hit = _PACK_CACHE.get(key)
    valid = (hit is not None and hit[0]() is w1
             and hit[1].data_ptr() == w1.data_ptr() and hit[2] == w1._version)
    if valid and (hit[4] is not None or not backward):
        return (hit[3], hit[4]) if backward else hit[3]
    source = w1.detach()
    # a valid entry's forward pack is kept: graphs captured before the
    # backward pack was added read it by address
    packed = hit[3] if valid else pack_w1(source)
    packed_bwd = pack_w1(source.t()) if backward else None
    if _capturing():
        tally = captured_launches()
        tally["packs"] = tally.get("packs", 0) + 1
    else:
        PACKS += 1
    ref = weakref.ref(w1, lambda _, key=key: _PACK_CACHE.pop(key, None))
    _PACK_CACHE[key] = (ref, source, w1._version, packed, packed_bwd)
    return (packed, packed_bwd) if backward else packed


def backward_tiles(N: int, NL: Optional[int] = None) -> Tuple[int, int]:
    """(target nodes a tile, tiles a graph) of the float32 backward kernel
    for graphs of N target nodes by NL source nodes (default N): whole
    target nodes of one graph, at most 128 edge rows a tile. Past 128 nodes
    (the square edge set), (target nodes a wide work item, work items a
    graph): as many nodes as share the tail tile of N - 128 source nodes
    each, at most 8. The dv partials it writes are (B, tiles a graph, NL,
    H)."""
    NL = N if NL is None else NL
    if N > _BWD_ROWS:
        ti = min(_WIDE_PACK, _BWD_ROWS // (N - _BWD_ROWS))
    else:
        ti = _BWD_ROWS // NL if NL <= _BWD_ROWS // 2 else 1
    return ti, -(-N // ti)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def set_build_dir(path: str) -> None:
    """Build and find the kernel libraries in ``path`` from now on. A
    process that has already loaded its libraries keeps them."""
    global _BUILD_DIR
    os.makedirs(path, exist_ok=True)
    _BUILD_DIR = os.path.abspath(path)


def library_paths() -> Dict[str, str]:
    """The library each source builds to, by source name: named by the
    source's hash, in the build directory."""
    paths = {}
    for name, src in _SOURCES.items():
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        paths[name] = os.path.join(_BUILD_DIR, f"lib{name}_{digest}.so")
    return paths


def build_kernel(verbose: bool = False) -> Dict[str, str]:
    """Compile the kernel sources for sm_90a into shared libraries.

    ``csrc/edge_mlp.cu`` (bfloat16), ``csrc/edge_mlp_f32.cu`` (float32) and
    ``csrc/edge_mlp_bwd_f32.cu`` (the float32 backward) are built side by
    side, one ``nvcc`` each. A library is named by its
    source's hash, so an edited source is rebuilt and a built one is reused.
    ``verbose`` rebuilds with ``-Xptxas -v`` (the per-kernel register and
    spill report lands in ``BUILD_INFO["logs"]`` by source name). Returns
    the libraries' paths by source name; a failed build raises.
    """
    t0 = time.perf_counter()
    paths, running = library_paths(), []
    for name, path in paths.items():
        if os.path.exists(path) and not verbose:
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
               tmp, _SOURCES[name]]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        running.append((name, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, tmp, path, proc in running:
        out = proc.communicate()[0]
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0 if running else 0.0,
                      logs=logs, paths=paths)
    return paths


def _load() -> Dict[str, ctypes.CDLL]:
    global _libs, _LIMITS
    if _libs is None:
        paths = build_kernel()
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        bf = ctypes.CDLL(paths["edge_mlp"])
        bf.mlcg_edge_mlp.restype = ci
        bf.mlcg_edge_mlp.argtypes = [ci, ci, ci, ci, ci, vp, vp, vp, vp, vp,
                                     ci, vp, vp, vp, vp, vp, cf, vp, vp, vp]
        bf.mlcg_cuda_error_string.restype = ctypes.c_char_p
        bf.mlcg_cuda_error_string.argtypes = [ci]
        f32 = ctypes.CDLL(paths["edge_mlp_f32"])
        f32.mlcg_edge_mlp_f32.restype = ci
        f32.mlcg_edge_mlp_f32.argtypes = [ci] * 6 + bf.mlcg_edge_mlp.argtypes[5:]
        for fn in (bf.mlcg_edge_mlp_max_nodes, bf.mlcg_edge_mlp_max_hidden,
                   bf.mlcg_edge_mlp_max_edge_feats,
                   bf.mlcg_edge_mlp_w1_tile_bytes,
                   f32.mlcg_edge_mlp_f32_max_nodes,
                   f32.mlcg_edge_mlp_f32_w1_tile_bytes):
            fn.restype = ci
            fn.argtypes = []
        bf.mlcg_edge_mlp_w1_half1_rows.restype = ci
        bf.mlcg_edge_mlp_w1_half1_rows.argtypes = [ci]
        if (bf.mlcg_edge_mlp_w1_tile_bytes() != _NH * 128
                or f32.mlcg_edge_mlp_f32_w1_tile_bytes() != _NH * 128
                or bf.mlcg_edge_mlp_max_hidden() != _NP
                or any(bf.mlcg_edge_mlp_w1_half1_rows(h) != _half1_rows(h)
                       for h in range(4, _NP + 1, 4))):
            raise RuntimeError("the built kernels and pack_w1 disagree on "
                               "the packed W1 layout")
        bwd = ctypes.CDLL(paths["edge_mlp_bwd_f32"])
        bwd.mlcg_edge_mlp_bwd_f32.restype = ci
        bwd.mlcg_edge_mlp_bwd_f32.argtypes = (
            [ci] * 6 + [vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, cf]
            + [vp] * 9 + [ci, vp, vp])
        for fn in (bwd.mlcg_edge_mlp_bwd_f32_max_nodes,
                   bwd.mlcg_edge_mlp_bwd_f32_w1_tile_bytes,
                   bwd.mlcg_edge_mlp_bwd_f32_part_floats):
            fn.restype = ci
            fn.argtypes = []
        bwd.mlcg_edge_mlp_bwd_f32_tiles_per_graph.restype = ci
        bwd.mlcg_edge_mlp_bwd_f32_tiles_per_graph.argtypes = [ci, ci]
        max_n = bwd.mlcg_edge_mlp_bwd_f32_max_nodes()
        if (bwd.mlcg_edge_mlp_bwd_f32_w1_tile_bytes() != _NH * 128
                or bwd.mlcg_edge_mlp_bwd_f32_part_floats() != _BWD_WARPS * _NP
                or max_n != f32.mlcg_edge_mlp_f32_max_nodes()
                or any(bwd.mlcg_edge_mlp_bwd_f32_tiles_per_graph(n, nl)
                       != backward_tiles(n, nl)[1]
                       for n in range(1, max_n + 1)
                       for nl in (range(1, n + 1) if n <= TILE_ROWS
                                  else (n,)))):
            raise RuntimeError("the built backward kernel and this wrapper "
                               "disagree on its layouts")
        _LIMITS = (f32.mlcg_edge_mlp_f32_max_nodes(),
                   bf.mlcg_edge_mlp_max_nodes(),
                   bf.mlcg_edge_mlp_max_hidden(),
                   bf.mlcg_edge_mlp_max_edge_feats())
        _libs = {"bfloat16": bf, "float32": f32, "backward": bwd}
    return _libs


def fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1, wh, bh, *,
                              mode: str = "gcl", norm: float = 100.0):
    """Plain PyTorch version of :func:`fused_edge_pass` (same arguments).

    The dense formulation of the JAX package's XLA path
    (``models/egnn.py`` ``_edge_stack_apply`` and the gate/j-sum of
    ``gcl_forward`` / the head of ``coord_update_forward``; on a j-slab,
    ``parallel/edge_shard.py`` ``_edge_stack_apply_local``): every op runs
    in the operand type, the j-sum accumulates in at least float32.
    """
    B, N, H = u.shape
    NL = v.shape[1]
    E = ef.shape[-1]
    acc = torch.promote_types(torch.float32, u.dtype)
    pre = (u[:, :, None, :] + v[:, None, :, :]
           + ef.reshape(B, N, NL, E) @ w_e.t() + b0)
    m = F.silu(F.silu(pre) @ w1.t() + b1)                  # (B, N, NL, H)
    head = m @ wh.reshape(H)                               # (B, N, NL)
    if bh is not None:
        head = head + bh.reshape(())
    if mode == "coord":
        return head.to(acc).reshape(B, N * NL, 1)
    if mode != "gcl":
        raise ValueError(f"unknown mode {mode!r}")
    gate = torch.sigmoid(head)[..., None]
    msg = m * gate * em.reshape(B, N, NL, 1)
    return msg.sum(dim=2, dtype=acc) / norm


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def fused_edge_pass(u, v, ef, em, w_e, b0, w1, b1, wh, bh, *,
                    mode: str = "gcl", norm: float = 100.0) -> torch.Tensor:
    """Batched fused edge-MLP pass.

    u: (B, N, H), the target nodes; v: (B, N_l, H), the source nodes (N_l
    = N for the whole edge set, N_l < N for a j-slab); ef: (B, N N_l, E);
    em: (B, N N_l, 1) (unused in "coord", may be None); w_e: (H, E), the
    edge-scalar columns of the first edge layer in torch layout (unit
    column stride, any row stride); b0, b1, wh: (H,); w1: (H, H) in torch
    layout [out][in]; bh: (1,) or None (zero). All in one operand type.
    Returns (B, N, H) for "gcl" (the j-sum over the N_l source nodes),
    (B, N N_l, 1) for "coord", float32 (float64 for float64 CPU inputs).

    On the card both types take N <= 192, H <= 448 with H a multiple of 4
    and E <= 4; float32 takes N_l <= N at N <= 128 and N_l = N past it,
    bfloat16 N_l = N only. A float32
    call that autograd records is differentiable through the backward
    kernel; the edge mask takes no gradient.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    recorded = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, v, ef, w_e, b0, w1, b1, wh, bh))
    if not recorded and (torch.compiler.is_compiling()
                         or torch._C._len_torch_dispatch_stack() > 0):
        # traced (torch.export) or under a dispatch mode (utils/debug.py):
        # the edge pass as one op
        return torch.ops.mlcg_torch.fused_edge_pass(
            u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode, float(norm))
    if u.device.type == "cpu":
        return fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1, wh,
                                         bh, mode=mode, norm=norm)
    if u.device.type != "cuda":
        raise ValueError(f"fused_edge_pass takes CPU or CUDA tensors, "
                         f"got {u.device}")
    if recorded:
        if u.dtype != torch.float32:
            # The kernel writes a fresh tensor that autograd cannot see
            # through, so a gradient would silently skip every edge MLP.
            raise RuntimeError(
                f"the {u.dtype} CUDA edge pass has no backward yet "
                "(ROADMAP.md M13b, the bf16 backward kernel): train in "
                "float32, run the forward under torch.no_grad(), or use CPU "
                "tensors, whose plain version is differentiable")
        if em is not None and em.requires_grad:
            raise ValueError("the edge mask takes no gradient")
        return _EdgePassFunction.apply(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                                       mode, norm)
    return _launch_forward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode=mode,
                           norm=norm)


@torch.library.custom_op("mlcg_torch::fused_edge_pass", mutates_args=(),
                         device_types="cpu")
def _edge_pass_op(u: torch.Tensor, v: torch.Tensor, ef: torch.Tensor,
                  em: Optional[torch.Tensor], w_e: torch.Tensor,
                  b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  wh: torch.Tensor, bh: Optional[torch.Tensor], mode: str,
                  norm: float) -> torch.Tensor:
    """The registered edge pass (arguments of :func:`fused_edge_pass`, mode
    and norm positional); on CPU tensors the plain version."""
    return fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                                     mode=mode, norm=norm)


@_edge_pass_op.register_kernel("cuda")
def _edge_pass_op_cuda(u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode, norm):
    return _launch_forward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode=mode,
                           norm=norm)


@_edge_pass_op.register_fake
def _edge_pass_op_fake(u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode, norm):
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    B, N, H = u.shape
    shape = (B, N, H) if mode == "gcl" else (B, N * v.shape[1], 1)
    return u.new_empty(shape,
                       dtype=torch.promote_types(torch.float32, u.dtype))


def _check_operands(u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode):
    """The kernels' shared checks: types, limits, shapes, layout."""
    dt = u.dtype
    if dt not in _DTYPES:
        raise TypeError(f"the CUDA edge pass takes float32 or bfloat16, got {dt}")
    B, N, H = u.shape
    NL = v.shape[1]
    E = ef.shape[-1]
    dev = u.device
    _load()
    bf16 = dt == torch.bfloat16
    max_n, max_h, max_e = _LIMITS[1 if bf16 else 0], _LIMITS[2], _LIMITS[3]
    if N > max_n or H > max_h or H % 4 or E > max_e:
        raise ValueError(f"the {'bfloat16' if bf16 else 'float32'} kernel "
                         f"takes N <= {max_n}, H <= {max_h} with H a multiple "
                         f"of 4, E <= {max_e}; got N={N}, H={H}, E={E}")
    if bf16 and NL != N:
        raise ValueError(f"the bfloat16 kernel takes the square edge set "
                         f"only (N_l = N); got a j-slab of N_l={NL} source "
                         f"nodes for N={N} (the float32 kernel takes slabs)")
    if not 0 < NL <= N:
        raise ValueError(f"the float32 kernel takes 0 < N_l <= N source "
                         f"nodes; got N_l={NL}, N={N}")
    if NL != N and N > TILE_ROWS:
        raise ValueError(f"the float32 kernel takes j-slabs at N <= "
                         f"{TILE_ROWS} only; got N_l={NL}, N={N}")
    _check("v", v, (B, NL, H), dt, dev)
    _check("ef", ef, (B, N * NL, E), dt, dev)
    _check("w_e", w_e, (H, E), dt, dev)
    _check("b0", b0, (H,), dt, dev)
    _check("w1", w1, (H, H), dt, dev)
    _check("b1", b1, (H,), dt, dev)
    _check("wh", wh, (H,), dt, dev)
    tensors = [u, v, ef, b0, w1, b1, wh]
    if mode == "gcl":
        if em is None:
            raise ValueError("mode 'gcl' needs the edge mask")
        _check("em", em, (B, N * NL, 1), dt, dev)
        tensors.append(em)
    if bh is not None:
        _check("bh", bh, (1,), dt, dev)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("fused_edge_pass needs contiguous u, v, ef, em, "
                             "b0, w1, b1 and wh")
    if E > 0 and w_e.stride(1) != 1:
        raise ValueError("w_e needs unit column stride")
    align = 8 if bf16 else 16
    for name, t in (("u", u), ("v", v)):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    return B, N, NL, H, E


def _launch_forward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, *, mode, norm,
                    w1p=None):
    """One launch of the forward kernel of u's type on CUDA tensors.
    ``w1p``: W1 already packed (else from the cache)."""
    B, N, NL, H, E = _check_operands(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                                     mode)
    libs = _load()
    dev = u.device
    if w1p is None:
        w1p = packed_w1(w1)
    out_shape = (B, N, H) if mode == "gcl" else (B, N * NL, 1)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    dims = (B, N, H, E) if u.dtype == torch.bfloat16 else (B, N, NL, H, E)
    shared = (*dims, u.data_ptr(), v.data_ptr(), ef.data_ptr(),
              em.data_ptr() if mode == "gcl" else None, w_e.data_ptr(),
              w_e.stride(0), b0.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
              wh.data_ptr(), bh.data_ptr() if bh is not None else None,
              float(norm), out.data_ptr())
    with torch.cuda.device(dev):   # the kernel launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = (libs["bfloat16"].mlcg_edge_mlp if u.dtype == torch.bfloat16
                 else libs["float32"].mlcg_edge_mlp_f32)
        rc = entry(_MODES[mode], *shared, None, stream)
    if rc != 0:
        raise RuntimeError(
            "edge pass kernel failed: "
            + libs["bfloat16"].mlcg_cuda_error_string(rc).decode())
    _count_launch(mode, (w1p,))
    _count_launch(f"pass.{mode}_wide" if N > TILE_ROWS else f"pass.{mode}")
    return out


class _EdgePassFunction(torch.autograd.Function):
    """The edge pass under autograd: forward by :func:`_launch_forward` on
    the card (the plain version on the CPU), backward by
    :func:`fused_edge_pass_backward`. Saves only the inputs; the backward
    kernel recomputes every edge activation. ``em`` takes no gradient."""

    @staticmethod
    def forward(ctx, u, v, ef, em, w_e, b0, w1, b1, wh, bh, mode, norm):
        ctx.w1p = None
        if u.device.type == "cpu":
            out = fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1,
                                            wh, bh, mode=mode, norm=norm)
        else:
            # Pack the backward's layouts of W1 with the forward's: one pack
            # per weight and step. The backward takes its pack from here:
            # the W1 it gets back from autograd (under remat a detached
            # alias) is not the tensor object the cache knows.
            ctx.w1p = packed_w1(w1, backward=True)
            out = _launch_forward(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                                  mode=mode, norm=norm, w1p=ctx.w1p[0])
        ctx.save_for_backward(u, v, ef, em, w_e, b0, w1, b1, wh, bh)
        ctx.mode, ctx.norm = mode, norm
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if ctx.w1p is None:
            grads = fused_edge_pass_backward(*saved, g, mode=ctx.mode,
                                             norm=ctx.norm)
        else:
            grads = _launch_backward(*saved, g, mode=ctx.mode, norm=ctx.norm,
                                     w1p=ctx.w1p)
        du, dv, de, dw_e, db0, dw1, db1, dwh, dbh = grads
        return (du, dv, de, None, dw_e, db0, dw1, db1, dwh, dbh, None, None)


def fused_edge_pass_backward_reference(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                                       g, *, mode: str = "gcl",
                                       norm: float = 100.0):
    """Plain PyTorch version of :func:`fused_edge_pass_backward` (same
    arguments and outputs): ``torch.autograd.grad`` through
    :func:`fused_edge_pass_reference`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (u, v, ef, w_e, b0, w1, b1, wh)]
        lbh = bh.detach().requires_grad_(True) if bh is not None else None
        lu, lv, lef, lwe, lb0, lw1, lb1, lwh = leaves
        out = fused_edge_pass_reference(lu, lv, lef, em, lwe, lb0, lw1, lb1,
                                        lwh, lbh, mode=mode, norm=norm)
        if lbh is not None:
            leaves.append(lbh)
        grads = torch.autograd.grad(out, leaves, g)
    return tuple(grads) + ((None,) if bh is None else ())


def fused_edge_pass_backward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, g, *,
                             mode: str = "gcl", norm: float = 100.0):
    """Gradient of :func:`fused_edge_pass` with respect to every input but
    the edge mask, given the upstream gradient ``g`` (the output's shape).

    Returns (du, dv, de, dw_e, db0, dw1, db1, dwh, dbh), each in its
    input's shape (dbh None when bh is None). A CPU tensor goes to
    :func:`fused_edge_pass_backward_reference`; a float32 CUDA tensor
    launches the backward kernel (``csrc/edge_mlp_bwd_f32.cu``), which
    writes the recomputed first-layer activations s0 and dpre1, (B N N_l,
    H) each, and [dW1 | db1] = dpre1^T [s0 | 1] is one ``torch.matmul`` (a
    library product, as XLA's in the JAX package); the kernel's per-tile
    and per-block partials are added by :func:`_reduce_backward`. Other
    CUDA types raise.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if u.device.type == "cpu":
        return fused_edge_pass_backward_reference(
            u, v, ef, em, w_e, b0, w1, b1, wh, bh, g, mode=mode, norm=norm)
    if u.device.type != "cuda":
        raise ValueError(f"fused_edge_pass_backward takes CPU or CUDA "
                         f"tensors, got {u.device}")
    if u.dtype != torch.float32:
        raise RuntimeError(
            f"the {u.dtype} CUDA edge pass has no backward yet (ROADMAP.md "
            "M13b, the bf16 backward kernel)")
    return _launch_backward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, g,
                            mode=mode, norm=norm,
                            w1p=packed_w1(w1, backward=True))


def _launch_backward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, g, *, mode,
                     norm, w1p):
    """One launch of the float32 backward kernel on CUDA tensors, with
    ``w1p`` the pair (``pack_w1(w1)``, ``pack_w1(w1.t())``), then the
    reduction of what it wrote (:func:`_reduce_backward`)."""
    B, N, NL, H, E = _check_operands(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                                     mode)
    dev = u.device
    g_shape = (B, N, H) if mode == "gcl" else (B, N * NL, 1)
    if tuple(g.shape) != g_shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {g_shape}")
    g = g.to(torch.float32).contiguous()
    lib = _load()["backward"]
    M = B * N * NL
    f32 = dict(dtype=torch.float32, device=dev)
    nblk = torch.cuda.get_device_properties(dev).multi_processor_count
    raw = dict(s0=torch.empty(M, H + 4, **f32), dpre1=torch.empty(M, H, **f32),
               du=torch.empty(B, N, H, **f32),
               dvp=torch.empty(B, backward_tiles(N, NL)[1], NL, H, **f32),
               de=torch.empty(B, N * NL, E, **f32),
               dwe=torch.empty(B, N, E, H, **f32), dhead=torch.empty(M, **f32),
               part=torch.zeros(nblk, _BWD_WARPS, _NP, **f32))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mlcg_edge_mlp_bwd_f32(
            _MODES[mode], B, N, NL, H, E, u.data_ptr(), v.data_ptr(),
            ef.data_ptr(), em.data_ptr() if mode == "gcl" else None,
            w_e.data_ptr(), w_e.stride(0), b0.data_ptr(), w1p[0].data_ptr(),
            w1p[1].data_ptr(), b1.data_ptr(), wh.data_ptr(),
            bh.data_ptr() if bh is not None else None, float(norm),
            g.data_ptr(), *(t.data_ptr() for t in raw.values()), nblk, None,
            stream)
    if rc != 0:
        raise RuntimeError(
            "edge pass backward kernel failed: "
            + _load()["bfloat16"].mlcg_cuda_error_string(rc).decode())
    _count_launch(f"{mode}_bwd", tuple(w1p))
    return _reduce_backward(raw, bh is not None)


def _reduce_backward(raw, has_bh: bool):
    """The gradients (du, dv, de, dw_e, db0, dw1, db1, dwh, dbh) from what the
    backward kernel wrote, ``raw``: s0 (B N N_l, H + 4) with a column of
    ones after its H columns, dpre1 (B N N_l, H), du (B, N, H), the dv
    partials dvp (B, tiles a graph, N_l, H), de (B, N N_l, E), dwe (B, N, E,
    H) with sum_j dpre0_ij e_ij, dhead (B N N_l,) and the dwh sums by block
    and warp,
    part (blocks, warps, 448). [dW1 | db1] = dpre1^T [s0 | 1] is one library
    product; every other sum is over a fixed shape, so it is taken in a
    fixed order. Plain torch, on any device."""
    H = raw["du"].shape[-1]
    ext = torch.matmul(raw["dpre1"].t(), raw["s0"])           # (H, H + 4)
    dw1 = ext[:, :H].contiguous()
    db1 = ext[:, H].contiguous()
    du = raw["du"]
    dv = raw["dvp"].sum(1)
    dw_e = raw["dwe"].sum((0, 1)).t()
    db0 = du.sum((0, 1))
    dwh = raw["part"].reshape(-1, raw["part"].shape[-1]).sum(0)[:H]
    dbh = raw["dhead"].sum().reshape(1) if has_bh else None
    return du, dv, raw["de"], dw_e, db0, dw1, db1, dwh, dbh


def _split_first_layer(lin0, h, h_src=None):
    """u = h W_src, v = h_src W_tgt (h_src: the source nodes, default h) and
    the edge-scalar columns W_e of the first edge layer (torch layout
    [out][2H + E]): the split-weight form of Linear([h_i, h_j, e_ij])."""
    H = h.shape[-1]
    w = lin0.weight
    u = F.linear(h, w[:, :H])
    v = F.linear(h if h_src is None else h_src, w[:, H:2 * H])
    return u, v, w[:, 2 * H:]


def gcl_edge_aggregate(gcl, h: torch.Tensor, edge_feat: torch.Tensor,
                       edge_mask: torch.Tensor, norm: float,
                       h_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GCL edge aggregate (B, N, H) in h.dtype through the fused edge pass.

    gcl: a module with ``edge_mlp`` (Linear, SiLU, Linear, SiLU) and
    ``att_mlp`` (Linear, Sigmoid); h: (B, N, H); edge_feat: (B, N, N_l, E);
    edge_mask: (B, N, N_l, 1), both in h.dtype; h_src: (B, N_l, H), the
    source nodes of a j-slab (default h, N_l = N): the j-sum then runs over
    the slab.
    """
    B, N, H = h.shape
    NL = edge_feat.shape[2]
    lin0, lin1, att = gcl.edge_mlp[0], gcl.edge_mlp[2], gcl.att_mlp[0]
    u, v, w_e = _split_first_layer(lin0, h, h_src)
    agg = fused_edge_pass(
        u, v, edge_feat.reshape(B, N * NL, -1),
        edge_mask.reshape(B, N * NL, 1), w_e, lin0.bias, lin1.weight,
        lin1.bias, att.weight.reshape(H), att.bias, mode="gcl", norm=norm)
    return agg.to(h.dtype)


def coord_edge_scalars(eq, h: torch.Tensor, edge_feat: torch.Tensor,
                       h_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge scalar head of the coordinate update, (B, N, N_l, 1)
    float32 (float64 for float64 inputs). eq: a module with ``coord_mlp``
    (Linear, SiLU, Linear, SiLU, Linear without bias); h_src: the source
    nodes of a j-slab, as in :func:`gcl_edge_aggregate`."""
    B, N, H = h.shape
    NL = edge_feat.shape[2]
    lin0, lin1, out = eq.coord_mlp[0], eq.coord_mlp[2], eq.coord_mlp[4]
    u, v, w_e = _split_first_layer(lin0, h, h_src)
    scal = fused_edge_pass(
        u, v, edge_feat.reshape(B, N * NL, -1), None, w_e, lin0.bias,
        lin1.weight, lin1.bias, out.weight.reshape(H), None, mode="coord")
    return scal.reshape(B, N, NL, 1)
