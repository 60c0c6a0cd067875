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
Both take N <= 128. See the notes at the top of the CUDA sources.

Dispatch: a CPU tensor goes to :func:`fused_edge_pass_reference`; a CUDA
tensor launches the kernel or raises. There is no fallback on the card.

The two sources (``csrc/edge_mlp.cu`` for bfloat16, ``csrc/edge_mlp_f32.cu``
for float32) are built with ``nvcc`` at first use, side by side, into
``build/kernels/`` at the repository root (plain C interfaces, loaded with
``ctypes``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The kernel sources by library name: bfloat16 (the main path), float32.
_SOURCES = {"edge_mlp": os.path.join(_PKG_DIR, "csrc", "edge_mlp.cu"),
            "edge_mlp_f32": os.path.join(_PKG_DIR, "csrc", "edge_mlp_f32.cu")}
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_MODES = {"gcl": 0, "coord": 1}
_DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches per mode since import (or since the caller reset them).
LAUNCHES: Dict[str, int] = {"gcl": 0, "coord": 0}

#: Times W1 was packed since import (or since the caller reset it). A
#: weight is packed once and then served from the cache.
PACKS = 0

#: Packed W1 layout, as the kernels consume it: output rows padded to _NP and
#: cut in halves of _NH, input columns in K-tiles; a tile is _NH rows of 128
#: bytes whose 16-byte chunks are XOR-swizzled with the row. A bf16 K-tile is
#: _KT input columns; a float32 K-tile is _KT32 input columns, a row holding
#: their 16 TF32 parts and then their 16 TF32 residuals.
_NP, _NH, _KT, _KT32 = 448, 224, 64, 16
#: Position p of a float32 K-tile row holds input column _K_PERM[p] of the
#: K-tile: the wgmma A fragment's logical column 8 s + 4 h + t is what
#: thread t of a quad builds as input column 4 t + 2 s + h, so that a thread's
#: four columns are contiguous in u and v.
_K_PERM = [4 * (p % 4) + 2 * (p // 8) + (p // 4) % 2 for p in range(_KT32)]

_libs: Optional[Dict[str, ctypes.CDLL]] = None
#: (max nodes in f32, max nodes in bf16, max hidden, max edge scalars) the
#: built kernels take.
_LIMITS = (0, 0, 0, 0)
#: id(w1) -> (weak reference, the data that was packed, version, packed).
_PACK_CACHE: Dict[int, Tuple[weakref.ref, torch.Tensor, int,
                             torch.Tensor]] = {}
#: Output of the last build: {"seconds": float, "logs": {source name: str},
#: "paths": dict}.
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_pack_count() -> None:
    global PACKS
    PACKS = 0


def _chunk_swizzle(device) -> torch.Tensor:
    """(_NH, 8) index: position d of row r holds chunk d ^ (r % 8). The
    permutation is its own inverse."""
    rows = torch.arange(_NH, device=device)[:, None] % 8
    return torch.arange(8, device=device)[None, :] ^ rows


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (nearest, ties away from zero), as
    ``cvt.rna.tf32.f32`` does: the low 13 bits of each result are zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """W1 (H, H), torch layout [out][in], in the form the kernel of its type
    reads, flat. Plain torch, on any device.

    bfloat16: zero-padded to (_NP, HP) with HP = 64 ceil(H / 64), laid out
    tile by tile in the order the kernel consumes them: (half, K-tile, row,
    swizzled chunk, 8 values). float32: zero-padded to (_NP, 16 ceil(H /
    16)) and split into hi = round_tf32(W1) and lo = round_tf32(W1 - hi);
    a tile row is the K-tile's 16 hi values and then its 16 lo values, both
    in the column order ``_K_PERM``, then (half, K-tile, row, swizzled
    chunk, 4 values). Either way a tile is one contiguous block of _NH x 128
    bytes.
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
        perm = torch.tensor(_K_PERM, device=w1.device)
        rows = torch.stack((hi.view(_NP, nkt, _KT32)[..., perm],
                            lo.view(_NP, nkt, _KT32)[..., perm]), 2)
        tiles = rows.view(2, _NH, nkt, 8, 4).permute(0, 2, 1, 3, 4)
    else:
        nkt = -(-H // _KT)
        wp = w1.new_zeros(_NP, nkt * _KT)
        wp[:H, :H] = w1
        tiles = wp.view(2, _NH, nkt, 8, 8).permute(0, 2, 1, 3, 4)
    idx = _chunk_swizzle(w1.device)[None, None, :, :, None].expand_as(tiles)
    return torch.gather(tiles, 3, idx).contiguous().view(-1)


def packed_w1(w1: torch.Tensor) -> torch.Tensor:
    """The packed form of ``w1``, made once per weight.

    The cache entry belongs to the tensor object and is valid while its data
    pointer and version counter stand: an in-place update (an optimizer
    step, ``load_state_dict``) or new storage (``.to()``) repacks. The entry
    holds on to the storage it packed, so that new storage cannot come to
    lie at the same address. The entry goes when the tensor does, so nothing
    accumulates per call.
    """
    global PACKS
    key = id(w1)
    hit = _PACK_CACHE.get(key)
    if (hit is not None and hit[0]() is w1
            and hit[1].data_ptr() == w1.data_ptr()
            and hit[2] == w1._version):
        return hit[3]
    source = w1.detach()
    packed = pack_w1(source)
    PACKS += 1
    ref = weakref.ref(w1, lambda _, key=key: _PACK_CACHE.pop(key, None))
    _PACK_CACHE[key] = (ref, source, w1._version, packed)
    return packed


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_kernel(verbose: bool = False) -> Dict[str, str]:
    """Compile the two kernel sources for sm_90a into shared libraries.

    ``csrc/edge_mlp.cu`` (bfloat16) and ``csrc/edge_mlp_f32.cu`` (float32)
    are built side by side, one ``nvcc`` each. A library is named by its
    source's hash, so an edited source is rebuilt and a built one is reused.
    ``verbose`` rebuilds with ``-Xptxas -v`` (the per-kernel register and
    spill report lands in ``BUILD_INFO["logs"]`` by source name). Returns
    the libraries' paths by source name; a failed build raises.
    """
    t0 = time.perf_counter()
    paths, running = {}, []
    for name, src in _SOURCES.items():
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        path = os.path.join(_BUILD_DIR, f"lib{name}_{digest}.so")
        paths[name] = path
        if os.path.exists(path) and not verbose:
            continue
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
               tmp, src]
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
        f32.mlcg_edge_mlp_f32.argtypes = bf.mlcg_edge_mlp.argtypes
        for fn in (bf.mlcg_edge_mlp_max_nodes, bf.mlcg_edge_mlp_max_hidden,
                   bf.mlcg_edge_mlp_max_edge_feats,
                   bf.mlcg_edge_mlp_w1_tile_bytes,
                   f32.mlcg_edge_mlp_f32_max_nodes,
                   f32.mlcg_edge_mlp_f32_w1_tile_bytes):
            fn.restype = ci
            fn.argtypes = []
        if (bf.mlcg_edge_mlp_w1_tile_bytes() != _NH * 128
                or f32.mlcg_edge_mlp_f32_w1_tile_bytes() != _NH * 128
                or bf.mlcg_edge_mlp_max_hidden() != _NP):
            raise RuntimeError("the built kernels and pack_w1 disagree on "
                               "the packed W1 layout")
        _LIMITS = (f32.mlcg_edge_mlp_f32_max_nodes(),
                   bf.mlcg_edge_mlp_max_nodes(),
                   bf.mlcg_edge_mlp_max_hidden(),
                   bf.mlcg_edge_mlp_max_edge_feats())
        _libs = {"bfloat16": bf, "float32": f32}
    return _libs


def fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1, wh, bh, *,
                              mode: str = "gcl", norm: float = 100.0):
    """Plain PyTorch version of :func:`fused_edge_pass` (same arguments).

    The dense formulation of the JAX package's XLA path
    (``models/egnn.py`` ``_edge_stack_apply`` and the gate/j-sum of
    ``gcl_forward`` / the head of ``coord_update_forward``): every op runs
    in the operand type, the j-sum accumulates in at least float32.
    """
    B, N, H = u.shape
    E = ef.shape[-1]
    acc = torch.promote_types(torch.float32, u.dtype)
    pre = (u[:, :, None, :] + v[:, None, :, :]
           + ef.reshape(B, N, N, E) @ w_e.t() + b0)
    m = F.silu(F.silu(pre) @ w1.t() + b1)                  # (B, N, N, H)
    head = m @ wh.reshape(H)                               # (B, N, N)
    if bh is not None:
        head = head + bh.reshape(())
    if mode == "coord":
        return head.to(acc).reshape(B, N * N, 1)
    if mode != "gcl":
        raise ValueError(f"unknown mode {mode!r}")
    gate = torch.sigmoid(head)[..., None]
    msg = m * gate * em.reshape(B, N, N, 1)
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

    u, v: (B, N, H); ef: (B, N^2, E); em: (B, N^2, 1) (unused in "coord",
    may be None); w_e: (H, E), the edge-scalar columns of the first edge
    layer in torch layout (unit column stride, any row stride); b0, b1, wh:
    (H,); w1: (H, H) in torch layout [out][in]; bh: (1,) or None (zero).
    All in one operand type. Returns (B, N, H) for "gcl", (B, N^2, 1) for
    "coord", float32 (float64 for float64 CPU inputs).

    On the card both types take N <= 128, H <= 448 with H a multiple of 4
    and E <= 4.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if u.device.type == "cpu":
        return fused_edge_pass_reference(u, v, ef, em, w_e, b0, w1, b1, wh,
                                         bh, mode=mode, norm=norm)
    if u.device.type != "cuda":
        raise ValueError(f"fused_edge_pass takes CPU or CUDA tensors, "
                         f"got {u.device}")
    dt = u.dtype
    if dt not in _DTYPES:
        raise TypeError(f"the CUDA edge pass takes float32 or bfloat16, got {dt}")
    B, N, H = u.shape
    E = ef.shape[-1]
    dev = u.device
    libs = _load()
    bf16 = dt == torch.bfloat16
    max_n, max_h, max_e = _LIMITS[1 if bf16 else 0], _LIMITS[2], _LIMITS[3]
    if N > max_n or H > max_h or H % 4 or E > max_e:
        raise ValueError(f"the {'bfloat16' if bf16 else 'float32'} kernel "
                         f"takes N <= {max_n}, H <= {max_h} with H a multiple "
                         f"of 4, E <= {max_e}; got N={N}, H={H}, E={E}")
    _check("v", v, (B, N, H), dt, dev)
    _check("ef", ef, (B, N * N, E), dt, dev)
    _check("w_e", w_e, (H, E), dt, dev)
    _check("b0", b0, (H,), dt, dev)
    _check("w1", w1, (H, H), dt, dev)
    _check("b1", b1, (H,), dt, dev)
    _check("wh", wh, (H,), dt, dev)
    tensors = [u, v, ef, b0, w1, b1, wh]
    if mode == "gcl":
        if em is None:
            raise ValueError("mode 'gcl' needs the edge mask")
        _check("em", em, (B, N * N, 1), dt, dev)
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
    w1p = packed_w1(w1)
    out_shape = (B, N, H) if mode == "gcl" else (B, N * N, 1)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    shared = (B, N, H, E, u.data_ptr(), v.data_ptr(), ef.data_ptr(),
              em.data_ptr() if mode == "gcl" else None, w_e.data_ptr(),
              w_e.stride(0), b0.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
              wh.data_ptr(), bh.data_ptr() if bh is not None else None,
              float(norm), out.data_ptr())
    with torch.cuda.device(dev):   # the kernel launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = (libs["bfloat16"].mlcg_edge_mlp if bf16
                 else libs["float32"].mlcg_edge_mlp_f32)
        rc = entry(_MODES[mode], *shared, None, stream)
    if rc != 0:
        raise RuntimeError(
            "edge pass kernel failed: "
            + libs["bfloat16"].mlcg_cuda_error_string(rc).decode())
    LAUNCHES[mode] += 1
    return out


def _split_first_layer(lin0, h):
    """u = h W_src, v = h W_tgt and the edge-scalar columns W_e of the first
    edge layer (torch layout [out][2H + E]): the split-weight form of
    Linear([h_i, h_j, e_ij])."""
    H = h.shape[-1]
    w = lin0.weight
    u = F.linear(h, w[:, :H])
    v = F.linear(h, w[:, H:2 * H])
    return u, v, w[:, 2 * H:]


def gcl_edge_aggregate(gcl, h: torch.Tensor, edge_feat: torch.Tensor,
                       edge_mask: torch.Tensor, norm: float) -> torch.Tensor:
    """GCL edge aggregate (B, N, H) in h.dtype through the fused edge pass.

    gcl: a module with ``edge_mlp`` (Linear, SiLU, Linear, SiLU) and
    ``att_mlp`` (Linear, Sigmoid); h: (B, N, H); edge_feat: (B, N, N, E);
    edge_mask: (B, N, N, 1), both in h.dtype.
    """
    B, N, H = h.shape
    lin0, lin1, att = gcl.edge_mlp[0], gcl.edge_mlp[2], gcl.att_mlp[0]
    u, v, w_e = _split_first_layer(lin0, h)
    agg = fused_edge_pass(
        u, v, edge_feat.reshape(B, N * N, -1), edge_mask.reshape(B, N * N, 1),
        w_e, lin0.bias, lin1.weight, lin1.bias, att.weight.reshape(H),
        att.bias, mode="gcl", norm=norm)
    return agg.to(h.dtype)


def coord_edge_scalars(eq, h: torch.Tensor,
                       edge_feat: torch.Tensor) -> torch.Tensor:
    """Per-edge scalar head of the coordinate update, (B, N, N, 1) float32
    (float64 for float64 inputs). eq: a module with ``coord_mlp`` (Linear,
    SiLU, Linear, SiLU, Linear without bias)."""
    B, N, H = h.shape
    lin0, lin1, out = eq.coord_mlp[0], eq.coord_mlp[2], eq.coord_mlp[4]
    u, v, w_e = _split_first_layer(lin0, h)
    scal = fused_edge_pass(
        u, v, edge_feat.reshape(B, N * N, -1), None, w_e, lin0.bias,
        lin1.weight, lin1.bias, out.weight.reshape(H), None, mode="coord")
    return scal.reshape(B, N, N, 1)
