#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``ml_conformer_generator_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus the kernel's phase clocks and
                                      # one request under torch.profiler

It builds the port's CUDA kernels from ``ml_conformer_generator_tpu_torch/
csrc/`` (``edge_mlp.cu`` for bfloat16, ``edge_mlp_f32.cu`` for float32, one
``nvcc`` each, side by side) and drives the port's main path, the
reference-conditioned ``MLConformerGenerator.generate_conformers``, at full
width (EGNN 420 x 9 blocks, AdjMatSeer 2048) with random weights made from a
seed, in bf16 (the default) and in float32. Phases:

1. environment: device, name and power limit from nvidia-smi; TF32 off;
2. build: ``nvcc`` for sm_90a, with the build time, and per source ptxas's
   registers, spills and C7511 notes and the wgmma instructions in the SASS;
3. kernel: each edge-pass mode (gcl, coord) in bf16 and f32 against its
   plain PyTorch version on the card, at the production shape (B=128, N=40),
   at a shape with more than 48 nodes (B=16, N=64), at one whose graphs do
   not fill their last tile of target nodes (B=5, N=40), at the most nodes
   a tile holds (B=8, N=128) and at the shape this run's request gives it;
   kernel, plain and library times (CUDA events) beside the bound; then the
   cache of packed W1 in both types: a second launch packs nothing, an
   in-place change of W1 packs again and changes the result;
4. model: one full-width bf16 ``dynamics_forward`` through the kernel
   against the same forward through the plain version;
5. end to end: a short f32 generation through the kernel against the same
   generation through the plain version, a short bf16 generation of
   molecules of up to 60 atoms, then the request ``generate_conformers``
   twice (warm-up, timed) in bf16 and then in float32, each with exact
   launch counts and no W1 packed in the timed one.

Any failed check raises, so the script exits non-zero and does not print its
last line, ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
with code 2 before doing anything.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ml_conformer_generator_tpu_torch"
KERNEL_SOURCE = f"{PACKAGE}/csrc/edge_mlp.cu"      # bf16: the main path
F32_SOURCE = f"{PACKAGE}/csrc/edge_mlp_f32.cu"     # float32 (3xTF32)
KERNEL_SOURCES = {"edge_mlp": KERNEL_SOURCE, "edge_mlp_f32": F32_SOURCE}
TPU_KERNEL = "ml_conformer_generator_tpu/ops/gcl_kernel.py:160"

# The request: 64 samples, variance 2, 100 steps, around this reference.
N_SAMPLES, VARIANCE, STEPS = 64, 2, 100
# Published H100 SXM peaks (dense) for what each kernel computes: bf16 on the
# tensor cores; f32-accurate products as 3xTF32, three TF32 tensor-core
# products (495 TFLOP/s) for each (see edge_pass_bound).
# Kernel against plain, (atol, rtol) by (type, mode). bf16 gcl outputs are
# j-sums / 100, mostly below 0.1, so their bar is set from the measured
# error (~3e-3 at most), not from bf16's 8 mantissa bits; the per-edge coord
# head reaches ~2.6 and keeps the looser bar.
TOLERANCE = {("bfloat16", "gcl"): (5e-3, 1e-2),
             ("bfloat16", "coord"): (5e-2, 5e-2),
             ("float32", "gcl"): (1e-5, 1e-4),
             ("float32", "coord"): (1e-5, 1e-4)}
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_BYTES = 3.35e12

# A drug-like reference, heavy atoms only: (atomic number, x, y, z) in
# Angstrom. A pyridyl-phenyl core with methoxy, amide chain, thioether,
# chloride, fluoride and ethyl substituents (25 atoms).
_REFERENCE = [
    (6, 1.390, 0.000, 0.000), (6, 0.695, 1.204, 0.067),
    (6, -0.695, 1.204, 0.073), (6, -1.390, 0.000, 0.011),
    (6, -0.695, -1.204, -0.061), (6, 0.695, -1.204, -0.077),
    (6, 2.880, 0.000, -0.022), (6, 3.575, -1.204, 0.053),
    (6, 4.965, -1.204, 0.079), (7, 5.660, -0.000, 0.033),
    (6, 4.965, 1.204, -0.044), (6, 3.575, 1.204, -0.080),
    (8, -1.375, 2.382, -0.043), (6, -2.805, 2.382, 0.034),
    (6, -1.445, -2.503, 0.079), (8, -2.675, -2.503, 0.052),
    (7, -0.775, -3.663, -0.023), (6, -1.505, -4.928, -0.077),
    (6, -0.740, -6.253, -0.060), (6, -1.505, -7.578, 0.012),
    (16, 7.430, 0.000, 0.067), (17, 2.705, 2.711, -0.068),
    (9, 2.900, -2.373, -0.072), (6, 5.720, -2.511, -0.011),
    (6, 7.250, -2.511, 0.061),
]


def log(*args):
    print(*args, flush=True)


def sass_mma(gk, lib_path):
    """The tensor-core instructions in a built library's SASS, by opcode
    and count (from ``cuobjdump -sass``), e.g. {"HGMMA.64x224x8.F32.TF32":
    24}: what the source's wgmma became."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(gk._nvcc())),
                             "cuobjdump")
    try:
        sass = subprocess.run([cuobjdump, "-sass", lib_path],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({type(exc).__name__})"
    ops = {}
    for line in sass.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith(("HGMMA", "HMMA")):
                ops[word] = ops.get(word, 0) + 1
    return ops or "no tensor-core instructions"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean time of ``fn`` on the card over ``iters`` warm launches (CUDA
    events). The inputs stay in the 50 MB L2, as they do when the model
    has just written them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edge_pass_bound(B, N, H, E, dtype_name, mode):
    """Least time (ms) of one edge pass on an H100, and what bounds it.

    Operations: the per-edge products of the kernel (edge scalars through
    W_e, m1 through W1, m2 through the head), 2 B N^2 H (H + E + 1), at the
    rate of the kind of product the kernel does. bf16: the bf16 tensor
    cores. float32: f32-accurate products taken as 3xTF32, three TF32
    tensor-core products for each, so a third of the TF32 rate (165
    TFLOP/s). Counted at the f32 FMA rate (67 TFLOP/s) instead, the bound
    would sit below what the kernel reaches, and its share would read over
    100%. Bytes: each input read once, the float32 output written once."""
    el = 2 if dtype_name == "bfloat16" else 4
    ops = 2.0 * B * N * N * H * (H + E + 1)
    n_in = 2 * B * N * H + B * N * N * E + H * E + H * H + 3 * H
    if mode == "gcl":
        n_in += B * N * N + 1
    n_out = B * N * H if mode == "gcl" else B * N * N
    t_ops = ops / PEAK_OPS[dtype_name]
    t_bytes = (n_in * el + n_out * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# Work of the bf16 kernel outside the tensor cores, per element of the
# (B N^2, 448) edge tensors (448: H padded to the kernel's width), as
# csrc/edge_mlp.cu is written. Special-function unit: one tanh.approx for
# each of the two SiLUs. Other f32/integer instructions: building m1 about
# 9.5 (add u + v, two edge-scalar FMAs, round, halve, fused multiply-add,
# round, a share of the loads and the store), the epilogue about 7.5 (bias,
# the same SiLU, the head's FMA); gcl adds about 4 (gate product, pack,
# store, and the j-sum's unpack and FMA).
MUFU_PER_ELEMENT = 2.0
ALU_PER_ELEMENT = {"gcl": 21.0, "coord": 17.0}
MUFU_LANES, ALU_LANES, PADDED_WIDTH = 16, 128, 448


def elementwise_floor_us(B, N, mode, sms, clock_hz):
    """Least time (us) of the bf16 kernel's elementwise work on this card:
    the larger of its special-function and its other instructions, at 16
    and 128 lanes per SM and clock."""
    elements = float(B) * N * N * PADDED_WIDTH
    mufu = elements * MUFU_PER_ELEMENT / (MUFU_LANES * sms * clock_hz)
    alu = elements * ALU_PER_ELEMENT[mode] / (ALU_LANES * sms * clock_hz)
    return max(mufu, alu) * 1e6


def edge_inputs(torch, B, N, H, dtype, sizes, seed):
    """Edge-pass operands on the card, laid out as the model passes them:
    w_e is the (H, E) column block of the first edge layer (row stride
    2H + E), masks from random graph sizes in ``sizes``."""
    g = torch.Generator().manual_seed(seed)
    E = 2
    n = torch.randint(sizes[0], sizes[1] + 1, (B,), generator=g).clamp(max=N)
    nm = (torch.arange(N)[None] < n[:, None]).float()
    em = nm[:, :, None] * nm[:, None, :] * (1 - torch.eye(N))

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    w0 = r(H, 2 * H + E, scale=H ** -0.5)
    args = dict(u=r(B, N, H), v=r(B, N, H), ef=r(B, N * N, E),
                em=em.reshape(B, N * N, 1).to("cuda", dtype),
                w_e=w0[:, 2 * H:], b0=r(H, scale=0.1),
                w1=r(H, H, scale=H ** -0.5), b1=r(H, scale=0.1),
                wh=r(H, scale=H ** -0.5), bh=r(1))
    return args, nm.cuda()


@contextlib.contextmanager
def plain_edge_pass(gk):
    """Route the model's edge passes to the plain PyTorch version (the
    reference the kernel is held against)."""
    kernel = gk.fused_edge_pass
    gk.fused_edge_pass = gk.fused_edge_pass_reference
    try:
        yield
    finally:
        gk.fused_edge_pass = kernel


def kernel_phase(torch, gk, B, N, sizes, card, H=420):
    """Each mode x type at (B, N, H): held against the plain version, then
    timed beside the plain version, one torch.matmul of the inner GEMM and
    the bound. ``card``: (SMs, SM clock in Hz) for the elementwise floor.
    Returns one record per (mode, type)."""
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        a, nm = edge_inputs(torch, B, N, H, dtype, sizes, seed=B * N)
        for mode in ("gcl", "coord"):
            args = dict(a)
            if mode == "coord":
                args["em"], args["bh"] = None, None
            call = lambda: gk.fused_edge_pass(**args, mode=mode)
            plain = lambda: gk.fused_edge_pass_reference(**args, mode=mode)
            got = call()
            torch.cuda.synchronize()
            ref = plain().float()
            err = (got - ref).abs()
            atol, rtol = TOLERANCE[name, mode]
            excess = (err - atol - rtol * ref.abs()).max().item()
            rec = {"kernel": "edge_mlp", "mode": mode, "dtype": name,
                   "B": B, "N": N, "H": H,
                   "max_abs_err": err.max().item(),
                   "ref_max_abs": ref.abs().max().item(),
                   "ref_mean_abs": ref.abs().mean().item(),
                   "atol": atol, "rtol": rtol}
            if mode == "gcl":
                rec["masked_rows_max_abs"] = (
                    got[nm == 0].abs().max().item() if (nm == 0).any()
                    else 0.0)
            check(torch.isfinite(got).all().item(), f"non-finite {rec}")
            check(excess <= 0.0, f"kernel disagrees with plain: {rec}")
            check(rec.get("masked_rows_max_abs", 0.0) == 0.0,
                  f"masked rows not zero: {rec}")
            x = torch.randn(B * N * N, H, device="cuda", dtype=dtype)
            rec["kernel_ms"] = cuda_ms(torch, call, iters=20)
            rec["plain_ms"] = cuda_ms(torch, plain, iters=5)
            rec["library_ms"] = cuda_ms(torch, lambda: x @ args["w1"].t(),
                                        iters=20)
            bound_ms, bound_by = edge_pass_bound(B, N, H, 2, name, mode)
            rec["bound_us"] = bound_ms * 1e3
            rec["bound_by"] = bound_by
            rec["share_of_bound"] = bound_ms / rec["kernel_ms"]
            if dtype == torch.bfloat16:
                rec["elementwise_floor_us"] = elementwise_floor_us(
                    B, N, mode, *card)
            del x
            log(json.dumps(rec))
            out.append(rec)
    return out


def pack_cache_phase(torch, gk, dtype, B=8, N=32, H=420):
    """The packed W1 is made once per weight: a second launch packs
    nothing; an in-place change of W1 packs again and changes the result."""
    name = str(dtype).replace("torch.", "")
    a, _ = edge_inputs(torch, B, N, H, dtype, (N // 2, N), seed=7)
    gk.reset_pack_count()
    first = gk.fused_edge_pass(**a, mode="gcl")
    packs_first = gk.PACKS
    second = gk.fused_edge_pass(**a, mode="gcl")
    packs_second = gk.PACKS
    a["w1"].mul_(0.5)
    third = gk.fused_edge_pass(**a, mode="gcl")
    ref = gk.fused_edge_pass_reference(**a, mode="gcl").float()
    torch.cuda.synchronize()
    rec = {"packs_first_launch": packs_first,
           "packs_second_launch": packs_second - packs_first,
           "packs_after_inplace_change": gk.PACKS - packs_second,
           "same_result_twice": torch.equal(first, second),
           "change_of_result": (third - first).abs().max().item(),
           "max_abs_err_after_change": (third - ref).abs().max().item()}
    log(f"[kernel] packed W1 cache, {name}: {json.dumps(rec)}")
    check(packs_first == 1 and packs_second == packs_first,
          f"W1 is not packed exactly once: {rec}")
    check(rec["packs_after_inplace_change"] == 1,
          f"an in-place change of W1 did not repack: {rec}")
    check(rec["same_result_twice"], f"two launches disagree: {rec}")
    check(rec["change_of_result"] > 1e-3,
          f"the changed W1 did not change the result: {rec}")
    atol, rtol = TOLERANCE[name, "gcl"]
    check(((third - ref).abs() <= atol + rtol * ref.abs()).all().item(),
          f"after the change the kernel disagrees with plain: {rec}")


# The clock slots of each kernel (the C entries' notes give their bounds).
PHASES = {"bfloat16": ["build_m1", "product_half0", "epilogue_half0",
                       "product_half1", "epilogue_half1", "gate_and_store",
                       "jsum_and_tile_end"],
          "float32": ["tile_rows", "product_half0", "epilogue_half0",
                      "product_half1", "epilogue_half1",
                      "gate_and_jsum_half0", "jsum_half1_and_tile_end"]}


def phase_clocks(torch, gk, B, N, sizes, dtype, H=420):
    """Where a block of the kernel of ``dtype`` spends its clocks: one
    launch per mode through the library's C entry with its optional clock
    buffer (the first thread of each block adds the SM's clocks between
    phases; the package's wrapper always passes none). In the f32 kernel
    the product phases include building m1, which overlaps the products.
    Only with ``--profile``."""
    import ctypes

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    name = str(dtype).replace("torch.", "")
    bf16 = dtype == torch.bfloat16
    lib = ctypes.CDLL(gk.build_kernel()["edge_mlp" if bf16 else "edge_mlp_f32"])
    entry = lib.mlcg_edge_mlp if bf16 else lib.mlcg_edge_mlp_f32
    slots = (lib.mlcg_edge_mlp_prof_slots if bf16
             else lib.mlcg_edge_mlp_f32_prof_slots)
    entry.restype = slots.restype = ci
    entry.argtypes = [ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, ci, vp, vp, vp,
                      vp, vp, cf, vp, vp, vp]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a, _ = edge_inputs(torch, B, N, H, dtype, sizes, seed=B * N)
    w1p = gk.packed_w1(a["w1"])
    ptr = {k: t.data_ptr() for k, t in a.items()}
    for mode in ("gcl", "coord"):
        gcl = mode == "gcl"
        clocks = torch.zeros(sms, slots(), dtype=torch.int64, device="cuda")
        out = torch.empty((B, N, H) if gcl else (B, N * N, 1),
                          dtype=torch.float32, device="cuda")
        rc = entry(
            0 if gcl else 1, B, N, H, 2, ptr["u"], ptr["v"], ptr["ef"],
            ptr["em"] if gcl else None, ptr["w_e"], a["w_e"].stride(0),
            ptr["b0"], w1p.data_ptr(), ptr["b1"], ptr["wh"],
            ptr["bh"] if gcl else None, 100.0, out.data_ptr(),
            clocks.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        check(rc == 0, f"phase-clock launch failed with CUDA error {rc}")
        args = dict(a)
        if not gcl:
            args["em"], args["bh"] = None, None
        check(torch.equal(out, gk.fused_edge_pass(**args, mode=mode)),
              "the clocked launch and the wrapper's disagree")
        per_block = clocks.sum(0).double() / clocks.shape[0]
        total = per_block.sum().item()
        log("[profile] " + json.dumps({
            "phase_clocks": {"B": B, "N": N, "H": H, "mode": mode,
                             "dtype": name},
            "clocks_per_block": {n: int(c) for n, c in
                                 zip(PHASES[name], per_block.tolist())},
            "share": {n: round(c / total, 4) for n, c in
                      zip(PHASES[name], per_block.tolist())}}))


def profile_request(torch, gen, kw, req_s):
    """One more request under ``torch.profiler``: the device's busy share
    and the kernels that take the most device time. Only with
    ``--profile``; the tracing slows the host, so the share is given
    against both the profiled and the unprofiled request time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate_conformers(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    log("[profile] " + json.dumps({
        "device_kernel_s": busy_s, "profiled_request_s": wall,
        "busy_share_profiled": busy_s / wall if busy_s else "not measured",
        "busy_share_unprofiled": busy_s / req_s if busy_s else "not measured",
        "top_kernels": [{"name": e.key[:70], "count": e.count,
                         "device_ms": dev_us(e) / 1e3} for e in top]}))


def timed_request(torch, gk, gen, samples, kw, n_pad, path, name, ref_n):
    """The request through ``gen`` twice: a warm-up, then the timed one with
    the launch and W1-pack counts set to 0 just before it and read just
    after. Checks the counts (one pack per edge MLP in the warm-up, none
    after) and the samples' shapes and atom types; logs samples/s and the
    stage split. ``samples``: the sampler's outputs, as ``recorded``
    collects them. Returns the request's record."""
    from ml_conformer_generator_tpu_torch.chem import native

    blocks = gen.egnn_cfg.n_blocks
    gk.reset_pack_count()
    t0 = time.perf_counter()
    gen.generate_conformers(**kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_packs = gk.PACKS
    gk.reset_launch_counts()
    gk.reset_pack_count()
    t0 = time.perf_counter()
    valid = gen.generate_conformers(**kw)
    torch.cuda.synchronize()
    req_s = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    packs = gk.PACKS
    want = {"gcl": 2 * blocks * (STEPS + 1), "coord": blocks * (STEPS + 1)}
    x, h, nm = samples[-1]
    nonfinite = int((~torch.isfinite(x)).flatten(1).any(1).sum().item())
    check(launches == want,
          f"{name} request launches {launches}, expected {want}")
    check(warm_packs == 3 * blocks and packs == 0,
          f"{name} W1 packs: {warm_packs} in the warm-up request (expected "
          f"one per edge MLP, {3 * blocks}), {packs} in the timed one "
          f"(expected 0)")
    check(tuple(x.shape) == (N_SAMPLES, n_pad, 3)
          and tuple(h.shape) == (N_SAMPLES, n_pad, 8),
          f"sample shapes {tuple(x.shape)} {tuple(h.shape)}")
    check(torch.equal(h.sum(-1), nm[..., 0].to(h.dtype)),
          "h is not one-hot on real nodes and zero on padding")
    check(h[..., 7].max().item() == 0.0, "class 7 (Br) was emitted")
    by_mode = {r["mode"]: r for r in path if r["dtype"] == name}
    edge_s = sum(launches[m] * by_mode[m]["kernel_ms"] for m in launches) / 1e3
    rec = {"dtype": name, "n_samples": N_SAMPLES, "steps": STEPS, "N": n_pad,
           "reference_heavy_atoms": ref_n, "warmup_s": warm_s,
           "request_s": req_s, "samples_per_s": N_SAMPLES / req_s,
           "valid": len(valid), "nonfinite_samples": nonfinite,
           "launches": launches, "w1_packs_warmup": warm_packs,
           "w1_packs": packs, "edge_kernel_s_estimate": edge_s,
           "edge_kernel_share_of_sampling": edge_s
           / gen.last_metrics["edm_sampling_s"],
           "native_chemistry_worker": native.available(),
           "last_metrics": gen.last_metrics}
    log(f"[e2e] {json.dumps(rec)}")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)

    # -- 1. environment ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    max_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0])
    card = (torch.cuda.get_device_properties(0).multi_processor_count,
            max_clock_mhz * 1e6)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; device {kind}; "
        f"count {torch.cuda.device_count()}; nvidia-smi: {smi}")
    log("[env] TF32 off for matmul and cuDNN: the plain versions' f32 "
        "products are full f32")
    log(f"[env] {card[0]} SMs, max SM clock {max_clock_mhz:.0f} MHz (for "
        f"the elementwise floor)")

    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.generator import MLConformerGenerator
    from ml_conformer_generator_tpu_torch.models.egnn import (
        EGNNDynamics, dynamics_forward)
    from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
    from ml_conformer_generator_tpu_torch.utils.masks import (pad_to_bucket,
                                                              prepare_masks)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = gk.build_kernel(verbose=True)
    log(f"[build] nvcc sm_90a {', '.join(KERNEL_SOURCES.values())} (side by "
        f"side): {time.perf_counter() - t0:.1f} s")
    for name, src in KERNEL_SOURCES.items():
        build_log = gk.BUILD_INFO["logs"][name].splitlines()
        regs = [int(line.split("Used ")[1].split()[0]) for line in build_log
                if "Used " in line and "registers" in line]
        spills = [line.strip() for line in build_log if "spill" in line
                  and not line.strip().startswith("0 bytes")]
        # ptxas C7511: wgmma serialized for want of registers.
        serialized = sum("C7511" in line
                         or "instructions are serialized" in line
                         for line in build_log)
        log(f"[build] {src}: {len(regs)} instantiations, registers "
            f"{min(regs)}..{max(regs)}, spilling: {spills or 'none'}, "
            f"wgmma serialized (ptxas C7511): {serialized or 'no'}; "
            f"SASS: {sass_mma(gk, paths[name])}")
        if "--profile" in sys.argv[1:]:
            # ptxas's report of the kernel's instantiations, as it gave it.
            for i, line in enumerate(build_log):
                if "instructions are serialized" in line:
                    log("[build] " + line.strip())
                if "Compiling entry function" in line:
                    log("[build] " + " | ".join(
                        l.replace("ptxas info    :", "").strip()
                        for l in build_log[i:i + 4]))

    # -- 3. kernel -----------------------------------------------------------
    ref_n = len(_REFERENCE)
    max_n = min(ref_n + VARIANCE, 39)
    n_pad = pad_to_bucket(max_n, 8)
    log(f"[kernel] production shape B=128 N=40, request shape "
        f"B={N_SAMPLES} N={n_pad}")
    kernel_phase(torch, gk, 128, 40, (15, 39), card)
    log("[kernel] more than 48 nodes (B=16 N=64), and graphs that do not "
        "fill their last tile (B=5 N=40: 3 target nodes a tile)")
    kernel_phase(torch, gk, 16, 64, (40, 64), card)
    kernel_phase(torch, gk, 5, 40, (15, 39), card)
    log("[kernel] the most nodes a tile holds (B=8 N=128)")
    kernel_phase(torch, gk, 8, 128, (100, 128), card)
    path = kernel_phase(torch, gk, N_SAMPLES, n_pad,
                        (ref_n - VARIANCE, max_n), card)
    for dtype in (torch.bfloat16, torch.float32):
        pack_cache_phase(torch, gk, dtype)

    # -- 4. model: full-width bf16 forward, kernel against plain ---------------
    cfg = EGNNConfig(compute_dtype="bfloat16")
    dyn = EGNNDynamics(cfg, torch.Generator().manual_seed(1))
    dyn = dyn.to("cuda", torch.bfloat16).eval()
    g = torch.Generator().manual_seed(2)
    B, N = 128, 40
    node_mask, edge_mask = prepare_masks(
        torch.randint(15, 40, (B,), generator=g), N)
    node_mask, edge_mask = node_mask.cuda(), edge_mask.cuda()
    xh = torch.randn(B, N, 11, generator=g).cuda() * node_mask
    ctx = torch.randn(B, N, 3, generator=g).cuda() * node_mask
    t = torch.full((B,), 0.5, device="cuda")
    with torch.no_grad():
        gk.reset_launch_counts()
        out_k = dynamics_forward(dyn, t, xh, node_mask, edge_mask, ctx)
        torch.cuda.synchronize()
        launches = dict(gk.LAUNCHES)
        with plain_edge_pass(gk):
            out_p = dynamics_forward(dyn, t, xh, node_mask, edge_mask, ctx)
        fwd_k = cuda_ms(torch, lambda: dynamics_forward(
            dyn, t, xh, node_mask, edge_mask, ctx), iters=3, warmup=1)
        with plain_edge_pass(gk):
            fwd_p = cuda_ms(torch, lambda: dynamics_forward(
                dyn, t, xh, node_mask, edge_mask, ctx), iters=3, warmup=1)
    err = (out_k - out_p).abs()
    model = {"B": B, "N": N, "width": cfg.hidden_nf, "blocks": cfg.n_blocks,
             "dtype": "bfloat16", "launches": launches,
             "max_abs_err": err.max().item(),
             "ref_max_abs": out_p.abs().max().item(),
             "forward_ms_kernel": fwd_k, "forward_ms_plain": fwd_p}
    log(f"[model] {json.dumps(model)}")
    check(launches == {"gcl": 2 * cfg.n_blocks, "coord": cfg.n_blocks},
          f"forward launches {launches}")
    check(torch.isfinite(out_k).all().item(), "non-finite forward")
    check((err <= 5e-2 + 5e-2 * out_p.abs()).all().item(),
          "full-width forward: kernel disagrees with plain beyond 5e-2")

    # -- 5. end to end ---------------------------------------------------------
    reference = Molecule([z for z, *_ in _REFERENCE],
                         [xyz for _, *xyz in _REFERENCE], [])
    ref_context = [105.0766, 473.1938, 537.4675]

    def recorded(gen):
        samples = []
        generate = gen.sampler.generate

        def wrapped(*args, **kwargs):
            x, h = generate(*args, **kwargs)
            samples.append((x, h, args[2]))       # args[2]: the node mask
            return x, h

        gen.sampler.generate = wrapped
        return samples

    # 5a. a short f32 generation, kernel against plain, same seed
    small = MLConformerGenerator(diffusion_steps=4, seed=3,
                                 compute_dtype="float32")
    small_samples = recorded(small)
    for plain in (False, True):
        small._generator.manual_seed(5)
        with plain_edge_pass(gk) if plain else contextlib.nullcontext():
            small.edm_samples(ref_context, n_samples=8, min_n_nodes=23,
                              max_n_nodes=27)
    (xk, hk, _), (xp, hp, _) = small_samples
    small_err = (xk - xp).abs().max().item()
    log(f"[e2e] f32 T=4 B=8 generation, kernel vs plain: max |dx| "
        f"{small_err:.3e} (|x| max {xp.abs().max().item():.3e}), "
        f"h equal: {torch.equal(hk, hp)}")
    check(torch.isfinite(xk).all().item(), "non-finite small generation")
    check(torch.allclose(xk, xp, rtol=1e-3, atol=1e-3),
          "f32 generation through the kernel disagrees with the plain one")
    check(torch.equal(hk, hp), "atom types differ between kernel and plain")
    del small

    # 5a'. larger molecules: max_n_nodes=60 pads the node axis to 64, which
    # the bf16 kernel takes (it takes up to 128 nodes)
    big = MLConformerGenerator(diffusion_steps=2, seed=4, max_n_nodes=60)
    big_samples = recorded(big)
    gk.reset_launch_counts()
    big.edm_samples(ref_context, n_samples=4, min_n_nodes=50, max_n_nodes=60)
    torch.cuda.synchronize()
    xb = big_samples[-1][0]
    log(f"[e2e] bf16 T=2 B=4 generation with up to 60 atoms: x "
        f"{tuple(xb.shape)}, launches {dict(gk.LAUNCHES)}")
    check(tuple(xb.shape) == (4, 64, 3) and torch.isfinite(xb).all().item(),
          "generation with max_n_nodes=60 failed")
    check(gk.LAUNCHES == {"gcl": 18 * 3, "coord": 9 * 3},
          f"launches with max_n_nodes=60: {gk.LAUNCHES}")
    del big

    # 5b. the request, at full width in bf16 (the default), then in float32
    kw = dict(reference_conformer=reference, n_samples=N_SAMPLES,
              variance=VARIANCE, optimise_geometry=True)
    requests = {}
    for name in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        gen = MLConformerGenerator(diffusion_steps=STEPS, seed=0,
                                   compute_dtype=name)
        log(f"[e2e] MLConformerGenerator(compute_dtype={name!r}) on "
            f"{gen.device} in {time.perf_counter() - t0:.1f} s (420 x 9 "
            f"EGNN; AdjMatSeer 2048; random weights, seed 0)")
        check(gen.device.type == "cuda", "the generator is not on the card")
        requests[name] = timed_request(torch, gk, gen, recorded(gen), kw,
                                       n_pad, path, name, ref_n)
        if name == "bfloat16":
            bf16_gen = gen
        del gen
    log("[e2e] random weights: 0 valid molecules and diverging coordinates "
        "are expected and are not a failure")
    if "--profile" in sys.argv[1:]:
        for dtype in (torch.bfloat16, torch.float32):
            phase_clocks(torch, gk, N_SAMPLES, n_pad,
                         (ref_n - VARIANCE, max_n), dtype)
            phase_clocks(torch, gk, 128, 40, (15, 39), dtype)
        profile_request(torch, bf16_gen, kw,
                        requests["bfloat16"]["request_s"])

    # One entry per kernel and mode, at the request's shape; launches are
    # those of the request in the kernel's type.
    kernels = []
    for name, source, prefix in (("bfloat16", KERNEL_SOURCE, "edge_mlp"),
                                 ("float32", F32_SOURCE, "edge_mlp_f32")):
        by_mode = {r["mode"]: r for r in path if r["dtype"] == name}
        for mode in ("gcl", "coord"):
            r = by_mode[mode]
            bound_ms, bound_by = edge_pass_bound(r["B"], r["N"], r["H"], 2,
                                                 name, mode)
            kernels.append({
                "name": f"{prefix}_{mode}", "route": "cuda",
                "source": source, "replaces": TPU_KERNEL,
                "launches": requests[name]["launches"][mode],
                "max_abs_err": r["max_abs_err"],
                "ref_mean_abs": r["ref_mean_abs"],
                "atol": r["atol"], "rtol": r["rtol"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": r["library_ms"],
                "dtype": name, "shape": [r["B"], r["N"], r["H"]]})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
