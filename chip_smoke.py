#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``ml_conformer_generator_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus the kernels' phase clocks and
                                      # one request under torch.profiler
    python3 chip_smoke.py --compare-train DIR   # only the backward call and
        # the train step of the checkout in DIR and of this one, in turns

It builds the port's CUDA kernels from ``ml_conformer_generator_tpu_torch/
csrc/`` (``edge_mlp.cu`` for bfloat16, ``edge_mlp_f32.cu`` for float32,
``edge_mlp_bwd_f32.cu`` for the float32 backward, one ``nvcc`` each, side
by side) and drives the port's main path, the
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
   launch counts and no W1 packed in the timed one; (5c) short f32
   fragment-conditioned generations, inpainting and inertial fragment
   matching (IFM), kernel against plain; (5d) the full-width bf16 request
   with a fixed fragment (the reference's phenyl ring and methoxy group),
   once inpainting and once IFM, each warm-up and timed, with exact launch
   counts;
6. evaluation: ``evaluate_samples`` of 64 rotated, jittered and trimmed
   copies of the reference on the card against the same call on the CPU,
   with the card's and the CPU's times of the grid Tanimoto and the
   ChemNet encoder's time for 256 molecules;
7. ONNX weights: the bf16 generator's float32 weights written as ONNX
   protobufs (the script's own writer, with a non-parameter initializer as
   exported graphs carry), ``MLConformerGeneratorONNX`` built from them on
   the card with the same seed, its request's sampler outputs equal to the
   source generator's bit for bit, 27 launches a forward;
8. ``save_weights`` round trip: the float32 weights saved as ``.npz``,
   loaded into a new generator on the card, weights and one request's
   sampler outputs equal;
9. the HTTP app: ``ConformerServer`` on the card behind a
   ``ThreadingHTTPServer`` on 127.0.0.1, ``GET /api/health`` names the card,
   ``POST /api/generate`` with the reference as a mol block (64 samples,
   twice: the first builds the server's generator), status 200, JAX's
   response keys, exact launches;
10. shape from an STL mesh: a box written as a binary STL, its principal
    moments against the closed form, one request from that context;
11. gradient guard: a bf16 denoiser forward on the card under grad, with
    parameters that require grad, raises naming ROADMAP M13b (the bf16
    kernel has no backward), and a float32 one runs through the autograd
    Function, its backward through the backward kernel;
12. force field: ``standardize_batch(..., optimize_geometry_flag=True)`` of
    phase 6's copies on the card (twice) against the CPU: the same entries
    invalid, the relaxed coordinates within ``FF_BAR``, each sample's FIRE
    branch history compared; the same relaxation in float64 within
    ``FF64_BAR``; then copies of ``_RING``, each well-conditioned one held
    to both bars and each ill-conditioned one reported;
13. training (EGNN 420 x 9, float32, B = 64, N = 39): the float32 backward
    kernel (``edge_mlp_bwd_f32.cu``) in both modes against the plain
    backward at (64, 39), (5, 40) and (8, 128), a second call bit-equal to
    the first, with kernel, plain and library (the call's three products)
    times beside the bound; the split of one (64, 39) call by device kernel
    under ``torch.profiler`` (with ``--profile`` also the kernel's phase
    clocks); a corpus of 136 molecules made on the
    card by ``perturb_and_relax`` from the reference; one ``make_train_step``
    step through the kernels against the same step through the plain
    version (same weights, same draws: losses within 1e-5, every
    parameter's gradient within 1e-4 relative norm), with exact launches
    (36 / 18 forward, 18 / 9 backward: remat runs each forward twice) and
    27 W1 packs a step; 30 steps on a fixed objective (the loss drops by
    20%), the step's time with and without remat and its split; ``train``
    for one epoch with EMA and cosine LR, its checkpoint loaded into a
    generator that serves one request (27 launches a forward, no backward);
    ``train_adj_mat_seer`` on the card (its loss drops).

Files it writes (ONNX, ``.npz``, STL) go to ``build/chip_smoke/``.

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
BWD_SOURCE = f"{PACKAGE}/csrc/edge_mlp_bwd_f32.cu"  # float32 backward
KERNEL_SOURCES = {"edge_mlp": KERNEL_SOURCE, "edge_mlp_f32": F32_SOURCE,
                  "edge_mlp_bwd_f32": BWD_SOURCE}
TPU_KERNEL = "ml_conformer_generator_tpu/ops/gcl_kernel.py:160"
BWD_REPLACES = ("none: JAX computes this backward in XLA (use_pallas off, "
                "no custom_vjp)")

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
# Relaxed coordinates, card against CPU (Angstrom, max over atoms). float32,
# as the pipeline runs, on phase 6's copies: set from the well-conditioned
# reference copy (a few 1e-6 A), with room for copies whose FIRE branch
# flips in the last steps (up to ~1e-4 A). Some copies of ``_RING`` are
# ill-conditioned: their relaxation amplifies round-off on any device, so
# they are reported, not held to a bar (PERF.md has the measurements).
FF_BAR, FF64_BAR = 1e-3, 1e-6
# A molecule whose float32 relaxation on the CPU ends within this distance
# (Angstrom) of its float64 relaxation is well-conditioned.
WELL_CONDITIONED = 1e-4
# Benzamide-like ring with a methoxy group, far from the force field's
# equilibrium (heavy atoms, Angstrom). Its unjittered copies start exactly
# planar, on a saddle of the out-of-plane terms, so round-off decides which
# way they relax: they are ill-conditioned.
_RING = ([6, 6, 6, 6, 6, 6, 6, 8, 7, 8, 6],
         [(1.390, 0.000, 0.000), (0.695, 1.204, 0.000),
          (-0.695, 1.204, 0.000), (-1.390, 0.000, 0.000),
          (-0.695, -1.204, 0.000), (0.695, -1.204, 0.000),
          (2.880, 0.000, 0.000), (3.500, 1.060, 0.000),
          (3.560, -1.160, 0.000), (-1.375, 2.382, 0.000),
          (-2.805, 2.382, 0.000)])
# Box of the STL phase, (a, b, c) in Angstrom, and the factor that scales its
# principal moments (density 1) into the model's context range.
STL_BOX, STL_SCALE = (4.0, 6.0, 12.0), 0.1

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


def edge_pass_bound(B, N, H, E, dtype_name, mode, backward=False):
    """Least time (ms) of one edge pass on an H100, and what bounds it.

    Operations: the per-edge products of the kernel (edge scalars through
    W_e, m1 through W1, m2 through the head), 2 B N^2 H (H + E + 1), at the
    rate of the kind of product the kernel does. bf16: the bf16 tensor
    cores. float32: f32-accurate products taken as 3xTF32, three TF32
    tensor-core products for each, so a third of the TF32 rate (165
    TFLOP/s). Counted at the f32 FMA rate (67 TFLOP/s) instead, the bound
    would sit below what the kernel reaches, and its share would read over
    100%. Bytes: each input read once, the float32 output written once.

    ``backward``: the float32 backward call (``fused_edge_pass_backward``:
    the kernel and its wrapper's dW1 product). Operations: its three
    products of the edge chain, the recompute s0 W1^T, dpre1 W1 and dW1 =
    dpre1^T s0, 3 x 2 B N^2 H^2, at the 3xTF32 rate; bytes: the call's
    inputs (u, v, the edge scalars, the weights, the upstream gradient and
    in gcl the edge mask) read once and its outputs (du, dv, de and the
    weight gradients) written once; the s0 and dpre1 it passes from the
    kernel to the product are intermediates and not counted."""
    if backward:
        edges = B * N * N
        ops = 3 * 2.0 * edges * H * H
        n_in = (2 * B * N * H + edges * E + H * E + H * H + 3 * H
                + (edges + 1 + B * N * H if mode == "gcl" else edges))
        n_out = (2 * B * N * H + edges * E + H * E + H * H + 3 * H
                 + (1 if mode == "gcl" else 0))
        t_ops = ops / PEAK_OPS["float32"]
        t_bytes = (n_in + n_out) * 4 / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                           else "bytes")
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


def timed_request(torch, gk, gen, samples, kw, n_pad, path, name, ref_n,
                  request="plain", forwards=STEPS + 1, warm_packs_want=None):
    """The request through ``gen`` twice: a warm-up, then the timed one with
    the launch and W1-pack counts set to 0 just before it and read just
    after. Checks the counts (``forwards`` denoiser calls, 27 launches
    each; one pack per edge MLP in the warm-up of a new generator, or
    ``warm_packs_want``; none after) and the samples' shapes and atom types;
    logs samples/s and the stage split. ``samples``: the sampler's outputs,
    as ``recorded`` collects them; ``path``: the kernel records at the
    request shape, for the edge-kernel estimate (None: every forward at
    that shape is not given, no estimate). Returns the request's record."""
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
    want = forward_launches(forwards, blocks)
    if warm_packs_want is None:
        warm_packs_want = 3 * blocks
    x, h, nm = samples[-1]
    nonfinite = int((~torch.isfinite(x)).flatten(1).any(1).sum().item())
    check(launches == want,
          f"{name} {request} request launches {launches}, expected {want}")
    check(warm_packs == warm_packs_want and packs == 0,
          f"{name} {request} W1 packs: {warm_packs} in the warm-up request "
          f"(expected {warm_packs_want}), {packs} in the timed one "
          f"(expected 0)")
    check(tuple(x.shape) == (N_SAMPLES, n_pad, 3)
          and tuple(h.shape) == (N_SAMPLES, n_pad, 8),
          f"sample shapes {tuple(x.shape)} {tuple(h.shape)}")
    check(torch.equal(h.sum(-1), nm[..., 0].to(h.dtype)),
          "h is not one-hot on real nodes and zero on padding")
    check(h[..., 7].max().item() == 0.0, "class 7 (Br) was emitted")
    rec = {"request": request, "dtype": name, "n_samples": N_SAMPLES,
           "steps": STEPS, "N": n_pad, "reference_heavy_atoms": ref_n,
           "forwards": forwards, "warmup_s": warm_s,
           "request_s": req_s, "samples_per_s": N_SAMPLES / req_s,
           "valid": len(valid), "nonfinite_samples": nonfinite,
           "launches": launches, "w1_packs_warmup": warm_packs,
           "w1_packs": packs,
           "native_chemistry_worker": native.available(),
           "last_metrics": gen.last_metrics}
    if path is not None:
        by_mode = {r["mode"]: r for r in path if r["dtype"] == name}
        edge_s = sum(launches[m] * by_mode[m]["kernel_ms"]
                     for m in ("gcl", "coord")) / 1e3
        rec["edge_kernel_s_estimate"] = edge_s
        rec["edge_kernel_share_of_sampling"] = (
            edge_s / gen.last_metrics["edm_sampling_s"])
    log(f"[e2e] {json.dumps(rec)}")
    return rec


def reference_copies(reference, n=64):
    """The reference with bonds from distances, and ``n`` copies of it,
    each randomly rotated, given a seeded 0.05-0.3 A jitter and with up to
    three atoms dropped; the first copy only rotated."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem.perception import \
        determine_connectivity

    rng = np.random.default_rng(11)
    ref = determine_connectivity(reference)
    z, xyz = ref.atomic_nums, ref.coords
    samples = []
    for k in range(n):
        q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        keep = (np.arange(len(z)) if k == 0 else
                np.sort(rng.permutation(len(z))[: len(z) - k % 4]))
        jitter = 0.0 if k == 0 else rng.uniform(0.05, 0.3)
        c = xyz[keep] @ q.T + rng.standard_normal((len(keep), 3)) * jitter
        samples.append(determine_connectivity(
            type(ref)(z[keep], c, [])))
    return ref, samples


def eval_phase(torch, reference, n=64, n_grid=40):
    """``evaluate_samples`` on the card against the CPU, on
    :func:`reference_copies`: scores within 1e-4, equal mol blocks wherever
    the best flip is equal, the unjittered copy above 0.99. Logs the grid
    Tanimoto's time on the card and on the CPU at (n, n_grid) and the
    ChemNet encoder's for 4 n molecules."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.eval import (chemnet_embeddings,
                                                       evaluate_samples,
                                                       shape_quadrupole,
                                                       tanimoto_batch)

    ref, samples = reference_copies(reference, n)

    def timed(fn, device):
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    evaluate_samples(ref, samples[:2], device="cuda")          # warm-up
    (ref_card, res_card), s_card = timed(
        lambda: evaluate_samples(ref, samples, n_grid=n_grid,
                                 device="cuda"), "cuda")
    (ref_cpu, res_cpu), s_cpu = timed(
        lambda: evaluate_samples(ref, samples, n_grid=n_grid, device="cpu"),
        "cpu")

    # the grid Tanimoto alone, on the inputs evaluate_samples gives it
    rc = ref.coords - ref.coords.mean(axis=0)
    ref_frame = np.asarray(shape_quadrupole(rc)[1], np.float32)
    frames = [shape_quadrupole(m.coords - m.coords.mean(axis=0))[1]
              for m in samples]
    cand = np.zeros((n, max(len(f) for f in frames), 3), np.float32)
    mask = np.zeros(cand.shape[:2], np.float32)
    for k, f in enumerate(frames):
        cand[k, : len(f)], mask[k, : len(f)] = f, 1.0
    ones = np.ones(len(ref_frame), np.float32)
    tanimoto_batch(ref_frame, ones, cand, mask, n_grid=n_grid, device="cuda")
    tb_card, tb_card_s = timed(lambda: tanimoto_batch(
        ref_frame, ones, cand, mask, n_grid=n_grid, device="cuda"), "cuda")
    tb_cpu, tb_cpu_s = timed(lambda: tanimoto_batch(
        ref_frame, ones, cand, mask, n_grid=n_grid, device="cpu"), "cpu")
    flips_equal = (tb_card.argmax(1).cpu() == tb_cpu.argmax(1)).numpy()

    mols = samples * 4
    chemnet_embeddings(mols[:8], device="cuda")                 # warm-up
    emb_card, emb_card_s = timed(lambda: chemnet_embeddings(
        mols, device="cuda"), "cuda")
    emb_cpu, emb_cpu_s = timed(lambda: chemnet_embeddings(
        mols, device="cpu"), "cpu")

    d_score = max(abs(g["shape_tanimoto"] - c["shape_tanimoto"])
                  for g, c in zip(res_card, res_cpu))
    blocks_differ = [k for k in range(n) if flips_equal[k]
                     and res_card[k]["mol_block"] != res_cpu[k]["mol_block"]]
    rec = {"samples": n, "n_grid": n_grid,
           "reference_heavy_atoms": ref.num_atoms,
           "evaluate_samples_s": {"cuda": s_card, "cpu": s_cpu},
           "tanimoto_batch_s": {"cuda": tb_card_s, "cpu": tb_cpu_s},
           "tanimoto_batch_max_abs_diff": (tb_card.cpu() - tb_cpu)
           .abs().max().item(),
           "best_flip_equal": int(flips_equal.sum()),
           "shape_tanimoto_max_abs_diff": d_score,
           "self_copy_shape_tanimoto": res_card[0]["shape_tanimoto"],
           "mean_shape_tanimoto": float(np.mean(
               [r["shape_tanimoto"] for r in res_card])),
           "chemnet_molecules": len(mols),
           "chemnet_embeddings_s": {"cuda": emb_card_s, "cpu": emb_cpu_s},
           "chemnet_max_rel_diff": float(np.abs(emb_card - emb_cpu).max()
                                         / np.abs(emb_cpu).max())}
    log(f"[eval] {json.dumps(rec)}")
    check(ref_card == ref_cpu, "reference mol blocks differ")
    check(len(res_card) == len(res_cpu) == n, "result counts differ")
    check(d_score <= 1e-4, f"card and CPU shape scores differ by {d_score}")
    check(rec["tanimoto_batch_max_abs_diff"] <= 1e-4,
          "card and CPU tanimoto_batch differ beyond 1e-4")
    check(not blocks_differ, f"mol blocks differ at equal flips: "
          f"{blocks_differ}")
    check(all(g["chemical_tanimoto"] == c["chemical_tanimoto"]
              for g, c in zip(res_card, res_cpu)), "chemical scores differ")
    check(rec["self_copy_shape_tanimoto"] > 0.99,
          "the unjittered copy scores 0.99 or less")
    check(rec["chemnet_max_rel_diff"] <= 1e-4,
          "card and CPU ChemNet embeddings differ beyond 1e-4")


def recorded(gen, method="generate"):
    """Collect (x, h, node mask) of each call of the sampler's ``method``
    (generate, inpaint or merge_fragments)."""
    samples = []
    run = getattr(gen.sampler, method)

    def wrapped(*args, **kwargs):
        x, h = run(*args, **kwargs)
        samples.append((x, h, args[2]))       # args[2]: the node mask
        return x, h

    setattr(gen.sampler, method, wrapped)
    return samples


def launch_counts(gcl=0, coord=0, gcl_bwd=0, coord_bwd=0):
    """A whole ``gk.LAUNCHES`` dict: forward and backward launches by mode."""
    return {"gcl": gcl, "coord": coord, "gcl_bwd": gcl_bwd,
            "coord_bwd": coord_bwd}


def forward_launches(forwards, blocks=9):
    """Edge-kernel launches of ``forwards`` denoiser calls: 2 GCL passes and
    1 coordinate pass a block, no backward."""
    return launch_counts(2 * blocks * forwards, blocks * forwards)


def launches_of(torch, gk, fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after (the card synchronised). Returns (result, launches, seconds)."""
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(gk.LAUNCHES), time.perf_counter() - t0


def seeded_request(torch, gk, gen, kw, seed=12):
    """One request through ``gen`` from the noise seed ``seed``: its sampler
    outputs (x, h), launches and seconds."""
    samples = recorded(gen)
    gen._generator.manual_seed(seed)
    _, launches, secs = launches_of(torch, gk,
                                    lambda: gen.generate_conformers(**kw))
    x, h, _ = samples[-1]
    return (x, h), launches, secs


def same_weights(torch, a, b):
    """Both generators hold equal float32 trees and equal modules."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.checkpoint import _flatten

    fa, fb = _flatten(a.edm_params), _flatten(b.edm_params)
    return (sorted(fa) == sorted(fb)
            and all(fa[k].dtype == fb[k].dtype
                    and np.array_equal(fa[k], fb[k]) for k in fa)
            and all(torch.equal(x, y) for x, y in zip(
                a.sampler.dynamics.state_dict().values(),
                b.sampler.dynamics.state_dict().values()))
            and all(torch.equal(x, y) for x, y in zip(
                a.adj_model.state_dict().values(),
                b.adj_model.state_dict().values())))


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _len_field(num, payload):
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def onnx_bytes(tensors):
    """A minimal ONNX ModelProto that holds ``tensors`` (name -> array) as
    float32 graph initializers with raw data: the part of ONNX that carries
    weights (ModelProto.graph 7, GraphProto.initializer 5; TensorProto dims
    1, data_type 2, name 8, raw_data 9)."""
    import numpy as np

    graph = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        msg = b"".join(_varint(1 << 3) + _varint(d) for d in arr.shape)
        msg += _varint(2 << 3) + _varint(1)
        msg += _len_field(8, name.encode()) + _len_field(9, arr.tobytes())
        graph.append(_len_field(5, msg))
    return _len_field(7, b"".join(graph))


def onnx_phase(torch, gk, src, kw, workdir):
    """The bf16 generator ``src``'s float32 weights as ONNX files (the
    denoiser under the reference export's ``dynamics.egnn.`` names, beside a
    non-parameter initializer, the gamma table), loaded by
    ``MLConformerGeneratorONNX`` on the card with the same seed: the same
    weights, and one request's sampler outputs equal to ``src``'s bit for
    bit, with 27 launches a forward."""
    from ml_conformer_generator_tpu_torch.checkpoint import (
        adj_mat_seer_params_to_torch_names, egnn_params_to_torch_names,
        to_jax_params)
    from ml_conformer_generator_tpu_torch.generator import \
        MLConformerGeneratorONNX

    egnn = egnn_params_to_torch_names(src.edm_params, src.egnn_cfg,
                                      prefix="dynamics.egnn.")
    egnn["gamma.gamma"] = src.gamma.numpy()
    paths = (os.path.join(workdir, "egnn.onnx"),
             os.path.join(workdir, "adj_mat_seer.onnx"))
    t0 = time.perf_counter()
    for path, tensors in zip(paths, (egnn, adj_mat_seer_params_to_torch_names(
            to_jax_params(src.adj_model)))):
        with open(path, "wb") as f:
            f.write(onnx_bytes(tensors))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = MLConformerGeneratorONNX(diffusion_steps=src.diffusion_steps,
                                   seed=0, egnn_onnx=paths[0],
                                   adj_mat_seer_onnx=paths[1], device="cuda")
    load_s = time.perf_counter() - t0
    weights_equal = same_weights(torch, gen, src)
    seeded_request(torch, gk, gen, kw, seed=13)             # warm-up
    (x, h), launches, req_s = seeded_request(torch, gk, gen, kw)
    (xs, hs), _, _ = seeded_request(torch, gk, src, kw)
    rec = {"phase": "onnx", "onnx_bytes": [os.path.getsize(p) for p in paths],
           "write_s": write_s, "load_s": load_s, "device": str(gen.device),
           "weights_equal": weights_equal, "launches": launches,
           "request_s": req_s, "samples_per_s": kw["n_samples"] / req_s,
           "x_equal": torch.equal(x, xs), "h_equal": torch.equal(h, hs),
           "max_abs_dx": (x - xs).abs().max().item()}
    log(f"[onnx] {json.dumps(rec)}")
    check(gen.device.type == "cuda", "the ONNX generator is not on the card")
    check(weights_equal, "ONNX-loaded weights differ from the source's")
    check(launches == forward_launches(STEPS + 1),
          f"ONNX request launches {launches}")
    check(rec["x_equal"] and rec["h_equal"],
          "the ONNX generator's sampler outputs differ from the source's")
    del gen


def roundtrip_phase(torch, gk, src, kw, workdir):
    """``save_weights`` of ``src`` and a new generator on the card loaded
    from the files: equal weights and equal sampler outputs."""
    from ml_conformer_generator_tpu_torch.generator import \
        MLConformerGenerator

    paths = (os.path.join(workdir, "edm.npz"),
             os.path.join(workdir, "adj_mat_seer.npz"))
    t0 = time.perf_counter()
    src.save_weights(*paths)
    save_s = time.perf_counter() - t0
    gen = MLConformerGenerator(diffusion_steps=src.diffusion_steps, seed=0,
                               edm_weights=paths[0],
                               adj_mat_seer_weights=paths[1], device="cuda")
    weights_equal = same_weights(torch, gen, src)
    (x, h), launches, req_s = seeded_request(torch, gk, gen, kw)
    (xs, hs), _, _ = seeded_request(torch, gk, src, kw)
    rec = {"phase": "save_weights", "save_s": save_s,
           "npz_bytes": [os.path.getsize(p) for p in paths],
           "weights_equal": weights_equal, "launches": launches,
           "request_s": req_s, "x_equal": torch.equal(x, xs),
           "h_equal": torch.equal(h, hs)}
    log(f"[save_weights] {json.dumps(rec)}")
    check(weights_equal, "weights differ after the save_weights round trip")
    check(launches == forward_launches(STEPS + 1),
          f"round-trip request launches {launches}")
    check(rec["x_equal"] and rec["h_equal"],
          "sampler outputs differ after the save_weights round trip")
    del gen


# The keys of the JAX app's /api/generate response and of its metrics.
APP_KEYS = {"reference_mol_block", "samples", "sdf", "metrics"}
APP_METRICS = {"requested", "valid", "validity", "generation_s",
               "evaluation_s"}


def app_phase(torch, gk, reference, kind):
    """``ConformerServer`` on the card behind a ``ThreadingHTTPServer`` on
    127.0.0.1 (port 0): health names the card; two 64-sample generate
    requests with the reference as a mol block (the first builds the
    server's generator), each status 200 with JAX's keys and 27 launches a
    forward."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from ml_conformer_generator_tpu_torch.app.server import (ConformerServer,
                                                             _make_handler)
    from ml_conformer_generator_tpu_torch.chem.io import to_mol_block
    from ml_conformer_generator_tpu_torch.chem.perception import \
        determine_connectivity

    server = ConformerServer(default_steps=STEPS, seed=0, device="cuda")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = json.dumps({"mol_block": to_mol_block(determine_connectivity(
        reference)), "n_samples": N_SAMPLES, "diffusion_steps": STEPS,
        "variance": VARIANCE}).encode()

    def call(path, data=None):
        req = urllib.request.Request(base + path, data=data,
                                     method="POST" if data else "GET")
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise AssertionError(f"{path}: HTTP {e.code}: {e.read()!r}")

    try:
        _, health = call("/api/health")
        posts = [launches_of(torch, gk, lambda: call("/api/generate", body))
                 for _ in range(2)]
        _, health_after = call("/api/health")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    recs = []
    for (status, out), launches, secs in posts:
        recs.append({"status": status, "keys": sorted(out),
                     "metrics": out["metrics"], "launches": launches,
                     "wall_s": secs})
    rec = {"phase": "app", "health": health, "health_after": health_after,
           "requests": recs, "server_thread_stopped": not thread.is_alive()}
    log(f"[app] {json.dumps(rec)}")
    check(health["device"] == kind and health["platform"] == "cuda",
          f"health does not name the card: {health}")
    check(health_after["step_counts"] == [STEPS],
          f"health after the requests: {health_after}")
    for r, ((_, out), _, _) in zip(recs, posts):
        check(r["status"] == 200, f"generate status {r['status']}")
        check(set(out) == APP_KEYS and set(out["metrics"]) == APP_METRICS,
              f"response keys {r['keys']} / {sorted(out['metrics'])}")
        check(out["metrics"]["requested"] == N_SAMPLES,
              f"requested {out['metrics']['requested']}")
        check(r["launches"] == forward_launches(STEPS + 1),
              f"app request launches {r['launches']}")
    check(rec["server_thread_stopped"], "the HTTP server thread still runs")


def box_triangles(a, b, c):
    """12 outward-oriented triangles of the box [0, a] x [0, b] x [0, c]."""
    import numpy as np

    v = np.array([[x, y, z] for x in (0.0, a) for y in (0.0, b)
                  for z in (0.0, c)])
    centre = v.mean(axis=0)
    tris = []
    for q in ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
              (0, 2, 6, 4), (1, 5, 7, 3)):
        tris += [[v[q[0]], v[q[1]], v[q[2]]], [v[q[0]], v[q[2]], v[q[3]]]]
    t = np.asarray(tris)
    inward = np.einsum("ij,ij->i", t[:, 0] - centre,
                       np.cross(t[:, 1] - centre, t[:, 2] - centre)) < 0
    t[inward] = t[inward][:, [0, 2, 1]]
    return t


def stl_phase(torch, gk, gen, workdir, n_atoms=25):
    """A box of ``STL_BOX`` written as a binary STL: its principal moments
    (``principal_inertia_components`` of the file, density 1) against the
    closed form V (b^2 + c^2) / 12, ...; then one 64-sample request on the
    card from those moments times ``STL_SCALE`` and ``n_atoms``."""
    import struct

    import numpy as np

    from ml_conformer_generator_tpu_torch import principal_inertia_components
    from ml_conformer_generator_tpu_torch.utils.masks import pad_to_bucket

    a, b, c = STL_BOX
    tris = box_triangles(a, b, c)
    path = os.path.join(workdir, "box.stl")
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<12fH", 0, 0, 0, *t.ravel(), 0))
    got = principal_inertia_components(path)
    vol = a * b * c
    want = np.sort([vol * (b * b + c * c) / 12, vol * (a * a + c * c) / 12,
                    vol * (a * a + b * b) / 12])
    context = got * STL_SCALE
    samples = recorded(gen)
    _, launches, req_s = launches_of(torch, gk, lambda: gen.generate_conformers(
        reference_context=context, n_atoms=n_atoms, n_samples=N_SAMPLES))
    x, h, nm = samples[-1]
    rec = {"phase": "stl", "box": STL_BOX, "moments": got.tolist(),
           "closed_form": want.tolist(),
           "max_rel_err": float(np.max(np.abs(got - want) / want)),
           "context": context.tolist(), "n_atoms": n_atoms,
           "launches": launches, "request_s": req_s,
           "x_shape": list(x.shape), "valid": gen.last_metrics["valid"]}
    log(f"[stl] {json.dumps(rec)}")
    check(rec["max_rel_err"] <= 1e-9, "STL moments disagree with the box's")
    check(launches == forward_launches(STEPS + 1),
          f"STL request launches {launches}")
    n_pad = pad_to_bucket(n_atoms + VARIANCE, gen.node_bucket)
    check(tuple(x.shape) == (N_SAMPLES, n_pad, 3)
          and torch.isfinite(x).all().item(),
          f"STL request samples {tuple(x.shape)}")
    check(torch.equal(h.sum(-1), nm[..., 0].to(h.dtype)),
          "STL request: h is not one-hot on real nodes")


def relax_batch(torch, mols, device, dtype):
    """``forcefield.relax`` of ``mols`` on ``device`` in ``dtype``, as
    ``optimize_geometry`` sets it up: the coordinates (B, N, 3) float64 on
    the host and the (steps, B) branch history (P < 0)."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem import forcefield

    n_pad = forcefield._pad8(max(m.num_atoms for m in mols))
    ff = forcefield.build_ff_batch(mols, n_pad)
    x0 = np.zeros((len(mols), n_pad, 3), np.float64)
    for b, m in enumerate(mols):
        x0[b, :m.num_atoms] = m.coords
    steps = []
    with torch.no_grad():
        x = forcefield.relax(torch.tensor(x0, device=device, dtype=dtype),
                             forcefield.to_device(ff, device, dtype),
                             uphill_log=steps)
    return x.double().cpu().numpy(), torch.stack(steps).cpu().numpy()


def first_branch_differences(a, b):
    """Column -> first step where two (steps, B) branch histories differ."""
    import numpy as np

    out = {}
    for j in range(a.shape[1]):
        d = np.nonzero(a[:, j] != b[:, j])[0]
        if d.size:
            out[j] = int(d[0])
    return out


def forcefield_phase(torch, reference, n=64):
    """``standardize_batch(..., optimize_geometry_flag=True)`` of the copies
    of phase 6 on the card (twice) and on the CPU, all float32 as the
    pipeline runs it: the same entries invalid, the relaxed coordinates
    within ``FF_BAR`` of the CPU's, each valid sample's FIRE branch history
    (the steps where P < 0) compared, and a sample beyond the bar reported
    by index with both histories. Then the same relaxation in float64 on
    both devices: within ``FF64_BAR``, the same branch histories (the
    float32 gap is round-off that FIRE amplifies, not a fault of the card's
    arithmetic)."""
    import functools

    import numpy as np

    from ml_conformer_generator_tpu_torch.chem import forcefield
    from ml_conformer_generator_tpu_torch.chem.standardize import \
        standardize_batch

    _, copies = reference_copies(reference, n)
    unrelaxed = standardize_batch(copies, optimize_geometry_flag=False,
                                  device="cpu")
    relax = forcefield.relax

    def run(device):
        steps = []
        forcefield.relax = functools.partial(relax, uphill_log=steps)
        try:
            t0 = time.perf_counter()
            out = standardize_batch(copies, optimize_geometry_flag=True,
                                    device=device)
            secs = time.perf_counter() - t0
        finally:
            forcefield.relax = relax
        return out, secs, torch.stack(steps).cpu().numpy()

    standardize_batch(copies[:2], optimize_geometry_flag=True,
                      device="cuda")                          # warm-up
    card, card_s, card_up = run("cuda")
    again, _, again_up = run("cuda")
    cpu, cpu_s, cpu_up = run("cpu")
    valid = [k for k, m in enumerate(cpu) if m is not None]
    same_invalid = ([m is None for m in card] == [m is None for m in cpu]
                    == [m is None for m in again])
    check(same_invalid, "card and CPU standardize different molecules")
    diff = {k: float(np.abs(card[k].coords - cpu[k].coords).max())
            for k in valid}
    repeat = max(float(np.abs(card[k].coords - again[k].coords).max())
                 for k in valid)
    moved = {k: float(np.abs(cpu[k].coords - unrelaxed[k].coords).max())
             for k in valid}
    flips = {valid[j]: s for j, s in
             first_branch_differences(card_up, cpu_up).items()}
    over = [k for k in valid if diff[k] > FF_BAR]

    mols = [unrelaxed[k] for k in valid]
    t0 = time.perf_counter()
    x64_card, up64_card = relax_batch(torch, mols, "cuda", torch.float64)
    card64_s = time.perf_counter() - t0
    x64_cpu, up64_cpu = relax_batch(torch, mols, "cpu", torch.float64)
    x32_cpu, _ = relax_batch(torch, mols, "cpu", torch.float32)
    diff64 = float(np.abs(x64_card - x64_cpu).max())
    flips64 = first_branch_differences(up64_card, up64_cpu)
    rec = {"phase": "forcefield", "molecules": n, "valid": len(valid),
           "steps": int(card_up.shape[0]),
           "seconds": {"cuda": card_s, "cpu": cpu_s, "cuda_float64": card64_s},
           "bar": FF_BAR, "max_abs_diff": max(diff.values()),
           "median_abs_diff": float(np.median(list(diff.values()))),
           "reference_copy_abs_diff": diff.get(0),
           "card_repeat_max_abs_diff": repeat,
           "max_moved": max(moved.values()),
           "uphill_steps": {"cuda": int(card_up.sum()),
                            "cpu": int(cpu_up.sum())},
           "first_branch_difference": flips,
           "max_abs_diff_same_branches": max(
               [diff[k] for k in valid if k not in flips], default=0.0),
           "beyond_bar": over,
           "float64": {"bar": FF64_BAR, "max_abs_diff": diff64,
                       "first_branch_difference": flips64},
           "cpu_float32_vs_float64_max_abs": float(
               np.abs(x32_cpu - x64_cpu).max())}
    log(f"[forcefield] {json.dumps(rec)}")
    for k in over:
        j = valid.index(k)
        log("[forcefield] " + json.dumps({
            "diverged": k, "max_abs_diff": diff[k],
            "first_branch_difference": flips.get(k),
            "uphill_steps_cuda": np.nonzero(card_up[:, j])[0].tolist(),
            "uphill_steps_cpu": np.nonzero(cpu_up[:, j])[0].tolist()}))
    check(valid and 0 in valid, "the reference copy did not standardize")
    check(rec["max_moved"] > 1e-2, "the force field moved no atom")
    check(not over, f"relaxed coordinates differ beyond {FF_BAR} A at "
          f"samples {over}")
    check(diff64 <= FF64_BAR and not flips64,
          f"float64 relaxation differs on the card: {rec['float64']}")
    ring_phase(torch)


def ring_copies(n=8, seed=0):
    """Rotated copies of ``_RING``, sanitised; the first unjittered, the
    others with a 0.05-0.2 A jitter."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.chem.perception import \
        determine_connectivity
    from ml_conformer_generator_tpu_torch.chem.standardize import \
        standardize_batch

    rng = np.random.default_rng(seed)
    z, xyz = _RING
    mols = []
    for k in range(n):
        q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        jitter = 0.0 if k == 0 else rng.uniform(0.05, 0.2)
        c = np.asarray(xyz) @ q.T + rng.standard_normal((len(z), 3)) * jitter
        mols.append(determine_connectivity(Molecule(z, c, [])))
    out = standardize_batch(mols, optimize_geometry_flag=False, device="cpu")
    check(all(m is not None for m in out), "a ring copy does not sanitise")
    return out


def ring_phase(torch):
    """``_RING`` copies relaxed on the card and on the CPU, in float32 and
    float64. Each copy's conditioning is measured on the CPU alone: how far
    its float32 run ends from its float64 run. A well-conditioned copy
    (within ``WELL_CONDITIONED``) is held as phase 6's copies are: float32
    within ``FF_BAR``, float64 within ``FF64_BAR`` with the same branch
    history. An ill-conditioned copy, whose relaxation amplifies round-off
    on any device, is reported by index with its distances and the first
    step where its branch histories differ."""
    import numpy as np

    for seed, n in ((0, 8), (1, 4)):
        mols = ring_copies(n, seed)
        runs = {(dev, str(dt)[6:]): relax_batch(torch, mols, dev, dt)
                for dev in ("cuda", "cpu")
                for dt in (torch.float32, torch.float64)}
        (c32, u32), (p32, v32) = runs["cuda", "float32"], runs["cpu",
                                                             "float32"]
        (c64, u64), (p64, v64) = runs["cuda", "float64"], runs["cpu",
                                                             "float64"]
        d32 = np.abs(c32 - p32).max((1, 2))
        d64 = np.abs(c64 - p64).max((1, 2))
        cond = np.abs(p32 - p64).max((1, 2))
        flips32 = first_branch_differences(u32, v32)
        flips64 = first_branch_differences(u64, v64)
        well = [k for k in range(n) if cond[k] <= WELL_CONDITIONED]
        rec = {"phase": "forcefield_ring", "seed": seed, "molecules": n,
               "cpu_float32_vs_float64": cond.tolist(),
               "float32_abs_diff": d32.tolist(),
               "float32_first_branch_difference": flips32,
               "float64_abs_diff": d64.tolist(),
               "float64_first_branch_difference": flips64,
               "well_conditioned": well,
               "ill_conditioned": [k for k in range(n) if k not in well]}
        log(f"[forcefield] {json.dumps(rec)}")
        check(np.isfinite(c32).all() and np.isfinite(c64).all(),
              "non-finite ring relaxation on the card")
        check(len(well) >= n // 2, f"fewer than half the ring copies are "
              f"well-conditioned: {rec}")
        for k in well:
            check(d32[k] <= FF_BAR and d64[k] <= FF64_BAR
                  and k not in flips64,
                  f"well-conditioned ring copy {k} differs on the card: "
                  f"{rec}")


def grad_guard_phase(torch, gk, gen, B=2, N=16):
    """A bf16 denoiser forward on the card under grad, with parameters that
    require grad, raises before any launch, naming the bf16 backward's
    ROADMAP item (M13b); the same forward under ``no_grad`` runs its 27
    launches. A float32 forward under grad runs through the autograd
    Function (27 forward launches) and its backward launches the backward
    kernel (27 more)."""
    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.models.egnn import (
        EGNNDynamics, dynamics_forward)
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    dyn = gen.sampler.dynamics
    g = torch.Generator().manual_seed(9)
    nm, em = prepare_masks(torch.tensor([N, N - 4]), N)
    nm, em = nm.cuda(), em.cuda()
    xh = torch.randn(B, N, 11, generator=g).cuda() * nm
    ctx = torch.randn(B, N, 3, generator=g).cuda() * nm
    t = torch.full((B,), 0.5, device="cuda")
    raised = None
    gk.reset_launch_counts()
    with torch.enable_grad():
        try:
            dynamics_forward(dyn, t, xh, nm, em, ctx)
        except RuntimeError as e:
            raised = str(e)
    guarded = dict(gk.LAUNCHES)
    with torch.no_grad():
        out, launches, _ = launches_of(
            torch, gk, lambda: dynamics_forward(dyn, t, xh, nm, em, ctx))

    dyn32 = EGNNDynamics(EGNNConfig(), torch.Generator().manual_seed(9))
    dyn32 = dyn32.cuda()
    with torch.enable_grad():
        out32, launches32, _ = launches_of(
            torch, gk, lambda: dynamics_forward(dyn32, t, xh, nm, em, ctx))
        gk.reset_launch_counts()
        out32.square().sum().backward()
        torch.cuda.synchronize()
    launches32_bwd = dict(gk.LAUNCHES)
    grads_finite = all(p.grad is not None and torch.isfinite(p.grad).all()
                       .item() for p in dyn32.parameters())
    rec = {"phase": "grad_guard",
           "parameters_require_grad": all(p.requires_grad
                                          for p in dyn.parameters()),
           "raised": raised, "launches_under_grad": guarded,
           "launches_no_grad": launches,
           "f32_launches_under_grad": launches32,
           "f32_launches_backward": launches32_bwd,
           "f32_grads_finite": grads_finite}
    log(f"[grad_guard] {json.dumps(rec)}")
    check(rec["parameters_require_grad"], "the denoiser's parameters do not "
          "require grad: the guard is not exercised")
    check(raised is not None and "M13b" in raised,
          "a bf16 forward under grad on the card did not raise naming M13b")
    check(guarded == launch_counts(), f"the guarded forward launched {guarded}")
    check(launches == forward_launches(1) and torch.isfinite(out).all()
          .item(), f"the forward under no_grad: launches {launches}")
    check(launches32 == forward_launches(1) and out32.requires_grad,
          f"the f32 forward under grad: launches {launches32}")
    check(launches32_bwd == launch_counts(gcl_bwd=18, coord_bwd=9)
          and grads_finite, f"the f32 backward: launches {launches32_bwd}")


# -- 13. training ---------------------------------------------------------------

# The training shape: the batch of examples/10_train.py, MAX_N_NODES nodes.
TRAIN_B, TRAIN_N = 64, 39
GRAD_NAMES = ["du", "dv", "de", "dw_e", "db0", "dw1", "db1", "dwh", "dbh"]
# Backward kernel against the plain backward. du, dv and de per element at
# the forward's f32 bar; the edge-summed weight gradients (dW_e, db0, dW1,
# db1, dwh, dbh) are sums over up to 10^5 edges in another order, so their
# bar is relative to their largest entry: max |err| <= 1e-4 max |ref|.
BWD_ATOL, BWD_RTOL, BWD_SUM_RTOL = 1e-5, 1e-4, 1e-4


def backward_kernel_phase(torch, gk, B, N, sizes, H=420):
    """Both modes of the float32 backward kernel at (B, N, H) against the
    plain backward (autograd of the plain forward) on the same inputs and
    upstream gradient, a second call bit-equal to the first, then timed
    beside the plain backward, the call's three products as
    ``torch.matmul`` (the library) and the bound. Returns one record per
    mode."""
    out = []
    a, _ = edge_inputs(torch, B, N, H, torch.float32, sizes, seed=B * N + 1)
    g = torch.Generator().manual_seed(B + N)
    for mode in ("gcl", "coord"):
        args = dict(a)
        if mode == "coord":
            args["em"], args["bh"] = None, None
        shape = (B, N, H) if mode == "gcl" else (B, N * N, 1)
        up = torch.randn(*shape, generator=g).cuda()
        call = lambda: gk.fused_edge_pass_backward(**args, g=up, mode=mode)
        plain = lambda: gk.fused_edge_pass_backward_reference(
            **args, g=up, mode=mode)
        gk.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        launches = dict(gk.LAUNCHES)
        ref = plain()
        rec = {"kernel": "edge_mlp_bwd_f32", "mode": mode, "B": B, "N": N,
               "H": H, "launches": launches}
        worst_elem, worst_sum = 0.0, 0.0
        for name, x, r in zip(GRAD_NAMES, got, ref):
            if r is None:
                check(x is None and mode == "coord", f"{name}: no gradient")
                continue
            check(x.shape == r.shape and torch.isfinite(x).all().item(),
                  f"backward {mode} {name}: shape or non-finite")
            err = (x - r).abs()
            rec[name] = {"max_abs_err": err.max().item(),
                         "ref_max_abs": r.abs().max().item()}
            if name in ("du", "dv", "de"):
                excess = (err - BWD_ATOL - BWD_RTOL * r.abs()).max().item()
                worst_elem = max(worst_elem, err.max().item())
                check(excess <= 0.0, f"backward kernel disagrees with plain "
                      f"in {name}: {rec}")
            else:
                rel = err.max().item() / r.abs().max().item()
                worst_sum = max(worst_sum, rel)
                check(rel <= BWD_SUM_RTOL, f"backward kernel disagrees with "
                      f"plain in {name}: {rec}")
        check(launches == launch_counts(**{f"{mode}_bwd": 1}),
              f"backward launches {launches}")
        again = call()
        torch.cuda.synchronize()
        rec["bit_equal_twice"] = all(
            (x is None and y is None) or torch.equal(x, y)
            for x, y in zip(got, again))
        check(rec["bit_equal_twice"], f"two backward calls differ: {rec}")
        del again
        rec["max_abs_err"] = worst_elem
        rec["weight_sums_max_rel_err"] = worst_sum
        del got, ref
        x = torch.randn(B * N * N, H, device="cuda")
        y = torch.randn(B * N * N, H, device="cuda")
        w1 = args["w1"]
        rec["kernel_ms"] = cuda_ms(torch, call, iters=10)
        rec["plain_ms"] = cuda_ms(torch, plain, iters=3)
        # the call's three products: s0 W1^T, dpre1 W1, dW1 = dpre1^T s0
        rec["library_ms"] = cuda_ms(
            torch, lambda: (x @ w1.t(), y @ w1, y.t() @ x), iters=10)
        del x, y
        bound_ms, bound_by = edge_pass_bound(B, N, H, 2, "float32", mode,
                                             backward=True)
        rec["bound_ms"], rec["bound_by"] = bound_ms, bound_by
        rec["share_of_bound"] = bound_ms / rec["kernel_ms"]
        log(f"[train] {json.dumps(rec)}")
        out.append(rec)
    return out


def backward_split(torch, gk, B, N, sizes, H=420, calls=5):
    """Where one float32 backward call (``fused_edge_pass_backward``) spends
    its time, per mode at (B, N, H): ``calls`` warm calls under
    ``torch.profiler``, each device kernel's ms a call (the backward
    kernel's own, the wrapper's ``dW1`` matmul, its reductions and
    fills), the host's ms a call in the wrapper's allocations
    (``aten::empty`` / ``aten::zeros``), and the call's CUDA-event time
    beside them. Returns one record per mode."""
    from torch.profiler import ProfilerActivity, profile

    a, _ = edge_inputs(torch, B, N, H, torch.float32, sizes, seed=B * N + 1)
    g = torch.Generator().manual_seed(B + N)
    cuda = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    out = []
    for mode in ("gcl", "coord"):
        args = dict(a)
        if mode == "coord":
            args["em"], args["bh"] = None, None
        shape = (B, N, H) if mode == "gcl" else (B, N * N, 1)
        up = torch.randn(*shape, generator=g).cuda()
        call = lambda: gk.fused_edge_pass_backward(**args, g=up, mode=mode)
        call_ms = cuda_ms(torch, call, iters=calls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sorted((e for e in events if e.device_type == cuda
                          and dev_us(e) > 0), key=dev_us, reverse=True)
        alloc_us = sum(e.self_cpu_time_total for e in events
                       if e.key in ("aten::empty", "aten::zeros"))
        # The trace may miss a call's kernels (after an earlier trace in the
        # process it has dropped the first call's): count the calls it saw
        # by launches of the backward kernel, the one that takes longest.
        seen = kernels[0].count if kernels else calls
        ms, launches = {}, {}
        for e in kernels:   # names cut short, so two kernels may share one
            name = e.key[:90]
            ms[name] = ms.get(name, 0.0) + dev_us(e) / 1e3 / seen
            launches[name] = launches.get(name, 0) + e.count / seen
        rec = {"backward_split": {"B": B, "N": N, "H": H, "mode": mode,
                                  "calls": calls, "calls_traced": seen},
               "call_ms": call_ms, "device_ms_a_call": ms,
               "launches_a_call": launches,
               "device_ms_a_call_total": sum(dev_us(e) for e in kernels)
               / 1e3 / seen,
               "host_alloc_ms_a_call": alloc_us / 1e3 / calls}
        log("[train] " + json.dumps(rec))
        out.append(rec)
    return out


BWD_PHASES = ["tile_rows", "recompute_half0", "epilogue1a_half0",
              "recompute_half1", "epilogue1a_half1", "epilogue1b",
              "product2_half0", "epilogue2_half0", "product2_half1",
              "epilogue2_half1", "column_sums_half0", "column_sums_half1"]


def backward_phase_clocks(torch, gk, B, N, sizes, H=420):
    """Where a block of the float32 backward kernel spends its clocks: one
    launch per mode through the library's C entry with its clock buffer,
    the other outputs allocated as the wrapper allocates them; its
    gradients are held bit-equal to the wrapper's. The product phases
    include building their A operand; "epilogue1a" is storing a half's
    pre1 (gcl) or that half's epilogue (coord), "epilogue1b" gcl's epilogue
    of both halves. Only with ``--profile``."""
    import ctypes

    lib = ctypes.CDLL(gk.build_kernel()["edge_mlp_bwd_f32"])
    lib.mlcg_edge_mlp_bwd_f32.restype = ctypes.c_int
    lib.mlcg_edge_mlp_bwd_f32.argtypes = (
        gk._load()["backward"].mlcg_edge_mlp_bwd_f32.argtypes)
    lib.mlcg_edge_mlp_bwd_f32_prof_slots.restype = ctypes.c_int
    slots = lib.mlcg_edge_mlp_bwd_f32_prof_slots()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a, _ = edge_inputs(torch, B, N, H, torch.float32, sizes, seed=B * N + 1)
    w1p = gk.packed_w1(a["w1"], backward=True)
    g = torch.Generator().manual_seed(B + N)
    M, E = B * N * N, 2
    f32 = dict(dtype=torch.float32, device="cuda")
    for mode in ("gcl", "coord"):
        gcl = mode == "gcl"
        args = dict(a)
        if not gcl:
            args["em"], args["bh"] = None, None
        up = torch.randn(*((B, N, H) if gcl else (B, N * N, 1)),
                         generator=g).cuda()
        raw = dict(s0=torch.empty(M, H + 4, **f32),
                   dpre1=torch.empty(M, H, **f32),
                   du=torch.empty(B, N, H, **f32),
                   dvp=torch.empty(B, gk.backward_tiles(N)[1], N, H, **f32),
                   de=torch.empty(B, N * N, E, **f32),
                   dwe=torch.empty(B, N, E, H, **f32),
                   dhead=torch.empty(M, **f32),
                   part=torch.zeros(sms, 8, 448, **f32))
        clocks = torch.zeros(sms, slots, dtype=torch.int64, device="cuda")
        rc = lib.mlcg_edge_mlp_bwd_f32(
            0 if gcl else 1, B, N, H, E, a["u"].data_ptr(),
            a["v"].data_ptr(), a["ef"].data_ptr(),
            a["em"].data_ptr() if gcl else None, a["w_e"].data_ptr(),
            a["w_e"].stride(0), a["b0"].data_ptr(), w1p[0].data_ptr(),
            w1p[1].data_ptr(), a["b1"].data_ptr(), a["wh"].data_ptr(),
            a["bh"].data_ptr() if gcl else None, 100.0, up.data_ptr(),
            *(t.data_ptr() for t in raw.values()), sms, clocks.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        check(rc == 0, f"clocked backward launch failed with CUDA error {rc}")
        got = gk._reduce_backward(raw, gcl)
        want = gk.fused_edge_pass_backward(**args, g=up, mode=mode)
        check(all((x is None and y is None) or torch.equal(x, y)
                  for x, y in zip(got, want)),
              "the clocked backward launch and the wrapper's disagree")
        per_block = clocks.sum(0).double() / clocks.shape[0]
        total = per_block.sum().item()
        log("[profile] " + json.dumps({
            "backward_phase_clocks": {"B": B, "N": N, "H": H, "mode": mode},
            "clocks_per_block": {n: int(c) for n, c in
                                 zip(BWD_PHASES, per_block.tolist())},
            "share": {n: round(c / total, 4) for n, c in
                      zip(BWD_PHASES, per_block.tolist())}}))


def training_corpus(torch, reference, n_copies=135):
    """The training corpus, made on the card: the reference with bonds from
    distances and ``n_copies`` perturb-and-relax copies of it (200 FIRE
    steps), as a ``MoleculeDataset``: two batches of 64 at least."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem.perception import \
        determine_connectivity
    from ml_conformer_generator_tpu_torch.training import (MoleculeDataset,
                                                           perturb_and_relax)

    ref = determine_connectivity(reference)
    t0 = time.perf_counter()
    mols = perturb_and_relax([ref], n_copies=n_copies, sigma=0.15, seed=0,
                             device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ds = MoleculeDataset(mols)

    def bond_lengths(m):
        return np.array([np.linalg.norm(m.coords[i] - m.coords[j])
                         for i, j, _ in m.bonds])

    ref_bl = bond_lengths(ref)
    dev = max(np.abs(bond_lengths(m) - ref_bl).max() for m in mols[1:])
    moved = min(np.abs(m.coords - ref.coords).max() for m in mols[1:])
    rec = {"molecules": len(mols), "dataset": len(ds), "bonds": len(ref.bonds),
           "relax_s": secs, "max_bond_length_change_A": float(dev),
           "min_max_displacement_A": float(moved)}
    log(f"[train] corpus {json.dumps(rec)}")
    check(len(ds) >= 2 * TRAIN_B, f"corpus of {len(ds)} < {2 * TRAIN_B}")
    check(all(np.isfinite(m.coords).all() for m in mols),
          "non-finite relaxed corpus")
    check(moved > 1e-3, "a copy did not move")
    return ds


def timed_steps(torch, step, model, state, batch, gamma, n, seed=7):
    """``n`` steps of ``step`` on one fixed objective: the draws re-seeded
    each step. Returns (losses, seconds per step), each step's host time
    ending in a synchronise."""
    losses, secs = [], []
    for _ in range(n):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, gen, batch, gamma)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return losses, secs


def train_step_phase(torch, gk, ds, n_learn=30):
    """The train step at full width (EGNN 420 x 9, float32, B = 64,
    N = 39): one step through the kernels against the same step through the
    plain version (same weights, same draws), the launch and W1-pack counts
    of a step, learning on a fixed objective with remat (the step's
    default) and the step's time without it, and the step's split into
    forward, backward and optimizer. Returns the record; its
    ``launches`` is the kernel step's."""
    import copy
    import dataclasses
    import statistics

    import numpy as np

    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.training import (batches,
                                                           edm_training_loss,
                                                           init_train_state,
                                                           make_optimizer,
                                                           make_train_step)

    cfg, diff = EGNNConfig(), DiffusionConfig()
    batch = next(batches(ds, TRAIN_B, rng=np.random.default_rng(0),
                         n_pad=TRAIN_N))
    gamma = torch.from_numpy(gamma_schedule(diff.timesteps))
    step = make_train_step(cfg, diff, device="cuda")
    model_k = EGNNDynamics(cfg, torch.Generator().manual_seed(21)).cuda()
    model_p = copy.deepcopy(model_k)
    state_k = init_train_state(model_k, make_optimizer(lr=1e-4))
    state_p = init_train_state(model_p, make_optimizer(lr=1e-4))

    # 13c. one step, kernel against plain: same weights, same draws
    gk.reset_launch_counts()
    gk.reset_pack_count()
    t0 = time.perf_counter()
    mk = step(model_k, state_k, torch.Generator(device="cuda").manual_seed(5),
              batch, gamma)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, packs = dict(gk.LAUNCHES), gk.PACKS
    with plain_edge_pass(gk):
        mp = step(model_p, state_p,
                  torch.Generator(device="cuda").manual_seed(5), batch,
                  gamma)
    torch.cuda.synchronize()
    check(gk.LAUNCHES == launches, "the plain step launched a kernel")
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    rel = {}
    for (name, pk), pp in zip(model_k.named_parameters(),
                              model_p.parameters()):
        rel[name] = ((pk.grad - pp.grad).norm() / pp.grad.norm()).item()
    worst = max(rel, key=rel.get)
    # a second kernel step: the optimizer moved every W1, so each repacks
    gk.reset_pack_count()
    step(model_k, state_k, torch.Generator(device="cuda").manual_seed(6),
         batch, gamma)
    torch.cuda.synchronize()
    packs2 = gk.PACKS
    want = launch_counts(4 * cfg.n_blocks, 2 * cfg.n_blocks, 2 * cfg.n_blocks,
                         cfg.n_blocks)
    rec = {"phase": "train_step", "B": TRAIN_B, "N": TRAIN_N,
           "width": cfg.hidden_nf, "blocks": cfg.n_blocks, "dtype": "float32",
           "remat": True, "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_norm_max": rel[worst], "grad_rel_norm_worst": worst,
           "grad_rel_norm_median": statistics.median(rel.values()),
           "launches": launches, "w1_packs": packs,
           "w1_packs_second_step": packs2, "first_step_s": first_s}
    check(rec["loss_rel_diff"] <= 1e-5, f"kernel and plain losses: {rec}")
    check(rel[worst] <= 1e-4, f"kernel and plain gradients: {rec}")
    check(all(pk.grad.abs().max().item() > 0
              for pk in model_k.parameters()), "a parameter got no gradient")
    check(launches == want, f"a step's launches {launches}, expected {want}")
    check(packs == packs2 == 3 * cfg.n_blocks,
          f"W1 packs a step {packs}, {packs2}; expected {3 * cfg.n_blocks}")
    del model_p, state_p

    # 13d. learning on a fixed objective (remat on), then remat off
    model = EGNNDynamics(cfg, torch.Generator().manual_seed(22)).cuda()
    state = init_train_state(model, make_optimizer(lr=1e-4))
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(torch, step, model, state, batch, gamma,
                               n_learn)
    peak_on = torch.cuda.max_memory_allocated()
    cfg_off = dataclasses.replace(cfg, remat=False)

    def step_off(model, state, gen, batch, gamma):
        b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = edm_training_loss(
            model, gen, b["x"], b["h"], b["node_mask"], b["edge_mask"],
            b["context"], gamma.cuda(), cfg_off, diff)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        return metrics

    torch.cuda.reset_peak_memory_stats()
    gk.reset_launch_counts()
    _, secs_off = timed_steps(torch, step_off, model, state, batch, gamma, 8)
    off_launches = dict(gk.LAUNCHES)
    peak_off = torch.cuda.max_memory_allocated()

    # the step's split: forward (loss), backward, optimizer
    split = {"forward": [], "backward": [], "optimizer": []}
    for i in range(5):
        gen = torch.Generator(device="cuda").manual_seed(7)
        b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = edm_training_loss(
            model, gen, b["x"], b["h"], b["node_mask"], b["edge_mask"],
            b["context"], gamma.cuda(), dataclasses.replace(cfg, remat=True),
            diff)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.optimizer.step()
        state.scheduler.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split["forward"].append(t1 - t0)
        split["backward"].append(t2 - t1)
        split["optimizer"].append(t3 - t2)

    med = statistics.median(secs[1:])
    med_off = statistics.median(secs_off[1:])
    rec.update({
        "learn_steps": n_learn, "learn_lr": 1e-4,
        "learn_loss_first": losses[0], "learn_loss_last": losses[-1],
        "learn_loss_drop": 1.0 - losses[-1] / losses[0],
        "step_s_median_remat": med, "step_s_min_remat": min(secs[1:]),
        "step_s_max_remat": max(secs[1:]),
        "molecules_per_s_remat": TRAIN_B / med,
        "step_s_median_no_remat": med_off,
        "molecules_per_s_no_remat": TRAIN_B / med_off,
        "launches_no_remat_8_steps": off_launches,
        "peak_mem_gb_remat": peak_on / 1e9,
        "peak_mem_gb_no_remat": peak_off / 1e9,
        "split_s_median": {k: statistics.median(v[1:])
                           for k, v in split.items()}})
    log(f"[train] {json.dumps(rec)}")
    log(f"[train] fixed-objective losses: {[round(x, 5) for x in losses]}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] <= 0.8 * losses[0],
          f"the loss did not drop by 20% in {n_learn} steps: {losses}")
    check(off_launches == launch_counts(8 * 2 * cfg.n_blocks,
                                        8 * cfg.n_blocks,
                                        8 * 2 * cfg.n_blocks,
                                        8 * cfg.n_blocks),
          f"launches without remat {off_launches}")
    return rec


def train_loop_phase(torch, gk, ds, reference, workdir):
    """``train`` for one epoch (EMA 0.999, cosine LR with warmup) writing
    its checkpoint; the checkpoint loaded into a generator on the card
    (weights equal to the EMA's) that serves one 64-sample request with 27
    forward launches a forward and no backward launch."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.checkpoint import (_flatten,
                                                             to_jax_params)
    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.generator import MLConformerGenerator
    from ml_conformer_generator_tpu_torch.training import train

    ckpt = os.path.join(workdir, "train_edm.npz")
    lines = []
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    out = train(ds, egnn_cfg=EGNNConfig(), batch_size=TRAIN_B, epochs=1,
                lr=1e-4, seed=0, device="cuda", checkpoint_path=ckpt,
                ema_decay=0.999, cosine_lr=True, warmup_steps=1, log_every=1,
                log_fn=lines.append)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    steps = len(ds) // TRAIN_B
    gen = MLConformerGenerator(diffusion_steps=STEPS, seed=0, device="cuda",
                               edm_weights=ckpt)
    fa = _flatten(gen.edm_params)
    fb = _flatten(to_jax_params(out["ema_params"]))
    same = sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k])
                                            for k in fa)
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    valid = gen.generate_conformers(reference_conformer=reference,
                                    n_samples=N_SAMPLES, variance=VARIANCE)
    torch.cuda.synchronize()
    req_s = time.perf_counter() - t0
    req_launches = dict(gk.LAUNCHES)
    rec = {"phase": "train_loop", "steps": steps, "train_s": train_s,
           "history": out["history"], "log": lines, "launches": launches,
           "checkpoint_mb": os.path.getsize(ckpt) / 1e6,
           "generator_weights_equal_ema": same, "request_s": req_s,
           "request_valid": len(valid), "request_launches": req_launches}
    log(f"[train] {json.dumps(rec)}")
    blocks = 9
    check(len(out["history"]) == steps and all(
        np.isfinite(h["loss"]) for h in out["history"]), "train history")
    check(launches == launch_counts(4 * blocks * steps, 2 * blocks * steps,
                                    2 * blocks * steps, blocks * steps),
          f"train() launches {launches}")
    check(same, "the generator's weights are not the checkpoint's EMA")
    check(req_launches == forward_launches(STEPS + 1),
          f"request from the trained checkpoint: launches {req_launches}")
    del gen


def bond_training_phase(torch, ds, steps=20):
    """``train_adj_mat_seer`` on the card (AdjMatSeer 2048) for ``steps``
    steps on the corpus, batches of 64: its loss drops."""
    from ml_conformer_generator_tpu_torch.training import train_adj_mat_seer

    t0 = time.perf_counter()
    out = train_adj_mat_seer(ds.mols, steps=steps, lr=3e-4,
                             batch_size=TRAIN_B, seed=0, log_every=1,
                             log_fn=lambda s: None, device="cuda")
    torch.cuda.synchronize()
    hist = [h["loss"] for h in out["history"]]
    rec = {"phase": "bond_training", "steps": steps,
           "seconds": time.perf_counter() - t0,
           "device": str(next(out["params"].parameters()).device),
           "loss_first": hist[0], "loss_last": hist[-1]}
    log(f"[train] {json.dumps(rec)}")
    check(rec["device"].startswith("cuda"), "the bond predictor is not on "
          "the card")
    check(hist[-1] < hist[0], f"the bond loss did not drop: {hist}")


# Run by ``--compare-train DIR`` in each of two checkouts, in a process of
# its own: that checkout's backward call at the training shape and its
# train step (phase 13), as one JSON line.
_TRAIN_RUN = r"""
import json, sys, torch
sys.argv = ["chip_smoke.py"]
sys.path.insert(0, ".")
import chip_smoke as cs
from ml_conformer_generator_tpu_torch.chem.mol import Molecule
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
torch.backends.cuda.matmul.allow_tf32 = False
out = {r["mode"] + "_bwd_ms": r["kernel_ms"] for r in cs.backward_kernel_phase(
    torch, gk, cs.TRAIN_B, cs.TRAIN_N, (15, 39))}
ref = Molecule([z for z, *_ in cs._REFERENCE], [x for _, *x in cs._REFERENCE], [])
rec = cs.train_step_phase(torch, gk, cs.training_corpus(torch, ref))
out.update({k: rec[k] for k in (
    "step_s_median_remat", "molecules_per_s_remat", "step_s_median_no_remat",
    "peak_mem_gb_remat", "peak_mem_gb_no_remat", "split_s_median",
    "grad_rel_norm_max")})
print("TRAIN_RUN " + json.dumps(out), flush=True)
"""


def compare_train(other):
    """The backward call at the training shape and the train step of the
    checkout at ``other`` (the parent's, say) and of this one, in turns:
    other, this, this, other, each in a process of its own that imports
    its own package. Prints one JSON line a run; returns non-zero if one
    failed."""
    rc = 0
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        p = subprocess.run([sys.executable, "-c", _TRAIN_RUN], cwd=root,
                           capture_output=True, text=True, timeout=900)
        line = [l for l in p.stdout.splitlines() if l.startswith("TRAIN_RUN ")]
        if p.returncode or not line:
            log(f"[compare] {name} {root} failed:\n{(p.stdout + p.stderr)[-3000:]}")
            rc = 1
            continue
        log(f"[compare] {json.dumps(dict(json.loads(line[0][10:]), run=name))}")
    return rc


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
    if "--compare-train" in sys.argv[1:]:
        return compare_train(
            os.path.abspath(sys.argv[sys.argv.index("--compare-train") + 1]))

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

    import numpy as np

    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.generator import MLConformerGenerator
    from ml_conformer_generator_tpu_torch.models.egnn import (
        EGNNDynamics, dynamics_forward)
    from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
    from ml_conformer_generator_tpu_torch.ops.moi import get_context_shape
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
    check(launches == forward_launches(1, cfg.n_blocks),
          f"forward launches {launches}")
    check(torch.isfinite(out_k).all().item(), "non-finite forward")
    check((err <= 5e-2 + 5e-2 * out_p.abs()).all().item(),
          "full-width forward: kernel disagrees with plain beyond 5e-2")

    # -- 5. end to end ---------------------------------------------------------
    reference = Molecule([z for z, *_ in _REFERENCE],
                         [xyz for _, *xyz in _REFERENCE], [])
    ref_context = [105.0766, 473.1938, 537.4675]

    # The fixed fragment of 5c and 5d: the reference's phenyl ring and
    # methoxy group (atoms 0-5, 12, 13), in the principal frame that
    # generate_conformers puts the reference in.
    ref_xyz = np.asarray(reference.coords, dtype=np.float32)
    ref_shape_context, ref_frame = get_context_shape(
        ref_xyz - ref_xyz.mean(axis=0))
    frag_idx = [0, 1, 2, 3, 4, 5, 12, 13]
    fragment = Molecule(reference.atomic_nums[frag_idx],
                        ref_frame[frag_idx], [])

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

    # 5c. short f32 fragment generations, kernel against plain, same seed
    for ifm, method in ((False, "inpaint"), (True, "merge_fragments")):
        frag_samples = recorded(small, method)
        for plain in (False, True):
            small._generator.manual_seed(6)
            gk.reset_launch_counts()
            with plain_edge_pass(gk) if plain else contextlib.nullcontext():
                small.edm_samples(ref_shape_context, n_samples=8,
                                  min_n_nodes=23, max_n_nodes=27,
                                  fixed_fragment=fragment,
                                  inertial_fragment_matching=ifm)
            torch.cuda.synchronize()
            if not plain:
                frag_launches = dict(gk.LAUNCHES)
        (xk, hk, _), (xp, hp, _) = frag_samples
        frag_err = (xk - xp).abs().max().item()
        # inpaint: T * 2 + 1 forwards; IFM: T + 1 at N = 32 - 8, then
        # min(50, T - 1) + 1 + 1 (T = 4)
        forwards = 9 if not ifm else 5 + 4 + 1
        log(f"[e2e] f32 T=4 B=8 {method} (fragment of {len(frag_idx)} "
            f"atoms), kernel vs plain: max |dx| {frag_err:.3e} (|x| max "
            f"{xp.abs().max().item():.3e}), h equal: {torch.equal(hk, hp)}, "
            f"launches {frag_launches}")
        check(frag_launches == forward_launches(forwards),
              f"{method} launches {frag_launches}, expected {forwards} "
              f"forwards")
        check(torch.isfinite(xk).all().item(), f"non-finite {method}")
        check(torch.allclose(xk, xp, rtol=1e-3, atol=1e-3),
              f"f32 {method} through the kernel disagrees with the plain one")
        check(torch.equal(hk, hp),
              f"{method}: atom types differ between kernel and plain")
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
    check(gk.LAUNCHES == forward_launches(3),
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

    # 5d. the full-width bf16 request with a fixed fragment: inpainting
    # (one resample: T * 2 + 1 forwards) and IFM (the complement generated
    # at N = 32 - 8 in T + 1 forwards, merged from min(50, T - 1) in 52)
    fragment_requests = {}
    for ifm, method, forwards in ((False, "inpaint", 2 * STEPS + 1),
                                  (True, "merge_fragments",
                                   (STEPS + 1) + (min(50, STEPS - 1) + 1)
                                   + 1)):
        request = "ifm" if ifm else "inpaint"
        fragment_requests[request] = timed_request(
            torch, gk, bf16_gen, recorded(bf16_gen, method),
            dict(kw, fixed_fragment=fragment,
                 inertial_fragment_matching=ifm),
            n_pad, path if not ifm else None, "bfloat16", ref_n,
            request=request, forwards=forwards, warm_packs_want=0)
    log("[e2e] random weights: 0 valid molecules and diverging coordinates "
        "are expected and are not a failure")
    if "--profile" in sys.argv[1:]:
        for dtype in (torch.bfloat16, torch.float32):
            phase_clocks(torch, gk, N_SAMPLES, n_pad,
                         (ref_n - VARIANCE, max_n), dtype)
            phase_clocks(torch, gk, 128, 40, (15, 39), dtype)
        profile_request(torch, bf16_gen, kw,
                        requests["bfloat16"]["request_s"])

    # -- 6. evaluation on the card against the CPU ------------------------
    eval_phase(torch, reference)

    # -- 7-12. the serving surface, the repairs ------------------------------
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    onnx_phase(torch, gk, bf16_gen, kw, workdir)
    roundtrip_phase(torch, gk, bf16_gen, kw, workdir)
    app_phase(torch, gk, reference, kind)
    stl_phase(torch, gk, bf16_gen, workdir)
    grad_guard_phase(torch, gk, bf16_gen)
    forcefield_phase(torch, reference)

    # -- 13. training -----------------------------------------------------------
    bwd = []
    for B, N, sizes in ((TRAIN_B, TRAIN_N, (15, 39)), (5, 40, (15, 39)),
                        (8, 128, (100, 128))):
        bwd += backward_kernel_phase(torch, gk, B, N, sizes)
    split = backward_split(torch, gk, TRAIN_B, TRAIN_N, (15, 39))
    if "--profile" in sys.argv[1:]:
        backward_phase_clocks(torch, gk, TRAIN_B, TRAIN_N, (15, 39))
    corpus = training_corpus(torch, reference)
    train_rec = train_step_phase(torch, gk, corpus)
    train_loop_phase(torch, gk, corpus, reference, workdir)
    bond_training_phase(torch, corpus)
    train_launches = train_rec["launches"]

    # One entry per kernel and mode: the forward kernels at the request's
    # shape, launches those of the request in the kernel's type; the
    # backward kernel at the training shape, launches those of one train
    # step. Every entry also has the train step's launches.
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
                "dtype": name, "shape": [r["B"], r["N"], r["H"]],
                "training_step_launches": (train_launches[mode]
                                           if name == "float32" else 0)})
    for r in bwd:
        if (r["B"], r["N"]) != (TRAIN_B, TRAIN_N):
            continue
        mode = r["mode"]
        kernels.append({
            "name": f"edge_mlp_bwd_f32_{mode}", "route": "cuda",
            "source": BWD_SOURCE, "replaces": BWD_REPLACES,
            "launches": train_launches[f"{mode}_bwd"],
            "max_abs_err": r["max_abs_err"],
            "weight_sums_max_rel_err": r["weight_sums_max_rel_err"],
            "atol": BWD_ATOL, "rtol": BWD_RTOL, "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "float32", "shape": [r["B"], r["N"], r["H"]],
            "bit_equal_twice": r["bit_equal_twice"],
            "call_device_ms": next(x["device_ms_a_call"] for x in split
                                   if x["backward_split"]["mode"] == mode),
            "training_step_launches": train_launches[f"{mode}_bwd"]})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
