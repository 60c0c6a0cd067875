#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``ml_conformer_generator_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a):

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus the kernels' phase clocks (the
        # bf16 kernel's per warpgroup) and one request under torch.profiler
    python3 chip_smoke.py --compare-train DIR   # only the backward call and
        # the train step of the checkout in DIR and of this one, in turns
    python3 chip_smoke.py --compare-bf16 DIR    # only the bf16 edge kernel
        # of the checkout in DIR and of this one, in turns: times beside the
        # bound, the output's digest and the phase clocks, at MLCG's and at
        # GEOM-Drugs' width
    python3 chip_smoke.py --drugs     # only the bf16 kernel at GEOM-Drugs'
        # width (phase 3's wide shapes, the drugs cell's N <= 128 shapes)
        # and EDM GEOM-Drugs' front end (4b); with --profile also the phase
        # clocks of both bodies
    python3 chip_smoke.py --f32-wide [--compare-f32 DIR]   # only the
        # smoke run's float32 phases at GEOM-Drugs' width: the forward and
        # backward kernels' wide paths (128 < N <= 192) and the training
        # cell's N <= 128 pads, held against the plain versions, bit-equal
        # twice, timed beside the bound, and its train step at pad 184
        # against the plain version; with --compare-f32 also the kernels'
        # outputs at N <= 128 against the checkout in DIR (the parent's,
        # say), bit for bit

It builds the port's CUDA kernels from ``ml_conformer_generator_tpu_torch/
csrc/`` (``edge_mlp.cu`` for bfloat16, ``edge_mlp_f32.cu`` for float32,
``edge_mlp_bwd_f32.cu`` for the float32 backward, one ``nvcc`` each, side
by side) and drives the port's main path, the
reference-conditioned ``MLConformerGenerator.generate_conformers``, at full
width (EGNN 420 x 9 blocks, AdjMatSeer 2048) with random weights made from a
seed, in bf16 (the default) and in float32. On the card each trajectory of
the sampler runs as one captured CUDA graph, and FIRE as a captured graph of
one step replayed once a step (``utils/cuda_graph.py``): the first request
of a shape captures it, and its
warm-up (the first reverse step and the decode) launches for real
(``WARMUP_FORWARDS``); later requests replay it, each replay credited with
the launches its capture recorded. So the launch checks count a capture's
warm-up where a request captures, and the kernel-against-plain runs take
the sampler's loop for their plain side. A train step on one card, the EMA
update and AdjMatSeer's step are captured graphs too: a run's first step
is the capture's warm-up, made for real, and the later steps replay it
(credited with its launches and W1 packs). Phases:

1. environment: device, name and power limit from nvidia-smi; TF32 off;
2. build: ``nvcc`` for sm_90a, with the build time, and per source ptxas's
   registers, spills and C7511 notes and the wgmma instructions in the SASS;
3. kernel: each edge-pass mode (gcl, coord) in bf16 and f32 against its
   plain PyTorch version on the card, at the production shape (B=128, N=40),
   at a shape with more than 48 nodes (B=16, N=64), at one whose graphs do
   not fill their last tile of target nodes (B=5, N=40), at the most nodes
   a tile holds (B=8, N=128), at the edges twin's (B=128, N=42) and at the
   shape this run's request gives it; the bf16 wide path (128 < N <= 192,
   ``edge_mlp_bf16_wide_kernel``) at H = 256 at the drugs cell's shapes
   (B=16, N=184 and N=144) and at B=1, N=192, one call a mode counted as
   one launch and one wide pass;
   kernel (eager, and replayed in a CUDA graph of 50 launches), plain and
   library times (CUDA events) beside the bound; then the
   cache of packed W1 in both types: a second launch packs nothing, an
   in-place change of W1 packs again and changes the result;
4. model: one full-width bf16 ``dynamics_forward`` through the kernel
   against the same forward through the plain version; (4b) EDM
   GEOM-Drugs' front end, ``EDMGenerator.sample(16, 181)`` in bf16 (T =
   1000, every edge pass on the wide path), capture and replay with exact
   launches and wide passes, then one drugs forward at (16, 184) through
   the kernel against the plain version;
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
   three times: the first builds the server's generator and captures its
   graph), status 200, JAX's response keys, exact launches;
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
    ``train_adj_mat_seer`` on the card (its loss drops). Since phase 21's
    graphs the kernel step's first call is its capture's warm-up and its
    second a replay, credited with the capture's launches and packs;
14. j-slab kernels (the edge-sharded EGNN's): the float32 forward in both
    modes at (B, N, N_l) = (64, 32, 16), (64, 32, 8), (64, 40, 20),
    (5, 40, 20) and (8, 128, 64), the backward at (64, 40, 20), (64, 39,
    13) and (8, 128, 64), each slab against the plain version on the same
    slab within the unloosened bars, the slabs of one pass put back
    together against the N_l = N call, exact launches, a second call
    bit-equal, and times beside the bound;
15. the sharded paths: two gloo ranks on this card (NCCL refuses two ranks
    on one device), a (1, 2) mesh at full width in float32: the sharded
    forward (B = 64, N = 32), ``make_sharded_generate`` (T = 10) and two
    ``make_train_step`` steps (B = 64, N = 40, phase 13's corpus padded by
    a masked node) against one rank with the same weights and draws, with
    exact launches on each rank and equal parameters on both, each bar
    checked to refuse two controls (a slab dropped, the work in bf16); a
    rank's failure fails the run;
16. the screening driver: ``ScreeningDriver`` on the bf16 generator, four
    references, 64 samples, 100 steps, at queue depth 1 and 2 against a
    serial loop of ``generate_conformers`` (equal samples and molecules,
    4 x 101 x 27 launches), its stage metrics, the screen with scoring on
    copies of the references that survive (depth 1 and 2 the same
    molecules and reports), then ``screen_iter`` broken off early;
17. deployment: the bf16 generator exported by
    ``export_generator_artifacts(..., batch=32)`` (N = 42; the sampler one
    ``while_loop`` over the T steps), each unit's export, save and load
    seconds and file size; the loaded sampler fed the raw draws that a
    patched ``sample_noise`` replays to ``EDMSampler.generate``, the loaded
    denoiser and AdjMatSeer against the eager functions, each bit for bit;
    exact launches a sampler call (T + 1 denoiser calls, whatever this
    torch's eager ``scan`` would add) and 27 W1 packs a loaded program, none
    a later call; the ``MLConformerGeneratorAOT``'s captured graphs of the
    sampler and AdjMatSeer programs against the direct calls and the eager
    functions, bit for bit, with exact launches, the first call's seconds
    and the reserved memory across each capture; the direct call, the
    graphed call and the eager sampler in turns; the AOT request (64
    samples, two sampler replays) beside ``generate_conformers`` in turns;
    two processes sharing a
    fresh ``enable_compile_cache`` directory (the first builds, the second
    does not, the same kernel output) and a failing ``nvcc`` that raises;
    ``debug_mode`` over a denoiser forward (bit-equal, timed) and over one
    whose W1 carries a NaN (raises naming ``mlcg_torch.fused_edge_pass``);
    an artifact set exported on the CPU refused on the card;
18. the overfit-validity path (``scripts_torch/train_overfit_validity.py``,
    the twin of the JAX package's script, at full width): one train step
    at its shape (B = 32, N = 39) with every forward and backward kernel
    call held against its plain version and exact launches (36 / 18
    forward, 18 / 9 backward); the twin's ``run`` at ``VALIDITY_STEPS``:
    the denoiser and AdjMatSeer trained on three cuts of the reference and
    their copies, saved as ``.npz``, served through ``generate_conformers``
    (64 samples, 100 steps, bf16) around each cut, with exact launches in
    training (those of a step times the steps) and in serving (1,818 / 909
    a request); the served EMA weights' loss on a fixed objective at least
    20% below the initial weights'; the serving generator's weights equal
    to the trained modules; the first forward of a served request held
    against the plain version in bf16; the report with every key of
    ``VALIDITY.json``; a valid molecule where ``VALIDITY_REACHED``, else
    the stage that lost them. One ``[validity]`` line gives validity,
    size-matched validity, valid molecules a second and the train
    seconds beside the card;
19. the JAX system's tools (``scripts_torch/``'s twins) on phase 18's
    weights: (19a) ``make_eval_report.evaluate`` over REPORT_DEPTH protocol
    references at full width (bf16, 100 steps, variance 2) with exact
    launches, every payload key of the JAX script's, validity, uniqueness
    and novelty in [0, 1] and the first forward held against the plain
    version; (19b) ``edges_scaling`` at its defaults (B = 128, N = 42) in
    bf16 and float32, one forward of each held against the plain version,
    exact launches and the busy share, then ``--mesh 1x2`` (two gloo ranks
    on the card, float32) held against one rank within phase 15's bar;
    (19c) ``kernel_microbench`` at (128, 42, 420) in both types, the
    kernel's pass within the bar, plain, kernel and library times and the
    share of the bound; (19d) one bf16 request under ``torch.profiler``,
    its trace read by ``trace_breakdown``: the edge category's events equal
    the request's launches, its time the profiler's key averages within
    1%, busy within the window, the busy share and the five longest gaps
    with the host ops open at their start; in 19a also FIRE on the served
    traffic: each relaxation's batch, whether it captured, its seconds
    against the loop's on the same inputs, and a replay bit for bit the
    loop;
20. the one-program trajectories, the twin of JAX's ``jit(lax.scan)``:
    (20a) the bf16 and the float32 request, two in a row from one seed,
    through the captured graphs against the sampler's loop (the
    comparison's own route): x and h bit for bit, the generator in one
    state after both; (20b) the bf16 inpaint and IFM requests at 5d's
    fragment, the same way; (20c) ``relax`` through its graph against the
    loop of its steps on phase 12's batch (float32 and float64) and the
    ring copies: coordinates bit for bit, the same uphill history, at a
    capture and a replay, the well-conditioned ring copies within
    ``FF_BAR`` of the CPU, and FIRE's 200 steps timed both ways in turns;
    (20d) in every request of 20a-b exact launches (the graph's credited
    by its replay) and no W1 packed; (20e) the bf16 request GRAPH_TURNS
    times each through the graph and the loop in turns: median and range of
    request seconds, ``edm_sampling_s``, ``standardize_s`` and (profiled
    turns) the card's busy share, and of a capture's seconds over as many
    fresh captures; (20f) one graphed request traced and read as 19d;
    (20g) what the graphs hold on the card: the reserved memory across each
    capture (generate, inpaint, IFM and relax at 64 and at 200 samples, the
    most the app takes) and across a sampler cache filled to its bound;
21. the one-program train steps, the twin of JAX's jitted step, EMA update
    and AdjMatSeer step: (21a) six full-width float32 steps (remat) with
    the EMA after each and a warmup-cosine through its warmup, through the
    graphs and through the loop (``train_loop``, the comparison's own
    route), at (64, 39) on phase 13's corpus and at the overfit twin's
    (32, 39): losses, parameters, gradients, AdamW moments and counts, EMA,
    learning rate and generator bit for bit; (21b) every step 36 / 18
    forward and 18 / 9 backward launches and 27 W1 packs, a replay's
    credited; (21c) an eager forward on the live model after its replays
    (every W1 packed afresh) and every kernel call of a replayed step held
    against the plain version; (21d) the step with its EMA, graph and loop
    in turns at both shapes: median and range, the card's busy share, the
    captures' seconds and the reserved memory across them; (21e)
    ``train_adj_mat_seer`` graph against loop (full batch in turns, and
    sampled) bit for bit and timed, and the overfit twin's training at
    ``TWIN_STEPS`` through each route.

Files it writes (ONNX, ``.npz``, STL, ``.pt2``, the kernel cache, phase
18's weights and report, phase 19's report and trace) go to
``build/chip_smoke/``.

Any failed check raises, so the script exits non-zero and does not print its
last line, ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
with code 2 before doing anything.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

# Phase 18's twin; it owns the request's reference molecule.
from scripts_torch import train_overfit_validity as overfit
# Phase 19's twins of the JAX system's tools.
from scripts_torch import edges_scaling as edges
from scripts_torch import kernel_microbench as microbench
from scripts_torch import make_eval_report as report
from scripts_torch import trace_breakdown as breakdown_tool

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
# The request's reference: a drug-like molecule of 25 heavy atoms, (atomic
# number, x, y, z) in Angstrom; phase 18 trains on three cuts of it.
_REFERENCE = overfit.REFERENCE


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


def graph_ms(torch, fn, iters=50):
    """Mean time of ``fn`` on the card, ``iters`` launches captured in one
    CUDA graph and replayed (CUDA events): device time without the host's
    gaps between eager launches, as the sampler's graphs run them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edge_pass_bound(B, N, H, E, dtype_name, mode, backward=False, NL=None):
    """Least time (ms) of one edge pass on an H100, and what bounds it.
    ``NL``: source nodes of a j-slab (default N, the square edge set); the
    edges are then B N NL, v and dv (B, NL, H).

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
    NL = N if NL is None else NL
    edges = B * N * NL
    nodes = B * (N + NL) * H        # u and v (du and dv)
    if backward:
        ops = 3 * 2.0 * edges * H * H
        n_in = (nodes + edges * E + H * E + H * H + 3 * H
                + (edges + 1 + B * N * H if mode == "gcl" else edges))
        n_out = (nodes + edges * E + H * E + H * H + 3 * H
                 + (1 if mode == "gcl" else 0))
        t_ops = ops / PEAK_OPS["float32"]
        t_bytes = (n_in + n_out) * 4 / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                           else "bytes")
    el = 2 if dtype_name == "bfloat16" else 4
    ops = 2.0 * edges * H * (H + E + 1)
    n_in = nodes + edges * E + H * E + H * H + 3 * H
    if mode == "gcl":
        n_in += edges + 1
    n_out = B * N * H if mode == "gcl" else edges
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
def train_loop():
    """Within: the train step, the EMA update and AdjMatSeer's step run as
    the loop on the card, the comparison's own route (the training
    package's switch; nothing else reaches the loop with CUDA tensors on
    the (1, 1) mesh)."""
    from ml_conformer_generator_tpu_torch.training import step as tstep

    tstep._graphed = False
    try:
        yield
    finally:
        tstep._graphed = True


@contextlib.contextmanager
def plain_edge_pass(gk):
    """Route the model's edge passes to the plain PyTorch version (the
    reference the kernel is held against), and the sampler's trajectories
    to its loop: a captured graph would replay the kernels it recorded."""
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler

    kernel = gk.fused_edge_pass
    gk.fused_edge_pass = gk.fused_edge_pass_reference
    EDMSampler._graphed = False
    try:
        yield
    finally:
        gk.fused_edge_pass = kernel
        EDMSampler._graphed = True


def kernel_phase(torch, gk, B, N, sizes, card, H=420,
                 dtypes=("bfloat16", "float32")):
    """Each mode x type (of ``dtypes``) at (B, N, H): held against the plain
    version, then timed beside the plain version, one torch.matmul of the
    inner GEMM and the bound. ``card``: (SMs, SM clock in Hz) for the
    elementwise floor. Returns one record per (mode, type)."""
    out = []
    for dtype in (getattr(torch, d) for d in dtypes):
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
                   "out_sha": hashlib.sha256(
                       got.cpu().numpy().tobytes()).hexdigest()[:16],
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
            rec["kernel_graph_ms"] = graph_ms(torch, call)
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


# The bf16 kernel's wide path (128 < N <= 192) at EDM GEOM-Drugs' width:
# the drugs cell's requests at 181 and 144 atoms (16 molecules, buckets 184
# and 144), and one graph at the most nodes the path takes.
WIDE_SHAPES = [(16, 184, (181, 181)), (16, 144, (144, 144)),
               (1, 192, (192, 192))]
DRUGS_H = 256
# The drugs cell's requests at 96 and 48 atoms: the N <= 128 body at that
# width.
DRUGS_SHAPES = [(16, 96, (96, 96)), (16, 48, (48, 48))]
# Its phase clocks (``--drugs --profile``) and the timing against another
# checkout (``--compare-bf16``): the largest request on the wide body and
# one on the N <= 128 body.
DRUGS_PROFILE_SHAPES = [(16, 184, (181, 181)), (16, 96, (96, 96))]


def wide_kernel_phase(torch, gk, card):
    """The wide path at each of ``WIDE_SHAPES``: one call a mode from zeroed
    counts is one launch and one wide pass, then ``kernel_phase`` in bf16
    (held against the plain version at the unloosened bars, timed beside
    the bound). Returns its records."""
    out = []
    for B, N, sizes in WIDE_SHAPES:
        a, _ = edge_inputs(torch, B, N, DRUGS_H, torch.bfloat16, sizes,
                           seed=B * N)
        gk.reset_launch_counts()
        gk.fused_edge_pass(**a, mode="gcl")
        gk.fused_edge_pass(**dict(a, em=None, bh=None), mode="coord")
        torch.cuda.synchronize()
        counts = {"launches": dict(gk.LAUNCHES), "passes": dict(gk.PASSES)}
        log(f"[kernel] wide ({B}, {N}, {DRUGS_H}) one call a mode: "
            f"{json.dumps(counts)}")
        check(counts == {"launches": launch_counts(1, 1),
                         "passes": {"gcl": 0, "coord": 0, "gcl_wide": 1,
                                    "coord_wide": 1}},
              f"a wide call is not one launch and one wide pass: {counts}")
        out += kernel_phase(torch, gk, B, N, sizes, card, H=DRUGS_H,
                            dtypes=("bfloat16",))
    return out


# The float32 kernels' wide paths (128 < N <= 192) at EDM GEOM-Drugs' width:
# the training cell's largest pads at 16 and 64 molecules (sizes from 24 up:
# graphs wholly inside the first slab too), a second slab of one source node,
# and the most nodes the paths take; then the N <= 128 float32 kernels at
# that width at the cell's smaller pads.
F32_WIDE_SHAPES = [(16, 184, (24, 181)), (64, 184, (24, 181)),
                   (64, 144, (24, 144)), (2, 129, (129, 129)),
                   (1, 192, (192, 192))]
F32_DRUGS_SHAPES = [(64, 96, (24, 96)), (64, 128, (24, 128))]


def f32_wide_phase(torch, gk, card):
    """The float32 forward and backward kernels' wide paths at each of
    ``F32_WIDE_SHAPES`` (H = 256): one forward call a mode from zeroed
    counts is one launch and one wide pass, a second call gives the same
    bits; then ``kernel_phase`` (held against the plain version at the
    f32 bar, timed beside the bound) and ``backward_kernel_phase`` (bars,
    bit-equal twice, timed beside the bound). Then both at
    ``F32_DRUGS_SHAPES`` on the N <= 128 kernels. Returns the records."""
    out = []
    for B, N, sizes in F32_WIDE_SHAPES:
        a, _ = edge_inputs(torch, B, N, DRUGS_H, torch.float32, sizes,
                           seed=B * N)
        coord = dict(a, em=None, bh=None)
        gk.reset_launch_counts()
        first = (gk.fused_edge_pass(**a, mode="gcl"),
                 gk.fused_edge_pass(**coord, mode="coord"))
        torch.cuda.synchronize()
        counts = {"launches": dict(gk.LAUNCHES), "passes": dict(gk.PASSES)}
        again = (gk.fused_edge_pass(**a, mode="gcl"),
                 gk.fused_edge_pass(**coord, mode="coord"))
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(first, again))
        log(f"[f32-wide] ({B}, {N}, {DRUGS_H}) one call a mode: "
            f"{json.dumps(counts)}; a second call bit-equal: {equal}")
        check(counts == {"launches": launch_counts(1, 1),
                         "passes": {"gcl": 0, "coord": 0, "gcl_wide": 1,
                                    "coord_wide": 1}},
              f"a wide f32 call is not one launch and one wide pass: "
              f"{counts}")
        check(equal, f"two wide f32 calls differ at ({B}, {N})")
        del first, again
        out += kernel_phase(torch, gk, B, N, sizes, card, H=DRUGS_H,
                            dtypes=("float32",))
        out += backward_kernel_phase(torch, gk, B, N, sizes, H=DRUGS_H)
        torch.cuda.empty_cache()
    for B, N, sizes in F32_DRUGS_SHAPES:
        out += kernel_phase(torch, gk, B, N, sizes, card, H=DRUGS_H,
                            dtypes=("float32",))
        out += backward_kernel_phase(torch, gk, B, N, sizes, H=DRUGS_H)
        torch.cuda.empty_cache()
    return out


def drugs_train_phase(torch, gk, B=64, largest=181, seed=24):
    """EDM GEOM-Drugs' train step at its published widths (float32, EGNN
    256 x 4) on one all-atom batch of ``B`` molecules, the largest of
    ``largest`` atoms and the others of 24-64 (padded to 184: every edge
    pass on the float32 wide kernels): two steps through the kernels, the
    first capturing the step's graph (its warm-up eager), the second
    replaying it, each from zeroed counts with one step's launches and wide
    passes; against the same two steps through the plain version (same
    weights, same draws, the loop), by each step's loss and by the worst
    parameter's gradient, its gap over the larger of its norm and the
    median parameter's (as the training cells compare). The GCLs'
    residual heads and the feature head damped as ``drugs_phase`` damps
    them. Returns the record."""
    import copy

    import numpy as np

    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.config import edm_geom_drugs
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import (AllAtomDataset,
                                                           init_train_state,
                                                           make_optimizer,
                                                           make_train_step)

    cfg, diff = edm_geom_drugs("float32")
    rng = np.random.default_rng(seed)
    sizes = [largest] + rng.integers(24, 65, B - 1).tolist()

    def chain(n):
        step = rng.standard_normal((n, 3))
        step *= rng.uniform(1.0, 1.5, (n, 1)) / np.linalg.norm(
            step, axis=1, keepdims=True)
        return np.cumsum(step, axis=0)

    ds = AllAtomDataset([Molecule(rng.choice([1, 6, 7, 8], size=n),
                                  chain(n), []) for n in sizes])
    batch = ds.featurize(list(range(B)))
    N = batch["x"].shape[1]
    gamma = torch.from_numpy(gamma_schedule(diff.timesteps,
                                            diff.noise_precision,
                                            diff.schedule_power))
    model_k = EGNNDynamics(cfg, torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        for name, p in model_k.named_parameters():
            if name.endswith(("node_mlp.2.weight", "embedding_out.weight")):
                p.mul_(1e-3)
    model_p = copy.deepcopy(model_k)
    routes = {"kernel": model_k, "plain": model_p}
    states = {r: init_train_state(m, make_optimizer(lr=1e-4))
              for r, m in routes.items()}
    steps = {r: make_train_step(make_mesh(device="cuda"), cfg, diff,
                                batch_shapes=ds.batch_shapes)
             for r in routes}
    gens = {r: torch.Generator(device="cuda").manual_seed(seed)
            for r in routes}
    blocks, gcls = cfg.n_blocks, cfg.n_blocks * cfg.inv_sublayers
    # remat: every forward pass twice (the forward and its recompute)
    want = launch_counts(2 * gcls, 2 * blocks, gcls, blocks)
    rec = {"phase": "drugs_train_step", "B": B, "N": N, "largest": largest,
           "width": cfg.hidden_nf, "blocks": blocks, "dtype": "float32",
           "steps": []}
    for k in range(2):
        gk.reset_launch_counts()
        mk = steps["kernel"](model_k, states["kernel"], gens["kernel"],
                             batch, gamma)
        torch.cuda.synchronize()
        counts = {"launches": dict(gk.LAUNCHES), "passes": dict(gk.PASSES)}
        with plain_edge_pass(gk), train_loop():
            mp = steps["plain"](model_p, states["plain"], gens["plain"],
                                batch, gamma)
        torch.cuda.synchronize()
        check(gk.LAUNCHES == counts["launches"],
              "the plain drugs step launched a kernel")
        norms = {n: p.grad.double().norm().item()
                 for n, p in model_p.named_parameters()}
        med = float(np.median(list(norms.values())))
        gaps = {n: ((pk.grad.double() - pp.grad.double()).norm().item()
                    / max(norms[n], med))
                for (n, pk), pp in zip(model_k.named_parameters(),
                                       model_p.parameters())}
        worst = max(gaps, key=gaps.get)
        loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
        step_rec = {"route": ("capture", "replay")[k], **counts,
                    "loss_kernel": loss_k, "loss_plain": loss_p,
                    "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
                    "grad_gap_max": gaps[worst], "grad_gap_worst": worst}
        rec["steps"].append(step_rec)
        log(f"[drugs-train] {json.dumps(step_rec)}")
        check(counts == {"launches": want,
                         "passes": {"gcl": 0, "coord": 0,
                                    "gcl_wide": 2 * gcls,
                                    "coord_wide": 2 * blocks}},
              f"a drugs step's counts {counts}, expected launches {want}, "
              f"every forward pass wide")
        check(step_rec["loss_rel_diff"] <= 1e-5,
              f"kernel and plain drugs losses: {step_rec}")
        check(gaps[worst] <= 1e-4, f"kernel and plain drugs gradients: "
              f"{step_rec}")
    check(steps["kernel"].graphs.captures == 1,
          "the second drugs step of the shape captured again")
    del routes, states, steps, model_k, model_p
    torch.cuda.empty_cache()
    return rec


# The float32 kernels' outputs at N <= 128 (forward and backward, both
# modes) in one checkout, digested, for ``--compare-f32``: MLCG's training
# and sampling shapes and the drugs training cell's pad 96. Plain torch
# inputs from a seed; the checkout is the working directory.
F32_DIGEST_SHAPES = [(64, 32, 420), (64, 39, 420), (16, 96, 256)]
_F32_DIGEST_RUN = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for B, N, H in json.loads(sys.argv[1]):
    g = torch.Generator().manual_seed(B * N + H)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).cuda()
    n = torch.randint(N // 2, N + 1, (B,), generator=g)
    nm = (torch.arange(N)[None] < n[:, None]).float()
    em = (nm[:, :, None] * nm[:, None, :] * (1 - torch.eye(N))).reshape(B, N * N, 1).cuda()
    w0 = r(H, 2 * H + 2, sc=H ** -0.5)
    a = dict(u=r(B, N, H), v=r(B, N, H), ef=r(B, N * N, 2), em=em, w_e=w0[:, 2 * H:],
             b0=r(H, sc=0.1), w1=r(H, H, sc=H ** -0.5), b1=r(H, sc=0.1),
             wh=r(H, sc=H ** -0.5), bh=r(1))
    for mode in ("gcl", "coord"):
        args = a if mode == "gcl" else dict(a, em=None, bh=None)
        up = r(B, N, H) if mode == "gcl" else r(B, N * N, 1)
        res = [gk.fused_edge_pass(**args, mode=mode)]
        res += [x for x in gk.fused_edge_pass_backward(**args, g=up, mode=mode) if x is not None]
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in res:
            h.update(x.contiguous().cpu().numpy().tobytes())
        out[f"{mode} {B} {N} {H}"] = h.hexdigest()[:16]
print("F32_DIGEST " + json.dumps(out), flush=True)
"""


def compare_f32(other):
    """The float32 kernels' outputs at ``F32_DIGEST_SHAPES`` in the checkout
    at ``other`` and in this one: every digest must be equal."""
    found = {}
    for name, root in (("other", other), ("this", ROOT)):
        p = subprocess.run([sys.executable, "-c", _F32_DIGEST_RUN,
                            json.dumps(F32_DIGEST_SHAPES)], cwd=root,
                           capture_output=True, text=True, timeout=900)
        line = [l for l in p.stdout.splitlines()
                if l.startswith("F32_DIGEST ")]
        check(p.returncode == 0 and line,
              f"{name} {root} failed:\n{(p.stdout + p.stderr)[-3000:]}")
        found[name] = json.loads(line[0][len("F32_DIGEST "):])
        log(f"[f32-compare] {name}: {json.dumps(found[name])}")
    check(found["other"] == found["this"],
          "the float32 kernels' outputs at N <= 128 differ from the other "
          "checkout's")
    log("[f32-compare] bit-equal at N <= 128: "
        f"{sorted(found['this'])}")
    return found


def drugs_phase(torch, gk, n_samples=16, n_atoms=181):
    """EDM GEOM-Drugs' front end on the card: ``EDMGenerator.sample`` of
    ``n_samples`` molecules of ``n_atoms`` atoms (bucket 184: every edge
    pass on the wide path) twice, the first capturing the trajectory's graph
    (with its warm-up forwards), the second replaying it, each with exact
    launches and wide passes; every molecule of the asked size with finite
    positions. Then one denoiser forward at that shape through the kernel
    against the same forward through the plain version. Random weights from
    a seed, the GCLs' residual heads and the feature head damped as the
    benchmark's drugs weights are (``benchmark/drugs.py``): at PyTorch's
    default scale an untrained denoiser's unnormalised sums over 180
    neighbours compound through 1000 steps into non-finite positions."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.generator import EDMGenerator
    from ml_conformer_generator_tpu_torch.models.egnn import dynamics_forward
    from ml_conformer_generator_tpu_torch.utils.masks import (pad_to_bucket,
                                                              prepare_masks)

    gen = EDMGenerator(seed=5, device="cuda")
    dyn, cfg = gen.sampler.dynamics, gen.egnn_cfg
    with torch.no_grad():
        for name, p in dyn.named_parameters():
            if name.endswith(("node_mlp.2.weight", "embedding_out.weight")):
                p.mul_(1e-3)
    forwards = gen.diff_cfg.timesteps + 1
    rec = {"B": n_samples, "atoms": n_atoms,
           "N": pad_to_bucket(n_atoms, gen.node_bucket)}
    for k, name in enumerate(("capture", "replay")):
        mols, launches, secs = launches_of(
            torch, gk, lambda: gen.sample(n_samples, n_atoms))
        f = forwards + (WARMUP_FORWARDS["generate"] if k == 0 else 0)
        rec[name] = {"launches": launches, "passes": dict(gk.PASSES),
                     "seconds": secs,
                     "edm_sampling_s": gen.last_metrics["edm_sampling_s"]}
        log(f"[drugs] {json.dumps(rec)}")
        blocks = cfg.n_blocks
        check(launches == launch_counts(blocks * cfg.inv_sublayers * f,
                                        blocks * f),
              f"drugs {name}: launches {launches}, {f} forwards")
        check(rec[name]["passes"] == {
            "gcl": 0, "coord": 0, "gcl_wide": blocks * cfg.inv_sublayers * f,
            "coord_wide": blocks * f},
              f"drugs {name}: passes {rec[name]['passes']}")
        check(len(mols) == n_samples
              and all(m.num_atoms == n_atoms for m in mols),
              f"drugs {name}: atom counts {[m.num_atoms for m in mols]}")
        check(all(np.isfinite(m.coords).all() for m in mols),
              f"drugs {name}: non-finite positions")

    g = torch.Generator().manual_seed(6)
    B, N = n_samples, rec["N"]
    node_mask, edge_mask = prepare_masks(torch.full((B,), n_atoms), N)
    node_mask, edge_mask = node_mask.cuda(), edge_mask.cuda()
    xh = torch.randn(B, N, 3 + gen.diff_cfg.in_node_nf, generator=g).cuda()
    xh = xh * node_mask
    ctx = node_mask.new_zeros(B, N, 0)
    t = torch.full((B,), 0.5, device="cuda")
    with torch.no_grad():
        out_k = dynamics_forward(dyn, t, xh, node_mask, edge_mask, ctx)
        with plain_edge_pass(gk):
            out_p = dynamics_forward(dyn, t, xh, node_mask, edge_mask, ctx)
    err = (out_k.float() - out_p.float()).abs()
    rec["forward"] = {"max_abs_err": err.max().item(),
                      "ref_max_abs": out_p.abs().max().item(),
                      "ref_mean_abs": out_p.abs().mean().item()}
    log(f"[drugs] {json.dumps(rec['forward'])}")
    check(torch.isfinite(out_k).all().item(), "non-finite drugs forward")
    check((err <= 5e-2 + 5e-2 * out_p.float().abs()).all().item(),
          "drugs forward: kernel disagrees with plain beyond 5e-2")
    del gen
    torch.cuda.empty_cache()
    return rec


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
# The bf16 kernel's are marks (clock readings), (block, warpgroup, tile,
# mark); these are the intervals between its consecutive marks. The float32
# kernel's are clock sums a block.
PHASES = {"bfloat16": ["build_m1", "product_half0", "epilogue_half0",
                       "product_half1", "epilogue_half1", "gate_and_store",
                       "jsum_and_tile_end"],
          "float32": ["tile_rows", "product_half0", "epilogue_half0",
                      "product_half1", "epilogue_half1",
                      "gate_and_jsum_half0", "jsum_half1_and_tile_end"]}
BF16_MARKS, BF16_PROF_TILES = len(PHASES["bfloat16"]) + 1, 16
# Before the marks, the bf16 kernel summed the clocks of each block's first
# thread into 8 slots, in the order of PHASES["bfloat16"].
SUMMED_SLOTS = 8
# The shapes of the bf16 kernel's profile: the sampling cells' node buckets
# at 64 samples, and the production shape.
BF16_PROFILE_SHAPES = [(64, 24, (17, 24)), (64, 32, (25, 32)),
                       (64, 40, (33, 39)), (128, 40, (15, 39))]
# ... and for the timing against another checkout, the interactive cell's
# (10 samples) and the other shapes of PERF.md's kernel table too.
BF16_COMPARE_SHAPES = BF16_PROFILE_SHAPES + [
    (10, 24, (17, 24)), (10, 32, (25, 32)), (10, 40, (33, 39)),
    (8, 128, (100, 128)), (128, 42, (25, 39)), (5, 40, (15, 39))]


def warpgroup_clocks(marks):
    """What the bf16 kernel's clock marks (int64, (blocks, 2, tiles,
    BF16_MARKS)) say, over the blocks' recorded tiles: each warpgroup's
    mean clocks a tile by phase, the block's wall clocks a tile, and
    ``hidden_share``: the part of each warpgroup's product during which the
    other warpgroup was in an elementwise phase (building m1, an epilogue,
    the gate or the j-sum), over all product clocks. In lock-step (the two
    in their products together) it is about 0."""
    import numpy as np

    m = np.asarray(marks, dtype=np.float64)
    ran = (m[:, :, :, 0] != 0).all(axis=1)          # (blocks, tiles)
    names = PHASES["bfloat16"]
    dur = np.diff(m, axis=3)           # (blocks, 2, tiles, phases): [k, k + 1]
    tiles = ran.sum()
    by_wg = [{n: float((dur[:, w, :, k] * ran).sum() / tiles)
              for k, n in enumerate(names)} for w in range(2)]
    # Phase k lies between marks k and k + 1.
    prods = [(k, k + 1) for k, n in enumerate(names) if n.startswith("product")]
    elem = [(k, k + 1) for k, n in enumerate(names)
            if not n.startswith("product")]
    wall = hidden = product = 0.0
    for blk in range(m.shape[0]):
        n = int(ran[blk].sum())
        if n == 0:
            continue
        mb = m[blk, :, :n]
        wall += mb[:, :, len(names)].max() - mb[:, 0, 0].min()
        for w in range(2):
            p = np.concatenate([mb[w][:, list(a)] for a in prods])
            e = np.concatenate([mb[1 - w][:, list(a)] for a in elem])
            product += (p[:, 1] - p[:, 0]).sum()
            lo = np.maximum(p[:, None, 0], e[None, :, 0])
            hi = np.minimum(p[:, None, 1], e[None, :, 1])
            hidden += np.clip(hi - lo, 0, None).sum()
    return {"tiles_recorded": int(tiles),
            "wall_clocks_per_tile": wall / tiles,
            "clocks_per_tile": [{n: int(c) for n, c in d.items()}
                                for d in by_wg],
            "hidden_share": hidden / product}


def phase_clocks(torch, gk, B, N, sizes, dtype, H=420):
    """Where a block of the kernel of ``dtype`` spends its clocks: one
    launch per mode through the library's C entry with its optional clock
    buffer (the package's wrapper always passes none). bf16: each
    warpgroup's phases and the share of the product hidden behind the other
    warpgroup's elementwise work (``warpgroup_clocks``); a library with the
    earlier 8 summed slots gives their sums. float32: the first thread
    of each block adds the SM's clocks between phases; the product phases
    include building m1, which overlaps the products. Only with
    ``--profile`` and in ``--compare-bf16``. Returns one record per mode."""
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
    recs = []
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
        rec = {"phase_clocks": {"B": B, "N": N, "H": H, "mode": mode,
                                "dtype": name}}
        if bf16 and slots() != SUMMED_SLOTS:
            rec.update(warpgroup_clocks(clocks.view(
                sms, 2, BF16_PROF_TILES, BF16_MARKS).cpu().numpy()))
        else:
            names = PHASES[name]
            per_block = clocks.sum(0).double() / clocks.shape[0]
            total = per_block.sum().item()
            rec["clocks_per_block"] = {n: int(c) for n, c in
                                       zip(names, per_block.tolist())}
            rec["share"] = {n: round(c / total, 4) for n, c in
                            zip(names, per_block.tolist())}
        log("[profile] " + json.dumps(rec))
        recs.append(rec)
    return recs


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


# The denoiser calls a trajectory's capture makes for real before it records
# the graph (utils/cuda_graph.py): the warm-up runs the first reverse step
# (with its resample and blend) and the decode. A request whose trajectory
# shape the sampler has not captured yet makes them besides the replay's.
WARMUP_FORWARDS = {"generate": 1 + 1, "inpaint": 1 + 1 + 1,
                   "merge": 1 + 1}


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
    seeded_request(torch, gk, gen, kw, seed=13)             # warm-up
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
    127.0.0.1 (port 0): health names the card; three 64-sample generate
    requests with the reference as a mol block (the first builds the
    server's generator and captures its graph), each status 200 with JAX's
    keys and 27 launches a forward (the first also its capture's
    warm-up)."""
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
                 for _ in range(3)]
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
    for k, (r, ((_, out), _, _)) in enumerate(zip(recs, posts)):
        check(r["status"] == 200, f"generate status {r['status']}")
        check(set(out) == APP_KEYS and set(out["metrics"]) == APP_METRICS,
              f"response keys {r['keys']} / {sorted(out['metrics'])}")
        check(out["metrics"]["requested"] == N_SAMPLES,
              f"requested {out['metrics']['requested']}")
        # the first request builds the generator and captures its graph
        check(r["launches"] == forward_launches(
            STEPS + 1 + (WARMUP_FORWARDS["generate"] if k == 0 else 0)),
              f"app request {k} launches {r['launches']}")
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


def relax_inputs(torch, mols, device, dtype):
    """(x0, topology) of ``mols`` on ``device`` in ``dtype``, as
    ``optimize_geometry`` sets them up."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem import forcefield

    n_pad = forcefield._pad8(max(m.num_atoms for m in mols))
    ff = forcefield.build_ff_batch(mols, n_pad)
    x0 = np.zeros((len(mols), n_pad, 3), np.float64)
    for b, m in enumerate(mols):
        x0[b, :m.num_atoms] = m.coords
    return (torch.tensor(x0, device=device, dtype=dtype),
            forcefield.to_device(ff, device, dtype))


def relax_batch(torch, mols, device, dtype, loop=False):
    """``forcefield.relax`` of ``mols`` on ``device`` in ``dtype`` (on the
    card a captured graph), or with ``loop`` its steps as a loop
    (``fire_steps``): the coordinates (B, N, 3) float64 on the host and
    the (steps, B) branch history (P < 0)."""
    from ml_conformer_generator_tpu_torch.chem import forcefield

    x0, ff = relax_inputs(torch, mols, device, dtype)
    steps = []
    with torch.no_grad():
        if loop:
            x = forcefield.fire_steps(x0, ff, 200,
                                      lambda k, uphill: steps.append(uphill))
        else:
            x = forcefield.relax(x0, ff, uphill_log=steps)
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


def backward_bars(torch, got, ref, mode, what):
    """Hold the gradients ``got`` of a backward call to ``ref`` (both in
    ``GRAD_NAMES`` order): du, dv and de per element within BWD_ATOL +
    BWD_RTOL |ref|, the weight sums within BWD_SUM_RTOL of their largest
    entry. Returns (errors by name, worst element error, worst weight-sum
    relative error)."""
    errors, worst_elem, worst_sum = {}, 0.0, 0.0
    for name, x, r in zip(GRAD_NAMES, got, ref):
        if r is None:
            check(x is None and mode == "coord", f"{name}: no gradient")
            continue
        check(x.shape == r.shape and torch.isfinite(x).all().item(),
              f"{what} {mode} {name}: shape or non-finite")
        err = (x - r).abs()
        errors[name] = {"max_abs_err": err.max().item(),
                        "ref_max_abs": r.abs().max().item()}
        if name in ("du", "dv", "de"):
            excess = (err - BWD_ATOL - BWD_RTOL * r.abs()).max().item()
            worst_elem = max(worst_elem, err.max().item())
            check(excess <= 0.0, f"{what} disagrees in {name}: {errors}")
        else:
            rel = err.max().item() / r.abs().max().item()
            worst_sum = max(worst_sum, rel)
            check(rel <= BWD_SUM_RTOL, f"{what} disagrees in {name}: "
                  f"{errors}")
    return errors, worst_elem, worst_sum


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
        errors, worst_elem, worst_sum = backward_bars(
            torch, got, ref, mode, "backward kernel against plain")
        rec.update(errors)
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
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import (batches,
                                                           edm_training_loss,
                                                           init_train_state,
                                                           make_optimizer,
                                                           make_train_step)

    cfg, diff = EGNNConfig(), DiffusionConfig()
    batch = next(batches(ds, TRAIN_B, rng=np.random.default_rng(0),
                         n_pad=TRAIN_N))
    gamma = torch.from_numpy(gamma_schedule(diff.timesteps))
    step = make_train_step(make_mesh(device="cuda"), cfg, diff)
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
    with plain_edge_pass(gk), train_loop():
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
    # a second kernel step, a replay of the step's graph: the optimizer
    # moved every W1, so each repacks inside the graph
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
    # the new generator's first request also warms up its capture
    check(req_launches == forward_launches(STEPS + 1
                                           + WARMUP_FORWARDS["generate"]),
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


# -- 14. the j-slab edge kernels ------------------------------------------------

# (B, N, N_l, graph sizes) of the slab checks: slabs of the request's 32
# nodes (two and four ranks), of the training batch's 40 (two ranks), a
# last tile that is not full (5 graphs), the most nodes a tile holds; the
# backward at the training batch's 40 and 39 nodes (three ranks) and at 128.
SLAB_FWD = [(64, 32, 16, (23, 27)), (64, 32, 8, (23, 27)),
            (64, 40, 20, (15, 39)), (5, 40, 20, (15, 39)),
            (8, 128, 64, (100, 128))]
SLAB_BWD = [(64, 40, 20, (15, 39)), (64, 39, 13, (15, 39)),
            (8, 128, 64, (100, 128))]


def slab_args(args, NL, i, mode):
    """Slab ``i`` of ``NL`` source nodes of a square edge pass's operands:
    v's rows and the edges (i, j) of the slab, as ``parallel/edge_shard.py``
    gives a rank."""
    B, N, H = args["u"].shape
    cols = slice(i * NL, (i + 1) * NL)

    def cut(t, width):
        return t.reshape(B, N, N, width)[:, :, cols].reshape(
            B, N * NL, width).contiguous()

    out = dict(args, v=args["v"][:, cols].contiguous(),
               ef=cut(args["ef"], args["ef"].shape[-1]))
    if mode == "gcl":
        out["em"] = cut(args["em"], 1)
    return out


def slab_phase(torch, gk, B, N, NL, sizes, backward, H=420):
    """The float32 forward (or with ``backward`` the backward) kernel on
    each j-slab of one (B, N) edge set, both modes: each slab's call
    against the plain version on the same slab (the unloosened bars), the
    slabs put back together (gcl outputs and du summed, coord, de and dv
    concatenated, weight sums summed) against the N_l = N call within the
    same bars, exact launches, a second call bit-equal, and the first
    slab's kernel, plain and library times beside its bound. Returns one
    record per mode."""
    out = []
    a, _ = edge_inputs(torch, B, N, H, torch.float32, sizes,
                       seed=B * N + NL)
    g = torch.Generator().manual_seed(B + N + NL)
    for mode in ("gcl", "coord"):
        args = dict(a)
        if mode == "coord":
            args["em"], args["bh"] = None, None
        up = torch.randn(*((B, N, H) if mode == "gcl" else (B, N, N)),
                         generator=g).cuda()

        def up_of(i):
            if mode == "gcl":
                return up
            return up[:, :, i * NL:(i + 1) * NL].reshape(
                B, N * NL, 1).contiguous()

        slabs = [slab_args(args, NL, i, mode) for i in range(N // NL)]
        if backward:
            call = lambda s, i: gk.fused_edge_pass_backward(
                **s, g=up_of(i), mode=mode)
            plain = lambda s, i: gk.fused_edge_pass_backward_reference(
                **s, g=up_of(i), mode=mode)
        else:
            call = lambda s, i: gk.fused_edge_pass(**s, mode=mode)
            plain = lambda s, i: gk.fused_edge_pass_reference(**s, mode=mode)
        rec = {"kernel": "edge_mlp_bwd_f32" if backward else "edge_mlp_f32",
               "slab": True, "mode": mode, "B": B, "N": N, "NL": NL, "H": H,
               "slabs": len(slabs)}
        gk.reset_launch_counts()
        got = [call(s, i) for i, s in enumerate(slabs)]
        torch.cuda.synchronize()
        rec["launches"] = dict(gk.LAUNCHES)
        key = f"{mode}_bwd" if backward else mode
        check(rec["launches"] == launch_counts(**{key: len(slabs)}),
              f"slab launches {rec}")
        worst = 0.0
        for i, (s, x) in enumerate(zip(slabs, got)):
            ref = plain(s, i)
            if backward:
                _, elem, sums = backward_bars(torch, x, ref, mode,
                                              f"slab {i} backward")
                worst = max(worst, elem)
                rec["weight_sums_max_rel_err"] = max(
                    rec.get("weight_sums_max_rel_err", 0.0), sums)
            else:
                err = (x - ref).abs()
                check((err <= 1e-5 + 1e-4 * ref.abs()).all().item(),
                      f"slab {i} disagrees with plain: {err.max().item()}")
                worst = max(worst, err.max().item())
        rec["max_abs_err"] = worst
        # the slabs of one pass put back together against the N_l = N call
        full = (gk.fused_edge_pass_backward(**args, g=up if mode == "gcl"
                                            else up.reshape(B, N * N, 1),
                                            mode=mode)
                if backward else gk.fused_edge_pass(**args, mode=mode))
        if backward:
            parts = list(zip(*got))
            E = args["ef"].shape[-1]
            joined = [sum(parts[0]), torch.cat(parts[1], 1),
                      torch.cat([d.reshape(B, N, NL, E) for d in parts[2]],
                                2).reshape(B, N * N, E)]
            joined += [None if p[0] is None else sum(p) for p in parts[3:]]
            _, elem, sums = backward_bars(torch, joined, full, mode,
                                          "slabs put together")
            rec["rejoined_max_abs_err"] = elem
            rec["rejoined_weight_sums_max_rel_err"] = sums
        else:
            joined = (sum(got) if mode == "gcl" else torch.cat(
                [x.reshape(B, N, NL) for x in got], 2).reshape(B, N * N, 1))
            err = (joined - full).abs()
            check((err <= 1e-5 + 1e-4 * full.abs()).all().item(),
                  f"slabs put together disagree: {err.max().item()}")
            rec["rejoined_max_abs_err"] = err.max().item()
        again = call(slabs[0], 0)
        torch.cuda.synchronize()
        first = got[0] if backward else (got[0],)
        rec["bit_equal_twice"] = all(
            (x is None and y is None) or torch.equal(x, y)
            for x, y in zip(first, again if backward else (again,)))
        check(rec["bit_equal_twice"], f"two slab calls differ: {rec}")
        del got, full, again
        x = torch.randn(B * N * NL, H, device="cuda")
        y = torch.randn(B * N * NL, H, device="cuda")
        w1 = args["w1"]
        s0 = slabs[0]
        rec["kernel_ms"] = cuda_ms(torch, lambda: call(s0, 0), iters=10)
        rec["plain_ms"] = cuda_ms(torch, lambda: plain(s0, 0), iters=3)
        rec["library_ms"] = cuda_ms(
            torch, (lambda: (x @ w1.t(), y @ w1, y.t() @ x)) if backward
            else (lambda: x @ w1.t()), iters=10)
        del x, y
        bound_ms, bound_by = edge_pass_bound(B, N, H, 2, "float32", mode,
                                             backward=backward, NL=NL)
        rec["bound_ms"], rec["bound_by"] = bound_ms, bound_by
        rec["share_of_bound"] = bound_ms / rec["kernel_ms"]
        log(f"[slab] {json.dumps(rec)}")
        out.append(rec)
    return out


# -- 15. the sharded paths: two gloo ranks on the one card ---------------------

# The sharded forward's bar against the one-rank run, per element: the
# f32 kernels' bar (the j-sums' order differs: two slabs and an
# all-reduce). The sampler's bar is relative to its largest coordinate:
# max |dx| <= 1e-6 max |x| (about 8 float32 units in the last place of
# that coordinate), since its random-weight coordinates grow to the
# hundreds in T steps. Each bar is checked to refuse two controls: the
# same work with the other rank's slab dropped from the sum, and the
# one-rank work in bfloat16.
SHARDED_ATOL, SHARDED_RTOL = 1e-5, 1e-4
SAMPLER_REL = 1e-6
SHARDED_T = 10


def sharded_rank(workdir):
    """One of two ranks of a (1 data, 2 edge) mesh on the card, over gloo
    (NCCL refuses two ranks on one device; gloo all-reduces and broadcasts
    CUDA tensors): at full width, float32, the sharded forward (B = 64,
    N = 32), ``make_sharded_generate`` (T = 10) and two ``make_train_step``
    steps (B = 64, N = 40, the batch in ``workdir``), each against the same
    work on a one-rank mesh in this process, launches counted around each
    sharded run. Writes ``rank{r}.json``; any failed check raises."""
    import copy
    import dataclasses
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from ml_conformer_generator_tpu_torch.config import (CONTEXT_NORMS,
                                                         DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import (
        EGNNDynamics, dynamics_forward)
    from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
    from ml_conformer_generator_tpu_torch.parallel import (
        data_sharding, dynamics_forward_sharded, make_mesh,
        make_sharded_generate)
    from ml_conformer_generator_tpu_torch.parallel.sampler import data_stream
    from ml_conformer_generator_tpu_torch.training import (init_train_state,
                                                           make_optimizer,
                                                           make_train_step)
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_edm_input

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    mesh = make_mesh((1, 2), device="cuda", backend="gloo")
    one = make_mesh((1, 1), devices=[rank], device="cuda")
    # gloo takes CUDA tensors in all_reduce: checked here first
    probe = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(probe, group=mesh.edge_group)
    check(probe.device.type == "cuda" and probe.eq(3.0).all().item(),
          f"gloo all_reduce of a CUDA tensor gave {probe}")
    cfg, diff = EGNNConfig(), DiffusionConfig(timesteps=SHARDED_T)
    dyn = EGNNDynamics(cfg, torch.Generator().manual_seed(31)).cuda()
    rec = {"rank": rank, "mesh": dict(mesh.shape), "edge_index":
           mesh.edge_index, "backend": "gloo", "device":
           torch.cuda.get_device_name(0)}

    def counted(fn):
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(gk.LAUNCHES), time.perf_counter() - t0

    def close(a, b):
        err = (a - b).abs()
        ok = (err <= SHARDED_ATOL + SHARDED_RTOL * b.abs()).all().item()
        return ok, err.max().item(), b.abs().max().item()

    def close_x(a, b):
        err, ref = (a - b).abs().max().item(), b.abs().max().item()
        return err <= SAMPLER_REL * ref, err, ref

    # the controls: each rank's own slab alone (the edge all-reduce over a
    # group of one), and a bfloat16 copy of the weights on one rank
    solo = [dist.new_group([r], backend="gloo") for r in range(2)][rank]
    dropped = dataclasses.replace(mesh, edge_group=solo)
    dyn16 = copy.deepcopy(dyn).to(torch.bfloat16)

    # 15a. the forward, B = 64, N = 32, graphs of 23-27 nodes
    g = torch.Generator().manual_seed(32)
    node_mask, edge_mask, context = (t.cuda() for t in prepare_edm_input(
        g, 64, [105.0766, 473.1938, 537.4675], CONTEXT_NORMS, 23, 27,
        n_nodes_pad=32)[:3])
    xh = torch.randn(64, 32, 11, generator=g).cuda() * node_mask
    t = torch.full((64,), 0.5, device="cuda")
    slab = data_sharding(mesh, None, "edge")
    with torch.no_grad():
        dense = dynamics_forward(dyn, t, xh, node_mask, edge_mask, context)
        out, launches, secs = counted(lambda: dynamics_forward_sharded(
            dyn, t, xh, node_mask, slab(edge_mask), context, None, mesh))
        out_dropped = dynamics_forward_sharded(
            dyn, t, xh, node_mask, slab(edge_mask), context, None, dropped)
        out16 = dynamics_forward(dyn16, t, xh, node_mask, edge_mask,
                                 context).float()
    ok, err, ref = close(out, dense)
    ok_dropped, err_dropped, _ = close(out_dropped, dense)
    ok16, err16, _ = close(out16, dense)
    rec["forward"] = {"B": 64, "N": 32, "NL": 16, "launches": launches,
                      "max_abs_err": err, "ref_max_abs": ref,
                      "bar": [SHARDED_ATOL, SHARDED_RTOL],
                      "control_slab_dropped_max_abs_err": err_dropped,
                      "control_bf16_max_abs_err": err16, "s": secs}
    check(ok, f"sharded forward against one rank: {rec['forward']}")
    check(not ok_dropped and not ok16,
          f"the forward's bar passes a control: {rec['forward']}")
    check(launches == launch_counts(2 * cfg.n_blocks, cfg.n_blocks),
          f"sharded forward launches {launches}")

    # 15b. the sampler, T = 10, against the dense one on data row 0's stream
    gamma = torch.from_numpy(gamma_schedule(SHARDED_T))
    fn = make_sharded_generate(mesh, cfg, diff)
    (xs, hs), launches, secs = counted(lambda: fn(
        dyn, torch.Generator().manual_seed(33), gamma, node_mask, edge_mask,
        context))
    xd, hd = EDMSampler(dyn, diff).generate(
        data_stream(torch.Generator().manual_seed(33), 0, "cuda"), gamma,
        node_mask, edge_mask, context)
    xs_dropped, _ = make_sharded_generate(dropped, cfg, diff)(
        dyn, torch.Generator().manual_seed(33), gamma, node_mask, edge_mask,
        context)
    x16, _ = EDMSampler(dyn16, diff).generate(
        data_stream(torch.Generator().manual_seed(33), 0, "cuda"), gamma,
        node_mask, edge_mask, context)
    ok, err, ref = close_x(xs, xd)
    ok_dropped, err_dropped, _ = close_x(xs_dropped, xd)
    ok16, err16, _ = close_x(x16.float(), xd)
    rec["generate"] = {"T": SHARDED_T, "launches": launches,
                       "max_abs_err": err, "ref_max_abs": ref,
                       "bar_rel_to_max": SAMPLER_REL,
                       "control_slab_dropped_max_abs_err": err_dropped,
                       "control_bf16_max_abs_err": err16,
                       "h_equal": torch.equal(hs, hd), "s": secs}
    check(ok and rec["generate"]["h_equal"],
          f"sharded sampler against one rank: {rec['generate']}")
    check(not ok_dropped and not ok16,
          f"the sampler's bar passes a control: {rec['generate']}")
    check(launches == forward_launches(SHARDED_T + 1),
          f"sharded sampler launches {launches}")

    # 15c. two train steps, (1, 2) against (1, 1): same weights and draws
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    step_s = make_train_step(mesh, cfg, diff)
    step_1 = make_train_step(one, cfg, diff)
    model_s = EGNNDynamics(cfg, torch.Generator().manual_seed(41)).cuda()
    model_1 = copy.deepcopy(model_s)
    state_s = init_train_state(model_s, make_optimizer(lr=1e-4))
    state_1 = init_train_state(model_1, make_optimizer(lr=1e-4))
    steps = []
    for seed in (5, 6):
        ms, launches, secs = counted(lambda: step_s(
            model_s, state_s, torch.Generator(device="cuda").manual_seed(seed),
            batch, gamma))
        m1, _, secs_1 = counted(lambda: step_1(
            model_1, state_1, torch.Generator(device="cuda").manual_seed(seed),
            batch, gamma))
        rel = {n: ((ps.grad - p1.grad).norm() / p1.grad.norm()).item()
               for (n, ps), p1 in zip(model_s.named_parameters(),
                                      model_1.parameters())}
        worst = max(rel, key=rel.get)
        loss_s, loss_1 = float(ms["loss"]), float(m1["loss"])
        steps.append({"launches": launches, "loss_sharded": loss_s,
                      "loss_one_rank": loss_1,
                      "loss_rel_diff": abs(loss_s - loss_1) / abs(loss_1),
                      "grad_rel_norm_max": rel[worst],
                      "grad_rel_norm_worst": worst, "s_sharded": secs,
                      "s_one_rank": secs_1})
        check(steps[-1]["loss_rel_diff"] <= 1e-5
              and rel[worst] <= 1e-4, f"sharded step: {steps[-1]}")
        check(launches == launch_counts(4 * cfg.n_blocks, 2 * cfg.n_blocks,
                                        2 * cfg.n_blocks, cfg.n_blocks),
              f"sharded step launches {launches}")
    params_rel = max(((ps - p1).norm() / p1.norm()).item() for ps, p1 in zip(
        model_s.parameters(), model_1.parameters()))
    check(params_rel <= 1e-4, f"parameters after two steps: {params_rel}")
    digest = hashlib.sha256()
    for p in model_s.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    rec["train"] = {"B": int(batch["x"].shape[0]),
                    "N": int(batch["x"].shape[1]), "NL": 20, "steps": steps,
                    "params_rel_norm_max": params_rel,
                    "params_sha256": digest.hexdigest()}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def sharded_phase(torch, ds, workdir):
    """Phase 15: ``sharded_rank`` on two gloo ranks on this card (each
    process reuses the kernels built in ``build/kernels/``); a rank's
    failure fails the phase. Checks that both ranks end with equal
    parameters. Returns rank 0's record."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.parallel.launch import spawn
    from ml_conformer_generator_tpu_torch.training import batches

    # phase 13's corpus, padded by a masked node to 40 (two slabs of 20)
    batch = next(batches(ds, TRAIN_B, rng=np.random.default_rng(1),
                         n_pad=40))
    np.savez(os.path.join(workdir, "batch.npz"), **batch)
    t0 = time.perf_counter()
    spawn(sharded_rank, 2, [workdir], backend="gloo", timeout=600)
    recs = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
        log(f"[sharded] {json.dumps(recs[-1])}")
    check(recs[0]["train"]["params_sha256"] == recs[1]["train"]
          ["params_sha256"], "the two ranks end with other parameters")
    log(f"[sharded] two ranks on one card: {time.perf_counter() - t0:.1f} s "
        f"with start-up; both ranks' parameters equal after two steps")
    return recs[0]


# -- 16. the screening driver ------------------------------------------------------

SCREEN_SIZES = (25, 24, 22, 20)     # heavy atoms of the K references


# Depth 1 against depth 2 on the surviving batch: atoms, bonds, counts and
# buckets equal; coordinates (written with 4 decimals in the mol blocks)
# within one unit of the last decimal and scores within 1e-6, since the
# relaxation's gradient on the card sums in no fixed order (the H100's
# readings: 1.0e-4 and 1.8e-7).
SURVIVOR_COORD_BAR, SURVIVOR_SCORE_BAR = 1.5e-4, 1e-6
SURVIVOR_SAMPLES = 16               # copies of each reference
AOT_BATCH = 32                      # the exported sampler's batch (phase 17)


def report_differences(a, b):
    """How far two ``EvaluationReport``s of the same samples differ: whether
    their molecules' atoms and bonds, their counts and their buckets' keys
    and sizes are equal, and the largest difference of a coordinate and of
    a score."""
    import numpy as np

    def structure(rep):
        return ([(m.atomic_nums.tolist(), sorted(map(tuple, m.bonds)))
                 for m in rep.samples],
                rep.n_valid, rep.unique_within_batch,
                {k: v["n"] for k, v in rep.by_ref_size.items()},
                {k: v["n"] for k, v in rep.by_variance.items()})

    def scores(rep):
        return ([rep.avg_shape_tanimoto, rep.avg_chemical_tanimoto,
                 rep.max_shape_tanimoto]
                + [v[k] for d in (rep.by_ref_size, rep.by_variance)
                   for _, v in sorted(d.items())
                   for k in ("shape_tanimoto", "chemical_tanimoto")])

    same = structure(a) == structure(b)
    coords = max((float(np.abs(np.asarray(m.coords) - np.asarray(n.coords))
                        .max()) for m, n in zip(a.samples, b.samples)),
                 default=0.0) if same else float("inf")
    score = (float(np.abs(np.subtract(scores(a), scores(b))).max())
             if same else float("inf"))
    return {"same_molecules_and_counts": same, "coords_max_abs_diff": coords,
            "scores_max_abs_diff": score}


def copies_as_samples(mols):
    """Molecules as one sampler output (x, h, node_mask), numpy float32:
    centred coordinates, one-hot atom classes, padded to the largest."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem import periodic
    from ml_conformer_generator_tpu_torch.config import (ATOM_ENCODER,
                                                         NUM_ATOM_CLASSES)

    B, N = len(mols), max(m.num_atoms for m in mols)
    x = np.zeros((B, N, 3), np.float32)
    h = np.zeros((B, N, NUM_ATOM_CLASSES), np.float32)
    node_mask = np.zeros((B, N, 1), np.float32)
    for b, m in enumerate(mols):
        n, c = m.num_atoms, np.asarray(m.coords)
        x[b, :n] = c - c.mean(axis=0)
        h[b, np.arange(n), [ATOM_ENCODER[periodic.symbol(int(z))]
                            for z in m.atomic_nums]] = 1.0
        node_mask[b, :n] = 1.0
    return x, h, node_mask


def distance_bonds(model, elements, dist_mat, adj_mat):
    """A stand-in for ``predict_bond_types``: single bonds wherever the
    featurised adjacency (bonds from distances) has one, so that samples
    survive standardisation, which random bond-predictor weights never
    let them do."""
    import torch

    eye = torch.eye(adj_mat.shape[-1], dtype=adj_mat.dtype,
                    device=adj_mat.device)
    return (adj_mat - eye).to(torch.int8)


def screening_phase(torch, gk, gen):
    """``ScreeningDriver(gen)`` on the card (the default bf16 generator at
    full width, the one-rank mesh): K = 4 references (the reference cut to
    SCREEN_SIZES atoms), 64 samples, 100 steps, in turns a serial loop of
    ``generate_conformers``, the screen at queue depth 1 and 2, the serial
    loop again, each from the same generator state: equal samples and
    molecules, K x 101 x 27 launches each; then the screen with scoring at
    depth 1 and 2 on a batch that survives (copies of each reference in
    place of the sampler's output, bonds from distances): the same
    molecules and reports (within SURVIVOR_*_BAR); then ``screen_iter``
    broken off after the first reference."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem.mol import Molecule
    from ml_conformer_generator_tpu_torch.parallel import ScreeningDriver

    refs = [Molecule([z for z, *_ in _REFERENCE[:n]],
                     [xyz for _, *xyz in _REFERENCE[:n]], [])
            for n in SCREEN_SIZES]
    kw = dict(n_samples=N_SAMPLES, variance=VARIANCE)
    drv = ScreeningDriver(gen)
    sample = drv._sample
    K = len(refs)
    want = forward_launches(K * (STEPS + 1))

    def key(m):
        return (m.atomic_nums.tolist(), m.coords.tolist(),
                sorted(map(tuple, m.bonds)))

    def serial_loop():
        got = recorded(gen)
        gen._generator.manual_seed(21)
        mols, secs = [], []
        gk.reset_launch_counts()
        for r in refs:
            t0 = time.perf_counter()
            mols += [key(m) for m in gen.generate_conformers(
                reference_conformer=r, **kw)]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        del gen.sampler.generate            # recorded()'s wrappers
        samples = [(x.cpu().numpy(), h.cpu().numpy()) for x, h, _ in got]
        return {"samples": samples, "molecules": mols,
                "launches": dict(gk.LAUNCHES), "seconds": secs,
                "sum_s": sum(secs)}

    def screen(depth):
        got = []
        drv._sample = lambda *a: got.append(sample(*a)) or got[-1]
        gen._generator.manual_seed(21)
        rep, launches, secs = launches_of(torch, gk, lambda: drv.screen(
            refs, score=False, queue_depth=depth, **kw))
        return {"samples": [(x, h) for x, h, _ in got],
                "molecules": [key(m) for m in rep.samples],
                "launches": launches, "screen_s": secs,
                "valid": rep.n_valid, "last_metrics": drv.last_metrics}

    # capture each reference's trajectory graph for the generator's sampler
    # and for the screening driver's, so that every counted run replays
    serial_loop()
    screen(1)
    runs = {"serial": serial_loop(), "depth1": screen(1),
            "depth2": screen(2), "serial_again": serial_loop()}
    first = runs["serial"]
    rec = {"phase": "screening", "references": K, "sizes": SCREEN_SIZES,
           "samples": N_SAMPLES, "steps": STEPS}
    for name, run in runs.items():
        same = (run["molecules"] == first["molecules"]
                and len(run["samples"]) == K
                and all(np.array_equal(x, xs) and np.array_equal(h, hs)
                        for (x, h), (xs, hs) in zip(run["samples"],
                                                    first["samples"])))
        rec[name] = {k: v for k, v in run.items()
                     if k not in ("samples", "molecules")}
        rec[name]["equal_to_serial"] = same
        check(same, f"{name} differs from the serial loop")
        check(run["launches"] == want, f"{name} launches {run['launches']}, "
              f"expected {want}")
    # samples that survive: copies of each reference (reference_copies) in
    # place of the sampler's output and bonds from distances; depth 1 and
    # 2 give the same molecules and reports, and most copies survive
    from ml_conformer_generator_tpu_torch.parallel import screening

    copies = [reference_copies(r, SURVIVOR_SAMPLES) for r in refs]
    fixed = [copies_as_samples(samples) for _, samples in copies]
    predict = screening.predict_bond_types
    screening.predict_bond_types = distance_bonds
    try:
        fixed_runs = {}
        for depth in (1, 2):
            batches = iter(fixed)
            drv._sample = lambda *a: next(batches)
            t0 = time.perf_counter()
            rep = drv.screen([ref for ref, _ in copies],
                             n_samples=SURVIVOR_SAMPLES, queue_depth=depth)
            torch.cuda.synchronize()
            fixed_runs[depth] = (rep, time.perf_counter() - t0)
    finally:
        screening.predict_bond_types = predict
        drv._sample = sample
    (rep1, s1), (rep2, s2) = fixed_runs[1], fixed_runs[2]
    rec["surviving_batch"] = {
        "n_valid": rep1.n_valid, "avg_shape_tanimoto": rep1.avg_shape_tanimoto,
        "avg_chemical_tanimoto": rep1.avg_chemical_tanimoto,
        "unique_within_batch": rep1.unique_within_batch,
        "depth1_s": s1, "depth2_s": s2, **report_differences(rep1, rep2)}
    diff = rec["surviving_batch"]
    check(diff["same_molecules_and_counts"]
          and diff["coords_max_abs_diff"] <= SURVIVOR_COORD_BAR
          and diff["scores_max_abs_diff"] <= SURVIVOR_SCORE_BAR,
          f"depth 1 and 2 differ on a surviving batch: {diff}")
    check(rep1.n_valid >= K * SURVIVOR_SAMPLES // 2,
          f"only {rep1.n_valid} of {K * SURVIVOR_SAMPLES} copies survive")
    drv.last_metrics = {"stale": True}
    for _ in drv.screen_iter(refs, **kw):
        break
    rec["screen_iter_break_metrics"] = drv.last_metrics
    check("stale" not in drv.last_metrics
          and "dispatch_s" in drv.last_metrics,
          f"screen_iter after a break: {drv.last_metrics}")
    log(f"[screen] {json.dumps(rec)}")
    log("[screen] random weights: almost no sample survives "
        "standardisation, so the chemistry is short and the overlap small")
    return rec


# -- 17. deployment -------------------------------------------------------------

# Run in a process of its own by ``build_cache_phase``, from the checkout's
# root: the kernels built in (or loaded from) the cache directory argv[1],
# one bf16 gcl pass on seeded inputs, and one JSON line with the build's
# seconds and the output's digest.
_CACHE_RUN = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
import ml_conformer_generator_tpu_torch as mcg
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
mcg.enable_compile_cache(sys.argv[1])
g = torch.Generator().manual_seed(0)
B, N, H = 8, 32, 420
def r(*s):
    return (torch.randn(*s, generator=g) * 0.1).to("cuda", torch.bfloat16)
out = gk.fused_edge_pass(r(B, N, H), r(B, N, H), r(B, N * N, 2),
                         torch.ones(B, N * N, 1, device="cuda",
                                    dtype=torch.bfloat16),
                         r(H, 2), r(H), r(H, H), r(H), r(H), r(1))
torch.cuda.synchronize()
print("CACHE_RUN " + json.dumps({
    "build_s": gk.BUILD_INFO["seconds"],
    "paths": sorted(gk.BUILD_INFO["paths"].values()),
    "launches": gk.LAUNCHES["gcl"],
    "digest": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()}),
    flush=True)
"""


def scan_shape_calls():
    """How many extra times this torch's eager ``scan`` runs its body: its
    ``generic_scan`` may run the body once on the first slice to learn the
    outputs' shapes before the loop (torch 2.11 does, 2.13 does not). Each
    such run is one more denoiser call of the exported sampler."""
    import torch
    from torch._higher_order_ops.scan import generic_scan

    calls = []

    def body(carry, x):
        calls.append(1)
        return [carry + x]

    generic_scan(body, [torch.zeros(())], [torch.zeros(3)])
    return len(calls) - 3


def build_cache_phase(workdir):
    """Two processes share a fresh ``enable_compile_cache`` directory: the
    first builds the three libraries there, the second builds nothing; both
    give the same kernel output. A third, whose ``nvcc`` fails, raises."""
    import shutil

    cache = os.path.join(workdir, "kernel_cache")
    shutil.rmtree(cache, ignore_errors=True)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", _CACHE_RUN, cache],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        line = [l for l in p.stdout.splitlines()
                if l.startswith("CACHE_RUN ")]
        check(p.returncode == 0 and line,
              f"cache run failed:\n{(p.stdout + p.stderr)[-3000:]}")
        runs.append(dict(json.loads(line[0][10:]),
                         process_s=time.perf_counter() - t0))
    # a failing nvcc first on PATH, a fresh cache directory
    fake = os.path.join(workdir, "failing_nvcc")
    os.makedirs(fake, exist_ok=True)
    with open(os.path.join(fake, "nvcc"), "w") as f:
        f.write("#!/bin/sh\necho 'nvcc: refused' >&2\nexit 1\n")
    os.chmod(os.path.join(fake, "nvcc"), 0o755)
    bad_cache = os.path.join(workdir, "kernel_cache_failed")
    shutil.rmtree(bad_cache, ignore_errors=True)
    p = subprocess.run(
        [sys.executable, "-c", _CACHE_RUN, bad_cache], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PATH=fake + os.pathsep + os.environ["PATH"]))
    failed_raised = (p.returncode != 0 and "nvcc failed" in p.stderr
                     and not [l for l in p.stdout.splitlines()
                              if l.startswith("CACHE_RUN ")])
    rec = {"phase": "build_cache", "runs": runs,
           "failed_build_raised": failed_raised,
           "failed_build_stderr_tail": p.stderr[-300:],
           "libraries": sorted(os.listdir(cache))}
    log(f"[deploy] {json.dumps(rec)}")
    check(runs[0]["build_s"] > 0, "the first process built nothing")
    check(runs[1]["build_s"] == 0.0, "the second process built again")
    check(all(os.path.dirname(q) == os.path.abspath(cache)
              for r in runs for q in r["paths"]),
          "the libraries are not in the cache directory")
    check(runs[0]["digest"] == runs[1]["digest"]
          and runs[0]["launches"] == runs[1]["launches"] == 1,
          "the two processes' kernel outputs differ")
    check(failed_raised, "a failed build in the cache directory did not "
          "raise")
    return rec


def cpu_artifacts(workdir):
    """A small artifact set exported on the CPU (EGNN 32 x 2, T = 2)."""
    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.export import \
        export_generator_artifacts
    from ml_conformer_generator_tpu_torch.generator import MLConformerGenerator
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics

    gen = MLConformerGenerator(diffusion_steps=2, device="cpu",
                               compute_dtype="float32")
    gen.egnn_cfg = EGNNConfig(hidden_nf=32, n_blocks=2)
    gen.sampler = EDMSampler(EGNNDynamics(gen.egnn_cfg).eval(), gen.diff_cfg)
    out = os.path.join(workdir, "artifacts_cpu")
    export_generator_artifacts(gen, out, batch=4, n_nodes=32)
    return out


def deployment_phase(torch, gk, gen, reference, kw, workdir):
    """The bf16 generator (EGNN 420 x 9, AdjMatSeer 2048, T = 100) exported
    by ``export_generator_artifacts(..., batch=32)`` (N = 42), each unit's
    export, save and load seconds and file size; the loaded sampler against
    ``EDMSampler.generate`` (a captured graph, captured before
    it is counted) fed the same raw draws, the loaded denoiser
    against ``dynamics_forward``, the loaded AdjMatSeer against the eager
    logits, each bit for bit; exact launches a sampler call and 27 W1 packs
    a loaded program; ``MLConformerGeneratorAOT``'s graphs of the sampler
    and AdjMatSeer programs against the direct calls, bit for bit, their
    launches, first-call seconds and reserved memory, and the direct call,
    the graphed call and the eager sampler in turns;
    ``MLConformerGeneratorAOT`` on the card (64 samples, two sampler calls)
    beside ``generate_conformers`` in turns; the shared build cache;
    ``debug_mode`` over a denoiser forward (bit-equal, timed) and over one
    whose W1 carries a NaN (raises, naming the edge pass op); an artifact
    exported on the CPU refused on the card."""
    import copy

    from ml_conformer_generator_tpu_torch import export as ex
    from ml_conformer_generator_tpu_torch.chem.featurize import \
        prepare_adj_mat_seer_input
    from ml_conformer_generator_tpu_torch.diffusion.edm import mask_noise
    from ml_conformer_generator_tpu_torch.generator_aot import \
        MLConformerGeneratorAOT
    from ml_conformer_generator_tpu_torch.models.adj_mat_seer import \
        adj_mat_seer_forward
    from ml_conformer_generator_tpu_torch.models.egnn import dynamics_forward
    from ml_conformer_generator_tpu_torch.utils.debug import debug_mode
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_edm_input

    B, N = AOT_BATCH, gen.dimension
    T, blocks = gen.diffusion_steps, gen.egnn_cfg.n_blocks
    # for information: the sampler's while_loop runs its body T times
    # whatever this torch's eager scan would add
    extra = scan_shape_calls()
    per_call = forward_launches(T + 1, blocks)
    art = os.path.join(workdir, "artifacts")
    # -- export, save, load: each unit timed through wrappers
    timing = {}
    real = {n: getattr(ex, n) for n in ("export_sampler", "export_denoiser",
                                        "export_adj_mat_seer",
                                        "save_exported")}

    def timed(name, unit=None):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = real[name](*a, **k)
            key = unit or os.path.basename(a[1])
            timing.setdefault(key, {})[
                "save_s" if name == "save_exported" else "export_s"] = (
                time.perf_counter() - t0)
            return out
        return run

    ex.export_sampler = timed("export_sampler", "edm_sampler.pt2")
    ex.export_denoiser = timed("export_denoiser", "egnn_denoiser.pt2")
    ex.export_adj_mat_seer = timed("export_adj_mat_seer", "adj_mat_seer.pt2")
    ex.save_exported = timed("save_exported")
    try:
        t0 = time.perf_counter()
        paths = ex.export_generator_artifacts(gen, art, batch=B)
        export_total_s = time.perf_counter() - t0
    finally:
        for n, f in real.items():
            setattr(ex, n, f)
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    programs = {}
    for unit, path in paths.items():
        t0 = time.perf_counter()
        programs[unit] = ex.load_exported(path).module()
        name = os.path.basename(path)
        timing[name]["load_s"] = time.perf_counter() - t0
        timing[name]["bytes"] = os.path.getsize(path)
    loop_nodes = {name: [n for n in programs["sampler"].graph.nodes
                         if n.op == "call_function"
                         and name in str(n.target)]
                  for name in ("while_loop", "scan")}

    # -- the loaded sampler against the eager one, the same raw draws
    g = torch.Generator(device="cuda").manual_seed(17)
    node_mask, edge_mask, context, _ = prepare_edm_input(
        g, B, [105.0766, 473.1938, 537.4675], gen.context_norms, 23, 27,
        n_nodes_pad=N, device="cuda")
    draws = torch.randn(manifest["draws"], generator=g, device="cuda")
    sampler = gen.sampler

    def eager_sampler():
        queue = list(draws)
        sampler.sample_noise = (
            lambda generator, n_samples, n_nodes, nm, dtype:
            mask_noise(queue.pop(0), nm, 3))
        try:
            return sampler.generate(None, gen.gamma, node_mask, edge_mask,
                                    context, dtype=gen.dtype)
        finally:
            del sampler.sample_noise

    with torch.no_grad():
        eager_sampler()                     # captures the sampler's graph
        (xe, he), eager_launches, _ = launches_of(torch, gk, eager_sampler)
        gk.reset_pack_count()
        (xl, hl), loaded_launches, _ = launches_of(
            torch, gk, lambda: programs["sampler"](draws, node_mask,
                                                   edge_mask, context))
        packs_first = gk.PACKS
        (xl2, hl2), _, _ = launches_of(
            torch, gk, lambda: programs["sampler"](draws, node_mask,
                                                   edge_mask, context))
        packs_second = gk.PACKS - packs_first
        # in turns: eager, loaded, loaded, eager, each synchronised
        turns = []
        for which in ("eager", "loaded", "loaded", "eager"):
            fn = (eager_sampler if which == "eager" else
                  lambda: programs["sampler"](draws, node_mask, edge_mask,
                                              context))
            _, _, secs = launches_of(torch, gk, fn)
            turns.append([which, secs])

    # -- the AOT generator's sampler graph against the direct call and the
    # eager sampler: its first call is the capture's warm-up, made for real
    t0 = time.perf_counter()
    aot = MLConformerGeneratorAOT(art, seed=0)
    aot_load_s = time.perf_counter() - t0
    sampler_in = dict(draws=draws, node_mask=node_mask, edge_mask=edge_mask,
                      context=context)

    def graphed_sampler():
        return aot._call("sampler", aot._sampler, **sampler_in)

    def direct_sampler():
        return programs["sampler"](draws, node_mask, edge_mask, context)

    graphs = {}

    def first_graphed(name, fn):
        """``fn``'s first call, which captures: launches, W1 packs, seconds
        and the reserved memory across it."""
        gk.reset_pack_count()
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        out, launches, secs = launches_of(torch, gk, fn)
        graphs[name] = {"first_call_s": secs, "first_call_launches": launches,
                        "first_call_packs": gk.PACKS,
                        "reserved_mib": (torch.cuda.memory_reserved()
                                         - reserved) / 2 ** 20}
        return out

    with torch.no_grad():
        xg, hg = first_graphed("sampler", graphed_sampler)
        gk.reset_pack_count()
        (xg2, hg2), graph_launches, _ = launches_of(torch, gk,
                                                    graphed_sampler)
        graphs["sampler"].update(replay_launches=graph_launches,
                                 replay_packs=gk.PACKS)
        # in turns: direct, graph, eager, eager, graph, direct
        fns = {"direct": direct_sampler, "graph": graphed_sampler,
               "eager": eager_sampler}
        graph_turns = []
        for which in ("direct", "graph", "eager", "eager", "graph",
                      "direct"):
            _, _, secs = launches_of(torch, gk, fns[which])
            graph_turns.append([which, secs])

    # -- the loaded denoiser and AdjMatSeer against the eager functions
    dyn = sampler.dynamics
    params = dict(dyn.state_dict())
    t = torch.full((B,), 0.37, device="cuda")
    xh = mask_noise(draws[0], node_mask, 3)
    with torch.no_grad():
        want = dynamics_forward(dyn, t, xh, node_mask, edge_mask, context)
        (got, den_launches, _) = launches_of(torch, gk, lambda: programs[
            "denoiser"](params, t, xh, node_mask, edge_mask, context))
        elements, dist, adj, _ = prepare_adj_mat_seer_input(
            [reference] * B, gen.dimension)
        adj_in = (torch.as_tensor(elements, dtype=torch.int64, device="cuda"),
                  torch.as_tensor(dist, dtype=torch.float32, device="cuda"),
                  torch.as_tensor(adj, dtype=torch.float32, device="cuda"))
        logits_e = adj_mat_seer_forward(gen.adj_model, *adj_in)
        logits_l = programs["adj_mat_seer"](*adj_in)
        adj_kw = dict(zip(("elements", "dist_mat", "adj_mat"), adj_in))

        def graphed_adj():
            return aot._call("adj_mat_seer", aot._adj, **adj_kw)

        logits_g = first_graphed("adj_mat_seer", graphed_adj)
        logits_g2 = graphed_adj()

    # -- host time a call: the registered op beside the direct call on a
    # tiny edge pass (the host sets the pace), the loaded denoiser beside
    # dynamics_forward at the sampler's shape; in turns, synchronised
    def host_ms(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    g1 = torch.Generator().manual_seed(3)
    tiny = [(torch.randn(*s, generator=g1) * 0.1).to("cuda", torch.bfloat16)
            for s in ((1, 8, 420), (1, 8, 420), (1, 64, 2), (1, 64, 1),
                      (420, 2), (420,), (420, 420), (420,), (420,), (1,))]
    host = {"op_call_us": [], "direct_call_us": [], "loaded_forward_ms": [],
            "eager_forward_ms": []}
    with torch.no_grad():
        for which in ("direct", "op", "op", "direct"):
            fn = ((lambda: gk.fused_edge_pass(*tiny)) if which == "direct"
                  else (lambda: torch.ops.mlcg_torch.fused_edge_pass(
                      *tiny, "gcl", 100.0)))
            host[f"{which}_call_us"].append(host_ms(fn, 500) * 1e3)
        for which in ("eager", "loaded", "loaded", "eager"):
            fn = ((lambda: dynamics_forward(dyn, t, xh, node_mask, edge_mask,
                                            context)) if which == "eager"
                  else (lambda: programs["denoiser"](
                      params, t, xh, node_mask, edge_mask, context)))
            host[f"{which}_forward_ms"].append(host_ms(fn, 20))

    # -- the AOT request beside the eager request, in turns: both of its
    # programs' graphs are captured, so every call replays
    aot_kw = dict(kw)
    requests = []
    gk.reset_pack_count()
    aot.generate_conformers(**aot_kw)                   # warm-up
    torch.cuda.synchronize()
    aot_warm_packs = gk.PACKS
    for which in ("eager", "aot", "aot", "eager"):
        run = aot if which == "aot" else gen
        valid, launches, secs = launches_of(
            torch, gk, lambda: run.generate_conformers(**aot_kw))
        requests.append({"request": which, "request_s": secs,
                         "valid": len(valid), "launches": launches})
    aot_launches = requests[1]["launches"]
    calls = -(-kw["n_samples"] // B)

    # -- debug mode: bit-equal when clean, raises on a NaN in W1
    with torch.no_grad():
        t0 = time.perf_counter()
        plain = dynamics_forward(dyn, t, xh, node_mask, edge_mask, context)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with debug_mode():
            checked = dynamics_forward(dyn, t, xh, node_mask, edge_mask,
                                       context)
        torch.cuda.synchronize()
        debug_s = time.perf_counter() - t0
        debug_launches = dict(gk.LAUNCHES)
        poisoned = copy.deepcopy(dyn)
        poisoned.egnn.e_block_0.gcl_0.edge_mlp[2].weight[3, 5] = float("nan")
        nan_error = None
        try:
            with debug_mode():
                dynamics_forward(poisoned, t, xh, node_mask, edge_mask,
                                 context)
        except FloatingPointError as e:
            nan_error = str(e)
        del poisoned

    # -- no fallback: an artifact exported on the CPU is refused on the card
    cpu_dir = cpu_artifacts(workdir)
    refused = None
    try:
        MLConformerGeneratorAOT(cpu_dir)
    except ValueError as e:
        refused = str(e)

    build_cache_phase(workdir)

    rec = {"phase": "deployment", "batch": B, "n_nodes": N, "steps": T,
           "manifest_device": manifest["device"],
           "manifest_draws": manifest["draws"],
           "export_total_s": export_total_s, "units": timing,
           "while_loop_nodes": len(loop_nodes["while_loop"]),
           "scan_nodes": len(loop_nodes["scan"]), "scan_shape_calls": extra,
           "sampler_bit_equal": bool(torch.equal(xl, xe)
                                     and torch.equal(hl, he)),
           "sampler_max_abs_dx": (xl - xe).abs().max().item(),
           "sampler_again_bit_equal": bool(torch.equal(xl2, xl)
                                           and torch.equal(hl2, hl)),
           "x_max_abs": xe.abs().max().item(),
           "eager_sampler_launches": eager_launches,
           "loaded_sampler_launches": loaded_launches,
           "loaded_sampler_packs_first_call": packs_first,
           "loaded_sampler_packs_second_call": packs_second,
           "sampler_turns_s": turns,
           "graphs": graphs, "graph_turns_s": graph_turns,
           "graph_sampler_bit_equal": bool(
               torch.equal(xg, xl) and torch.equal(hg, hl)
               and torch.equal(xg2, xl) and torch.equal(hg2, hl)),
           "graph_sampler_max_abs_dx": (xg - xl).abs().max().item(),
           "graph_adj_mat_seer_bit_equal": bool(
               torch.equal(logits_g, logits_l)
               and torch.equal(logits_g2, logits_l)),
           "aot_captures": aot._graphs.captures,
           "denoiser_bit_equal": bool(torch.equal(got, want)),
           "denoiser_max_abs_diff": (got - want).abs().max().item(),
           "denoiser_launches": den_launches,
           "adj_mat_seer_bit_equal": bool(torch.equal(logits_l, logits_e)),
           "adj_mat_seer_max_abs_diff": (logits_l - logits_e).abs().max()
           .item(),
           "host_time": host,
           "aot_load_s": aot_load_s, "aot_warmup_packs": aot_warm_packs,
           "requests": requests, "aot_sampler_calls": calls,
           "debug_bit_equal": bool(torch.equal(checked, plain)),
           "debug_forward_s": debug_s, "plain_forward_s": plain_s,
           "debug_launches": debug_launches, "nan_error": nan_error,
           "cpu_artifact_refused": refused}
    log(f"[deploy] {json.dumps(rec)}")
    check(manifest["device"] == "cuda"
          and manifest["draws"] == [T + 2, B, N, 11],
          f"manifest {manifest}")
    check(len(loop_nodes["while_loop"]) == 1 and not loop_nodes["scan"],
          f"{len(loop_nodes['while_loop'])} while_loop and "
          f"{len(loop_nodes['scan'])} scan nodes, expected 1 and 0")
    check(rec["sampler_bit_equal"] and rec["sampler_again_bit_equal"],
          f"loaded sampler differs from the eager one: max |dx| "
          f"{rec['sampler_max_abs_dx']}")
    check(eager_launches == forward_launches(T + 1, blocks),
          f"eager sampler launches {eager_launches}")
    check(loaded_launches == per_call,
          f"loaded sampler launches {loaded_launches}, expected {per_call} "
          f"({T} steps and the decode)")
    check(packs_first == 3 * blocks and packs_second == 0,
          f"W1 packs of the loaded sampler: {packs_first} then "
          f"{packs_second}, expected {3 * blocks} then 0")
    check(rec["denoiser_bit_equal"], "loaded denoiser differs from "
          f"dynamics_forward by {rec['denoiser_max_abs_diff']}")
    check(den_launches == forward_launches(1, blocks),
          f"loaded denoiser launches {den_launches}")
    check(rec["adj_mat_seer_bit_equal"], "loaded AdjMatSeer differs by "
          f"{rec['adj_mat_seer_max_abs_diff']}")
    check(rec["graph_sampler_bit_equal"] and rec["sampler_bit_equal"],
          f"the graphed sampler program differs from the direct call by "
          f"{rec['graph_sampler_max_abs_dx']} (or the direct call from the "
          f"eager sampler)")
    check(rec["graph_adj_mat_seer_bit_equal"]
          and rec["adj_mat_seer_bit_equal"],
          "the graphed AdjMatSeer program differs from the direct call")
    sg = graphs["sampler"]
    check(sg["first_call_launches"] == per_call
          and sg["replay_launches"] == per_call,
          f"graphed sampler launches {sg['first_call_launches']} (capture) "
          f"and {sg['replay_launches']} (replay), expected {per_call}")
    check(sg["first_call_packs"] == 3 * blocks and sg["replay_packs"] == 0,
          f"W1 packs of the graphed sampler: {sg['first_call_packs']} then "
          f"{sg['replay_packs']}, expected {3 * blocks} then 0")
    check(graphs["adj_mat_seer"]["first_call_launches"]
          == forward_launches(0, blocks), "the AdjMatSeer graph launched an "
          "edge kernel")
    check(aot_warm_packs == 0 and aot._graphs.captures == 2,
          f"AOT requests packed {aot_warm_packs} W1 and captured "
          f"{aot._graphs.captures - 2} more graphs, expected none")
    for r in requests:
        want_l = (forward_launches(calls * (T + 1), blocks)
                  if r["request"] == "aot" else forward_launches(T + 1,
                                                                 blocks))
        check(r["launches"] == want_l,
              f"{r['request']} request launches {r['launches']}, "
              f"expected {want_l}")
    check(rec["debug_bit_equal"], "debug_mode changed the forward")
    check(debug_launches == forward_launches(1, blocks),
          f"launches under debug_mode {debug_launches}")
    check(nan_error is not None and "mlcg_torch.fused_edge_pass" in nan_error,
          f"debug_mode on a NaN W1: {nan_error}")
    check(refused is not None, "an artifact exported on the CPU ran on the "
          "card")
    return aot_launches


# -- 18. the overfit-validity path ---------------------------------------------

# The twin's step budget in phase 18, (EDM steps, bond steps). Its defaults,
# (1500, 600), took 251 s of command on the H100 (1,600 EDM steps at 0.142 s,
# PERF.md), too long beside phases 1-17: the phase runs 400 and 200, widths
# and everything else as the defaults.
VALIDITY_STEPS = (400, 200)
# Whether the twin's run on the card at VALIDITY_STEPS made a valid molecule
# in the full run of this script (it made 31 of 192 on the H100): phase 18
# then requires one; otherwise it prints the stage that lost them.
VALIDITY_REACHED = True


@contextlib.contextmanager
def held_against_plain(torch, gk):
    """Within: each launch of a forward or backward edge kernel is held
    against its plain version on the same inputs, the forward at
    TOLERANCE's bar for its type and mode, the backward at
    ``backward_bars``'. The plain versions launch nothing. A launch under a
    CUDA graph's capture cannot be read then: its inputs and outputs are
    copied inside the graph, on every replay, into the record's "stash",
    which ``held_replay`` holds after a replay. Yields a record of the
    calls and the worst errors, by kernel."""
    launch_forward, launch_backward = gk._launch_forward, gk._launch_backward
    rec = {}

    def forward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, *, mode, norm, **kw):
        out = launch_forward(u, v, ef, em, w_e, b0, w1, b1, wh, bh,
                             mode=mode, norm=norm, **kw)
        args = (u, v, ef, em, w_e, b0, w1, b1, wh, bh)
        if torch.cuda.is_current_stream_capturing():
            rec.setdefault("stash", []).append(
                (mode, norm, _copies(torch, args), out.clone(), None))
        else:
            _hold_forward(torch, gk, rec, mode, norm, args, out)
        return out

    def backward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, g, *, mode, norm,
                 w1p):
        got = launch_backward(u, v, ef, em, w_e, b0, w1, b1, wh, bh, g,
                              mode=mode, norm=norm, w1p=w1p)
        args = (u, v, ef, em, w_e, b0, w1, b1, wh, bh)
        if torch.cuda.is_current_stream_capturing():
            rec.setdefault("stash", []).append(
                (mode, norm, _copies(torch, args), _copies(torch, got),
                 g.clone()))
        else:
            _hold_backward(torch, gk, rec, mode, norm, args, got, g)
        return got

    gk._launch_forward, gk._launch_backward = forward, backward
    try:
        yield rec
    finally:
        gk._launch_forward, gk._launch_backward = (launch_forward,
                                                   launch_backward)


def _copies(torch, tensors):
    return tuple(None if t is None else t.clone() for t in tensors)


def _hold_forward(torch, gk, rec, mode, norm, args, out, prefix=""):
    """One forward kernel call's output against the plain version."""
    ref = gk.fused_edge_pass_reference(*args, mode=mode, norm=norm).float()
    name = str(args[0].dtype).replace("torch.", "")
    atol, rtol = TOLERANCE[name, mode]
    err = (out - ref).abs()
    r = rec.setdefault(f"{prefix}{name}_{mode}", {
        "calls": 0, "max_abs_err": 0.0, "ref_max_abs": 0.0, "atol": atol,
        "rtol": rtol})
    r["calls"] += 1
    r["max_abs_err"] = max(r["max_abs_err"], err.max().item())
    r["ref_max_abs"] = max(r["ref_max_abs"], ref.abs().max().item())
    check(torch.isfinite(out).all().item(), f"non-finite {name} {mode}")
    check((err - atol - rtol * ref.abs()).max().item() <= 0.0,
          f"{name} {mode} kernel disagrees with plain: {r}")


def _hold_backward(torch, gk, rec, mode, norm, args, got, g, prefix=""):
    """One backward kernel call's gradients against the plain backward."""
    ref = gk.fused_edge_pass_backward_reference(*args, g, mode=mode,
                                                norm=norm)
    _, elem, sums = backward_bars(torch, got, ref, mode,
                                  "backward kernel against plain")
    r = rec.setdefault(f"{prefix}float32_{mode}_bwd", {
        "calls": 0, "max_abs_err": 0.0, "weight_sums_max_rel_err": 0.0,
        "atol": BWD_ATOL, "rtol": BWD_RTOL})
    r["calls"] += 1
    r["max_abs_err"] = max(r["max_abs_err"], elem)
    r["weight_sums_max_rel_err"] = max(r["weight_sums_max_rel_err"], sums)


def held_replay(torch, gk, rec):
    """After a replay of a graph captured within ``held_against_plain``:
    each kernel call its capture recorded, held against the plain version
    on the inputs that replay gave it (record keys "replayed_...")."""
    torch.cuda.synchronize()
    for mode, norm, args, out, g in rec.pop("stash", []):
        if g is None:
            _hold_forward(torch, gk, rec, mode, norm, args, out, "replayed_")
        else:
            _hold_backward(torch, gk, rec, mode, norm, args, out, g,
                           "replayed_")


def fixed_objective_loss(torch, model, batch, gamma, seed=11):
    """The EDM training loss of ``model`` on ``batch`` with draws from
    ``seed``, without a gradient."""
    from ml_conformer_generator_tpu_torch.config import DiffusionConfig
    from ml_conformer_generator_tpu_torch.training import edm_training_loss

    b = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = edm_training_loss(
            model, torch.Generator(device="cuda").manual_seed(seed), b["x"],
            b["h"], b["node_mask"], b["edge_mask"], b["context"],
            gamma.cuda(), model.cfg, DiffusionConfig())
    return float(loss)


def validity_phase(torch, gk, smi, workdir):
    """The overfit-validity path at full width (EGNN 420 x 9, AdjMatSeer
    2048, T = 1000 training, 100 sampling steps, 64 samples a reference):
    one train step of the twin's shape (B = 32, N = 39) with each kernel
    call held against its plain version and exact launches; the twin's
    ``run`` at VALIDITY_STEPS, its training and its serving each with exact
    launches; the loss of the served (EMA) weights on a fixed objective 20%
    below the initial weights'; the saved ``.npz`` files in the serving
    generator equal to the trained modules; the first forward of a served
    request held against the plain version in bf16; the report with every
    key of ``VALIDITY.json``; a valid molecule where VALIDITY_REACHED.
    Returns the launches of the train step and of one request."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.checkpoint import (_flatten,
                                                             to_jax_params)
    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import (MoleculeDataset,
                                                           batches,
                                                           init_train_state,
                                                           make_optimizer,
                                                           make_train_step)

    edm_steps, bond_steps = VALIDITY_STEPS
    args = overfit.parse_args([
        "--edm-steps", str(edm_steps), "--bond-steps", str(bond_steps),
        "--out", os.path.join(workdir, "overfit"),
        "--json", os.path.join(workdir, "VALIDITY_smoke.json"),
        "--device", "cuda"])
    cfg, diff = EGNNConfig(), DiffusionConfig()
    blocks = cfg.n_blocks

    # 18a. one train step at the twin's shape, each kernel call held
    mols, train_mols, _ = overfit.build_corpus(args)
    batch = next(batches(MoleculeDataset(train_mols), args.batch,
                         rng=np.random.default_rng(0)))
    gamma = torch.from_numpy(gamma_schedule(diff.timesteps))
    step = make_train_step(make_mesh(device="cuda"), cfg, diff)
    init = EGNNDynamics(cfg, torch.Generator().manual_seed(args.seed)).cuda()
    loss_before = fixed_objective_loss(torch, init, batch, gamma)
    state = init_train_state(init, make_optimizer(lr=args.lr))
    gk.reset_launch_counts()
    with held_against_plain(torch, gk) as held_step:
        step(init, state, torch.Generator(device="cuda").manual_seed(3),
             batch, gamma)
        torch.cuda.synchronize()
    # the step's capture recorded its calls too; 21c holds a replay's
    held_step.pop("stash", None)
    step_launches = dict(gk.LAUNCHES)
    want_step = launch_counts(4 * blocks, 2 * blocks, 2 * blocks, blocks)
    check(step_launches == want_step,
          f"a train step's launches {step_launches}, expected {want_step}")
    check(sorted(held_step) == ["float32_coord", "float32_coord_bwd",
                                "float32_gcl", "float32_gcl_bwd"],
          f"kernels held in the train step: {sorted(held_step)}")
    del init, state

    # 18b. the twin's run: training, then serving, each path counted
    counts, first_forward = {}, []
    serve, phi = overfit.serve, EDMSampler.phi

    def counted_serve(*a):
        torch.cuda.synchronize()
        counts["train"] = dict(gk.LAUNCHES)
        gk.reset_launch_counts()
        out = serve(*a)
        torch.cuda.synchronize()
        counts["serve"] = dict(gk.LAUNCHES)
        return out

    def recording_phi(self, *a):
        # a real call: the warm-up before a capture runs the forward on the
        # card; a call under capture only records it
        if not first_forward and not torch.cuda.is_current_stream_capturing():
            first_forward.append((self, a))
        return phi(self, *a)

    overfit.serve, EDMSampler.phi = counted_serve, recording_phi
    try:
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        report, trained, gen = overfit.run(args)
        run_s = time.perf_counter() - t0
    finally:
        overfit.serve, EDMSampler.phi = serve, phi
    steps = trained["edm_steps"]
    want_train = launch_counts(*(n * steps for n in want_step.values()))
    request = forward_launches(STEPS + 1, blocks)
    # each graph the serving generator captured warmed up once
    captures = gen.sampler._graphs.captures
    want_serve = forward_launches(
        len(mols) * (STEPS + 1) + captures * WARMUP_FORWARDS["generate"],
        blocks)
    check(counts["train"] == want_train,
          f"training launches {counts['train']}, expected {want_train}")
    check(counts["serve"] == want_serve,
          f"serving launches {counts['serve']}, expected {want_serve}")

    # 18c. the served weights: the loss fell; the files hold the modules
    loss_after = fixed_objective_loss(torch, trained["edm_model"], batch,
                                      gamma)
    fa = _flatten(gen.edm_params)
    fb = _flatten(to_jax_params(trained["edm_model"]))
    ga = _flatten(to_jax_params(gen.adj_model))
    gb = _flatten(to_jax_params(trained["adj_mat_seer_model"]))
    same = all(sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                              for k in a)
               for a, b in ((fa, fb), (ga, gb)))

    # 18d. the first forward of a served request, held in bf16
    sampler, a = first_forward[0]
    gk.reset_launch_counts()
    with torch.no_grad(), held_against_plain(torch, gk) as held_request:
        phi(sampler, *a)
        torch.cuda.synchronize()
    check(gk.LAUNCHES == forward_launches(1, blocks),
          f"the held request forward's launches {gk.LAUNCHES}")
    check(sorted(held_request) == ["bfloat16_coord", "bfloat16_gcl"],
          f"kernels held in the request forward: {sorted(held_request)}")

    with open(os.path.join(ROOT, "VALIDITY.json")) as f:
        jax_report = json.load(f)
    missing = sorted(set(jax_report) - set(report)) + sorted(
        f"{k}.{x}" for k in ("per_reference", "training", "weights",
                             "validity_definition")
        for x in set(jax_report[k][0] if k == "per_reference"
                     else jax_report[k])
        - set(report[k][0] if k == "per_reference" else report[k]))
    hist = trained["history"]["edm"]
    rec = {"phase": "validity", "edm_steps": steps, "bond_steps": bond_steps,
           "B": args.batch, "N": MoleculeDataset(mols).max_n_nodes,
           "run_s": run_s, "loss_before": loss_before,
           "loss_after": loss_after,
           "history_first_last": [hist[0]["loss"], hist[-1]["loss"]],
           "weights_equal_trained": same,
           "step_launches": step_launches, "train_launches": counts["train"],
           "request_launches": request, "serve_launches": counts["serve"],
           "serve_captures": captures,
           "held_train_step": held_step, "held_request_forward": held_request,
           "missing_report_keys": missing,
           "stages": report["stages"]}
    log(f"[validity] {json.dumps(rec)}")
    log("[validity] " + json.dumps({
        "validity": report["validity"],
        "size_matched_validity": report["size_matched_validity"],
        "n_valid": report["n_valid"], "n_samples": report["n_samples"],
        "valid_mol_per_s": report["valid_mol_per_s"],
        "size_matched_valid_mol_per_s":
            report["size_matched_valid_mol_per_s"],
        "generate_s": [r["generate_s"] for r in report["per_reference"]],
        "edm_train_s": report["training"]["edm_train_s"],
        "edm_steps_per_s": report["training"]["edm_steps_per_s"],
        "adj_mat_seer_train_s": report["training"]["adj_mat_seer_train_s"],
        "platform": report["platform"], "nvidia_smi": smi}))
    check(np.isfinite([loss_before, loss_after]).all(), "non-finite loss")
    check(loss_after <= 0.8 * loss_before,
          f"the loss did not drop by 20%: {loss_before} -> {loss_after}")
    check(same, "the generator's weights are not the trained modules'")
    check(not missing, f"the report lacks VALIDITY.json's keys {missing}")
    if VALIDITY_REACHED:
        check(report["n_valid"] > 0, f"no valid molecule: stages "
              f"{report['stages']}")
    elif report["n_valid"] == 0:
        log(f"[validity] no valid molecule; where they were lost: "
            f"{report['stages']}")
    return {"train_step": step_launches, "request": request}


# -- 19. the JAX system's tools --------------------------------------------------

# The report's depth in phase 19, (references, samples a reference): the
# twin's defaults (25, 100) are too long beside phases 1-18.
REPORT_DEPTH = (8, 64)
# The mesh run of the edges twin: two ranks sharing the card, float32; a
# forward takes ~0.26 s there, so fewer and shorter windows than the
# twin's defaults.
EDGES_MESH = ["--mesh", "1x2", "--batch", "64", "--nodes", "32", "--loops",
              "5", "--repeats", "2"]


def recorded_relax(torch, relax, calls):
    """``forcefield.relax`` that appends to ``calls``, for each call, its
    batch (B, n_pad), whether it captured a graph, its seconds (the card
    synchronised around it) and its inputs."""
    from ml_conformer_generator_tpu_torch.chem import forcefield

    def run(x0, ff, *a, **k):
        captures = forcefield._GRAPHS.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = relax(x0, ff, *a, **k)
        torch.cuda.synchronize()
        calls.append({"B": x0.shape[0], "n_pad": x0.shape[1],
                      "captured": forcefield._GRAPHS.captures - captures,
                      "graph_s": time.perf_counter() - t0,
                      "inputs": (x0, ff)})
        return x

    return run


def fire_traffic(torch, calls):
    """FIRE on a served request's traffic: for each ``recorded_relax``
    call, its seconds in the request (a capture, if it made one, and the
    replays) against the loop of its steps on the same inputs, then a
    replay's seconds; the replay bit for bit the loop. Returns the
    record."""
    from ml_conformer_generator_tpu_torch.chem import forcefield

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    per_call = []
    for c in calls:
        x0, ff = c.pop("inputs")
        loop, c["loop_s"] = timed(
            lambda: forcefield.fire_steps(x0, ff, 200, lambda k, u: None))
        graph = forcefield.relax(x0, ff)      # captures again if evicted
        _, c["replay_s"] = timed(lambda: forcefield.relax(x0, ff))
        c["bit_equal"] = torch.equal(graph, loop)
        per_call.append(c)
    rec = {"calls": len(calls),
           "captures": sum(c["captured"] for c in per_call),
           "graph_s": sum(c["graph_s"] for c in per_call),
           "loop_s": sum(c["loop_s"] for c in per_call),
           "per_call": per_call}
    check(all(c["bit_equal"] for c in per_call),
          f"FIRE on the report's traffic: graph and loop differ: {rec}")
    return rec


def report_phase(torch, gk, smi, workdir):
    """19a: ``make_eval_report.evaluate`` at full width on phase 18's
    weights (REPORT_DEPTH protocol references, variance 2, 100 steps,
    bf16): exact launches, every payload key of the JAX script's, the
    fractions in [0, 1], the first forward of a request held against the
    plain version, both files written; FIRE on its traffic (its captures,
    its seconds against the loop's, ``fire_traffic``). Returns the
    generator and its references."""
    import dataclasses

    from ml_conformer_generator_tpu_torch.chem import forcefield
    from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
    from ml_conformer_generator_tpu_torch.eval.harness import \
        EvaluationReport

    n_refs, samples = REPORT_DEPTH
    args = report.parse_args([
        "--references", str(n_refs), "--samples", str(samples),
        "--weights-dir", os.path.join(workdir, "overfit"),
        "--md", os.path.join(workdir, "EVAL_smoke.md"),
        "--json", os.path.join(workdir, "EVAL_smoke.json"),
        "--device", "cuda"])
    t0 = time.perf_counter()
    gen = report.load_generator(args)
    refs = report.build_references(args)
    first_forward, phi = [], EDMSampler.phi

    def recording_phi(self, *a):
        # a real call: the warm-up before a capture runs the forward on the
        # card; a call under capture only records it
        if not first_forward and not torch.cuda.is_current_stream_capturing():
            first_forward.append((self, a))
        return phi(self, *a)

    EDMSampler.phi = recording_phi
    relaxes, relax = [], forcefield.relax
    forcefield.relax = recorded_relax(torch, relax, relaxes)
    try:
        gk.reset_launch_counts()
        body, payload = report.evaluate(
            gen, refs, report.corpus_keys(), samples=samples,
            variance=args.variance, weights=report.weight_paths(args),
            platform=overfit.card_platform("cuda"))
        torch.cuda.synchronize()
        launches = dict(gk.LAUNCHES)
    finally:
        EDMSampler.phi, forcefield.relax = phi, relax
    report.write(body, payload, args.md, args.json)
    fire = fire_traffic(torch, relaxes)
    sampler, a = first_forward[0]
    gk.reset_launch_counts()
    with torch.no_grad(), held_against_plain(torch, gk) as held:
        phi(sampler, *a)
        torch.cuda.synchronize()
    held_launches = dict(gk.LAUNCHES)
    want_keys = ({f.name for f in dataclasses.fields(EvaluationReport)}
                 - {"samples"}) | {"size_matched_validity",
                                   "validity_fraction", "valid_mol_per_s",
                                   "protocol"}
    want_protocol = {"references", "samples", "variance", "diffusion_steps",
                     "reference_source", "weights", "platform", "wall_s"}
    n_valid = payload["n_valid"]
    fractions = {
        "validity": payload["validity_fraction"],
        "size_matched_validity": payload["size_matched_validity"],
        "uniqueness": payload["unique_within_batch"] / n_valid if n_valid
        else 0.0,
        "novelty": payload["unique_vs_corpus"] / n_valid if n_valid
        else 0.0}
    rec = {"phase": "eval_report", "references": n_refs, "samples": samples,
           "sizes": [r.num_atoms for r in refs], "launches": launches,
           "captures": gen.sampler._graphs.captures, "fire": fire,
           "fractions": fractions, "n_valid": n_valid,
           "valid_mol_per_s": payload["valid_mol_per_s"],
           "total_gen_time_s": payload["total_gen_time_s"],
           "total_eval_time_s": payload["total_eval_time_s"],
           "avg_shape_tanimoto": payload["avg_shape_tanimoto"],
           "held_request_forward": held, "phase_s": time.perf_counter() - t0,
           "platform": payload["protocol"]["platform"], "nvidia_smi": smi}
    log(f"[tools] {json.dumps(rec)}")
    # each graph the report's generator captured warmed up once
    want = forward_launches(n_refs * (STEPS + 1) + gen.sampler._graphs.captures
                            * WARMUP_FORWARDS["generate"])
    check(launches == want, f"the report's launches {launches}, expected "
          f"{want}")
    check(set(payload) == want_keys
          and set(payload["protocol"]) == want_protocol,
          f"the report's keys {sorted(payload)}, protocol "
          f"{sorted(payload['protocol'])}")
    check(all(0.0 <= v <= 1.0 for v in fractions.values()),
          f"a fraction outside [0, 1]: {fractions}")
    check(held_launches == forward_launches(1)
          and sorted(held) == ["bfloat16_coord", "bfloat16_gcl"],
          f"the held request forward: {held_launches}, {sorted(held)}")
    check(os.path.getsize(args.md) > 0 and os.path.getsize(args.json) > 0,
          "the report's files are empty")
    return gen, refs


def edges_phase(torch, gk, smi):
    """19b: the edges twin at its defaults (B = 128, N = 42, 420 x 9) in
    bf16 and float32, one forward of each held against the plain version
    first, exact launches and the busy share; then ``--mesh 1x2`` (two gloo
    ranks on the card, float32, B = 64, N = 32), the sharded output against
    one rank's within phase 15's bar."""
    from ml_conformer_generator_tpu_torch.models.egnn import dynamics_forward

    for dtype in ("bfloat16", "float32"):
        args = edges.parse_args(["--dtype", dtype])
        dyn = edges.make_model(edges.config(args), torch.device("cuda"))
        t, xh, nm, em, ctx = (v.cuda() for v in edges.make_inputs(
            args.batch, args.nodes))
        gk.reset_launch_counts()
        with torch.no_grad(), held_against_plain(torch, gk) as held:
            dynamics_forward(dyn, t, xh, nm, em, ctx)
            torch.cuda.synchronize()
        check(gk.LAUNCHES == forward_launches(1)
              and sorted(held) == [f"{dtype}_coord", f"{dtype}_gcl"],
              f"the held {dtype} forward: {gk.LAUNCHES}, {sorted(held)}")
        del dyn
        rec = edges.run(args)
        log(f"[tools] {json.dumps(dict(rec, phase='edges_scaling', held=held, nvidia_smi=smi))}")
        check(rec["launches_per_forward"] == {"gcl": 18, "coord": 9},
              f"edges launches a forward {rec['launches_per_forward']}")
        check(rec["value"] > 0 and 0.0 < rec["busy_share"] <= 1.05,
              f"edges {dtype}: {rec}")
    rec = edges.run(edges.parse_args(EDGES_MESH))
    log(f"[tools] {json.dumps(dict(rec, phase='edges_scaling_mesh', nvidia_smi=smi))}")
    check(rec["within_bar"] and rec["bar"] == [SHARDED_ATOL, SHARDED_RTOL],
          f"the sharded forward against one rank: {rec}")
    check(rec["launches_per_forward"] == {"gcl": 18, "coord": 9},
          f"a rank's sharded launches {rec['launches_per_forward']}")


def microbench_phase(torch, smi):
    """19c: the microbench twin at (128, 42, 420) in both types: the
    kernel's pass within the bar of the plain pass; the three times and
    the share of the bound."""
    for dtype in ("bfloat16", "float32"):
        rec = microbench.run(microbench.parse_args(["--dtype", dtype]))
        log(f"[tools] {json.dumps(dict(rec, phase='kernel_microbench', nvidia_smi=smi))}")
        check(rec["within_bar"]
              and tuple(rec["bar"]) == TOLERANCE[dtype, "gcl"],
              f"the microbench's kernel pass against plain: {rec}")


def breakdown_phase(torch, gk, gen, reference, smi, workdir,
                    name="trace_breakdown"):
    """19d (and 20f): one bf16 request of N_SAMPLES around ``reference``
    under ``torch.profiler`` (a warm generator: no W1 packed, no capture),
    its trace written and read by the breakdown twin: the edge category's
    events equal the request's launches (credited by the graph's replay),
    its time the profiler's key averages for those kernels within 1%, busy
    within the window. Logs the busy share and the five longest gaps with
    their host ops, as ``name``."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(workdir, name)
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    kw = dict(reference_conformer=reference, n_samples=N_SAMPLES,
              variance=VARIANCE)
    t0 = time.perf_counter()
    gen.generate_conformers(**kw)
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    gk.reset_launch_counts()
    gk.reset_pack_count()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate_conformers(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, packs = dict(gk.LAUNCHES), gk.PACKS
    t0 = time.perf_counter()
    prof.export_chrome_trace(os.path.join(trace_dir, "request.json"))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = breakdown_tool.breakdown(breakdown_tool.load_events(
        breakdown_tool.newest_trace(trace_dir)))
    parse_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    averaged = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == cuda and "edge_mlp" in e.key)
    edge = breakdown_tool.EDGE
    want = forward_launches(STEPS + 1)
    rec = {"phase": name, "request_s_profiled": wall,
           "request_s_unprofiled": unprofiled,
           "launches": launches, "w1_packs": packs,
           "device_events": rep["device_events"],
           "edge_events": rep["launches_by_category"].get(edge, 0),
           "edge_us": rep["by_category_us"].get(edge, 0.0),
           "edge_us_key_averages": averaged,
           "busy_us": rep["busy_us"], "window_us": rep["window_us"],
           "busy_share_of_window": rep["busy_us"] / rep["window_us"],
           "busy_share_of_request": rep["busy_us"] / 1e6 / wall,
           # the profiler slows the host, not the device's work
           "busy_share_of_request_unprofiled":
               rep["busy_us"] / 1e6 / unprofiled,
           "by_category_us": rep["by_category_us"],
           "longest_gaps": rep["gaps"], "export_s": export_s,
           "parse_s": parse_s, "nvidia_smi": smi}
    log(f"[tools] {json.dumps(rec)}")
    check(launches == want and packs == 0,
          f"the profiled request's launches {launches}, packs {packs}")
    check(rec["edge_events"] == want["gcl"] + want["coord"],
          f"edge events in the trace {rec['edge_events']}, expected "
          f"{want['gcl'] + want['coord']}")
    check(abs(rec["edge_us"] - averaged) <= 0.01 * averaged,
          f"edge time {rec['edge_us']} us against the key averages' "
          f"{averaged} us")
    check(0 < rep["busy_us"] <= rep["window_us"],
          f"busy {rep['busy_us']} us over a window of {rep['window_us']} us")
    check(len(rep["gaps"]) == 5, f"gaps: {rep['gaps']}")


def tools_phase(torch, gk, smi, workdir):
    """Phase 19, the JAX system's tools on the port: 19a the evaluation
    report, 19b edges a second, 19c the microbench, 19d the breakdown of a
    profiled request."""
    seconds, t0 = {}, time.perf_counter()
    gen, refs = report_phase(torch, gk, smi, workdir)
    seconds["19a"] = time.perf_counter() - t0
    edges_phase(torch, gk, smi)
    seconds["19b"] = time.perf_counter() - t0 - sum(seconds.values())
    microbench_phase(torch, smi)
    seconds["19c"] = time.perf_counter() - t0 - sum(seconds.values())
    breakdown_phase(torch, gk, gen, refs[0], smi, workdir)
    seconds["19d"] = time.perf_counter() - t0 - sum(seconds.values())
    log(f"[tools] phase 19: {time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(seconds)}")


# -- 20. the one-program trajectories ------------------------------------------

# Phase 20e's timed turns: this many of each route, graph and loop, in turns
# (graph, loop, loop, graph, ...), and as many fresh captures.
GRAPH_TURNS = 5


@contextlib.contextmanager
def sampler_loop(sampler):
    """Within: ``sampler`` runs its trajectories as the loop on the card,
    the comparison's own route (the sampler's class attribute turned off on
    the instance; nothing else reaches the loop with CUDA tensors)."""
    sampler._graphed = False
    try:
        yield
    finally:
        del sampler._graphed


def graph_against_loop(torch, gk, gen, kw, method, name, forwards,
                       requests=2, seed=41):
    """``requests`` requests in a row through ``gen`` from the noise seed
    ``seed``, first through the captured graphs (warm: no capture), then
    through the sampler's loop: the sampler's ``method`` outputs equal bit
    for bit request by request, the generator in one state after each
    route, exact launches (``forwards`` denoiser calls a request) in both
    and no W1 packed. Returns the record."""
    samples = recorded(gen, method)
    runs, graphs = {}, gen.sampler._graphs.captures
    try:
        for route in ("graph", "loop"):
            gen._generator.manual_seed(seed)
            gk.reset_pack_count()
            out, launches, secs = [], [], []
            with (sampler_loop(gen.sampler) if route == "loop"
                  else contextlib.nullcontext()):
                for _ in range(requests):
                    _, n, t = launches_of(
                        torch, gk, lambda: gen.generate_conformers(**kw))
                    out.append(samples[-1][:2])
                    launches.append(n)
                    secs.append(t)
            runs[route] = {"out": out, "launches": launches, "s": secs,
                           "packs": gk.PACKS,
                           "state": gen._generator.get_state()}
    finally:
        delattr(gen.sampler, method)            # recorded()'s wrapper
    g, l = runs["graph"], runs["loop"]
    equal = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
             for a, b in zip(g["out"], l["out"])]
    rec = {"request": name, "requests": requests, "bit_equal": equal,
           "state_equal": torch.equal(g["state"], l["state"]),
           "max_abs_dx": max((a[0] - b[0]).abs().max().item()
                             for a, b in zip(g["out"], l["out"])),
           "finite": all(torch.isfinite(a[0]).all().item()
                         for a in l["out"]),
           "launches": {"graph": g["launches"], "loop": l["launches"]},
           "w1_packs": {"graph": g["packs"], "loop": l["packs"]},
           "request_s": {"graph": g["s"], "loop": l["s"]},
           "captures_during": gen.sampler._graphs.captures - graphs}
    log(f"[graphs] {json.dumps(rec)}")
    want = forward_launches(forwards)
    check(all(equal) and rec["state_equal"],
          f"{name}: graph and loop differ: {rec}")
    check(all(n == want for n in g["launches"] + l["launches"]),
          f"{name}: launches {rec['launches']}, expected {want} a request")
    check(rec["captures_during"] == 0 and g["packs"] == 0 and l["packs"] == 0,
          f"{name}: a capture or a W1 pack in a counted request: {rec}")
    return rec


def relax_graph_phase(torch, reference):
    """20c: ``relax`` through its captured graph against the loop of its
    steps (``fire_steps``) on the card: phase 12's batch (its copies that
    standardize) in float32 and float64 and ``_RING``'s copies in float32,
    bit for bit on the coordinates with the same branch history, at a
    capture and at a replay; every well-conditioned ring copy within
    ``FF_BAR`` of the CPU; the 200 steps' seconds, graph and loop in turns
    (synchronised, phase 12's batch in float32)."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.chem import forcefield
    from ml_conformer_generator_tpu_torch.chem.standardize import \
        standardize_batch

    _, copies = reference_copies(reference, 64)
    batch = [m for m in standardize_batch(copies, optimize_geometry_flag=False,
                                          device="cpu") if m is not None]
    ring = ring_copies(8, 0)
    rec = {"phase": "relax_graph", "molecules": len(batch)}
    for name, mols, dtypes in (("batch", batch, (torch.float32,
                                                 torch.float64)),
                               ("ring", ring, (torch.float32,))):
        for dtype in dtypes:
            runs = [relax_batch(torch, mols, "cuda", dtype) for _ in range(2)]
            loop = relax_batch(torch, mols, "cuda", dtype, loop=True)
            same = [np.array_equal(x, loop[0]) and np.array_equal(u, loop[1])
                    for x, u in runs]
            key = f"{name}_{str(dtype)[6:]}"
            rec[key] = {"capture_and_replay_bit_equal_to_loop": same,
                        "uphill_steps": int(loop[1].sum())}
            check(all(same), f"relax {key}: graph and loop differ")
    c32, _ = relax_batch(torch, ring, "cuda", torch.float32)
    p32, _ = relax_batch(torch, ring, "cpu", torch.float32)
    p64, _ = relax_batch(torch, ring, "cpu", torch.float64)
    well = [k for k in range(len(ring))
            if np.abs(p32[k] - p64[k]).max() <= WELL_CONDITIONED]
    d32 = [float(np.abs(c32[k] - p32[k]).max()) for k in well]
    rec["ring_well_conditioned"] = well
    rec["ring_float32_abs_diff"] = d32
    check(all(d <= FF_BAR for d in d32),
          f"a well-conditioned ring copy beyond {FF_BAR} A: {rec}")

    x0, ff = relax_inputs(torch, batch, "cuda", torch.float32)

    def timed(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            if route == "graph":
                forcefield.relax(x0, ff)
            else:
                forcefield.fire_steps(x0, ff, 200, lambda k, u: None)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    turns = {"graph": [], "loop": []}
    for route in ("graph", "loop", "loop", "graph", "graph", "loop"):
        turns[route].append(timed(route))
    rec["fire_200_steps_s"] = turns
    log(f"[graphs] {json.dumps(rec)}")
    return rec


def device_busy_s(torch, prof):
    """Seconds in which the card ran anything (kernels, copies, sets) in a
    ``torch.profiler`` run: the union of its device events' intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.duration_ns() > 0)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9


# Phase 20g's batches: the request's and the most samples the app takes in
# one request (``app/server.py``: n_samples in [1, 200]).
MEMORY_SAMPLES = (N_SAMPLES, 200)


def graph_memory_phase(torch, gen, kw, fragment, reference):
    """20g: what captured graphs hold on the card. Across each capture, the
    change in ``torch.cuda.memory_reserved()`` (the allocator's cache
    emptied before and after: the static inputs and outputs and the private
    pool) and the static inputs' own bytes: the bf16 generate, inpaint and
    IFM requests at each of MEMORY_SAMPLES on an emptied sampler cache, and
    ``relax`` of phase 12's batch and of the copies of the largest; then
    GRAPHS_KEPT generate graphs at the largest batch (distinct batch
    sizes), the sampler's cache at its bound. Returns the record."""
    import functools
    import gc

    from ml_conformer_generator_tpu_torch.chem import forcefield
    from ml_conformer_generator_tpu_torch.chem.standardize import \
        standardize_batch
    from ml_conformer_generator_tpu_torch.diffusion import edm
    from ml_conformer_generator_tpu_torch.utils.cuda_graph import GraphCache
    from ml_conformer_generator_tpu_torch.utils.masks import prepare_masks

    mib = 2.0 ** 20
    readings, label = [], [""]

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def measured(capture):
        def run(fn, inputs, **k):
            r0 = reserved()
            t0 = time.perf_counter()
            graph = capture(fn, inputs, **k)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            readings.append({
                "request": label[0],
                "graph": ("relax" if "history" in inputs
                          else fn.args[0]["trajectory"]),
                "B": next(iter(inputs.values())).shape[0]
                if "history" in inputs else inputs["node_mask"].shape[0],
                "capture_s": secs,
                "reserved_mib": (reserved() - r0) / mib,
                "inputs_mib": sum(t.nbytes for t in inputs.values()) / mib})
            return graph
        return run

    captures = edm.capture, forcefield.capture
    edm.capture, forcefield.capture = map(measured, captures)
    try:
        for n in MEMORY_SAMPLES:
            for name, extra in (
                    ("generate", {}),
                    ("inpaint", dict(fixed_fragment=fragment,
                                     inertial_fragment_matching=False)),
                    ("ifm", dict(fixed_fragment=fragment,
                                 inertial_fragment_matching=True))):
                gen.sampler._graphs = GraphCache(gen.sampler.GRAPHS_KEPT)
                label[0] = f"{name}_{n}"
                gen.generate_conformers(**dict(kw, n_samples=n, **extra))
        _, copies = reference_copies(reference, max(MEMORY_SAMPLES))
        batch = [m for m in standardize_batch(
            copies, optimize_geometry_flag=False, device="cpu")
            if m is not None]
        for mols in (batch[:len(batch) * N_SAMPLES // len(copies)], batch):
            forcefield._GRAPHS = GraphCache(forcefield._GRAPHS.maxsize)
            label[0] = f"relax_{len(mols)}"
            x0, ff = relax_inputs(torch, mols, "cuda", torch.float32)
            with torch.no_grad():
                forcefield.relax(x0, ff)
    finally:
        edm.capture, forcefield.capture = captures

    log(f"[graphs] {json.dumps({'phase': 'graph_memory', 'captures': readings})}")
    # the sampler's cache at its bound, at the largest batch
    sampler, B = gen.sampler, max(MEMORY_SAMPLES)
    sampler._graphs = GraphCache(sampler.GRAPHS_KEPT)
    r0 = reserved()
    kept = []
    for i in range(sampler.GRAPHS_KEPT):
        n = torch.full((B - i,), 39, device="cuda")
        nm, em = prepare_masks(n, 40)
        static = dict(trajectory="generate", resample_steps=0,
                      diffusion_level=0, t_dtype=gen.gamma.dtype)
        inputs = sampler.buffers(
            gen._generator, gen.gamma, blend_power=3, dtype=gen.dtype,
            node_mask=nm, edge_mask=em,
            context=torch.zeros((B - i, 40, 3), device="cuda"), **static)
        replay = functools.partial(sampler.from_buffers, static)
        with torch.no_grad():
            kept.append(edm.capture(
                replay, inputs, warmup=functools.partial(replay, steps=1)))
        del inputs
    bound = (reserved() - r0) / mib
    del kept
    rec = {"phase": "graph_memory", "captures": readings,
           "bound": {"graphs": sampler.GRAPHS_KEPT, "samples": B,
                     "reserved_mib": bound}}
    log(f"[graphs] {json.dumps(rec['bound'])}")
    check(len(readings) >= 2 * 4 and all(r["reserved_mib"] > 0
                                         for r in readings),
          f"graph memory: {rec}")
    return rec


def graph_timing_phase(torch, gk, gen, kw):
    """20e: the bf16 request (phase 5's) through the captured graph and
    through the sampler's loop, GRAPH_TURNS each in turns, unprofiled:
    request seconds, ``edm_sampling_s``, ``standardize_s``; then as many
    turns again under ``torch.profiler`` (device events only) for the
    card's busy share over the request; and GRAPH_TURNS requests each on
    an emptied graph cache, the capture's seconds (warm-up, recording and
    instantiation) timed around ``capture``. Returns median and range of
    each."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from ml_conformer_generator_tpu_torch.diffusion import edm
    from ml_conformer_generator_tpu_torch.utils.cuda_graph import GraphCache

    def request(route, profiled=False):
        ctx = (sampler_loop(gen.sampler) if route == "loop"
               else contextlib.nullcontext())
        prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
                else contextlib.nullcontext())
        with ctx, prof as p:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate_conformers(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = {"request_s": wall,
               "edm_sampling_s": gen.last_metrics["edm_sampling_s"],
               "standardize_s": gen.last_metrics["standardize_s"]}
        if profiled:
            out["busy_share"] = device_busy_s(torch, p) / wall
        return out

    order = (["graph", "loop", "loop", "graph"] * GRAPH_TURNS)[:2 * GRAPH_TURNS]
    turns = {"graph": [], "loop": []}
    for route in order:
        turns[route].append(request(route))
    busy = {"graph": [], "loop": []}
    for route in order:
        busy[route].append(request(route, profiled=True)["busy_share"])
    capture, captured = edm.capture, []

    def timed_capture(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = capture(*a, **k)
        torch.cuda.synchronize()
        captured.append(time.perf_counter() - t0)
        return graph

    edm.capture = timed_capture
    first = []
    try:
        for _ in range(GRAPH_TURNS):
            gen.sampler._graphs = GraphCache(gen.sampler.GRAPHS_KEPT)
            first.append(request("graph"))
    finally:
        edm.capture = capture

    def spread(values):
        return {"median": statistics.median(values), "min": min(values),
                "max": max(values)}

    rec = {"phase": "graph_timing", "turns": GRAPH_TURNS, "order": order}
    for route, rs in turns.items():
        rec[route] = {k: spread([r[k] for r in rs]) for k in rs[0]}
        rec[route]["busy_share"] = spread(busy[route])
    rec["capture_s"] = spread(captured)
    rec["first_request_s"] = spread([r["request_s"] for r in first])
    log(f"[graphs] {json.dumps(rec)}")
    check(len(captured) == GRAPH_TURNS,
          f"{len(captured)} captures in {GRAPH_TURNS} fresh requests")
    check(all(0.0 < b <= 1.0 for bs in busy.values() for b in bs),
          f"a busy share outside (0, 1]: {rec}")
    return rec


def graphs_phase(torch, gk, gens, reference, kw, fragment, smi, workdir):
    """Phase 20, the JAX package's execution model on the card: (20a) the
    bf16 and float32 requests, two in a row, graph against loop; (20b) the
    bf16 inpaint and IFM requests at phase 5d's fragment, the same way;
    (20c) ``relax`` graph against loop; (20d) in each, exact launches
    credited by the replay and no W1 packed; (20e) the timed turns; (20f)
    one graphed request traced and broken down; (20g) the graphs' memory."""
    t0 = time.perf_counter()
    recs = {}
    for name, gen in gens.items():
        recs[name] = graph_against_loop(torch, gk, gen, kw, "generate",
                                        f"generate_{name}", STEPS + 1)
    bf16 = gens["bfloat16"]
    frag = dict(kw, fixed_fragment=fragment)
    recs["inpaint"] = graph_against_loop(
        torch, gk, bf16, dict(frag, inertial_fragment_matching=False),
        "inpaint", "inpaint", 2 * STEPS + 1)
    recs["ifm"] = graph_against_loop(
        torch, gk, bf16, dict(frag, inertial_fragment_matching=True),
        "merge_fragments", "ifm", (STEPS + 1) + (min(50, STEPS - 1) + 1) + 1)
    recs["relax"] = relax_graph_phase(torch, reference)
    recs["memory"] = graph_memory_phase(torch, bf16, kw, fragment, reference)
    recs["timing"] = graph_timing_phase(torch, gk, bf16, kw)
    breakdown_phase(torch, gk, bf16, reference, smi, workdir,
                    name="graph_trace_breakdown")
    log(f"[graphs] phase 20: {time.perf_counter() - t0:.1f} s; {smi}")
    return recs


# -- 21. the one-program train steps ---------------------------------------------

# Phase 21a's steps, graph against loop, with the EMA after each, through the
# warmup of a warmup-cosine schedule of (total steps, warmup steps).
TRAIN_GRAPH_STEPS = 6
TRAIN_SCHEDULE = (12, 2)
# Phase 21d's timed turns: this many of each route (graph, loop, loop,
# graph, ...), TRAIN_TURN_STEPS steps each.
TRAIN_TURNS = 4
TRAIN_TURN_STEPS = 4
# Phase 21e's runs of the overfit twin's training, graph and loop: (EDM
# steps, bond steps); its defaults (1500, 600) would take minutes a route.
TWIN_STEPS = (200, 200)


def train_batches(ds, B, n, n_pad=None):
    """``n`` batches of ``B`` molecules of ``ds``, epoch after epoch."""
    import numpy as np

    from ml_conformer_generator_tpu_torch.training import batches

    out, epoch = [], 0
    while len(out) < n:
        out += list(batches(ds, B, rng=np.random.default_rng(epoch),
                            n_pad=n_pad))
        epoch += 1
    return out[:n]


def train_setup(torch, seed, schedule=(0, 0)):
    """A full-width float32 denoiser from ``seed`` on the card, its EMA
    copy and its AdamW state (lr 1e-4; ``schedule``: (total steps, warmup
    steps) of a warmup-cosine, (0, 0) constant)."""
    import copy

    from ml_conformer_generator_tpu_torch.config import EGNNConfig
    from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
    from ml_conformer_generator_tpu_torch.training import (init_train_state,
                                                           make_optimizer)

    model = EGNNDynamics(EGNNConfig(),
                         torch.Generator().manual_seed(seed)).cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    state = init_train_state(model, make_optimizer(
        lr=1e-4, total_steps=schedule[0], warmup_steps=schedule[1]))
    return model, ema, state


def train_step_and_ema(torch, step, model, ema, state, gen, batch, gamma, t):
    """One train step and the EMA update after it, synchronised: (metrics,
    seconds)."""
    from ml_conformer_generator_tpu_torch.training.loop import ema_update_

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(model, state, gen, batch, gamma)
    ema_update_(ema, model, 0.999, t)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def train_graph_against_loop(torch, gk, ds, B, n_pad, name):
    """21a-b: TRAIN_GRAPH_STEPS full-width steps (420 x 9, float32, remat)
    with the EMA update after each and a warmup-cosine through its warmup,
    through the graphs and through the loop from the same weights, batches
    and draws: every step's loss and mean t, and after the last the
    parameters, gradients, AdamW moments and counts, the EMA, the learning
    rate and the generator, bit for bit; every step 36 / 18 forward and 18
    / 9 backward launches and 27 W1 packs, a replay's credited from what
    its capture recorded. Returns the record and the graphed (model, state,
    step, batches, gamma)."""
    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import make_train_step

    cfg, diff = EGNNConfig(), DiffusionConfig()
    blocks = cfg.n_blocks
    gamma = torch.from_numpy(gamma_schedule(diff.timesteps))
    batches = train_batches(ds, B, TRAIN_GRAPH_STEPS, n_pad)
    step = make_train_step(make_mesh(device="cuda"), cfg, diff)
    runs = {}
    for route in ("graph", "loop"):
        model, ema, state = train_setup(torch, 31, TRAIN_SCHEDULE)
        lr = state.optimizer.param_groups[0]["lr"]
        gen = torch.Generator(device="cuda").manual_seed(17)
        run = runs[route] = {"model": model, "ema": ema, "state": state,
                             "metrics": [], "launches": [], "packs": [],
                             "s": [], "lr": []}
        with train_loop() if route == "loop" else contextlib.nullcontext():
            for t, batch in enumerate(batches):
                gk.reset_launch_counts()
                gk.reset_pack_count()
                m, secs = train_step_and_ema(torch, step, model, ema, state,
                                             gen, batch, gamma, t)
                run["metrics"].append(m)
                run["launches"].append(dict(gk.LAUNCHES))
                run["packs"].append(gk.PACKS)
                run["s"].append(secs)
                run["lr"].append(float(lr))
        run["lr_same_tensor"] = state.optimizer.param_groups[0]["lr"] is lr
        run["generator"] = gen.get_state()
    g, l = runs["graph"], runs["loop"]
    pairs = list(zip(g["model"].parameters(), l["model"].parameters()))
    moments = [(g["state"].optimizer.state[p][k],
                l["state"].optimizer.state[q][k])
               for p, q in pairs for k in ("exp_avg", "exp_avg_sq", "step")]
    equal = {
        "loss_and_mean_t": all(
            torch.equal(a[k], b[k]) for a, b in zip(g["metrics"],
                                                     l["metrics"])
            for k in ("loss", "mean_t")),
        "parameters": all(torch.equal(p, q) for p, q in pairs),
        "gradients": all(torch.equal(p.grad, q.grad) for p, q in pairs),
        "adamw_state": all(torch.equal(a, b) for a, b in moments),
        "ema": all(torch.equal(a, b) for a, b in zip(
            g["ema"].parameters(), l["ema"].parameters())),
        "lr": g["lr"] == l["lr"],
        "generator": torch.equal(g["generator"], l["generator"])}
    want = launch_counts(4 * blocks, 2 * blocks, 2 * blocks, blocks)
    rec = {"phase": "train_graph", "case": name, "B": B,
           "N": int(batches[0]["x"].shape[1]), "steps": len(batches),
           "schedule": TRAIN_SCHEDULE, "bit_equal": equal,
           "lr_by_step": g["lr"],
           "losses": [float(m["loss"]) for m in g["metrics"]],
           "lr_same_tensor": g["lr_same_tensor"],
           "launches": {r: runs[r]["launches"] for r in runs},
           "w1_packs": {r: runs[r]["packs"] for r in runs},
           "step_and_ema_s": {r: runs[r]["s"] for r in runs}}
    log(f"[train-graph] {json.dumps(rec)}")
    check(all(equal.values()), f"{name}: graph and loop differ: {equal}")
    check(g["lr_same_tensor"], f"{name}: the schedule replaced the lr tensor")
    check(all(n == want for r in runs for n in runs[r]["launches"]),
          f"{name}: launches a step {rec['launches']}, expected {want}")
    check(all(n == 3 * blocks for r in runs for n in runs[r]["packs"]),
          f"{name}: W1 packs a step {rec['w1_packs']}")
    check(len(set(g["lr"][:TRAIN_SCHEDULE[1] + 2])) > 2,
          f"{name}: the schedule did not move: {g['lr']}")
    del runs["loop"], l
    return rec, (g["model"], g["state"], step, batches, gamma)


def train_graph_held(torch, gk, graphed, ds, B, n_pad):
    """21c: (i) an eager forward on the live model after its replays: every
    W1 packed afresh (the replays moved the weights' versions) and each
    kernel call held against the plain version; (ii) a fresh model's first
    step (the capture's warm-up) and second (a replay) within
    ``held_against_plain``: every kernel call of the warm-up, and every call
    the replay made (36 / 18 forward, 18 / 9 backward), held against the
    plain version on that replay's inputs. Returns the record."""
    from ml_conformer_generator_tpu_torch.models.egnn import dynamics_forward

    model, _, step, batches, gamma = graphed
    b = {k: torch.as_tensor(v, device="cuda") for k, v in batches[0].items()}
    gk.reset_pack_count()
    gk.reset_launch_counts()
    with torch.no_grad(), held_against_plain(torch, gk) as eager:
        dynamics_forward(model, torch.full((B,), 0.5, device="cuda"),
                         torch.cat([b["x"], b["h"]], -1), b["node_mask"],
                         b["edge_mask"], b["context"], model.cfg)
        torch.cuda.synchronize()
    eager_packs = gk.PACKS
    blocks = model.cfg.n_blocks
    check(eager_packs == 3 * blocks,
          f"the eager forward after replays packed {eager_packs} W1")
    check(sorted(eager) == ["float32_coord", "float32_gcl"],
          f"kernels held in the eager forward: {sorted(eager)}")

    fresh, ema, state = train_setup(torch, 32)
    with held_against_plain(torch, gk) as held:
        for t, batch in enumerate(batches[:2]):
            train_step_and_ema(torch, step, fresh, ema, state,
                               torch.Generator(device="cuda").manual_seed(t),
                               batch, gamma, t)
        held_replay(torch, gk, held)
    calls = {k: v["calls"] for k, v in held.items()}
    want = {"float32_gcl": 4 * blocks, "float32_coord": 2 * blocks,
            "float32_gcl_bwd": 2 * blocks, "float32_coord_bwd": blocks}
    want.update({f"replayed_{k}": n for k, n in want.items()})
    rec = {"phase": "train_graph_held", "eager_forward_after_replays": eager,
           "eager_forward_w1_packs": eager_packs, "step_calls": held}
    log(f"[train-graph] {json.dumps(rec)}")
    check(calls == want, f"kernel calls held in the warm-up and the replay: "
          f"{calls}, expected {want}")
    del fresh, ema, state
    return rec


def train_graph_timing(torch, gk, ds, B, n_pad, name):
    """21d: the step with the EMA after it, graph and loop, TRAIN_TURNS
    turns of TRAIN_TURN_STEPS steps each, in turns: median and range of a
    step's seconds; the card's busy share over TRAIN_TURN_STEPS profiled
    steps of each; the graphed route's first step (the captures of the step
    and of the EMA, their warm-ups), each capture's seconds, and the
    allocator's reserved memory across that first step (its cache emptied
    before and after). Returns the record."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                         EGNNConfig)
    from ml_conformer_generator_tpu_torch.diffusion.schedule import \
        gamma_schedule
    from ml_conformer_generator_tpu_torch.parallel import make_mesh
    from ml_conformer_generator_tpu_torch.training import make_train_step
    from ml_conformer_generator_tpu_torch.utils import cuda_graph

    cfg, diff = EGNNConfig(), DiffusionConfig()
    gamma = torch.from_numpy(gamma_schedule(diff.timesteps))
    batches = train_batches(ds, B, TRAIN_TURN_STEPS, n_pad)
    step = make_train_step(make_mesh(device="cuda"), cfg, diff)
    routes = {r: train_setup(torch, 33) for r in ("graph", "loop")}
    gens = {r: torch.Generator(device="cuda").manual_seed(5) for r in routes}
    counter = {r: 0 for r in routes}

    def run(route, n=1):
        model, ema, state = routes[route]
        secs = []
        with train_loop() if route == "loop" else contextlib.nullcontext():
            for k in range(n):
                _, t = train_step_and_ema(
                    torch, step, model, ema, state, gens[route],
                    batches[k % len(batches)], gamma, counter[route])
                counter[route] += 1
                secs.append(t)
        return secs

    capture, captured = cuda_graph.capture, []

    def timed_capture(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = capture(*a, **k)
        torch.cuda.synchronize()
        captured.append(time.perf_counter() - t0)
        return graph

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    cuda_graph.capture = timed_capture
    try:
        first = run("graph")[0]
    finally:
        cuda_graph.capture = capture
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved()
    loop_first = run("loop")[0]
    order = (["graph", "loop", "loop", "graph"] * TRAIN_TURNS)[:2 * TRAIN_TURNS]
    turns = {"graph": [], "loop": []}
    for route in order:
        turns[route] += run(route, TRAIN_TURN_STEPS)
    busy = {}
    for route in ("graph", "loop"):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(route, TRAIN_TURN_STEPS)
            wall = time.perf_counter() - t0
        busy[route] = {"wall_s": wall, "device_busy_s": device_busy_s(torch, p),
                       "busy_share": device_busy_s(torch, p) / wall}

    def spread(values):
        return {"median": statistics.median(values), "min": min(values),
                "max": max(values)}

    rec = {"phase": "train_graph_timing", "case": name, "B": B,
           "N": int(batches[0]["x"].shape[1]), "turns": TRAIN_TURNS,
           "steps_a_turn": TRAIN_TURN_STEPS, "order": order,
           "step_and_ema_s": {r: spread(v) for r, v in turns.items()},
           "molecules_per_s": {r: B / statistics.median(v)
                               for r, v in turns.items()},
           "profiled": busy, "first_graphed_step_s": first,
           "first_loop_step_s": loop_first, "captures_s": captured,
           "reserved_across_first_step_mib": (reserved1 - reserved0) / 2**20}
    log(f"[train-graph] {json.dumps(rec)}")
    check(len(captured) == 2, f"{len(captured)} captures in the first graphed "
          f"step, expected 2 (the step and the EMA)")
    check(all(0.0 < b["busy_share"] <= 1.0 for b in busy.values()),
          f"a busy share outside (0, 1]: {busy}")
    del routes
    return rec


def bond_graph_phase(torch, twin_mols, corpus_mols):
    """21e: ``train_adj_mat_seer`` (AdjMatSeer 2048) through its graph and
    through the loop: full batch on the overfit twin's three molecules, 200
    steps a run in turns (graph, loop, loop, graph), and sampled batches of
    64 of phase 13's corpus, 20 steps a route: losses and weights bit for
    bit, seconds a run."""
    from ml_conformer_generator_tpu_torch.training import train_adj_mat_seer

    def run(route, mols, steps, batch_size):
        with train_loop() if route == "loop" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_adj_mat_seer(mols, steps=steps, lr=3e-4,
                                     batch_size=batch_size, seed=0,
                                     log_every=1, log_fn=lambda s: None,
                                     device="cuda")
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rec = {"phase": "bond_graph"}
    for case, mols, steps, batch_size, order in (
            ("full", twin_mols, 200, 0, ("graph", "loop", "loop", "graph")),
            ("sampled", corpus_mols, 20, TRAIN_B, ("graph", "loop"))):
        runs = {"graph": [], "loop": []}
        for route in order:
            runs[route].append(run(route, mols, steps, batch_size))
        (g, _), (l, _) = runs["graph"][0], runs["loop"][0]
        equal = (g["history"] == l["history"] and all(
            torch.equal(p, q) for p, q in zip(g["params"].parameters(),
                                               l["params"].parameters())))
        rec[case] = {"steps": steps, "batch_size": batch_size,
                     "molecules": len(mols), "bit_equal": equal,
                     "loss_first_last": [g["history"][0]["loss"],
                                         g["history"][-1]["loss"]],
                     "s": {r: [t for _, t in v] for r, v in runs.items()}}
        check(equal, f"AdjMatSeer {case}: graph and loop differ")
    log(f"[train-graph] {json.dumps(rec)}")
    return rec


def twin_training_phase(torch, smi, workdir):
    """21e: the overfit twin's training (``train_models``: EDM with EMA and
    a warmup-cosine, then AdjMatSeer) at TWIN_STEPS, through the graphs and
    through the loop, one run each: its seconds a route. Returns the twin's
    arguments and corpus (``build_corpus``'s molecules and training set)."""
    steps, bond_steps = TWIN_STEPS
    args = overfit.parse_args([
        "--edm-steps", str(steps), "--bond-steps", str(bond_steps),
        "--out", os.path.join(workdir, "overfit_turns"), "--device", "cuda"])
    mols, train_mols, _ = overfit.build_corpus(args)
    rec = {"phase": "twin_training", "edm_steps": steps,
           "bond_steps": bond_steps}
    for route in ("graph", "loop"):
        with train_loop() if route == "loop" else contextlib.nullcontext():
            out = overfit.train_models(args, mols, train_mols)
        hist = out["history"]["edm"]
        rec[route] = {"edm_train_s": out["edm_train_s"],
                      "edm_steps": out["edm_steps"],
                      "bond_train_s": out["bond_train_s"],
                      "edm_loss_first_last": [hist[0]["loss"],
                                              hist[-1]["loss"]]}
    rec["nvidia_smi"] = smi
    log(f"[train-graph] {json.dumps(rec)}")
    check(rec["graph"]["edm_steps"] == rec["loop"]["edm_steps"] > 0,
          f"twin runs: {rec}")
    return args, mols, train_mols


def train_graphs_phase(torch, gk, corpus, smi, workdir):
    """Phase 21, the JAX package's jitted train steps on the card: (21a-b)
    graph against loop at (64, 39) on phase 13's corpus and at the overfit
    twin's (32, 39), with exact launches and packs; (21c) the eager forward
    after replays and a replayed step's kernel calls, held; (21d) the timed
    turns at both shapes; (21e) AdjMatSeer and the twin's training, graph
    against loop. Returns the (64, 39) record of 21a."""
    from ml_conformer_generator_tpu_torch.training import MoleculeDataset

    t0 = time.perf_counter()
    rec64, graphed = train_graph_against_loop(torch, gk, corpus, TRAIN_B,
                                              TRAIN_N, "B64")
    train_graph_held(torch, gk, graphed, corpus, TRAIN_B, TRAIN_N)
    del graphed
    args, twin_mols, twin_train = twin_training_phase(torch, smi, workdir)
    twin_ds = MoleculeDataset(twin_train)
    train_graph_against_loop(torch, gk, twin_ds, args.batch, None, "B32")
    timing = [train_graph_timing(torch, gk, corpus, TRAIN_B, TRAIN_N, "B64"),
              train_graph_timing(torch, gk, twin_ds, args.batch, None,
                                 "B32")]
    bond_graph_phase(torch, twin_mols, corpus.mols)
    log(f"[train-graph] phase 21: {time.perf_counter() - t0:.1f} s; {smi}; "
        + json.dumps({t["case"]: {"graph": t["step_and_ema_s"]["graph"],
                                  "loop": t["step_and_ema_s"]["loop"],
                                  "busy": {r: b["busy_share"] for r, b in
                                           t["profiled"].items()}}
                      for t in timing}))
    return rec64


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


def compare_runs(other, script, tag, args=()):
    """Run ``script`` (Python that prints one JSON line after ``tag``) in
    the checkout at ``other`` (the parent's, say) and in this one, in
    turns: other, this, this, other, each in a process of its own that
    imports its own package. Logs one JSON line a run; returns non-zero if
    one failed."""
    rc = 0
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        p = subprocess.run([sys.executable, "-c", script, *args], cwd=root,
                           capture_output=True, text=True, timeout=900)
        line = [l for l in p.stdout.splitlines() if l.startswith(tag + " ")]
        if p.returncode or not line:
            log(f"[compare] {name} {root} failed:\n{(p.stdout + p.stderr)[-3000:]}")
            rc = 1
            continue
        log(f"[compare] {json.dumps(dict(json.loads(line[0][len(tag) + 1:]), run=name))}")
    return rc


def compare_train(other):
    """The backward call at the training shape and the train step of the
    checkout at ``other`` and of this one, in turns (``compare_runs``)."""
    return compare_runs(other, _TRAIN_RUN, "TRAIN_RUN")


# One checkout's bf16 kernel (the checkout is the working directory; this
# file's functions do the timing and read the clocks), for compare_bf16.
_BF16_RUN = r"""
import importlib.util, json, sys, torch
smoke, sys.argv = sys.argv[1], ["chip_smoke.py"]
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_timing", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
torch.backends.cuda.matmul.allow_tf32 = False
card = (torch.cuda.get_device_properties(0).multi_processor_count, 1.98e9)
out = {"times": [], "clocks": []}
drugs = [(s, cs.DRUGS_H) for s in cs.DRUGS_PROFILE_SHAPES]
for (B, N, sizes), H in [(s, 420) for s in cs.BF16_COMPARE_SHAPES] + drugs:
    out["times"] += [{k: r[k] for k in ("mode", "B", "N", "H", "kernel_ms",
                                         "kernel_graph_ms",
                                         "bound_us", "share_of_bound",
                                         "max_abs_err", "out_sha")}
                     for r in cs.kernel_phase(torch, gk, B, N, sizes, card,
                                              H=H, dtypes=("bfloat16",))]
for (B, N, sizes), H in [(s, 420) for s in cs.BF16_PROFILE_SHAPES] + drugs:
    out["clocks"] += cs.phase_clocks(torch, gk, B, N, sizes, torch.bfloat16,
                                     H=H)
print("BF16_RUN " + json.dumps(out))
"""


def compare_bf16(other):
    """The bf16 edge kernel of the checkout at ``other`` and of this one, in
    turns (``compare_runs``): at BF16_COMPARE_SHAPES (H = 420) and
    DRUGS_PROFILE_SHAPES (H = 256) each mode held against its plain
    version, timed beside the bound and its output's bits digested, and at
    BF16_PROFILE_SHAPES and DRUGS_PROFILE_SHAPES its clocks read. Logs the
    card first."""
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip())
    return compare_runs(other, _BF16_RUN, "BF16_RUN", (os.path.abspath(__file__),))


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
    if "--compare-bf16" in sys.argv[1:]:
        return compare_bf16(
            os.path.abspath(sys.argv[sys.argv.index("--compare-bf16") + 1]))

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

    if "--f32-wide" in sys.argv[1:]:
        log(smi)
        if "--compare-f32" in sys.argv[1:]:
            compare_f32(os.path.abspath(
                sys.argv[sys.argv.index("--compare-f32") + 1]))
        f32_wide_phase(torch, gk, card)
        drugs_train_phase(torch, gk)
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    if "--drugs" in sys.argv[1:]:
        from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

        wide_kernel_phase(torch, gk, card)
        for B, N, sizes in DRUGS_SHAPES:
            kernel_phase(torch, gk, B, N, sizes, card, H=DRUGS_H,
                         dtypes=("bfloat16",))
        if "--profile" in sys.argv[1:]:
            for B, N, sizes in DRUGS_PROFILE_SHAPES:
                phase_clocks(torch, gk, B, N, sizes, torch.bfloat16,
                             H=DRUGS_H)
        drugs_phase(torch, gk)
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

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
    log("[kernel] the edges twin's shape (B=128 N=42, graphs of 25-39 "
        "nodes)")
    kernel_phase(torch, gk, 128, 42, (25, 39), card)
    path = kernel_phase(torch, gk, N_SAMPLES, n_pad,
                        (ref_n - VARIANCE, max_n), card)
    log(f"[kernel] the bf16 wide path (128 < N <= 192) at H={DRUGS_H}: "
        f"{WIDE_SHAPES}")
    wide = wide_kernel_phase(torch, gk, card)
    log(f"[kernel] the float32 wide paths (128 < N <= 192) at H={DRUGS_H}: "
        f"{F32_WIDE_SHAPES}, then the N <= 128 float32 kernels at "
        f"{F32_DRUGS_SHAPES}")
    f32_wide = f32_wide_phase(torch, gk, card)
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

    # -- 4b. EDM GEOM-Drugs' front end at 181 atoms: the wide path -------------
    drugs = drugs_phase(torch, gk)

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
        # min(50, T - 1) + 1 + 1 (T = 4); each trajectory's first request
        # also warms up its capture
        forwards = (9 + WARMUP_FORWARDS["inpaint"] if not ifm else
                    5 + 4 + 1 + WARMUP_FORWARDS["generate"]
                    + WARMUP_FORWARDS["merge"])
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
    check(gk.LAUNCHES == forward_launches(3 + WARMUP_FORWARDS["generate"]),
          f"launches with max_n_nodes=60: {gk.LAUNCHES}")
    del big

    # 5b. the request, at full width in bf16 (the default), then in float32
    kw = dict(reference_conformer=reference, n_samples=N_SAMPLES,
              variance=VARIANCE, optimise_geometry=True)
    requests, gens = {}, {}
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
        gens[name] = gen
    bf16_gen = gens["bfloat16"]
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
        for B, N, sizes in BF16_PROFILE_SHAPES:
            phase_clocks(torch, gk, B, N, sizes, torch.bfloat16)
        phase_clocks(torch, gk, N_SAMPLES, n_pad, (ref_n - VARIANCE, max_n),
                     torch.float32)
        phase_clocks(torch, gk, 128, 40, (15, 39), torch.float32)
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
    log("[drugs-train] EDM GEOM-Drugs' train step at pad 184 (the float32 "
        "wide kernels), captured and replayed, against the plain version")
    drugs_train = drugs_train_phase(torch, gk)
    train_loop_phase(torch, gk, corpus, reference, workdir)
    bond_training_phase(torch, corpus)
    train_launches = train_rec["launches"]

    # -- 14. the j-slab edge kernels ------------------------------------------
    slabs = []
    for B, N, NL, sizes in SLAB_FWD:
        slabs += slab_phase(torch, gk, B, N, NL, sizes, backward=False)
    for B, N, NL, sizes in SLAB_BWD:
        slabs += slab_phase(torch, gk, B, N, NL, sizes, backward=True)

    # -- 15. the sharded paths, two gloo ranks on the card ----------------------
    sharded = sharded_phase(torch, corpus, workdir)
    sharded_launches = sharded["train"]["steps"][0]["launches"]

    # -- 16. the screening driver ---------------------------------------------------
    screening_phase(torch, gk, bf16_gen)

    # -- 17. deployment: exported programs, the AOT request, cache, debug --------
    aot_launches = deployment_phase(torch, gk, bf16_gen, reference, kw,
                                    workdir)

    # -- 18. the overfit-validity path: train, save, serve, count -----------------
    overfit_launches = validity_phase(torch, gk, smi, workdir)

    # -- 19. the JAX system's tools on phase 18's weights ------------------------
    tools_phase(torch, gk, smi, workdir)

    # -- 20. the one-program trajectories: graph against loop ---------------------
    graphs_phase(torch, gk, gens, reference, kw, fragment, smi, workdir)

    # -- 21. the one-program train steps: graph against loop ----------------------
    graphed_step = train_graphs_phase(torch, gk, corpus, smi, workdir)
    graphed_launches = graphed_step["launches"]["graph"][-1]

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
                                           if name == "float32" else 0),
                "graphed_step_launches": (graphed_launches[mode]
                                          if name == "float32" else 0),
                "aot_request_launches": (aot_launches[mode]
                                         if name == "bfloat16" else 0),
                "overfit_launches": (
                    overfit_launches["request"][mode] if name == "bfloat16"
                    else overfit_launches["train_step"][mode])})
    # The wide path at the drugs request's shape, launches those of the
    # replayed drugs request (phase 4b).
    for r in wide:
        if (r["B"], r["N"]) != (drugs["B"], drugs["N"]):
            continue
        mode = r["mode"]
        bound_ms, bound_by = edge_pass_bound(r["B"], r["N"], r["H"], 2,
                                             "bfloat16", mode)
        kernels.append({
            "name": f"edge_mlp_bf16_wide_{mode}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": drugs["replay"]["passes"][f"{mode}_wide"],
            "max_abs_err": r["max_abs_err"],
            "ref_mean_abs": r["ref_mean_abs"],
            "atol": r["atol"], "rtol": r["rtol"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            "dtype": "bfloat16", "shape": [r["B"], r["N"], r["H"]]})
    # The float32 wide paths at the drugs training cell's pad-184 shape,
    # launches those of the replayed drugs step (phase 13).
    replayed = drugs_train["steps"][-1]
    for r in f32_wide:
        if (r["B"], r["N"]) != (drugs_train["B"], drugs_train["N"]):
            continue
        mode, back = r["mode"], "weight_sums_max_rel_err" in r
        if back:
            bound_ms, bound_by = r["bound_ms"], r["bound_by"]
        else:
            bound_ms, bound_by = edge_pass_bound(r["B"], r["N"], r["H"], 2,
                                                 "float32", mode)
        kernels.append({
            "name": f"edge_mlp{'_bwd' if back else ''}_f32_wide_{mode}",
            "route": "cuda", "source": BWD_SOURCE if back else F32_SOURCE,
            "replaces": BWD_REPLACES if back else TPU_KERNEL,
            "launches": (replayed["launches"][f"{mode}_bwd"] if back
                         else replayed["passes"][f"{mode}_wide"]),
            "max_abs_err": r["max_abs_err"],
            "atol": BWD_ATOL if back else r["atol"],
            "rtol": BWD_RTOL if back else r["rtol"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            "dtype": "float32", "shape": [r["B"], r["N"], r["H"]]})
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
            "training_step_launches": train_launches[f"{mode}_bwd"],
            "graphed_step_launches": graphed_launches[f"{mode}_bwd"],
            "overfit_launches": overfit_launches["train_step"][
                f"{mode}_bwd"]})
    # The slab kernels at the sharded train step's shape (64, 40, 20),
    # launches those of one rank's sharded step (phase 15).
    for r in slabs:
        if (r["B"], r["N"], r["NL"]) != (TRAIN_B, 40, 20):
            continue
        bwd_slab = r["kernel"] == "edge_mlp_bwd_f32"
        key = f"{r['mode']}_bwd" if bwd_slab else r["mode"]
        kernels.append({
            "name": f"{r['kernel']}_slab_{r['mode']}", "route": "cuda",
            "source": BWD_SOURCE if bwd_slab else F32_SOURCE,
            "replaces": BWD_REPLACES if bwd_slab else TPU_KERNEL,
            "launches": sharded_launches[key],
            "max_abs_err": r["max_abs_err"],
            "rejoined_max_abs_err": r["rejoined_max_abs_err"],
            "atol": BWD_ATOL if bwd_slab else 1e-5,
            "rtol": BWD_RTOL if bwd_slab else 1e-4, "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "float32", "shape": [r["B"], r["N"], r["NL"], r["H"]],
            "bit_equal_twice": r["bit_equal_twice"]})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
