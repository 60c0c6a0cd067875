// Fused EGNN edge pass in bfloat16 for Hopper (sm_90a): the main path.
//
// Replaces the TPU kernel ml_conformer_generator_tpu/ops/gcl_kernel.py::_edge_kernel
// (both of its modes). For every graph b, target node i and source node j < N:
//   pre_ij = u_i + v_j + e_ij . W_e + b0           (f32, rounded to bf16)
//   m1_ij  = SiLU(pre_ij)                           (rounded to bf16)
//   m2_ij  = SiLU(m1_ij . W1^T + b1)                (f32 accumulate, rounded to bf16)
//   head_ij = m2_ij . wh + bh                       (f32)
// mode GCL:   out_i = sum_j round(m2_ij * round(sigmoid(head_ij))) * em_ij / norm
// mode COORD: out_ij = head_ij
//
// What bounds it: at the main path's shapes (B = 64..128, N = 32..40, H = 420)
// the m1 . W1 product is 2 B N^2 H^2 operations (tens of GFLOP) against a few
// MB of inputs and outputs, so on the roofline tensor-core operations bound
// it, not device memory. The two SiLUs per edge element load the special-
// function and f32 units nearly as much: 2 B N^2 448 of them a launch; in
// practice that elementwise work sets the pace (see the design). Every per-
// edge tensor stays in shared memory and registers; only per-node rows, per-
// edge scalars and W1 are read from device memory.
//
// ---- The design -------------------------------------------------------------
// Rows are whole tiles of edges. A block owns TI whole target nodes of one
// graph with TI * N <= 128 rows (N = 32: 4 nodes; N = 40: 3 nodes, 120 rows;
// 64 < N <= 128: one node; wider graphs below), as two 64-row wgmma
// m-tiles, one per consumer warpgroup. Whole nodes keep the gated j-sum
// inside the block: no atomics.
// Blocks are persistent: a grid of at most one block per SM walks the tiles,
// and the W1 stream runs on across tiles.
//
// m1 (A) lives in shared memory, 128 x 448 bf16, in the layout wgmma reads:
// K-tiles of 64 columns, rows of 128 bytes, 16-byte chunks XOR-swizzled with
// the row (the 128-byte swizzle). Shared memory and not registers, because A
// in registers (112 a thread) beside 112 accumulators and 56 registers of
// packed m2 does not fit a thread's 232, and because the threads that build
// m1 then write plain 16-byte chunks instead of the A-fragment layout. The
// threads that build it own a chunk of columns each and share a source node's v
// row between the tile's target nodes (see build_m1). The map is sized to the
// columns H has: 56 chunks x every fourth row (224 threads) where H > 256, 32
// chunks x every eighth row (all 256 consumers) where H <= 256, so that at
// GEOM-Drugs' H = 256 no thread builds zero columns and each builds half the
// rows it would at H = 420.
//
// W1 is packed once per weight by the wrapper (ops/gcl_kernel.py::pack_w1):
// zero-padded to HP input columns (HP = 64 ceil(H / 64)), its output rows in
// two halves, each cut into tiles of 64 input columns, each tile one
// contiguous block already in the swizzled layout: half 0 in tiles of 224
// rows (28,672 bytes), half 1 in tiles of its width's rows, 32 (4,096 bytes)
// where 224 < H <= 256, else 224 (rows past H are zeros). One producer
// thread streams the tiles through a ring of three 28,672-byte slots with one
// cp.async.bulk per tile, completing on an mbarrier; consumers wait on that
// barrier and release the slot on another. No thread computes a W1 address.
// The producer sits in a third warpgroup, which exists so that setmaxnreg
// can move its registers to the consumers. Both consumer warpgroups read the
// same tile, so each 28 KB slot feeds 128 rows of products (896 clocks of
// the tensor cores); alone, the ring delivers a slot every ~400 clocks
// (measured), so it keeps up.
//
// The output columns are walked in two halves (wgmma m64n224k16 for half 0,
// 112 f32 accumulators a thread; half 1 as narrow as H allows: m64n32k16
// where 224 < H <= 256, which covers GEOM-Drugs' 256, m64n200k16 where H <=
// 424, which covers MLCG's 420, else m64n224k16). K steps that lie wholly
// past H (zeros in m1 and W1) are skipped: 27 of 28 at H = 420. After each half the
// accumulators pass through bias, SiLU and the head's partial dot product in
// registers: a thread owns two whole rows of its half, so the head needs two
// shuffles and no shared memory. In gcl mode the first half's m2 waits in 56
// registers (packed bf16); when the second half is done the gate is known, and
// the gated m2 is written over the warpgroup's own rows of m1 (dead by then),
// from where the masked j-sum reads it; stmatrix writes it, four 8 x 8 tiles
// an instruction. The gate re-reads m2 from its packed registers through an
// asm the compiler cannot merge with the epilogue's unpacking: merged, it held
// both halves of every pair as f32 from the epilogue on, spilled and
// serialised the wgmmas (ptxas C7511), and the gcl product took 15% more
// clocks than coord's; now the two take about the same. coord mode stores the
// head and no m2. The f32 order of the head's sum differs from the plain
// version's; the tolerances in chip_smoke.py (bf16 gcl 5e-3 + 1e-2 |ref|,
// coord 5e-2 + 5e-2 |ref|) allow it.
//
// SiLU is x/2 (1 + tanh(x/2)) with tanh.approx: one special-function
// operation instead of two, and the same errors against the plain version
// as exp and divide gave (the result is rounded to bf16 right after).
//
// The phases of a tile (build m1, product, epilogue, product, epilogue, gate
// and store, j-sum) run one after the other, both warpgroups in lock-step:
// the elementwise work does not overlap the product. What bounds the kernel
// is that elementwise work, about 60% of a tile's clocks (the m1 build alone
// a third): it is bound by latency, with two warps a scheduler, at about a
// third of what the special-function unit allows. So the code is kept small
// enough for the instruction cache: the m1 build is a rolled loop.
//
// Why not a ping-pong of the two warpgroups (each its own rows, its own m1 and
// its own pass over W1, the product of one behind the elementwise work of the
// other), measured on the H100: it hides 70-85% of the product's clocks, and
// no launch gets shorter. Each W1 slot then feeds 64 rows, so every slot's
// fixed costs (a consumer spends ~176 clocks a slot beyond its products; the
// ring gives at most a slot every ~400) are paid twice as often, and a
// warpgroup's elementwise phases, with one warp a scheduler instead of two,
// take as long for its 64 rows as lock-step takes for 128. Its best form
// (output thirds of 168, 168 and 112 columns so that gcl fits its registers,
// four 21 KB slots, one turn a warpgroup a tile) equalled lock-step in gcl and
// lost 4-7% in coord, which already runs at the card's power limit. Sharing
// each slot between the two instead keeps them in lock-step; multicasting W1
// to a cluster of two blocks only slowed the ring.
//
// Padding is exact: padded hidden units see zero weights and a zero bias,
// stay at SiLU(0) = 0 and carry zero head weight. Rows past the last edge of
// a tile are built as zeros and written nowhere.
//
// Graphs of 128 < N <= 192 nodes (all-atom drug molecules: GEOM-Drugs pads
// its largest, 181 atoms, to 184) take the wide instantiation,
// edge_mlp_bf16_wide_kernel, a name of its own so that a device trace tells
// its launches apart. A target node's source nodes then span two tiles:
// nodes 0..127 fill one, and its tail, the N - 128 <= 64 others, shares a
// tile with the tails of the next nodes. A block's work item is TI =
// min(8, 128 / (N - 128)) target nodes of one graph (N = 184: 2, N = 144:
// 8): a whole tile for each node's first 128 source nodes, then one tile of
// their tails packed row after row (TI (N - 128) <= 128 rows), so that no
// warpgroup idles and every tile runs the same code. The gated j-sum runs on
// across a node's two tiles in f32: each first tile leaves its node's running
// sums in shared memory (a row a node of the item), where the thread that
// owns that column takes them up in the tail tile, so each sum is added in
// the order j = 0, 1, ..., N - 1, as a one-tile sum is; no atomics, and two
// launches are bit-equal. Everything else (the rounding points above, the
// products, the epilogues, the gate) is the one code of the N <= 128 kernel,
// which the wide one shares as a template of the same body; only a row's
// edge is reckoned from (node, source node) rather than as the node's rows
// end to end.
//
// The float32 kernel (3xTF32 on wgmma, N <= 128) is edge_mlp_f32.cu.
//
// Interface: a plain C function (mlcg_edge_mlp) that launches on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxE = 4;           // edge scalars per edge
constexpr int kMaxHidden = 448;    // HP <= 448
constexpr int kMaxDevices = 64;    // devices whose attributes are cached

constexpr int kRows = 128;                 // edge rows per block tile
constexpr int kMaxNodes = kRows + 64;      // wide: a node's tail fits one m-tile
constexpr int kMaxPack = 8;                // wide: target nodes whose tails share a tile
constexpr int kNP = kMaxHidden;            // padded output width
constexpr int kNH = kNP / 2;               // columns per wgmma (one half)
constexpr int kNT = kNH / 8;               // 8-column accumulator tiles per half
constexpr int kNarrow = 200;               // half 1's width where H <= kNH + kNarrow
constexpr int kSlim = 32;                  // ... and where kNH < H <= kNH + kSlim
constexpr int kKTileBytes = kRows * 128;   // one K-tile of m1: 128 rows x 64 bf16
constexpr int kABytes = (kNP / 64) * kKTileBytes;
constexpr int kWTileBytes = kNH * 128;     // a ring slot, a half-0 W1 tile: 224 rows x 64 bf16
constexpr int kRing = 3;                   // W1 ring slots
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kBf16Threads = kConsumers + 128;  // plus the producer's warpgroup
// The m1 build's map (see build_m1) by half 1's width N1: where it is kSlim
// (H <= 256: 32 chunks of 8 columns) every consumer thread builds, a chunk and
// every eighth row; else 56 chunks x every fourth row, 224 threads.
template <int N1> constexpr int kM1Groups = N1 == kSlim ? 8 : 4;
template <int N1> constexpr int kM1Chunks = N1 == kSlim ? kConsumers / 8 : kNP / 8;
// Rows of a packed half-1 tile of W1 (ops/gcl_kernel.py::pack_w1).
template <int N1> constexpr int kW1Rows1 = N1 == kSlim ? kSlim : kNH;
// Clock marks of a warpgroup's tile (profiling; see mlcg_edge_mlp), for the
// first kProfTiles tiles of each block.
constexpr int kProfMarks = 8;
constexpr int kProfTiles = 16;
constexpr int kProfSlots = 2 * kProfTiles * kProfMarks;

// Shared memory of the bf16 kernel, from a 1024-byte aligned base.
constexpr int kOffRing = kABytes;
constexpr int kOffB1 = kOffRing + kRing * kWTileBytes;      // f32[kNP]
constexpr int kOffWh = kOffB1 + kNP * 4;                    // f32[kNP]
constexpr int kOffB0 = kOffWh + kNP * 4;                    // f32[kNP]
constexpr int kOffWe = kOffB0 + kNP * 4;                    // f32[kMaxE][kNP]
constexpr int kOffEm = kOffWe + kMaxE * kNP * 4;            // f32[kRows]
constexpr int kOffEf = kOffEm + kRows * 4;                  // f32[kRows][kMaxE]
constexpr int kOffBar = kOffEf + kRows * kMaxE * 4;         // 2 * kRing mbarriers
constexpr int kBf16Smem = kOffBar + 2 * kRing * 8 + 1024;   // + alignment slack
constexpr int kOffCarry = kOffBar + 2 * kRing * 8;  // wide: f32[kMaxPack][kNP] running j-sums
constexpr int kBf16SmemWide = kOffCarry + kMaxPack * kNP * 4 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float bf_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two bf16 of a packed pair as f32, through an asm the compiler does not
// merge with an earlier unpacking of the same pair: the gate re-reads m2 from
// its packed registers instead of holding both halves as f32 from the
// epilogue on (twice the registers, and spills).
__device__ __forceinline__ float2 unpack2(uint32_t p) {
  uint32_t lo, hi;
  asm("shl.b32 %0, %2, 16;\n\tand.b32 %1, %2, 0xffff0000;" : "=r"(lo), "=r"(hi) : "r"(p));
  return make_float2(__uint_as_float(lo), __uint_as_float(hi));
}

// SiLU for a value that is rounded to bf16 right after, as
// x/2 (1 + tanh(x/2)): one special-function operation (tanh.approx, relative
// error about 2^-11, a quarter of a bf16 ulp) instead of an exp and a divide.
__device__ __forceinline__ float silu_fast(float x) {
  const float h = 0.5f * x;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// round_bf16(SiLU(round_bf16(.))) of two values, packed.
__device__ __forceinline__ uint32_t act2(float a, float b) {
  const uint32_t p = pack2(a, b);
  return pack2(silu_fast(bf_lo(p)), silu_fast(bf_hi(p)));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// One contiguous block from device memory into shared memory; completion is
// counted in bytes on the mbarrier. All addresses and the size are multiples
// of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// Four 8 x 8 bf16 matrices from the accumulator layout into shared memory:
// lane 8 m + i gives the address of row i of matrix m.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor: K-major operand, 128-byte swizzle, rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define MLCG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MLCG_R16(i) MLCG_R4(i), MLCG_R4(i + 4), MLCG_R4(i + 8), MLCG_R4(i + 12)

// d (64 x 224, f32) = a (64 x 16) . b^T (224 x 16) [+ d if accumulate].
// Thread (warp w, lane 4 g + t) holds rows 16 w + g (d[4 n], d[4 n + 1]) and
// 16 w + g + 8 (d[4 n + 2], d[4 n + 3]) at columns 8 n + 2 t, 8 n + 2 t + 1.
__device__ __forceinline__ void wgmma_m64n224k16(float (&d)[4 * kNT], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111},"
      " %112, %113, p, 1, 1, 0, 0;\n}\n"
      : MLCG_R16(0), MLCG_R16(16), MLCG_R16(32), MLCG_R16(48), MLCG_R16(64),
        MLCG_R16(80), MLCG_R16(96)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with 200 columns (half 1 where H <= kNH + kNarrow): d[0 .. 99].
__device__ __forceinline__ void wgmma_m64n200k16(float (&d)[4 * kNT], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99},"
      " %100, %101, p, 1, 1, 0, 0;\n}\n"
      : MLCG_R16(0), MLCG_R16(16), MLCG_R16(32), MLCG_R16(48), MLCG_R16(64), MLCG_R16(80), MLCG_R4(96)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with 32 columns (half 1 where kNH < H <= kNH + kSlim): d[0 .. 15].
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4 * kNT], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MLCG_R16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// One pass of build_m1 over the source nodes, for the NB target nodes from
// node0 + t0: no branch inside, so that the nodes' arithmetic interleaves.
// G: the row groups (a thread takes every G-th source node).
template <int EE, int NB, int G>
__device__ __forceinline__ void build_m1_pass(
    unsigned char* dst, int cc, const float (&bb)[8], const float (&we)[EE][8],
    const float* ef_s, const bf16* __restrict__ u_c, const bf16* __restrict__ v_c,
    bool hi_ok, int jg, int N, int H, int t0) {
  const uint2 zero2 = make_uint2(0u, 0u);
  float ub[NB][8];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const bf16* up = u_c + (size_t)(t0 + n) * H;
    const uint2 ul = *reinterpret_cast<const uint2*>(up);
    const uint2 uh = hi_ok ? *reinterpret_cast<const uint2*>(up + 4) : zero2;
    ub[n][0] = bb[0] + bf_lo(ul.x);
    ub[n][1] = bb[1] + bf_hi(ul.x);
    ub[n][2] = bb[2] + bf_lo(ul.y);
    ub[n][3] = bb[3] + bf_hi(ul.y);
    ub[n][4] = bb[4] + bf_lo(uh.x);
    ub[n][5] = bb[5] + bf_hi(uh.x);
    ub[n][6] = bb[6] + bf_lo(uh.y);
    ub[n][7] = bb[7] + bf_hi(uh.y);
  }
  uint2 vl = zero2, vh = zero2, vl_next, vh_next;
  if (jg < N) {
    vl = *reinterpret_cast<const uint2*>(v_c + (size_t)jg * H);
    if (hi_ok) vh = *reinterpret_cast<const uint2*>(v_c + (size_t)jg * H + 4);
  }
  // Not unrolled: the kernel's code has to stay inside the instruction
  // cache, and the register copy at the end is cheap.
#pragma unroll 1
  for (int j = jg; j < N; j += G) {
    const bf16* vp = v_c + (size_t)min(j + G, N - 1) * H;   // the last one is unused
    vl_next = *reinterpret_cast<const uint2*>(vp);
    vh_next = hi_ok ? *reinterpret_cast<const uint2*>(vp + 4) : zero2;
    const float vf[8] = {bf_lo(vl.x), bf_hi(vl.x), bf_lo(vl.y), bf_hi(vl.y),
                         bf_lo(vh.x), bf_hi(vh.x), bf_lo(vh.y), bf_hi(vh.y)};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int r = (t0 + n) * N + j;
      const float4 f = *reinterpret_cast<const float4*>(ef_s + r * kMaxE);
      const float fq[kMaxE] = {f.x, f.y, f.z, f.w};
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = ub[n][e] + vf[e];
#pragma unroll
      for (int q = 0; q < EE; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = fmaf(fq[q], we[q][e], x[e]);
      *reinterpret_cast<uint4*>(dst + r * 128 + ((cc ^ (r & 7)) << 4)) =
          make_uint4(act2(x[0], x[1]), act2(x[2], x[3]), act2(x[4], x[5]), act2(x[6], x[7]));
    }
    vl = vl_next;
    vh = vh_next;
  }
}

// m1 = SiLU(u_i + v_j + e_ij . W_e + b0) of one tile, into A: row ti * N + j
// for the tile's target nodes node0 + ti (ti < nodes) and the graph's source
// nodes j < N. Thread tid < NC G owns one 16-byte chunk of columns (8 of
// them), the first NC chunks, and every G-th source node. It loads v_j once
// for up to four target nodes, whose u_i + b0 it holds in registers, and
// starts the next j's loads before this j's arithmetic. Columns of the NC
// chunks past H are built as zeros; those past the NC chunks are never read
// (NC 8 >= 16 ceil(H / 16)). EE: edge scalars computed (those past E are
// zeros); b0f, wef (by scalar, then column) and ef_s (by row, kMaxE a row)
// are the staged f32 copies in shared memory.
template <int EE, int G, int NC>
__device__ __forceinline__ void build_m1(
    unsigned char* A, const float* b0f, const float* wef, const float* ef_s,
    const bf16* __restrict__ u, const bf16* __restrict__ v, int tid, int N,
    int H, int b, int node0, int nodes, int nrows) {
  const int c = tid % NC, jg = tid / NC;
  const int k0 = c * 8;
  const bool lo_ok = k0 < H, hi_ok = k0 + 4 < H;   // H is a multiple of 4
  unsigned char* dst = A + (c >> 3) * kKTileBytes;
  const int cc = c & 7;
  // Rows past the tile's last edge, and padded columns, are zeros.
  for (int r = (lo_ok ? nrows : 0) + jg; r < kRows; r += G)
    *reinterpret_cast<uint4*>(dst + r * 128 + ((cc ^ (r & 7)) << 4)) =
        make_uint4(0u, 0u, 0u, 0u);
  if (!lo_ok) return;
  float bb[8], we[EE][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bb[i] = b0f[k0 + i];
#pragma unroll
    for (int q = 0; q < EE; ++q) we[q][i] = wef[q * kNP + k0 + i];
  }
  const bf16* u_c = u + (size_t)node0 * H + k0;
  const bf16* v_c = v + (size_t)b * N * H + k0;
  int t0 = 0;
  for (; t0 + 4 <= nodes; t0 += 4)
    build_m1_pass<EE, 4, G>(dst, cc, bb, we, ef_s, u_c, v_c, hi_ok, jg, N, H, t0);
  switch (nodes - t0) {
    case 3: build_m1_pass<EE, 3, G>(dst, cc, bb, we, ef_s, u_c, v_c, hi_ok, jg, N, H, t0); break;
    case 2: build_m1_pass<EE, 2, G>(dst, cc, bb, we, ef_s, u_c, v_c, hi_ok, jg, N, H, t0); break;
    case 1: build_m1_pass<EE, 1, G>(dst, cc, bb, we, ef_s, u_c, v_c, hi_ok, jg, N, H, t0); break;
    default: break;
  }
}

// TI: whole target nodes per 128-row tile. tpg: tiles per graph; a tile
// holds nodes of one graph. nkt: K-tiles of W1 (HP / 64). N1: the columns
// of half 1 (kNH; kNarrow where H <= kNH + kNarrow; kSlim where kNH < H <=
// kNH + kSlim), which also sets the m1 build's map.
// w1p: the packed W1, nkt tiles of kWTileBytes (half 0), then nkt of
// kW1Rows1<N1> rows of 128 bytes (half 1). prof: null, or
// kProfSlots clock marks per block (see mlcg_edge_mlp). WIDE (128 < N <=
// kMaxNodes): a tile of tpg is a work item of TI nodes, TI + 1 tiles of
// rows (see the notes at the top); the marks are its first tile's, 7 at its
// end.
template <bool GCL, int N1, bool WIDE>
__device__ __forceinline__ void edge_mlp_bf16_body(
    int N, int H, int E, int nkt, int TI, int tpg, int ntiles,
    const bf16* __restrict__ u, const bf16* __restrict__ v,
    const bf16* __restrict__ ef, const bf16* __restrict__ em,
    const bf16* __restrict__ w_e, int ld_we, const bf16* __restrict__ b0,
    const bf16* __restrict__ w1p, const bf16* __restrict__ b1,
    const bf16* __restrict__ wh, const bf16* __restrict__ bh, float norm,
    float* __restrict__ out, long long* __restrict__ prof) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned (the swizzle is a function of the address); the offset
  // is added to the array itself so that accesses stay ld/st.shared.
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* A = smem;
  float* b1f = reinterpret_cast<float*>(smem + kOffB1);
  float* whf = reinterpret_cast<float*>(smem + kOffWh);
  float* b0f = reinterpret_cast<float*>(smem + kOffB0);
  float* wef = reinterpret_cast<float*>(smem + kOffWe);
  float* em_s = reinterpret_cast<float*>(smem + kOffEm);
  float* ef_s = reinterpret_cast<float*>(smem + kOffEf);
  float* carry = reinterpret_cast<float*>(smem + kOffCarry);   // WIDE only: [TI][kNP]
  const uint32_t ring = smem_u32(smem + kOffRing);
  const uint32_t full = smem_u32(smem + kOffBar);        // kRing barriers
  const uint32_t empty = full + kRing * 8;               // kRing barriers

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < kNP; c += kBf16Threads) {
    b1f[c] = c < H ? __bfloat162float(b1[c]) : 0.0f;
    whf[c] = c < H ? __bfloat162float(wh[c]) : 0.0f;
    b0f[c] = c < H ? __bfloat162float(b0[c]) : 0.0f;
    for (int q = 0; q < kMaxE; ++q)
      wef[q * kNP + c] = (c < H && q < E)
          ? __bfloat162float(w_e[(size_t)c * ld_we + q]) : 0.0f;
  }
  __syncthreads();

  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // Registers are handed out per warpgroup: three groups of 128 threads get
  // 168 each at launch. The producer's group gives most of its share back,
  // and the consumers take 232 (112 accumulators, 56 of packed m2).
  if (warp >= kConsumers / 32) {
    // ---- producer: keep the ring full of W1 tiles, all of W1 a tile ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(w1p);
      constexpr uint32_t kBytes1 = kW1Rows1<N1> * 128;   // a half-1 tile
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0, tile = blockIdx.x; t < my_tiles; ++t, tile += gridDim.x) {
        // WIDE: a tile for each of the item's nodes and one for their tails
        const int rounds = WIDE ? min(TI, N - (tile % tpg) * TI) + 1 : 1;
        for (int round = 0; round < rounds; ++round) {
          for (int w = 0; w < 2 * nkt; ++w) {
            uint32_t bytes = kWTileBytes;
            size_t at = (size_t)w * kWTileBytes;
            if constexpr (kBytes1 != kWTileBytes) {   // half 1's narrower tiles
              if (w >= nkt) {
                bytes = kBytes1;
                at = (size_t)nkt * kWTileBytes + (size_t)(w - nkt) * kBytes1;
              }
            }
            mbar_wait(empty + 8 * s, ph ^ 1);   // passes at once on the first round
            mbar_expect_tx(full + 8 * s, bytes);
            bulk_load(ring + s * kWTileBytes, src + at, bytes, full + 8 * s);
            if (++s == kRing) { s = 0; ph ^= 1; }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 rows each ------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;   // this thread's rows: r0, r0 + 8
  const uint32_t a_base = smem_u32(A) + wg * (64 * 128);
  const float bhv = bh ? __bfloat162float(bh[0]) : 0.0f;
  long long* clk = prof != nullptr && (tid & 127) == 0
      ? prof + ((size_t)blockIdx.x * 2 + wg) * kProfTiles * kProfMarks : nullptr;

  float acc[4 * kNT];
  int slot = 0;
  uint32_t phase = 0;

  for (int it = 0, tile = blockIdx.x; tile < ntiles; ++it, tile += gridDim.x) {
    const int b = tile / tpg;                     // the tile's graph
    const int i0 = (tile - b * tpg) * TI;         // its first target node
    const int item_nodes = min(TI, N - i0);
    const int item_node0 = b * N + i0;
#pragma unroll 1
    for (int sub = 0; sub < (WIDE ? item_nodes + 1 : 1); ++sub) {
    // WIDE: tile sub < item_nodes holds node item_node0 + sub's source nodes
    // 0..127; the last, tail, every node's source nodes 128..N-1.
    const bool tail = WIDE && sub == item_nodes;
    const int nodes = WIDE && !tail ? 1 : item_nodes;
    const int node0 = WIDE && !tail ? item_node0 + sub : item_node0;
    const int j0 = tail ? kRows : 0;              // the tile's first source node
    const int nsrc = WIDE ? (tail ? N - kRows : kRows) : N;
    const int nrows = nodes * nsrc;               // real rows of this tile
    const size_t e0 = (size_t)node0 * N + j0;     // first edge of this tile
    // The edge of row r: its node's rows lie end to end (not WIDE), or
    // (node r / nsrc, source node j0 + r % nsrc).
    auto edge = [&](int r) -> size_t {
      return WIDE ? (size_t)(node0 + r / nsrc) * N + j0 + r % nsrc : e0 + r;
    };
    auto mark = [&](int k) {
      if (clk != nullptr && it < kProfTiles && (!WIDE || sub == 0 || k == 7))
        clk[it * kProfMarks + k] = clock64();
    };
    mark(0);

    // 0. The edge scalars and the edge mask of the tile's rows.
    for (int i = tid; i < kRows * kMaxE; i += kConsumers) {
      const int r = i / kMaxE, q = i - r * kMaxE;
      ef_s[i] = (r < nrows && q < E) ? __bfloat162float(ef[edge(r) * E + q]) : 0.0f;
    }
    if (GCL && tid < kRows)
      em_s[tid] = tid < nrows ? __bfloat162float(em[edge(tid)]) : 0.0f;
    named_barrier(1, kConsumers);

    // 1. m1 (see build_m1); the tile's source nodes start at row j0 of v.
    constexpr int kG = kM1Groups<N1>, kNC = kM1Chunks<N1>;
    if (tid < kNC * kG) {
      const bf16* v_s = WIDE ? v + ((size_t)b * N + j0) * H : v;
      const int b_s = WIDE ? 0 : b;
      if (E <= 2) {
        build_m1<2, kG, kNC>(A, b0f, wef, ef_s, u, v_s, tid, nsrc, H, b_s, node0, nodes, nrows);
      } else {
        build_m1<kMaxE, kG, kNC>(A, b0f, wef, ef_s, u, v_s, tid, nsrc, H, b_s, node0, nodes, nrows);
      }
    }
    // m1 was written by ordinary stores; wgmma reads it through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1, kConsumers);
    mark(1);

    // 2. m1 . W1^T in two halves of 224 and N1 columns, each followed by its
    //    epilogue. K steps past H (zeros in m1 and W1) are skipped.
    float hd0 = 0.0f, hd1 = 0.0f;     // partial heads of rows r0 and r0 + 8
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) acc[i] = 0.0f;   // dead while m1 is built
    uint32_t m2p[2 * kNT];            // gcl: the first half's m2, packed
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int prev = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(full + 8 * slot, phase);
        wgmma_fence();
        const uint32_t a_kt = a_base + kt * kKTileBytes;
        const uint32_t b_kt = ring + slot * kWTileBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // 16 columns = 32 bytes inside the swizzled row
          if (kk > 0 && kt * 64 + kk * 16 >= H) break;
          if (h == 0 || N1 == kNH)
            wgmma_m64n224k16(acc, wgmma_desc(a_kt + kk * 32), wgmma_desc(b_kt + kk * 32),
                             (kt | kk) != 0);
          else if (N1 == kNarrow)
            wgmma_m64n200k16(acc, wgmma_desc(a_kt + kk * 32), wgmma_desc(b_kt + kk * 32),
                             (kt | kk) != 0);
          else
            wgmma_m64n32k16(acc, wgmma_desc(a_kt + kk * 32), wgmma_desc(b_kt + kk * 32),
                            (kt | kk) != 0);
        }
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();               // the previous tile's products are done
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = slot;
        if (++slot == kRing) { slot = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      mark(2 + 2 * h);

      // m2 = SiLU(acc + b1) rounded, and its share of the head.
#pragma unroll
      for (int nt = 0; nt < (h == 0 ? kNT : N1 / 8); ++nt) {
        const int col = h * kNH + nt * 8 + 2 * t4;
        const float2 bias = *reinterpret_cast<const float2*>(b1f + col);
        const float2 w = *reinterpret_cast<const float2*>(whf + col);
        const uint32_t p0 = act2(acc[4 * nt] + bias.x, acc[4 * nt + 1] + bias.y);
        const uint32_t p1 = act2(acc[4 * nt + 2] + bias.x, acc[4 * nt + 3] + bias.y);
        hd0 = fmaf(bf_lo(p0), w.x, fmaf(bf_hi(p0), w.y, hd0));
        hd1 = fmaf(bf_lo(p1), w.x, fmaf(bf_hi(p1), w.y, hd1));
        if (GCL) {
          if (h == 0) {
            m2p[2 * nt] = p0;
            m2p[2 * nt + 1] = p1;
          } else {
            acc[4 * nt] = __uint_as_float(p0);   // kept as bits until the gate is known
            acc[4 * nt + 2] = __uint_as_float(p1);
          }
        }
      }
      mark(3 + 2 * h);
    }

    // 3. The head of each edge: the four lanes of a row hold its parts.
    hd0 += __shfl_xor_sync(0xffffffffu, hd0, 1);
    hd0 += __shfl_xor_sync(0xffffffffu, hd0, 2);
    hd1 += __shfl_xor_sync(0xffffffffu, hd1, 1);
    hd1 += __shfl_xor_sync(0xffffffffu, hd1, 2);
    hd0 += bhv;
    hd1 += bhv;

    if (!GCL) {
      if (t4 == 0) {
        if (r0 < nrows) out[edge(r0)] = hd0;
        if (r0 + 8 < nrows) out[edge(r0 + 8)] = hd1;
      }
    } else {
      // 4. The gated m2 goes over this warpgroup's rows of m1, which every
      //    warp of the group has finished reading.
      const float g0 = bf_lo(pack2(1.0f / (1.0f + expf(-hd0)), 0.0f));
      const float g1 = bf_lo(pack2(1.0f / (1.0f + expf(-hd1)), 0.0f));
      named_barrier(2 + wg, 128);
      // stmatrix x4 of 8-column groups (nt, nt + 1): matrices (rows of r0,
      // group nt), (rows of r0 + 8, nt), (r0, nt + 1), (r0 + 8, nt + 1); this
      // lane gives row (lane & 7) of matrix lane >> 3. Half 1's groups past
      // N1 lie past H, where the j-sum does not read.
      const int srow = wg * 64 + (warp & 3) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const uint32_t srow_base = smem_u32(A) + srow * 128;
      const int sswz = srow & 7;
      const int scg = lane >> 4;                     // 0 or 1: group nt or nt + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nt = 0; nt < (h == 0 ? kNT : N1 / 8); nt += 2) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            // An odd last group (N1 = 200) also goes into the group after it:
            // a padded one past H, which the j-sum does not read and the
            // next tile's build rewrites.
            const int n = min(nt + k, (h == 0 ? kNT : N1 / 8) - 1);
            const float2 m0 = unpack2(h == 0 ? m2p[2 * n] : __float_as_uint(acc[4 * n]));
            const float2 m1 = unpack2(h == 0 ? m2p[2 * n + 1] : __float_as_uint(acc[4 * n + 2]));
            v[2 * k] = pack2(m0.x * g0, m0.y * g0);
            v[2 * k + 1] = pack2(m1.x * g1, m1.y * g1);
          }
          const int cg = h * kNT + nt + scg;         // this lane's 8-column group
          stmatrix_x4(srow_base + (cg >> 3) * kKTileBytes + (((cg & 7) ^ sswz) << 4),
                      v[0], v[1], v[2], v[3]);
        }
      }
    }
    if (GCL) {
      named_barrier(1, kConsumers);
      mark(6);

      // 5. Masked j-sum in f32: a thread owns a 16-byte chunk (8 columns) of
      //    one node and walks its rows. WIDE: a node's first tile leaves its
      //    sums in its row of carry, the tail tile adds on from them.
      for (int item = tid; item < nodes * (kNP / 8); item += kConsumers) {
        const int ti = item / (kNP / 8);
        const int c = item - ti * (kNP / 8);
        const int k0 = c * 8;
        if (k0 < H) {
          const unsigned char* src = A + (c >> 3) * kKTileBytes;
          const int cc = c & 7;
          float sum[8];
          float* held = carry + (tail ? ti : sub) * kNP + k0;
          if (tail) {
            const float4 s0 = *reinterpret_cast<const float4*>(held);
            const float4 s1 = *reinterpret_cast<const float4*>(held + 4);
            sum[0] = s0.x; sum[1] = s0.y; sum[2] = s0.z; sum[3] = s0.w;
            sum[4] = s1.x; sum[5] = s1.y; sum[6] = s1.z; sum[7] = s1.w;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) sum[i] = 0.0f;
          }
#pragma unroll 4
          for (int j = 0; j < nsrc; ++j) {
            const int r = ti * nsrc + j;
            const uint4 p = *reinterpret_cast<const uint4*>(
                src + r * 128 + ((cc ^ (r & 7)) << 4));
            const float m = em_s[r];
            sum[0] = fmaf(bf_lo(p.x), m, sum[0]);
            sum[1] = fmaf(bf_hi(p.x), m, sum[1]);
            sum[2] = fmaf(bf_lo(p.y), m, sum[2]);
            sum[3] = fmaf(bf_hi(p.y), m, sum[3]);
            sum[4] = fmaf(bf_lo(p.z), m, sum[4]);
            sum[5] = fmaf(bf_hi(p.z), m, sum[5]);
            sum[6] = fmaf(bf_lo(p.w), m, sum[6]);
            sum[7] = fmaf(bf_hi(p.w), m, sum[7]);
          }
          if (WIDE && !tail) {
            *reinterpret_cast<float4*>(held) = make_float4(sum[0], sum[1], sum[2], sum[3]);
            *reinterpret_cast<float4*>(held + 4) = make_float4(sum[4], sum[5], sum[6], sum[7]);
            continue;
          }
          // H is a multiple of 4: a chunk holds 8 or 4 real columns; rows of
          // out are 16-byte aligned.
          float* o = out + (size_t)(node0 + ti) * H + k0;
          *reinterpret_cast<float4*>(o) =
              make_float4(sum[0] / norm, sum[1] / norm, sum[2] / norm, sum[3] / norm);
          if (k0 + 4 < H)
            *reinterpret_cast<float4*>(o + 4) =
                make_float4(sum[4] / norm, sum[5] / norm, sum[6] / norm, sum[7] / norm);
        }
      }
    } else {
      mark(6);
    }
    // The next tile rewrites m1 and the mask.
    named_barrier(1, kConsumers);
    mark(7);
    }   // sub
  }
}

// The kernels: N <= 128, and the wide one (a name of its own in a trace).
#define MLCG_BF16_PARAMS                                                        \
    int N, int H, int E, int nkt, int TI, int tpg, int ntiles,                  \
    const bf16* __restrict__ u, const bf16* __restrict__ v,                     \
    const bf16* __restrict__ ef, const bf16* __restrict__ em,                   \
    const bf16* __restrict__ w_e, int ld_we, const bf16* __restrict__ b0,       \
    const bf16* __restrict__ w1p, const bf16* __restrict__ b1,                  \
    const bf16* __restrict__ wh, const bf16* __restrict__ bh, float norm,       \
    float* __restrict__ out, long long* __restrict__ prof
#define MLCG_BF16_ARGS \
    N, H, E, nkt, TI, tpg, ntiles, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof

template <bool GCL, int N1>
__global__ void __launch_bounds__(kBf16Threads, 1)
edge_mlp_bf16_kernel(MLCG_BF16_PARAMS) {
  edge_mlp_bf16_body<GCL, N1, false>(MLCG_BF16_ARGS);
}

template <bool GCL, int N1>
__global__ void __launch_bounds__(kBf16Threads, 1)
edge_mlp_bf16_wide_kernel(MLCG_BF16_PARAMS) {
  edge_mlp_bf16_body<GCL, N1, true>(MLCG_BF16_ARGS);
}

#undef MLCG_BF16_PARAMS
#undef MLCG_BF16_ARGS

#undef MLCG_R4
#undef MLCG_R16

template <bool GCL, int N1, bool WIDE>
cudaError_t launch_bf16(int B, int N, int H, int E, const void* u, const void* v,
                        const void* ef, const void* em, const void* w_e, int ld_we,
                        const void* b0, const void* w1p, const void* b1,
                        const void* wh, const void* bh, float norm, float* out,
                        long long* prof, cudaStream_t stream) {
  auto kern = WIDE ? edge_mlp_bf16_wide_kernel<GCL, N1> : edge_mlp_bf16_kernel<GCL, N1>;
  constexpr int smem = WIDE ? kBf16SmemWide : kBf16Smem;
  // The shared-memory limit and the SM count are read once per device (and
  // instantiation).
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_sm = dev < kMaxDevices ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) sms[dev] = n_sm;
  }
  // WIDE: nodes whose tails (N - kRows source nodes each) share a tile
  const int TI = WIDE ? min(kMaxPack, kRows / (N - kRows))
                      : N <= kRows / 2 ? kRows / N : 1;
  const int tpg = (N + TI - 1) / TI;
  const int ntiles = B * tpg;
  const int nkt = (H + 63) / 64;
  kern<<<ntiles < n_sm ? ntiles : n_sm, kBf16Threads, smem, stream>>>(
      N, H, E, nkt, TI, tpg, ntiles, (const bf16*)u, (const bf16*)v, (const bf16*)ef,
      (const bf16*)em, (const bf16*)w_e, ld_we, (const bf16*)b0, (const bf16*)w1p,
      (const bf16*)b1, (const bf16*)wh, (const bf16*)bh, norm, out, prof);
  return cudaGetLastError();
}

// Half 1's width for H: as narrow as H allows, so that the product, its
// epilogue, the gate and the W1 ring skip the padded columns (and gcl holds
// fewer registers through it). kSlim also sizes the m1 build to H <= 256.
int half1_width(int H) {
  return H > kNH && H <= kNH + kSlim ? kSlim : H <= kNH + kNarrow ? kNarrow : kNH;
}

template <bool GCL, bool WIDE, typename... Args>
cudaError_t launch_width(int n1, Args... args) {
  return n1 == kSlim ? launch_bf16<GCL, kSlim, WIDE>(args...)
       : n1 == kNarrow ? launch_bf16<GCL, kNarrow, WIDE>(args...)
       : launch_bf16<GCL, kNH, WIDE>(args...);
}

// One mode's launch: the wide kernel past kRows nodes, half 1 at
// half1_width(H).
template <bool GCL>
cudaError_t launch_mode(int B, int N, int H, int E, const void* u, const void* v,
                        const void* ef, const void* em, const void* w_e, int ld_we,
                        const void* b0, const void* w1p, const void* b1,
                        const void* wh, const void* bh, float norm, float* out,
                        long long* prof, cudaStream_t s) {
  const int n1 = half1_width(H);
  if (N > kRows)
    return launch_width<GCL, true>(n1, B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof, s);
  return launch_width<GCL, false>(n1, B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof, s);
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

extern "C" {

// Largest sizes the kernel takes; the Python wrapper checks against these.
int mlcg_edge_mlp_max_nodes() { return kMaxNodes; }
int mlcg_edge_mlp_max_hidden() { return kMaxHidden; }
int mlcg_edge_mlp_max_edge_feats() { return kMaxE; }
// Bytes of one packed W1 tile of half 0 (and of a ring slot), the output
// rows of a packed half-1 tile at hidden width H, and clock slots per block
// of `prof`.
int mlcg_edge_mlp_w1_tile_bytes() { return kWTileBytes; }
int mlcg_edge_mlp_w1_half1_rows(int H) {
  return half1_width(H) == kSlim ? kW1Rows1<kSlim> : kW1Rows1<kNH>;
}
int mlcg_edge_mlp_prof_slots() { return kProfSlots; }

// mode: 0 = gcl, 1 = coord. All operands bfloat16.
// u, v: (B, N, H); ef: (B, N*N, E); em: (B, N*N) (gcl only);
// w_e: (H, E) with row stride ld_we; b0, b1, wh: (H,); bh: (1,) or null;
// u, v 8-byte aligned; H a multiple of 4, at most 448; N <= 192 (past 128
// the wide kernel); E <= 4.
// w1p: W1 in the packed form, ceil(H / 64) tiles of
// mlcg_edge_mlp_w1_tile_bytes() bytes and as many of
// mlcg_edge_mlp_w1_half1_rows(H) rows of 128 bytes, 16-byte aligned (see
// pack_w1 in ops/gcl_kernel.py).
// out: float32, (B, N, H) for gcl, (B, N*N) for coord.
// prof: null, or zeros, one block per SM times mlcg_edge_mlp_prof_slots()
// int64: each block's (warpgroup, tile, mark) for its first 16 tiles, where
// the first thread of each warpgroup writes the SM's clock at the marks
// 0 tile start, 1 m1 built, 2 half 0's product done, 3 its epilogue done,
// 4 half 1's product done, 5 its epilogue done, 6 gate and store done, 7 the
// j-sum and the tile's last barrier done. coord mode writes 6 at 5. The wide
// kernel's tile is a work item of up to 8 target nodes: marks 0-6 of its
// first tile of rows, 7 at its end.
int mlcg_edge_mlp(int mode, int B, int N, int H, int E, const void* u,
                  const void* v, const void* ef, const void* em,
                  const void* w_e, int ld_we, const void* b0, const void* w1p,
                  const void* b1, const void* wh, const void* bh, float norm,
                  void* out, void* prof, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxNodes || H <= 0 || H > kMaxHidden || H % 4 != 0 ||
      E < 0 || E > kMaxE || !aligned(u, 8) || !aligned(v, 8) || !aligned(w1p, 16))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && em == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  long long* p = (long long*)prof;
  return (int)(mode == 0
      ? launch_mode<true>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, o, p, s)
      : launch_mode<false>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, o, p, s));
}

const char* mlcg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
