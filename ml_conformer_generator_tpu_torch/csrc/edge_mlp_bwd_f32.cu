// Backward of the fused EGNN edge pass in float32 for Hopper (sm_90a):
// 3xTF32 on wgmma, in the frame of the float32 forward (edge_mlp_f32.cu).
//
// The gradient of edge_mlp_f32.cu's pass (both modes), for training with
// compute_dtype="float32". It replaces no TPU kernel: the JAX package trains
// on its dense XLA path (use_pallas off, and the Pallas kernel has no
// custom_vjp), so XLA takes this gradient there. The port runs every edge
// pass on the card through its kernels, so its training needs this one. It
// replaces this file's first design (two products on the f32 FMA units, 64-row
// tiles, cp.async stages, and a third kernel for the node sums), whose call
// took 4.2 / 3.8 ms (gcl / coord) on an H100 at (B, N, H) = (64, 39, 420),
// 2.4 / 2.1x the library's time for its two in-chain products.
//
// Given the forward's inputs and the upstream gradient g ((B, N, H) in gcl
// mode, (B, N^2) in coord mode), each edge's chain is recomputed and walked
// back. As in the forward, the edge set may be a j-slab of NL <= N source
// nodes (edge_mlp_f32.cu): v, dv and dv's partials then have NL nodes, and
// the edges, g in coord mode, de, s0 and dpre1 N * NL rows a graph.
//
//   pre0 = u_i + v_j + e_ij . W_e + b0,   s0 = SiLU(pre0)
//   pre1 = s0 . W1^T + b1,                 m = SiLU(pre1)
//   head = m . wh + bh
//   gcl:   gate = sigmoid(head), dmsg = g_i em_ij / norm,
//          dhead = (dmsg . m) gate (1 - gate), dm = dmsg gate + dhead wh
//   coord: dhead = g_ij, dm = dhead wh
//   dpre1 = dm SiLU'(pre1),  ds0 = dpre1 . W1,  dpre0 = ds0 SiLU'(pre0)
// The kernel writes: du_i = sum_j dpre0_ij; dv as per-tile partials (see
// below); de_ij = dpre0_ij . W_e; per target node sum_j dpre0_ij e_ij (for
// dW_e); dhead per edge (for dbh); per block and warp the column sums of
// dhead m (for dwh); and s0 (with a column of ones after its H columns) and
// dpre1, (B N^2, H) each, from which the wrapper takes [dW1 | db1] =
// dpre1^T [s0 | 1] as one library product (XLA's place in the JAX package).
// The wrapper adds the partials in a fixed order; db0 is the sum of du.
//
// What bounds it: its two products in the edge chain, s0 . W1^T (the
// recompute) and dpre1 . W1, 2 x 2 B N^2 H^2 operations (69 GFLOP at
// (64, 39, 420)), 0.42 ms at the 3xTF32 rate (165 TFLOP/s); the (B N^2, H)
// s0 and dpre1 it writes for dW1 are 0.33 GB, 0.1 ms at 3.35 TB/s.
//
// ---- The design ----------------------------------------------------------
// The forward's frame: a persistent block (one per SM) walks tiles of TI whole
// target nodes of one graph, TI * NL <= 128 edge rows, as two 64-row wgmma
// m-tiles, one per consumer warpgroup; a producer warpgroup streams packed W1
// tiles (28,672 bytes each) with one cp.async.bulk per tile through a ring of
// three mbarrier slots and gives its registers to the consumers (setmaxnreg
// 24 / 240). Both products are 3xTF32 (hi.hi + hi.lo + lo.hi, wgmma
// m64n224k8 with A from registers and f32 accumulators), each over two
// output halves of 224 columns, one after the other through the one ring:
// per tile the producer streams pack_w1(W1)'s 2 ceil(H / 16) tiles, then
// pack_w1(W1^T)'s (as an [out][in] operand, ds0 = dpre1 . W1 reads W1^T;
// ops/gcl_kernel.py). One kernel and not two: the second product's A is the
// first's output, hot in L2, and the ring runs on without draining.
//
// 1. The recompute, pre1 = s0 . W1^T + b1. A is s0, built in registers per
//    K-tile exactly as the forward builds m1 (a thread's four contiguous
//    input columns of its two rows, the pack's column order matching; the
//    next K-tile's u and v loaded one K-tile ahead). Its gcl gradients are
//    sums over edges of terms of both signs, which a biased product spoils:
//    so each pair of K-tiles is summed afresh, small terms first, and the
//    pairs' sums are added in float32 in the stash (issue_tile, flush_acc).
//    That costs the recompute about twice the time of the second product.
// 2. ds0 = dpre1 . W1. A is dpre1, read back from device memory one K-tile
//    ahead as a thread's four contiguous columns (one 16-byte load a row)
//    through L2 (ld.global.cg: other warps of the block wrote it, ordered
//    by a barrier of the consumers; never a non-coherent path).
// 3. The epilogues work by rows, not in the accumulators' fragment layout:
//    a half's accumulators are stored into the stash (128 x 232 f32, the
//    forward's m2 stash), and then a warp takes whole rows, a lane 16-byte
//    column groups, so that every load from device memory is coalesced and
//    the row reductions are warp sums. Written in the fragment layout, the
//    epilogues' unrolled loads held so many registers that ptxas spilled
//    kilobytes, into the products' loops too, and the recompute slowed. The first product's epilogue forms dpre1 = dm
//    SiLU'(pre1): coord (dhead = g) takes each half from the stash in turn;
//    gcl needs the head and g_i . m over all 448 columns for the gate, so
//    its first half waits in dpre1, where dpre1 is then written over it, and
//    its second in the stash. The column sums of dhead m stay in the
//    lanes over the warp's rows and are added into the warp's row of `part`.
//    The second product's epilogue recomputes pre0 from u, v, e and W_e,
//    writes s0 = SiLU(pre0) (for dW1, never read again here) and forms
//    dpre0 = ds0 SiLU'(pre0) in the stash, with de = dpre0 . W_e as warp
//    sums; then the consumers walk the stash by columns: du_i (the j-sum of
//    each whole node, as the forward's gcl j-sum) and sum_j dpre0_ij e_ij
//    per node, and for each source node j the tile's sum over its target
//    nodes, a (B, tiles per graph, N, H) partial of dv (13 tiles per graph
//    at N = 39: 54.5 MB, not the 163.5 MB of a (B N^2, H) dpre0). dpre0 is
//    never written to device memory, and there are no atomics.
// 4. Outputs that this kernel does not read again (s0, du, dwe, dv's
//    partials) are stored with the evict-first hint, so that they do not
//    push dpre1 out of L2 before the second half of the second product
//    reads it again (on an H100 that half ran markedly slower without it).
//
// Every sum is taken in a fixed order (a block's tiles in order, a warp's
// rows in order and a fixed shuffle tree, the wrapper's sums over fixed
// shapes), so two calls give equal results bit for bit.
//
// Graphs of 128 < N <= 192 nodes on the square edge set take the wide
// instantiation, edge_mlp_bwd_f32_wide_kernel (a name of its own in a device
// trace), with the forward's wide packing (edge_mlp_f32.cu): a work item of
// TI = min(8, 128 / (N - 128)) target nodes of one graph, a tile for each
// node's source nodes 0..127, then one for the tails of all TI nodes. The
// sums that span a node's two tiles, du and sum_j dpre0 e, are carried in
// their own rows of device memory: a node's first tile writes its part, the
// item's tail tile reads it back (ld.global.cg, after the consumers' barrier)
// and adds on, so each runs in the order j = 0, 1, ..., N - 1. The dv
// partials are the item's (B, items a graph, N, H): each first tile adds its
// node's row into the item's partial of source nodes 0..127, which the same
// thread wrote at the item's first tile, and the tail tile writes those of
// source nodes 128..N-1. Neither fits the shared memory the ring and the
// stash leave (the dv partial is 128 H floats an item). s0 and dpre1 are
// written in the item's row order (its tiles one after another), which
// [dW1 | db1] = dpre1^T [s0 | 1] does not see; every per-edge output (de,
// dhead) is at its edge.
//
// Padding is exact: padded rows and columns of both packs are zero; rows past
// a tile's last edge are built as zeros and written nowhere.
//
// Interface: a plain C function (mlcg_edge_mlp_bwd_f32) that launches on the
// given stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 4;           // edge scalars per edge
constexpr int kMaxHidden = 448;    // H <= 448
constexpr int kMaxDevices = 64;    // devices whose attributes are cached

constexpr int kRows = 128;                 // edge rows per block tile
constexpr int kMaxNodes = kRows + 64;      // wide: a node's tail fits one m-tile
constexpr int kMaxPack = 8;                // wide: target nodes whose tails share a tile
constexpr int kNP = kMaxHidden;            // padded output width
constexpr int kNH = kNP / 2;               // columns per wgmma (one half)
constexpr int kNT = kNH / 8;               // 8-column accumulator tiles per half
constexpr int kKT = 16;                    // input columns per K-tile
constexpr int kWTileBytes = kNH * 128;     // one packed tile: 224 rows x (16 hi + 16 lo)
constexpr int kRing = 3;                   // W1 ring slots
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kWarps = kConsumers / 32;    // consumer warps
constexpr int kThreads = kConsumers + 128; // plus the producer's warpgroup
constexpr int kLdS = kNH + 8;              // row stride (floats) of the stash
constexpr int kQuads = kNH / 4;            // 4-column groups of a half
constexpr int kProfSlots = 12;             // clock slots per block (profiling)
constexpr int kPartFloats = kWarps * kNP;  // a block's row of `part`: dwh by warp

// Shared memory, from a 1024-byte aligned base.
constexpr int kOffRing = 0;
constexpr int kOffStash = kOffRing + kRing * kWTileBytes;   // f32[kRows][kLdS]
constexpr int kOffB1 = kOffStash + kRows * kLdS * 4;        // f32[kNP]
constexpr int kOffWh = kOffB1 + kNP * 4;                    // f32[kNP]
constexpr int kOffB0 = kOffWh + kNP * 4;                    // f32[kNP]
constexpr int kOffWe = kOffB0 + kNP * 4;                    // f32[kMaxE][kNP]
constexpr int kOffEf = kOffWe + kMaxE * kNP * 4;            // f32[kRows][kMaxE]
constexpr int kOffDe = kOffEf + kRows * kMaxE * 4;          // f32[kRows][kMaxE]: de, half 0
constexpr int kOffClk = kOffDe + kRows * kMaxE * 4;         // int64: profiling's last lap
constexpr int kOffBar = kOffClk + 8;                        // 2 * kRing mbarriers
constexpr int kSmem = kOffBar + 2 * kRing * 8 + 1024;       // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float sigm(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

// SiLU'(x) from x and sigmoid(x).
__device__ __forceinline__ float dsilu(float x, float s) { return s * (1.0f + x * (1.0f - s)); }

// Round to TF32 (nearest, ties away): the low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
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
// counted in bytes on the mbarrier. Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
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

// d (64 x 224, f32) += a (64 x 8, TF32, registers) . b^T (224 x 8, TF32,
// shared memory); d is overwritten instead when accumulate is 0.
// A fragment of thread (warp w, lane 4 g + t): a[0] row 16 w + g, column t;
// a[1] row 16 w + g + 8, column t; a[2] and a[3] the same rows, column t + 4.
// d: rows 16 w + g (d[4 n], d[4 n + 1]) and 16 w + g + 8 (d[4 n + 2],
// d[4 n + 3]) at columns 8 n + 2 t, 8 n + 2 t + 1.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * kNT], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k8.f32.tf32.tf32 "
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
      " {%112, %113, %114, %115}, %116, p, 1, 1;\n}\n"
      : MLCG_R16(0), MLCG_R16(16), MLCG_R16(32), MLCG_R16(48), MLCG_R16(64),
        MLCG_R16(80), MLCG_R16(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef MLCG_R4
#undef MLCG_R16

// A consumer thread's two rows of the tile: r0 and r0 + 8.
template <int EE>
struct Rows {
  const float* u[2];   // u of the row's target node
  const float* v[2];   // v of the row's source node
  float f[2][EE];      // the row's edge scalars (zeros past E)
  bool ok[2];          // the row is an edge of the tile
};

// The split A fragments of one K-tile from x, the thread's two rows at its
// four input columns (x[row][c]): column k + 2 s + h of row r0 + 8 i is
// element 2 h + i of k-step s.
__device__ __forceinline__ void split_a(uint32_t (&hi)[2][4], uint32_t (&lo)[2][4],
                                        const float (&x)[2][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t h = tf32(x[i][c]);
      hi[c >> 1][2 * (c & 1) + i] = h;
      lo[c >> 1][2 * (c & 1) + i] = tf32(x[i][c] - __uint_as_float(h));
    }
  }
}

// u and v of the thread's two rows at input columns k .. k + 3 (uv[row][0] u,
// uv[row][1] v); nothing for padding columns and rows past the tile's edges.
template <int EE>
__device__ __forceinline__ void load_uv(float4 (&uv)[2][2], const Rows<EE>& rw, int k, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (k < H && rw.ok[i]) {
      uv[i][0] = __ldg(reinterpret_cast<const float4*>(rw.u[i] + k));
      uv[i][1] = __ldg(reinterpret_cast<const float4*>(rw.v[i] + k));
    }
  }
}

// The first product's A for one K-tile: s0 at the thread's two rows and
// input columns k .. k + 3 (k = 16 kt + 4 t), split. uv holds u and v at
// columns k .. k + 3 and is then loaded with those at k_next.
template <int EE>
__device__ __forceinline__ void build_s0(uint32_t (&hi)[2][4], uint32_t (&lo)[2][4],
                                         float4 (&uv)[2][2], const Rows<EE>& rw,
                                         const float* b0f, const float* wef, int k,
                                         int k_next, int H) {
  float x[2][4] = {};
  if (k < H) {   // H is a multiple of 4: columns k .. k + 3 are all real or all padding
    const float4 bb = *reinterpret_cast<const float4*>(b0f + k);
    float4 we[EE];
#pragma unroll
    for (int q = 0; q < EE; ++q) we[q] = *reinterpret_cast<const float4*>(wef + q * kNP + k);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!rw.ok[i]) continue;
      const float4 uu = uv[i][0];
      const float4 vv = uv[i][1];
      float p[4] = {uu.x + vv.x + bb.x, uu.y + vv.y + bb.y, uu.z + vv.z + bb.z,
                    uu.w + vv.w + bb.w};
#pragma unroll
      for (int q = 0; q < EE; ++q) {
        p[0] = fmaf(rw.f[i][q], we[q].x, p[0]);
        p[1] = fmaf(rw.f[i][q], we[q].y, p[1]);
        p[2] = fmaf(rw.f[i][q], we[q].z, p[2]);
        p[3] = fmaf(rw.f[i][q], we[q].w, p[3]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) x[i][c] = p[c] * sigm(p[c]);
    }
  }
  load_uv<EE>(uv, rw, k_next, H);
  split_a(hi, lo, x);
}

// dpre1 of the thread's two rows at columns k .. k + 3 (zeros past H and
// past the tile's edges), through L2: the quad's lanes have just written it.
template <int EE>
__device__ __forceinline__ void load_d(float4 (&dd)[2], const Rows<EE>& rw,
                                       const float* dpre1, size_t e0, int r0, int k, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dd[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < H && rw.ok[i])
      dd[i] = __ldcg(reinterpret_cast<const float4*>(dpre1 + (e0 + r0 + 8 * i) * H + k));
  }
}

// The second product's A for one K-tile: dd (dpre1 at columns k .. k + 3),
// split; dd is then loaded with the columns at k_next.
template <int EE>
__device__ __forceinline__ void build_d(uint32_t (&hi)[2][4], uint32_t (&lo)[2][4],
                                        float4 (&dd)[2], const Rows<EE>& rw,
                                        const float* dpre1, size_t e0, int r0, int k_next,
                                        int H) {
  const float x[2][4] = {{dd[0].x, dd[0].y, dd[0].z, dd[0].w},
                         {dd[1].x, dd[1].y, dd[1].z, dd[1].w}};
  load_d<EE>(dd, rw, dpre1, e0, r0, k_next, H);
  split_a(hi, lo, x);
}

// The W1 ring as the consumers see it.
struct Ring {
  uint32_t base, full, empty;
  int slot;
  uint32_t phase;
  int prev;
};

// The six products of one K-tile (A already built) with the ring's current
// slot, then the previous K-tile's products retired and its slot freed.
__device__ __forceinline__ void product_issue(float (&acc)[4 * kNT], const uint32_t (&a_hi)[2][4],
                                              const uint32_t (&a_lo)[2][4], int kt, int lane,
                                              Ring& ring) {
  mbar_wait(ring.full + 8 * ring.slot, ring.phase);
  wgmma_fence();
  const uint32_t b = ring.base + ring.slot * kWTileBytes;
#pragma unroll
  for (int s = 0; s < 2; ++s) {   // k-step s: bytes 32 s (hi) and 64 + 32 s (lo) of a row
    wgmma_tf32(acc, a_hi[s], wgmma_desc(b + 32 * s), (kt | s) != 0);
    wgmma_tf32(acc, a_hi[s], wgmma_desc(b + 64 + 32 * s), 1);
    wgmma_tf32(acc, a_lo[s], wgmma_desc(b + 32 * s), 1);
  }
  wgmma_commit();
  if (kt > 0) {
    wgmma_wait<1>();   // the previous K-tile's products are done
    if (lane == 0) mbar_arrive(ring.empty + 8 * ring.prev);
  }
  ring.prev = ring.slot;
  if (++ring.slot == kRing) { ring.slot = 0; ring.phase ^= 1; }
}

// Zeros: the first product of a sum overwrites the accumulators, but the
// compiler sees the wgmma read them; clearing them first ends the previous
// values' registers at their last use, so that the epilogues between two
// products do not hold them.
__device__ __forceinline__ void clear(float (&acc)[4 * kNT]) {
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) acc[i] = 0.0f;
}

// The last K-tile's products retired and its slot freed.
__device__ __forceinline__ void product_drain(int lane, Ring& ring) {
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(ring.empty + 8 * ring.prev);
}

// The recompute's six products of one K-tile (A built, its W1 tile at b)
// for one output half: the small terms (hi.lo, lo.hi) first, then hi.hi;
// with `first` the sum starts afresh. The tensor cores round each addition
// into the accumulator toward zero; accumulated over all K-tiles in the
// registers, as the second product is, the recompute came out
// systematically smaller than the float32 product, a bias that the gcl
// gate's gradient (a sum over edges of terms of both signs) turned into a
// relative error of 3e-4 in a train step on an H100, three times the bar.
// So the recompute sums each pair of K-tiles afresh, its large additions
// relative to a partial sum of 32 columns, and adds the partial sums in
// float32 (flush_acc), rounded to nearest.
__device__ __forceinline__ void issue_tile(float (&acc)[4 * kNT], const uint32_t (&hi)[2][4],
                                           const uint32_t (&lo)[2][4], uint32_t b, bool first) {
  wgmma_fence();
  wgmma_tf32(acc, hi[0], wgmma_desc(b + 64), first ? 0 : 1);
  wgmma_tf32(acc, lo[0], wgmma_desc(b), 1);
  wgmma_tf32(acc, hi[1], wgmma_desc(b + 96), 1);
  wgmma_tf32(acc, lo[1], wgmma_desc(b + 32), 1);
  wgmma_tf32(acc, hi[0], wgmma_desc(b), 1);
  wgmma_tf32(acc, hi[1], wgmma_desc(b + 32), 1);
}

// acc (a half's partial sum, fragment layout) added into the stash, or
// with `first` stored there plus the bias (by column of the half).
__device__ __forceinline__ void flush_acc(const float (&acc)[4 * kNT], const float* bias,
                                          float* stash, bool first, int r0, int t4) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = nt * 8 + 2 * t4;
    const float2 bb = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2* p = reinterpret_cast<float2*>(stash + (r0 + 8 * i) * kLdS + c);
      const float2 x = first ? bb : *p;
      *p = make_float2(x.x + acc[4 * nt + 2 * i], x.y + acc[4 * nt + 2 * i + 1]);
    }
  }
}

// The next K-tile of a product of nkt K-tiles in two halves: this half's
// next one, K-tile 0 of the second half after the first half's last, none
// (nkt: past H) after the second's.
__device__ __forceinline__ int next_kt(int kt, int nkt, int h) {
  return kt + 1 < nkt ? kt + 1 : (h == 0 ? 0 : nkt);
}

// One half's accumulators into the stash, in their fragment layout (every
// row); the epilogues then read them by rows.
__device__ __forceinline__ void stash_acc(const float (&acc)[4 * kNT], float* stash, int r0,
                                          int t4) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = nt * 8 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(stash + (r0 + 8 * i) * kLdS + c) =
          make_float2(acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
  }
}

// The first product's epilogue, by rows: a warp takes rows warp, warp + 8,
// ... of the tile, kHeadRows at a time (their loads in flight together), a
// lane four columns in each 128. dpre1 = (dhead wh + g_i a) SiLU'(pre1).
// gcl (KCH = 4: all columns, 4 (lane + 32 k)) needs the row's head and
// g_i . m (a warp sum) first, for its gate, dhead and a = em gate / norm;
// pre1 (bias included) is in dpre1 (first half), where dpre1 is written over
// it, and in the stash (second half). coord (KCH = 2: the columns of half
// h, h 224 + 4 (lane + 32 k)) has dhead = g and a = 0, and takes each half
// from the stash in turn. dhead goes to dhead[edge]; each lane adds its
// columns' sums of dhead m over the warp's rows into the warp's row of part.
// WIDE: rows r of dpre1 lie at e0 + r; the edge of row r is (node r / NL,
// source node j0 + r % NL) of N (NL: the tile's source nodes a node).
constexpr int kHeadRows = 2;
template <bool GCL, int KCH, bool WIDE>
__device__ __forceinline__ void head_pass(const float* stash, float* dpre1, const float* whf,
                                          const float* __restrict__ g,
                                          const float* __restrict__ em,
                                          const float* __restrict__ bh, float norm,
                                          size_t node0, size_t e0, int nrows, int NL, int H,
                                          int h, float* __restrict__ dhead, float* part,
                                          int warp, int lane, int N, int j0) {
  static_assert(GCL ? KCH == 4 : KCH == 2, "gcl takes all columns, coord a half");
  float* pw = part + ((size_t)blockIdx.x * kWarps + warp) * kNP;   // this warp's dwh sums
  const int col0 = KCH == 2 ? h * kNH : 0;
  const int width = KCH == 2 ? kNH : kNP;
  float w[KCH][4], cw[KCH][4];
#pragma unroll
  for (int k = 0; k < KCH; ++k) {
    const int c = 4 * (lane + 32 * k);
    const int col = col0 + c;
    const float4 z = c < width && col < H ? *reinterpret_cast<const float4*>(whf + col)
                                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    w[k][0] = z.x; w[k][1] = z.y; w[k][2] = z.z; w[k][3] = z.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) cw[k][j] = 0.0f;
  }
#pragma unroll 1
  for (int rb = warp; rb < nrows; rb += kWarps * kHeadRows) {
    float p[kHeadRows][KCH][4], gg[kHeadRows][KCH][4];
#pragma unroll
    for (int rr = 0; rr < kHeadRows; ++rr) {
      const int r = rb + kWarps * rr;
      const size_t e = e0 + r;
      const float* gi = g + (node0 + r / NL) * H;   // gcl: g of the row's target node
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const int c = 4 * (lane + 32 * k);
        const int col = col0 + c;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
        if (r < nrows && c < width && col < H) {   // H <= 448 and a multiple of 4
          x = KCH == 2 ? *reinterpret_cast<const float4*>(stash + r * kLdS + c)
              : col < kNH ? __ldcg(reinterpret_cast<const float4*>(dpre1 + e * H + col))
                          : *reinterpret_cast<const float4*>(stash + r * kLdS + col - kNH);
          if (GCL) y = __ldg(reinterpret_cast<const float4*>(gi + col));
        }
        p[rr][k][0] = x.x; p[rr][k][1] = x.y; p[rr][k][2] = x.z; p[rr][k][3] = x.w;
        gg[rr][k][0] = y.x; gg[rr][k][1] = y.y; gg[rr][k][2] = y.z; gg[rr][k][3] = y.w;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kHeadRows; ++rr) {
      const int r = rb + kWarps * rr;
      if (r >= nrows) break;   // the same for the whole warp
      const size_t e = e0 + r;
      const size_t ed = WIDE ? (node0 + r / NL) * N + j0 + r % NL : e;   // its edge
      float sg[KCH][4];
#pragma unroll
      for (int k = 0; k < KCH; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) sg[k][c] = sigm(p[rr][k][c]);
      float dh, a = 0.0f;
      if (GCL) {
        float hd = 0.0f, gp = 0.0f;
#pragma unroll
        for (int k = 0; k < KCH; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float m = p[rr][k][c] * sg[k][c];
            hd = fmaf(m, w[k][c], hd);
            gp = fmaf(m, gg[rr][k][c], gp);
          }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          hd += __shfl_xor_sync(0xffffffffu, hd, o);
          gp += __shfl_xor_sync(0xffffffffu, gp, o);
        }
        const float scale = __ldg(em + ed) / norm;
        // An IEEE division here, not __fdividef: where the gate saturates,
        // 1 - gate is a few ulp of 1, so the gate must be rounded correctly
        // (as the plain version's sigmoid is) for dhead to keep its digits.
        const float gate = 1.0f / (1.0f + __expf(-(hd + (bh ? __ldg(bh) : 0.0f))));
        a = scale * gate;
        dh = gp * scale * gate * (1.0f - gate);
      } else {
        dh = __ldg(g + ed);
      }
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const int c = 4 * (lane + 32 * k);
        const int col = col0 + c;
        if (c >= width || col >= H) continue;
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j] = fmaf(gg[rr][k][j], a, dh * w[k][j]) * dsilu(p[rr][k][j], sg[k][j]);
          cw[k][j] = fmaf(dh, p[rr][k][j] * sg[k][j], cw[k][j]);
        }
        *reinterpret_cast<float4*>(dpre1 + e * H + col) = make_float4(d[0], d[1], d[2], d[3]);
      }
      if (lane == 0 && h == 0) dhead[ed] = dh;
    }
  }
#pragma unroll
  for (int k = 0; k < KCH; ++k) {
    const int c = 4 * (lane + 32 * k);
    const int col = col0 + c;
    if (c >= width || col >= H) continue;
    float4 s = *reinterpret_cast<float4*>(pw + col);
    s.x += cw[k][0]; s.y += cw[k][1]; s.z += cw[k][2]; s.w += cw[k][3];
    *reinterpret_cast<float4*>(pw + col) = s;
  }
}

// The second product's epilogue for one half, by rows as head_pass
// (kLayerRows at a time): ds0 in the stash becomes dpre0 = ds0 SiLU'(pre0)
// in place, pre0 recomputed from u, v, the edge scalars (efs) and W_e, and
// s0 = SiLU(pre0) is written out (rows of H + 4 floats, the first half's
// pass adding the column of ones); each row's share of de = dpre0 . W_e is a
// warp sum, kept in des after the first half and added to it and written
// after the second.
// WIDE: as head_pass (vrow0 the row of v of the tile's first source node).
constexpr int kLayerRows = 2;
template <int EE, bool WIDE>
__device__ __forceinline__ void first_layer_pass(float* stash, const float* __restrict__ u,
                                                 const float* __restrict__ v, const float* b0f,
                                                 const float* wef, const float* efs, float* des,
                                                 float* __restrict__ de,
                                                 float* __restrict__ s0, int h, size_t node0,
                                                 size_t vrow0, size_t e0, int nrows, int NL,
                                                 int H, int E, int warp, int lane, int N,
                                                 int j0) {
  // This lane's columns of the half (4 (lane + 32 k), k < 2) and their b0, W_e.
  float4 bb[2], we[2][EE];
  bool on[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = 4 * (lane + 32 * k);
    const int col = h * kNH + c;
    on[k] = c < kNH && col < H;
    bb[k] = on[k] ? *reinterpret_cast<const float4*>(b0f + col)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < EE; ++q)
      we[k][q] = on[k] ? *reinterpret_cast<const float4*>(wef + q * kNP + col) : bb[k];
  }
#pragma unroll 1
  for (int rb = warp; rb < nrows; rb += kWarps * kLayerRows) {
    float4 x[kLayerRows][2], uu[kLayerRows][2], vv[kLayerRows][2];
#pragma unroll
    for (int rr = 0; rr < kLayerRows; ++rr) {
      const int r = rb + kWarps * rr;
      const int ti = r / NL;
      const float* ur = u + (node0 + ti) * H;
      const float* vr = v + (vrow0 + r - ti * NL) * H;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = 4 * (lane + 32 * k);
        const int col = h * kNH + c;
        x[rr][k] = uu[rr][k] = vv[rr][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < nrows && on[k]) {
          x[rr][k] = *reinterpret_cast<const float4*>(stash + r * kLdS + c);
          uu[rr][k] = __ldg(reinterpret_cast<const float4*>(ur + col));
          vv[rr][k] = __ldg(reinterpret_cast<const float4*>(vr + col));
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kLayerRows; ++rr) {
      const int r = rb + kWarps * rr;
      if (r >= nrows) break;   // the same for the whole warp
      float ee[EE], dq[EE];
#pragma unroll
      for (int q = 0; q < EE; ++q) {
        ee[q] = efs[r * kMaxE + q];
        dq[q] = 0.0f;
      }
      if (h == 0 && lane == 0)
        __stcs(reinterpret_cast<float4*>(s0 + (e0 + r) * (H + 4) + H),
               make_float4(1.0f, 0.0f, 0.0f, 0.0f));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!on[k]) continue;
        float pre[4] = {uu[rr][k].x + vv[rr][k].x + bb[k].x, uu[rr][k].y + vv[rr][k].y + bb[k].y,
                        uu[rr][k].z + vv[rr][k].z + bb[k].z, uu[rr][k].w + vv[rr][k].w + bb[k].w};
#pragma unroll
        for (int q = 0; q < EE; ++q) {
          pre[0] = fmaf(ee[q], we[k][q].x, pre[0]);
          pre[1] = fmaf(ee[q], we[k][q].y, pre[1]);
          pre[2] = fmaf(ee[q], we[k][q].z, pre[2]);
          pre[3] = fmaf(ee[q], we[k][q].w, pre[3]);
        }
        float sg[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) sg[c] = sigm(pre[c]);
        const float4 d = make_float4(x[rr][k].x * dsilu(pre[0], sg[0]),
                                     x[rr][k].y * dsilu(pre[1], sg[1]),
                                     x[rr][k].z * dsilu(pre[2], sg[2]),
                                     x[rr][k].w * dsilu(pre[3], sg[3]));
        *reinterpret_cast<float4*>(stash + r * kLdS + 4 * (lane + 32 * k)) = d;
        __stcs(reinterpret_cast<float4*>(s0 + (e0 + r) * (H + 4) + h * kNH + 4 * (lane + 32 * k)),
            make_float4(pre[0] * sg[0], pre[1] * sg[1], pre[2] * sg[2], pre[3] * sg[3]));
#pragma unroll
        for (int q = 0; q < EE; ++q)
          dq[q] = fmaf(d.x, we[k][q].x, fmaf(d.y, we[k][q].y, fmaf(d.z, we[k][q].z,
                  fmaf(d.w, we[k][q].w, dq[q]))));
      }
#pragma unroll
      for (int q = 0; q < EE; ++q) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dq[q] += __shfl_xor_sync(0xffffffffu, dq[q], o);
        if (lane == 0 && q < E) {
          if (h == 0) des[r * kMaxE + q] = dq[q];
          else de[(WIDE ? (node0 + r / NL) * N + j0 + r % NL : e0 + r) * E + q] =
              des[r * kMaxE + q] + dq[q];
        }
      }
    }
  }
}

// The column sums of one half's dpre0 (in the stash) over the tile, in a
// fixed order: for each of the tile's nodes and four columns, du (the j-sum)
// and sum_j dpre0 e (dwe); for each of the NL source nodes j and four
// columns, the sum over the tile's target nodes into its dv partial.
__device__ __forceinline__ void column_sums(const float* stash, const float* efs, int h,
                                            int nodes, int NL, int H, int E, size_t node0,
                                            float* __restrict__ du, float* __restrict__ dwe,
                                            float* __restrict__ dvp_tile, int tid) {
  for (int item = tid; item < (nodes + NL) * kQuads; item += kConsumers) {
    const int w = item / kQuads;
    const int c = 4 * (item - w * kQuads);
    const int col = h * kNH + c;
    if (col >= H) continue;   // H is a multiple of 4
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (w < nodes) {
      float4 se[kMaxE];
#pragma unroll
      for (int q = 0; q < kMaxE; ++q) se[q] = s;
#pragma unroll 4
      for (int j = 0; j < NL; ++j) {
        const int r = w * NL + j;
        const float4 x = *reinterpret_cast<const float4*>(stash + r * kLdS + c);
        s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
#pragma unroll
        for (int q = 0; q < kMaxE; ++q) {
          if (q < E) {
            const float e = efs[r * kMaxE + q];
            se[q].x = fmaf(x.x, e, se[q].x);
            se[q].y = fmaf(x.y, e, se[q].y);
            se[q].z = fmaf(x.z, e, se[q].z);
            se[q].w = fmaf(x.w, e, se[q].w);
          }
        }
      }
      __stcs(reinterpret_cast<float4*>(du + (node0 + w) * H + col), s);
#pragma unroll
      for (int q = 0; q < kMaxE; ++q)
        if (q < E) __stcs(reinterpret_cast<float4*>(dwe + ((node0 + w) * E + q) * H + col), se[q]);
    } else {
      const int j = w - nodes;
#pragma unroll 4
      for (int ti = 0; ti < nodes; ++ti) {
        const float4 x = *reinterpret_cast<const float4*>(stash + (ti * NL + j) * kLdS + c);
        s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
      }
      __stcs(reinterpret_cast<float4*>(dvp_tile + (size_t)j * H + col), s);
    }
  }
}

// column_sums for the wide kernel's tiles (nsrc source nodes a node, from
// source node j0; dvp_rows: the item's dv partial at source node j0). A
// node's first tile writes its du and dwe parts, the tail tile reads them
// back and adds on (other threads wrote them, before the consumers' barrier
// at the end of the first tile's column sums). dv: the tile's sums over its
// target nodes, added to the partial's rows (`fresh`: written, the item's
// first tile and its tail); each column of a source node is the same
// thread's in all first tiles of an item.
__device__ __forceinline__ void column_sums_wide(const float* stash, const float* efs, int h,
                                                 int nodes, int nsrc, int H, int E,
                                                 size_t node0, float* __restrict__ du,
                                                 float* __restrict__ dwe,
                                                 float* __restrict__ dvp_rows, bool tail,
                                                 bool fresh, int tid) {
  for (int item = tid; item < (nodes + nsrc) * kQuads; item += kConsumers) {
    const int w = item / kQuads;
    const int c = 4 * (item - w * kQuads);
    const int col = h * kNH + c;
    if (col >= H) continue;   // H is a multiple of 4
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (w < nodes) {
      float* du_at = du + (node0 + w) * H + col;
      float4 se[kMaxE];
#pragma unroll
      for (int q = 0; q < kMaxE; ++q) se[q] = s;
      if (tail) {
        s = __ldcg(reinterpret_cast<const float4*>(du_at));
#pragma unroll
        for (int q = 0; q < kMaxE; ++q)
          if (q < E) se[q] = __ldcg(reinterpret_cast<const float4*>(dwe + ((node0 + w) * E + q) * H + col));
      }
#pragma unroll 4
      for (int j = 0; j < nsrc; ++j) {
        const int r = w * nsrc + j;
        const float4 x = *reinterpret_cast<const float4*>(stash + r * kLdS + c);
        s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
#pragma unroll
        for (int q = 0; q < kMaxE; ++q) {
          if (q < E) {
            const float e = efs[r * kMaxE + q];
            se[q].x = fmaf(x.x, e, se[q].x);
            se[q].y = fmaf(x.y, e, se[q].y);
            se[q].z = fmaf(x.z, e, se[q].z);
            se[q].w = fmaf(x.w, e, se[q].w);
          }
        }
      }
      __stcg(reinterpret_cast<float4*>(du_at), s);
#pragma unroll
      for (int q = 0; q < kMaxE; ++q)
        if (q < E) __stcg(reinterpret_cast<float4*>(dwe + ((node0 + w) * E + q) * H + col), se[q]);
    } else {
      const int j = w - nodes;
      float4* at = reinterpret_cast<float4*>(dvp_rows + (size_t)j * H + col);
      if (!fresh) s = __ldcg(at);
#pragma unroll 4
      for (int ti = 0; ti < nodes; ++ti) {
        const float4 x = *reinterpret_cast<const float4*>(stash + (ti * nsrc + j) * kLdS + c);
        s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
      }
      __stcg(at, s);
    }
  }
}

// N target nodes, NL source nodes a graph. TI: whole target nodes per
// 128-row tile. tpg: tiles per graph; a tile holds nodes of one graph. nkt:
// K-tiles of W1 (ceil(H / 16)). w1p, w1tp: pack_w1(W1) and pack_w1(W1^T), 2 * nkt tiles of kWTileBytes
// each. prof: null, or kProfSlots clock sums per block (see
// mlcg_edge_mlp_bwd_f32). WIDE (128 < N <= kMaxNodes, NL = N): a tile of tpg
// is a work item of TI nodes, TI + 1 tiles of rows (see the notes at the top).
#define MLCG_BWD_PARAMS                                                             \
    int N, int NL, int H, int E, int nkt, int TI, int tpg, int ntiles,             \
    const float* __restrict__ u, const float* __restrict__ v,                      \
    const float* __restrict__ ef, const float* __restrict__ em,                    \
    const float* __restrict__ w_e, int ld_we,                                      \
    const float* __restrict__ b0, const float* __restrict__ w1p,                   \
    const float* __restrict__ w1tp, const float* __restrict__ b1,                  \
    const float* __restrict__ wh, const float* __restrict__ bh,                    \
    float norm, const float* __restrict__ g, float* __restrict__ s0,               \
    float* dpre1, float* __restrict__ du, float* __restrict__ dvp,                 \
    float* __restrict__ de, float* __restrict__ dwe,                               \
    float* __restrict__ dhead, float* __restrict__ part,                           \
    long long* __restrict__ prof
#define MLCG_BWD_ARGS                                                               \
    N, NL, H, E, nkt, TI, tpg, ntiles, u, v, ef, em, w_e, ld_we, b0, w1p, w1tp, b1, \
    wh, bh, norm, g, s0, dpre1, du, dvp, de, dwe, dhead, part, prof

template <bool GCL, int EE, bool WIDE>
__device__ __forceinline__ void edge_mlp_bwd_f32_body(MLCG_BWD_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned (the swizzle is a function of the address).
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* stash = reinterpret_cast<float*>(smem + kOffStash);
  float* b1f = reinterpret_cast<float*>(smem + kOffB1);
  float* whf = reinterpret_cast<float*>(smem + kOffWh);
  float* b0f = reinterpret_cast<float*>(smem + kOffB0);
  float* wef = reinterpret_cast<float*>(smem + kOffWe);
  float* efs = reinterpret_cast<float*>(smem + kOffEf);
  float* des = reinterpret_cast<float*>(smem + kOffDe);
  const uint32_t full = smem_u32(smem + kOffBar);        // kRing barriers
  const uint32_t empty = full + kRing * 8;               // kRing barriers

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, kWarps);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < kNP; c += kThreads) {
    b1f[c] = c < H ? b1[c] : 0.0f;
    whf[c] = c < H ? wh[c] : 0.0f;
    b0f[c] = c < H ? b0[c] : 0.0f;
    for (int q = 0; q < kMaxE; ++q)
      wef[q * kNP + c] = (c < H && q < E) ? w_e[(size_t)c * ld_we + q] : 0.0f;
  }
  __syncthreads();

  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (warp >= kWarps) {
    // ---- producer: keep the ring full of W1 tiles, then W1^T tiles ---------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      const uint32_t ring = smem_u32(smem + kOffRing);
      int s = 0;
      uint32_t ph = 0;
      const unsigned char* w1b = reinterpret_cast<const unsigned char*>(w1p);
      const unsigned char* w1tb = reinterpret_cast<const unsigned char*>(w1tp);
      for (int t = 0, tile = blockIdx.x; t < my_tiles; ++t, tile += gridDim.x) {
        // WIDE: a tile for each of the item's nodes and one for their tails
        const int rounds = WIDE ? min(TI, N - (tile % tpg) * TI) + 1 : 1;
        for (int round = 0; round < rounds; ++round) {
          for (int p = 0; p < 2; ++p) {
            const unsigned char* src = p == 0 ? w1b : w1tb;
            for (int w = 0; w < 2 * nkt; ++w) {
              mbar_wait(empty + 8 * s, ph ^ 1);   // passes at once on the first round
              mbar_expect_tx(full + 8 * s, kWTileBytes);
              bulk_load(ring + s * kWTileBytes, src + (size_t)w * kWTileBytes, kWTileBytes,
                        full + 8 * s);
              if (++s == kRing) { s = 0; ph ^= 1; }
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 rows each ------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp >> 2;
  const int t4 = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);   // this thread's rows: r0, r0 + 8
  // Profiling: thread 0 adds the clocks since the last lap (kept in shared
  // memory, not in a register held through the products) to prof's slot.
  long long* t_prev = reinterpret_cast<long long*>(smem + kOffClk);
  auto lap = [&](int slot) {   // prof starts as zeros
    if (prof != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      prof[(size_t)blockIdx.x * kProfSlots + slot] += now - *t_prev;
      *t_prev = now;
    }
  };

  Ring ring{smem_u32(smem + kOffRing), full, empty, 0, 0u, 0};
  float acc[4 * kNT];
  uint32_t a_hi0[2][4], a_lo0[2][4], a_hi1[2][4], a_lo1[2][4];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpg;                     // the tile's graph
    const int tig = tile - b * tpg;               // its place among the graph's tiles
    const int i0 = tig * TI;                      // its first target node
    const int item_nodes = min(TI, N - i0);
#pragma unroll 1
    for (int sub = 0; sub < (WIDE ? item_nodes + 1 : 1); ++sub) {
    // WIDE: tile sub < item_nodes holds node i0 + sub's source nodes 0..127;
    // the last, tail, every node's source nodes 128..N-1.
    const bool tail = WIDE && sub == item_nodes;
    const int nodes = WIDE && !tail ? 1 : item_nodes;
    const size_t node0 = (size_t)b * N + i0 + (WIDE && !tail ? sub : 0);
    const int j0 = tail ? kRows : 0;              // the tile's first source node
    const int nsrc = WIDE ? (tail ? N - kRows : kRows) : NL;
    const int nrows = nodes * nsrc;               // real rows of this tile
    // The tile's first row of s0 and dpre1: its first edge (not WIDE), or
    // after the item's earlier tiles.
    const size_t e0 = WIDE ? ((size_t)b * N + i0) * N + (size_t)sub * kRows : node0 * NL;
    // The edge of row r (WIDE: node r / nsrc, source node j0 + r % nsrc).
    auto edge = [&](int r) -> size_t {
      return WIDE ? (node0 + r / nsrc) * N + j0 + r % nsrc : e0 + r;
    };
    if (prof != nullptr && tid == 0) *t_prev = clock64();

    // 0. This thread's rows: their u and v rows and edge scalars (also into
    //    shared memory for the epilogues).
    Rows<EE> rw;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      rw.ok[i] = r < nrows;
      const int ti = rw.ok[i] ? r / nsrc : 0;
      const int j = rw.ok[i] ? r - ti * nsrc : 0;
      rw.u[i] = u + (node0 + ti) * H;
      rw.v[i] = v + ((size_t)b * NL + j0 + j) * H;
#pragma unroll
      for (int q = 0; q < EE; ++q)
        rw.f[i][q] = (rw.ok[i] && q < E) ? __ldg(ef + edge(r) * E + q) : 0.0f;
      if (t4 == 0) {
#pragma unroll
        for (int q = 0; q < EE; ++q) efs[r * kMaxE + q] = rw.f[i][q];
#pragma unroll
        for (int q = EE; q < kMaxE; ++q) efs[r * kMaxE + q] = 0.0f;
      }
    }
    lap(0);

    // 1. pre1 = s0 . W1^T + b1 in two halves of 224 columns, summed pair of
    //    K-tiles by pair of K-tiles into the stash (issue_tile): coord
    //    takes each half's epilogue from there in turn; gcl copies the first
    //    half into dpre1, where its epilogue reads it with the second half
    //    from the stash.
    {
      float4 uv[2][2];
      load_uv<EE>(uv, rw, 4 * t4, H);
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        clear(acc);
        build_s0<EE>(a_hi0, a_lo0, uv, rw, b0f, wef, 4 * t4, next_kt(0, nkt, h) * kKT + 4 * t4,
                     H);
#pragma unroll 1
        for (int kt = 0; kt < nkt; kt += 2) {
          const bool two = kt + 1 < nkt;
          if (two)
            build_s0<EE>(a_hi1, a_lo1, uv, rw, b0f, wef, (kt + 1) * kKT + 4 * t4,
                         next_kt(kt + 1, nkt, h) * kKT + 4 * t4, H);
          const int s0slot = ring.slot;
          mbar_wait(ring.full + 8 * ring.slot, ring.phase);
          if (++ring.slot == kRing) { ring.slot = 0; ring.phase ^= 1; }
          issue_tile(acc, a_hi0, a_lo0, ring.base + s0slot * kWTileBytes, true);
          const int s1slot = ring.slot;
          if (two) {
            mbar_wait(ring.full + 8 * ring.slot, ring.phase);
            if (++ring.slot == kRing) { ring.slot = 0; ring.phase ^= 1; }
            issue_tile(acc, a_hi1, a_lo1, ring.base + s1slot * kWTileBytes, false);
          }
          wgmma_commit();
          wgmma_wait<0>();
          if (lane == 0) {
            mbar_arrive(ring.empty + 8 * s0slot);
            if (two) mbar_arrive(ring.empty + 8 * s1slot);
          }
          flush_acc(acc, b1f + h * kNH, stash, kt == 0, r0, t4);
          if (kt + 2 < nkt)
            build_s0<EE>(a_hi0, a_lo0, uv, rw, b0f, wef, (kt + 2) * kKT + 4 * t4,
                         next_kt(kt + 2, nkt, h) * kKT + 4 * t4, H);
        }
        lap(1 + 2 * h);
        named_barrier(1, kConsumers);
        if (!GCL) {
          head_pass<false, 2, WIDE>(stash, dpre1, whf, g, em, bh, norm, node0, e0, nrows, nsrc,
                                    H, h, dhead, part, warp, lane, N, j0);
        } else if (h == 0) {
          // The first half's pre1 into dpre1, by rows.
#pragma unroll 1
          for (int r = warp; r < nrows; r += kWarps) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int c = 4 * (lane + 32 * k);
              if (c < kNH && h * kNH + c < H)
                *reinterpret_cast<float4*>(dpre1 + (e0 + r) * H + h * kNH + c) =
                    *reinterpret_cast<const float4*>(stash + r * kLdS + c);
            }
          }
        }
        // The stash is written again next; after the second half, the
        // second product reads rows of dpre1 that other warps wrote.
        named_barrier(1, kConsumers);
        lap(2 + 2 * h);
      }
    }
    if (GCL) {
      // The second product reads each row of dpre1 in the warps that
      // compute its accumulators.
      head_pass<true, 4, WIDE>(stash, dpre1, whf, g, em, bh, norm, node0, e0, nrows, nsrc, H, 0,
                               dhead, part, warp, lane, N, j0);
      named_barrier(1, kConsumers);
    }
    lap(5);

    // 2. ds0 = dpre1 . W1 in two halves of 224 columns, each followed by its
    //    epilogue and the tile's column sums.
    {
      float4 dd[2];
      load_d<EE>(dd, rw, dpre1, e0, r0, 4 * t4, H);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        clear(acc);
#pragma unroll 1
        for (int kt = 0; kt < nkt; kt += 2) {
          build_d<EE>(a_hi0, a_lo0, dd, rw, dpre1, e0, r0, next_kt(kt, nkt, h) * kKT + 4 * t4,
                      H);
          product_issue(acc, a_hi0, a_lo0, kt, lane, ring);
          if (kt + 1 < nkt) {
            build_d<EE>(a_hi1, a_lo1, dd, rw, dpre1, e0, r0,
                        next_kt(kt + 1, nkt, h) * kKT + 4 * t4, H);
            product_issue(acc, a_hi1, a_lo1, kt + 1, lane, ring);
          }
        }
        product_drain(lane, ring);
        lap(6 + 2 * h);
        stash_acc(acc, stash, r0, t4);
        named_barrier(1, kConsumers);
        first_layer_pass<EE, WIDE>(stash, u, v, b0f, wef, efs, des, de, s0, h, node0,
                                   (size_t)b * NL + j0, e0, nrows, nsrc, H, E, warp, lane, N,
                                   j0);
        named_barrier(1, kConsumers);
        lap(7 + 2 * h);
        if constexpr (WIDE)
          column_sums_wide(stash, efs, h, nodes, nsrc, H, E, node0, du, dwe,
                           dvp + (((size_t)b * tpg + tig) * N + j0) * H, tail,
                           sub == 0 || tail, tid);
        else
          column_sums(stash, efs, h, nodes, NL, H, E, node0, du, dwe,
                      dvp + ((size_t)b * tpg + tig) * NL * H, tid);
        // The stash, the edge scalars and des are written again next.
        named_barrier(1, kConsumers);
        lap(10 + h);
      }
    }
    }   // sub
  }
}

// The kernels: N <= 128, and the wide one (a name of its own in a trace).
template <bool GCL, int EE>
__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_bwd_f32_kernel(MLCG_BWD_PARAMS) {
  edge_mlp_bwd_f32_body<GCL, EE, false>(MLCG_BWD_ARGS);
}

template <bool GCL, int EE>
__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_bwd_f32_wide_kernel(MLCG_BWD_PARAMS) {
  edge_mlp_bwd_f32_body<GCL, EE, true>(MLCG_BWD_ARGS);
}

#undef MLCG_BWD_PARAMS
#undef MLCG_BWD_ARGS

// Target nodes a tile for N target nodes by NL source nodes: TI whole target
// nodes, TI * NL <= kRows; past kRows nodes (NL = N) a wide work item's, as
// many as share the tail tile, at most kMaxPack.
int tile_nodes(int N, int NL) {
  if (N > kRows) return min(kMaxPack, kRows / (N - kRows));
  return NL <= kRows / 2 ? kRows / NL : 1;
}

// Tiles (wide: work items) per graph of N target nodes by NL source nodes.
int tiles_per_graph(int N, int NL) {
  const int TI = tile_nodes(N, NL);
  return (N + TI - 1) / TI;
}

template <bool GCL, int EE, bool WIDE>
cudaError_t launch_bwd(int B, int N, int NL, int H, int E, const float* u, const float* v,
                       const float* ef, const float* em, const float* w_e, int ld_we,
                       const float* b0, const float* w1p, const float* w1tp, const float* b1,
                       const float* wh, const float* bh, float norm, const float* g, float* s0,
                       float* dpre1, float* du, float* dvp, float* de, float* dwe,
                       float* dhead, float* part, int nblk, long long* prof,
                       cudaStream_t stream) {
  auto kern = WIDE ? edge_mlp_bwd_f32_wide_kernel<GCL, EE> : edge_mlp_bwd_f32_kernel<GCL, EE>;
  // The shared-memory limit is raised once per device and instantiation.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const int TI = tile_nodes(N, NL);
  const int tpg = tiles_per_graph(N, NL);
  const int ntiles = B * tpg;
  const int nkt = (H + kKT - 1) / kKT;
  kern<<<ntiles < nblk ? ntiles : nblk, kThreads, kSmem, stream>>>(
      N, NL, H, E, nkt, TI, tpg, ntiles, u, v, ef, em, w_e, ld_we, b0, w1p, w1tp, b1, wh, bh,
      norm, g, s0, dpre1, du, dvp, de, dwe, dhead, part, prof);
  return cudaGetLastError();
}

template <bool GCL>
cudaError_t dispatch_bwd(int B, int N, int NL, int H, int E, const float* u, const float* v,
                         const float* ef, const float* em, const float* w_e, int ld_we,
                         const float* b0, const float* w1p, const float* w1tp, const float* b1,
                         const float* wh, const float* bh, float norm, const float* g,
                         float* s0, float* dpre1, float* du, float* dvp, float* de, float* dwe,
                         float* dhead, float* part, int nblk, long long* prof,
                         cudaStream_t s) {
  if (N > kRows)   // the wide kernel: the square edge set only (checked by the caller)
    return E <= 2
        ? launch_bwd<GCL, 2, true>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, w1tp, b1,
                                   wh, bh, norm, g, s0, dpre1, du, dvp, de, dwe, dhead, part,
                                   nblk, prof, s)
        : launch_bwd<GCL, kMaxE, true>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, w1tp,
                                       b1, wh, bh, norm, g, s0, dpre1, du, dvp, de, dwe, dhead,
                                       part, nblk, prof, s);
  return E <= 2
      ? launch_bwd<GCL, 2, false>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, w1tp, b1, wh,
                                  bh, norm, g, s0, dpre1, du, dvp, de, dwe, dhead, part, nblk,
                                  prof, s)
      : launch_bwd<GCL, kMaxE, false>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, w1tp, b1,
                                      wh, bh, norm, g, s0, dpre1, du, dvp, de, dwe, dhead, part,
                                      nblk, prof, s);
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

extern "C" {

// Largest number of nodes the kernel takes (j-slabs: kRows); the Python
// wrapper checks against it.
int mlcg_edge_mlp_bwd_f32_max_nodes() { return kMaxNodes; }
// Bytes of one packed W1 tile, floats of a block's row of `part` (dwh by
// consumer warp, kMaxHidden each), clock slots per block of `prof`.
int mlcg_edge_mlp_bwd_f32_w1_tile_bytes() { return kWTileBytes; }
int mlcg_edge_mlp_bwd_f32_part_floats() { return kPartFloats; }
int mlcg_edge_mlp_bwd_f32_prof_slots() { return kProfSlots; }
// Tiles (wide: work items) per graph of N target nodes by NL source nodes:
// the second axis of the dv partials.
int mlcg_edge_mlp_bwd_f32_tiles_per_graph(int N, int NL) {
  return N > 0 && NL > 0 && N <= kMaxNodes && (N <= kRows || NL == N) ? tiles_per_graph(N, NL)
                                                                      : 0;
}

// mode: 0 = gcl, 1 = coord. All operands float32. N target nodes and NL
// source nodes a graph, 0 < NL <= N <= 128 (NL = N: the square edge set), or
// 128 < N = NL <= 192 (the wide kernel).
// u: (B, N, H) and v: (B, NL, H), 16-byte aligned; ef: (B, N*NL, E);
// em: (B, N*NL) (gcl only); w_e: (H, E) with row stride ld_we; b0, b1, wh:
// (H,); bh: (1,) or null; w1p, w1tp: pack_w1(W1) and pack_w1(W1^T)
// (ops/gcl_kernel.py), 16-byte aligned; g: (B, N, H) for gcl, (B, N*NL) for
// coord. H a multiple of 4, at most 448; E <= 4.
// Outputs, all written in full, 16-byte aligned:
//   s0: (B*N*NL, H + 4), s0 then 1, 0, 0, 0 on each row; dpre1: (B*N*NL, H)
//   (so that [dW1 | db1] = dpre1^T s0[:, :H + 1]; rows by edge, or for the
//   wide kernel in its tiles' order);
//   du: (B, N, H); dvp: (B, tpg, NL, H), tpg = tiles_per_graph(N, NL), dv's
//   partial sums; de: (B, N*NL, E); dwe: (B, N, E, H), sum_j dpre0_ij e_ij;
//   dhead: (B*N*NL,).
// part: nblk rows of mlcg_edge_mlp_bwd_f32_part_floats() floats, zeros on
// entry, to which each block adds its dwh sums. nblk: blocks (one per SM).
// prof: null, or zeros, nblk times mlcg_edge_mlp_bwd_f32_prof_slots() int64,
// to which each block's first thread adds clocks: 0 the tile's rows, 1 and 3
// the recompute's halves (with the s0 build), 2 and 4 storing their pre1
// (gcl) or their epilogue (coord), 5 gcl's epilogue (dpre1), 6 and 8 the
// second product's halves,
// 7 and 9 their epilogues, 10 and 11 their column sums.
int mlcg_edge_mlp_bwd_f32(int mode, int B, int N, int NL, int H, int E, const void* u,
                          const void* v, const void* ef, const void* em, const void* w_e, int ld_we,
                          const void* b0, const void* w1p, const void* w1tp, const void* b1,
                          const void* wh, const void* bh, float norm, const void* g, void* s0,
                          void* dpre1, void* du, void* dvp, void* de, void* dwe, void* dhead,
                          void* part, int nblk, void* prof, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxNodes || (N > kRows && NL != N) || NL <= 0 || NL > N ||
      H <= 0 || H > kMaxHidden ||
      H % 4 != 0 || E < 0 || E > kMaxE || nblk <= 0 || !aligned(u, 16) || !aligned(v, 16) || !aligned(w1p, 16) ||
      !aligned(w1tp, 16) || !aligned(s0, 16) || !aligned(dpre1, 16) || !aligned(du, 16) ||
      !aligned(dvp, 16) || !aligned(dwe, 16) || !aligned(part, 16))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && em == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fu = (const float*)u, *fv = (const float*)v, *fef = (const float*)ef,
              *fem = (const float*)em, *fwe = (const float*)w_e, *fb0 = (const float*)b0,
              *fw1 = (const float*)w1p, *fw1t = (const float*)w1tp, *fb1 = (const float*)b1,
              *fwh = (const float*)wh, *fbh = (const float*)bh, *fg = (const float*)g;
  float *o_s0 = (float*)s0, *o_d1 = (float*)dpre1, *o_du = (float*)du, *o_dvp = (float*)dvp,
        *o_de = (float*)de, *o_dwe = (float*)dwe, *o_dh = (float*)dhead, *o_p = (float*)part;
  long long* p = (long long*)prof;
  const cudaError_t err = mode == 0
      ? dispatch_bwd<true>(B, N, NL, H, E, fu, fv, fef, fem, fwe, ld_we, fb0, fw1, fw1t, fb1, fwh,
                           fbh, norm, fg, o_s0, o_d1, o_du, o_dvp, o_de, o_dwe, o_dh, o_p, nblk,
                           p, s)
      : dispatch_bwd<false>(B, N, NL, H, E, fu, fv, fef, fem, fwe, ld_we, fb0, fw1, fw1t, fb1, fwh,
                            fbh, norm, fg, o_s0, o_d1, o_du, o_dvp, o_de, o_dwe, o_dh, o_p,
                            nblk, p, s);
  return (int)err;
}

}  // extern "C"
