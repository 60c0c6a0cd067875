// Fused EGNN edge pass in float32 for Hopper (sm_90a): 3xTF32 on wgmma.
//
// The float32 counterpart of edge_mlp.cu; see the note there for what the pass
// computes. It replaces the TPU kernel ml_conformer_generator_tpu/ops/
// gcl_kernel.py::_edge_kernel (both of its modes) for compute_dtype="float32"
// and holds the plain float32 version's results to 1e-5 + 1e-4 |ref|.
//
// What bounds it: the m1 . W1 product, 2 B N^2 H^2 operations (tens of GFLOP
// at B = 64..128, N = 32..40, H = 420) against a few MB of inputs. On the f32
// FMA units (67 TFLOP/s) that product alone takes longer than one cuBLAS f32
// GEMM of it. TF32 tensor cores (495 TFLOP/s) keep 11 significant bits, too
// few for the f32 bar (the coord head would be off by ~1e-3). So each operand
// is split into two TF32 numbers,
//   x = hi + lo,  hi = round_tf32(x),  lo = round_tf32(x - hi),
// and the product is taken as hi.hi + hi.lo + lo.hi on the tensor cores with
// f32 accumulation ("3xTF32"). The dropped lo.lo term and the rounding of lo
// are below 2^-21 of each product, so the sum is f32-accurate; three
// products give 165 TFLOP/s of it, 2.5x the FMA peak.
//
// ---- The design -------------------------------------------------------------
// Tiles and blocks are the bf16 kernel's: a persistent block (one per SM) walks
// tiles of TI whole target nodes of one graph, TI * NL <= 128 edge rows, as two
// 64-row wgmma m-tiles, one per consumer warpgroup; whole nodes keep the gated
// j-sum inside the block (no atomics). N <= 128 (past it, the wide kernel
// below).
//
// The edge set may be a j-slab (the edge-sharded EGNN of parallel/edge_shard.py
// gives each rank one): N target nodes i by NL <= N source nodes j, u (B, N, H),
// v (B, NL, H), the edges (B, N * NL) in the order (i, j). A target node's
// rows are its NL edges, the gcl j-sum runs over the slab, and coord writes
// (B, N * NL). NL = N is the square edge set.
//
// W1 is split and packed once per weight by the wrapper
// (ops/gcl_kernel.py::pack_w1): zero-padded to 448 output rows x 16 ceil(H/16)
// input columns, cut into tiles of 224 output rows x 16 input columns. A tile
// row is 128 bytes, the 16 hi values and then the 16 lo values, its 16-byte
// chunks XOR-swizzled with the row (the 128-byte swizzle), so a tile is
// 28,672 contiguous bytes, as in the bf16 kernel. One producer thread streams
// the tiles through a ring of three slots with one cp.async.bulk per tile,
// completing on an mbarrier; both consumer warpgroups read each tile, so W1
// crosses from L2 once per 128 rows. The producer sits in a third warpgroup
// so that setmaxnreg can hand its registers to the consumers.
//
// A (m1) is built in registers, never in shared memory: an f32 m1 tile of 128
// rows is 224 KB. For each K-tile of 16 columns a consumer thread computes
// m1 = SiLU(u_i + v_j + e_ij . W_e + b0) at its two rows and four columns,
// splits it with cvt.rna.tf32 and a subtraction, and issues six wgmma
// m64n224k8 (two k-steps of 8 x three products) with A from registers and B
// (hi or lo) from the ring. The four columns of thread t of a quad are the
// contiguous input columns 4t .. 4t+3, so u and v come as one 16-byte load per
// row; the pack permutes W1's columns within each K-tile to match (the A
// fragment's logical column 8 s + 4 h + t is input column 4 t + 2 s + h). The
// A registers are double-buffered by K-tile: the next K-tile's m1 is built
// while the current K-tile's wgmmas run, and its u and v were loaded one
// K-tile earlier still, so that their latency is off the path to the next
// wgmma (measured: 6-12% of a launch at N = 32..64). m1 is built once per
// output half, three SiLUs per element in all instead of two; the
// special-function work is still far below the product's time.
//
// The output columns are walked in two halves of 224 (112 f32 accumulators a
// thread). Each half's epilogue (bias, SiLU, the head's partial dot product)
// runs in registers; a thread owns two whole rows of its half, so the head
// needs two shuffles. In gcl mode the first half's m2 waits in shared memory
// (128 x 224 f32, rows padded to 232 floats for conflict-free stores) until
// the gate is known; the gated, masked j-sum over the tile's whole nodes
// then reads it, the second half's m2 is written over it from registers and
// summed in turn. coord mode stores the head and keeps no m2.
//
// SiLU and the sigmoid use the hardware exp and divide (__expf, __fdividef):
// about 1e-7 relative error, far inside the bar.
//
// Padding is exact: padded hidden units see zero weights and a zero bias,
// stay at SiLU(0) = 0 and carry zero head weight; rows past a tile's last
// edge are built as zeros and written nowhere.
//
// Graphs of 128 < N <= 192 nodes on the square edge set (all-atom drug
// molecules: GEOM-Drugs pads its largest, 181 atoms, to 184) take the wide
// instantiation, edge_mlp_f32_wide_kernel, a name of its own so that a device
// trace tells its launches apart. Its packing is the bf16 wide kernel's
// (edge_mlp.cu): a block's work item is TI target nodes of one graph, a tile
// for each node's source nodes 0..127 and one more for the tails of all TI
// nodes, source nodes 128..N-1 packed row after row (TI (N - 128) <= 128
// rows), TI = min(8, 128 / (N - 128), kCarry / H) (N = 184: 2, N = 144: 8 at
// H <= 420). The gated j-sum runs on across a node's two tiles in f32: each
// first tile leaves its node's raw sums in shared memory (carry, TI rows of
// H floats in the room the ring and the stash leave), and the thread that
// owns a column in the tail tile adds on from there, so each sum is added in
// the order j = 0, 1, ..., N - 1; no atomics, and two launches are bit-equal.
// Everything else is the code of the N <= 128 kernel, which the wide one
// shares as a template of the same body; only a row's edge is reckoned from
// (node, source node) rather than as the node's rows end to end. j-slabs
// (NL < N) stay at N <= 128.
//
// Interface: a plain C function (mlcg_edge_mlp_f32) that launches on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError(). It is a source of its own so that the two sources build
// side by side.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 4;           // edge scalars per edge
constexpr int kMaxHidden = 448;    // H <= 448
constexpr int kMaxDevices = 64;    // devices whose attributes are cached

constexpr int kRows = 128;                 // edge rows per block tile
constexpr int kMaxNodes = kRows + 64;      // wide: a node's tail fits one m-tile
constexpr int kMaxPack = 8;                // wide: target nodes whose tails share a tile
constexpr int kCarry = 3360;               // wide: floats of carried j-sums (TI H <= kCarry)
constexpr int kNP = kMaxHidden;            // padded output width
constexpr int kNH = kNP / 2;               // columns per wgmma (one half)
constexpr int kNT = kNH / 8;               // 8-column accumulator tiles per half
constexpr int kKT = 16;                    // input columns per K-tile
constexpr int kWTileBytes = kNH * 128;     // one packed tile: 224 rows x (16 hi + 16 lo)
constexpr int kRing = 3;                   // W1 ring slots
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128; // plus the producer's warpgroup
constexpr int kLdS = kNH + 8;              // row stride (floats) of the m2 stash
constexpr int kProfSlots = 8;              // clock slots per block (profiling)

// Shared memory, from a 1024-byte aligned base.
constexpr int kOffRing = 0;
constexpr int kOffStash = kOffRing + kRing * kWTileBytes;   // f32[kRows][kLdS]
constexpr int kOffB1 = kOffStash + kRows * kLdS * 4;        // f32[kNP]
constexpr int kOffWh = kOffB1 + kNP * 4;                    // f32[kNP]
constexpr int kOffB0 = kOffWh + kNP * 4;                    // f32[kNP]
constexpr int kOffWe = kOffB0 + kNP * 4;                    // f32[kMaxE][kNP]
constexpr int kOffGw = kOffWe + kMaxE * kNP * 4;            // f32[kRows]: gate * mask
constexpr int kOffBar = kOffGw + kRows * 4;                 // 2 * kRing mbarriers
constexpr int kSmem = kOffBar + 2 * kRing * 8 + 1024;       // + alignment slack
constexpr int kOffCarry = kOffBar + 2 * kRing * 8;          // wide: f32[TI][H] running j-sums
constexpr int kSmemWide = kOffCarry + kCarry * 4 + 1024;
static_assert(kSmemWide <= 232448, "the wide kernel's shared memory exceeds the H100's 227 KB");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

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

// The A fragments of one K-tile: m1 at the thread's two rows and input
// columns k .. k + 3 (k = 16 kt + 4 t), split. hi[s] and lo[s] are the
// fragments of k-step s: column k + 2 s + h of row r0 + 8 i is element
// 2 h + i. uv holds u and v at columns k .. k + 3 and is then loaded with
// those at k_next. b0f and wef (by edge scalar, then column) are the staged
// f32 copies in shared memory, zero past H.
template <int EE>
__device__ __forceinline__ void build_a(uint32_t (&hi)[2][4], uint32_t (&lo)[2][4],
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
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < EE; ++q) {
        e[0] = fmaf(rw.f[i][q], we[q].x, e[0]);
        e[1] = fmaf(rw.f[i][q], we[q].y, e[1]);
        e[2] = fmaf(rw.f[i][q], we[q].z, e[2]);
        e[3] = fmaf(rw.f[i][q], we[q].w, e[3]);
      }
      x[i][0] = uu.x + vv.x + e[0] + bb.x;
      x[i][1] = uu.y + vv.y + e[1] + bb.y;
      x[i][2] = uu.z + vv.z + e[2] + bb.z;
      x[i][3] = uu.w + vv.w + e[3] + bb.w;
    }
  }
  load_uv<EE>(uv, rw, k_next, H);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m = silu(x[i][c]);
      const uint32_t h = tf32(m);
      hi[c >> 1][2 * (c & 1) + i] = h;
      lo[c >> 1][2 * (c & 1) + i] = tf32(m - __uint_as_float(h));
    }
  }
}

// The W1 ring as the consumers see it.
struct Ring {
  uint32_t base, full, empty;
  int slot;
  uint32_t phase;
  int prev;
};

// One K-tile of one output half: build its A, wait for its W1 tile, issue
// the six products, then retire the previous K-tile's products and free its
// slot. a_hi / a_lo are this K-tile's register buffer; the previous K-tile
// used the other one, so building here overlaps its products.
template <int EE>
__device__ __forceinline__ void product_step(float (&acc)[4 * kNT], uint32_t (&a_hi)[2][4],
                                             uint32_t (&a_lo)[2][4], float4 (&uv)[2][2],
                                             const Rows<EE>& rw, const float* b0f,
                                             const float* wef, int kt, int nkt, int h,
                                             int H, int lane, Ring& ring) {
  // The next K-tile's u and v: this half's next one, K-tile 0 of the
  // second half after the first half's last, none after the second's.
  const int kn = kt + 1 < nkt ? kt + 1 : (h == 0 ? 0 : nkt);
  build_a<EE>(a_hi, a_lo, uv, rw, b0f, wef, kt * kKT + 4 * (lane & 3),
              kn * kKT + 4 * (lane & 3), H);
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

// Masked, gated j-sum of one half's m2 (in the stash) into out: a thread owns
// four columns of one of the tile's nodes and walks its rows.
__device__ __forceinline__ void jsum_half(const float* stash, const float* gw, float* out,
                                          int h, int nodes, int NL, int H, int node0,
                                          float norm, int tid) {
  for (int item = tid; item < nodes * (kNH / 4); item += kConsumers) {
    const int ti = item / (kNH / 4);
    const int c = 4 * (item - ti * (kNH / 4));
    const int col = h * kNH + c;
    if (col >= H) continue;   // H is a multiple of 4
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j = 0; j < NL; ++j) {
      const int r = ti * NL + j;
      const float4 m = *reinterpret_cast<const float4*>(stash + r * kLdS + c);
      const float w = gw[r];
      s.x = fmaf(m.x, w, s.x);
      s.y = fmaf(m.y, w, s.y);
      s.z = fmaf(m.z, w, s.z);
      s.w = fmaf(m.w, w, s.w);
    }
    *reinterpret_cast<float4*>(out + (size_t)(node0 + ti) * H + col) =
        make_float4(s.x / norm, s.y / norm, s.z / norm, s.w / norm);
  }
}

// The wide kernel's j-sum of one half: a first tile (one node, source nodes
// 0..127) leaves its raw sums in the node's row `sub` of carry; the tail tile
// (the item's nodes, source nodes 128..N-1) takes each node's sums up from
// its row and adds on, so every sum runs in the order j = 0, 1, ..., N - 1.
__device__ __forceinline__ void jsum_half_wide(const float* stash, const float* gw, float* out,
                                               float* carry, int h, int nodes, int nsrc, int H,
                                               int node0, float norm, int tid, int sub,
                                               bool tail) {
  for (int item = tid; item < nodes * (kNH / 4); item += kConsumers) {
    const int ti = item / (kNH / 4);
    const int c = 4 * (item - ti * (kNH / 4));
    const int col = h * kNH + c;
    if (col >= H) continue;   // H is a multiple of 4
    float* held = carry + (tail ? ti : sub) * H + col;
    float4 s = tail ? *reinterpret_cast<const float4*>(held)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j = 0; j < nsrc; ++j) {
      const int r = ti * nsrc + j;
      const float4 m = *reinterpret_cast<const float4*>(stash + r * kLdS + c);
      const float w = gw[r];
      s.x = fmaf(m.x, w, s.x);
      s.y = fmaf(m.y, w, s.y);
      s.z = fmaf(m.z, w, s.z);
      s.w = fmaf(m.w, w, s.w);
    }
    if (!tail) {
      *reinterpret_cast<float4*>(held) = s;
      continue;
    }
    *reinterpret_cast<float4*>(out + (size_t)(node0 + ti) * H + col) =
        make_float4(s.x / norm, s.y / norm, s.z / norm, s.w / norm);
  }
}

// N target nodes, NL source nodes a graph. TI: whole target nodes per
// 128-row tile. tpg: tiles per graph; a tile holds nodes of one graph. nkt:
// K-tiles of W1 (ceil(H / 16)). w1p: the packed W1, 2 * nkt tiles of
// kWTileBytes. prof: null, or kProfSlots clock sums per block (see
// mlcg_edge_mlp_f32). WIDE (128 < N <= kMaxNodes, NL = N): a tile of tpg is
// a work item of TI nodes, TI + 1 tiles of rows (see the notes at the top).
#define MLCG_F32_PARAMS                                                         \
    int N, int NL, int H, int E, int nkt, int TI, int tpg, int ntiles,         \
    const float* __restrict__ u, const float* __restrict__ v,                  \
    const float* __restrict__ ef, const float* __restrict__ em,                \
    const float* __restrict__ w_e, int ld_we,                                  \
    const float* __restrict__ b0, const float* __restrict__ w1p,               \
    const float* __restrict__ b1, const float* __restrict__ wh,                \
    const float* __restrict__ bh, float norm,                                  \
    float* __restrict__ out, long long* __restrict__ prof
#define MLCG_F32_ARGS \
    N, NL, H, E, nkt, TI, tpg, ntiles, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof

template <bool GCL, int EE, bool WIDE>
__device__ __forceinline__ void edge_mlp_f32_body(MLCG_F32_PARAMS) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned (the swizzle is a function of the address).
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* stash = reinterpret_cast<float*>(smem + kOffStash);
  float* b1f = reinterpret_cast<float*>(smem + kOffB1);
  float* whf = reinterpret_cast<float*>(smem + kOffWh);
  float* b0f = reinterpret_cast<float*>(smem + kOffB0);
  float* wef = reinterpret_cast<float*>(smem + kOffWe);
  float* gw = reinterpret_cast<float*>(smem + kOffGw);
  float* carry = reinterpret_cast<float*>(smem + kOffCarry);   // WIDE only: [TI][H]
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
  for (int c = tid; c < kNP; c += kThreads) {
    b1f[c] = c < H ? b1[c] : 0.0f;
    whf[c] = c < H ? wh[c] : 0.0f;
    b0f[c] = c < H ? b0[c] : 0.0f;
    for (int q = 0; q < kMaxE; ++q)
      wef[q * kNP + c] = (c < H && q < E) ? w_e[(size_t)c * ld_we + q] : 0.0f;
  }
  __syncthreads();

  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  // Registers are handed out per warpgroup: the producer's group gives most
  // of its share back and the consumers take 232 (112 accumulators, two
  // K-tiles of split A, the next K-tile's u and v, the rows' pointers and
  // edge scalars).
  if (warp >= kConsumers / 32) {
    // ---- producer: keep the ring full of W1 tiles -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(w1p);
      const uint32_t ring = smem_u32(smem + kOffRing);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0, tile = blockIdx.x; t < my_tiles; ++t, tile += gridDim.x) {
        // WIDE: a tile for each of the item's nodes and one for their tails
        const int rounds = WIDE ? min(TI, N - (tile % tpg) * TI) + 1 : 1;
        for (int round = 0; round < rounds; ++round) {
          for (int w = 0; w < 2 * nkt; ++w) {
            mbar_wait(empty + 8 * s, ph ^ 1);   // passes at once on the first round
            mbar_expect_tx(full + 8 * s, kWTileBytes);
            bulk_load(ring + s * kWTileBytes, src + (size_t)w * kWTileBytes,
                      kWTileBytes, full + 8 * s);
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
  const float bhv = bh ? bh[0] : 0.0f;
  const bool clk = prof != nullptr && tid == 0;
  long long t_prev = 0;
  auto lap = [&](int slot) {   // prof starts as zeros
    if (clk) {
      const long long now = clock64();
      prof[(size_t)blockIdx.x * kProfSlots + slot] += now - t_prev;
      t_prev = now;
    }
  };

  Ring ring{smem_u32(smem + kOffRing), full, empty, 0, 0u, 0};
  float acc[4 * kNT];
  uint32_t a_hi0[2][4], a_lo0[2][4], a_hi1[2][4], a_lo1[2][4];
  float4 uv[2][2];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / tpg;                     // the tile's graph
    const int i0 = (tile - b * tpg) * TI;         // its first target node
    const int item_nodes = min(TI, N - i0);
#pragma unroll 1
    for (int sub = 0; sub < (WIDE ? item_nodes + 1 : 1); ++sub) {
    // WIDE: tile sub < item_nodes holds node i0 + sub's source nodes 0..127;
    // the last, tail, every node's source nodes 128..N-1.
    const bool tail = WIDE && sub == item_nodes;
    const int nodes = WIDE && !tail ? 1 : item_nodes;
    const int node0 = b * N + i0 + (WIDE && !tail ? sub : 0);
    const int j0 = tail ? kRows : 0;              // the tile's first source node
    const int nsrc = WIDE ? (tail ? N - kRows : kRows) : NL;
    const int nrows = nodes * nsrc;               // real rows of this tile
    const size_t e0 = (size_t)node0 * NL;         // first edge of this tile (not WIDE)
    // The edge of row r: its node's rows lie end to end (not WIDE), or
    // (node r / nsrc, source node j0 + r % nsrc).
    auto edge = [&](int r) -> size_t {
      return WIDE ? (size_t)(node0 + r / nsrc) * N + j0 + r % nsrc : e0 + r;
    };
    if (clk) t_prev = clock64();

    // 0. This thread's rows: their u and v rows and their edge scalars.
    Rows<EE> rw;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      rw.ok[i] = r < nrows;
      const int ti = rw.ok[i] ? r / nsrc : 0;
      const int j = rw.ok[i] ? r - ti * nsrc : 0;
      rw.u[i] = u + (size_t)(node0 + ti) * H;
      rw.v[i] = v + ((size_t)b * NL + j0 + j) * H;
#pragma unroll
      for (int q = 0; q < EE; ++q)
        rw.f[i][q] = (rw.ok[i] && q < E) ? __ldg(ef + edge(r) * E + q) : 0.0f;
    }
    load_uv<EE>(uv, rw, 4 * t4, H);
    lap(0);

    // 1. m1 . W1^T in two halves of 224 columns, each followed by its epilogue.
    float hd0 = 0.0f, hd1 = 0.0f;     // partial heads of rows r0 and r0 + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 1
      for (int kt = 0; kt < nkt; kt += 2) {
        product_step<EE>(acc, a_hi0, a_lo0, uv, rw, b0f, wef, kt, nkt, h, H, lane, ring);
        if (kt + 1 < nkt)
          product_step<EE>(acc, a_hi1, a_lo1, uv, rw, b0f, wef, kt + 1, nkt, h, H, lane,
                           ring);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(ring.empty + 8 * ring.prev);
      lap(1 + 2 * h);

      // m2 = SiLU(acc + b1) and its share of the head; gcl keeps the first
      // half's m2 in the stash and the second's in the accumulators.
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = nt * 8 + 2 * t4;
        const float2 bias = *reinterpret_cast<const float2*>(b1f + h * kNH + c);
        const float2 w = *reinterpret_cast<const float2*>(whf + h * kNH + c);
        const float m00 = silu(acc[4 * nt] + bias.x);
        const float m01 = silu(acc[4 * nt + 1] + bias.y);
        const float m10 = silu(acc[4 * nt + 2] + bias.x);
        const float m11 = silu(acc[4 * nt + 3] + bias.y);
        hd0 = fmaf(m00, w.x, fmaf(m01, w.y, hd0));
        hd1 = fmaf(m10, w.x, fmaf(m11, w.y, hd1));
        if (GCL) {
          if (h == 0) {
            *reinterpret_cast<float2*>(stash + r0 * kLdS + c) = make_float2(m00, m01);
            *reinterpret_cast<float2*>(stash + (r0 + 8) * kLdS + c) = make_float2(m10, m11);
          } else {
            acc[4 * nt] = m00;
            acc[4 * nt + 1] = m01;
            acc[4 * nt + 2] = m10;
            acc[4 * nt + 3] = m11;
          }
        }
      }
      lap(2 + 2 * h);
    }

    // 2. The head of each edge: the four lanes of a row hold its parts.
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
      // 3. gate * mask per row, then the j-sum of the first half from the
      //    stash; the second half's m2 goes over it and is summed in turn.
      if (t4 == 0) {
        gw[r0] = r0 < nrows ? __fdividef(1.0f, 1.0f + __expf(-hd0)) * em[edge(r0)] : 0.0f;
        gw[r0 + 8] = r0 + 8 < nrows
            ? __fdividef(1.0f, 1.0f + __expf(-hd1)) * em[edge(r0 + 8)] : 0.0f;
      }
      named_barrier(1, kConsumers);
      if constexpr (WIDE)
        jsum_half_wide(stash, gw, out, carry, 0, nodes, nsrc, H, node0, norm, tid, sub, tail);
      else
        jsum_half(stash, gw, out, 0, nodes, NL, H, node0, norm, tid);
      lap(5);
      named_barrier(1, kConsumers);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(stash + r0 * kLdS + c) =
            make_float2(acc[4 * nt], acc[4 * nt + 1]);
        *reinterpret_cast<float2*>(stash + (r0 + 8) * kLdS + c) =
            make_float2(acc[4 * nt + 2], acc[4 * nt + 3]);
      }
      named_barrier(1, kConsumers);
      if constexpr (WIDE)
        jsum_half_wide(stash, gw, out, carry, 1, nodes, nsrc, H, node0, norm, tid, sub, tail);
      else
        jsum_half(stash, gw, out, 1, nodes, NL, H, node0, norm, tid);
      // The next tile rewrites the stash and gw (WIDE: the tail tile reads
      // the carry its item's first tiles wrote).
      named_barrier(1, kConsumers);
    }
    lap(6);
    }   // sub
  }
}

// The kernels: N <= 128, and the wide one (a name of its own in a trace).
template <bool GCL, int EE>
__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_f32_kernel(MLCG_F32_PARAMS) {
  edge_mlp_f32_body<GCL, EE, false>(MLCG_F32_ARGS);
}

template <bool GCL, int EE>
__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_f32_wide_kernel(MLCG_F32_PARAMS) {
  edge_mlp_f32_body<GCL, EE, true>(MLCG_F32_ARGS);
}

#undef MLCG_F32_PARAMS
#undef MLCG_F32_ARGS

// Target nodes of a wide work item: as many as share the tail tile (at most
// kMaxPack), and as carry holds at width H.
int wide_nodes(int N, int H) {
  const int by_rows = kRows / (N - kRows), by_carry = kCarry / H;
  return min(kMaxPack, min(by_rows, by_carry));
}

template <bool GCL, int EE, bool WIDE>
cudaError_t launch_f32(int B, int N, int NL, int H, int E, const void* u, const void* v,
                       const void* ef, const void* em, const void* w_e, int ld_we,
                       const void* b0, const void* w1p, const void* b1,
                       const void* wh, const void* bh, float norm, float* out,
                       long long* prof, cudaStream_t stream) {
  auto kern = WIDE ? edge_mlp_f32_wide_kernel<GCL, EE> : edge_mlp_f32_kernel<GCL, EE>;
  constexpr int smem = WIDE ? kSmemWide : kSmem;
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
  const int TI = WIDE ? wide_nodes(N, H) : NL <= kRows / 2 ? kRows / NL : 1;
  const int tpg = (N + TI - 1) / TI;
  const int ntiles = B * tpg;
  const int nkt = (H + kKT - 1) / kKT;
  kern<<<ntiles < n_sm ? ntiles : n_sm, kThreads, smem, stream>>>(
      N, NL, H, E, nkt, TI, tpg, ntiles, (const float*)u, (const float*)v, (const float*)ef,
      (const float*)em, (const float*)w_e, ld_we, (const float*)b0, (const float*)w1p,
      (const float*)b1, (const float*)wh, (const float*)bh, norm, out, prof);
  return cudaGetLastError();
}

template <bool GCL>
cudaError_t dispatch_f32(int B, int N, int NL, int H, int E, const void* u, const void* v,
                         const void* ef, const void* em, const void* w_e, int ld_we,
                         const void* b0, const void* w1p, const void* b1,
                         const void* wh, const void* bh, float norm, float* out,
                         long long* prof, cudaStream_t s) {
  if (N > kRows)   // the wide kernel: the square edge set only (checked by the caller)
    return E <= 2
        ? launch_f32<GCL, 2, true>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof, s)
        : launch_f32<GCL, kMaxE, true>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof, s);
  return E <= 2
      ? launch_f32<GCL, 2, false>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof, s)
      : launch_f32<GCL, kMaxE, false>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, out, prof, s);
}

bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

}  // namespace

extern "C" {

// Largest number of nodes the kernel takes (j-slabs: kRows); the Python
// wrapper checks against it.
int mlcg_edge_mlp_f32_max_nodes() { return kMaxNodes; }
// Bytes of one packed W1 tile and clock slots per block of `prof`.
int mlcg_edge_mlp_f32_w1_tile_bytes() { return kWTileBytes; }
int mlcg_edge_mlp_f32_prof_slots() { return kProfSlots; }

// mode: 0 = gcl, 1 = coord. All operands float32. N target nodes and NL
// source nodes a graph, 0 < NL <= N <= 128 (NL = N: the square edge set), or
// 128 < N = NL <= 192 (the wide kernel).
// u: (B, N, H) and v: (B, NL, H), 16-byte aligned; ef: (B, N*NL, E);
// em: (B, N*NL) (gcl only);
// w_e: (H, E) with row stride ld_we; b0, b1, wh: (H,); bh: (1,) or null;
// H a multiple of 4, at most 448; E <= 4.
// w1p: W1 split and packed, 2 * ceil(H / 16) tiles of
// mlcg_edge_mlp_f32_w1_tile_bytes() bytes, 16-byte aligned (see pack_w1 in
// ops/gcl_kernel.py).
// out: (B, N, H) for gcl, (B, N*NL) for coord.
// prof: null, or zeros, one block per SM times mlcg_edge_mlp_f32_prof_slots()
// int64, to which each block's first thread adds clocks: 0 the tile's rows,
// 1 and 3 the product of half 0 and 1 (with the A build), 2 and 4 its
// epilogue, 5 gate and the first half's j-sum, 6 the second half's j-sum
// and the tile's last barrier; the wide kernel adds each of its tiles' clocks.
int mlcg_edge_mlp_f32(int mode, int B, int N, int NL, int H, int E, const void* u,
                      const void* v, const void* ef, const void* em,
                      const void* w_e, int ld_we, const void* b0, const void* w1p,
                      const void* b1, const void* wh, const void* bh, float norm,
                      void* out, void* prof, void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxNodes || (N > kRows && NL != N) || NL <= 0 || NL > N ||
      H <= 0 || H > kMaxHidden || H % 4 != 0 || E < 0 || E > kMaxE || !aligned(u, 16) ||
      !aligned(v, 16) || !aligned(w1p, 16))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && em == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  long long* p = (long long*)prof;
  const cudaError_t err = mode == 0
      ? dispatch_f32<true>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, o, p, s)
      : dispatch_f32<false>(B, N, NL, H, E, u, v, ef, em, w_e, ld_we, b0, w1p, b1, wh, bh, norm, o, p, s);
  return (int)err;
}

}  // extern "C"
