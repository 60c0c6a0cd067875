// Fused EGNN edge pass in float32 for Hopper (sm_90a), off the main path.
//
// The float32 counterpart of edge_mlp.cu (see the note there for what the pass
// computes and which TPU kernel it replaces: ml_conformer_generator_tpu/ops/
// gcl_kernel.py::_edge_kernel, both modes). It serves compute_dtype="float32"
// on the card. What bounds it: the m1 . W1 product, 2 B N^2 H^2 operations on
// the f32 FMA units (no TF32), against a few MB of inputs.
//
// One target node per block of 256 threads, N <= 64 (four 16-row tiles of
// source nodes). m1 and later m2 live in shared memory; W1 (torch layout,
// [out][in]) is streamed in K-tiles of 16 through a 3-stage cp.async ring
// (8-byte chunks, zero-filled past H), served from L2; the product is plain
// FMA in full f32. H is zero-padded to a multiple of 64 inside the kernel,
// which is exact: padded units see zero weights and a zero bias, stay at
// SiLU(0) = 0 and carry zero head weight.
//
// Interface: a plain C function (mlcg_edge_mlp_f32) that launches on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError(). It is a source of its own so that the two sources build
// side by side.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 4;           // edge scalars per edge
constexpr int kMaxHidden = 448;    // HP <= 448
constexpr int kMaxDevices = 64;    // devices whose attributes are cached

constexpr int kThreads = 256;      // threads per target node
constexpr int kWarps = kThreads / 32;
constexpr int kKT = 16;            // K-tile of W1
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kMaxNTW = kMaxHidden / 64;   // columns per thread
constexpr int kMaxMT = 4;          // 16-row tiles of source nodes: N <= 64
constexpr int kLdmPad = 1;         // m1/m2 row padding: conflict-free FMA reads
constexpr int kLdb = kKT + 2;      // W1 tile row: 8-byte aligned for cp.async

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;   // 0 source bytes: the 8 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float silu_f32(float x) { return x / (1.0f + expf(-x)); }

// MT: number of 16-row tiles covering the N source nodes (MP = 16 * MT).
// H is zero-padded to HP (a multiple of 64) inside the kernel; rows j >= N of
// the last tile are computed and ignored. H is even and u, v, b0, w1 8-byte
// aligned (whole 8-byte chunks and element pairs).
template <bool GCL, int MT>
__global__ void __launch_bounds__(kThreads, 1)
edge_mlp_f32_kernel(int N, int H, int E, int HP,
                    const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ ef, const float* __restrict__ em,
                    const float* __restrict__ w_e, int ld_we,
                    const float* __restrict__ b0, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ wh,
                    const float* __restrict__ bh, float norm, float* __restrict__ out) {
  constexpr int MP = 16 * MT;
  constexpr int CPR = kKT / 2;             // 8-byte chunks per W1 tile row
  const int LDM = HP + kLdmPad;
  const int ntw = HP / 64;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x;               // b * N + i
  const int b = bi / N;

  extern __shared__ __align__(16) unsigned char smem[];
  float* M = reinterpret_cast<float*>(smem);                  // MP x LDM
  size_t off = ((size_t)MP * LDM * 4 + 15) & ~(size_t)15;
  float* Bs = reinterpret_cast<float*>(smem + off);           // kStages x HP x kLdb
  off += ((size_t)kStages * HP * kLdb * 4 + 15) & ~(size_t)15;
  float* gate_s = reinterpret_cast<float*>(smem + off);       // MP
  float* em_s = gate_s + MP;                                  // MP
  float* hpart = em_s + MP;                                   // kWarps x MP

  const float* u_i = u + (size_t)bi * H;
  const float* ef_i = ef + (size_t)bi * N * E;
  const int nkt = HP / kKT;

  // Stage tile kt of W1 (rows n < HP, columns kt*kKT ..) into ring slot s.
  auto load_tile = [&](int s, int kt) {
    float* dst = Bs + (size_t)s * HP * kLdb;
    const int k0 = kt * kKT;
    for (int c = tid; c < HP * CPR; c += kThreads) {
      const int n = c / CPR;
      const int q = c - n * CPR;
      const int k = k0 + q * 2;
      const bool ok = n < H && k < H;
      cp_async8(dst + n * kLdb + q * 2, ok ? w1 + (size_t)n * H + k : w1, ok);
    }
  };

  // The first tiles load while m1 is built.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_tile(s, s);
    cp_async_commit();
  }

  if (GCL) {
    for (int j = tid; j < N; j += kThreads) em_s[j] = em[(size_t)bi * N + j];
  }
  // warps write the partial heads of their own rows only
  for (int r = tid; r < kWarps * MP; r += kThreads) hpart[r] = 0.0f;

  // 1. m1 = SiLU(u_i + v_j + e_ij . W_e + b0): each thread owns a column
  //    pair (k, k+1), holds u_i, b0 and W_e there in registers and walks
  //    the rows j.
  for (int p = tid; p < HP / 2; p += kThreads) {
    const int k = 2 * p;
    const bool kin = k < H;           // H is even: then k + 1 < H too
    float we0[kMaxE], we1[kMaxE];
#pragma unroll
    for (int q = 0; q < kMaxE; ++q) {
      we0[q] = (kin && q < E) ? w_e[(size_t)k * ld_we + q] : 0.0f;
      we1[q] = (kin && q < E) ? w_e[(size_t)(k + 1) * ld_we + q] : 0.0f;
    }
    const float2 uk = kin ? *reinterpret_cast<const float2*>(u_i + k) : make_float2(0.0f, 0.0f);
    const float2 bk = kin ? *reinterpret_cast<const float2*>(b0 + k) : make_float2(0.0f, 0.0f);
    const float* v_k = v + (size_t)b * N * H + k;
#pragma unroll 4
    for (int j = 0; j < MP; ++j) {
      float m0 = 0.0f, m1 = 0.0f;
      if (j < N && kin) {
        const float2 vj = *reinterpret_cast<const float2*>(v_k + (size_t)j * H);
        float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
        for (int q = 0; q < kMaxE; ++q) {
          if (q < E) {
            const float f = ef_i[(size_t)j * E + q];
            e0 += f * we0[q];
            e1 += f * we1[q];
          }
        }
        m0 = silu_f32(uk.x + vj.x + e0 + bk.x);
        m1 = silu_f32(uk.y + vj.y + e1 + bk.y);
      }
      M[j * LDM + k] = m0;            // rows are odd-length: no paired store
      M[j * LDM + k + 1] = m1;
    }
  }

  // 2. m1 . W1^T with W1 (torch layout, [out][in]) streamed through the ring.
  //    A thread owns rows ty + 4 r (r < 4 MT) and columns tx + 64 q (q < ntw).
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 63, ty = tid >> 6;
  float acc[4 * MT][kMaxNTW];
#pragma unroll
  for (int r = 0; r < 4 * MT; ++r)
#pragma unroll
    for (int q = 0; q < kMaxNTW; ++q) acc[r][q] = 0.0f;

  for (int kt = 0; kt < nkt; ++kt) {
    // Keep kStages - 1 tiles in flight: start tile kt + kStages - 1 into the
    // slot that the previous iteration finished with, then wait for tile kt.
    const int nt = kt + kStages - 1;
    if (nt < nkt) load_tile(nt % kStages, nt);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();   // tile kt (and, at kt = 0, all of m1) is visible
    const float* Bt = Bs + (size_t)(kt % kStages) * HP * kLdb;
    const int k0 = kt * kKT;
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      float bv[kMaxNTW];
#pragma unroll
      for (int q = 0; q < kMaxNTW; ++q)
        bv[q] = (q < ntw) ? Bt[(tx + 64 * q) * kLdb + kk] : 0.0f;
#pragma unroll
      for (int r = 0; r < 4 * MT; ++r) {
        const float a = M[(ty + 4 * r) * LDM + k0 + kk];
#pragma unroll
        for (int q = 0; q < kMaxNTW; ++q)
          if (q < ntw) acc[r][q] = fmaf(a, bv[q], acc[r][q]);
      }
    }
    __syncthreads();   // slot kt % kStages is free for the load of tile kt + kStages
  }
  cp_async_wait<0>();

  // 3. m2 = SiLU(acc + b1), stored over m1 for the j-sum (every read of m1 is
  //    done: the loop ends with a barrier), and its scalar head m2 . wh
  //    reduced on the way: per thread over its columns, across the warp
  //    (a warp holds one ty), then into hpart[warp][row].
#pragma unroll
  for (int r = 0; r < 4 * MT; ++r) {
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxNTW; ++q) {
      if (q < ntw) {
        const int c = tx + 64 * q;
        const bool cin = c < H;
        const float x = silu_f32(acc[r][q] + (cin ? b1[c] : 0.0f));
        if (GCL) M[(ty + 4 * r) * LDM + c] = x;
        part += x * (cin ? wh[c] : 0.0f);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) hpart[warp * MP + ty + 4 * r] = part;
  }
  __syncthreads();

  // 4. The head of each edge: the gate (gcl) or the output (coord).
  const float bhv = bh ? bh[0] : 0.0f;
  for (int j = tid; j < N; j += kThreads) {
    float head = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) head += hpart[w * MP + j];
    head += bhv;
    if (GCL) {
      gate_s[j] = 1.0f / (1.0f + expf(-head));
    } else {
      out[(size_t)bi * N + j] = head;
    }
  }
  if (!GCL) return;
  __syncthreads();

  // 5. Gated, masked j-sum.
  for (int n = tid; n < H; n += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < N; ++j) s += M[j * LDM + n] * gate_s[j] * em_s[j];
    out[(size_t)bi * H + n] = s / norm;
  }
}

template <int MT>
size_t f32_smem_bytes(int HP) {
  size_t off = ((size_t)16 * MT * (HP + kLdmPad) * 4 + 15) & ~(size_t)15;
  off += ((size_t)kStages * HP * kLdb * 4 + 15) & ~(size_t)15;
  return off + (2 + kWarps) * 16 * MT * sizeof(float);
}

template <bool GCL, int MT>
cudaError_t launch_f32(int B, int N, int H, int E, const void* u, const void* v,
                       const void* ef, const void* em, const void* w_e, int ld_we,
                       const void* b0, const void* w1, const void* b1,
                       const void* wh, const void* bh, float norm, float* out,
                       cudaStream_t stream) {
  const int HP = ((H + 63) / 64) * 64;
  auto kern = edge_mlp_f32_kernel<GCL, MT>;
  // The shared-memory limit is set once per device, to what the widest
  // hidden size needs; a launch then only checks a flag.
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)f32_smem_bytes<MT>(kMaxHidden));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev] = true;
  }
  kern<<<B * N, kThreads, f32_smem_bytes<MT>(HP), stream>>>(
      N, H, E, HP, (const float*)u, (const float*)v, (const float*)ef,
      (const float*)em, (const float*)w_e, ld_we, (const float*)b0,
      (const float*)w1, (const float*)b1, (const float*)wh, (const float*)bh,
      norm, out);
  return cudaGetLastError();
}

template <bool GCL>
cudaError_t dispatch_f32(int B, int N, int H, int E, const void* u, const void* v,
                         const void* ef, const void* em, const void* w_e, int ld_we,
                         const void* b0, const void* w1, const void* b1,
                         const void* wh, const void* bh, float norm, float* out,
                         cudaStream_t s) {
  switch ((N + 15) / 16) {
    case 1: return launch_f32<GCL, 1>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1, b1, wh, bh, norm, out, s);
    case 2: return launch_f32<GCL, 2>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1, b1, wh, bh, norm, out, s);
    case 3: return launch_f32<GCL, 3>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1, b1, wh, bh, norm, out, s);
    case 4: return launch_f32<GCL, 4>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1, b1, wh, bh, norm, out, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned8(const void* p) { return ((uintptr_t)p & 7) == 0; }

}  // namespace

extern "C" {

// Largest number of nodes the kernel takes; the Python wrapper checks against it.
int mlcg_edge_mlp_f32_max_nodes() { return 16 * kMaxMT; }

// mode: 0 = gcl, 1 = coord. All operands float32.
// u, v: (B, N, H); ef: (B, N*N, E); em: (B, N*N) (gcl only);
// w_e: (H, E) with row stride ld_we; b0, b1, wh: (H,); w1: (H, H) [out][in];
// bh: (1,) or null; u, v, b0, w1 8-byte aligned; H even, at most 448; E <= 4.
// out: (B, N, H) for gcl, (B, N*N) for coord.
int mlcg_edge_mlp_f32(int mode, int B, int N, int H, int E, const void* u,
                      const void* v, const void* ef, const void* em,
                      const void* w_e, int ld_we, const void* b0, const void* w1,
                      const void* b1, const void* wh, const void* bh, float norm,
                      void* out, void* stream) {
  if (B <= 0 || N <= 0 || N > 16 * kMaxMT || H <= 0 || H > kMaxHidden ||
      H % 2 != 0 || E < 0 || E > kMaxE || !aligned8(u) || !aligned8(v) ||
      !aligned8(b0) || !aligned8(w1))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && em == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  const cudaError_t err = mode == 0
      ? dispatch_f32<true>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1, b1, wh, bh, norm, o, s)
      : dispatch_f32<false>(B, N, H, E, u, v, ef, em, w_e, ld_we, b0, w1, b1, wh, bh, norm, o, s);
  return (int)err;
}

}  // extern "C"
