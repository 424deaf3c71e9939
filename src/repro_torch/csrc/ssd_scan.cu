// Mamba-2 SSD chunked scan for Hopper (sm_90a).  Per (batch b, head h),
// over chunks of Q steps, with the (N, P) state carried across chunks:
//
//   dA_cum[i] = sum_{j <= i} dt[j] * A[h]                (within the chunk)
//   y[i]      = sum_{j <= i} (C[i] . B[j]) exp(dA_cum[i] - dA_cum[j]) dt[j] x[j]
//             + exp(dA_cum[i]) C[i] H                     (H: previous state)
//   H        <- H exp(dA_cum[Q-1]) + sum_j exp(dA_cum[Q-1] - dA_cum[j]) dt[j] B[j]^T x[j]
//
// x (b, s, h, p), dt (b, s, h) f32, A (h,) f32, B/C (b, s, n) (single
// group); x, B, C f32 or bf16 (computed in f32); y in x's dtype, final
// state (b, h, n, p) f32.  Replaces the Pallas ssd_scan_kernel of
// repro/kernels/ssd_scan/kernel.py (_ssd_kernel), whose state lives in a
// VMEM scratch across the TPU's sequential chunk axis; here the final
// state is written too, so ssd_chunked(..., return the final state) runs
// on the kernel as well.
//
// Bound: at mamba2-780m's widths (n = 128, p = 64, Q = 128) the work is
// C B^T once per (b, chunk) and, per (b, chunk, head), the causal
// diagonal product, C H and the state B^T x: operations, ~4x the bytes'
// time.  Design: chunk-parallel, in the plain version's own phases
// (kernels/ssd_scan/ref.py) and the split of the public Mamba-2 Triton
// kernels (state-spaces/mamba, mamba_ssm/ops/triton/ssd_*.py: bmm_chunk,
// chunk_state, state_passing, chunk_scan), four kernels on one stream:
//
// 1. ssd_cb_kernel, one block per (b, chunk): CB = C_c B_c^T, the lower
//    triangle (j <= i), into a (b, nc, Q, Q) f32 workspace.  C B^T is the
//    same for every head (one group), so it is computed once, not per head.
// 2. ssd_chunk_state_kernel, one block per (b, chunk, head): dA_cum by a
//    warp scan of the f32 products dt A summed in f64 (into a (b, nc, h,
//    Q) f64 workspace: exp(dA_cum[i] - dA_cum[j]) then loses no digits
//    to the difference of two large sums), then the chunk's own
//    state S_c = sum_j exp(dA_cum[Q-1] - dA_cum[j]) dt[j] B_j^T x_j (n x p)
//    into a (b, nc, h, n, p) workspace.
// 3. ssd_state_passing_kernel, per (b, head), parallel over the n p
//    elements and sequential over the nc chunks: seeded from the initial
//    state, it overwrites S_c in place with the state before chunk c
//    (prev[c]) and writes the final state.
// 4. ssd_chunk_scan_kernel, one block per (b, chunk, head): y = exp(dA_cum)
//    o (C prev[c]) + (CB o L o dt) x, written once in x's dtype.  L is a
//    select, j <= i ? exp(dA_cum[i] - dA_cum[j]) : 0, never mask * exp(seg):
//    above the diagonal seg > 0 can overflow to inf, and inf * 0 is NaN.
//
// Products use register tiles of 8 x 8 outputs per thread: per step of
// the contraction, 2 float4 of each operand from shared memory feed 64
// FMAs.  In phases 2 and 4 the operands stream through a two-stage ring
// of slabs of kSlab = 16 steps: a slab's global reads (16-byte chunks)
// are in flight in registers while the slab before it is multiplied, one
// __syncthreads per slab.  Blocks of phase 4 skip, per warp, the
// diagonal slabs wholly above their rows.
// Ragged s is masked (dt = 0, x = B = C = 0 past the end, the reference's
// padding), never padded in memory.  Any n, p and Q: output tiles of 128
// rows x 64 columns are walked in loops.
//
// Rounding: explicit fused multiply-adds in the products, precise expf,
// built with -fmad=false; the state passing rounds carry * decay + S_c as
// the plain version does.  The result differs from the plain version in
// the add order of its sums (phase 4 starts its sum from exp(dA_cum) C H)
// and in dA_cum, summed in f64 where the plain version sums in f32.
// No atomics: two launches give the same bits.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlab = 16;        // contraction steps per shared-memory slab
constexpr int kTR = 128;         // output tile rows
constexpr int kTC = 64;          // output tile columns of phases 2 and 4
constexpr int kTS = kTR + 4;     // row stride of a transposed slab (floats)
constexpr int kCbThreads = 256;  // phase 1: 16 x 16 threads, 128 x 128 tile
constexpr int kThreads = 128;    // phases 2, 4: 16 x 8 threads, 128 x 64
// phases 2 and 4 at 168 registers a thread: three blocks per SM hide
// more latency than two at 255 registers (no spill) or four at 128 (heavy
// spills), though a few dozen bytes spill
constexpr int kBlocksPerSM = 3;
constexpr int kPassThreads = 256;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// kSlab x kTR slab T[k][r] = M[t0 + r0 + r, k0 + k] of a (b, s, n) matrix
// M, transposed; zero where r0 + r >= rmax, t0 + r0 + r >= s or k0 + k >=
// n.  Lanes take 8 consecutive k of 4 rows: 32-byte global segments and
// conflict-free shared stores (row stride kTS = 4 mod 32 banks).
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* __restrict__ M,
                                       int b, int s, int n, int t0, int r0,
                                       int rmax, int k0, int tid,
                                       int nthr) {
  for (int e = tid; e < kSlab * kTR; e += nthr) {
    const int k = e % 8 + 8 * (e / (8 * kTR)), r = (e / 8) % kTR;
    const int row = r0 + r, t = t0 + row, col = k0 + k;
    dst[k * kTS + r] = (row < rmax && t < s && col < n)
                           ? load(M, ((size_t)b * s + t) * n + col)
                           : 0.0f;
  }
}

// entries of the f64 cum in shared memory: Q rounded up to even, so what
// follows it stays 16-byte aligned
__host__ __device__ inline int cum_len(int Q) { return (Q + 1) & ~1; }

// dts[j] = dt[b, t0 + j, h] (0 past s) and cum = the inclusive scan of
// the f32 products dts * a, summed in f64 by warp 0; the block syncs
// before and after
__device__ void chunk_cum(float* dts, double* cum, const float* __restrict__ dt,
                          float a, int b, int s, int H, int h, int t0, int Q) {
  for (int j = threadIdx.x; j < Q; j += blockDim.x)
    dts[j] = t0 + j < s ? dt[((size_t)b * s + t0 + j) * H + h] : 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double carry = 0.0;
    for (int j0 = 0; j0 < Q; j0 += 32) {
      const int j = j0 + lane;
      double v = j < Q ? (double)__fmul_rn(dts[j], a) : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = __dadd_rn(v, u);
      }
      v = __dadd_rn(v, carry);
      if (j < Q) cum[j] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// acc[r][4 jj + e] += sum_k rows[k][8 tr + r] * cols[k][4 tc + 32 jj + e]
// over k < kSlab: the 8 x 8 register tile of one slab
__device__ __forceinline__ void tile_fma(float (&acc)[8][8],
                                         const float* rows, int rstride,
                                         const float* cols, int cstride) {
#pragma unroll 4
  for (int k = 0; k < kSlab; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(rows + k * rstride);
    const float4 a1 =
        *reinterpret_cast<const float4*>(rows + k * rstride + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(cols + k * cstride);
    const float4 c1 =
        *reinterpret_cast<const float4*>(cols + k * cstride + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = __fmaf_rn(a[r], c[e], acc[r][e]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
}

// column of element e of a thread's 8 x 8 tile: 4 tc + 32 (e / 4) + e % 4
__device__ __forceinline__ int tile_col(int tc, int e) {
  return 4 * tc + 32 * (e / 4) + e % 4;
}

// ---- phase 1: CB = C B^T per (b, chunk), lower triangle --------------------
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int s, int n, int Q, int nc) {
  __shared__ __align__(16) float Ct[kSlab * kTS];
  __shared__ __align__(16) float Bt[kSlab * kTS];
  const int bc = blockIdx.x, b = bc / nc, c = bc % nc;
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int t0 = c * Q;
  float* out = cb + (size_t)bc * Q * Q;
  for (int i0 = 0; i0 < Q; i0 += kTR)
    for (int j0 = 0; j0 <= i0; j0 += kTR) {
      // 128 x 128 tile: rows i0 + 8 ti + r, columns j0 + 4 tj + 64 jj + e
      float acc[8][8];
      zero(acc);
      for (int k0 = 0; k0 < n; k0 += kSlab) {
        __syncthreads();
        load_t(Ct, Cm, b, s, n, t0, i0, Q, k0, tid, kCbThreads);
        load_t(Bt, Bm, b, s, n, t0, j0, Q, k0, tid, kCbThreads);
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kSlab; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(Ct + k * kTS + 8 * ti);
          const float4 a1 = *reinterpret_cast<const float4*>(Ct + k * kTS + 8 * ti + 4);
          const float4 c0 = *reinterpret_cast<const float4*>(Bt + k * kTS + 4 * tj);
          const float4 c1 = *reinterpret_cast<const float4*>(Bt + k * kTS + 4 * tj + 64);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float cc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[r][e] = __fmaf_rn(a[r], cc[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + 8 * ti + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = j0 + 4 * tj + 64 * (e / 4) + e % 4;
          if (i < Q && j <= i) out[(size_t)i * Q + j] = acc[r][e];
        }
      }
    }
}

// ---- register-prefetched slabs of phases 2 and 4 ---------------------------
//
// A slab's global reads are 16-byte chunks (4 f32 or 8 bf16 values),
// neighbouring threads on neighbouring chunks, loaded into registers
// before the products of the slab before it and written to shared memory
// (converted to f32, and transformed where the phase needs it) after them:
// a two-stage ring with one __syncthreads per slab.  Chunks off the
// matrix's edge, or of a matrix whose rows are not whole aligned chunks
// (vec == 0), are read element by element, zero outside it.

template <typename T>
struct Vec {
  static constexpr int kN = 16 / (int)sizeof(T);  // values per chunk
};

__device__ __forceinline__ uint32_t bits(const float* v) {
  return __float_as_uint(*v);
}
__device__ __forceinline__ uint32_t bits(const __nv_bfloat16* v) {
  return *reinterpret_cast<const unsigned short*>(v);
}

// the chunk at column col of a row (row null: outside the matrix) whose
// valid columns end at ncols
template <typename T>
__device__ __forceinline__ uint4 ld_chunk(const T* row, int col, int ncols,
                                          bool vec) {
  constexpr int V = Vec<T>::kN;
  if (row != nullptr && vec && col + V <= ncols)
    return __ldg(reinterpret_cast<const uint4*>(row + col));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row != nullptr)
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (col + e < ncols)
        w[e * (int)sizeof(T) / 4] |= bits(row + col + e)
                                     << (8 * (e * (int)sizeof(T) % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void to_f32(uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_f32(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// acc[r][e] += sum_k A[8 tr + r][k] * Bm[k][tile_col(tc, e)] over k <
// kSlab, A row-major (row stride kAS): per 4 steps 8 float4 of A (the same
// for a quarter-warp) and 8 of Bm feed 256 FMAs
constexpr int kAS = kSlab + 4;
__device__ __forceinline__ void tile_fma_rows(float (&acc)[8][8],
                                              const float* A,
                                              const float* Bm) {
#pragma unroll 2
  for (int k4 = 0; k4 < kSlab; k4 += 4) {
    float4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + r * kAS + k4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 c0 =
          *reinterpret_cast<const float4*>(Bm + (k4 + q) * kTC);
      const float4 c1 =
          *reinterpret_cast<const float4*>(Bm + (k4 + q) * kTC + 32);
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float av = q == 0 ? a[r].x : q == 1 ? a[r].y
                       : q == 2 ? a[r].z : a[r].w;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = __fmaf_rn(av, c[e], acc[r][e]);
      }
    }
  }
}

// ---- phase 2: dA_cum and the chunk's own state, per (b, chunk, head) -------
//
// S[nn][pp] = sum_j (w[j] B[j][nn]) x[j][pp]: the slabs are kSlab steps j
// of w B (kSlab x 128, rows nn of the tile k-major) and of x (kSlab x
// 64).
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       double* __restrict__ cum_ws, float* __restrict__ states,
                       int s, int H, int p, int n, int Q, int nc, int vecx,
                       int vecb) {
  constexpr int V = Vec<T>::kN;
  constexpr int NB = kSlab * kTR / V / kThreads;  // chunks of w B a thread
  constexpr int NX = kSlab * kTC / V / kThreads;  // chunks of x a thread
  extern __shared__ float4 ssd_smem[];
  double* cum = reinterpret_cast<double*>(ssd_smem);            // Q
  float* ring = reinterpret_cast<float*>(cum + cum_len(Q));     // 2 stages
  constexpr int kStage = kSlab * (kTR + kTC);  // w B, then x
  float* dts = ring + 2 * kStage;                               // Q
  float* wv = dts + Q;                                          // Q
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc % nc, t0 = c * Q;
  const int tid = threadIdx.x, tn = tid / 8, tp = tid % 8;

  chunk_cum(dts, cum, dt, A[h], b, s, H, h, t0, Q);
  const double cum_last = cum[Q - 1];
  double* cum_out = cum_ws + ((size_t)bc * H + h) * Q;
  for (int j = tid; j < Q; j += kThreads) {
    cum_out[j] = cum[j];
    wv[j] = __fmul_rn(expf((float)(cum_last - cum[j])), dts[j]);
  }
  __syncthreads();
  float* st = states + ((size_t)bc * H + h) * n * p;
  const int nslab = (Q + kSlab - 1) / kSlab;

  for (int n0 = 0; n0 < n; n0 += kTR)
    for (int p0 = 0; p0 < p; p0 += kTC) {
      uint4 rb[NB], rx[NX];
      auto fetch = [&](int j0) {
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int q = tid + kThreads * u;
          const int jj = q / (kTR / V), col = (q % (kTR / V)) * V;
          const int j = j0 + jj, t = t0 + j;
          rb[u] = ld_chunk(j < Q && t < s ? Bm + ((size_t)b * s + t) * n + n0
                                          : (const T*)nullptr,
                           col, n - n0, vecb != 0);
        }
#pragma unroll
        for (int u = 0; u < NX; ++u) {
          const int q = tid + kThreads * u;
          const int jj = q / (kTC / V), col = (q % (kTC / V)) * V;
          const int j = j0 + jj, t = t0 + j;
          rx[u] = ld_chunk(
              j < Q && t < s ? x + (((size_t)b * s + t) * H + h) * p + p0
                             : (const T*)nullptr,
              col, p - p0, vecx != 0);
        }
      };
      auto commit = [&](int j0, float* buf) {
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int q = tid + kThreads * u;
          const int jj = q / (kTR / V), col = (q % (kTR / V)) * V;
          const int j = j0 + jj;
          const float w = j < Q ? wv[j] : 0.0f;
          float v[V];
          to_f32(rb[u], v);
#pragma unroll
          for (int e = 0; e < V; ++e) v[e] = __fmul_rn(w, v[e]);
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(buf + jj * kTR + col + e) =
                make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        }
        float* xb = buf + kSlab * kTR;
#pragma unroll
        for (int u = 0; u < NX; ++u) {
          const int q = tid + kThreads * u;
          const int jj = q / (kTC / V), col = (q % (kTC / V)) * V;
          float v[V];
          to_f32(rx[u], v);
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(xb + jj * kTC + col + e) =
                make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        }
      };

      // rows n0 + 8 tn + r of the state, columns p0 + tile_col(tp, e)
      float acc[8][8];
      zero(acc);
      fetch(0);
      for (int k = 0; k < nslab; ++k) {
        float* buf = ring + (k & 1) * kStage;
        commit(k * kSlab, buf);
        __syncthreads();
        if (k + 1 < nslab) fetch((k + 1) * kSlab);
        tile_fma(acc, buf + 8 * tn, kTR, buf + kSlab * kTR + 4 * tp, kTC);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int nn = n0 + 8 * tn + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pp = p0 + tile_col(tp, e);
          if (nn < n && pp < p) st[(size_t)nn * p + pp] = acc[r][e];
        }
      }
      __syncthreads();  // the ring is refilled by the next tile
    }
}

// ---- phase 3: the states before each chunk, per (b, head) ------------------
constexpr int kPassBatch = 8;  // chunk states read ahead per thread

__global__ void __launch_bounds__(kPassThreads)
ssd_state_passing_kernel(float* __restrict__ states,
                         const double* __restrict__ cum_ws,
                         const float* __restrict__ h0,
                         float* __restrict__ hout, int H, int np, int Q,
                         int nc) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int e = blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= np) return;
  float carry = h0 ? h0[(size_t)bh * np + e] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    // the batch's reads first, all in flight together
    float own[kPassBatch], decay[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const size_t bch = (size_t)(b * nc + c0 + k) * H + h;
      own[k] = c0 + k < nc ? states[bch * np + e] : 0.0f;
      decay[k] = c0 + k < nc ? expf((float)cum_ws[bch * Q + Q - 1]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k >= nc) break;
      const size_t bch = (size_t)(b * nc + c0 + k) * H + h;
      states[bch * np + e] = carry;  // prev[c]
      carry = __fadd_rn(__fmul_rn(carry, decay[k]), own[k]);
    }
  }
  hout[(size_t)bh * np + e] = carry;
}

// ---- phase 4: the chunk's outputs, per (b, chunk, head) --------------------
//
// Per 128 x 64 tile of y: first the slabs of kSlab state rows nn, A = C
// (rows i, row-major) and Bm = prev[c]; then acc *= exp(dA_cum[i]); then
// the slabs of kSlab steps j <= the tile's last row, A = CB o L o dt (built
// from the cb workspace as it is written to shared memory) and Bm = x.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Cm, const float* __restrict__ cb,
                      const double* __restrict__ cum_ws,
                      const float* __restrict__ prev, T* __restrict__ y,
                      int s, int H, int p, int n, int Q, int nc, int vecx,
                      int vecc, int vecq) {
  constexpr int V = Vec<T>::kN;
  constexpr int NA = kTR * kSlab / 4 / kThreads;  // A chunks a thread (f32)
  constexpr int NB = kSlab * kTC / 4 / kThreads;  // Bm chunks a thread (f32)
  extern __shared__ float4 ssd_smem[];
  double* cum = reinterpret_cast<double*>(ssd_smem);            // Q
  float* ring = reinterpret_cast<float*>(cum + cum_len(Q));     // 2 stages
  constexpr int kStage = kTR * kAS + kSlab * kTC;  // A, then Bm
  float* dts = ring + 2 * kStage;                               // Q
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / nc, c = bc % nc, t0 = c * Q;
  const int tid = threadIdx.x, ti = tid / 8, tp = tid % 8, warp = tid / 32;
  const float* cbc = cb + (size_t)bc * Q * Q;
  const float* pv = prev + ((size_t)bc * H + h) * n * p;
  const double* cum_in = cum_ws + ((size_t)bc * H + h) * Q;
  for (int j = tid; j < Q; j += kThreads) {
    dts[j] = t0 + j < s ? dt[((size_t)b * s + t0 + j) * H + h] : 0.0f;
    cum[j] = cum_in[j];
  }
  __syncthreads();
  const int nslab_n = (n + kSlab - 1) / kSlab;

  for (int i0 = 0; i0 < Q; i0 += kTR)
    for (int p0 = 0; p0 < p; p0 += kTC) {
      const int jend = min(Q, i0 + kTR);
      const int nslab = nslab_n + (jend + kSlab - 1) / kSlab;
      // slab k < nslab_n: C / prev over state rows kSlab k ..; else cb /
      // x over steps kSlab (k - nslab_n) ..; ra (A) and rb (Bm) hold the
      // thread's 16-byte chunks as read (4 f32 or 8 bf16 values each)
      uint4 ra[NA], rb[NB];
      auto fetch = [&](int k) {
        if (k < nslab_n) {
          const int k0 = k * kSlab;
#pragma unroll
          for (int u = 0; u < NA; ++u) {
            const int q = tid + kThreads * u;
            if (q >= kTR * kSlab / V) break;
            const int r = q / (kSlab / V), col = (q % (kSlab / V)) * V;
            const int i = i0 + r, t = t0 + i;
            ra[u] = ld_chunk(i < Q && t < s ? Cm + ((size_t)b * s + t) * n + k0
                                            : (const T*)nullptr,
                             col, n - k0, vecc != 0);
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int q = tid + kThreads * u;
            const int kk = q / (kTC / 4), col = (q % (kTC / 4)) * 4;
            rb[u] = ld_chunk(k0 + kk < n ? pv + (size_t)(k0 + kk) * p + p0
                                         : (const float*)nullptr,
                             col, p - p0, vecq != 0);
          }
        } else {
          const int j0 = (k - nslab_n) * kSlab;
#pragma unroll
          for (int u = 0; u < NA; ++u) {
            const int q = tid + kThreads * u;
            const int r = q / (kSlab / 4), col = (q % (kSlab / 4)) * 4;
            const int i = i0 + r;
            ra[u] = ld_chunk(i < Q ? cbc + (size_t)i * Q + j0
                                   : (const float*)nullptr,
                             col, Q - j0, Q % 4 == 0);
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int q = tid + kThreads * u;
            if (q >= kSlab * kTC / V) break;
            const int jj = q / (kTC / V), col = (q % (kTC / V)) * V;
            const int j = j0 + jj, t = t0 + j;
            rb[u] = ld_chunk(
                j < Q && t < s ? x + (((size_t)b * s + t) * H + h) * p + p0
                               : (const T*)nullptr,
                col, p - p0, vecx != 0);
          }
        }
      };
      auto put4 = [](float* d, const float* v) {
        *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
      };
      auto commit = [&](int k, float* buf) {
        float* bm = buf + kTR * kAS;
        if (k < nslab_n) {
#pragma unroll
          for (int u = 0; u < NA; ++u) {
            const int q = tid + kThreads * u;
            if (q >= kTR * kSlab / V) break;
            const int r = q / (kSlab / V), col = (q % (kSlab / V)) * V;
            float v[V];
            to_f32(ra[u], v);
#pragma unroll
            for (int e = 0; e < V; e += 4) put4(buf + r * kAS + col + e, v + e);
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int q = tid + kThreads * u;
            const int kk = q / (kTC / 4), col = (q % (kTC / 4)) * 4;
            float v[4];
            to_f32(rb[u], v);
            put4(bm + kk * kTC + col, v);
          }
        } else {
          const int j0 = (k - nslab_n) * kSlab;
#pragma unroll
          for (int u = 0; u < NA; ++u) {
            const int q = tid + kThreads * u;
            const int r = q / (kSlab / 4), col = (q % (kSlab / 4)) * 4;
            const int i = i0 + r;
            float v[4];
            to_f32(ra[u], v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // L[i][j] only on and below the diagonal: a select
              const int j = j0 + col + e;
              v[e] = j <= i && i < Q
                         ? __fmul_rn(__fmul_rn(v[e], expf((float)(cum[i] -
                                                                  cum[j]))),
                                     dts[j])
                         : 0.0f;
            }
            put4(buf + r * kAS + col, v);
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int q = tid + kThreads * u;
            if (q >= kSlab * kTC / V) break;
            const int jj = q / (kTC / V), col = (q % (kTC / V)) * V;
            float v[V];
            to_f32(rb[u], v);
#pragma unroll
            for (int e = 0; e < V; e += 4) put4(bm + jj * kTC + col + e, v + e);
          }
        }
      };

      // rows i0 + 8 ti + r, columns p0 + tile_col(tp, e)
      float acc[8][8];
      zero(acc);
      fetch(0);
      for (int k = 0; k < nslab; ++k) {
        float* buf = ring + (k & 1) * kStage;
        commit(k, buf);
        __syncthreads();
        if (k + 1 < nslab) fetch(k + 1);
        if (k == nslab_n) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int i = i0 + 8 * ti + r;
            const float ec = i < Q ? expf((float)cum[i]) : 0.0f;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] = __fmul_rn(ec, acc[r][e]);
          }
        }
        // warp w's rows are i0 + 32 w ..: a diagonal slab wholly above
        // them holds only zeros
        if (k < nslab_n || i0 + 32 * warp + 31 >= (k - nslab_n) * kSlab)
          tile_fma_rows(acc, buf + 8 * ti * kAS, buf + kTR * kAS + 4 * tp);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + 8 * ti + r, t = t0 + i;
        if (i >= Q || t >= s) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pp = p0 + tile_col(tp, e);
          if (pp < p)
            store(y, (((size_t)b * s + t) * H + h) * p + pp, acc[r][e]);
        }
      }
      __syncthreads();  // the ring is refilled by the next tile
    }
}

// raise a kernel's dynamic shared memory limit to what this call needs (a
// host-side attribute, not a stream operation)
template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes, size_t& set) {
  if (bytes <= 48 * 1024 || bytes <= set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set = bytes;
  return err;
}

enum { kPhaseCb = 1, kPhaseState = 2, kPhasePass = 4, kPhaseScan = 8 };

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* h0, T* y, float* hout, float* cb,
           double* cum, float* states, int b, int s, int H, int p, int n,
           int Q, int phases, cudaStream_t stream) {
  const int nc = (s + Q - 1) / Q;
  const int np = n * p;
  if ((np + kPassThreads - 1) / kPassThreads > 65535)
    return (int)cudaErrorInvalidValue;
  // the f64 cum comes first, Q rounded up to even entries, so the float
  // slabs after it stay 16-byte aligned
  const size_t qd = (size_t)cum_len(Q);
  const size_t state_bytes =
      sizeof(double) * qd +
      sizeof(float) * (2 * (size_t)kSlab * (kTR + kTC) + 2 * (size_t)Q);
  const size_t scan_bytes =
      sizeof(double) * qd +
      sizeof(float) * (2 * ((size_t)kTR * kAS + kSlab * kTC) + (size_t)Q);
  // rows of whole 16-byte chunks at 16-byte aligned addresses
  const auto vec = [](const void* base, int row_len, size_t elem) {
    return (int)(reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                 row_len * elem % 16 == 0);
  };
  const int vecx = vec(x, p, sizeof(T)), vecb = vec(Bm, n, sizeof(T)),
            vecc = vec(Cm, n, sizeof(T)), vecq = vec(states, p, 4);
  static size_t state_set = 0, scan_set = 0;
  cudaError_t err;
  if ((err = smem_limit(ssd_chunk_state_kernel<T>, state_bytes, state_set)) !=
          cudaSuccess ||
      (err = smem_limit(ssd_chunk_scan_kernel<T>, scan_bytes, scan_set)) !=
          cudaSuccess)
    return (int)err;
  if (phases & kPhaseCb) {
    ssd_cb_kernel<T><<<b * nc, kCbThreads, 0, stream>>>(Bm, Cm, cb, s, n, Q,
                                                        nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & kPhaseState) {
    ssd_chunk_state_kernel<T><<<b * nc * H, kThreads, state_bytes, stream>>>(
        x, dt, A, Bm, cum, states, s, H, p, n, Q, nc, vecx, vecb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & kPhasePass) {
    dim3 grid(b * H, (np + kPassThreads - 1) / kPassThreads);
    ssd_state_passing_kernel<<<grid, kPassThreads, 0, stream>>>(
        states, cum, h0, hout, H, np, Q, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & kPhaseScan) {
    ssd_chunk_scan_kernel<T><<<b * nc * H, kThreads, scan_bytes, stream>>>(
        x, dt, Cm, cb, cum, states, y, s, H, p, n, Q, nc, vecx, vecc, vecq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// x, y: (b, s, H, p); dt: (b, s, H) f32; A: (H,) f32; B, C: (b, s, n);
// x, B, C, y all float32 (bf16 == 0) or all bfloat16 (bf16 == 1); h0
// (b, H, n, p) f32 or null (zeros); hout (b, H, n, p) f32.  Chunk Q,
// nc = ceil(s / Q) chunks.  Workspaces from the caller: cb (b, nc, Q, Q)
// f32, cum (b, nc, H, Q) f64, states (b, nc, H, n, p) f32.  phases: a mask of
// the four kernels to run (1 cb, 2 chunk state, 4 state passing, 8 chunk
// scan; 15 runs the scan), each reading what the earlier ones wrote into
// the workspaces.
int ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* h0, void* y, float* hout,
             float* cb, double* cum, float* states, int bf16, int b, int s,
             int H, int p, int n, int Q, int phases, cudaStream_t stream) {
  if (b <= 0 || H <= 0) return 0;
  if (s <= 0 || Q <= 0 || p <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), dt, A,
                  static_cast<const __nv_bfloat16*>(Bm),
                  static_cast<const __nv_bfloat16*>(Cm), h0,
                  static_cast<__nv_bfloat16*>(y), hout, cb, cum, states, b, s,
                  H, p, n, Q, phases, stream);
  return launch(static_cast<const float*>(x), dt, A,
                static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                h0, static_cast<float*>(y), hout, cb, cum, states, b, s, H, p,
                n, Q, phases, stream);
}

}  // extern "C"
