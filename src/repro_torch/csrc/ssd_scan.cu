// Mamba-2 SSD chunked scan for Hopper (sm_90a).  Per (batch b, head h),
// over chunks of Q steps walked in order, with the (N, P) state carried:
//
//   dA_cum[i] = sum_{j <= i} dt[j] * A[h]                (within the chunk)
//   y[i]      = sum_{j <= i} (C[i] . B[j]) exp(dA_cum[i] - dA_cum[j]) dt[j] x[j]
//             + exp(dA_cum[i]) C[i] H                     (H: previous state)
//   H        <- H exp(dA_cum[Q-1]) + sum_j exp(dA_cum[Q-1] - dA_cum[j]) dt[j] B[j]^T x[j]
//
// x (b, s, h, p), dt (b, s, h) f32, A (h,) f32, B/C (b, s, n) (single
// group); x, B, C f32 or bf16; y in x's dtype, final state (b, h, n, p)
// f32.  Replaces the Pallas ssd_scan_kernel of
// repro/kernels/ssd_scan/kernel.py (_ssd_kernel), whose state lives in a
// VMEM scratch across the TPU's sequential chunk axis and is never
// written out; here the final state is written too, so
// ssd_chunked(..., return the final state) runs on the kernel as well.
//
// Bound: at mamba2-780m's widths (n = 128, p = 64, Q = 128) a chunk does
// ~Q^2 n / 2 + Q^2 p / 2 + 2 Q n p multiply-adds against Q (p + 2 n) + Q
// inputs read: operations, ~0.1 of the bytes' time.  Design: one block
// per (b, h) walks the chunks in order (the sequential grid axis becomes
// a loop); the chunk's B, C and x and the state H stay in shared memory
// (~200 KB at those widths, 1 block per SM).  Per chunk: a warp scan
// gives dA_cum; the scores (C B^T o L) dt are built kRB rows at a time,
// L as a select j <= i ? exp(seg) : 0 (never mask * exp(seg): above the
// diagonal seg > 0 can overflow to inf, and inf * 0 is NaN); each thread
// accumulates its column of p for kPer output rows at a time in
// registers, and likewise for kPer state rows in the state update.
// Ragged s is masked (dt = 0, x = B = C = 0 past the end, the
// reference's padding), never padded in memory.
//
// Rounding: explicit fused multiply-adds in the products, precise expf,
// built with -fmad=false; the result differs from the plain version
// (repro_torch.models.ssm.ssd_chunked) in the add order of its sums.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 32;        // score rows built at a time
constexpr int kPer = 8;        // register accumulators per thread and pass

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

struct Layout {
  int NS;  // row stride of the B / C tiles: n rounded up to 4, plus 4
  size_t bs, cs, xs, hs, ss, cum, ecum, wv, dts, total;  // float offsets
};

__host__ __device__ inline Layout layout(int Q, int n, int p) {
  Layout L;
  L.NS = ((n + 3) / 4) * 4 + 4;
  L.bs = 0;
  L.cs = L.bs + (size_t)Q * L.NS;
  L.xs = L.cs + (size_t)Q * L.NS;
  L.hs = L.xs + (size_t)Q * p;
  L.ss = L.hs + (size_t)n * p;
  L.cum = L.ss + (size_t)kRB * Q;
  L.ecum = L.cum + Q;
  L.wv = L.ecum + Q;
  L.dts = L.wv + Q;
  L.total = L.dts + Q;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hout, int s, int H,
                int p, int n, int Q) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L = layout(Q, n, p);
  float* Bs = sm + L.bs;
  float* Cs = sm + L.cs;
  float* Xs = sm + L.xs;
  float* Hs = sm + L.hs;
  float* Ss = sm + L.ss;
  float* cum = sm + L.cum;
  float* ecum = sm + L.ecum;
  float* wv = sm + L.wv;
  float* dts = sm + L.dts;
  const int NS = L.NS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float a = A[h];
  const size_t hbase = ((size_t)b * H + h) * n * p;
  for (int e = tid; e < n * p; e += kThreads)
    Hs[e] = h0 ? h0[hbase + e] : 0.0f;

  // fixed column per thread: p divides kThreads (checked by the host)
  const int pp = tid % p;
  const int rstep = kThreads / p;  // rows a pass over the threads covers
  const int r0 = tid / p;

  const int nc = (s + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < Q * NS; e += kThreads) {
      const int j = e / NS, nn = e % NS;
      const bool ok = t0 + j < s && nn < n;
      const size_t g = ((size_t)b * s + t0 + j) * n + nn;
      Bs[e] = ok ? load(Bm, g) : 0.0f;
      Cs[e] = ok ? load(Cm, g) : 0.0f;
    }
    for (int e = tid; e < Q * p; e += kThreads) {
      const int j = e / p, q = e % p;
      Xs[e] = t0 + j < s ? load(x, (((size_t)b * s + t0 + j) * H + h) * p + q)
                         : 0.0f;
    }
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = t0 + j < s ? dt[((size_t)b * s + t0 + j) * H + h] : 0.0f;
    __syncthreads();

    // dA_cum: inclusive scan of dt * A by warp 0, 32 steps at a time
    if (warp == 0) {
      float carry = 0.0f;
      for (int j0 = 0; j0 < Q; j0 += 32) {
        const int j = j0 + lane;
        float v = j < Q ? __fmul_rn(dts[j], a) : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v = __fadd_rn(v, u);
        }
        v = __fadd_rn(v, carry);
        if (j < Q) cum[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      ecum[j] = expf(cum[j]);
      wv[j] = __fmul_rn(expf(__fsub_rn(cum_last, cum[j])), dts[j]);
    }
    __syncthreads();

    // outputs, kRB rows at a time: scores, then y = S x + exp(cum) C H
    for (int i0 = 0; i0 < Q; i0 += kRB) {
      const int rows = min(kRB, Q - i0);
      for (int e = tid; e < rows * Q; e += kThreads) {
        const int il = e / Q, j = e % Q, i = i0 + il;
        float sc = 0.0f;
        if (j <= i) {
          const float* ci = Cs + (size_t)i * NS;
          const float* bj = Bs + (size_t)j * NS;
          float dot = 0.0f;
          for (int nn = 0; nn < n; nn += 4) {
            const float4 cv = *reinterpret_cast<const float4*>(ci + nn);
            const float4 bv = *reinterpret_cast<const float4*>(bj + nn);
            dot = __fmaf_rn(cv.x, bv.x, dot);
            dot = __fmaf_rn(cv.y, bv.y, dot);
            dot = __fmaf_rn(cv.z, bv.z, dot);
            dot = __fmaf_rn(cv.w, bv.w, dot);
          }
          // L[i, j] = exp(dA_cum[i] - dA_cum[j]) only on and below the
          // diagonal: a select, not a product with a mask
          sc = __fmul_rn(__fmul_rn(dot, expf(__fsub_rn(cum[i], cum[j]))),
                         dts[j]);
        }
        Ss[il * Q + j] = sc;
      }
      __syncthreads();
      // this thread: column pp of rows il = r0 + m * rstep < rows, kPer
      // rows per pass
      const int jmax = i0 + rows;  // the columns j <= i of these rows
      for (int m0 = 0; r0 + m0 * rstep < rows; m0 += kPer) {
        float yd[kPer], yo[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) yd[k] = yo[k] = 0.0f;
        for (int j = 0; j < jmax; ++j) {
          const float xv = Xs[j * p + pp];
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int il = r0 + (m0 + k) * rstep;
            if (il < rows) yd[k] = __fmaf_rn(Ss[il * Q + j], xv, yd[k]);
          }
        }
        for (int nn = 0; nn < n; ++nn) {
          const float hv = Hs[nn * p + pp];
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int il = r0 + (m0 + k) * rstep;
            if (il < rows)
              yo[k] = __fmaf_rn(Cs[(i0 + il) * NS + nn], hv, yo[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int il = r0 + (m0 + k) * rstep, i = i0 + il;
          if (il < rows && t0 + i < s)
            store(y, (((size_t)b * s + t0 + i) * H + h) * p + pp,
                  __fadd_rn(yd[k], __fmul_rn(ecum[i], yo[k])));
        }
      }
      __syncthreads();  // Ss is rebuilt next, Hs updated below
    }

    // state: H[nn, pp] = H exp(cum_last) + sum_j (wv[j] B[j, nn]) x[j, pp]
    // for this thread's column pp, rows nn = r0 + m * rstep < n
    const float decay = expf(cum_last);
    for (int m0 = 0; r0 + m0 * rstep < n; m0 += kPer) {
      float acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        const float xv = Xs[j * p + pp];
        const float w = wv[j];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int nn = r0 + (m0 + k) * rstep;
          if (nn < n)
            acc[k] = __fmaf_rn(__fmul_rn(w, Bs[j * NS + nn]), xv, acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int nn = r0 + (m0 + k) * rstep;
        if (nn < n) Hs[nn * p + pp] = __fmaf_rn(Hs[nn * p + pp], decay, acc[k]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < n * p; e += kThreads) hout[hbase + e] = Hs[e];
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* Bm,
           const T* Cm, const float* h0, T* y, float* hout, int b, int s,
           int H, int p, int n, int Q, cudaStream_t stream) {
  const size_t bytes = layout(Q, n, p).total * sizeof(float);
  // raise the dynamic shared memory limit to what this call needs (a
  // host-side attribute, not a stream operation)
  static size_t attr_bytes = 0;
  if (bytes > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = bytes;
  }
  dim3 grid(H, b);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      x, dt, A, Bm, Cm, h0, y, hout, s, H, p, n, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The threads of a block: p must divide it (the host checks).
int ssd_threads() { return kThreads; }

// x, y: (b, s, H, p); dt: (b, s, H) f32; A: (H,) f32; B, C: (b, s, n);
// x, B, C, y all float32 (bf16 == 0) or all bfloat16 (bf16 == 1); h0
// (b, H, n, p) f32 or null (zeros); hout (b, H, n, p) f32.  Chunk Q.
int ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* h0, void* y, float* hout, int bf16,
             int b, int s, int H, int p, int n, int Q, cudaStream_t stream) {
  if (b <= 0 || H <= 0) return 0;
  if (s <= 0 || Q <= 0 || p <= 0 || n <= 0 || kThreads % p != 0)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), dt, A,
                  static_cast<const __nv_bfloat16*>(Bm),
                  static_cast<const __nv_bfloat16*>(Cm), h0,
                  static_cast<__nv_bfloat16*>(y), hout, b, s, H, p, n, Q,
                  stream);
  return launch(static_cast<const float*>(x), dt, A,
                static_cast<const float*>(Bm), static_cast<const float*>(Cm),
                h0, static_cast<float*>(y), hout, b, s, H, p, n, Q, stream);
}

}  // extern "C"
