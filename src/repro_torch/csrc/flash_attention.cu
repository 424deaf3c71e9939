// Online-softmax ("flash") attention for Hopper (sm_90a):
//
//   o[b, i, h] = sum_j softmax_j(mask(cap(q[b, i, h] . k[b, j, g] / sqrt(hd))))
//                * v[b, j, g],                 g = h / (H / KV)   (GQA)
//
// with cap(s) = softcap * tanh(s / softcap) (when softcap > 0) and the
// causal mask j <= i and sliding window i - j < window (when set).  q
// (B, S, H, hd), k/v (B, S, KV, hd), f32 or bf16; f32 accumulation;
// output in q's dtype.  Replaces the Pallas flash_attention of
// repro/kernels/flash_attention/kernel.py (_fa_kernel).
//
// Bound: at the widths it serves (gemma2: hd = 256, S = 8192) the
// product work (2 * 2 * S * S_visited * hd per head) outweighs the bytes
// (q, k, v read once, o written once) by ~70x: operations.  This first
// kernel runs them on the f32 pipes (no tensor cores yet).  Design: one
// block per (b, h, q tile of kBQ rows); the tile, pre-scaled by
// 1/sqrt(hd) as the TPU kernel does, stays in shared memory while K/V
// tiles of kBK rows stream through shared memory; each thread holds a
// 4 x 4 patch of the score tile and a 4 x hd/16 patch of the output
// accumulator in registers, and the running (max, sum) per row live in
// shared memory.  kv tiles entirely beyond the causal frontier or older
// than the window are skipped (the TPU kernel's bounds, C division
// truncating as jax.lax.div).  Ragged S and hd are masked, never padded:
// keys j >= S score the mask value, so they carry no weight.
//
// The mask value is the finite -1e30 of the TPU kernel, not -inf: a row
// whose first visited tile is fully masked computes exp(m - m_new) with
// m = m_new, i.e. exp(0), where -inf would give NaN; the next tile with a
// valid key has alpha = exp(-1e30 - m) = 0 and wipes that row's sums.
//
// Rounding: the dot products use explicit fused multiply-adds; softcap
// uses the precise tanhf, exponentials the precise expf (no fast math,
// built with -fmad=false).  The result differs from the plain version
// (kernels/flash_attention/ref.py) in the scaling order (q is scaled,
// not the scores) and the add order of the sums.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -1e30f;
constexpr int kPS = kBK + 4;   // score tile row stride (16-byte aligned)
// the thread layout covers 64 x 64 score tiles: 16 x 16 threads, 4 x 4 each
static_assert(kBQ == 64 && kBK == 64 && kThreads == 256, "tile layout");

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// rows x hdp tile of x[b, r0 + r, head, :] into s (row stride ld), scaled,
// zero beyond S and hd
template <typename T>
__device__ void load_tile(float* s, int ld, int rows, const T* __restrict__ x,
                          int b, int r0, int head, int S, int nh, int hd,
                          int hdp, float scale) {
  for (int e = threadIdx.x; e < rows * hdp; e += kThreads) {
    const int r = e / hdp, d = e % hdp;
    const int row = r0 + r;
    float v = 0.0f;
    if (row < S && d < hd)
      v = load(x, (((size_t)b * S + row) * nh + head) * hd + d);
    s[r * ld + d] = scale == 1.0f ? v : __fmul_rn(v, scale);
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, int hd, float scale, int causal,
                       int window, float softcap) {
  constexpr int QS = HDP + 4;          // q / k tile row stride
  constexpr int NC = HDP / 64;         // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * HDP;
  float* m_s = Ps + kBQ * kPS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(Qs, QS, kBQ, q, b, q0, h, S, H, hd, HDP, scale);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    m_s[r] = kMaskValue;
    l_s[r] = 0.0f;
  }
  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // live kv tiles [lo, hi): the TPU kernel's bounds (kernel.py:47-55)
  const int nkv = (S + kBK - 1) / kBK;
  int hi = causal ? (q0 + kBQ - 1) / kBK + 1 : nkv;
  if (hi > nkv) hi = nkv;
  int lo = 0;
  if (window > 0) {
    lo = (q0 - window - kBK + 1) / kBK;  // truncates toward zero
    if (lo < 0) lo = 0;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, QS, kBK, k, b, k0, g, S, KV, hd, HDP, 1.0f);
    load_tile(Vs, HDP, kBK, v, b, k0, g, S, KV, hd, HDP, 1.0f);
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = __fmaf_rn(qv[i].x, kv[j].x, a);
          a = __fmaf_rn(qv[i].y, kv[j].y, a);
          a = __fmaf_rn(qv[i].z, kv[j].z, a);
          a = __fmaf_rn(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.0f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
        const bool ok = col < S && (!causal || col <= row) &&
                        (window <= 0 || row - col < window);
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = ok ? x : kMaskValue;
      }
    __syncthreads();

    // online softmax: warp w owns rows w * 8 .. w * 8 + 7
    for (int rr = 0; rr < kBQ / kWarps; ++rr) {
      const int r = warp * (kBQ / kWarps) + rr;
      float* pr = Ps + r * kPS;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(__fsub_rn(x0, m_new));
      const float p1 = expf(__fsub_rn(x1, m_new));
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = __fadd_rn(p0, p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        a_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(alpha, l_s[r]), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns 4 tx + 64 j + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fmul_rn(acc[i][j][e], alpha);
    }
    for (int c = 0; c < kBK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kPS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * HDP + 4 * tx + 64 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z : p[i].w;
            acc[i][j][0] = __fmaf_rn(pc, vv.x, acc[i][j][0]);
            acc[i][j][1] = __fmaf_rn(pc, vv.y, acc[i][j][1]);
            acc[i][j][2] = __fmaf_rn(pc, vv.z, acc[i][j][2]);
            acc[i][j][3] = __fmaf_rn(pc, vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * j + e;
        if (d < hd)
          store(o, (((size_t)b * S + row) * H + h) * hd + d,
                __fdiv_rn(acc[i][j][e], l));
      }
  }
}

template <int HDP>
size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * (HDP + 4) + (size_t)kBK * HDP +
          (size_t)kBQ * kPS + 3 * kBQ);
}

template <typename T, int HDP>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
           int KV, int hd, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<HDP>();
  // set once, outside any graph capture (the first call is never captured)
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HDP><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, S, H, KV, hd, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
             int KV, int hd, float scale, int causal, int window,
             float softcap, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                         softcap, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                          softcap, stream);
  return launch<T, 256>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                        softcap, stream);
}

}  // namespace

extern "C" {

int fa_max_head_dim() { return 256; }

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); all float32 (bf16 == 0) or
// all bfloat16 (bf16 == 1), contiguous.  window <= 0: no window;
// softcap <= 0: no cap.  Needs 1 <= hd <= 256 and H % KV == 0.
int fa_attention(const void* q, const void* k, const void* v, void* o,
                 int bf16, int B, int S, int H, int KV, int hd, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (hd < 1 || hd > 256 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v),
                    static_cast<__nv_bfloat16*>(o), B, S, H, KV, hd, scale,
                    causal, window, softcap, stream);
  return dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o), B, S,
                  H, KV, hd, scale, causal, window, softcap, stream);
}

}  // extern "C"
