// Per-example clip and accumulate for DP-SGD on Hopper (sm_90a):
//
//   out[d] = sum_n G[n, d] * s_n,   s_n = 1 / max(1, ||G[n]|| / clip)
//
// over per-example gradients G (N, D), f32 or bf16, out f32.  Replaces
// the Pallas clip_accumulate_kernel of repro/kernels/dp_clip/kernel.py
// (_sqsum_kernel: per-example squared sums carried across the TPU's
// sequential grid; _scale_sum_kernel: scale rows, sum over examples).
//
// Bound: one stream over G (read once, D f32 written): device-memory
// bytes.  Design (the structure of cohort_dp.cu): block b owns kRows
// example rows; its warps first reduce each row's squared norm
// (lane-strided sums, then a fixed xor-shuffle tree), then its threads
// sweep the columns and write the block's partial column sums over its
// rows in ascending n while the rows are still in L1/L2.  A second pass
// adds the block partials in ascending b.  No atomics: two runs give the
// same bits.  Ragged N and D are masked, never padded.
//
// Rounding: explicit round-to-nearest intrinsics, built with -fmad=false;
// the result differs from the plain version (kernels/dp_clip/ref.py) only
// in the add order of the row norms and the column sums.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// example rows per block (fixed: it sets the add order of the sums)
constexpr int kRows = 64;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void clip_rows_kernel(const T* __restrict__ g,
                                 float* __restrict__ partial, int N, int D,
                                 float clip) {
  __shared__ float scale_s[kRows];
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, N);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const size_t row = (size_t)r * D;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = load(g, row + d);
      sq = __fadd_rn(sq, __fmul_rn(v, v));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    if (lane == 0)
      scale_s[r - r0] =
          __fdiv_rn(1.0f, fmaxf(1.0f, __fdiv_rn(__fsqrt_rn(sq), clip)));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int r = r0; r < r1; ++r) {
      // the sum starts from its first term: an all -0.0 column stays -0.0
      const float term = __fmul_rn(load(g, (size_t)r * D + d), scale_s[r - r0]);
      acc = r == r0 ? term : __fadd_rn(acc, term);
    }
    partial[(size_t)blockIdx.x * D + d] = acc;
  }
}

__global__ void clip_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int nblk, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float a = nblk > 0 ? partial[d] : 0.0f;
#pragma unroll 8
  for (int b = 1; b < nblk; ++b) a = __fadd_rn(a, partial[(size_t)b * D + d]);
  out[d] = a;
}

int blocks_of(int N) { return (N + kRows - 1) / kRows; }

template <typename T>
int launch(const T* g, float* out, float* partial, int N, int D, float clip,
           cudaStream_t stream) {
  if (D <= 0) return 0;
  const int nblk = blocks_of(N);
  if (nblk > 0) {
    clip_rows_kernel<T><<<nblk, kThreads, 0, stream>>>(g, partial, N, D, clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  clip_sum_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, out, nblk, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dc_blocks(int N) { return blocks_of(N); }

// g: (N, D) row-major, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// out: (D,) f32; partial: (dc_blocks(N), D) f32 scratch.
int dc_clip_accumulate(const void* g, int bf16, float* out, float* partial,
                       int N, int D, float clip, cudaStream_t stream) {
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(g), out, partial, N, D,
                  clip, stream);
  return launch(static_cast<const float*>(g), out, partial, N, D, clip,
                stream);
}

}  // extern "C"
