// Round-completion DP over a client cohort for Hopper (sm_90a):
// per-row clip, Gaussian noise added from an operand, weighted sum.
//
//   out[c] = U[c] * s_c + (noise_scale * mask[c]) * noise[c]
//   s_c    = 1 + mask[c] * (min(1, clip / ||U[c]||) - 1)   (clip > 0)
//          = 1                                              (clip <= 0)
//   agg[d] = sum_c weights[c] * out[c, d]
//
// Replaces the Pallas kernels of repro/kernels/cohort_dp/kernel.py
// (_row_sqsum + cohort_clip_noise_kernel, tile math _scale_noise).  The
// work is an f32 stream over [C, D] (read U and noise, write out), so it
// is bound by device-memory bytes.  Design: block b owns kRows client
// rows; its warps first reduce each row's squared norm (lane-strided
// sums, then a fixed xor-shuffle tree), then its threads sweep the
// columns, writing out[c] and the partial sums of agg for its rows in
// ascending c while the rows are still in L1/L2.  A second pass adds the
// block partials in ascending b.  No atomics: two runs give the same
// bits.  Ragged C and D are masked in the kernel, never padded.
//
// Rounding: explicit round-to-nearest intrinsics, built with
// -fmad=false; out rows with clip <= 0 match the plain version bitwise,
// row norms and agg differ from it only in their add order.
//
// Each extern "C" entry point launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// client rows per block (fixed: it sets the add order of agg)
constexpr int kRows = 64;

__global__ void clip_noise_rows_kernel(const float* __restrict__ u,
                                       const float* __restrict__ noise,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ wgt,
                                       float* __restrict__ out,
                                       float* __restrict__ partial, int C,
                                       int D, float clip, float noise_scale) {
  __shared__ float scale_s[kRows];
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, C);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    float s = 1.0f;
    if (clip > 0.0f) {
      const float* row = u + (size_t)r * D;
      float sq = 0.0f;
      for (int d = lane; d < D; d += 32) sq = __fadd_rn(sq, __fmul_rn(row[d], row[d]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
      s = __fdiv_rn(1.0f, fmaxf(1.0f, __fdiv_rn(__fsqrt_rn(sq), clip)));
    }
    if (lane == 0)
      scale_s[r - r0] = __fadd_rn(1.0f, __fmul_rn(mask[r], __fsub_rn(s, 1.0f)));
  }
  __syncthreads();
  if (r1 <= r0) return;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const size_t i = (size_t)r * D + d;
      float o = __fmul_rn(u[i], scale_s[r - r0]);
      if (noise_scale > 0.0f)
        o = __fadd_rn(o, __fmul_rn(__fmul_rn(noise_scale, mask[r]), noise[i]));
      out[i] = o;
      // the sum starts from its first term: an all -0.0 column stays -0.0
      const float term = __fmul_rn(o, wgt[r]);
      acc = r == r0 ? term : __fadd_rn(acc, term);
    }
    partial[(size_t)blockIdx.x * D + d] = acc;
  }
}

__global__ void clip_noise_agg_kernel(const float* __restrict__ partial,
                                      float* __restrict__ agg, int nblk,
                                      int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float a = nblk > 0 ? partial[d] : 0.0f;
  for (int b = 1; b < nblk; ++b) a = __fadd_rn(a, partial[(size_t)b * D + d]);
  agg[d] = a;
}

}  // namespace

extern "C" {

int dp_blocks(int C) { return (C + kRows - 1) / kRows; }

int dp_clip_noise(const float* u, const float* noise, const float* mask,
                  const float* wgt, float* out, float* agg, float* partial,
                  int C, int D, float clip, float noise_scale,
                  cudaStream_t stream) {
  const int nblk = dp_blocks(C);
  if (nblk > 0 && D > 0) {
    clip_noise_rows_kernel<<<nblk, kThreads, 0, stream>>>(
        u, noise, mask, wgt, out, partial, C, D, clip, noise_scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (D == 0) return 0;
  clip_noise_agg_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, agg, nblk, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
