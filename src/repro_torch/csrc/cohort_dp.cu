// Round-completion DP over a client cohort for Hopper (sm_90a):
// per-row clip, Gaussian noise, weighted sum.
//
//   out[c] = U[c] * s_c + (noise_scale * mask[c]) * n[c]
//   s_c    = 1 + mask[c] * (min(1, clip / ||U[c]||) - 1)   (clip > 0)
//          = 1                                              (clip <= 0)
//   agg[d] = sum_c weights[c] * out[c, d]
//
// Two entry points share that tile math:
//
// * dp_clip_noise — the standard normals n come in as an operand.
//   Replaces the Pallas _row_sqsum + cohort_clip_noise_kernel of
//   repro/kernels/cohort_dp/kernel.py (tile math _scale_noise).
// * dp_clip_noise_prng — n is generated in registers and never read from
//   device memory.  Replaces cohort_clip_noise_prng_kernel (tile math
//   :71-87), which reseeds the TPU's hardware PRNG per tile; those bits
//   cannot be reproduced off the TPU.  Here each element hashes its own
//   counter: threefry2x32 (20 rounds, jax's schedule) keyed by the tick's
//   noise key (k0, k1), counter = the flat index c * D + d as the
//   (hi, lo) pair, x0 -> b1, x1 -> b2; then Box-Muller exactly as the
//   TPU kernel: u1 = (b1 >> 8) 2^-24 + 2^-25, u2 = (b2 >> 8) 2^-24,
//   n = sqrt(-2 log u1) cos(2 pi u2).  A draw depends only on
//   (key, c, d), so the result does not depend on the launch geometry,
//   two runs give the same bits, and the plain version
//   (kernels/cohort_dp/ref.py) reproduces the stream bit for bit.
//
// Bounds: the operand path is an f32 stream over [C, D] (read U and the
// noise, write out), bound by device-memory bytes.  The PRNG path reads
// U and writes out only, and does ~100 int32 operations of the hash
// plus logf, cosf and a square root per element: against the card's
// int32 rate that work takes about as long as the bytes, so it may be
// bound by operations.  Design: block b owns kRows client rows; its
// warps first reduce each row's squared norm (lane-strided sums, then a
// fixed xor-shuffle tree), then its threads sweep the columns, writing
// out[c] and the partial sums of agg for its rows in ascending c while
// the rows are still in L1/L2.  A second pass adds the block partials in
// ascending b.  No atomics: two runs give the same bits.  Ragged C and D
// are masked in the kernel, never padded.
//
// Rounding: explicit round-to-nearest intrinsics, precise logf/cosf (no
// fast math), built with -fmad=false; out rows with clip <= 0 match the
// operand plain version bitwise, row norms and agg differ from it only
// in their add order, and the generated normals differ from PyTorch's
// log/cos by the libraries' few-ulp error.
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

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds, jax's unrolled schedule (repro_torch/prng.py)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int n = 0; n < 5; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[n & 1][j]) ^ x0;
    }
    x0 += ks[(n + 1) % 3];
    x1 += ks[(n + 2) % 3] + (uint32_t)(n + 1);
  }
}

// standard normal of flat element i: threefry on the (hi, lo) counter,
// Box-Muller on the top 24 bits of each word
__device__ __forceinline__ float counter_normal(uint32_t k0, uint32_t k1,
                                                uint64_t i) {
  uint32_t b1 = (uint32_t)(i >> 32), b2 = (uint32_t)i;
  threefry2x32(k0, k1, b1, b2);
  const float u1 = __fadd_rn(__fmul_rn((float)(b1 >> 8), 0x1p-24f), 0x1p-25f);
  const float u2 = __fmul_rn((float)(b2 >> 8), 0x1p-24f);
  return __fmul_rn(__fsqrt_rn(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(6.2831855f, u2)));
}

// The noise of element i: read from the operand, or generated.
struct OperandNoise {
  const float* noise;
  __device__ float operator()(size_t i) const { return noise[i]; }
};
struct CounterNoise {
  uint32_t k0, k1;
  __device__ float operator()(size_t i) const {
    return counter_normal(k0, k1, (uint64_t)i);
  }
};

template <typename Noise>
__global__ void clip_noise_rows_kernel(const float* __restrict__ u,
                                       Noise noise,
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
        o = __fadd_rn(o, __fmul_rn(__fmul_rn(noise_scale, mask[r]), noise(i)));
      out[i] = o;
      // the sum starts from its first term: an all -0.0 column stays -0.0
      const float term = __fmul_rn(o, wgt[r]);
      acc = r == r0 ? term : __fadd_rn(acc, term);
    }
    partial[(size_t)blockIdx.x * D + d] = acc;
  }
}

// The counter stream itself, for checking it against the plain version:
// words0[i], words1[i] = threefry2x32((k0, k1), (i >> 32, i & 0xffffffff)).
__global__ void prng_words_kernel(uint32_t k0, uint32_t k1, long long n,
                                  uint32_t* __restrict__ words0,
                                  uint32_t* __restrict__ words1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = (uint32_t)((uint64_t)i >> 32), x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  words0[i] = x0;
  words1[i] = x1;
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

int blocks_of(int C) { return (C + kRows - 1) / kRows; }

template <typename Noise>
int launch_clip_noise(const float* u, Noise noise, const float* mask,
                      const float* wgt, float* out, float* agg,
                      float* partial, int C, int D, float clip,
                      float noise_scale, cudaStream_t stream) {
  const int nblk = blocks_of(C);
  if (nblk > 0 && D > 0) {
    clip_noise_rows_kernel<Noise><<<nblk, kThreads, 0, stream>>>(
        u, noise, mask, wgt, out, partial, C, D, clip, noise_scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (D == 0) return 0;
  clip_noise_agg_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, agg, nblk, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dp_blocks(int C) { return blocks_of(C); }

int dp_clip_noise(const float* u, const float* noise, const float* mask,
                  const float* wgt, float* out, float* agg, float* partial,
                  int C, int D, float clip, float noise_scale,
                  cudaStream_t stream) {
  return launch_clip_noise(u, OperandNoise{noise}, mask, wgt, out, agg,
                           partial, C, D, clip, noise_scale, stream);
}

int dp_clip_noise_prng(const float* u, uint32_t k0, uint32_t k1,
                       const float* mask, const float* wgt, float* out,
                       float* agg, float* partial, int C, int D, float clip,
                       float noise_scale, cudaStream_t stream) {
  return launch_clip_noise(u, CounterNoise{k0, k1}, mask, wgt, out, agg,
                           partial, C, D, clip, noise_scale, stream);
}

int dp_prng_words(uint32_t k0, uint32_t k1, long long n, uint32_t* words0,
                  uint32_t* words1, cudaStream_t stream) {
  if (n <= 0) return 0;
  prng_words_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(k0, k1, n, words0, words1);
  return (int)cudaGetLastError();
}

}  // extern "C"
