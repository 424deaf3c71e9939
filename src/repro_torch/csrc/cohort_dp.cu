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
//   (hi, lo) pair (c the global row: a rank holding rows from row_lo
//   passes start = row_lo * D), x0 -> b1, x1 -> b2; then Box-Muller as the
//   TPU kernel: u1 = (b1 >> 8) 2^-24 + 2^-25, u2 = (b2 >> 8) 2^-24,
//   n = sqrt(-2 log u1) cos(2 pi u2).  A draw depends only on
//   (key, c, d), so the result does not depend on the launch geometry,
//   two runs give the same bits, and the plain version
//   (kernels/cohort_dp/ref.py) reproduces the stream bit for bit.
//
// Bounds: the operand path is an f32 stream over [C, D] (read U and the
// noise, write out), bound by device-memory bytes.  The PRNG path reads
// U and writes out, and hashes only where the noise term can change the
// output: ~120 int32 operations of threefry plus logf, cosf and a square
// root per element of a masked row.  With half the rows masked the
// bytes bound it, with every row masked the int32 operations; on a tick
// where few clients finish a round it is nearly a copy.
//
// Design (one launch of each step on the caller's stream):
// 1. Row scales (clip > 0 only): one warp per row with mask[c] != 0
//    sums the row's squares (lane-strided, then a fixed xor-shuffle
//    tree) into s_c; a row with mask[c] == 0 gets exactly 1.0f without
//    reading U, the bits of 1 + 0 * (s - 1) since s is always finite
//    (fmaxf below keeps it in [0, 1]).  With clip <= 0 there is no
//    step: the scale is 1 + mask * 0, computed in place.
// 2. The elementwise pass over the flat index i in [0, C * D): each
//    thread takes kElts consecutive elements (16-byte loads and stores
//    where the pointers allow), steps their row and column from one
//    divide, and hashes their kElts counters as independent chains, so
//    that many hashes are in flight per SM.  A grid of one group per
//    thread fills every SM; blocks that find pass-through rows end early
//    and the scheduler refills the SM.  The ragged end of C * D is
//    masked, never padded.
//    Pass-through elements skip the hash.  Where the row's noise factor
//    noise_scale * mask[c] is 0, the noise term is (+-0) * n = +-0 for a
//    finite n, and o + (+-0) == o bit for bit unless o is -0.0, where
//    the sign of 0 * n decides.  So such elements write o (for a
//    pass-through row, u itself) and only an element whose o has the
//    bits 0x80000000 still hashes.  This holds for the generated noise
//    alone (u1 >= 2^-25, so n is finite); the operand noise is read for
//    every element, since 0 * inf is NaN.
// 3. agg, only when the caller asks for it: block b sums rows
//    [64 b, 64 b + 64) of out into partial[b] in ascending c, then a
//    finish pass adds the partials in ascending b.  No atomics: two
//    runs give the same bits, and the sums match the row-block order of
//    the kernel this one replaced.
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
// client rows per agg partial (fixed: it sets the add order of agg)
constexpr int kRows = 64;
// consecutive elements per thread in the elementwise pass
constexpr int kElts = 4;     // a multiple of 4

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

// kElts consecutive elements from i0 (cnt of them at the ragged end);
// vec: 16-byte accesses (the pointer is 16-byte aligned)
__device__ __forceinline__ void load_elts(const float* __restrict__ p,
                                          size_t i0, int cnt, bool vec,
                                          float* v) {
  if (vec && cnt == kElts) {
#pragma unroll
    for (int q = 0; q < kElts; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i0 + q);
      v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
    }
  } else {
    for (int j = 0; j < cnt; ++j) v[j] = p[i0 + j];
  }
}

__device__ __forceinline__ void store_elts(float* __restrict__ p, size_t i0,
                                           int cnt, bool vec, const float* v) {
  if (vec && cnt == kElts) {
#pragma unroll
    for (int q = 0; q < kElts; q += 4)
      *reinterpret_cast<float4*>(p + i0 + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
    for (int j = 0; j < cnt; ++j) p[i0 + j] = v[j];
  }
}

// The noise of elements i0 .. i0 + cnt - 1: read from the operand, or
// generated.  kSkipZero: a zero noise factor may skip the noise (it is
// finite, so 0 * n is a signed zero).
struct OperandNoise {
  static constexpr bool kSkipZero = false;
  const float* noise;
  __device__ void fill(size_t i0, int cnt, bool vec, float* nz) const {
    load_elts(noise, i0, cnt, vec, nz);
  }
};
struct CounterNoise {
  static constexpr bool kSkipZero = true;
  uint32_t k0, k1;
  // the counter of element 0: the flat index of this block's first row
  // in the whole [C, D] draw (row offset * D)
  uint64_t start;
  // all kElts hashes, independent chains (past the end: unused)
  __device__ void fill(size_t i0, int, bool, float* nz) const {
#pragma unroll
    for (int j = 0; j < kElts; ++j)
      nz[j] = counter_normal(k0, k1, start + (uint64_t)(i0 + j));
  }
};

// Step 1: s_c of each row with mask[c] != 0, exactly 1.0f elsewhere.
__global__ void __launch_bounds__(kThreads)
    row_scale_kernel(const float* __restrict__ u,
                     const float* __restrict__ mask,
                     float* __restrict__ scale, int C, int D, float clip) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= C) return;
  const float m = mask[r];
  if (m == 0.0f) {              // warp-uniform: the whole warp leaves
    if (lane == 0) scale[r] = 1.0f;
    return;
  }
  const float* row = u + (size_t)r * D;
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) sq = __fadd_rn(sq, __fmul_rn(row[d], row[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  const float s = __fdiv_rn(1.0f, fmaxf(1.0f, __fdiv_rn(__fsqrt_rn(sq), clip)));
  if (lane == 0) scale[r] = __fadd_rn(1.0f, __fmul_rn(m, __fsub_rn(s, 1.0f)));
}

// Step 2: out[i] = u[i] * s_c + (noise_scale * mask[c]) * n(i), c = i / D.
// scale == nullptr: clip <= 0, s_c = 1 + mask[c] * 0.  kNarrow: C * D
// fits 32 bits, and c = i / D is a 32-bit divide (a 64-bit divide is a
// long software routine, slow enough to hold the whole pass back).
template <typename Noise, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
    clip_noise_elts_kernel(const float* __restrict__ u, Noise noise,
                           const float* __restrict__ mask,
                           const float* __restrict__ scale,
                           float* __restrict__ out, long long n, int D,
                           float noise_scale, bool vec) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kElts;
  if (i0 >= n) return;
  const int cnt = (int)min((long long)kElts, n - i0);
  float o[kElts], nsm[kElts];
  load_elts(u, (size_t)i0, cnt, vec, o);
  const bool noise_on = noise_scale > 0.0f;
  int r = kNarrow ? (int)((unsigned)i0 / (unsigned)D) : (int)(i0 / D);
  int col = (int)(i0 - (long long)r * D);
  bool hash = false;
#pragma unroll
  for (int j = 0; j < kElts; ++j) {
    if (j < cnt) {
      const float m = mask[r];
      const float s = scale ? scale[r] : __fadd_rn(1.0f, __fmul_rn(m, 0.0f));
      o[j] = __fmul_rn(o[j], s);
      nsm[j] = __fmul_rn(noise_scale, m);
      hash |= nsm[j] != 0.0f || __float_as_uint(o[j]) == 0x80000000u;
    }
    if (++col == D) {
      col = 0;
      ++r;
    }
  }
  if (noise_on && (hash || !Noise::kSkipZero)) {
    float nz[kElts];
    noise.fill((size_t)i0, cnt, vec, nz);
#pragma unroll
    for (int j = 0; j < kElts; ++j) {
      if (j < cnt && (!Noise::kSkipZero || nsm[j] != 0.0f ||
                      __float_as_uint(o[j]) == 0x80000000u))
        o[j] = __fadd_rn(o[j], __fmul_rn(nsm[j], nz[j]));
    }
  }
  store_elts(out, (size_t)i0, cnt, vec, o);
}

// Step 3a: partial[b, d] = sum of weights[c] * out[c, d] over the rows c
// of block b (blockIdx.x), in ascending c.
__global__ void __launch_bounds__(kThreads)
    agg_partial_kernel(const float* __restrict__ out,
                       const float* __restrict__ wgt,
                       float* __restrict__ partial, int C, int D) {
  const int d = blockIdx.y * kThreads + threadIdx.x;
  if (d >= D) return;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, C);
  // the sum starts from its first term: an all -0.0 column stays -0.0
  float acc = __fmul_rn(out[(size_t)r0 * D + d], wgt[r0]);
#pragma unroll 8
  for (int r = r0 + 1; r < r1; ++r)
    acc = __fadd_rn(acc, __fmul_rn(out[(size_t)r * D + d], wgt[r]));
  partial[(size_t)blockIdx.x * D + d] = acc;
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

// scale: scratch [C] when clip > 0; agg == nullptr: no agg (partial is
// then unused)
template <typename Noise>
int launch_clip_noise(const float* u, Noise noise, const void* operand,
                      const float* mask, const float* wgt, float* out,
                      float* agg, float* partial, float* scale, int C, int D,
                      float clip, float noise_scale, cudaStream_t stream) {
  const long long n = (long long)C * D;
  if (n > 0) {
    if (clip > 0.0f) {
      row_scale_kernel<<<(C + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          u, mask, scale, C, D, clip);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const bool vec = (((uintptr_t)u | (uintptr_t)out | (uintptr_t)operand) &
                      15) == 0;
    const long long groups = (n + kElts - 1) / kElts;
    const unsigned grid = (unsigned)((groups + kThreads - 1) / kThreads);
    const float* sc = clip > 0.0f ? scale : nullptr;
    if (n <= 0xffffffffLL)
      clip_noise_elts_kernel<Noise, true><<<grid, kThreads, 0, stream>>>(
          u, noise, mask, sc, out, n, D, noise_scale, vec);
    else
      clip_noise_elts_kernel<Noise, false><<<grid, kThreads, 0, stream>>>(
          u, noise, mask, sc, out, n, D, noise_scale, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (agg == nullptr || D == 0) return 0;
  const int nblk = blocks_of(C);
  if (nblk > 0) {
    agg_partial_kernel<<<dim3(nblk, (D + kThreads - 1) / kThreads), kThreads,
                         0, stream>>>(out, wgt, partial, C, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  clip_noise_agg_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, agg, nblk, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dp_blocks(int C) { return blocks_of(C); }

int dp_clip_noise(const float* u, const float* noise, const float* mask,
                  const float* wgt, float* out, float* agg, float* partial,
                  float* scale, int C, int D, float clip, float noise_scale,
                  cudaStream_t stream) {
  return launch_clip_noise(u, OperandNoise{noise}, noise, mask, wgt, out,
                           agg, partial, scale, C, D, clip, noise_scale,
                           stream);
}

// start: the counter of u's first element, row_offset * D for the rows
// of a larger draw
int dp_clip_noise_prng(const float* u, uint32_t k0, uint32_t k1,
                       long long start, const float* mask, const float* wgt,
                       float* out, float* agg, float* partial, float* scale,
                       int C, int D, float clip, float noise_scale,
                       cudaStream_t stream) {
  return launch_clip_noise(u, CounterNoise{k0, k1, (uint64_t)start}, nullptr,
                           mask, wgt, out, agg, partial, scale, C, D, clip,
                           noise_scale, stream);
}

int dp_prng_words(uint32_t k0, uint32_t k1, long long n, uint32_t* words0,
                  uint32_t* words1, cudaStream_t stream) {
  if (n <= 0) return 0;
  prng_words_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      stream>>>(k0, k1, n, words0, words1);
  return (int)cudaGetLastError();
}

}  // extern "C"
