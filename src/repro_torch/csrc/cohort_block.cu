// A logistic-regression client block for Hopper (sm_90a): every client's
// local SGD steps of one block tick, in one launch.
//
// Replaces no TPU kernel: the reference runs the block as a vmapped scan
// (repro/cohort/tasks.py, CohortLogRegTask.block_body) that XLA fuses.
// The port ran it as an eager loop of b masked steps over [C, D] tensors
// (about 30 passes of 4 C D bytes a step); this kernel takes its place.
//
// Per client c, for j < min(n[c], b) (steps past n[c] are not run, and a
// client with n[c] = 0 writes its rows back unchanged):
//   r = idx[c, j]; x = X[r] (d = D - 1 values); yv = y[r]
//   z  = x . w + wb                        (w = row[:d], wb = row[d])
//   dz = per_example_grad's f32 formula: bal = 1, 1/2, 0 for z >, ==, < 0
//        (clamp's balanced tie), e = exp(-|z|), t = (1 / (e + 1)) e,
//        t_abs = z >= 0 ? -t : t, dz = (t_abs - yv) + bal
//   g  = x dz (+ c_l2 (2 w) when l2 > 0, c_l2 = f32(0.5 l2)); gb = dz
//   clip > 0: s = 1 / max(sqrt(gb gb + |g|^2) inv, 1); g *= s; gb *= s,
//        inv = f32(1 / clip), the reciprocal in double rounded to f32
//        (PyTorch on the card divides an f32 tensor by a Python number
//        so, and the benchmark's reference does)
//   U row += (g, gb); w row -= eta[c] (g, gb)
// and the new rows are written out of place.
//
// Bound: device-memory bytes.  Each step must read its sampled row of X
// (4 d bytes; rows are drawn at random from an X larger than L2), and
// the launch reads and writes the w and U rows once:
// 4 d sum_c min(n[c], b) + 16 C D bytes, plus the indices it reads.  The
// arithmetic (about 8 f32 operations an element a step) is a small
// fraction of the card's rate.
//
// Design: one warp per client.  A row's d elements are read as q = d / 4
// groups of four (then t = d % 4 tail elements): lane l holds groups
// l, l + 32, ..., l + 32 (KV - 1) and tail element 4 q + l of w, U and
// the current x in registers (KV = ceil(q / 32), a template parameter
// chosen from D), and every lane holds the bias pair.  The row of step
// j + 1 is loaded into a second register set before step j computes,
// and the index of step j + 2 one step before that, so each warp keeps
// one row in flight behind its serial chain of steps; the many warps of
// an SM hide the rest.  Warps are independent: ragged n needs no
// synchronisation.
//
// Add order (fixed, repeated by the plain twin's lane_sum in
// kernels/cohort_block/ref.py), the order of PyTorch's own f32 row sum on
// the card for a contiguous row whose length is a multiple of 4 and at
// least 128 (as the cell's 784): the dot product and the clip's squared
// norm are each summed by lane into four accumulators from +0.0, one per
// place in a group, over the lane's groups in ascending order; the tail
// element goes into the first; the four meet as ((a0 + a1) + a2) + a3;
// then the lanes in a shuffle tree of offsets 16, 8, 4, 2, 1, whose lane
// 0 sum every lane takes.  The clip's norm adds the bias term first:
// gb gb + |g|^2.  So on the card the block gives the old eager loop's
// bits (torch's row sums) but for the sign of an exact zero and NaN.
//
// Rounding: explicit round-to-nearest intrinsics, built with -fmad=false,
// precise expf, correctly rounded division and square root, as PyTorch's
// elementwise kernels compute them on the card: the twin on CUDA tensors
// gives this kernel's bits.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// blocks an SM must hold: 128 registers a thread, 16 clients an SM.  On
// the card at C 131072, D 785 (one element a lane a column, the layout
// before groups of four) it ran faster than the uncapped 164 registers
// (12 clients an SM), most at ragged n: 9.06 against 10.25 ms.
constexpr int kMinBlocks = 4;
constexpr unsigned kFull = 0xffffffffu;
// the most groups of four a lane holds: d <= 4 * 32 * kMaxKV + 3
constexpr int kMaxKV = 7;

// The warp's sum of one value a lane, as a shuffle-down tree into lane 0,
// whose bits every lane takes.
__device__ __forceinline__ float warp_tree(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  return __shfl_sync(kFull, s, 0);
}

// The lane's row slots: 4 KV group elements and one tail element.
template <int KV>
struct Slots {
  static constexpr int N = 4 * KV + 1;
};

// This lane's elements of a d-long row into v[Slots<KV>::N] (0 where a
// slot has no element, and everywhere when !valid).  vec: the row start
// is 16-byte aligned and d % 4 == 0, so a group is one 16-byte load.
template <int KV>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int q, int t, int lane, bool valid,
                                         bool vec, float* v) {
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int m = lane + 32 * k;
    const bool in = valid && m < q;
    if (vec) {
      const float4 g = in ? reinterpret_cast<const float4*>(row)[m]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * k] = g.x; v[4 * k + 1] = g.y; v[4 * k + 2] = g.z;
      v[4 * k + 3] = g.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * k + i] = in ? row[4 * m + i] : 0.0f;
    }
  }
  v[4 * KV] = (valid && lane < t) ? row[4 * q + lane] : 0.0f;
}

// The row sum of a[k] b[k] over this lane's slots and the warp, in the
// add order above.
template <int KV>
__device__ __forceinline__ float row_dot(const float* a, const float* b,
                                         int q, int t, int lane) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < KV; ++k)
    if (lane + 32 * k < q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(a[4 * k + i], b[4 * k + i]));
    }
  if (lane < t)
    acc[0] = __fadd_rn(acc[0], __fmul_rn(a[4 * KV], b[4 * KV]));
  return warp_tree(
      __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]));
}

template <int KV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    logreg_block_kernel(const float* __restrict__ w,
                        const float* __restrict__ U,
                        const int64_t* __restrict__ idx,
                        const int* __restrict__ n,
                        const float* __restrict__ eta,
                        const float* __restrict__ X,
                        const float* __restrict__ y,
                        float* __restrict__ w_out, float* __restrict__ U_out,
                        int C, int D, int b, float c_l2, int use_l2,
                        float inv_clip) {
  constexpr int S = Slots<KV>::N;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;                     // warp-uniform
  const int d = D - 1, q = d / 4, t = d % 4;
  const bool xvec = t == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const size_t base = (size_t)c * D;
  float p[S], u[S];
  load_row<KV>(w + base, q, t, lane, true, false, p);
  load_row<KV>(U + base, q, t, lane, true, false, u);
  float pb = w[base + d], ub = U[base + d];
  const int steps = min(max(n[c], 0), b);
  const float et = eta[c];
  const int64_t* __restrict__ my = idx + (size_t)c * b;

  // the first row, and the index of the second
  float x[S];
  const int r0 = steps > 0 ? (int)my[0] : 0;
  load_row<KV>(X + (size_t)r0 * d, q, t, lane, steps > 0, xvec, x);
  float yv = steps > 0 ? y[r0] : 0.0f;
  int r1 = steps > 1 ? (int)my[1] : 0;

  for (int j = 0; j < steps; ++j) {
    // prefetch: the index two steps on, the row one step on
    const bool more = j + 1 < steps;
    const int r2 = j + 2 < steps ? (int)my[j + 2] : 0;
    float xn[S];
    load_row<KV>(X + (size_t)r1 * d, q, t, lane, more, xvec, xn);
    const float yn = more ? y[r1] : 0.0f;

    // z = x . w + wb
    const float z = __fadd_rn(row_dot<KV>(x, p, q, t, lane), pb);
    // dz, as per_example_grad
    const float bal = z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
    const float e = expf(-fabsf(z));
    const float th = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(e, 1.0f)), e);
    const float t_abs = z >= 0.0f ? -th : th;
    const float dz = __fadd_rn(__fsub_rn(t_abs, yv), bal);
    // g, in x's registers
#pragma unroll
    for (int k = 0; k < S; ++k) {
      x[k] = __fmul_rn(x[k], dz);
      if (use_l2)
        x[k] = __fadd_rn(x[k], __fmul_rn(c_l2, __fmul_rn(2.0f, p[k])));
    }
    float gb = dz;
    if (inv_clip > 0.0f) {
      const float norm =
          __fsqrt_rn(__fadd_rn(__fmul_rn(gb, gb),
                               row_dot<KV>(x, x, q, t, lane)));
      const float r = __fmul_rn(norm, inv_clip);
      const float sc = __fdiv_rn(1.0f, r < 1.0f ? 1.0f : r);  // NaN stays
#pragma unroll
      for (int k = 0; k < S; ++k) x[k] = __fmul_rn(x[k], sc);
      gb = __fmul_rn(gb, sc);
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      u[k] = __fadd_rn(u[k], x[k]);
      p[k] = __fsub_rn(p[k], __fmul_rn(et, x[k]));
    }
    ub = __fadd_rn(ub, gb);
    pb = __fsub_rn(pb, __fmul_rn(et, gb));

#pragma unroll
    for (int k = 0; k < S; ++k) x[k] = xn[k];
    yv = yn;
    r1 = r2;
  }

#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int m = lane + 32 * k;
    if (m < q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w_out[base + 4 * m + i] = p[4 * k + i];
        U_out[base + 4 * m + i] = u[4 * k + i];
      }
    }
  }
  if (lane < t) {
    w_out[base + 4 * q + lane] = p[4 * KV];
    U_out[base + 4 * q + lane] = u[4 * KV];
  }
  if (lane == 0) {
    w_out[base + d] = pb;
    U_out[base + d] = ub;
  }
}

template <int KV>
cudaError_t launch(const float* w, const float* U, const int64_t* idx,
                   const int* n, const float* eta, const float* X,
                   const float* y, float* w_out, float* U_out, int C, int D,
                   int b, float c_l2, int use_l2, float inv_clip,
                   cudaStream_t stream) {
  const int blocks = (C + kWarps - 1) / kWarps;
  logreg_block_kernel<KV><<<blocks, kThreads, 0, stream>>>(
      w, U, idx, n, eta, X, y, w_out, U_out, C, D, b, c_l2, use_l2,
      inv_clip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w, U, w_out, U_out: [C, D] f32; idx: [C, b] int64 rows of X; n: [C]
// int32; eta: [C] f32; X: [N, D - 1] f32; y: [N] f32; inv_clip: the
// clip's f32 reciprocal, 0 for no clip.  Returns cudaErrorInvalidValue
// for (D - 1) / 4 groups past 32 kMaxKV (kernel.py's MAX_D).
int logreg_block(const float* w, const float* U, const int64_t* idx,
                 const int* n, const float* eta, const float* X,
                 const float* y, float* w_out, float* U_out, int C, int D,
                 int b, float c_l2, int use_l2, float inv_clip,
                 cudaStream_t stream) {
  if (C <= 0) return cudaSuccess;
  const int groups = ((D - 1) / 4 + 31) / 32;   // groups a lane holds
  if (D < 1 || groups > kMaxKV) return cudaErrorInvalidValue;
#define LOGREG_BLOCK_LAUNCH(KV)                                             \
  return launch<KV>(w, U, idx, n, eta, X, y, w_out, U_out, C, D, b, c_l2,  \
                    use_l2, inv_clip, stream)
  if (groups <= 1) LOGREG_BLOCK_LAUNCH(1);
  if (groups <= 2) LOGREG_BLOCK_LAUNCH(2);
  if (groups <= 4) LOGREG_BLOCK_LAUNCH(4);
  LOGREG_BLOCK_LAUNCH(kMaxKV);
#undef LOGREG_BLOCK_LAUNCH
}

}  // extern "C"
