// Fused device-tick kernels for Hopper (sm_90a): server bucket apply,
// ISRRECEIVE delivery gather, and the round-completion ring scatter.
//
// Replaces the Pallas kernels of repro/kernels/tick_fused/kernel.py
// (_bucket_apply_kernel, _tick_deliver_kernel, _tick_scatter_kernel).
// All three are f32 streams over the [C, D] client block with almost no
// arithmetic per byte, so they are bound by device-memory bytes: the
// design reads each input element once, writes each output once, masks
// the ragged edges of C and D in the kernel (no padding, hence no +0.0
// terms that could flip a -0.0 sum) and keeps every reduction over
// clients in a fixed order with no atomics, so two runs give the same
// bits.
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), which nvcc never
// contracts into an FMA; the file is also built with -fmad=false.  So
// bucket_apply (A == 1), tick_deliver and the w/U outputs of
// tick_scatter round exactly like PyTorch's eager plain versions and
// match them bit for bit; the scatter sums differ from torch.sum only
// in their add order.
//
// Each extern "C" entry point launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows of the client axis one scatter block reduces (fixed: it sets
// the add order of the two-pass reduction)
constexpr int kRowsPerBlock = 64;
// scatter rows accumulated per sweep over a block's rows
constexpr int kGChunk = 8;

// v'[d] = flag ? v[d] - sum_a rows[a, d] * dec[a] : v[d]
// A == 1 scales the single row (rows[0] * dec[0], no 0.0 + x that would
// flip a -0.0 row); A > 1 sums in ascending a.
__global__ void bucket_apply_kernel(const float* __restrict__ v,
                                    const float* __restrict__ rows,
                                    const float* __restrict__ dec,
                                    const int32_t* __restrict__ flag,
                                    float* __restrict__ out, int A, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const float vd = v[d];
  if (*flag == 0) {
    out[d] = vd;
    return;
  }
  float c = __fmul_rn(rows[d], dec[0]);
  for (int a = 1; a < A; ++a)
    c = __fadd_rn(c, __fmul_rn(rows[(size_t)a * D + d], dec[a]));
  out[d] = __fsub_rn(vd, c);
}

// w'[c] = take[c] ? bc_v[best[c]] - eta[c] * U[c] : w[c]; one block per
// client row, threads stride over D (coalesced).  Pure selection plus
// one rounded product and difference per element.
__global__ void tick_deliver_kernel(const float* __restrict__ w,
                                    const float* __restrict__ U,
                                    const float* __restrict__ bc_v,
                                    const int64_t* __restrict__ best,
                                    const bool* __restrict__ take,
                                    const float* __restrict__ eta,
                                    float* __restrict__ out, int D) {
  const size_t row = (size_t)blockIdx.x * D;
  if (take[blockIdx.x]) {
    const float e = eta[blockIdx.x];
    const float* src = bc_v + (size_t)best[blockIdx.x] * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      out[row + d] = __fsub_rn(src[d], __fmul_rn(e, U[row + d]));
  } else {
    for (int d = threadIdx.x; d < D; d += blockDim.x) out[row + d] = w[row + d];
  }
}

// Pass 1 of the scatter.  Block b owns client rows
// [b * kRowsPerBlock, ...): it writes their w/U outputs and, per column,
// the partial sums partial[b, g, d] = sum_c wgt[g, c] * sent[c, d] in
// ascending c.
__global__ void tick_scatter_rows_kernel(
    const float* __restrict__ sent, const float* __restrict__ w,
    const float* __restrict__ U, const float* __restrict__ wgt,
    const bool* __restrict__ done, const float* __restrict__ eta,
    float* __restrict__ w_out, float* __restrict__ u_out,
    float* __restrict__ partial, int C, int D, int G, int dp_on) {
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, C);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    for (int g0 = 0; g0 < G; g0 += kGChunk) {
      // the sums start from their first term, not from 0.0f: an
      // all -0.0 column stays -0.0, as in an unpadded torch.sum
      float acc[kGChunk];
      const float s0 = sent[(size_t)r0 * D + d];
#pragma unroll
      for (int j = 0; j < kGChunk; ++j)
        acc[j] = g0 + j < G ? __fmul_rn(s0, wgt[(size_t)(g0 + j) * C + r0]) : 0.0f;
      for (int r = r0 + 1; r < r1; ++r) {
        const float s = sent[(size_t)r * D + d];
#pragma unroll
        for (int j = 0; j < kGChunk; ++j)
          if (g0 + j < G)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(s, wgt[(size_t)(g0 + j) * C + r]));
      }
#pragma unroll
      for (int j = 0; j < kGChunk; ++j)
        if (g0 + j < G)
          partial[((size_t)blockIdx.x * G + g0 + j) * D + d] = acc[j];
    }
    for (int r = r0; r < r1; ++r) {
      const size_t i = (size_t)r * D + d;
      const float s = sent[i];
      if (done[r]) {
        w_out[i] = dp_on ? __fadd_rn(w[i], __fmul_rn(eta[r], __fsub_rn(s, U[i])))
                         : w[i];
        u_out[i] = 0.0f;
      } else {
        w_out[i] = w[i];
        u_out[i] = s;
      }
    }
  }
}

// Pass 2: upd'[g, d] = any_g[g] ? upd[g, d] + sum_b partial[b, g, d]
// : upd[g, d] (the guarded add: a ring row nobody scattered into stays
// bitwise untouched).  Blocks are summed in ascending b.
__global__ void tick_scatter_finish_kernel(const float* __restrict__ partial,
                                           const float* __restrict__ upd,
                                           const bool* __restrict__ any_g,
                                           float* __restrict__ upd_out,
                                           int nblk, int G, int D) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= G * D) return;
  const int g = t / D;
  if (!any_g[g] || nblk == 0) {
    upd_out[t] = upd[t];
    return;
  }
  float vec = partial[t];
  for (int b = 1; b < nblk; ++b) vec = __fadd_rn(vec, partial[(size_t)b * G * D + t]);
  upd_out[t] = __fadd_rn(upd[t], vec);
}

}  // namespace

extern "C" {

int tf_bucket_apply(const float* v, const float* rows, const float* dec,
                    const int32_t* flag, float* out, int A, int D,
                    cudaStream_t stream) {
  if (D == 0) return 0;
  bucket_apply_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      v, rows, dec, flag, out, A, D);
  return (int)cudaGetLastError();
}

int tf_tick_deliver(const float* w, const float* U, const float* bc_v,
                    const int64_t* best, const bool* take, const float* eta,
                    float* out, int C, int D, cudaStream_t stream) {
  if (C == 0) return 0;
  tick_deliver_kernel<<<C, kThreads, 0, stream>>>(w, U, bc_v, best, take, eta,
                                                  out, D);
  return (int)cudaGetLastError();
}

int tf_scatter_blocks(int C) { return (C + kRowsPerBlock - 1) / kRowsPerBlock; }

int tf_tick_scatter(const float* sent, const float* w, const float* U,
                    const float* upd, const float* wgt, const bool* any_g,
                    const bool* done, const float* eta, float* w_out,
                    float* u_out, float* upd_out, float* partial, int C,
                    int D, int G, int dp_on, cudaStream_t stream) {
  const int nblk = tf_scatter_blocks(C);
  if (nblk > 0) {
    tick_scatter_rows_kernel<<<nblk, kThreads, 0, stream>>>(
        sent, w, U, wgt, done, eta, w_out, u_out, partial, C, D, G, dp_on);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (G * D == 0) return 0;
  tick_scatter_finish_kernel<<<(G * D + kThreads - 1) / kThreads, kThreads, 0,
                               stream>>>(partial, upd, any_g, upd_out, nblk, G,
                                         D);
  return (int)cudaGetLastError();
}

}  // extern "C"
