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
// tick_scatter runs on every completion tick (thousands of launches a
// scenario run).  Its rows pass streams sent, w and (on done rows) U
// through shared memory in tiles of 4 client rows by 16-byte cp.async, a
// tile's copies in flight while the previous tile is used: w' and U' go
// out of the tile as 16-byte stores, and each thread adds its two columns
// of the tile into register sums for up to 8 ring rows at a time over the
// block's whole row range (row_tiles.cuh: at most 264 blocks, two resident
// on each SM, so the 16384 clients of the main run are 256 blocks of 64
// rows and 256 partial rows per ring row).  The finish pass adds those in
// a tree of 16 leaves per column, many blocks wide.  One pass over the
// bytes, every SM busy: what the byte bound asks for.
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), which nvcc never
// contracts into an FMA; the file is also built with -fmad=false.  So
// bucket_apply (A == 1), tick_deliver and the w/U outputs of
// tick_scatter round exactly like PyTorch's eager plain versions and
// match them bit for bit; the scatter sums differ from torch.sum only
// in their add order, which kernels/tick_fused/ref.py's
// tick_scatter_twin repeats exactly.
//
// Each extern "C" entry point launches on the caller's stream and
// returns cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

constexpr int kThreads = 256;
// client rows of one tick_scatter tile (fixed: with the partition of
// row_tiles.cuh it sets the add order of the ring sums)
constexpr int kScatterTileRows = 4;

// floats of one tick_scatter pipeline stage: the tile's sent, w and U
// rows, its eta and its KG wgt columns (a multiple of 4: stages stay
// 16-byte aligned)
__host__ __device__ constexpr int scatter_stage_floats(int KG, int ld) {
  return 3 * kScatterTileRows * ld + kScatterTileRows * (1 + KG);
}

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
// chunk of kDeliverChunk columns of a client row (one chunk a row at the
// main run's D; a model-sized row is spread over the whole card), threads
// stride over the chunk (coalesced).  Pure selection plus one rounded
// product and difference per element.
constexpr int kDeliverChunk = 8192;

__global__ void tick_deliver_kernel(const float* __restrict__ w,
                                    const float* __restrict__ U,
                                    const float* __restrict__ bc_v,
                                    const int64_t* __restrict__ best,
                                    const bool* __restrict__ take,
                                    const float* __restrict__ eta,
                                    float* __restrict__ out, int D,
                                    int nchunk) {
  const int c = blockIdx.x / nchunk;
  const int d0 = (blockIdx.x - c * nchunk) * kDeliverChunk;
  const int d1 = min(d0 + kDeliverChunk, D);
  const size_t row = (size_t)c * D;
  if (take[c]) {
    const float e = eta[c];
    const float* src = bc_v + (size_t)best[c] * D;
    for (int d = d0 + threadIdx.x; d < d1; d += blockDim.x)
      out[row + d] = __fsub_rn(src[d], __fmul_rn(e, U[row + d]));
  } else {
    for (int d = d0 + threadIdx.x; d < d1; d += blockDim.x)
      out[row + d] = w[row + d];
  }
}

// tick_scatter's rows pass.  Block (x, b, z) owns the columns of slab x
// and client rows [b * rows_per_block, ...); it walks them in
// tiles of kScatterTileRows rows, each tile's sent, w and (on done rows,
// with dp_on) U rows copied into shared memory while the previous tile is
// used.  From the tile it writes w' and U' (z == 0 only) as 16-byte
// stores, and adds wgt[g, c] * sent[c, d] for the KG ring rows of chunk z
// into register sums over all its rows in ascending c; it ends by writing
// partial[b, g, d].  done for tile t + 2 is read from memory while tile t
// waits for its copies, so the U copies of tile t + 1 know their rows.
template <int KG>
__global__ void __launch_bounds__(512, 2) tick_scatter_rows_kernel(
    const float* __restrict__ sent, const float* __restrict__ w,
    const float* __restrict__ U, const float* __restrict__ wgt,
    const bool* __restrict__ done, const float* __restrict__ eta,
    float* __restrict__ w_out, float* __restrict__ u_out,
    float* __restrict__ partial, int C, int D, int G, int slab, int ld,
    int rows_per_block, int dp_on, int vec) {
  constexpr int TR = kScatterTileRows;
  constexpr int NC = rowtiles::kColsPerThread;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool sdone[3][TR];
  const int sf = scatter_stage_floats(KG, ld);
  // slabs on x (up to 2^31 - 1 of them: a model-sized D has ~10^6),
  // row blocks on y (at most kMaxBlocks)
  const int rb0 = blockIdx.y * rows_per_block;
  const int rb1 = min(rb0 + rows_per_block, C);
  const int c0 = blockIdx.x * slab;
  const int len = min(slab, D - c0);
  const int g0 = blockIdx.z * KG;
  const int gn = min(KG, G - g0);
  const bool rows_out = blockIdx.z == 0;
  const bool need_u = rows_out && dp_on;
  const int ntile = (rb1 - rb0 + TR - 1) / TR;
  const int tid = threadIdx.x;

  auto done_of = [&](int t) {  // thread tid's row of tile t (tid < TR)
    const int r = rb0 + t * TR + tid;
    return tid < TR && r < rb1 && done[r];
  };
  auto issue = [&](int t) {
    float* st = smem + (t & 1) * sf;
    const int r0 = rb0 + t * TR;
    const int nr = min(TR, rb1 - r0);
    const size_t off = (size_t)r0 * D + c0;
    const bool* dn = sdone[t % 3];
    auto all = [](int) { return true; };
    rowtiles::copy_rows(st, ld, sent + off, (size_t)D, len, nr, all);
    if (rows_out)
      rowtiles::copy_rows(st + TR * ld, ld, w + off, (size_t)D, len, nr, all);
    if (need_u)
      rowtiles::copy_rows(st + 2 * TR * ld, ld, U + off, (size_t)D, len, nr,
                          [dn](int i) { return dn[i]; });
    float* se = st + 3 * TR * ld;  // eta[TR], then wgt[g0 + k][TR]
    for (int j = tid; j < nr * (1 + gn); j += blockDim.x) {
      const int k = j / nr;
      const int i = j - k * nr;
      rowtiles::cp_elem(se + k * TR + i,
                        k == 0 ? eta + r0 + i
                               : wgt + (size_t)(g0 + k - 1) * C + r0 + i);
    }
    rowtiles::commit();
  };

  if (tid < TR) {
    sdone[0][tid] = done_of(0);
    sdone[1][tid] = done_of(1);
  }
  __syncthreads();
  issue(0);
  float acc[NC][KG];
  for (int t = 0; t < ntile; ++t) {
    const bool dnext = done_of(t + 2);
    rowtiles::wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (tid < TR) sdone[(t + 2) % 3][tid] = dnext;
    if (t + 1 < ntile) issue(t + 1);
    const float* st = smem + (t & 1) * sf;
    const float* se = st + 3 * TR * ld;
    const bool* dn = sdone[t % 3];
    const int r0 = rb0 + t * TR;
    const int nr = min(TR, rb1 - r0);
    int sh[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      sh[i] = rowtiles::line_shift(sent + (size_t)(r0 + i) * D + c0);

    if (rows_out) {
      // w' and U' in 16-byte groups of the shared rows; vec: every array
      // has sent's line shift, so a full group is one 16-byte store
      rowtiles::for_groups(nr, ld / 4, [&](int i, int q) {
        const int lo = q * 4;
        const size_t off = (size_t)(r0 + i) * D + c0;
        const int s0 = rowtiles::line_shift(sent + off);
        if (lo + 4 <= s0 || lo >= s0 + len) return;
        const bool di = dn[i];
        const float e = se[i];
        const float* srow = st + i * ld;
        const float* wrow = st + (TR + i) * ld;
        const float* urow = st + (2 * TR + i) * ld;
        if (vec && lo >= s0 && lo + 4 <= s0 + len) {
          const float4 s4 = *reinterpret_cast<const float4*>(srow + lo);
          float4 wo = *reinterpret_cast<const float4*>(wrow + lo);
          float4 uo = s4;
          if (di) {
            uo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (dp_on) {
              const float4 u4 = *reinterpret_cast<const float4*>(urow + lo);
              wo.x = __fadd_rn(wo.x, __fmul_rn(e, __fsub_rn(s4.x, u4.x)));
              wo.y = __fadd_rn(wo.y, __fmul_rn(e, __fsub_rn(s4.y, u4.y)));
              wo.z = __fadd_rn(wo.z, __fmul_rn(e, __fsub_rn(s4.z, u4.z)));
              wo.w = __fadd_rn(wo.w, __fmul_rn(e, __fsub_rn(s4.w, u4.w)));
            }
          }
          *reinterpret_cast<float4*>(w_out + off + (lo - s0)) = wo;
          *reinterpret_cast<float4*>(u_out + off + (lo - s0)) = uo;
        } else {
          const int sw = rowtiles::line_shift(w + off);
          const int su = rowtiles::line_shift(U + off);
          for (int p = max(lo, s0); p < min(lo + 4, s0 + len); ++p) {
            const int c = p - s0;
            const float s = srow[p];
            float wo = wrow[sw + c];
            float uo = s;
            if (di) {
              uo = 0.0f;
              if (dp_on)
                wo = __fadd_rn(wo, __fmul_rn(e, __fsub_rn(s, urow[su + c])));
            }
            w_out[off + c] = wo;
            u_out[off + c] = uo;
          }
        }
      });
    }

    // the ring sums: each thread's NC columns, rows in ascending order;
    // the block's first row starts each sum (no 0.0f + x)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = tid + k * blockDim.x;
      if (c >= len) continue;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        if (i >= nr) break;
        const float s = st[i * ld + sh[i] + c];
#pragma unroll
        for (int j = 0; j < KG; ++j) {
          if (j >= gn) break;
          const float term = __fmul_rn(s, se[(1 + j) * TR + i]);
          acc[k][j] = t == 0 && i == 0 ? term : __fadd_rn(acc[k][j], term);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = tid + k * blockDim.x;
    if (c >= len) continue;
#pragma unroll
    for (int j = 0; j < KG; ++j)
      if (j < gn)
        partial[((size_t)blockIdx.y * G + g0 + j) * D + c0 + c] = acc[k][j];
  }
}

// The rows pass over (row blocks, column slabs, chunks of KG ring rows),
// then the finish pass.  vec: w, U and both outputs share sent's
// alignment within 16 bytes, so w' and U' go out as 16-byte stores.
template <int KG>
int launch_scatter(const float* sent, const float* w, const float* U,
                   const float* upd, const float* wgt, const bool* any_g,
                   const bool* done, const float* eta, float* w_out,
                   float* u_out, float* upd_out, float* partial, int C, int D,
                   int G, int dp_on, cudaStream_t stream) {
  const rowtiles::Partition part =
      rowtiles::partition(C, kScatterTileRows);
  if (part.blocks > 0) {
    const rowtiles::Slabs sl = rowtiles::slabs(D, sizeof(float));
    const size_t bytes =
        2 * sizeof(float) * (size_t)scatter_stage_floats(KG, sl.ld);
    cudaError_t err = cudaFuncSetAttribute(
        tick_scatter_rows_kernel<KG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const uintptr_t a = reinterpret_cast<uintptr_t>(sent) % 16;
    const int vec = reinterpret_cast<uintptr_t>(w) % 16 == a &&
                    reinterpret_cast<uintptr_t>(U) % 16 == a &&
                    reinterpret_cast<uintptr_t>(w_out) % 16 == a &&
                    reinterpret_cast<uintptr_t>(u_out) % 16 == a;
    const dim3 grid(sl.count, part.blocks, G > KG ? (G + KG - 1) / KG : 1);
    tick_scatter_rows_kernel<KG><<<grid, sl.threads, bytes, stream>>>(
        sent, w, U, wgt, done, eta, w_out, u_out, partial, C, D, G, sl.width,
        sl.ld, part.rows_per_block, dp_on, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowtiles::launch_finish(partial, upd, any_g, upd_out,
                                      part.blocks, G, D, stream);
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
  if (C == 0 || D == 0) return 0;
  const int nchunk = (D + kDeliverChunk - 1) / kDeliverChunk;
  tick_deliver_kernel<<<(unsigned)((size_t)C * nchunk), kThreads, 0,
                        stream>>>(w, U, bc_v, best, take, eta, out, D,
                                  nchunk);
  return (int)cudaGetLastError();
}

int tf_scatter_blocks(int C) {
  return rowtiles::partition(C, kScatterTileRows).blocks;
}

int tf_tick_scatter(const float* sent, const float* w, const float* U,
                    const float* upd, const float* wgt, const bool* any_g,
                    const bool* done, const float* eta, float* w_out,
                    float* u_out, float* upd_out, float* partial, int C,
                    int D, int G, int dp_on, cudaStream_t stream) {
  if (D <= 0) return 0;
  return G <= 2 ? launch_scatter<2>(sent, w, U, upd, wgt, any_g, done, eta,
                                    w_out, u_out, upd_out, partial, C, D, G,
                                    dp_on, stream)
                : launch_scatter<8>(sent, w, U, upd, wgt, any_g, done, eta,
                                    w_out, u_out, upd_out, partial, C, D, G,
                                    dp_on, stream);
}

}  // extern "C"
