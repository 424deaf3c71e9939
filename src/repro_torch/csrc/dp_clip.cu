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
// bytes.  Design (row_tiles.cuh): block b owns a contiguous range of
// example rows and walks it in tiles (12 rows in f32, 24 in bf16, ~37 KB
// at D 785) copied into shared memory by 16-byte cp.async, the next tile
// in flight while the current one is used.  From the tile, a warp per
// row takes the squared norm (lane-strided sums, then a fixed xor-shuffle
// tree) and the row's scale; then each thread adds its two columns of the
// scaled rows into register sums over the block's whole row range, in
// ascending n.  G is read from memory once.  The partition (at most 264
// blocks, two resident on each SM) keeps every SM busy at the DP round's
// N = 60000 (264 blocks of 228 rows) and at its microbatch N = 6000 (250
// blocks of 24 rows); a wide finish pass adds the block partials in a
// tree of 16 leaves per column.  Rows wider than row_tiles.cuh's slab
// (D > 1024) take their scales from a norm pass first (clip_norms_kernel,
// the same add order), so only there G is read twice.  No atomics: two
// runs give the same bits.  Ragged N and D are masked, never padded.
//
// Rounding: explicit round-to-nearest intrinsics, built with -fmad=false;
// the result differs from the plain version (kernels/dp_clip/ref.py) only
// in the add order of the row norms and the column sums, which
// ref.py's clip_accumulate_twin repeats exactly.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

// example rows of one tile: 48 bytes of each column (fixed per dtype: with
// the partition of row_tiles.cuh it sets the add order of the sums)
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return 48 / sizeof(T);
}

// bytes of one pipeline stage: the tile's rows, then their scales (a
// multiple of 16: stages stay 16-byte aligned)
template <typename T>
__host__ __device__ size_t stage_bytes(int ld) {
  return (size_t)tile_rows<T>() * (ld * sizeof(T) + sizeof(float));
}

// 1 / max(1, ||row|| / clip) over D elements, for the whole warp: lane l
// adds the squares of elements l, l + 32, ... in order from 0.0f, then
// the lanes combine by an xor-shuffle tree (every lane ends with the same
// bits)
template <typename T>
__device__ __forceinline__ float row_scale(const T* row, int D, int lane,
                                           float clip) {
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = rowtiles::to_f32(row[d]);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  return __fdiv_rn(1.0f, fmaxf(1.0f, __fdiv_rn(__fsqrt_rn(sq), clip)));
}

// the scales of all rows, a warp per row, from device memory (only for
// rows wider than a slab)
template <typename T>
__global__ void clip_norms_kernel(const T* __restrict__ g,
                                  float* __restrict__ scale, int N, int D,
                                  float clip) {
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= N) return;
  const float s = row_scale(g + (size_t)r * D, D, lane, clip);
  if (lane == 0) scale[r] = s;
}

// The rows pass.  Block (b, y) owns example rows [b * rows_per_block,
// ...) and the columns of slab y.  scale_in == nullptr: one slab, the
// scales come from the tile; else they are copied with it.
template <typename T>
__global__ void __launch_bounds__(512, 2)
    clip_rows_kernel(const T* __restrict__ g,
                     const float* __restrict__ scale_in,
                     float* __restrict__ partial, int N, int D, int slab,
                     int ld, int rows_per_block, float clip) {
  constexpr int TR = tile_rows<T>();
  constexpr int NC = rowtiles::kColsPerThread;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t sb = stage_bytes<T>(ld);
  // slabs on x, row blocks on y (gridDim.y is at most 65535)
  const int rb0 = blockIdx.y * rows_per_block;
  const int rb1 = min(rb0 + rows_per_block, N);
  const int c0 = blockIdx.x * slab;
  const int len = min(slab, D - c0);
  const int ntile = (rb1 - rb0 + TR - 1) / TR;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = blockDim.x / 32;

  auto rows_of = [&](int t) {
    return reinterpret_cast<T*>(smem + (t & 1) * sb);
  };
  auto scales_of = [&](int t) {
    return reinterpret_cast<float*>(smem + (t & 1) * sb +
                                    (size_t)TR * ld * sizeof(T));
  };
  auto issue = [&](int t) {
    const int r0 = rb0 + t * TR;
    const int nr = min(TR, rb1 - r0);
    rowtiles::copy_rows(rows_of(t), ld, g + (size_t)r0 * D + c0, (size_t)D,
                        len, nr, [](int) { return true; });
    if (scale_in)
      for (int i = tid; i < nr; i += blockDim.x)
        rowtiles::cp_elem(scales_of(t) + i, scale_in + r0 + i);
    rowtiles::commit();
  };

  issue(0);
  float acc[NC];
  for (int t = 0; t < ntile; ++t) {
    rowtiles::wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < ntile) issue(t + 1);
    const int r0 = rb0 + t * TR;
    const int nr = min(TR, rb1 - r0);
    const T* rows = rows_of(t);
    float* sc = scales_of(t);
    if (!scale_in) {
      for (int i = warp; i < nr; i += nwarps) {
        const float s = row_scale(
            rows + i * ld + rowtiles::line_shift(g + (size_t)(r0 + i) * D),
            D, lane, clip);
        if (lane == 0) sc[i] = s;
      }
      __syncthreads();
    }
    // the block's first row starts each column sum (no 0.0f + x); a
    // row's line shift steps by D from the previous row's
    int sh = rowtiles::line_shift(g + (size_t)r0 * D + c0);
    for (int i = 0; i < nr; ++i) {
      const T* row = rows + i * ld + sh;
      const float s = sc[i];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = tid + k * blockDim.x;
        if (c < len) {
          const float term = __fmul_rn(rowtiles::to_f32(row[c]), s);
          acc[k] = t == 0 && i == 0 ? term : __fadd_rn(acc[k], term);
        }
      }
      sh = (sh + D) % (16 / (int)sizeof(T));
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = tid + k * blockDim.x;
    if (c < len) partial[(size_t)blockIdx.y * D + c0 + c] = acc[k];
  }
}

template <typename T>
int launch(const T* g, float* out, float* partial, float* scale, int N,
           int D, float clip, cudaStream_t stream) {
  if (D <= 0) return 0;
  const rowtiles::Partition part = rowtiles::partition(N, tile_rows<T>());
  if (part.blocks > 0) {
    const rowtiles::Slabs sl = rowtiles::slabs(D, sizeof(T));
    const float* scale_in = nullptr;
    if (sl.count > 1) {
      clip_norms_kernel<T><<<(N + 7) / 8, 256, 0, stream>>>(g, scale, N, D,
                                                            clip);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      scale_in = scale;
    }
    const size_t bytes = 2 * stage_bytes<T>(sl.ld);
    cudaError_t err = cudaFuncSetAttribute(
        clip_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    clip_rows_kernel<T><<<dim3(sl.count, part.blocks), sl.threads, bytes,
                          stream>>>(g, scale_in, partial, N, D, sl.width,
                                    sl.ld, part.rows_per_block, clip);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)rowtiles::launch_finish(partial, nullptr, nullptr, out,
                                      part.blocks, 1, D, stream);
}

}  // namespace

extern "C" {

// blocks of the partition of N rows (the rows of the partial scratch)
int dc_blocks(int N, int bf16) {
  return rowtiles::partition(N, bf16 ? tile_rows<__nv_bfloat16>()
                                     : tile_rows<float>())
      .blocks;
}

// g: (N, D) row-major, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// out: (D,) f32; partial: (dc_blocks(N, bf16), D) f32 scratch; scale: (N,)
// f32 scratch (used for D > 1024).
int dc_clip_accumulate(const void* g, int bf16, float* out, float* partial,
                       float* scale, int N, int D, float clip,
                       cudaStream_t stream) {
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(g), out, partial, scale,
                  N, D, clip, stream);
  return launch(static_cast<const float*>(g), out, partial, scale, N, D,
                clip, stream);
}

}  // extern "C"
