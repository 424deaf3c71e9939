// Shared pieces of the two row-streaming kernels on Hopper (sm_90a):
// tick_fused.cu's tick_scatter and dp_clip.cu's clip_accumulate.  Both
// reduce a row-major [n, D] f32 (or bf16) array over its rows into column
// sums, with a few operations per byte: they are bound by device-memory
// bytes.
//
// The shape both share: block b owns a contiguous range of whole rows (a
// column slab of them where D > kMaxSlab) and walks it in tiles of a few
// rows.  Each tile is copied into shared memory by cp.async while the
// block uses the previous one (two stages), so every input byte is read
// from memory once and each block keeps a tile's copies in flight.
// Threads own columns and add the tile's rows into register sums, in
// ascending row order across the block's whole range, so a block writes
// one partial row of column sums, not one per tile.  A second, wide pass
// (finish_kernel) adds the block partials in a fixed tree.
//
// Determinism: the partition (rows per block, blocks, slabs, leaves) is
// a function of the shapes and of the constants below, never of the card
// it runs on, and no sum uses atomics: two runs, and two cards, give the
// same bits.  Every sum starts from its first term and no tree pads an
// absent leaf with 0.0f, so an all -0.0 column stays -0.0.
//
// Row layout in shared memory: the segment of a row that starts at the
// global pointer p is stored from offset line_shift(p) of its shared row
// (p's element offset inside its 16-byte line), so the 16-byte groups of
// shared and global memory line up.  Full groups go by 16-byte cp.async,
// the ragged ends of a row element by element.  That holds for any D, any
// column offset and any base pointer, 16-byte aligned or not.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowtiles {

// the most blocks a partition has: two resident blocks on each of the
// H100's 132 SMs, one wave.  A constant, not the card's SM count
constexpr int kMaxBlocks = 264;
// columns one thread owns in a rows pass, and the widest column slab one
// block covers (wider rows are cut into equal slabs, one grid row each)
constexpr int kColsPerThread = 2;
constexpr int kMaxSlab = 1024;
// leaves (warps) of the finish pass's tree over the block partials
constexpr int kLeaves = 16;

struct Partition {
  int rows_per_block;
  int blocks;
};

// n rows in tiles of tile_rows: one tile a block while that takes at most
// kMaxBlocks blocks, else as many tiles a block as keep it at kMaxBlocks
inline Partition partition(int n, int tile_rows) {
  const int ntiles = (n + tile_rows - 1) / tile_rows;
  const int per = ntiles > kMaxBlocks ? (ntiles + kMaxBlocks - 1) / kMaxBlocks
                                      : 1;
  const int rb = tile_rows * per;
  return {rb, (n + rb - 1) / rb};
}

struct Slabs {
  int count;    // slabs (grid rows)
  int width;    // columns of a slab (the last may be narrower)
  int ld;       // elements of a shared row: width + room for the shift
  int threads;  // a block's threads: kColsPerThread columns each
};

// D > 0 columns of esz-byte elements
inline Slabs slabs(int D, int esz) {
  const int count = (D + kMaxSlab - 1) / kMaxSlab;
  const int width = (D + count - 1) / count;
  const int v = 16 / esz;
  const int per = (width + kColsPerThread - 1) / kColsPerThread;
  return {count, width, (width + 2 * v - 2) / v * v, (per + 31) / 32 * 32};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
// one element: a 4-byte cp.async; a bf16 element (cp.async has no 2-byte
// form) by a plain load and store, visible after the stage's barrier
__device__ __forceinline__ void cp_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_elem(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src) {
  *dst = *src;
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ int line_shift(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) %
                          (16 / sizeof(T)));
}

// f(i, q) for every row i < nrows and group q < gpr, the block's threads
// striding over them in row-major order (no division in the loop)
template <typename F>
__device__ __forceinline__ void for_groups(int nrows, int gpr, F f) {
  const int di = blockDim.x / gpr;
  const int dq = blockDim.x - di * gpr;
  int i = threadIdx.x / gpr;
  int q = threadIdx.x - i * gpr;
  while (i < nrows) {
    f(i, q);
    i += di;
    q += dq;
    if (q >= gpr) {
      q -= gpr;
      ++i;
    }
  }
}

// Copy nrows row segments of len elements (row i starts at src + i *
// stride) into the shared rows dst + i * ld, each from its line shift;
// rows where take(i) is false are skipped.  The block's threads share the
// 16-byte groups of all rows.
template <typename T, typename Take>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          size_t stride, int len, int nrows,
                                          Take take) {
  constexpr int v = 16 / sizeof(T);
  for_groups(nrows, ld / v, [&](int i, int q) {
    if (!take(i)) return;
    const T* row = src + i * stride;
    const int sh = line_shift(row);
    const int lo = q * v;
    if (lo + v <= sh || lo >= sh + len) return;
    const T* base = row - sh;  // 16-byte aligned; only [sh, sh + len) read
    T* d = dst + (size_t)i * ld;
    if (lo >= sh && lo + v <= sh + len) {
      cp16(d + lo, base + lo);
    } else {
      for (int p = max(lo, sh); p < min(lo + v, sh + len); ++p)
        cp_elem(d + p, base + p);
    }
  });
}

// out[g, d] = on ? (u ? upd[g, d] + S : S) : (u ? upd[g, d] : 0), with
// u = upd && g < nupd (the rows past upd's nupd are sums alone),
// on = nblk > 0 && (!any_g || any_g[g]) and S the sum over b of
// partial[b, g, d].  A block takes 32 columns of one g; warp l is leaf l
// and adds blocks [l * nblk / L, (l + 1) * nblk / L) in ascending order
// from its first term (L = min(kLeaves, nblk): no leaf is empty, none is
// padded).  The leaves combine pairwise, (0+1), (2+3), ..., then
// (01)+(23), ..., an odd leaf passing up alone.  A warp's read is one
// 128-byte line of a partial row.
__global__ void __launch_bounds__(kLeaves * 32)
    finish_kernel(const float* __restrict__ partial,
                  const float* __restrict__ upd,
                  const bool* __restrict__ any_g, float* __restrict__ out,
                  int nblk, int G, int D, int nupd) {
  __shared__ float red[kLeaves][32];
  const int lane = threadIdx.x & 31;
  const int leaf = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int g = blockIdx.y;
  const int L = min(kLeaves, nblk);
  const bool on = nblk > 0 && (any_g == nullptr || any_g[g]);
  if (on && leaf < L && d < D) {
    const int lo = leaf * nblk / L;
    const int n = (leaf + 1) * nblk / L - lo;
    const size_t step = (size_t)G * D;
    const float* p = partial + ((size_t)lo * G + g) * D + d;
    float a = p[0];
#pragma unroll 8
    for (int b = 1; b < n; ++b) a = __fadd_rn(a, p[b * step]);
    red[leaf][lane] = a;
  }
  __syncthreads();
  for (int s = 1; s < L; s <<= 1) {
    if (on && leaf % (2 * s) == 0 && leaf + s < L)
      red[leaf][lane] = __fadd_rn(red[leaf][lane], red[leaf + s][lane]);
    __syncthreads();
  }
  if (leaf == 0 && d < D) {
    const size_t i = (size_t)g * D + d;
    const bool u = upd != nullptr && g < nupd;
    const float base = u ? upd[i] : 0.0f;
    out[i] = !on ? base : u ? __fadd_rn(base, red[0][lane]) : red[0][lane];
  }
}

// nupd: rows of upd (G when it covers every row; ignored when upd is null)
inline cudaError_t launch_finish(const float* partial, const float* upd,
                                 const bool* any_g, float* out, int nblk,
                                 int G, int D, cudaStream_t stream,
                                 int nupd = -1) {
  if (G <= 0 || D <= 0) return cudaSuccess;
  finish_kernel<<<dim3((D + 31) / 32, G), kLeaves * 32, 0, stream>>>(
      partial, upd, any_g, out, nblk, G, D, nupd < 0 ? G : nupd);
  return cudaGetLastError();
}

}  // namespace rowtiles
