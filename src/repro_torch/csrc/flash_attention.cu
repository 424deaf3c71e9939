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
// (q, k, v read once, o written once) by ~70x: operations.  Two kernels,
// one per dtype:
//
// * f32 (f32::fa_f32_kernel) runs the products on the f32 pipes (no
//   tensor core takes f32 operands without rounding them): register tiles
//   of 8 x 8 scores and 8 x hd/32 outputs per thread, K and V streamed in
//   slabs by asynchronous copies; see the note above it.
// * bf16 (tc::fa_bf16_kernel) runs both products on the tensor cores with
//   wgmma; see the note above it.
//
// Both skip kv tiles entirely beyond the causal frontier or older than
// the window (the TPU kernel's bounds, C division truncating as
// jax.lax.div).  Ragged S and hd are masked, never padded: keys j >= S
// score the mask value, so they carry no weight.
//
// The mask value is the finite -1e30 of the TPU kernel, not -inf: a row
// whose first visited tile is fully masked computes exp(m - m_new) with
// m = m_new, i.e. exp(0), where -inf would give NaN; the next tile with a
// valid key has alpha = exp(-1e30 - m) = 0 and wipes that row's sums.
//
// Rounding: the f32 dot products use explicit fused multiply-adds;
// softcap uses the precise tanhf after a product with 1/softcap,
// exponentials the precise expf (no fast math, built with -fmad=false).
// The f32 result differs from the plain version
// (kernels/flash_attention/ref.py) in the scaling order (q is scaled, not
// the scores), s * (1/softcap) for s / softcap, and the add order of the
// sums; the bf16 one also in p, rounded to bf16 before P V.  No atomics:
// two launches give the same bits.
//
// The extern "C" entry points launch on the caller's stream and return
// cudaGetLastError(); the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kMaskValue = -1e30f;

// ---- f32: the SIMT kernel ------------------------------------------------
//
// What bounds it is the f32 pipes: 128 FMAs per clock per SM, against 128
// bytes per clock of shared memory, so a product whose operands come from
// shared memory needs at least 4 FMAs per 4-byte load.  Design:
//
// * One block of 8 warps per (b, h, q tile of kBQ = 64 rows); blocks walk
//   the q tiles heaviest first (blockIdx.y reversed, heads fastest).  Warp
//   w owns rows 8w .. 8w + 7 of the tile, in both products.
// * kv tiles of kBK = 256 keys.  Q . K^T: each thread holds an 8 x 8
//   register tile of scores (its warp's 8 rows, keys lane + 32 c): per 4
//   steps of d, 8 float4 of q (the same for the whole warp: broadcasts)
//   and 8 float4 of k feed 256 FMAs.  The Q tile (pre-scaled by 1/sqrt(hd),
//   as the TPU kernel does) stays in shared memory, row-major; K streams
//   through in slabs of 32 columns of d (256 keys x 32, rows padded to 36
//   floats so a quarter-warp's float4 reads hit 8 distinct bank groups).
// * The online softmax runs on the register tile: a row's 256 scores lie
//   in one warp, so its max reduces with five __shfl_xor_sync; the row sum
//   l is kept per lane and reduced once at the end.  Softcap multiplies by
//   a precomputed 1/softcap before the precise tanhf (no divide per score).
//   P goes through shared memory once, key-major (P^T, rows padded to 68
//   floats): conflict-free float4 writes, broadcast float4 reads.
// * P . V: each thread holds an 8 x (hd / 32) register tile of O (8 x 8 at
//   hd 256): per key, 2 float4 of p (broadcast) and 2 float4 of v feed 64
//   FMAs.  V streams through in slabs of 32 keys x hd.  V slabs wholly
//   past the causal frontier or S are skipped: every row of the tile has
//   seen a valid key by then, so their p are exactly 0.
// * K and V slabs (36 KB each) pass through a two-stage ring of 16-byte
//   cp.async copies (4-byte copies, also zero-filling, where hd % 4 != 0
//   or a pointer is not 16-byte aligned): the next slab is in flight while
//   the current one is multiplied, with one __syncthreads per slab.
//   Rows >= S and columns >= hd are zero-filled in shared memory, never
//   padded in device memory.
// * At hd 256: 204 KB of shared memory (Q 64 KB, the ring 72 KB, P^T 68
//   KB), one block of 8 warps per SM.

namespace f32 {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 256;          // keys per kv tile
constexpr int kThreads = 256;     // 8 warps of kR rows each
constexpr int kR = 8;             // rows per thread (its warp's)
constexpr int kC = kBK / 32;      // keys per thread: lane + 32 c
constexpr int kSlab = 32;         // d columns per K slab, keys per V slab
constexpr int kKS = kSlab + 4;    // K slab row stride (floats)
constexpr int kPS = kBQ + 4;      // P^T row stride (floats)
static_assert(kBQ == 8 * kR && kThreads == 32 * kBQ / kR, "warp per 8 rows");

template <int HDP>
__host__ __device__ constexpr int stage_floats() {
  return kBK * kKS > kSlab * HDP ? kBK * kKS : kSlab * HDP;
}

template <int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * HDP + 2 * (size_t)stage_floats<HDP>() +
          (size_t)kBK * kPS);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x COLS block x[b, r0 + r, head, c0 + c] into dst (row stride ld)
// by cp.async; zero where r0 + r >= S or c0 + c >= hd.  vec: 16-byte
// copies (hd % 4 == 0, 16-byte aligned base), else 4-byte ones.
template <int COLS>
__device__ __forceinline__ void copy_block(float* dst, int ld, int rows,
                                           const float* __restrict__ x,
                                           int b, int r0, int head, int c0,
                                           int S, int nh, int hd, bool vec) {
  constexpr int CH = COLS / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += kThreads) {
    const int r = e / CH, c = 4 * (e % CH);
    const int row = r0 + r, col = c0 + c;
    const float* src =
        x + (((size_t)b * S + (row < S ? row : 0)) * nh + head) * (size_t)hd;
    float* d = dst + r * ld + c;
    if (vec) {
      const bool in = row < S && col < hd;
      cp_async16(d, src + (in ? col : 0), in);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = row < S && col + k < hd;
        cp_async4(d + k, src + (in ? col + k : 0), in);
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int H, int KV, int hd, float scale, int causal, int window,
              float softcap, int vec) {
  constexpr int NK = HDP / kSlab;       // K slabs per kv tile
  constexpr int NCOL = HDP / 32;        // output columns per thread
  constexpr int VW = NCOL < 4 ? NCOL : 4;  // floats per V read
  constexpr int NJ = NCOL / VW;         // columns VW lane + 32 VW j + e
  constexpr int STAGE = stage_floats<HDP>();
  extern __shared__ float4 fa32_smem[];
  float* Qs = reinterpret_cast<float*>(fa32_smem);  // kBQ x HDP
  float* ring = Qs + kBQ * HDP;                      // 2 x STAGE
  float* Pt = ring + 2 * STAGE;                      // kBK x kPS

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kR;  // the thread's rows r0 .. r0 + 7
  const int rowb = q0 + r0;
  const bool v16 = vec != 0;
  const float inv_cap = softcap > 0.0f ? __fdiv_rn(1.0f, softcap) : 0.0f;

  // live kv tiles [lo, hi): the TPU kernel's bounds (kernel.py:47-55)
  const int nkv = (S + kBK - 1) / kBK;
  int hi = causal ? (q0 + kBQ - 1) / kBK + 1 : nkv;
  if (hi > nkv) hi = nkv;
  int lo = 0;
  if (window > 0) {
    lo = (q0 - window - kBK + 1) / kBK;  // truncates toward zero
    if (lo < 0) lo = 0;
  }
  // keys >= kend are masked in every row of the tile
  const int kend = causal ? min(S, q0 + kBQ) : S;

  // slab idx of kv tile kt into stage st: K columns [32 idx, 32 idx + 32)
  // for idx < NK, else V keys [32 (idx - NK), + 32) of the tile
  auto fetch = [&](int kt, int idx, int st) {
    float* buf = ring + st * STAGE;
    if (idx < NK)
      copy_block<kSlab>(buf, kKS, kBK, k, b, kt * kBK, g, idx * kSlab, S,
                        KV, hd, v16);
    else
      copy_block<HDP>(buf, HDP, kSlab, v, b, kt * kBK + (idx - NK) * kSlab,
                      g, 0, S, KV, hd, v16);
    cp_async_commit();
  };
  auto slabs = [&](int kt) {
    return NK + (min(kend - kt * kBK, kBK) + kSlab - 1) / kSlab;
  };
  fetch(lo, 0, 0);

  // the Q tile, scaled (once per block, while the first slab is in flight)
  for (int e = threadIdx.x; e < kBQ * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP, row = q0 + r;
    float x = 0.0f;
    if (row < S && d < hd)
      x = __fmul_rn(q[(((size_t)b * S + row) * H + h) * hd + d], scale);
    Qs[e] = x;
  }

  float acc[kR][NCOL];
  float s[kR][kC];
  float m[kR], l[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[r][c] = 0.0f;
  }

  int st = 0;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    const int ns = slabs(kt);
    for (int idx = 0; idx < ns; ++idx) {
      // slab idx has landed for every thread, and every thread is done
      // with the stage the next copies overwrite (and, at the first V slab,
      // has written its P^T rows)
      cp_async_wait_all();
      __syncthreads();
      {
        int nkt = kt, nidx = idx + 1;
        if (nidx == ns) {
          ++nkt;
          nidx = 0;
        }
        if (nkt < hi) fetch(nkt, nidx, st ^ 1);
      }
      const float* buf = ring + st * STAGE;
      st ^= 1;

      if (idx < NK) {
        // s += Q[:, 32 idx ..] . K_slab^T
        if (idx == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int c = 0; c < kC; ++c) s[r][c] = 0.0f;
        }
        const float* qs = Qs + r0 * HDP + idx * kSlab;
#pragma unroll
        for (int dd = 0; dd < kSlab; dd += 4) {
          float4 qv[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            qv[r] = *reinterpret_cast<const float4*>(qs + r * HDP + dd);
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float4 kv = *reinterpret_cast<const float4*>(
                buf + (lane + 32 * c) * kKS + dd);
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              float a = s[r][c];
              a = __fmaf_rn(qv[r].x, kv.x, a);
              a = __fmaf_rn(qv[r].y, kv.y, a);
              a = __fmaf_rn(qv[r].z, kv.z, a);
              a = __fmaf_rn(qv[r].w, kv.w, a);
              s[r][c] = a;
            }
          }
        }
        if (idx == NK - 1) {
          // cap, mask, online softmax on the register tile; branches are
          // uniform over the warp and sit outside the per-score loops
          if (softcap > 0.0f) {
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
              for (int c = 0; c < kC; ++c)
                s[r][c] = __fmul_rn(softcap,
                                    tanhf(__fmul_rn(s[r][c], inv_cap)));
          }
          if (!(k0 + kBK <= S && (!causal || k0 + kBK - 1 <= rowb) &&
                (window <= 0 || rowb + kR - 1 - k0 < window))) {
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
              for (int c = 0; c < kC; ++c) {
                const int row = rowb + r, col = k0 + lane + 32 * c;
                const bool ok = col < S && (!causal || col <= row) &&
                                (window <= 0 || row - col < window);
                if (!ok) s[r][c] = kMaskValue;
              }
          }
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            float mx = s[r][0];
#pragma unroll
            for (int c = 1; c < kC; ++c) mx = fmaxf(mx, s[r][c]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            const float alpha = expf(__fsub_rn(m[r], m_new));
            m[r] = m_new;
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              const float p = expf(__fsub_rn(s[r][c], m_new));
              s[r][c] = p;
              sum = __fadd_rn(sum, p);
            }
            l[r] = __fadd_rn(__fmul_rn(alpha, l[r]), sum);
#pragma unroll
            for (int c = 0; c < NCOL; ++c)
              acc[r][c] = __fmul_rn(acc[r][c], alpha);
          }
          // P^T: key lane + 32 c, rows r0 .. r0 + 7
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            float* dst = Pt + (lane + 32 * c) * kPS + r0;
            *reinterpret_cast<float4*>(dst) =
                make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
          }
        }
      } else {
        // acc += P[:, keys of the slab] . V_slab
        const float* pt = Pt + (idx - NK) * kSlab * kPS + r0;
#pragma unroll 4
        for (int kk = 0; kk < kSlab; ++kk) {
          const float4 p0 = *reinterpret_cast<const float4*>(pt + kk * kPS);
          const float4 p1 =
              *reinterpret_cast<const float4*>(pt + kk * kPS + 4);
          const float pr[kR] = {p0.x, p0.y, p0.z, p0.w,
                                p1.x, p1.y, p1.z, p1.w};
          const float* vs = buf + kk * HDP + VW * lane;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float vv[VW];
            if constexpr (VW == 4) {
              const float4 t = *reinterpret_cast<const float4*>(vs + 128 * j);
              vv[0] = t.x;
              vv[1] = t.y;
              vv[2] = t.z;
              vv[3] = t.w;
            } else {
              const float2 t = *reinterpret_cast<const float2*>(vs + 64 * j);
              vv[0] = t.x;
              vv[1] = t.y;
            }
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                acc[r][VW * j + e] =
                    __fmaf_rn(pr[r], vv[e], acc[r][VW * j + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, off));
    const int row = rowb + r;
    if (row >= S) continue;
    lt = fmaxf(lt, 1e-30f);
    float* orow = o + (((size_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int d = VW * lane + 32 * VW * j + e;
        if (d < hd) orow[d] = __fdiv_rn(acc[r][VW * j + e], lt);
      }
  }
}

template <int HDP>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int KV, int hd, float scale, int causal, int window,
           float softcap, int vec, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  // set once, outside any graph capture (the first call is never captured)
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_f32_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if ((S + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  fa_f32_kernel<HDP><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, S, H, KV, hd, scale, causal, window, softcap, vec);
  return (int)cudaGetLastError();
}

int dispatch(const float* q, const float* k, const float* v, float* o, int B,
             int S, int H, int KV, int hd, float scale, int causal,
             int window, float softcap, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = hd % 4 == 0 && aligned(q) && aligned(k) && aligned(v);
  if (hd <= 64)
    return launch<64>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                      softcap, vec, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                       softcap, vec, stream);
  return launch<256>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                     softcap, vec, stream);
}

}  // namespace f32

// ---- bf16: the tensor-core kernel ----------------------------------------
//
// What bounds the f32 kernel in bf16 is that it is the f32 kernel: the
// products run on the f32 pipes (67 Tflop/s) where the bf16 tensor cores
// give 989.  Design:
//
// * One block of two warpgroups (256 threads) per (b, h, q tile of 128
//   rows, the TPU kernel's q_block); each warpgroup owns 64 rows.  Blocks
//   walk the q tiles heaviest first (blockIdx.y reversed, heads fastest)
//   so the short causal tiles fill the tail of the grid.
// * Q (128 x HDP) stays in shared memory; K and V tiles of 64 keys pass
//   through a two-stage ring with one __syncthreads per kv tile.  The
//   next tile's 16-byte cp.async copies are issued while the tensor cores
//   run this tile's products (K's during Q K^T, V's during P V).  Tiles
//   are stored in wgmma's 128-byte-swizzled layout: 64-column (128-byte)
//   slabs, 16-byte chunk c of row r at c ^ (r % 8), 1024-byte aligned
//   atoms of 8 rows.  Rows >= S and columns >= hd are zero-filled in
//   shared memory (cp.async with source size 0), so every k-step of 16 is
//   whole; rows that are not whole 16-byte chunks (hd % 8 != 0) or
//   unaligned pointers take an element-by-element copy into the same
//   layout.  Nothing is padded in device memory.
// * S = Q K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory, both
//   K-major, HDP / 16 k-steps.  The scale 1/sqrt(hd) multiplies the f32
//   scores (Q is never rounded again); with a softcap, scale / softcap
//   does, in one product before the precise tanhf (no division per
//   score).  Softcap, masks and the online softmax run in registers on
//   the accumulator fragment, their uniform branches outside the
//   per-score loops: a row's 64 scores lie in the 4 threads of a quad, so
//   row max reduces with two __shfl_xor_sync; the row sum l is kept per
//   thread (from the f32 p) and reduced once at the end.  Tiles wholly
//   inside the masks skip the per-element mask.
// * O += P V: p is rounded to bf16 and packed straight into wgmma's A
//   register fragment (the m64n64 f32 accumulator maps onto it pair by
//   pair); V is B from shared memory in its stored (hd-contiguous,
//   MN-major) layout, the descriptor's transpose bit set.  O (64 x HDP
//   f32 per warpgroup, 128 registers per thread at HDP 256) is rescaled
//   by alpha in registers and issued as HDP / 64 wgmmas of n = 64 per
//   k-step of 16 keys.
// * At HDP 256 the block takes 193 KB of shared memory (Q 64 KB, the
//   ring 2 x (32 + 32) KB, 1 KB of alignment) and 255 registers a thread:
//   one block per SM, no room for a copying warp.  What holds it back at
//   gemma2's layer is the K/V traffic: every block reads 64 KB per kv tile
//   from L2, and the cp.async copies stall the issuing warps (the TMA and
//   a producer warp are the next step).
//
// Rounding against the plain version: q, k, v are bf16 already; the new
// rounding is p in bf16 before P V (l sums the f32 p, as FlashAttention
// does), and the output's bf16; the scores' scaling order and O * (1/l)
// for O / l move the f32 values by an ulp or two.  No atomics: two
// launches give the same bits.

namespace tc {

constexpr int kBQ = 128;       // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // two warpgroups of 64 rows each
constexpr int kAlign = 1024;   // swizzle atom: 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the dynamic shared memory's first 1024-byte aligned address
__device__ __forceinline__ uint32_t smem_base(const void* p) {
  return (smem_u32(p) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
}

// byte offset of 16-byte chunk c (bf16 columns 8c .. 8c + 7) of row r in
// a tile of `rows` rows stored as 128-byte-swizzled 64-column slabs
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// rows x HDP tile of x[b, r0 + r, head, :] (row stride nh * hd) into the
// swizzled tile at shared address dst; rows >= S and columns >= hd are
// zero.  vec: 16-byte cp.async copies (hd % 8 == 0, 16-byte aligned
// base); else element by element.
template <int HDP>
__device__ __forceinline__ void copy_tile(uint32_t dst, int rows,
                                          const __nv_bfloat16* __restrict__ x,
                                          int b, int r0, int head, int S,
                                          int nh, int hd, bool vec, int tid,
                                          int nthr) {
  constexpr int CH = HDP / 8;  // 16-byte chunks per row
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  for (int e = tid; e < rows * CH; e += nthr) {
    const int r = e / CH, c = e % CH;
    const int row = r0 + r;
    const uint32_t d = dst + swz(rows, r, c);
    const size_t base = (((size_t)b * S + (row < S ? row : 0)) * nh + head) *
                        (size_t)hd;
    if (vec) {
      const bool in = row < S && 8 * c < hd;
      const unsigned short* src = xs + base + (in ? 8 * c : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c0 = 8 * c + 2 * k;
        const uint32_t lo = (row < S && c0 < hd) ? xs[base + c0] : 0u;
        const uint32_t hi = (row < S && c0 + 1 < hd) ? xs[base + c0 + 1] : 0u;
        w[k] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies have landed; then make every thread's shared-memory
// writes visible to wgmma (the async proxy) once the caller syncs
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1024
// bytes apart (SBO); lbo is the MN-major slab stride (unused by the
// K-major operands and by n = 64)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// issue / wait points
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n64 f32 accumulator) = [d +] A . B, A and B from shared memory
// (descriptors); TB: B is MN-major (transposed)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// the same with A (m64 x k16 bf16) from registers, in wgmma's A fragment
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

// The m64n64 f32 accumulator fragment: thread t of the warpgroup holds
// d[4 j + 2 i + e] = D[row, col] with row = 16 (t / 32) + (t % 32) / 4 +
// 8 i, col = 8 j + 2 (t % 4) + e.  Keys 16 ks .. 16 ks + 15 of it are the
// k16 A fragment of k-step ks: a[ks][0] = (row, keys 16 ks + 2 (t % 4) +
// {0, 1}), [1] the same at row + 8, [2] and [3] at keys + 8.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void pack_a(const float (&p)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[ks][r] = pack_bf16(p[8 * ks + 2 * r], p[8 * ks + 2 * r + 1]);
}

template <int HDP>
constexpr size_t smem_bytes() {
  // Q tile, two K stages, two V stages, alignment slack
  return (size_t)(kBQ + 4 * kBK) * HDP * 2 + kAlign;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int S, int H, int KV, int hd,
               float scale, int causal, int window, float softcap, int vec) {
  constexpr int NS = HDP / 64;          // 64-column slabs
  constexpr int KS = HDP / 16;          // k-steps of Q K^T
  constexpr uint32_t kTile = kBK * HDP * 2;
  extern __shared__ unsigned char fa_smem[];
  const uint32_t sQ = smem_base(fa_smem);
  const uint32_t sK = sQ + kBQ * HDP * 2;  // stage st at sK + st * kTile
  const uint32_t sV = sK + 2 * kTile;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int rw = q0 + 64 * wg;                       // warpgroup's first row
  const int r_t = rw + 16 * (t / 32) + (t % 32) / 4;  // rows r_t, r_t + 8
  const int c_t = 2 * (t % 4);                       // cols c_t + 8 j + e
  const bool v16 = vec != 0;
  // softcap * tanh(s * scale / softcap) as one product and the precise
  // tanhf: no division per score
  const float cap_scale = softcap > 0.0f ? __fdiv_rn(scale, softcap) : 0.0f;

  // live kv tiles [lo, hi): the TPU kernel's bounds (kernel.py:47-55)
  const int nkv = (S + kBK - 1) / kBK;
  int hi = causal ? (q0 + kBQ - 1) / kBK + 1 : nkv;
  if (hi > nkv) hi = nkv;
  int lo = 0;
  if (window > 0) {
    lo = (q0 - window - kBK + 1) / kBK;  // truncates toward zero
    if (lo < 0) lo = 0;
  }

  copy_tile<HDP>(sQ, kBQ, q, b, q0, h, S, H, hd, v16, tid, kThreads);
  copy_tile<HDP>(sK, kBK, k, b, lo * kBK, g, S, KV, hd, v16, tid, kThreads);
  copy_tile<HDP>(sV, kBK, v, b, lo * kBK, g, S, KV, hd, v16, tid, kThreads);
  cp_async_commit();

  float acc[NS][32];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.0f;
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.0f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.0f, 0.0f};
  const uint32_t qa = sQ + wg * 64 * 128;  // this warpgroup's 64 Q rows

  for (int kt = lo; kt < hi; ++kt) {
    const int st = (kt - lo) & 1;
    const bool more = kt + 1 < hi;
    // tile kt has landed for every thread, and every warpgroup is done
    // with tile kt - 1, whose stage the next copies overwrite
    cp_async_wait_all();
    __syncthreads();
    const uint32_t ka = sK + st * kTile, va = sV + st * kTile;

    // s = Q K^T (64 x 64 per warpgroup), f32; K of tile kt + 1 is copied
    // while the tensor cores run it
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss<0>(s, desc(qa + (kk >> 2) * kBQ * 128 + off, 16),
                  desc(ka + (kk >> 2) * kBK * 128 + off, 16), kk > 0);
    }
    wg_commit();
    if (more)
      copy_tile<HDP>(sK + (st ^ 1) * kTile, kBK, k, b, (kt + 1) * kBK, g, S,
                     KV, hd, v16, tid, kThreads);
    wg_wait_all();
    reg_fence(s);

    // scale and cap, mask, online softmax on the fragment; the branches
    // are uniform and sit outside the per-score loops
    if (softcap > 0.0f) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] = __fmul_rn(softcap, tanhf(__fmul_rn(s[e], cap_scale)));
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = __fmul_rn(s[e], scale);
    }
    const int k0 = kt * kBK;
    if (!(k0 + kBK <= S && (!causal || k0 + kBK - 1 <= rw) &&
          (window <= 0 || rw + 63 - k0 < window))) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r_t + 8 * i, col = k0 + 8 * j + c_t + e;
            const bool ok = col < S && (!causal || col <= row) &&
                            (window <= 0 || row - col < window);
            if (!ok) s[4 * j + 2 * i + e] = kMaskValue;
          }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(__fsub_rn(m[i], mx[i]));
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(__fsub_rn(s[4 * j + 2 * i + e], m[i]));
          s[4 * j + 2 * i + e] = p;
          sum[i] = __fadd_rn(sum[i], p);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), sum[i]);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[n][4 * j + 2 * i + e] =
                __fmul_rn(acc[n][4 * j + 2 * i + e], alpha[i]);
    uint32_t pa[4][4];
    pack_a(s, pa);

    // acc += P V: per k-step of 16 keys, one n64 wgmma per slab of V; V
    // of tile kt + 1 is copied while the tensor cores run it
#pragma unroll
    for (int n = 0; n < NS; ++n) reg_fence(acc[n]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        wgmma_rs<1>(acc[n], pa[ks],
                    desc(va + n * kBK * 128 + ks * 16 * 128, kBK * 128), 1);
    wg_commit();
    if (more)
      copy_tile<HDP>(sV + (st ^ 1) * kTile, kBK, v, b, (kt + 1) * kBK, g, S,
                     KV, hd, v16, tid, kThreads);
    cp_async_commit();
    wg_wait_all();
#pragma unroll
    for (int n = 0; n < NS; ++n) reg_fence(acc[n]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
    const float inv = __frcp_rn(fmaxf(lt, 1e-30f));
    const int row = r_t + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (((size_t)b * S + row) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * n + 8 * j + c_t;
        const float o0 = __fmul_rn(acc[n][4 * j + 2 * i], inv);
        const float o1 = __fmul_rn(acc[n][4 * j + 2 * i + 1], inv);
        if (v16) {
          if (d < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(o0, o1);
        } else {
          if (d < hd) orow[d] = __float2bfloat16_rn(o0);
          if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(o1);
        }
      }
  }
}

template <int HDP>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S, int H,
           int KV, int hd, float scale, int causal, int window, float softcap,
           int vec, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  // set once, outside any graph capture (the first call is never captured)
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if ((S + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  fa_bf16_kernel<HDP><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, S, H, KV, hd, scale, causal, window, softcap, vec);
  return (int)cudaGetLastError();
}

int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S, int H,
             int KV, int hd, float scale, int causal, int window,
             float softcap, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(o);
  if (hd <= 64)
    return launch<64>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                      softcap, vec, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                       softcap, vec, stream);
  return launch<256>(q, k, v, o, B, S, H, KV, hd, scale, causal, window,
                     softcap, vec, stream);
}

// Layout probe (a test aid; nothing on the main path calls it): one
// warpgroup runs the kernel's wgmma forms on bf16 tiles through the same
// copies, descriptors and fragment maps.  A is 64 x KD (K-major shared,
// or registers packed from an accumulator fragment as P is); B is N x KD
// (K-major, as K) or KD x N (MN-major, as V); d = A B (64 x N, f32).
template <bool AREG, bool BMN, int KD>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ d) {
  constexpr int N = BMN ? 256 : 64;
  constexpr int NS = N / 64;
  extern __shared__ unsigned char fa_smem[];
  const uint32_t sA = smem_base(fa_smem);
  const uint32_t sB = sA + 64 * KD * 2;
  const int t = threadIdx.x;
  const int r_t = 16 * (t / 32) + (t % 32) / 4, c_t = 2 * (t % 4);
  if (!AREG) copy_tile<KD>(sA, 64, a, 0, 0, 0, 64, 1, KD, true, t, 128);
  if (BMN)
    copy_tile<N>(sB, KD, b, 0, 0, 0, KD, 1, N, true, t, 128);
  else
    copy_tile<KD>(sB, 64, b, 0, 0, 0, 64, 1, KD, true, t, 128);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t pa[KD / 64][4][4];
  if constexpr (AREG) {
#pragma unroll
    for (int kb = 0; kb < KD / 64; ++kb) {
      float p[32];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            p[4 * j + 2 * i + e] = __bfloat162float(
                a[(r_t + 8 * i) * KD + 64 * kb + 8 * j + c_t + e]);
      pack_a(p, pa[kb]);
    }
  }
  float acc[NS][32];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.0f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const uint64_t db =
          BMN ? desc(sB + n * KD * 128 + kk * 16 * 128, KD * 128)
              : desc(sB + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16);
      if constexpr (AREG)
        wgmma_rs<BMN ? 1 : 0>(acc[n], pa[kk >> 2][kk & 3], db, kk > 0);
      else
        wgmma_ss<BMN ? 1 : 0>(
            acc[n], desc(sA + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16), db,
            kk > 0);
    }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int n = 0; n < NS; ++n) reg_fence(acc[n]);
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          d[(r_t + 8 * i) * N + 64 * n + 8 * j + c_t + e] =
              acc[n][4 * j + 2 * i + e];
}

template <bool AREG, bool BMN, int KD>
int probe(const __nv_bfloat16* a, const __nv_bfloat16* b, float* d,
          cudaStream_t stream) {
  const int bytes = 64 * KD * 2 + (BMN ? KD * 256 : 64 * KD) * 2 + kAlign;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel<AREG, BMN, KD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wgmma_probe_kernel<AREG, BMN, KD><<<1, 128, bytes, stream>>>(a, b, d);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
    return tc::dispatch(static_cast<const __nv_bfloat16*>(q),
                        static_cast<const __nv_bfloat16*>(k),
                        static_cast<const __nv_bfloat16*>(v),
                        static_cast<__nv_bfloat16*>(o), B, S, H, KV, hd,
                        scale, causal, window, softcap, stream);
  return f32::dispatch(static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(o),
                       B, S, H, KV, hd, scale, causal, window, softcap,
                       stream);
}

// The wgmma layout probe (tc::wgmma_probe_kernel), a test aid.  a, b:
// bf16, 16-byte aligned; d: f32 (64, N).  form 0: A shared K-major (64 x
// 256) . B shared K-major (64 x 256)^T, N = 64 (the kernel's Q K^T); 1: A
// registers (64 x 64) . B shared MN-major (64 x 256), N = 256 (its P V);
// 2: A registers (64 x 64) . B K-major (64 x 64)^T, N = 64; 3: A shared
// K-major (64 x 64) . B MN-major (64 x 256), N = 256.
int fa_wgmma_probe(const void* a, const void* b, float* d, int form,
                   cudaStream_t stream) {
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  switch (form) {
    case 0: return tc::probe<false, false, 256>(pa, pb, d, stream);
    case 1: return tc::probe<true, true, 64>(pa, pb, d, stream);
    case 2: return tc::probe<true, false, 64>(pa, pb, d, stream);
    case 3: return tc::probe<false, true, 64>(pa, pb, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
