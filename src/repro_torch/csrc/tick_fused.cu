// Fused device-tick kernels for Hopper (sm_90a): the server's step of a
// tick, the ISRRECEIVE delivery gather, and the round-completion ring
// scatter.
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
// server_apply is the server's whole step of a tick in one launch (the
// bucket_apply of the reference, with everything the engine does around
// it): it reads the due ring slot and the due overflow entry once, applies
// them to v (decayed per sender-k stratum under FedAsync, banked and
// flushed under FedBuff), resets the slot and the overflow row in place
// and writes v' into the fired broadcast rows in place.  Its flags are
// read on the device.  Each thread owns whole columns (16-byte groups
// where every row is 16-byte aligned), so nothing crosses threads; a
// grid-stride loop over at most a few blocks per SM spreads a model-sized
// D over the card.
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
// The rows pass and the finish are also entry points of their own
// (tf_scatter_rows, tf_scatter_finish): the cohort engines launch them
// apart, so a client axis cut over ranks can run the rows pass on each
// rank's rows under the WHOLE axis's partition (rows per block given,
// row 0 at a given position of its block, block 0 started from a given
// carry: the running sum of that block's rows on the ranks before) and
// gather the block partials before the finish.  Uncut, the two launches
// are tf_tick_scatter's, with the same bits.
//
// Rounding: every product and sum is an explicit round-to-nearest
// intrinsic (__fmul_rn / __fadd_rn / __fsub_rn), which nvcc never
// contracts into an FMA; the file is also built with -fmad=false.  So
// server_apply, tick_deliver and the w/U outputs of tick_scatter round
// exactly like PyTorch's eager plain versions and match them bit for
// bit; the scatter sums differ from torch.sum only in their add order,
// which kernels/tick_fused/ref.py's tick_scatter_twin repeats exactly.
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

// The operands of one server step.  due [A, D]: the due ring slot (A == 1,
// or R sender-k strata under FedAsync); ovf [Q, A, D] with ovf_hit [Q]:
// the overflow bucket and its due entry (null: no far tier); buf [D] with
// flush: FedBuff's buffer (null: no buffer); bc [B, D] with fired [B]: the
// broadcast rows (null: no cascade this tick).  reset: zero the slot and
// the due overflow row after reading them.
struct ServerStep {
  const float* v;
  float* due;
  const float* dec;
  const bool* has_arr;
  float* ovf;
  const bool* ovf_hit;
  float* buf;
  const bool* flush;
  float* bc;
  const bool* fired;
  float* out;
  long long D;
  int A, Q, B, reset;
};

// W consecutive columns of one row: a 16-byte group (W == 4) or one
// column (W == 1)
template <int W>
struct Cols {
  float x[W];
};

template <int W>
__device__ __forceinline__ Cols<W> load_cols(const float* p) {
  Cols<W> r;
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.x[0] = t.x;
    r.x[1] = t.y;
    r.x[2] = t.z;
    r.x[3] = t.w;
  } else {
    r.x[0] = *p;
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const Cols<W>& r) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.x[0], r.x[1], r.x[2],
                                                r.x[3]);
  else
    *p = r.x[0];
}

template <int W>
__device__ __forceinline__ void zero_cols(float* p) {
  Cols<W> z;
#pragma unroll
  for (int k = 0; k < W; ++k) z.x[k] = 0.0f;
  store_cols<W>(p, z);
}

// stratum a of the due bucket at column d: the due overflow entry's row
// plus 0.0 (so -0.0 reads as +0.0, the reference's masked sum over the
// overflow bucket; +0.0 when no entry is due), then the ring slot's row
template <int W>
__device__ __forceinline__ Cols<W> due_cols(const ServerStep& s, int hit,
                                            int a, long long d) {
  Cols<W> r = load_cols<W>(s.due + (long long)a * s.D + d);
  if (s.ovf != nullptr) {
    Cols<W> o;
    if (hit >= 0) {
      o = load_cols<W>(s.ovf + ((long long)hit * s.A + a) * s.D + d);
#pragma unroll
      for (int k = 0; k < W; ++k) o.x[k] = __fadd_rn(o.x[k], 0.0f);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) o.x[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) r.x[k] = __fadd_rn(o.x[k], r.x[k]);
  }
  return r;
}

// One server step over ngroups groups of W columns:
//   due[a] = [ovf[hit, a] + 0.0 +] slot[a]
//   FedBuff: buf' = has_arr ? buf + due[0] : buf;
//            v' = flush ? v - buf' * dec[0] : v;  buf'' = flush ? 0 : buf'
//   else:    v' = has_arr ? v - sum_a due[a] * dec[a] : v
// The sum: A == 1 scales the single row (no 0.0 + x that would flip a
// -0.0 row); A > 1 adds 0.0 + t_0 + t_1 + ... in ascending a, the order
// of torch.sum over the strata.  Rows that the step does not need are not
// read (the slot on a tick without arrivals); rows it resets are written
// whatever the flags.
template <int W>
__global__ void __launch_bounds__(256) server_apply_kernel(ServerStep s,
                                                           long long ngroups) {
  __shared__ int s_hit;
  if (s.ovf != nullptr && threadIdx.x < 32) {
    // the first due overflow entry (the engine has at most one)
    int found = -1;
    for (int base = 0; base < s.Q && found < 0; base += 32) {
      const int q = base + (int)threadIdx.x;
      const unsigned m = __ballot_sync(0xffffffffu, q < s.Q && s.ovf_hit[q]);
      if (m) found = base + __ffs(m) - 1;
    }
    if (threadIdx.x == 0) s_hit = found;
  }
  __syncthreads();
  const int hit = s.ovf != nullptr ? s_hit : -1;
  const bool arr = *s.has_arr;
  const bool buffered = s.buf != nullptr;
  const bool apply = buffered ? *s.flush : arr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < ngroups; g += stride) {
    const long long d = g * W;
    const Cols<W> vd = load_cols<W>(s.v + d);
    Cols<W> o = vd;
    if (buffered) {
      if (arr || apply) {
        Cols<W> b = load_cols<W>(s.buf + d);
        if (arr) {
          const Cols<W> r = due_cols<W>(s, hit, 0, d);
#pragma unroll
          for (int k = 0; k < W; ++k) b.x[k] = __fadd_rn(b.x[k], r.x[k]);
        }
        if (apply) {
          const float w0 = s.dec[0];
#pragma unroll
          for (int k = 0; k < W; ++k) {
            o.x[k] = __fsub_rn(vd.x[k], __fmul_rn(b.x[k], w0));
            b.x[k] = 0.0f;
          }
        }
        store_cols<W>(s.buf + d, b);
      }
    } else if (apply) {
      Cols<W> c{};
      for (int a = 0; a < s.A; ++a) {
        const Cols<W> r = due_cols<W>(s, hit, a, d);
        const float wa = s.dec[a];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float t = __fmul_rn(r.x[k], wa);
          c.x[k] = a > 0 ? __fadd_rn(c.x[k], t)
                         : (s.A == 1 ? t : __fadd_rn(0.0f, t));
        }
      }
#pragma unroll
      for (int k = 0; k < W; ++k) o.x[k] = __fsub_rn(vd.x[k], c.x[k]);
    }
    store_cols<W>(s.out + d, o);
    if (s.reset) {
      for (int a = 0; a < s.A; ++a)
        zero_cols<W>(s.due + (long long)a * s.D + d);
      if (hit >= 0)
        for (int a = 0; a < s.A; ++a)
          zero_cols<W>(s.ovf + ((long long)hit * s.A + a) * s.D + d);
    }
    if (s.bc != nullptr)
      for (int b = 0; b < s.B; ++b)
        if (s.fired[b]) store_cols<W>(s.bc + (long long)b * s.D + d, o);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
  }
  return n;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte groups when every row starts on a 16-byte boundary, else one
// column a thread; at most 8 blocks of 256 threads per SM, each thread
// walking its groups with the grid's stride
int launch_server(const ServerStep& s, cudaStream_t stream) {
  if (s.D <= 0) return 0;
  const bool vec = s.D % 4 == 0 && aligned16(s.v) && aligned16(s.due) &&
                   aligned16(s.ovf) && aligned16(s.buf) && aligned16(s.bc) &&
                   aligned16(s.out);
  const long long groups = vec ? s.D / 4 : s.D;
  const long long want = (groups + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)(want < 8LL * sm_count() ? want : 8LL * sm_count());
  if (vec)
    server_apply_kernel<4><<<blocks, kThreads, 0, stream>>>(s, groups);
  else
    server_apply_kernel<1><<<blocks, kThreads, 0, stream>>>(s, groups);
  return (int)cudaGetLastError();
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
    float* __restrict__ partial, const float* __restrict__ carry, int C,
    int D, int G, int slab, int ld, int rows_per_block, int off, int ldw,
    int dp_on, int vec) {
  constexpr int TR = kScatterTileRows;
  constexpr int NC = rowtiles::kColsPerThread;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool sdone[3][TR];
  const int sf = scatter_stage_floats(KG, ld);
  // slabs on x (up to 2^31 - 1 of them: a model-sized D has ~10^6),
  // row blocks on y (at most kMaxBlocks); row 0 at position off of block 0
  const int rb0 = max(0, (int)blockIdx.y * rows_per_block - off);
  const int rb1 = min((int)blockIdx.y * rows_per_block - off + rows_per_block,
                      C);
  // block 0 starts its sums from carry (the running sums of its rows
  // before row 0), where given
  const bool from_carry = carry != nullptr && blockIdx.y == 0;
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
                               : wgt + (size_t)(g0 + k - 1) * ldw + r0 + i);
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
  if (from_carry) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = tid + k * blockDim.x;
      if (c >= len) continue;
#pragma unroll
      for (int j = 0; j < KG; ++j)
        if (j < gn) acc[k][j] = carry[(size_t)(g0 + j) * D + c0 + c];
    }
  }
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
    // the block's first row (or the carry) starts each sum (no 0.0f + x)
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
          acc[k][j] = t == 0 && i == 0 && !from_carry
                          ? term
                          : __fadd_rn(acc[k][j], term);
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

// The rows pass over (row blocks, column slabs, chunks of KG ring rows):
// n rows, row 0 at position off of its block, block 0 started from carry
// where given; wgt's rows ldw apart.  vec: w, U and both outputs share
// sent's alignment within 16 bytes, so w' and U' go out as 16-byte stores.
template <int KG>
int launch_rows(const float* sent, const float* w, const float* U,
                const float* wgt, const bool* done, const float* eta,
                float* w_out, float* u_out, float* partial,
                const float* carry, int n, int D, int G, int ldw, int rb,
                int off, int dp_on, cudaStream_t stream) {
  const int blocks = (off + n + rb - 1) / rb;
  if (n <= 0 || blocks <= 0) return 0;
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
  const dim3 grid(sl.count, blocks, G > KG ? (G + KG - 1) / KG : 1);
  tick_scatter_rows_kernel<KG><<<grid, sl.threads, bytes, stream>>>(
      sent, w, U, wgt, done, eta, w_out, u_out, partial, carry, n, D, G,
      sl.width, sl.ld, rb, off, ldw, dp_on, vec);
  return (int)cudaGetLastError();
}

int rows_pass(const float* sent, const float* w, const float* U,
              const float* wgt, const bool* done, const float* eta,
              float* w_out, float* u_out, float* partial, const float* carry,
              int n, int D, int G, int ldw, int rb, int off, int dp_on,
              cudaStream_t stream) {
  return G <= 2 ? launch_rows<2>(sent, w, U, wgt, done, eta, w_out, u_out,
                                 partial, carry, n, D, G, ldw, rb, off, dp_on,
                                 stream)
                : launch_rows<8>(sent, w, U, wgt, done, eta, w_out, u_out,
                                 partial, carry, n, D, G, ldw, rb, off, dp_on,
                                 stream);
}

}  // namespace

extern "C" {

// bucket_apply: the server step with only the apply (no slot or overflow
// reset, no buffer, no broadcast rows): v' = v - sum_a rows[a] * dec[a]
// where *flag
int tf_bucket_apply(const float* v, const float* rows, const float* dec,
                    const bool* flag, float* out, int A, long long D,
                    cudaStream_t stream) {
  ServerStep s{v,       const_cast<float*>(rows), dec, flag, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, out, D, A, 0, 0, 0};
  return launch_server(s, stream);
}

int tf_server_apply(const float* v, float* due, const float* dec,
                    const bool* has_arr, float* ovf, const bool* ovf_hit,
                    float* buf, const bool* flush, float* bc,
                    const bool* fired, float* out, int A, int Q, int B,
                    long long D, int reset, cudaStream_t stream) {
  ServerStep s{v,     due,   dec, has_arr, ovf, ovf_hit, buf, flush,
               bc,    fired, out, D,       A,   Q,       B,   reset};
  return launch_server(s, stream);
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

// the fused pass pair: the rows pass under C's own partition, then the
// finish over its partials into upd_out
int tf_tick_scatter(const float* sent, const float* w, const float* U,
                    const float* upd, const float* wgt, const bool* any_g,
                    const bool* done, const float* eta, float* w_out,
                    float* u_out, float* upd_out, float* partial, int C,
                    int D, int G, int dp_on, cudaStream_t stream) {
  if (D <= 0) return 0;
  const rowtiles::Partition part = rowtiles::partition(C, kScatterTileRows);
  const int err = rows_pass(sent, w, U, wgt, done, eta, w_out, u_out,
                            partial, nullptr, C, D, G, C,
                            part.rows_per_block, 0, dp_on, stream);
  if (err != 0) return err;
  return (int)rowtiles::launch_finish(partial, upd, any_g, upd_out,
                                      part.blocks, G, D, stream);
}

// The rows pass alone: n rows (pointers at the first), row 0 at position
// off of its block of rb rows, block 0 from carry [G, D] where not null;
// w', U' and the partials [(off + n + rb - 1) / rb, G, D]
int tf_scatter_rows(const float* sent, const float* w, const float* U,
                    const float* wgt, const bool* done, const float* eta,
                    float* w_out, float* u_out, float* partial,
                    const float* carry, int n, int D, int G, int ldw, int rb,
                    int off, int dp_on, cudaStream_t stream) {
  if (D <= 0) return 0;
  if (rb <= 0 || off < 0 || off >= rb) return (int)cudaErrorInvalidValue;
  return rows_pass(sent, w, U, wgt, done, eta, w_out, u_out, partial, carry,
                   n, D, G, ldw, rb, off, dp_on, stream);
}

// The finish pass alone over nblk partials [nblk, G, D]: rows g < nupd
// start from upd (null: none do) where any_g, the others are the sums
int tf_scatter_finish(const float* partial, const float* upd, int nupd,
                      const bool* any_g, float* out, int nblk, int G, int D,
                      cudaStream_t stream) {
  return (int)rowtiles::launch_finish(partial, upd, any_g, out, nblk, G, D,
                                      stream, upd ? nupd : 0);
}

}  // extern "C"
