// Backward of window (local) and segment (global) attention for Hopper,
// bf16 in and out, fp32 accumulation.
//
// Replaces the TPU kernels of the JAX package's ops/flash_attention_bwd.py
//   _dq_fused_kernel, _dkv_fused_kernel (driven by _window_fused_bwd)
//       -> cm3p_window_attention_dq, cm3p_window_attention_dkv
//   _dq_unrolled_kernel, _dkv_unrolled_kernel (driven by _global_unrolled_bwd)
//       -> cm3p_segment_attention_dq, cm3p_segment_attention_dkv
// each in two forms. Without tables q and k arrive rotated (rope applied
// outside the kernels: layers whose positions are not arange, as the
// metadata tower's) and dq/dk leave with respect to the rotated q/k. With the
// fp32 (L, 32) cos/sin tables (the training route elsewhere: the fuse_rope
// branch of each TPU kernel, CM3P_TRAIN_FUSED_ROPE) q and k arrive
// raw: every q/k tile is rotated as it is staged, with the forward's
// arithmetic (rope8 of csrc/attention_fwd.cuh, so the recomputed scores equal
// the forward's bit for bit and p matches the lse it wrote), and dq/dk are
// counter-rotated on the fp32 accumulators before the bf16 store, so they
// leave with respect to the raw q/k.
//
// Math (flash_attention_bwd.py module docstring), per head, with the forward's
// base-2 lse (csrc/attention.cu) and delta = rowsum(dout * out) in fp32:
//   s2 = (q . k) * log2(e) / sqrt(64)       scores in base-2 units
//   p  = exp2(s2 - lse)                      0 where the mask hides the key
//   dv = p^T . dout
//   ds = p * (dout . v^T - delta)            the gradient of the natural scores
//   dq = ds . k / sqrt(64),   dk = ds^T . q / sqrt(64)
// (q and k rotated). The counter-rotation is rope's transpose at each row's
// position: with g1 = d[c] and g2 = d[c + 32], c < 32,
//   d[c] <- g1 cos + g2 sin,   d[c + 32] <- g2 cos - g1 sin.
// The mask is the forward's: key j is visible to query i iff j < L,
// kseg[j] > 0, qseg[i] == kseg[j] and, for the window kernels, |i - j| <= w.
// A query that sees no key gets dq = 0 exactly; a key no query sees gets
// dk = dv = 0. p and ds are rounded to bf16 before their products (as the
// forward rounds p before p . v); every product accumulates in fp32.
//
// Design: the standard two-kernel flash backward, each a template over the
// mask type like the forward's attention_kernel<WINDOW> and over ROPE.
//   dq kernel : one block of 4 warps per (query tile of 64, head, row). Each
//               warp keeps its 16 rows of q and dout as mma fragments in
//               registers and streams key tiles (k row-major and transposed,
//               v row-major in shared memory), accumulating dq in registers.
//   dkv kernel: one block per (key tile of 64, head, row). Each warp keeps its
//               16 rows of k and v as fragments and streams query tiles (q and
//               dout row-major and transposed, lse and delta per query),
//               accumulating dk and dv in registers.
// Tile ranges: the window kernels visit the tiles meeting [t0 - w, t0 + 63 + w]
// (3 tiles at w = 64; any w, so windows wider than 128, the TPU's streaming
// _dq_kernel / _dkv_kernel route, run here too); the segment kernels visit the
// range [start, start + count) the wrapper computes from the segment ids
// (segment_tile_ranges, with the q/k roles swapped for dkv: the work of
// qb_index in _global_unrolled_bwd).
// Products are mma.sync m16n8k16 bf16 -> fp32.
// Bound on the H100: per visible (query, key) pair and head, 5 products of
// depth 64 (s, dp, dv, dq, dk) = 10 * 64 flops against ~16 bytes per position
// and head, so a window of 129 keys sits near the ridge and the segment kernels
// are bound by the tensor cores; this first kernel has no load/compute overlap
// and stores transposed tiles with scalar writes, so it runs well below that.
// The rope forms add, per staged q/k tile, 64 x 32 rotations in fp32 (with
// 16 KB of table reads, from L2) to the same staging step: the rotation is
// paid once per tile visit, not once per position as an outside rope pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

using namespace cm3p;

constexpr int D = 64;          // head dim
constexpr int BT = 64;         // query and key tile
constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int LDS = D + 8;     // padded smem row (bf16), 144 bytes
constexpr int LDT = BT + 8;    // padded row of a transposed tile

// 64 positions x 64 dims from pos0 into smem rows (stride LDS); zeros past L.
__device__ __forceinline__ void load_rows(__nv_bfloat16* sm, const __nv_bfloat16* base,
                                          long long pos_stride, int pos0, int L) {
  for (int item = threadIdx.x; item < BT * (D / 8); item += NTHREADS) {
    const int r = item >> 3;
    const int c = (item & 7) * 8;
    const int pos = pos0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (pos < L) u = *reinterpret_cast<const uint4*>(base + (long long)pos * pos_stride + c);
    *reinterpret_cast<uint4*>(sm + r * LDS + c) = u;
  }
}

// The same tile stored both row-major (sm[pos][dim]) and transposed
// (smt[dim][pos], row stride LDT).
__device__ __forceinline__ void load_rows_both(__nv_bfloat16* sm, __nv_bfloat16* smt,
                                               const __nv_bfloat16* base, long long pos_stride,
                                               int pos0, int L) {
  for (int item = threadIdx.x; item < BT * (D / 8); item += NTHREADS) {
    const int r = item >> 3;
    const int c = (item & 7) * 8;
    const int pos = pos0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (pos < L) u = *reinterpret_cast<const uint4*>(base + (long long)pos * pos_stride + c);
    *reinterpret_cast<uint4*>(sm + r * LDS + c) = u;
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) smt[(c + i) * LDT + r] = hv[i];
  }
}

// The tile rotated with rope (the forward's loader and bits), stored row-major
// and, when smt is not null, also transposed.
__device__ __forceinline__ void load_rows_rope_both(__nv_bfloat16* sm, __nv_bfloat16* smt,
                                                    const __nv_bfloat16* base, long long pos_stride,
                                                    int pos0, int L, const float* cos_t,
                                                    const float* sin_t) {
  static_assert(NTHREADS == attn::GROUP && LDS == attn::LDS, "the forward loader's thread count and row");
  attn::load_rows_rope(sm, LDS, base, pos_stride, pos0, L, cos_t, sin_t, threadIdx.x, smt, LDT);
}

// This warp's 16 rows (r0..r0+15) of a row-major smem tile as A fragments.
__device__ __forceinline__ void load_a_frags(uint32_t fa[4][4], const __nv_bfloat16* sm, int r0,
                                             int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    fa[ks][0] = lds32(&sm[(r0 + g) * LDS + ks * 16 + t * 2]);
    fa[ks][1] = lds32(&sm[(r0 + g + 8) * LDS + ks * 16 + t * 2]);
    fa[ks][2] = lds32(&sm[(r0 + g) * LDS + ks * 16 + t * 2 + 8]);
    fa[ks][3] = lds32(&sm[(r0 + g + 8) * LDS + ks * 16 + t * 2 + 8]);
  }
}

// c[8][4] (16 rows x 64 cols) = A (16 x 64, fragments) . B^T with B a
// row-major smem tile of 64 rows (the n index) x 64 dims.
__device__ __forceinline__ void mma_rows(float c[8][4], const uint32_t fa[4][4],
                                         const __nv_bfloat16* sb, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const __nv_bfloat16* bp = &sb[(nt * 8 + g) * LDS + ks * 16 + t * 2];
      mma_bf16(c[nt], fa[ks], lds32(bp), lds32(bp + 8));
    }
  }
}

// acc[8][4] (16 x 64 dims) += X (16 x 64 positions, C fragments in x) . M
// with M (64 positions x 64 dims) stored transposed in smem (smt[dim][pos]).
__device__ __forceinline__ void mma_acc_transposed(float acc[8][4], const float x[8][4],
                                                   const __nv_bfloat16* smt, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    xa[1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    xa[2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    xa[3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const __nv_bfloat16* bp = &smt[(dt * 8 + g) * LDT + ks * 16 + t * 2];
      mma_bf16(acc[dt], xa, lds32(bp), lds32(bp + 8));
    }
  }
}

// Rope's transpose on the fp32 accumulators of 16 rows x 64 dims (rows
// row0 + g and row0 + g + 8): the gradient with respect to the raw rows from
// the one with respect to the rotated rows. In the C-fragment layout dim c < 32
// (n-tile dt) and its partner c + 32 (n-tile dt + 4) sit in the same thread.
__device__ __forceinline__ void counter_rotate(float acc[8][4], const float* cos_t, const float* sin_t,
                                               int row0, int L, int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + hr * 8;
    if (row >= L) continue;
    const float* ct = cos_t + (long long)row * (D / 2);
    const float* st = sin_t + (long long)row * (D / 2);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = dt * 8 + t * 2 + e2;
        const int e = 2 * hr + e2;
        const float g1 = acc[dt][e], g2 = acc[dt + 4][e], cs = ct[c], sn = st[c];
        acc[dt][e] = g1 * cs + g2 * sn;
        acc[dt + 4][e] = g2 * cs - g1 * sn;
      }
    }
  }
}

// Store 16 rows x 64 dims of acc * scale as bf16 into (B, L, H, 64) output.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float acc[8][4], float scale,
                                           int b, int h, int H, int L, int row0, int g, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + g + hr * 8;
    if (row >= L) continue;
    __nv_bfloat16* op = out + (((long long)b * L + row) * H + h) * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<uint32_t*>(op + dt * 8) =
          pack_bf16(acc[dt][2 * hr] * scale, acc[dt][2 * hr + 1] * scale);
  }
}

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;                     // (B, L, H, 64) contiguous
  long long q_bstride, k_bstride, v_bstride;     // elements between batch rows
  long long q_pstride, k_pstride, v_pstride;     // elements between positions
  const float* lse;                              // (B, H, L) base 2
  const float* delta;                            // (B, H, L)
  const int* qseg;                               // (B, L)
  const int* kseg;                               // (B, L)
  const int* tile_start;                         // (B, ntiles), segment kernels only
  const int* tile_count;
  const float* cos_t;                            // (L, 32) rope tables, rope forms only
  const float* sin_t;
  __nv_bfloat16* dq;                             // (B, L, H, 64) contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int L, H, window;
};

constexpr float SCALE = 0.125f;                        // 1/sqrt(64)
constexpr float SCALE2 = 0.125f * 1.4426950408889634f;  // 1/sqrt(64) * log2(e)

// [begin, end) of the tiles of the other role this tile visits.
template <bool WINDOW>
__device__ __forceinline__ void tile_range(const BwdArgs& a, int tile, int b, int ntiles, int& begin,
                                           int& end) {
  if (WINDOW) {
    const int t0 = tile * BT;
    const int lo = max(0, t0 - a.window);
    const int hi = min(a.L - 1, t0 + BT - 1 + a.window);
    begin = lo / BT;
    end = hi / BT + 1;
  } else {
    begin = a.tile_start[b * ntiles + tile];
    end = begin + a.tile_count[b * ntiles + tile];
  }
}

template <bool WINDOW, bool ROPE>
__global__ void __launch_bounds__(NTHREADS) attention_dq_kernel(BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 sK[BT * LDS];   // also stages q at the start
  __shared__ __align__(16) __nv_bfloat16 sKt[D * LDT];
  __shared__ __align__(16) __nv_bfloat16 sV[BT * LDS];   // also stages dout at the start
  __shared__ int sKseg[BT];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, H = a.H;
  const int q0 = qt * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  const __nv_bfloat16* kbase = a.k + (long long)b * a.k_bstride + h * D;
  const __nv_bfloat16* vbase = a.v + (long long)b * a.v_bstride + h * D;
  const int* kseg = a.kseg + (long long)b * L;

  const __nv_bfloat16* qbase = a.q + (long long)b * a.q_bstride + h * D;
  if (ROPE)
    load_rows_rope_both(sK, nullptr, qbase, a.q_pstride, q0, L, a.cos_t, a.sin_t);
  else
    load_rows(sK, qbase, a.q_pstride, q0, L);
  load_rows(sV, a.dout + (long long)b * L * H * D + h * D, (long long)H * D, q0, L);
  __syncthreads();
  uint32_t qa[4][4], doa[4][4];
  load_a_frags(qa, sK, r0, g, t);
  load_a_frags(doa, sV, r0, g, t);

  int qi[2], qs[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + r0 + g + hr * 8;
    const bool in = qi[hr] < L;
    qs[hr] = in ? a.qseg[(long long)b * L + qi[hr]] : -1;
    const long long li = ((long long)b * H + h) * L + qi[hr];
    lse[hr] = in ? a.lse[li] : 0.f;
    dlt[hr] = in ? a.delta[li] : 0.f;
  }

  int kt_begin, kt_end;
  tile_range<WINDOW>(a, qt, b, gridDim.x, kt_begin, kt_end);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // every warp is done with the previous tile (and the staging)
    if (ROPE)
      load_rows_rope_both(sK, sKt, kbase, a.k_pstride, k0, L, a.cos_t, a.sin_t);
    else
      load_rows_both(sK, sKt, kbase, a.k_pstride, k0, L);
    load_rows(sV, vbase, a.v_pstride, k0, L);
    for (int r = threadIdx.x; r < BT; r += NTHREADS) sKseg[r] = (k0 + r < L) ? kseg[k0 + r] : 0;
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows(s, qa, sK, g, t);
    mma_rows(dp, doa, sV, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int hr = e >> 1;
        const int ksg = sKseg[col];
        bool ok = ksg > 0 && ksg == qs[hr];
        if (WINDOW) ok = ok && abs(qi[hr] - (k0 + col)) <= a.window;
        const float p = ok ? exp2f(s[nt][e] * SCALE2 - lse[hr]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[hr]);  // ds
      }
    }
    mma_acc_transposed(acc, s, sKt, g, t);
  }
  if (ROPE) counter_rotate(acc, a.cos_t, a.sin_t, q0 + r0, L, g, t);
  store_rows(a.dq, acc, SCALE, b, h, H, L, q0 + r0, g, t);
}

template <bool WINDOW, bool ROPE>
__global__ void __launch_bounds__(NTHREADS) attention_dkv_kernel(BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BT * LDS];   // also stages k at the start
  __shared__ __align__(16) __nv_bfloat16 sQt[D * LDT];
  __shared__ __align__(16) __nv_bfloat16 sO[BT * LDS];   // dout; also stages v at the start
  __shared__ __align__(16) __nv_bfloat16 sOt[D * LDT];
  __shared__ int sQseg[BT];
  __shared__ float sLse[BT];
  __shared__ float sDelta[BT];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, H = a.H;
  const int k0 = kt * BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  const __nv_bfloat16* qbase = a.q + (long long)b * a.q_bstride + h * D;
  const __nv_bfloat16* obase = a.dout + (long long)b * L * H * D + h * D;
  const int* qseg = a.qseg + (long long)b * L;
  const float* lse = a.lse + ((long long)b * H + h) * L;
  const float* delta = a.delta + ((long long)b * H + h) * L;

  const __nv_bfloat16* kbase = a.k + (long long)b * a.k_bstride + h * D;
  if (ROPE)
    load_rows_rope_both(sQ, nullptr, kbase, a.k_pstride, k0, L, a.cos_t, a.sin_t);
  else
    load_rows(sQ, kbase, a.k_pstride, k0, L);
  load_rows(sO, a.v + (long long)b * a.v_bstride + h * D, a.v_pstride, k0, L);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, sQ, r0, g, t);
  load_a_frags(va, sO, r0, g, t);

  int kj[2], ks[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = k0 + r0 + g + hr * 8;
    ks[hr] = kj[hr] < L ? a.kseg[(long long)b * L + kj[hr]] : 0;
  }

  int qt_begin, qt_end;
  tile_range<WINDOW>(a, kt, b, gridDim.x, qt_begin, qt_end);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // every warp is done with the previous tile (and the staging)
    if (ROPE)
      load_rows_rope_both(sQ, sQt, qbase, a.q_pstride, q0, L, a.cos_t, a.sin_t);
    else
      load_rows_both(sQ, sQt, qbase, a.q_pstride, q0, L);
    load_rows_both(sO, sOt, obase, (long long)H * D, q0, L);
    for (int r = threadIdx.x; r < BT; r += NTHREADS) {
      const bool in = q0 + r < L;
      sQseg[r] = in ? qseg[q0 + r] : -1;
      sLse[r] = in ? lse[q0 + r] : 0.f;
      sDelta[r] = in ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows(s, ka, sQ, g, t);   // s^T: this warp's keys x the tile's queries
    mma_rows(dp, va, sO, g, t);  // dp^T = v . dout^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int hr = e >> 1;
        bool ok = ks[hr] > 0 && sQseg[col] == ks[hr];
        if (WINDOW) ok = ok && abs(q0 + col - kj[hr]) <= a.window;
        const float p = ok ? exp2f(s[nt][e] * SCALE2 - sLse[col]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDelta[col]);  // ds^T
      }
    }
    mma_acc_transposed(dv, s, sOt, g, t);   // dv += p^T . dout
    mma_acc_transposed(dk, dp, sQt, g, t);  // dk += ds^T . q
  }
  if (ROPE) counter_rotate(dk, a.cos_t, a.sin_t, k0 + r0, L, g, t);
  store_rows(a.dk, dk, SCALE, b, h, H, L, k0 + r0, g, t);
  store_rows(a.dv, dv, 1.f, b, h, H, L, k0 + r0, g, t);
}

template <bool WINDOW, bool DQ, bool ROPE>
int launch_form(const BwdArgs& a, int B, void* stream) {
  dim3 grid((a.L + BT - 1) / BT, a.H, B);
  if (DQ)
    attention_dq_kernel<WINDOW, ROPE><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  else
    attention_dkv_kernel<WINDOW, ROPE><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The rope form when the tables are given, the plain form when neither is.
template <bool WINDOW, bool DQ>
int launch(const BwdArgs& a, int B, void* stream) {
  if (a.L <= 0 || B <= 0 || a.H <= 0 || a.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (WINDOW && a.window < 0) return (int)cudaErrorInvalidValue;
  if ((a.cos_t == nullptr) != (a.sin_t == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.cos_t != nullptr) return launch_form<WINDOW, DQ, true>(a, B, stream);
  return launch_form<WINDOW, DQ, false>(a, B, stream);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  long long q_bstride, long long k_bstride, long long v_bstride,
                  long long q_pstride, long long k_pstride, long long v_pstride, const void* lse,
                  const void* delta, const void* qseg, const void* kseg, const void* tile_start,
                  const void* tile_count, const void* cos_t, const void* sin_t, void* dq, void* dk,
                  void* dv, int L, int H, int window) {
  BwdArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.dout = (const __nv_bfloat16*)dout;
  a.q_bstride = q_bstride;
  a.k_bstride = k_bstride;
  a.v_bstride = v_bstride;
  a.q_pstride = q_pstride;
  a.k_pstride = k_pstride;
  a.v_pstride = v_pstride;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.tile_start = (const int*)tile_start;
  a.tile_count = (const int*)tile_count;
  a.cos_t = (const float*)cos_t;
  a.sin_t = (const float*)sin_t;
  a.dq = (__nv_bfloat16*)dq;
  a.dk = (__nv_bfloat16*)dk;
  a.dv = (__nv_bfloat16*)dv;
  a.L = L;
  a.H = H;
  a.window = window;
  return a;
}

}  // namespace

// Common arguments: q, k, v (B, L, H, 64) bf16 with the given batch and
// position strides; dout (B, L, H, 64) contiguous bf16; lse and delta
// (B, H, L) fp32; qseg, kseg (B, L) int32; tile_start, tile_count (B, ntiles)
// int32 (segment kernels; null for the window kernels); cos_t, sin_t (L, 32)
// fp32 rope tables of raw q/k (the rope forms) or both null. dq kernels write dq;
// dkv kernels write dk and dv; all outputs (B, L, H, 64) contiguous bf16.
#define CM3P_BWD_PARAMS                                                                      \
  const void *q, const void *k, const void *v, const void *dout, long long q_bstride,        \
      long long k_bstride, long long v_bstride, long long q_pstride, long long k_pstride,    \
      long long v_pstride, const void *lse, const void *delta, const void *qseg,             \
      const void *kseg, const void *tile_start, const void *tile_count, const void *cos_t,   \
      const void *sin_t, void *dq, void *dk, void *dv, int B, int L, int H, int window,      \
      void *stream
#define CM3P_BWD_ARGS                                                                        \
  make_args(q, k, v, dout, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride, v_pstride, \
            lse, delta, qseg, kseg, tile_start, tile_count, cos_t, sin_t, dq, dk, dv, L, H, window)

extern "C" int cm3p_window_attention_dq(CM3P_BWD_PARAMS) {
  return launch<true, true>(CM3P_BWD_ARGS, B, stream);
}

extern "C" int cm3p_window_attention_dkv(CM3P_BWD_PARAMS) {
  return launch<true, false>(CM3P_BWD_ARGS, B, stream);
}

extern "C" int cm3p_segment_attention_dq(CM3P_BWD_PARAMS) {
  return launch<false, true>(CM3P_BWD_ARGS, B, stream);
}

extern "C" int cm3p_segment_attention_dkv(CM3P_BWD_PARAMS) {
  return launch<false, false>(CM3P_BWD_ARGS, B, stream);
}
