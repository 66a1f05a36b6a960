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
// raw: the dq kernel rotates every q/k tile as it stages it, the dkv kernel
// reads q and k rotated once by the rope pass, both with the forward's
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
// Design: the two-kernel flash backward, each a template over the mask type
// like the forward's attention_kernel<WINDOW> and over ROPE.
//   dq kernel : one block of 4 warps per (query tile of 64, head, row). Each
//               warp keeps its 16 rows of q and dout as mma fragments in
//               registers and streams key tiles (k row-major and transposed,
//               v row-major in shared memory), accumulating dq in registers
//               (mma.sync m16n8k16 bf16 -> fp32; its first version).
//   dkv kernel: sm90_dkv::attention_dkv_kernel, on the design of the forward
//               (csrc/attention.cu): one block of three warpgroups per
//               (128 keys, head, row). The two consumer warpgroups each own a
//               64-key tile, whose K and V tiles TMA loads once and which stay
//               resident; a producer thread streams the query tiles the two
//               key tiles meet through a ring of 16 KB stages (the q and dout
//               tiles of one query tile, through (64 dims, L, H, B) tensor
//               maps; rows past L arrive as zeros), and both consumers take
//               every stage, each computing on the query tiles its own key
//               tile meets and handing the others straight back. Per query
//               tile a consumer forms s^T = K q^T and dp^T = V dout^T with
//               wgmma (both operands K-major in shared memory), the mask, p^T
//               = exp2(s^T * log2(e) / 8 - lse) and ds^T = p^T (dp^T - delta)
//               in registers (lse, delta and the query segments loaded by
//               each lane while the stage lands and passed by shuffles; a
//               warp whose 16 keys and the tile's queries share one segment,
//               inside the window, skips the per-element test), and then dv
//               += p^T dout and dk += ds^T q with wgmma, A (p^T, ds^T in bf16)
//               from registers and B the same q and dout tiles read MN-major,
//               so no tile is transposed. In the rope form a rope pass
//               (rope_qk_kernel, rope8's bits) first rotates q and k into a
//               scratch the wrapper allocates, so the recomputed
//               scores equal the forward's bit for bit; dk is counter-rotated
//               on the fp32 accumulators before the store. ptxas serialises
//               every wgmma of a kernel on a C++ polling loop, a role test it
//               cannot see as warp-uniform, or accumulators touched outside
//               the loop that accumulates them (C7520, C7514): the waits keep
//               their loop inside the asm (mbar_wait_wg), roles come from a
//               shuffle, and dk / dv are first written by the first query
//               tile's products (scale-d 0). Shared memory: K and V of the two
//               key tiles (32 KB) and a ring of 12 stages.
// Tile ranges: the window kernels visit the tiles meeting [t0 - w, t0 + 63 + w]
// (3 tiles at w = 64; any w, so windows wider than 128, the TPU's streaming
// _dq_kernel / _dkv_kernel route, run here too); the segment kernels visit the
// range [start, start + count) the wrapper computes from the segment ids
// (key_tile_ranges, with the q/k roles swapped for dkv: the work of qb_index in
// _global_unrolled_bwd).
// Bound on the H100: per visible (query, key) pair and head, 4 products of
// depth 64 in the dkv kernel (s, dp, dv, dk) and 3 in the dq kernel (s, dp,
// dq), 2 * 64 flops each, against ~16 bytes per position and head, so a window
// of 129 keys sits near the ridge and the segment kernels are bound by the
// tensor cores. The dkv kernel runs each query tile's score products, its
// elementwise step and its gradient products in turn in each consumer, the
// other consumer's work overlapping; the dq kernel has no load/compute
// overlap and stores transposed tiles with scalar writes, so it runs well
// below that.
// The dq kernel's rope form rotates each staged q/k tile (64 x 32 rotations in
// fp32, 16 KB of table reads from L2) as it stages it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// The dK/dV kernel (see the note at the top).
namespace sm90_dkv {

using namespace cm3p::sm90;

constexpr int THREADS = 384;                 // consumer warpgroups 0 and 1, the producer 2
constexpr int KEYS = 2 * BT;                 // keys of a block: one 64-key tile per consumer warpgroup
constexpr int TILE_BYTES = BT * D * 2;       // a 64 x 64 bf16 tile of 128-byte rows
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // the q and dout tiles of one query tile
constexpr int KV_BYTES = 4 * TILE_BYTES;     // K and V of each consumer's key tile, resident
constexpr int SMEM_MAX = 232448;             // dynamic shared memory a block may use on the H100
constexpr int PER_STAGE = STAGE_BYTES + 2 * 8;  // tiles, full and empty barriers
constexpr int STAGES = (SMEM_MAX - 1024 - KV_BYTES - 8) / PER_STAGE;
constexpr int BYTES = 1024 + KV_BYTES + STAGES * PER_STAGE + 8;
static_assert(STAGES >= 2, "a ring of one stage would serialise loads and products");

struct Params {
  const int* qseg;        // (B, L)
  const int* kseg;        // (B, L)
  const float* lse;       // (B, H, L) base 2
  const float* delta;     // (B, H, L)
  const int* tile_start;  // (B, ceil(L / 64)) query-tile ranges of each 64-key tile, segment form only
  const int* tile_count;
  const float* cos_t;     // (L, 32) rope tables, rope form only: dk is counter-rotated
  const float* sin_t;
  __nv_bfloat16* dk;      // (B, L, H, 64)
  __nv_bfloat16* dv;
  int L, H, window;
};

// 2^x with the hardware's approximation, denormal results flushed to zero (the forward's exponent)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The query tiles [begin, end) that 64-key tile kt meets: window [k0 - w, k0 + 63 + w], segment the
// wrapper's ranges (the q/k roles of key_tile_ranges swapped); empty past the last key tile.
template <bool WINDOW>
__device__ __forceinline__ void query_range(const Params& p, int b, int kt, int nkt, int& begin, int& end) {
  begin = end = 0;
  if (kt >= nkt) return;
  if (WINDOW) {
    begin = max(0, kt * BT - p.window) / BT;
    end = min(p.L - 1, kt * BT + BT - 1 + p.window) / BT + 1;
  } else {
    begin = p.tile_start[b * nkt + kt];
    end = begin + p.tile_count[b * nkt + kt];
  }
}

template <bool WINDOW, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
    attention_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = kv + KV_BYTES;  // consumer w's K tile at kv + 2 w TILE_BYTES, its V tile after it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);  // the stage's q and dout landed
  uint64_t* empty = full + STAGES;  // both consumer warpgroups are done with it (their 8 warps)
  uint64_t* kv_full = empty + STAGES;
  // Both consumers take every stage of the ring in order (each computes on the query tiles its key tile
  // meets and hands the others straight back), so no stage is refilled before both released it and each
  // parity wait tells its phase.

  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, H = p.H, k0 = kb * KEYS, nkt = (L + BT - 1) / BT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int rb0, re0, rb1, re1;
  query_range<WINDOW>(p, b, 2 * kb, nkt, rb0, re0);
  query_range<WINDOW>(p, b, 2 * kb + 1, nkt, rb1, re1);
  // the union of the two ranges, which the producer streams
  const int ub = re0 > rb0 ? (re1 > rb1 ? min(rb0, rb1) : rb0) : (re1 > rb1 ? rb1 : 0);
  const int ue = max(re0 > rb0 ? re0 : 0, re1 > rb1 ? re1 : 0);
  const bool two = k0 + BT < L;  // the block's second key tile exists

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kv_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform, as the compiler can see
  if (wg == 2) {  // producer: one thread issues every load
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_do);
      mbar_expect_tx(kv_full, (two ? 4 : 2) * TILE_BYTES);
      for (int w = 0; w < (two ? 2 : 1); ++w) {
        tma_load_4d(kv + 2 * w * TILE_BYTES, &map_k, kv_full, 0, k0 + w * BT, h, b);
        tma_load_4d(kv + (2 * w + 1) * TILE_BYTES, &map_v, kv_full, 0, k0 + w * BT, h, b);
      }
      for (int qt = ub; qt < ue; ++qt) {
        const int idx = qt - ub, s = idx % STAGES;
        mbar_wait(&empty[s], ((idx / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        unsigned char* st = ring + s * STAGE_BYTES;
        tma_load_4d(st, &map_q, &full[s], 0, qt * BT, h, b);
        tma_load_4d(st + TILE_BYTES, &map_do, &full[s], 0, qt * BT, h, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes keys k0 + 64 wg .. + 63; warp wl of it owns keys 16 wl .. 16 wl + 15
  regs_alloc<232>();
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + wg * BT, rw = 16 * wl;
  int mb = wg ? rb1 : rb0, me = wg ? re1 : re0;
  if (me <= mb) mb = me = ub;  // nothing to compute: hand every stage back
  // the loop bounds as lane 0 holds them, so that the compiler sees them warp-uniform
  mb = __shfl_sync(0xffffffffu, mb, 0);
  me = __shfl_sync(0xffffffffu, me, 0);
  const int ubw = __shfl_sync(0xffffffffu, ub, 0), uew = __shfl_sync(0xffffffffu, ue, 0);
  int kj[2], ks[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = kw0 + rw + g + 8 * hr;
    ks[hr] = kj[hr] < L ? p.kseg[(long long)b * L + kj[hr]] : 0;
  }
  if (me == mb) {  // no query sees these keys: dk = dv = 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (kj[hr] >= L) continue;
      const long long o = (((long long)b * L + kj[hr]) * H + h) * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        *reinterpret_cast<uint32_t*>(p.dk + o + 8 * dt) = 0u;
        *reinterpret_cast<uint32_t*>(p.dv + o + 8 * dt) = 0u;
      }
    }
  }
  // the segment all 16 keys of this warp share (> 0), else -2, which no query segment equals
  const int first = __shfl_sync(0xffffffffu, ks[0], 0);
  const int kuni = (__all_sync(0xffffffffu, ks[0] == first && ks[1] == first) && first > 0) ? first : -2;
  const int* qseg = p.qseg + (long long)b * L;
  const float* lse = p.lse + ((long long)b * H + h) * L;
  const float* delta = p.delta + ((long long)b * H + h) * L;
  unsigned char* sk = kv + 2 * wg * TILE_BYTES;
  const uint64_t dkd = desc_sw128(sk), dvd = desc_sw128(sk + TILE_BYTES);
  auto hand_back = [&](int qt) {  // a stage this warpgroup does not compute on
    const int idx = qt - ubw, s = idx % STAGES;
    mbar_wait_wg(&full[s], (idx / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  mbar_wait_wg(kv_full, 0);
  for (int qt = ubw; qt < mb; ++qt) hand_back(qt);
  // dk and dv are written first by the first query tile's products (scale-d 0): zeroing them before the
  // loop makes ptxas serialise every wgmma of the kernel (C7514)
  float dk[32], dv[32];
  for (int qt = mb; qt < me; ++qt) {
    const int idx = qt - ubw, s = idx % STAGES, q0 = qt * BT;
    // lane l holds the segment (-1 past L), lse and delta of queries q0 + 2 l and q0 + 2 l + 1, loaded while
    // the stage lands
    const int j0 = q0 + 2 * lane;
    const int qx = j0 < L ? __ldg(qseg + j0) : -1, qy = j0 + 1 < L ? __ldg(qseg + j0 + 1) : -1;
    const float lx = j0 < L ? __ldg(lse + j0) : 0.f, ly = j0 + 1 < L ? __ldg(lse + j0 + 1) : 0.f;
    const float dx = j0 < L ? __ldg(delta + j0) : 0.f, dy = j0 + 1 < L ? __ldg(delta + j0 + 1) : 0.f;
    mbar_wait_wg(&full[s], (idx / STAGES) & 1);
    unsigned char* st = ring + s * STAGE_BYTES;
    const uint64_t dqd = desc_sw128(st), dod = desc_sw128(st + TILE_BYTES);
    bool whole = kuni > 0 && qx == kuni && qy == kuni;
    if (WINDOW) whole = whole && max(q0 + BT - 1 - (kw0 + rw), kw0 + rw + 15 - q0) <= p.window;
    whole = __all_sync(0xffffffffu, whole);
    // the stage's 64 queries in two halves of 32, so that the score accumulators in flight (2 x 16 registers)
    // beside the resident dk and dv (2 x 32) leave ptxas room: with all 64 at once it moves accumulator
    // registers during the products and serialises every wgmma (C7514)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // s^T = K Q^T and dp^T = V dout^T for queries 32 half .. + 31: keys x queries, both operands K-major in
      // shared memory (32 rows of a tile = 4,096 bytes)
      float sa[16], dpa[16];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) wgmma_bf16_n32(sa, dkd + 2 * k, dqd + 256 * half + 2 * k, k);
#pragma unroll
      for (int k = 0; k < D / 16; ++k) wgmma_bf16_n32(dpa, dvd + 2 * k, dod + 256 * half + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dpa);

      // accumulator i: key row rw + g + 8 ((i / 2) % 2), query column 32 half + 8 (i / 4) + 2 t4 + i % 2
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // query columns 32 half + 8 j + 2 t4 (+ 1) are lane 16 half + 4 j + t4's
        const int src = 16 * half + 4 * j + t4;
        const float lsx = __shfl_sync(0xffffffffu, lx, src), lsy = __shfl_sync(0xffffffffu, ly, src);
        const float dlx = __shfl_sync(0xffffffffu, dx, src), dly = __shfl_sync(0xffffffffu, dy, src);
        const int sqx = __shfl_sync(0xffffffffu, qx, src), sqy = __shfl_sync(0xffffffffu, qy, src);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, hr = e >> 1, col = 32 * half + 8 * j + 2 * t4 + (e & 1);
          bool ok = true;
          if (!whole) {
            const int qsg = (e & 1) ? sqy : sqx;
            ok = ks[hr] > 0 && qsg == ks[hr];
            if (WINDOW) ok = ok && abs(q0 + col - kj[hr]) <= p.window;
          }
          const float pr = ok ? ex2_ftz(sa[i] * SCALE2 - ((e & 1) ? lsy : lsx)) : 0.f;
          sa[i] = pr;                                        // p^T
          dpa[i] = pr * (dpa[i] - ((e & 1) ? dly : dlx));    // ds^T
        }
      }
      uint32_t pa[2][4], da[2][4];  // p^T and ds^T in bf16 as A fragments of 16 queries each
#pragma unroll
      for (int kq = 0; kq < 2; ++kq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kq][e] = pack_bf16(sa[8 * kq + 2 * e], sa[8 * kq + 2 * e + 1]);
          da[kq][e] = pack_bf16(dpa[8 * kq + 2 * e], dpa[8 * kq + 2 * e + 1]);
        }
      // dv += p^T dout and dk += ds^T q: A from registers, B the same dout / q tiles read MN-major (16 queries
      // = 2,048 bytes); the first query tile's first product overwrites
      const int acc = half > 0 || qt != mb;
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) wgmma_bf16_n64_rs_mn(dv, pa[kq], dod + 128 * (2 * half + kq), kq > 0 || acc);
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) wgmma_bf16_n64_rs_mn(dk, da[kq], dqd + 128 * (2 * half + kq), kq > 0 || acc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        fence_regs(pa[kq]);
        fence_regs(da[kq]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  for (int qt = me; qt < uew; ++qt) hand_back(qt);
  if (me == mb) return;

  // dk (in the rope form counter-rotated: rope's transpose at each key's position, on the fp32 accumulators, as
  // they are stored; dim c < 32 sits in accumulators 4 (c / 8) + ..., its partner c + 32 sixteen further) and dv.
  // The accumulators are only read here: writing them back after the loop makes ptxas serialise every wgmma.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kj[hr] >= L) continue;
    const long long o = (((long long)b * L + kj[hr]) * H + h) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      float x0 = dk[4 * dt + 2 * hr], x1 = dk[4 * dt + 2 * hr + 1];
      if (ROPE) {
        const int pd = dt ^ 4, c = 8 * (dt & 3) + 2 * t4;  // the partner accumulators; the tables' column
        const float y0 = dk[4 * pd + 2 * hr], y1 = dk[4 * pd + 2 * hr + 1];
        const float2 cs = __ldg(reinterpret_cast<const float2*>(p.cos_t + (long long)kj[hr] * (D / 2) + c));
        const float2 sn = __ldg(reinterpret_cast<const float2*>(p.sin_t + (long long)kj[hr] * (D / 2) + c));
        // first half: g1 cos + g2 sin; second half: g2 cos - g1 sin (x is this half's value, y its partner's)
        const float sgn = dt < 4 ? 1.f : -1.f;
        x0 = x0 * cs.x + sgn * (y0 * sn.x);
        x1 = x1 * cs.y + sgn * (y1 * sn.y);
      }
      *reinterpret_cast<uint32_t*>(p.dk + o + 8 * dt) = pack_bf16(x0 * SCALE, x1 * SCALE);
      *reinterpret_cast<uint32_t*>(p.dv + o + 8 * dt) = pack_bf16(dv[4 * dt + 2 * hr], dv[4 * dt + 2 * hr + 1]);
    }
  }
}

// The rope pass of the rope forms: q then k (strided (B, L, H, 64) views) rotated into rot, two contiguous
// (B, L, H, 64) buffers, in one launch.
__global__ void __launch_bounds__(cm3p::attn::ROPE_BLOCK)
    rope_qk_kernel(const __nv_bfloat16* q, long long q_bstride, long long q_pstride, const __nv_bfloat16* k,
                   long long k_bstride, long long k_pstride, const float* cos_t, const float* sin_t,
                   __nv_bfloat16* rot, int B, int L, int H) {
  const long long n = 4ll * B * L * H, i = (long long)blockIdx.x * cm3p::attn::ROPE_BLOCK + threadIdx.x;
  if (i < n)
    cm3p::attn::rope_item(q, q_bstride, q_pstride, cos_t, sin_t, rot, L, H, i);
  else if (i < 2 * n)
    cm3p::attn::rope_item(k, k_bstride, k_pstride, cos_t, sin_t, rot + (long long)B * L * H * D, L, H, i - n);
}

// With rope tables q and k are first rotated by the pass into rot (two (B, L, H, 64) buffers), and the kernel
// reads them there.
template <bool WINDOW, bool ROPE>
int launch(const BwdArgs& a, int B, __nv_bfloat16* rot, cudaStream_t stream) {
  const __nv_bfloat16 *q = a.q, *k = a.k;
  long long qb = a.q_bstride, qp = a.q_pstride, kb = a.k_bstride, kp = a.k_pstride;
  if (ROPE) {
    if (rot == nullptr) return (int)cudaErrorInvalidValue;
    const long long n = (long long)B * a.L * a.H * D, items = 8ll * B * a.L * a.H;
    const int block = cm3p::attn::ROPE_BLOCK;
    rope_qk_kernel<<<(unsigned)((items + block - 1) / block), block, 0, stream>>>(
        a.q, a.q_bstride, a.q_pstride, a.k, a.k_bstride, a.k_pstride, a.cos_t, a.sin_t, rot, B, a.L, a.H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    q = rot;
    k = rot + n;
    qb = kb = (long long)a.L * a.H * D;
    qp = kp = (long long)a.H * D;
  }
  CUtensorMap mq, mk, mv, mdo;
  // (64 dims, L positions, H heads, B rows) over the views; heads lie 64 elements apart
  if (!make_map_4d_bf16(&mq, q, D, a.L, a.H, B, qp, D, qb, D, BT) ||
      !make_map_4d_bf16(&mk, k, D, a.L, a.H, B, kp, D, kb, D, BT) ||
      !make_map_4d_bf16(&mv, a.v, D, a.L, a.H, B, a.v_pstride, D, a.v_bstride, D, BT) ||
      !make_map_4d_bf16(&mdo, a.dout, D, a.L, a.H, B, (long long)a.H * D, D, (long long)a.L * a.H * D, D, BT))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)attention_dkv_kernel<WINDOW, ROPE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  const Params p{a.qseg, a.kseg, a.lse, a.delta, a.tile_start, a.tile_count, a.cos_t, a.sin_t,
                 a.dk, a.dv, a.L, a.H, a.window};
  dim3 grid((a.L + KEYS - 1) / KEYS, a.H, B);
  attention_dkv_kernel<WINDOW, ROPE><<<grid, THREADS, BYTES, stream>>>(mq, mk, mv, mdo, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90_dkv

template <bool WINDOW, bool DQ, bool ROPE>
int launch_form(const BwdArgs& a, int B, __nv_bfloat16* rot, void* stream) {
  if constexpr (!DQ) {
    return sm90_dkv::launch<WINDOW, ROPE>(a, B, rot, (cudaStream_t)stream);
  } else {
    dim3 grid((a.L + BT - 1) / BT, a.H, B);
    attention_dq_kernel<WINDOW, ROPE><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
}

// The rope form when the tables are given, the plain form when neither is.
template <bool WINDOW, bool DQ>
int launch(const BwdArgs& a, int B, void* rot, void* stream) {
  if (a.L <= 0 || B <= 0 || a.H <= 0 || a.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (WINDOW && a.window < 0) return (int)cudaErrorInvalidValue;
  if ((a.cos_t == nullptr) != (a.sin_t == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.cos_t != nullptr) return launch_form<WINDOW, DQ, true>(a, B, (__nv_bfloat16*)rot, stream);
  return launch_form<WINDOW, DQ, false>(a, B, (__nv_bfloat16*)rot, stream);
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
// dkv kernels write dk and dv; all outputs (B, L, H, 64) contiguous bf16. rot:
// with the tables, the dkv kernels' bf16 scratch of 2 * B * L * H * 64
// elements (q and k rotated by the rope pass); otherwise unused (null).
#define CM3P_BWD_PARAMS                                                                      \
  const void *q, const void *k, const void *v, const void *dout, long long q_bstride,        \
      long long k_bstride, long long v_bstride, long long q_pstride, long long k_pstride,    \
      long long v_pstride, const void *lse, const void *delta, const void *qseg,             \
      const void *kseg, const void *tile_start, const void *tile_count, const void *cos_t,   \
      const void *sin_t, void *dq, void *dk, void *dv, void *rot, int B, int L, int H,        \
      int window, void *stream
#define CM3P_BWD_ARGS                                                                        \
  make_args(q, k, v, dout, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride, v_pstride, \
            lse, delta, qseg, kseg, tile_start, tile_count, cos_t, sin_t, dq, dk, dv, L, H, window)

extern "C" int cm3p_window_attention_dq(CM3P_BWD_PARAMS) {
  return launch<true, true>(CM3P_BWD_ARGS, B, rot, stream);
}

extern "C" int cm3p_window_attention_dkv(CM3P_BWD_PARAMS) {
  return launch<true, false>(CM3P_BWD_ARGS, B, rot, stream);
}

extern "C" int cm3p_segment_attention_dq(CM3P_BWD_PARAMS) {
  return launch<false, true>(CM3P_BWD_ARGS, B, rot, stream);
}

extern "C" int cm3p_segment_attention_dkv(CM3P_BWD_PARAMS) {
  return launch<false, false>(CM3P_BWD_ARGS, B, rot, stream);
}
