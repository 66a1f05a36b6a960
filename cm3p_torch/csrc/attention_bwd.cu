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
// branch of each TPU kernel, CM3P_TRAIN_FUSED_ROPE) q and k arrive raw: a
// rope pass (cm3p_attention_rope_qk, run once per backward call, before both
// kernels) first rotates them with the forward's arithmetic (rope8 of
// csrc/attention_fwd.cuh, so the recomputed scores equal the forward's bit for
// bit and p matches the lse it wrote) into a scratch both kernels read, and
// dq/dk are counter-rotated on the fp32 accumulators as they are stored, so
// they leave with respect to the raw q/k.
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
// Design (namespace sm90_bwd): two kernels, each a template over the mask
// type like the forward's attention_kernel<WINDOW> and over ROPE, on the
// forward's design (csrc/attention.cu) turned around. One block of three
// warpgroups works on 128 rows of one role (head, batch row); the two
// consumer warpgroups each own a 64-row tile of it, whose two tiles TMA loads
// once and which stay resident; a producer thread streams the 64-row tiles of
// the other role that the two resident tiles meet through a ring of 16 KB
// stages (two tiles each, through (64 dims, L, H, B) tensor maps; rows past L
// arrive as zeros), and both consumers take every stage, each computing on
// the tiles its own resident tile meets and handing the others straight back.
//   dq kernel : resident q and dout; stages of K and V. Per key tile a
//               consumer forms s = Q K^T and dp = dout V^T with wgmma (both
//               operands K-major in shared memory), then the mask, p =
//               exp2(s * log2(e) / 8 - lse) and ds = p (dp - delta) in
//               registers (lse, delta and the query segments per row, loaded
//               once; the key segments loaded by each lane while the stage
//               lands and passed by shuffles), and dq += ds K with wgmma, A (ds
//               in bf16) from registers and B the same K tile read MN-major,
//               so no tile is transposed. At the end the consumer writes its
//               dq tile (counter-rotated in the rope form) into its Q tile's
//               shared memory and stores it in 16-byte rows.
//   dkv kernel: resident K and V; stages of q and dout. Per query tile s^T =
//               K q^T, dp^T = V dout^T, then p^T and ds^T in registers, then
//               dv += p^T dout and dk += ds^T q (A from registers, B the same
//               q and dout tiles read MN-major); dk is counter-rotated and
//               dk / dv stored by the accumulators' rows.
// Both kernels split a stage into two 32-row halves (n32 score products) so
// that the score accumulators in flight beside the resident gradients leave
// ptxas room: with all 64 at once it moves accumulator registers during the
// products and serialises every wgmma (C7514). ptxas does the same on a C++
// polling loop, a role test it cannot see as warp-uniform, or accumulators
// touched outside the loop that accumulates them (C7520, C7514): the waits
// keep their loop inside the asm (mbar_wait_wg), roles come from a shuffle,
// and the gradients are first written by the first tile's products (scale-d
// 0) and only read after the loop. A warp whose 16 rows and the stage's 64
// rows share one segment (inside the window) skips the per-element test.
// Shared memory: the two resident tiles of each consumer (32 KB) and a ring of
// 12 stages.
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
// tensor cores. Each consumer runs a tile's score products, its elementwise
// step and its gradient products in turn, the other consumer's work
// overlapping, so the kernels sit at a few times their bound (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;

constexpr int D = 64;   // head dim
constexpr int BT = 64;  // query and key tile

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

// ---------------------------------------------------------------------------
// The two kernels (see the note at the top).
namespace sm90_bwd {

using namespace cm3p::sm90;

constexpr int THREADS = 384;                 // consumer warpgroups 0 and 1, the producer 2
constexpr int ROWS = 2 * BT;                 // rows of a block's role: one 64-row tile per consumer warpgroup
constexpr int TILE_BYTES = BT * D * 2;       // a 64 x 64 bf16 tile of 128-byte rows
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // two tiles of the streamed role (k and v, or q and dout)
constexpr int RES_BYTES = 4 * TILE_BYTES;    // the two resident tiles of each consumer
constexpr int SMEM_MAX = 232448;             // dynamic shared memory a block may use on the H100
constexpr int PER_STAGE = STAGE_BYTES + 2 * 8;  // tiles, full and empty barriers
constexpr int STAGES = (SMEM_MAX - 1024 - RES_BYTES - 8) / PER_STAGE;
constexpr int BYTES = 1024 + RES_BYTES + STAGES * PER_STAGE + 8;
static_assert(STAGES >= 2, "a ring of one stage would serialise loads and products");

struct Params {
  const int* qseg;        // (B, L)
  const int* kseg;        // (B, L)
  const float* lse;       // (B, H, L) base 2
  const float* delta;     // (B, H, L)
  const int* tile_start;  // (B, ceil(L / 64)) ranges of the streamed role's tiles per resident tile, segment form
  const int* tile_count;
  const float* cos_t;     // (L, 32) rope tables, rope form only: dq / dk are counter-rotated
  const float* sin_t;
  __nv_bfloat16* dq;      // (B, L, H, 64), dq kernel
  __nv_bfloat16* dk;      // (B, L, H, 64), dkv kernel
  __nv_bfloat16* dv;
  int L, H, window;
};

// 2^x with the hardware's approximation, denormal results flushed to zero (the forward's exponent)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tiles [begin, end) of the streamed role that resident 64-row tile t meets: window [t0 - w, t0 + 63 + w],
// segment the wrapper's ranges; empty past the last tile.
template <bool WINDOW>
__device__ __forceinline__ void tile_range(const Params& p, int b, int t, int nt, int& begin, int& end, int kid) {
  begin = end = 0;
  if (t >= nt) return;
  if (WINDOW) {
    begin = max(0, t * BT - p.window) / BT;
    end = min(p.L - 1, t * BT + BT - 1 + p.window) / BT + 1;
  } else {
    const int at = b * nt + t;
    begin = BOUNDS_OK(kid, bounds::START, at, 1) ? p.tile_start[at] : 0;
    end = begin + (BOUNDS_OK(kid, bounds::COUNT, at, 1) ? p.tile_count[at] : 0);
  }
  // a range read from the tensors must lie in [0, nt]; the checked build records one that does not and visits
  // nothing
  if (!(IN_RANGE(kid, bounds::TILE, begin, nt + 1) && IN_RANGE(kid, bounds::TILE, end, nt + 1) &&
        IN_RANGE(kid, bounds::TILE, end - begin, nt + 1)))
    begin = end = 0;
}

// What both kernels share: shared memory, the barriers, the producer and the ranges. res holds consumer w's
// two resident tiles at res + 2 w TILE_BYTES (q and dout, or k and v), ring the stages; the producer loads the
// resident tiles from maps r0 / r1 and streams the tiles of s0 / s1.
struct Block {
  unsigned char* res;
  unsigned char* ring;
  uint64_t* full;      // the stage's tiles landed
  uint64_t* empty;     // both consumer warpgroups are done with it (their 8 warps)
  uint64_t* res_full;  // the resident tiles landed
  int ub, ue;          // the union of the two consumers' ranges, which the producer streams
  int rb[2], re[2];    // each consumer's range
  bool two;            // the block's second resident tile exists
};

template <bool WINDOW>
__device__ __forceinline__ Block setup(const Params& p, unsigned char* smem_raw, int t0, int b, int kid) {
  Block k;
  k.res = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  k.ring = k.res + RES_BYTES;
  k.full = reinterpret_cast<uint64_t*>(k.ring + STAGES * STAGE_BYTES);
  k.empty = k.full + STAGES;
  k.res_full = k.empty + STAGES;
  // Both consumers take every stage of the ring in order (each computes on the tiles its resident tile meets and
  // hands the others straight back), so no stage is refilled before both released it and each parity wait tells
  // its phase.
  const int nt = (p.L + BT - 1) / BT;
  tile_range<WINDOW>(p, b, t0, nt, k.rb[0], k.re[0], kid);
  tile_range<WINDOW>(p, b, t0 + 1, nt, k.rb[1], k.re[1], kid);
  const bool e0 = k.re[0] > k.rb[0], e1 = k.re[1] > k.rb[1];
  k.ub = e0 ? (e1 ? min(k.rb[0], k.rb[1]) : k.rb[0]) : (e1 ? k.rb[1] : 0);
  k.ue = max(e0 ? k.re[0] : 0, e1 ? k.re[1] : 0);
  k.two = (t0 + 1) * BT < p.L;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k.full[s], 1);
      mbar_init(&k.empty[s], 8);
    }
    mbar_init(k.res_full, 1);
    fence_mbar_init();
  }
  __syncthreads();
  return k;
}

// The producer warpgroup: one thread issues every load.
__device__ __forceinline__ void produce(const Block& k, const CUtensorMap* r0, const CUtensorMap* r1,
                                        const CUtensorMap* s0, const CUtensorMap* s1, int t0, int h, int b,
                                        const Params& p, int kid) {
  const int nt = (p.L + BT - 1) / BT;
  regs_dealloc<40>();
  if (threadIdx.x != 256) return;
  prefetch_map(r0);
  prefetch_map(r1);
  prefetch_map(s0);
  prefetch_map(s1);
  mbar_expect_tx(k.res_full, (k.two ? 4 : 2) * TILE_BYTES);
  IN_RANGE(kid, bounds::HEAD, h, p.H);
  IN_RANGE(kid, bounds::ROW, b, gridDim.z);
  for (int w = 0; w < (k.two ? 2 : 1); ++w) {
    IN_RANGE(kid, bounds::TILE, t0 + w, nt);
    tma_load_4d(k.res + 2 * w * TILE_BYTES, r0, k.res_full, 0, (t0 + w) * BT, h, b);
    tma_load_4d(k.res + (2 * w + 1) * TILE_BYTES, r1, k.res_full, 0, (t0 + w) * BT, h, b);
  }
  for (int t = k.ub; t < k.ue; ++t) {
    const int idx = t - k.ub;
    int s = idx % STAGES;
    if (!IN_RANGE(kid, bounds::STAGE, s, STAGES)) s = 0;
    IN_RANGE(kid, bounds::TILE, t, nt);
    mbar_wait(&k.empty[s], ((idx / STAGES) & 1) ^ 1);
    mbar_expect_tx(&k.full[s], STAGE_BYTES);
    unsigned char* st = k.ring + s * STAGE_BYTES;
    tma_load_4d(st, s0, &k.full[s], 0, t * BT, h, b);
    tma_load_4d(st + TILE_BYTES, s1, &k.full[s], 0, t * BT, h, b);
  }
}

// A consumer's hand-back of a stage it does not compute on (ub: the first streamed tile of the block).
__device__ __forceinline__ void hand_back(const Block& k, int ub, int t, int lane, int kid) {
  const int idx = t - ub;
  int s = idx % STAGES;
  if (!IN_RANGE(kid, bounds::STAGE, s, STAGES)) s = 0;
  mbar_wait_wg(&k.full[s], (idx / STAGES) & 1);
  __syncwarp();
  if (lane == 0) mbar_arrive(&k.empty[s]);
}

template <bool WINDOW, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
    attention_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                        const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int KID = WINDOW ? bounds::DQ_WINDOW : bounds::DQ_SEGMENT;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Block blk = setup<WINDOW>(p, smem_raw, 2 * qb, b, KID);
  const int L = p.L, H = p.H, q0 = qb * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform, as the compiler can see
  if (wg == 2) {
    produce(blk, &map_q, &map_do, &map_k, &map_v, 2 * qb, h, b, p, KID);
    return;
  }

  // ---- consumers: warpgroup wg takes queries q0 + 64 wg .. + 63; warp wl of it owns queries 16 wl .. 16 wl + 15
  regs_alloc<232>();
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + wg * BT, rw = 16 * wl;
  int mb = wg ? blk.rb[1] : blk.rb[0], me = wg ? blk.re[1] : blk.re[0];
  if (me <= mb) mb = me = blk.ub;  // nothing to compute: hand every stage back
  // the loop bounds as lane 0 holds them, so that the compiler sees them warp-uniform
  mb = __shfl_sync(0xffffffffu, mb, 0);
  me = __shfl_sync(0xffffffffu, me, 0);
  const int ubw = __shfl_sync(0xffffffffu, blk.ub, 0), uew = __shfl_sync(0xffffffffu, blk.ue, 0);
  int qi[2], qs[2];
  float lsr[2], dlr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = qw0 + rw + g + 8 * hr;
    const bool in = qi[hr] < L;
    const long long si = (long long)b * L + qi[hr], li = ((long long)b * H + h) * L + qi[hr];
    qs[hr] = in && BOUNDS_OK(KID, bounds::QSEG, si, 1) ? p.qseg[si] : -1;
    lsr[hr] = in && BOUNDS_OK(KID, bounds::LSE, li, 1) ? p.lse[li] : 0.f;
    dlr[hr] = in && BOUNDS_OK(KID, bounds::DELTA, li, 1) ? p.delta[li] : 0.f;
  }
  if (me == mb) {  // no key reaches these queries: dq = 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (qi[hr] >= L) continue;
      const long long o = (((long long)b * L + qi[hr]) * H + h) * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        if (BOUNDS_OK(KID, bounds::DQ, o + 8 * dt, 2)) *reinterpret_cast<uint32_t*>(p.dq + o + 8 * dt) = 0u;
    }
  }
  // the segment all 16 queries of this warp share (> 0), else -2, which no key segment equals
  const int first = __shfl_sync(0xffffffffu, qs[0], 0);
  const int quni = (__all_sync(0xffffffffu, qs[0] == first && qs[1] == first) && first > 0) ? first : -2;
  const int* kseg = p.kseg + (long long)b * L;
  unsigned char* sq = blk.res + 2 * wg * TILE_BYTES;
  const uint64_t dqd = desc_sw128(sq), dod = desc_sw128(sq + TILE_BYTES);
  mbar_wait_wg(blk.res_full, 0);
  for (int kt = ubw; kt < mb; ++kt) hand_back(blk, ubw, kt, lane, KID);
  // dq is written first by the first key tile's products (scale-d 0): zeroing it before the loop makes ptxas
  // serialise every wgmma of the kernel (C7514)
  float dq[32];
  for (int kt = mb; kt < me; ++kt) {
    const int idx = kt - ubw, k0 = kt * BT;
    int s = idx % STAGES;
    if (!IN_RANGE(KID, bounds::STAGE, s, STAGES)) s = 0;
    // lane l holds the segments of keys k0 + 2 l and k0 + 2 l + 1 (0 past L), loaded while the stage lands
    const int j0 = k0 + 2 * lane;
    const long long kat = (long long)b * L + j0;
    const int kx = j0 < L && BOUNDS_OK(KID, bounds::KSEG, kat, 1) ? __ldg(kseg + j0) : 0;
    const int ky = j0 + 1 < L && BOUNDS_OK(KID, bounds::KSEG, kat + 1, 1) ? __ldg(kseg + j0 + 1) : 0;
    mbar_wait_wg(&blk.full[s], (idx / STAGES) & 1);
    unsigned char* st = blk.ring + s * STAGE_BYTES;
    const uint64_t dkd = desc_sw128(st), dvd = desc_sw128(st + TILE_BYTES);
    bool whole = quni > 0 && kx == quni && ky == quni;
    if (WINDOW) whole = whole && max(qw0 + rw + 15 - k0, k0 + BT - 1 - qw0 - rw) <= p.window;
    whole = __all_sync(0xffffffffu, whole);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // s = Q K^T and dp = dout V^T for keys 32 half .. + 31: queries x keys, both operands K-major in shared
      // memory (32 rows of a tile = 4,096 bytes)
      float sa[16], dpa[16];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) wgmma_bf16_n32(sa, dqd + 2 * k, dkd + 256 * half + 2 * k, k);
#pragma unroll
      for (int k = 0; k < D / 16; ++k) wgmma_bf16_n32(dpa, dod + 2 * k, dvd + 256 * half + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dpa);

      // accumulator i: query row rw + g + 8 ((i / 2) % 2), key column 32 half + 8 (i / 4) + 2 t4 + i % 2
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // key columns 32 half + 8 j + 2 t4 (+ 1) are lane 16 half + 4 j + t4's
        const int src = 16 * half + 4 * j + t4;
        const int kvx = __shfl_sync(0xffffffffu, kx, src), kvy = __shfl_sync(0xffffffffu, ky, src);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, hr = e >> 1, col = 32 * half + 8 * j + 2 * t4 + (e & 1);
          bool ok = true;
          if (!whole) {
            const int ksg = (e & 1) ? kvy : kvx;
            ok = ksg > 0 && ksg == qs[hr];
            if (WINDOW) ok = ok && abs(qi[hr] - (k0 + col)) <= p.window;
          }
          const float pr = ok ? ex2_ftz(sa[i] * SCALE2 - lsr[hr]) : 0.f;
          dpa[i] = pr * (dpa[i] - dlr[hr]);  // ds
        }
      }
      uint32_t da[2][4];  // ds in bf16 as A fragments of 16 keys each
#pragma unroll
      for (int kq = 0; kq < 2; ++kq)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[kq][e] = pack_bf16(dpa[8 * kq + 2 * e], dpa[8 * kq + 2 * e + 1]);
      // dq += ds K: A from registers, B the same K tile read MN-major (16 keys = 2,048 bytes); the first key
      // tile's first product overwrites
      const int acc = half > 0 || kt != mb;
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) wgmma_bf16_n64_rs_mn(dq, da[kq], dkd + 128 * (2 * half + kq), kq > 0 || acc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) fence_regs(da[kq]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&blk.empty[s]);
  }
  for (int kt = me; kt < uew; ++kt) hand_back(blk, ubw, kt, lane, KID);
  if (me == mb) return;

  // dq (in the rope form counter-rotated: rope's transpose at each query's position, on the fp32 accumulators;
  // dim c < 32 sits in accumulators 4 (c / 8) + ..., its partner c + 32 sixteen further), scaled and rounded,
  // into this warpgroup's Q tile (its products are done with it) in the 128-byte swizzle, then stored by
  // 16-byte rows. The accumulators are only read here: writing them after the loop serialises every wgmma.
  named_barrier(1 + wg, 128);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = rw + g + 8 * hr;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      float x0 = dq[4 * dt + 2 * hr], x1 = dq[4 * dt + 2 * hr + 1];
      if (ROPE && qi[hr] < L) {
        const int pd = dt ^ 4, c = 8 * (dt & 3) + 2 * t4;  // the partner accumulators; the tables' column
        const float y0 = dq[4 * pd + 2 * hr], y1 = dq[4 * pd + 2 * hr + 1];
        const long long ti = (long long)qi[hr] * (D / 2) + c;
        const float2 zero = make_float2(0.f, 0.f);
        const float2 cs = BOUNDS_OK(KID, bounds::COS, ti, 2) ? __ldg(reinterpret_cast<const float2*>(p.cos_t + ti)) : zero;
        const float2 sn = BOUNDS_OK(KID, bounds::SIN, ti, 2) ? __ldg(reinterpret_cast<const float2*>(p.sin_t + ti)) : zero;
        // first half: g1 cos + g2 sin; second half: g2 cos - g1 sin (x is this half's value, y its partner's)
        const float sgn = dt < 4 ? 1.f : -1.f;
        x0 = x0 * cs.x + sgn * (y0 * sn.x);
        x1 = x1 * cs.y + sgn * (y1 * sn.y);
      }
      *reinterpret_cast<uint32_t*>(sq + swizzle128(row, 16 * dt + 4 * t4)) = pack_bf16(x0 * SCALE, x1 * SCALE);
    }
  }
  named_barrier(1 + wg, 128);
  for (int i = threadIdx.x & 127; i < BT * 8; i += 128) {
    const int r = i >> 3, c = i & 7;
    if (qw0 + r >= L) break;
    const long long o = (((long long)b * L + qw0 + r) * H + h) * D + 8 * c;
    if (BOUNDS_OK(KID, bounds::DQ, o, 8))
      *reinterpret_cast<uint4*>(p.dq + o) = *reinterpret_cast<const uint4*>(sq + swizzle128(r, 16 * c));
  }
}

template <bool WINDOW, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
    attention_dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int KID = WINDOW ? bounds::DKV_WINDOW : bounds::DKV_SEGMENT;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Block blk = setup<WINDOW>(p, smem_raw, 2 * kb, b, KID);
  const int L = p.L, H = p.H, k0 = kb * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform, as the compiler can see
  if (wg == 2) {
    produce(blk, &map_k, &map_v, &map_q, &map_do, 2 * kb, h, b, p, KID);
    return;
  }

  // ---- consumers: warpgroup wg takes keys k0 + 64 wg .. + 63; warp wl of it owns keys 16 wl .. 16 wl + 15
  regs_alloc<232>();
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + wg * BT, rw = 16 * wl;
  int mb = wg ? blk.rb[1] : blk.rb[0], me = wg ? blk.re[1] : blk.re[0];
  if (me <= mb) mb = me = blk.ub;  // nothing to compute: hand every stage back
  // the loop bounds as lane 0 holds them, so that the compiler sees them warp-uniform
  mb = __shfl_sync(0xffffffffu, mb, 0);
  me = __shfl_sync(0xffffffffu, me, 0);
  const int ubw = __shfl_sync(0xffffffffu, blk.ub, 0), uew = __shfl_sync(0xffffffffu, blk.ue, 0);
  int kj[2], ks[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = kw0 + rw + g + 8 * hr;
    const long long si = (long long)b * L + kj[hr];
    ks[hr] = kj[hr] < L && BOUNDS_OK(KID, bounds::KSEG, si, 1) ? p.kseg[si] : 0;
  }
  if (me == mb) {  // no query sees these keys: dk = dv = 0
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (kj[hr] >= L) continue;
      const long long o = (((long long)b * L + kj[hr]) * H + h) * D + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        if (BOUNDS_OK(KID, bounds::DK, o + 8 * dt, 2)) *reinterpret_cast<uint32_t*>(p.dk + o + 8 * dt) = 0u;
        if (BOUNDS_OK(KID, bounds::DV, o + 8 * dt, 2)) *reinterpret_cast<uint32_t*>(p.dv + o + 8 * dt) = 0u;
      }
    }
  }
  // the segment all 16 keys of this warp share (> 0), else -2, which no query segment equals
  const int first = __shfl_sync(0xffffffffu, ks[0], 0);
  const int kuni = (__all_sync(0xffffffffu, ks[0] == first && ks[1] == first) && first > 0) ? first : -2;
  const int* qseg = p.qseg + (long long)b * L;
  const float* lse = p.lse + ((long long)b * H + h) * L;
  const float* delta = p.delta + ((long long)b * H + h) * L;
  unsigned char* sk = blk.res + 2 * wg * TILE_BYTES;
  const uint64_t dkd = desc_sw128(sk), dvd = desc_sw128(sk + TILE_BYTES);
  mbar_wait_wg(blk.res_full, 0);
  for (int qt = ubw; qt < mb; ++qt) hand_back(blk, ubw, qt, lane, KID);
  // dk and dv are written first by the first query tile's products (scale-d 0): zeroing them before the
  // loop makes ptxas serialise every wgmma of the kernel (C7514)
  float dk[32], dv[32];
  for (int qt = mb; qt < me; ++qt) {
    const int idx = qt - ubw, q0 = qt * BT;
    int s = idx % STAGES;
    if (!IN_RANGE(KID, bounds::STAGE, s, STAGES)) s = 0;
    // lane l holds the segment (-1 past L), lse and delta of queries q0 + 2 l and q0 + 2 l + 1, loaded while
    // the stage lands
    const int j0 = q0 + 2 * lane;
    const long long sat = (long long)b * L + j0, lat = ((long long)b * H + h) * L + j0;
    const bool x_in = j0 < L, y_in = j0 + 1 < L;
    const int qx = x_in && BOUNDS_OK(KID, bounds::QSEG, sat, 1) ? __ldg(qseg + j0) : -1;
    const int qy = y_in && BOUNDS_OK(KID, bounds::QSEG, sat + 1, 1) ? __ldg(qseg + j0 + 1) : -1;
    const float lx = x_in && BOUNDS_OK(KID, bounds::LSE, lat, 1) ? __ldg(lse + j0) : 0.f;
    const float ly = y_in && BOUNDS_OK(KID, bounds::LSE, lat + 1, 1) ? __ldg(lse + j0 + 1) : 0.f;
    const float dx = x_in && BOUNDS_OK(KID, bounds::DELTA, lat, 1) ? __ldg(delta + j0) : 0.f;
    const float dy = y_in && BOUNDS_OK(KID, bounds::DELTA, lat + 1, 1) ? __ldg(delta + j0 + 1) : 0.f;
    mbar_wait_wg(&blk.full[s], (idx / STAGES) & 1);
    unsigned char* st = blk.ring + s * STAGE_BYTES;
    const uint64_t dqd = desc_sw128(st), dod = desc_sw128(st + TILE_BYTES);
    bool whole = kuni > 0 && qx == kuni && qy == kuni;
    if (WINDOW) whole = whole && max(q0 + BT - 1 - (kw0 + rw), kw0 + rw + 15 - q0) <= p.window;
    whole = __all_sync(0xffffffffu, whole);
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
    if (lane == 0) mbar_arrive(&blk.empty[s]);
  }
  for (int qt = me; qt < uew; ++qt) hand_back(blk, ubw, qt, lane, KID);
  if (me == mb) return;

  // dk (in the rope form counter-rotated, as dq is) and dv. The accumulators are only read here: writing them
  // back after the loop makes ptxas serialise every wgmma.
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
        const long long ti = (long long)kj[hr] * (D / 2) + c;
        const float2 zero = make_float2(0.f, 0.f);
        const float2 cs = BOUNDS_OK(KID, bounds::COS, ti, 2) ? __ldg(reinterpret_cast<const float2*>(p.cos_t + ti)) : zero;
        const float2 sn = BOUNDS_OK(KID, bounds::SIN, ti, 2) ? __ldg(reinterpret_cast<const float2*>(p.sin_t + ti)) : zero;
        const float sgn = dt < 4 ? 1.f : -1.f;
        x0 = x0 * cs.x + sgn * (y0 * sn.x);
        x1 = x1 * cs.y + sgn * (y1 * sn.y);
      }
      if (BOUNDS_OK(KID, bounds::DK, o + 8 * dt, 2))
        *reinterpret_cast<uint32_t*>(p.dk + o + 8 * dt) = pack_bf16(x0 * SCALE, x1 * SCALE);
      if (BOUNDS_OK(KID, bounds::DV, o + 8 * dt, 2))
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
  const long long half = (long long)B * L * H * D;  // elements of each rotated buffer
  if (i < n)
    cm3p::attn::rope_item(q, q_bstride, q_pstride, cos_t, sin_t, rot, L, H, i, bounds::ROPE_QK, bounds::Q, 0);
  else if (i < 2 * n)
    cm3p::attn::rope_item(k, k_bstride, k_pstride, cos_t, sin_t, rot + half, L, H, i - n, bounds::ROPE_QK, bounds::K,
                          half);
}

// In the rope form q and k are read from rot (two (B, L, H, 64) buffers), where the rope pass put them.
template <bool WINDOW, bool DQ, bool ROPE>
int launch(const BwdArgs& a, int B, const __nv_bfloat16* rot, cudaStream_t stream) {
  const __nv_bfloat16 *q = a.q, *k = a.k;
  long long qb = a.q_bstride, qp = a.q_pstride, kb = a.k_bstride, kp = a.k_pstride;
  if (ROPE) {
    if (rot == nullptr) return (int)cudaErrorInvalidValue;
    q = rot;
    k = rot + (long long)B * a.L * a.H * D;
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
  const void* kernel =
      DQ ? (const void*)attention_dq_kernel<WINDOW, ROPE> : (const void*)attention_dkv_kernel<WINDOW, ROPE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  const Params p{a.qseg, a.kseg, a.lse, a.delta, a.tile_start, a.tile_count, a.cos_t, a.sin_t,
                 a.dq, a.dk, a.dv, a.L, a.H, a.window};
  dim3 grid((a.L + ROWS - 1) / ROWS, a.H, B);
  if (DQ)
    attention_dq_kernel<WINDOW, ROPE><<<grid, THREADS, BYTES, stream>>>(mq, mk, mv, mdo, p);
  else
    attention_dkv_kernel<WINDOW, ROPE><<<grid, THREADS, BYTES, stream>>>(mq, mk, mv, mdo, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90_bwd

// The rope form when the tables are given, the plain form when neither is.
template <bool WINDOW, bool DQ>
int launch(const BwdArgs& a, int B, void* rot, void* stream) {
  if (a.L <= 0 || B <= 0 || a.H <= 0 || a.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (WINDOW && a.window < 0) return (int)cudaErrorInvalidValue;
  if ((a.cos_t == nullptr) != (a.sin_t == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.cos_t != nullptr)
    return sm90_bwd::launch<WINDOW, DQ, true>(a, B, (const __nv_bfloat16*)rot, (cudaStream_t)stream);
  return sm90_bwd::launch<WINDOW, DQ, false>(a, B, nullptr, (cudaStream_t)stream);
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
// with the tables, the output of cm3p_attention_rope_qk over q and k (2 * B * L
// * H * 64 bf16 elements: q, then k rotated), which the kernels read in place
// of q and k; otherwise unused (null).
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

// The rope pass of one backward call: raw q and k ((B, L, H, 64) bf16 views with the given strides) rotated
// with the forward's arithmetic from the (L, 32) fp32 tables into rot (q, then k, each contiguous (B, L, H,
// 64)), which both backward kernels then read.
extern "C" int cm3p_attention_rope_qk(const void* q, const void* k, long long q_bstride, long long k_bstride,
                                      long long q_pstride, long long k_pstride, const void* cos_t, const void* sin_t,
                                      void* rot, int B, int L, int H, void* stream) {
  if (L <= 0 || B <= 0 || H <= 0 || cos_t == nullptr || sin_t == nullptr || rot == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long items = 8ll * B * L * H;
  const int block = cm3p::attn::ROPE_BLOCK;
  sm90_bwd::rope_qk_kernel<<<(unsigned)((items + block - 1) / block), block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, q_bstride, q_pstride, (const __nv_bfloat16*)k, k_bstride, k_pstride,
      (const float*)cos_t, (const float*)sin_t, (__nv_bfloat16*)rot, B, L, H);
  return (int)cudaGetLastError();
}
