// Window (local) and segment (global) attention for Hopper, bf16 in and out.
//
// Replaces the TPU kernels of the JAX package's ops/flash_attention.py
//   _window_fused_kernel (driven by _window_fused_fwd)  -> cm3p_window_attention
//   _seg_unrolled_kernel (driven by _seg_unrolled_fwd)  -> cm3p_segment_attention
//   _fa_kernel (driven by _flash_attention_fwd_impl, the TPU's streaming route
//     for windows wider than 128)                       -> cm3p_window_attention
// forward, with the optional lse output of the training path. Their forms
// with the out-projection epilogue are csrc/attention_wo.cu; their backward is
// csrc/attention_bwd.cu. The rectangular form (cm3p_segment_attention with
// Lk != L) is the TPU kernel's Lq != Lk case: a shard of Lq queries over all
// Lk keys that sequence parallelism gathered, with a key mask as the key
// segments; it has no rope, no window and no lse.
//
// Semantics (the masks and rope of the TPU kernels, not their layout):
//   q, k, v: head-minor (B, L, H, 64) bf16; a position stride is passed so
//     q/k/v may be the three views of the fused Wqkv output.
//   key j is visible to query i iff j < Lk, kseg[j] > 0, qseg[i] == kseg[j]
//     and, for the window kernel, |i - j| <= window. Lk == L but in the
//     rectangular form, whose k, v are (B, Lk, H, 64) and kseg (B, Lk).
//   rope (rotate-half, arange positions) from cos/sin tables of shape (L, 32)
//     fp32 that the wrapper builds; the rotated values are rounded to bf16
//     like the plain version does.
//   softmax scale 1/sqrt(64), fp32 scores and statistics, base-2 exponent.
//   A query with no visible key writes 0, not NaN.
//   lse (optional, fp32 (B, H, L)): the base-2 log-sum-exp of the scaled
//     scores, m + log2(l), written only when the caller passes a buffer (the
//     no-grad path passes none). A query with no visible key gets
//     log2(1e-30), the TPU kernels' value; the backward masks it anyway.
// The TPU kernels shift scores by a fixed power of two instead of tracking
// a running max; that equals the max-stabilised softmax outside a clamp band
// that LayerNormed activations never reach, so this port uses the running
// (online) max.
//
// Design (sm90_attn::attention_kernel), on the attention part of
// csrc/attention_wo.cu's sm90_wo::attention_wo_kernel:
//   * rope of k first: with tables, rope_k_kernel rotates k once, in one
//     bandwidth-bound pass (rope8's rounding), into a contiguous (B, L, H, 64)
//     bf16 scratch the wrapper allocates, and the kernel reads rotated K
//     tiles. Rotating K inside the kernel costs a rotation of every K tile for
//     every query tile and head that visits it (about 20 times per tile at the
//     corpus's windows), which set the pace of the Wo-epilogue kernel; the
//     pass moves each k element once in and once out. Each Q tile is rotated
//     once anyway, as its consumer copies it (below);
//   * key-tile ranges (segment form): key_tile_ranges_kernel, one launch
//     (the wrapper's PyTorch version took about 0.5 ms of host time a call);
//   * one block of three warpgroups per (64-query tile, batch row) walks over
//     the heads in pairs. A producer thread keeps a ring of 16 KB stages full
//     with TMA, through (64 dims, L, H, B) tensor maps over the strided views
//     (positions past L arrive as zeros): for each head pair the Q tiles of
//     its two heads (one stage each), then for each key tile the K and V tiles
//     of the two heads;
//   * two consumer warpgroups take the pair's two heads, so one's softmax
//     overlaps the other's products. A consumer copies its head's Q tile into
//     a tile of its own, rotating it with rope8 (table entries read once per
//     block), and hands the stage back; S = Q K^T is wgmma m64n64k16 from
//     shared memory; each lane loads the segments of two keys of the tile
//     while the stage lands (the mask takes them by shuffles); mask, online
//     softmax (base 2, running max, 2^x by ex2.approx.ftz) and the bf16 P stay
//     in registers; O += P V is wgmma with P from registers and V read
//     MN-major (the transpose flag), so V needs no transposed copy. A warp
//     whose 16 rows lie in one segment skips the per-element test on a key
//     tile whose keys all lie in it (and, in the window form, inside the
//     window). At the end of a head the consumer writes its normalised rows
//     (and lse) to device memory.
//   window form : visits only the key tiles that meet [q0 - w, q0 + 63 + w]
//                 (3 tiles at w = 64), so a local layer costs O(L * w).
//   segment form: visits the key-tile range [start, start + count): tiles
//                 whose segment interval cannot meet the query tile's are
//                 skipped, so a packed row costs about sum(segment_len^2),
//                 not L^2. An empty range writes zeros (and the lse dead
//                 value) and loads nothing. The rectangular form is the same
//                 kernel: its grid runs over the Lq query tiles and its
//                 ranges over the Lk key tiles.
// ptxas serialises every wgmma of a kernel when it cannot prove the warpgroup
// converged or sees accumulators touched between a wgmma and its wait (notes
// C7520, C7514): the consumers' waits keep their polling loop inside the asm
// (mbar_wait_wg), their role tests are warp-uniform, and o is zeroed inside
// the key-tile loop. Each consumer warpgroup has its own ring, so that each
// parity wait tells its phase. Shared memory: two rings of 6 stages of 16 KB
// and two Q tiles. Registers: 168 a thread at launch (384 threads);
// setmaxnreg gives the consumers 232, the producer 40.
// Bound on the H100: at head dim 64 a key tile brings 16 KB for 2 x 64 x 64
// x 64 x 2 flops per query tile, and the 64 x 64 exponentials of its softmax
// take the multi-function units about as long as its two products take the
// tensor cores; the window form is bound by its bytes (q, k, v, out once),
// the segment form by its operations over the visible pairs. Each consumer
// runs scores, softmax and P V of a tile in turn, so the kernel sits at about
// 4x its bound at the packed shape (PERF.md §6).
// Tried and measured: rotating q and k both in the pass (the window form paid
// more for the pass than the Wo-epilogue kernel pays for rotating in place);
// Q in registers (S by wgmma with A from registers) beside the key segments
// in a 1-D TMA box per stage: scores went wrong past the first key tile (the
// cause was not isolated), and a box longer than its vector faulted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;
using namespace cm3p::attn;

// ---------------------------------------------------------------------------
// Key-tile ranges of the segment form (segment_tile_ranges of ops/attention.py,
// the work of the TPU kernels' _block_ranges): per (row, query tile) the first
// and last key tile whose positive-segment interval meets the query tile's,
// as start and count (0, 0 when none). One block per row: one warp per tile
// finds its interval into the row's part of a device scratch (so no length
// is refused for want of shared memory), then one thread per query tile
// scans the key tiles.
constexpr int RANGE_THREADS = 256;
constexpr int NO_SEGMENT = 1 << 30;  // the low end of a tile with no positive segment

// seg: the row's segments, element row0 of tensor t (QSEG or KSEG)
__device__ __forceinline__ void tile_interval(const int* seg, long long row0, int t, int L, int pos0, int lane, int& lo,
                                              int& hi) {
  lo = NO_SEGMENT;
  hi = 0;
  for (int j = lane; j < BQ; j += 32) {
    const int v = pos0 + j < L && BOUNDS_OK(bounds::RANGES, t, row0 + pos0 + j, 1) ? seg[pos0 + j] : 0;
    if (v > 0) lo = min(lo, v), hi = max(hi, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

__global__ void __launch_bounds__(RANGE_THREADS)
    key_tile_ranges_kernel(const int* qseg, const int* kseg, int Lq, int Lk, int* start, int* count, int* bounds) {
  const int b = blockIdx.x, nq = (Lq + BQ - 1) / BQ, nk = (Lk + BK - 1) / BK;
  // low and high ends of the query tiles, then of the key tiles, of this row (element row0 of the scratch)
  const long long row0 = 2LL * b * (nq + nk);
  int *qlo = bounds + row0, *qhi = qlo + nq, *klo = qhi + nq, *khi = klo + nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < nq + nk; t += RANGE_THREADS / 32) {
    const bool is_q = t < nq;
    int lo, hi;
    tile_interval(is_q ? qseg + (long long)b * Lq : kseg + (long long)b * Lk, (long long)b * (is_q ? Lq : Lk),
                  is_q ? bounds::QSEG : bounds::KSEG, is_q ? Lq : Lk, (is_q ? t : t - nq) * BQ, lane, lo, hi);
    // lo of tile t at row0 + t (query tiles) or row0 + 2 nq + t - nq (key tiles), hi nq or nk further
    const long long at = is_q ? row0 + t : row0 + nq + t;
    if (lane == 0 && BOUNDS_OK(bounds::RANGES, bounds::RANGE_SCRATCH, at, 1) &&
        BOUNDS_OK(bounds::RANGES, bounds::RANGE_SCRATCH, at + (is_q ? nq : nk), 1))
      (is_q ? qlo : klo)[is_q ? t : t - nq] = lo, (is_q ? qhi : khi)[is_q ? t : t - nq] = hi;
  }
  __syncthreads();
  // reads of the scratch, checked (a refused read gives 0: an empty tile)
  auto scratch = [&](const int* base, int j) {
    const long long at = base - bounds + j;
    return BOUNDS_OK(bounds::RANGES, bounds::RANGE_SCRATCH, at, 1) ? base[j] : 0;
  };
  for (int t = threadIdx.x; t < nq; t += RANGE_THREADS) {
    int first = -1, last = -1;
    if (scratch(qhi, t) > 0)
      for (int j = 0; j < nk; ++j)
        if (scratch(qlo, t) <= scratch(khi, j) && scratch(klo, j) <= scratch(qhi, t) && scratch(khi, j) > 0) {
          if (first < 0) first = j;
          last = j;
        }
    const long long at = (long long)b * nq + t;
    if (BOUNDS_OK(bounds::RANGES, bounds::START, at, 1)) start[at] = first < 0 ? 0 : first;
    if (BOUNDS_OK(bounds::RANGES, bounds::COUNT, at, 1)) count[at] = first < 0 ? 0 : last - first + 1;
  }
}

// ---------------------------------------------------------------------------
// The rope pass: k (a strided (B, L, H, 64) view) rotated into out, contiguous (B, L, H, 64).
__global__ void __launch_bounds__(ROPE_BLOCK) rope_k_kernel(AttnArgs a, __nv_bfloat16* out, int B) {
  const long long i = (long long)blockIdx.x * ROPE_BLOCK + threadIdx.x;
  if (i < (long long)B * a.L * a.H * 4)
    rope_item(a.k, a.k_bstride, a.k_pstride, a.cos_t, a.sin_t, out, a.L, a.H, i, bounds::ROPE_K, bounds::K, 0);
}

// ---------------------------------------------------------------------------
// The attention kernel (see the note at the top).
namespace sm90_attn {

using namespace cm3p::sm90;

constexpr int THREADS = 384;                 // consumer warpgroups 0 and 1, the producer 2
constexpr int TILE_BYTES = BQ * D * 2;       // a 64 x 64 bf16 tile of 128-byte rows
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K and V of one (head, key tile), or the Q tile of one head
constexpr int SMEM_MAX = 232448;             // dynamic shared memory a block may use on the H100
constexpr int PER_STAGE = STAGE_BYTES + 2 * 8;  // tiles, full and empty barriers
constexpr int Q_BYTES = 2 * TILE_BYTES;         // each consumer warpgroup's Q tile
constexpr int RING = (SMEM_MAX - 1024 - Q_BYTES) / PER_STAGE / 2;  // stages of each consumer warpgroup's ring
constexpr int STAGES = 2 * RING;
constexpr int BYTES = 1024 + Q_BYTES + STAGES * PER_STAGE;
static_assert(RING >= 2, "a ring of one stage would serialise loads and products");

struct Params {
  const int* qseg;        // (B, L)
  const int* kseg;        // (B, Lk)
  const float* cos_t;     // (L, 32) or null: rotate each Q tile (k comes rotated)
  const float* sin_t;
  const int* tile_start;  // (B, nq), segment form only
  const int* tile_count;
  __nv_bfloat16* out;     // (B, L, H, 64)
  float* lse;             // (B, H, L) or null
  int L, Lk, H, window;
};

// 2^x with the hardware's approximation and denormal results flushed to zero (exp2f adds a denormal
// range fix-up of three instructions per element; a p below 2^-126 is nothing beside the row's 1).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float EMPTY_LSE = -99.65784284662087f;  // log2(1e-30)

template <bool WINDOW>
__global__ void __launch_bounds__(THREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = ring + STAGES * STAGE_BYTES;  // consumer warpgroup w's Q tile at w TILE_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(sQ + Q_BYTES);  // the stage's tiles landed
  uint64_t* empty = full + STAGES;  // the owning consumer warpgroup is done with it (its 4 warps)
  // Consumer warpgroup w owns the ring of stages w RING .. w RING + RING - 1 and takes its stages in order, so
  // when it waits for round r of a stage, round r - 1 was its own and has landed: each parity wait tells its
  // phase (in a ring the two shared, another warpgroup's stage could still be landing there).

  constexpr int KID = WINDOW ? bounds::ATTN_WINDOW : bounds::ATTN_SEGMENT;
  const int qt = blockIdx.x, b = blockIdx.y;
  const int L = p.L, Lk = p.Lk, H = p.H, q0 = qt * BQ;
  const int nk = (Lk + BK - 1) / BK;  // key tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int kt_begin, kt_end;
  if (WINDOW) {
    kt_begin = max(0, q0 - p.window) / BK;
    kt_end = min(Lk - 1, q0 + BQ - 1 + p.window) / BK + 1;
  } else {
    const int at = b * gridDim.x + qt;
    kt_begin = BOUNDS_OK(KID, bounds::START, at, 1) ? p.tile_start[at] : 0;
    kt_end = kt_begin + (BOUNDS_OK(KID, bounds::COUNT, at, 1) ? p.tile_count[at] : 0);
  }
  // a range read from the tensors must lie in [0, nk]; the checked build records one that does not and visits
  // nothing
  if (!(IN_RANGE(KID, bounds::TILE, kt_begin, nk + 1) && IN_RANGE(KID, bounds::TILE, kt_end, nk + 1) &&
        IN_RANGE(KID, bounds::TILE, kt_end - kt_begin, nk + 1)))
    kt_begin = kt_end = 0;
  const int nkt = kt_end - kt_begin;
  // The order of the loads: for each head pair hp, the Q stages of heads 2 hp and 2 hp + 1, then for each
  // key tile their K/V stages; consumer warpgroup w takes head 2 hp + w from its ring, 1 + nkt stages per
  // pair. Only the last pair can have one head (H odd).
  const int npairs = (H + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform, as the compiler can see
  if (wg == 2) {  // producer: one thread issues every load
    regs_dealloc<40>();
    if (warp == 8 && lane == 0 && nkt > 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      int idx[2] = {0, 0};
      auto acquire = [&](int w, uint32_t bytes) {
        int s = w * RING + idx[w] % RING;
        if (!IN_RANGE(KID, bounds::STAGE, s, STAGES)) s = 0;
        mbar_wait(&empty[s], ((idx[w] / RING) & 1) ^ 1);
        mbar_expect_tx(&full[s], bytes);
        ++idx[w];
        return s;
      };
      for (int hp = 0; hp < npairs; ++hp) {
        const int nh = min(2, H - 2 * hp);
        for (int w = 0; w < nh; ++w) {
          const int s = acquire(w, TILE_BYTES);
          IN_RANGE(KID, bounds::TILE, qt, (L + BQ - 1) / BQ);
          IN_RANGE(KID, bounds::HEAD, 2 * hp + w, H);
          IN_RANGE(KID, bounds::ROW, b, gridDim.y);
          tma_load_4d(ring + s * STAGE_BYTES, &map_q, &full[s], 0, q0, 2 * hp + w, b);
        }
        for (int kt = kt_begin; kt < kt_end; ++kt)
          for (int w = 0; w < nh; ++w) {
            const int s = acquire(w, STAGE_BYTES);
            IN_RANGE(KID, bounds::TILE, kt, nk);
            IN_RANGE(KID, bounds::HEAD, 2 * hp + w, H);
            IN_RANGE(KID, bounds::ROW, b, gridDim.y);
            unsigned char* st = ring + s * STAGE_BYTES;
            tma_load_4d(st, &map_k, &full[s], 0, kt * BK, 2 * hp + w, b);
            tma_load_4d(st + TILE_BYTES, &map_v, &full[s], 0, kt * BK, 2 * hp + w, b);
          }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes heads wg, wg + 2, ...; warp wl of it owns rows 16 wl .. 16 wl + 15
  regs_alloc<232>();
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int rw = 16 * wl;
  int qi[2], qs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + rw + g + 8 * hr;
    qs[hr] = qi[hr] < L && BOUNDS_OK(KID, bounds::QSEG, (long long)b * L + qi[hr], 1) ? p.qseg[(long long)b * L + qi[hr]]
                                                                                        : -1;
  }
  if (nkt == 0) {  // no query of the tile sees a key: out = 0, lse the dead value
    for (int h = wg; h < H; h += 2)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (qi[hr] >= L) continue;
        const long long o = (((long long)b * L + qi[hr]) * H + h) * D + 2 * t4, li = ((long long)b * H + h) * L + qi[hr];
        __nv_bfloat16* op = p.out + o;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          if (BOUNDS_OK(KID, bounds::OUT, o + 8 * dt, 2)) *reinterpret_cast<uint32_t*>(op + 8 * dt) = 0u;
        if (p.lse != nullptr && t4 == 0 && BOUNDS_OK(KID, bounds::LSE, li, 1)) p.lse[li] = EMPTY_LSE;
      }
    return;
  }
  // the segment all 16 rows of this warp share (> 0), else -2, which no key segment equals
  const int first = __shfl_sync(0xffffffffu, qs[0], 0);
  const int quni = (__all_sync(0xffffffffu, qs[0] == first && qs[1] == first) && first > 0) ? first : -2;
  const float sc = 0.125f * 1.4426950408889634f;
  const int* kseg = p.kseg + (long long)b * Lk;
  unsigned char* sq = sQ + wg * TILE_BYTES;
  const uint64_t dq = desc_sw128(sq);
  // this thread's part of each Q tile: row t / 2, 16-byte chunks c = 2 (t % 2) + i (dims 8 c .. 8 c + 7) and
  // their partners c + 4; with rope, the tables' entries for them, read once for all heads
  const int qt_row = (threadIdx.x & 127) >> 1, qt_c = 2 * (threadIdx.x & 1);
  const bool rope_q = p.cos_t != nullptr && q0 + qt_row < L;
  float cs[2][8], sn[2][8];
  if (rope_q)
#pragma unroll
    for (int i = 0; i < 2; ++i) load_tables(p.cos_t, p.sin_t, q0 + qt_row, 8 * (qt_c + i), cs[i], sn[i], KID);

  for (int hp = 0; hp < npairs; ++hp) {
    const int nh = min(2, H - 2 * hp);
    if (wg >= nh) break;
    const int h = 2 * hp + wg, base = hp * (1 + nkt);  // this warpgroup's stages before the pair
    // the head's Q tile, rotated when rope is on, into this warpgroup's own (the previous head's products that
    // read it are done), then its stage goes back
    {
      int s = wg * RING + base % RING;
      if (!IN_RANGE(KID, bounds::STAGE, s, STAGES)) s = 0;
      mbar_wait_wg(&full[s], (base / RING) & 1);
      const unsigned char* src = ring + s * STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ox = swizzle128(qt_row, 16 * (qt_c + i)), oy = swizzle128(qt_row, 16 * (qt_c + i + 4));
        uint4 ux = *reinterpret_cast<const uint4*>(src + ox), uy = *reinterpret_cast<const uint4*>(src + oy);
        if (rope_q) rope_packed(ux, uy, cs[i], sn[i]);
        *reinterpret_cast<uint4*>(sq + ox) = ux;
        *reinterpret_cast<uint4*>(sq + oy) = uy;
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // o is zeroed inside the key-tile loop, at its first tile: zeroing it here makes ptxas serialise every
    // wgmma of the kernel (C7514, "non wgmma instructions reading accumulator registers")
    float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int idx = base + 1 + kt - kt_begin, k0 = kt * BK;
      int s = wg * RING + idx % RING;
      if (!IN_RANGE(KID, bounds::STAGE, s, STAGES)) s = 0;
      // lane l holds the segments of keys k0 + 2 l and k0 + 2 l + 1 (0 past Lk), loaded while the stage lands
      const int j0 = k0 + 2 * lane;
      const long long kat = (long long)b * Lk + j0;
      const int kx = j0 < Lk && BOUNDS_OK(KID, bounds::KSEG, kat, 1) ? __ldg(kseg + j0) : 0;
      const int ky = j0 + 1 < Lk && BOUNDS_OK(KID, bounds::KSEG, kat + 1, 1) ? __ldg(kseg + j0 + 1) : 0;
      mbar_wait_wg(&full[s], (idx / RING) & 1);
      unsigned char* st = ring + s * STAGE_BYTES;
      float sa[32];
      wgmma_fence();
      const uint64_t dk = desc_sw128(st);
#pragma unroll
      for (int k = 0; k < D / 16; ++k) wgmma_bf16_n64(sa, dq + 2 * k, dk + 2 * k, k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);

      // accumulator i: row rw + g + 8 ((i / 2) % 2), key column 8 (i / 4) + 2 t4 + i % 2
      bool whole = quni > 0 && kx == quni && ky == quni;
      if (WINDOW) whole = whole && max(q0 + rw + 15 - k0, k0 + BK - 1 - q0 - rw) <= p.window;
      whole = __all_sync(0xffffffffu, whole);
      float mx[2] = {-INFINITY, -INFINITY};
      if (whole) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sa[i] *= sc;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sa[i]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // key columns 8 j + 2 t4 (+ 1) are lane 4 j + t4's
          const int kvx = __shfl_sync(0xffffffffu, kx, 4 * j + t4), kvy = __shfl_sync(0xffffffffu, ky, 4 * j + t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, hr = e >> 1, col = 8 * j + 2 * t4 + (e & 1), kseg_j = (e & 1) ? kvy : kvx;
            bool ok = kseg_j > 0 && kseg_j == qs[hr];
            if (WINDOW) ok = ok && abs(qi[hr] - (k0 + col)) <= p.window;
            sa[i] = ok ? sa[i] * sc : -INFINITY;
            mx[hr] = fmaxf(mx[hr], sa[i]);
          }
        }
      }
      float alpha[2], mb[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float mn = fmaxf(m[hr], mx[hr]);
        mb[hr] = (mn == -INFINITY) ? 0.f : mn;
        alpha[hr] = ex2_ftz(m[hr] - mb[hr]);
        m[hr] = mn;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hr = (i >> 1) & 1;
        sa[i] = ex2_ftz(sa[i] - mb[hr]);
        ls[hr] += sa[i];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ls[hr];
      const bool first_tile = kt == kt_begin;  // o starts here: zero, then the first product
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = first_tile ? 0.f : o[i] * alpha[(i >> 1) & 1];
      uint32_t pa[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[ks][e] = pack_bf16(sa[8 * ks + 2 * e], sa[8 * ks + 2 * e + 1]);
      wgmma_fence();
      const uint64_t dv = desc_sw128(st + TILE_BYTES);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_bf16_n64_rs_mn(o, pa[ks], dv + 128 * ks, 1);  // 16 keys = 2,048 bytes
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the head's normalised rows, and their lse
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      if (qi[hr] >= L) continue;
      const float inv = l[hr] > 0.f ? 1.f / l[hr] : 0.f;
      const long long oo = (((long long)b * L + qi[hr]) * H + h) * D + 2 * t4, li = ((long long)b * H + h) * L + qi[hr];
      __nv_bfloat16* op = p.out + oo;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        if (BOUNDS_OK(KID, bounds::OUT, oo + 8 * dt, 2))
          *reinterpret_cast<uint32_t*>(op + 8 * dt) = pack_bf16(o[4 * dt + 2 * hr] * inv, o[4 * dt + 2 * hr + 1] * inv);
      if (p.lse != nullptr && t4 == 0 && BOUNDS_OK(KID, bounds::LSE, li, 1))
        p.lse[li] = l[hr] > 0.f ? m[hr] + log2f(l[hr]) : EMPTY_LSE;
    }
  }
}

template <bool WINDOW>
int launch(const AttnArgs& a, __nv_bfloat16* out, float* lse, int B, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  // (64 dims, L positions, H heads, B rows) over the strided views; heads lie 64 elements apart
  if (!make_map_4d_bf16(&mq, a.q, D, a.L, a.H, B, a.q_pstride, D, a.q_bstride, D, BQ) ||
      !make_map_4d_bf16(&mk, a.k, D, a.Lk, a.H, B, a.k_pstride, D, a.k_bstride, D, BK) ||
      !make_map_4d_bf16(&mv, a.v, D, a.Lk, a.H, B, a.v_pstride, D, a.v_bstride, D, BK))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)attention_kernel<WINDOW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  const Params p{a.qseg, a.kseg, a.cos_t, a.sin_t, a.tile_start, a.tile_count, out, lse, a.L, a.Lk, a.H, a.window};
  dim3 grid((a.L + BQ - 1) / BQ, B);
  attention_kernel<WINDOW><<<grid, THREADS, BYTES, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90_attn

// With rope tables: k rotated into `rot` by the pass, then the attention kernel over it (which rotates each Q
// tile itself).
template <bool WINDOW>
int launch(AttnArgs a, __nv_bfloat16* rot, __nv_bfloat16* out, float* lse, int B, void* stream) {
  if (a.L <= 0 || B <= 0 || B > 65535 || a.H <= 0 || a.Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.cos_t != nullptr) {
    if (rot == nullptr || a.Lk != a.L) return (int)cudaErrorInvalidValue;
    const long long items = 4ll * B * a.L * a.H;
    rope_k_kernel<<<(unsigned)((items + ROPE_BLOCK - 1) / ROPE_BLOCK), ROPE_BLOCK, 0, st>>>(a, rot, B);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a.k = rot;
    a.k_bstride = (long long)a.L * a.H * D;
    a.k_pstride = (long long)a.H * D;
  }
  return sm90_attn::launch<WINDOW>(a, out, lse, B, st);
}

}  // namespace

// q, k, v: head-minor (B, L, H, 64) bf16 views (strides in elements); qseg,
// kseg (B, L) int32, kseg 16-byte aligned; cos_t, sin_t (L, 32) fp32 or null;
// rot: (B, L, H, 64) bf16 scratch when the tables are given (the rotated k),
// else null; out (B, L, H, 64) contiguous bf16; lse (B, H, L) fp32 or
// null. Returns cudaErrorInvalidValue when the driver refuses a tensor map.
extern "C" int cm3p_window_attention(const void* q, const void* k, const void* v,
                                     long long q_bstride, long long k_bstride, long long v_bstride,
                                     long long q_pstride, long long k_pstride, long long v_pstride,
                                     const void* qseg, const void* kseg, const void* cos_t,
                                     const void* sin_t, void* rot, void* out, void* lse, int B, int L,
                                     int H, int window, void* stream) {
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride,
                         v_pstride, qseg, kseg, cos_t, sin_t, L, H);
  if (window < 0) return (int)cudaErrorInvalidValue;
  a.window = window;
  return launch<true>(a, (__nv_bfloat16*)rot, (__nv_bfloat16*)out, (float*)lse, B, stream);
}

// As above, and k, v (B, Lk, H, 64) with kseg (B, Lk); tile_start, tile_count
// (B, ceil(L / 64)) int32 key-tile ranges. Lk == L but in the rectangular
// form, which takes no rope tables and no lse.
extern "C" int cm3p_segment_attention(const void* q, const void* k, const void* v,
                                      long long q_bstride, long long k_bstride, long long v_bstride,
                                      long long q_pstride, long long k_pstride, long long v_pstride,
                                      const void* qseg, const void* kseg, const void* cos_t,
                                      const void* sin_t, const void* tile_start,
                                      const void* tile_count, void* rot, void* out, void* lse, int B,
                                      int L, int Lk, int H, void* stream) {
  if (Lk <= 0 || (Lk != L && (cos_t != nullptr || lse != nullptr))) return (int)cudaErrorInvalidValue;
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride,
                         v_pstride, qseg, kseg, cos_t, sin_t, L, H);
  a.Lk = Lk;
  a.tile_start = (const int*)tile_start;
  a.tile_count = (const int*)tile_count;
  return launch<false>(a, (__nv_bfloat16*)rot, (__nv_bfloat16*)out, (float*)lse, B, stream);
}

// qseg (B, Lq) and kseg (B, Lk) int32; start, count (B, ceil(Lq / 64)) int32
// out: the key-tile ranges of the segment forms (forward, backward with the
// roles swapped, and the Wo epilogue). bounds: int32 scratch of
// 2 * B * (ceil(Lq / 64) + ceil(Lk / 64)) entries.
extern "C" int cm3p_key_tile_ranges(const void* qseg, const void* kseg, void* start, void* count, void* bounds,
                                    int B, int Lq, int Lk, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  key_tile_ranges_kernel<<<B, RANGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)qseg, (const int*)kseg, Lq, Lk, (int*)start, (int*)count, (int*)bounds);
  return (int)cudaGetLastError();
}
