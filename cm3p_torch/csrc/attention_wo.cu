// Window and segment attention with the out-projection epilogue for Hopper:
//     out = res + bf16( bf16(attention(q, k, v)) . Wo^T )            (bf16 form)
//     out = res + bf16( float(int8(o) . Wo_q^T) * sa * sw )           (int8 form)
//
// Replaces the fuse_wo forms of the TPU kernels of the JAX package's
// ops/flash_attention.py (the CM3P_FUSED_WO / CM3P_FUSED_WO_Q gates):
//   _window_fused_kernel (driven by _window_fused_fwd), epilogue :444-461
//       -> cm3p_attention_wo with window >= 0
//   _seg_unrolled_kernel (driven by _seg_unrolled_fwd), epilogue :671-685
//       -> cm3p_attention_wo with a key-tile range (segment form)
// Attention semantics (masks, rope, online softmax) are those of
// csrc/attention.cu; the attention output o never reaches device memory.
//
// Rounding points kept from the TPU kernels: each head's normalised o is
// rounded to bf16 (o_scr); the product accumulates in fp32 and is cast to
// bf16; then the bf16 residual is added and rounded once more. The int8 form
// quantises each bf16 o row over all H*64 columns with the quantiser of
// csrc/ln_rows.cuh (sa = max(amax, 1e-30) / 127, true division, round half
// to even), multiplies int8 x int8 -> int32 (exact) with Wo codes per output
// channel and forms bf16(float(acc) * sa * sw[n]) in that order, then adds
// the residual. A query that sees no key has o = 0, so its row is the
// residual exactly in both forms.
//
// bf16 form (sm90_wo::attention_wo_kernel<WINDOW, HD, false>, rows 1w and
// 2w), designed for Hopper. One block of five warpgroups owns one (64-query tile, batch row) and
// every head, because the epilogue needs the whole H*64-column o row:
//   * a producer thread keeps a ring of 16 KB stages full with TMA: a stage is
//     the K and V tiles of one (head, key tile), 64 x 64 bf16 each, loaded
//     through (64 dims, L, H, B) tensor maps over the strided q / k / v views
//     (positions past L arrive as zeros), or, for the epilogue, a 128 x 64 box
//     of Wo. Every tile lies in the 128-byte swizzle that wgmma reads;
//   * two rope warpgroups rotate each landed K tile in place (rope8's rounding,
//     one 8-dim item a thread; a key tile's table rows and segments are read
//     once for the two heads that take it one after the other), copy the
//     tile's key segments beside it, note for each half of the tile whether
//     all its keys share one segment, and mark the stage ready; they pass the
//     Wo boxes on in order. At the start they rotate the H Q tiles, which TMA
//     put in the heads' 64-column chunks of the o tile;
//   * two consumer warpgroups take alternate heads (0, 2, ... and 1, 3, ...),
//     so one's softmax overlaps the other's products: S = Q K^T is wgmma
//     m64n64k16 from shared memory; mask, online softmax (base 2, running max,
//     2^x by ex2.approx.ftz) and the bf16 P stay in registers; O += P V is
//     wgmma with P from registers and V read MN-major (the transpose flag), so
//     V needs no transposed copy. A warp whose 16 rows lie in one segment skips the
//     per-element test on a key tile whose keys all lie in it (and, in the
//     window form, inside the window). At the end of a head the normalised o
//     is rounded to bf16 over Q in the head's chunk;
//   * epilogue: the warpgroups take alternate 128-column tiles of the output;
//     each multiplies the o tile (its H chunks by descriptor) by the Wo boxes
//     of the ring with wgmma m64n128k16, then adds the residual.
// ptxas serialises every wgmma of a kernel (a wait after each) when it cannot
// prove the warpgroup converged or sees accumulators touched between a wgmma
// and its wait (ptxas notes C7520, C7514). So the consumers' waits keep their
// polling loop inside the asm (mbar_wait_wg), their role test is warp-uniform,
// and o is zeroed inside the key-tile loop; phase 1 of chip_smoke.py prints
// the notes.
// A query tile whose segment range is empty writes the residual and loads
// nothing. Shared memory at H*64 = 768: the 96 KB o tile and 7 stages (8 at
// 512 and 256). Registers: 96 a thread at launch (640 threads); setmaxnreg
// gives the consumers 160, the rope warpgroups 64, the producer 32.
// Bound on the H100: the window forms by their bytes, the segment forms by
// their operations (at the extraction shape the epilogue adds 2 x 64 x 768 x
// 768 flops per tile). What holds it above (PERF.md §6, PR 8): the rotation
// of every K tile for every query tile and head, which keeps the rope
// warpgroups about as busy as the consumers, and the consumers' own chain
// (scores, softmax, P V in turn). The stages come from L2 at about 8 TB/s
// when nothing else limits them.
// Tried and measured slower: pairing query tiles in 2-CTA clusters that
// multicast each stage (the union of two key ranges and the lockstep cost
// more than the halved L2 bytes), fetching the next key tile's table rows
// ahead (an outstanding global load makes the rope warpgroups' proxy fence
// wait), bringing the table rows by TMA, P through shared memory, forming the
// next scores while the last P V product runs, and taking turns between the
// consumer warpgroups.
//
// int8 form (rows 1wq and 2wq): the same kernel, attention_wo_kernel<WINDOW,
// HD, true>; only its epilogue differs. When the o tile is complete, each of
// the 8 consumer warps quantises whole rows (lane l reads columns 64 i + 2 l,
// 2 l + 1 of every head chunk; the row's absmax by shuffles, then
// quant_row_int8_each of csrc/ln_rows.cuh) and writes the codes in place over
// the bf16 tile's first HD / 128 chunks, laid out and swizzled as int8 wgmma
// reads them (64 rows x 128 codes each; a row's codes overwrite only that
// row's lines, which its warp has read), and the row scales beside it. The
// Wo codes stream through the ring as 128 x 128 boxes, and each warpgroup
// multiplies with int8 wgmma m64n128k32 (exact int32), then forms
// bf16(float(acc) * sa * sw[n]) and adds the residual. Shared memory and
// registers as the bf16 form (plus 256 bytes of row scales).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_fwd.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;
using namespace cm3p::attn;

constexpr int BN = 128;  // N must be a multiple of this

struct WoArgs {
  const void* wo;              // (N, HD) bf16, or int8 codes in the int8 form
  const float* sw;             // (N,) fp32 weight scales (int8 form)
  const __nv_bfloat16* res;    // (B, L, N)
  __nv_bfloat16* out;          // (B, L, N)
  __nv_bfloat16* o_out;        // (B, L, HD) or null: the bf16 o tile, for checks only
  int8_t* codes_out;           // (B, L, HD) or null: the int8 o codes, for checks only
  int N;
};

// ---------------------------------------------------------------------------
// The bf16 form: warp-specialised, TMA ring, wgmma (see the note at the top).
namespace sm90_wo {

using namespace cm3p::sm90;

constexpr int ROPE_THREADS = 256;            // two rope warpgroups: one item of a 64 x 64 tile each
constexpr int THREADS = 384 + ROPE_THREADS;  // consumer warpgroups 0 and 1, the producer 2, rope 3 and 4
constexpr int TILE_BYTES = BQ * D * 2;       // a 64 x 64 bf16 tile of 128-byte rows
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K and V of one (head, key tile), or a 128-row box of Wo
constexpr int SMEM_MAX = 232448;             // dynamic shared memory a block may use on the H100
constexpr int MAX_STAGES = 8;

template <int HD, bool INT8>
struct Layout {
  static constexpr int H = HD / D;
  // the o tile: H chunks of 64 x 64, Q first; in the int8 form its first HD / 128 chunks end up holding o's codes
  static constexpr int O_BYTES = H * TILE_BYTES;
  static constexpr int KB = INT8 ? HD / 128 : H;  // Wo boxes per output tile: 128 x 64 bf16 or 128 x 128 int8
  static constexpr int SA_BYTES = INT8 ? BQ * 4 : 0;  // the int8 form's row scales
  // a stage: its tiles, its 64 key segments, two "one segment" notes, three barriers
  static constexpr int PER_STAGE = STAGE_BYTES + BK * 4 + 2 * 4 + 3 * 8;
  static constexpr int FIT = (SMEM_MAX - 1024 - O_BYTES - 2 * 8 - SA_BYTES) / PER_STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BYTES = 1024 + O_BYTES + STAGES * PER_STAGE + 2 * 8 + SA_BYTES;
  static_assert(H % 2 == 0, "the two consumer warpgroups take alternate heads");
  static_assert(STAGES >= 3, "a consumer's wait must tell its phase: it may trail the ring by two stages");
};

struct Params {
  const int* qseg;  // (B, L)
  const int* kseg;  // (B, L)
  const float* cos_t;  // (L, 32) or null
  const float* sin_t;
  const int* tile_start;  // (B, nq), segment form only
  const int* tile_count;
  const __nv_bfloat16* res;  // (B, L, N)
  __nv_bfloat16* out;        // (B, L, N)
  __nv_bfloat16* o_out;      // (B, L, HD) or null
  const float* sw;           // (N,) Wo's scales (int8 form)
  int8_t* codes_out;         // (B, L, HD) or null (int8 form)
  int L, N, window;
};

// 2^x with the hardware's approximation and denormal results flushed to zero (exp2f adds a denormal
// range fix-up of three instructions per element; a p below 2^-126 is nothing beside the row's 1).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool WINDOW, int HD, bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
    attention_wo_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_wo,
                        const Params p) {
  using Cfg = Layout<HD, INT8>;
  constexpr int H = Cfg::H, STAGES = Cfg::STAGES, KB = Cfg::KB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sO =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sO + Cfg::O_BYTES;
  int* sKseg = reinterpret_cast<int*>(ring + STAGES * STAGE_BYTES);  // STAGES x 64 key segments
  int* sKuni = sKseg + STAGES * BK;  // STAGES x 2: the segment all 32 keys of a half share, else -1
  uint64_t* full = reinterpret_cast<uint64_t*>(sKuni + STAGES * 2);  // the stage's tiles landed
  uint64_t* ready = full + STAGES;  // K rotated, key segments noted (every rope thread)
  uint64_t* empty = ready + STAGES;  // the owning consumer warpgroup is done with it (its 4 warps)
  uint64_t* qfull = empty + STAGES;  // the H Q tiles landed
  uint64_t* qready = qfull + 1;      // ... and are rotated
  float* sSa = reinterpret_cast<float*>(qready + 1);  // the int8 form's row scales

  const int qt = blockIdx.x, b = blockIdx.y;
  const int L = p.L, q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int kt_begin, kt_end;
  if (WINDOW) {
    kt_begin = max(0, q0 - p.window) / BK;
    kt_end = min(L - 1, q0 + BQ - 1 + p.window) / BK + 1;
  } else {
    kt_begin = p.tile_start[b * gridDim.x + qt];
    kt_end = kt_begin + p.tile_count[b * gridDim.x + qt];
  }
  const int nkt = kt_end - kt_begin;
  const int n_tiles = p.N / BN;
  // The ring's order, which every role walks: for each head pair, for each key tile, the K/V stages of
  // heads 2 hp and 2 hp + 1 (consumer warpgroups 0 and 1); then, for each pair of output tiles, for each
  // chunk kb of Wo's input (64 columns, or 128 int8 ones), the boxes of tiles 2 j (warpgroup 0) and 2 j + 1
  // (warpgroup 1).
  const int attn_stages = H * nkt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], ROPE_THREADS);
      mbar_init(&empty[s], 4);
    }
    mbar_init(qfull, 1);
    mbar_init(qready, ROPE_THREADS);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);  // warp-uniform, as the compiler can see
  if (wg == 2) {  // producer: one thread issues every load
    regs_dealloc<32>();
    if (warp == 8 && lane == 0 && nkt > 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_wo);
      mbar_expect_tx(qfull, H * TILE_BYTES);
      for (int h = 0; h < H; ++h) tma_load_4d(sO + h * TILE_BYTES, &map_q, qfull, 0, q0, h, b);
      int idx = 0;
      auto acquire = [&]() {
        const int s = idx % STAGES;
        mbar_wait(&empty[s], ((idx / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        ++idx;
        return s;
      };
      for (int hp = 0; hp < H / 2; ++hp)
        for (int kt = kt_begin; kt < kt_end; ++kt)
          for (int w = 0; w < 2; ++w) {
            const int s = acquire();
            unsigned char* st = ring + s * STAGE_BYTES;
            tma_load_4d(st, &map_k, &full[s], 0, kt * BK, 2 * hp + w, b);
            tma_load_4d(st + TILE_BYTES, &map_v, &full[s], 0, kt * BK, 2 * hp + w, b);
          }
      for (int nt0 = 0; nt0 < n_tiles; nt0 += 2)
        for (int kb = 0; kb < KB; ++kb)
          for (int nt = nt0; nt < min(nt0 + 2, n_tiles); ++nt) {
            const int s = acquire();
            tma_load_2d(ring + s * STAGE_BYTES, &map_wo, &full[s], kb * (INT8 ? 128 : D), nt * BN);
          }
    }
    return;
  }

  if (wg >= 3) {  // rope, 256 threads: rotates Q and each K tile in place, notes the key segments
    regs_dealloc<64>();
    if (nkt == 0) return;
    const int t = threadIdx.x - 384;
    // this thread's item of a tile: row r, dims c .. c + 7 and their partners c + 32 .. c + 39
    const int r = t >> 2, c = (t & 3) * 8;
    const bool rope = p.cos_t != nullptr;
    float cs[8], sn[8];
    auto load_tables = [&](int pos0) {
      const int pos = pos0 + r;
      if (pos >= L) return;
      const float4* cp = reinterpret_cast<const float4*>(p.cos_t + (long long)pos * (D / 2) + c);
      const float4* sp = reinterpret_cast<const float4*>(p.sin_t + (long long)pos * (D / 2) + c);
      const float4 c0 = __ldg(cp), c1 = __ldg(cp + 1), s0 = __ldg(sp), s1 = __ldg(sp + 1);
      cs[0] = c0.x, cs[1] = c0.y, cs[2] = c0.z, cs[3] = c0.w, cs[4] = c1.x, cs[5] = c1.y, cs[6] = c1.z, cs[7] = c1.w;
      sn[0] = s0.x, sn[1] = s0.y, sn[2] = s0.z, sn[3] = s0.w, sn[4] = s1.x, sn[5] = s1.y, sn[6] = s1.z, sn[7] = s1.w;
    };
    auto rotate = [&](unsigned char* tile, int pos0) {
      if (pos0 + r >= L) return;  // zeros past L
      uint4* px = reinterpret_cast<uint4*>(tile + swizzle128(r, 2 * c));
      uint4* py = reinterpret_cast<uint4*>(tile + swizzle128(r, 2 * c + D));
      float x[8], y[8];
      unpack8(*px, x);
      unpack8(*py, y);
      rope8(x, y, cs, sn);
      *px = pack8(x);
      *py = pack8(y);
    };
    mbar_wait(qfull, 0);
    if (rope) {
      load_tables(q0);
      for (int h = 0; h < H; ++h) rotate(sO + h * TILE_BYTES, q0);
    }
    fence_proxy_async();
    mbar_arrive(qready);
    const int* kseg = p.kseg + (long long)b * L;
    int idx = 0;
    for (int hp = 0; hp < H / 2; ++hp)
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;  // the key tile's table rows and segments serve its two stages
        if (rope) load_tables(k0);
        const int ks = (t < BK && k0 + t < L) ? kseg[k0 + t] : 0;
        for (int w = 0; w < 2; ++w, ++idx) {
          const int s = idx % STAGES;
          mbar_wait(&full[s], (idx / STAGES) & 1);
          if (rope) rotate(ring + s * STAGE_BYTES, k0);
          if (t < BK) {  // the first two rope warps: one key each
            sKseg[s * BK + t] = ks;
            const int first = __shfl_sync(0xffffffffu, ks, 0);
            const bool same = __all_sync(0xffffffffu, ks == first);
            if (lane == 0) sKuni[2 * s + (t >> 5)] = same ? first : -1;
          }
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    for (; idx < attn_stages + KB * n_tiles; ++idx) {  // Wo boxes: pass them on in order
      const int s = idx % STAGES;
      mbar_wait(&full[s], (idx / STAGES) & 1);
      mbar_arrive(&ready[s]);
    }
    return;
  }

  // ---- consumers: warpgroup wg takes heads wg, wg + 2, ...; warp wl of it owns rows 16 wl .. 16 wl + 15
  regs_alloc<160>();
  const int ct = threadIdx.x;  // 0 .. 255
  const int wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int rw = 16 * wl;
  const long long row0 = (long long)b * L + q0;
  if (nkt == 0) {  // no query of the tile sees a key: out = res, o = 0 (and its codes)
    for (int item = ct; item < BQ * (p.N / 8); item += 256) {
      const int r = item / (p.N / 8), col = (item % (p.N / 8)) * 8;
      if (q0 + r < L)
        *reinterpret_cast<uint4*>(p.out + (row0 + r) * p.N + col) =
            *reinterpret_cast<const uint4*>(p.res + (row0 + r) * p.N + col);
    }
    for (int item = ct; item < BQ * (HD / 8); item += 256) {
      const int r = item / (HD / 8), col = (item % (HD / 8)) * 8;
      if (q0 + r >= L) continue;
      if (p.o_out != nullptr) *reinterpret_cast<uint4*>(p.o_out + (row0 + r) * HD + col) = make_uint4(0u, 0u, 0u, 0u);
      if (INT8 && p.codes_out != nullptr) *reinterpret_cast<uint2*>(p.codes_out + (row0 + r) * HD + col) = make_uint2(0u, 0u);
    }
    return;
  }

  int qi[2], qs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + rw + g + 8 * hr;
    qs[hr] = qi[hr] < L ? p.qseg[(long long)b * L + qi[hr]] : -1;
  }
  // the segment all 16 rows of this warp share (> 0), else -2, which no key note equals
  const int first = __shfl_sync(0xffffffffu, qs[0], 0);
  const int quni = (__all_sync(0xffffffffu, qs[0] == first && qs[1] == first) && first > 0) ? first : -2;
  const float sc = 0.125f * 1.4426950408889634f;

  mbar_wait_wg(qready, 0);
  for (int hp = 0; hp < H / 2; ++hp) {
    unsigned char* sq = sO + (2 * hp + wg) * TILE_BYTES;
    const uint64_t dq = desc_sw128(sq);
    // o is zeroed inside the key-tile loop, at its first tile: zeroing it here makes ptxas serialise every
    // wgmma of the kernel (C7514, "non wgmma instructions reading accumulator registers")
    float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int idx = hp * 2 * nkt + 2 * (kt - kt_begin) + wg;
      const int s = idx % STAGES, k0 = kt * BK;
      mbar_wait_wg(&ready[s], (idx / STAGES) & 1);
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
      bool whole = quni > 0 && sKuni[2 * s] == quni && sKuni[2 * s + 1] == quni;
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
        const int* ksg = sKseg + s * BK;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kv = *reinterpret_cast<const int2*>(ksg + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, hr = e >> 1, kseg_j = (e & 1) ? kv.y : kv.x;
            bool ok = kseg_j > 0 && kseg_j == qs[hr];
            if (WINDOW) ok = ok && abs(qi[hr] - (k0 + 8 * j + 2 * t4 + (e & 1))) <= p.window;
            sa[i] = ok ? sa[i] * sc : -INFINITY;
            mx[hr] = fmaxf(mx[hr], sa[i]);
          }
        }
      }
      float alpha[2], base[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float mn = fmaxf(m[hr], mx[hr]);
        base[hr] = (mn == -INFINITY) ? 0.f : mn;
        alpha[hr] = ex2_ftz(m[hr] - base[hr]);
        m[hr] = mn;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hr = (i >> 1) & 1;
        sa[i] = ex2_ftz(sa[i] - base[hr]);
        ls[hr] += sa[i];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ls[hr];
      const bool first = kt == kt_begin;  // o starts here: zero, then the first product
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = first ? 0.f : o[i] * alpha[(i >> 1) & 1];
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
    // the head's normalised o, rounded to bf16, over its Q chunk (each warp its own 16 rows)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      const float inv = l[hr] > 0.f ? 1.f / l[hr] : 0.f;
      const int row = rw + g + 8 * hr;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(sq + swizzle128(row, 16 * dt + 4 * t4)) =
            pack_bf16(o[4 * dt + 2 * hr] * inv, o[4 * dt + 2 * hr + 1] * inv);
    }
  }
  fence_proxy_async();
  named_barrier(1, 256);  // the o tile is complete

  if (p.o_out != nullptr)
    for (int item = ct; item < BQ * (HD / 8); item += 256) {
      const int r = item / (HD / 8), cc = item % (HD / 8);
      if (q0 + r < L)
        *reinterpret_cast<uint4*>(p.o_out + (row0 + r) * HD + cc * 8) =
            *reinterpret_cast<const uint4*>(sO + (cc >> 3) * TILE_BYTES + swizzle128(r, (cc & 7) * 16));
    }

  if constexpr (INT8) {
    if (p.o_out != nullptr) named_barrier(1, 256);  // the copy above read the bf16 tile the codes overwrite
    // warp wq of the consumers quantises rows wq, wq + 8, ...: lane l holds columns 64 i + 2 l, 2 l + 1
    for (int r = ct >> 5; r < BQ; r += 8) {
      float2 y[H];
#pragma unroll
      for (int i = 0; i < H; ++i)
        y[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sO + i * TILE_BYTES + swizzle128(r, 4 * lane)));
      int8_t* codes_row = (p.codes_out != nullptr && q0 + r < L) ? p.codes_out + (row0 + r) * HD : nullptr;
      const float sa = quant_row_int8_each<HD>(y, lane, [&](int c, char2 q) {
        *reinterpret_cast<char2*>(sO + (c >> 7) * TILE_BYTES + swizzle128(r, c & 127)) = q;
        if (codes_row != nullptr) *reinterpret_cast<char2*>(codes_row + c) = q;
      });
      if (lane == 0) sSa[r] = sa;
    }
    fence_proxy_async();
    named_barrier(1, 256);  // the codes and row scales are complete
  }

  // ---- epilogue: out = res + bf16(o . Wo^T), or res + bf16(float(codes . Wo_q^T) * sa * sw); warpgroup wg
  // takes output tiles wg, wg + 2, ...
  using Acc = typename std::conditional<INT8, int, float>::type;
  int idx = attn_stages;
  for (int nt0 = 0; nt0 < n_tiles; nt0 += 2) {
    const int pair = min(2, n_tiles - nt0), nt = nt0 + wg;
    if (nt < n_tiles) {
      Acc acc[64];
      int prev = -1;
      for (int kb = 0; kb < KB; ++kb) {
        const int i = idx + kb * pair + wg, s = i % STAGES;
        mbar_wait_wg(&ready[s], (i / STAGES) & 1);
        wgmma_fence();
        const uint64_t da = desc_sw128(sO + kb * TILE_BYTES), db = desc_sw128(ring + s * STAGE_BYTES);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // 16 bf16 or 32 int8: 32 bytes of K a step
          if constexpr (INT8) wgmma_s8_n128(acc, da + 2 * k, db + 2 * k, kb | k);
          else wgmma_bf16_n128(acc, da + 2 * k, db + 2 * k, kb | k);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous box's products are done: hand it back
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      // accumulator i: row rw + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t4 + i % 2 of the tile
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rw + g + 8 * hr;
        if (q0 + row >= L) continue;
        const long long at = (row0 + row) * p.N + nt * BN + 2 * t4;
        const float sa = INT8 ? sSa[row] : 0.f;
        uint32_t rv[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) rv[j] = *reinterpret_cast<const uint32_t*>(p.res + at + 8 * j);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[j]));
          float y0, y1;
          if constexpr (INT8) {
            const float2 sw = *reinterpret_cast<const float2*>(p.sw + nt * BN + 8 * j + 2 * t4);
            y0 = bf16_round((float)acc[4 * j + 2 * hr] * sa * sw.x);
            y1 = bf16_round((float)acc[4 * j + 2 * hr + 1] * sa * sw.y);
          } else {
            y0 = bf16_round(acc[4 * j + 2 * hr]);
            y1 = bf16_round(acc[4 * j + 2 * hr + 1]);
          }
          *reinterpret_cast<uint32_t*>(p.out + at + 8 * j) = pack_bf16(r2.x + y0, r2.y + y1);
        }
      }
    }
    idx += KB * pair;
  }
}

template <bool WINDOW, int HD, bool INT8>
int launch(const AttnArgs& a, const WoArgs& w, int B, void* stream) {
  using Cfg = Layout<HD, INT8>;
  CUtensorMap mq, mk, mv, mw;
  // (64 dims, L positions, H heads, B rows) over the strided views; heads lie 64 elements apart
  if (!make_map_4d_bf16(&mq, a.q, D, a.L, a.H, B, a.q_pstride, D, a.q_bstride, D, BQ) ||
      !make_map_4d_bf16(&mk, a.k, D, a.L, a.H, B, a.k_pstride, D, a.k_bstride, D, BK) ||
      !make_map_4d_bf16(&mv, a.v, D, a.L, a.H, B, a.v_pstride, D, a.v_bstride, D, BK) ||
      !(INT8 ? make_map_2d(&mw, w.wo, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w.N, HD, BN, 128)
             : make_map_2d(&mw, w.wo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w.N, HD, BN, D)))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)attention_wo_kernel<WINDOW, HD, INT8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::BYTES);
  if (err != cudaSuccess) return (int)err;
  const Params p{a.qseg, a.kseg, a.cos_t, a.sin_t, a.tile_start, a.tile_count,
                 w.res, w.out, w.o_out, w.sw, w.codes_out, a.L, w.N, a.window};
  dim3 grid((a.L + BQ - 1) / BQ, B);
  attention_wo_kernel<WINDOW, HD, INT8><<<grid, THREADS, Cfg::BYTES, (cudaStream_t)stream>>>(mq, mk, mv, mw, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90_wo

template <bool WINDOW>
int dispatch(const AttnArgs& a, const WoArgs& w, int B, bool quant, void* stream) {
#define CM3P_ATTN_WO(HD)                                                                                  \
  if (a.H * D == HD)                                                                                      \
    return quant ? sm90_wo::launch<WINDOW, HD, true>(a, w, B, stream)                                      \
                 : sm90_wo::launch<WINDOW, HD, false>(a, w, B, stream);
  CM3P_ATTN_WO(768)
  CM3P_ATTN_WO(512)
  CM3P_ATTN_WO(256)
#undef CM3P_ATTN_WO
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: head-minor (B, L, H, 64) bf16 views (strides in elements);
// qseg, kseg: (B, L) int32; cos_t, sin_t: (L, 32) fp32 or null; window >= 0
// selects the window form, window < 0 the segment form with the key-tile
// range tile_start/tile_count (B, nq) int32. wo: (N, H*64) bf16, or int8
// codes with sw (N,) fp32 when quant != 0; res, out: (B, L, N) bf16;
// o_out (B, L, H*64) bf16 and codes_out (B, L, H*64) int8 are optional
// outputs for checks. H*64 in {256, 512, 768}, N a positive multiple of 128.
// Returns cudaErrorInvalidValue when the driver refuses one of the tensor maps.
extern "C" int cm3p_attention_wo(const void* q, const void* k, const void* v, long long q_bstride,
                                 long long k_bstride, long long v_bstride, long long q_pstride,
                                 long long k_pstride, long long v_pstride, const void* qseg,
                                 const void* kseg, const void* cos_t, const void* sin_t,
                                 const void* tile_start, const void* tile_count, const void* wo,
                                 const void* sw, const void* res, void* out, void* o_out,
                                 void* codes_out, int B, int L, int H, int N, int window, int quant,
                                 void* stream) {
  if (L <= 0 || B <= 0 || B > 65535 || N <= 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (quant && sw == nullptr) return (int)cudaErrorInvalidValue;
  if (window < 0 && (tile_start == nullptr || tile_count == nullptr)) return (int)cudaErrorInvalidValue;
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride, v_pstride, qseg,
                         kseg, cos_t, sin_t, L, H);
  WoArgs w{wo, (const float*)sw, (const __nv_bfloat16*)res, (__nv_bfloat16*)out, (__nv_bfloat16*)o_out,
           (int8_t*)codes_out, N};
  if (window >= 0) {
    a.window = window;
    return dispatch<true>(a, w, B, quant != 0, stream);
  }
  a.tile_start = (const int*)tile_start;
  a.tile_count = (const int*)tile_count;
  return dispatch<false>(a, w, B, quant != 0, stream);
}
