// Fused LayerNorm + GeGLU half-block for Hopper, bf16 in and out:
//     out = x + Wo( gelu_erf(a) * b ),   [a | b] = Wi( LN_fp32(x) )
//
// Replaces the TPU kernel of the JAX package's ops/fused_ffn.py _ffn_kernel (driven by
// _pallas_ln_ffn), at the three tower widths DM = 768 (beatmap), 512 (audio)
// and 256 (metadata). Four forms: bf16 (row 3, bf16::ffn_kernel); w8a8 with
// an int8 Wi (row 3q, the extraction tool's default, w8a8::ffn_kernel);
// w8a8 + w8a8_wo with an int8 Wi and an int8 Wo (row 3qq,
// w8a8::ffn_wo_kernel); and w8a8_wo alone with an int8 Wo behind a bf16 Wi
// (row 3o, the tool's --precise --w8a8-wo, bf16::ffn_wo_kernel). The training
// path runs none: under autograd the layer runs the plain composition and its
// analytic backward (ops/fused_ffn.py), as the JAX package does.
//
// Rounding points kept from the TPU kernel: LN statistics and output in
// fp32 (flax formula, var = E[x^2] - E[x]^2), LN output cast to bf16 before
// a bf16 Wi (or per-row int8 codes of the fp32 LN row before an int8 Wi),
// h = Wi(y) accumulated in fp32 (exact int32, then float(acc) * sa * swi)
// and cast to bf16, gelu(a) * b in fp32 then cast to bf16 before a bf16 Wo
// (or per-row int8 codes over all F, sg = max(absmax, 1e-30) / 127, before an
// int8 Wo), Wo accumulated in fp32 (exact int32, then float(acc) * sg * swo)
// and cast to bf16, residual added to that bf16 value and rounded once more.
//
// Bound on the H100: 6 * rows * DM * F operations against 4 * rows * DM bytes
// of activations, about 1,700 per byte at DM = 768: bound by the tensor cores
// (1.74 ms at 323,584 rows, DM 768, F 1152 in bf16; 1.16 ms with an int8 Wi,
// 0.87 ms with both weights int8, 1.45 ms with an int8 Wo alone).
//
// The wgmma design, 3q's (w8a8::ffn_kernel, below as it was designed) and
// that of rows 3, 3qq and 3o (sm90_ffn::ffn_body, the same with a bf16 Wi or
// an int8 Wo, or both). Persistent blocks of 384 threads, one per SM, in clusters of two;
// a cluster walks pairs of 64-row tiles x NO output columns (NO = 384 at
// DM 768 with a bf16 Wo, so two column tiles per 64 rows; DM otherwise). Why
// two column tiles at DM 768: the fp32 accumulator of 64 rows x 768 columns is
// 49,152 registers, three quarters of an SM's, which cannot sit beside the Wi
// product's; the price is the Wi product run twice. A producer warp feeds two
// TMA rings in the order they are read (3q: one thread for both; rows 3 and
// 3qq: one thread per ring, so that a Wo slot still in use never holds back
// the Wi stages behind it): Wi stages of 64 a-rows and 64 b-rows x 128 bytes
// of DM (16 KB: 64 bf16 or 128 int8 columns) and Wo slots of NO rows x 128
// bytes of F (one 64-column F chunk in bf16, a pair of chunks in int8). Each
// CTA of the cluster loads half of every stage and multicasts it to both, so
// L2 serves each weight byte once per 128 rows. Two consumer warpgroups share
// the tile's 64 rows. The front end normalises each row in fp32 (a warp per
// row) and writes it in wgmma's swizzled layout, as bf16 or as per-row int8
// codes (codes_y from the first column tile only). The F chunks alternate
// between the warpgroups: the owner of chunk c runs its Wi product (wgmma
// m64n128, bf16 k16 into fp32 or s8 k32 into exact s32; a- and b-columns side
// by side, 64 registers) and turns it into gelu(a) * b in registers, while the
// other warpgroup does the same for chunk c + 1; both multiply each g tile by
// their NO / 2 rows of Wo (NO / 2 = 192 / 256 / 128 columns of accumulators
// held across all of F: 96 / 128 / 64 registers; setmaxnreg gives consumers
// 232). So one warpgroup's GeGLU overlaps the other's products. g tiles are
// double-buffered between mbarriers (written, and freed by both). Both
// warpgroups wait on the one Wi ring; a parity wait tells apart only two
// phases of a stage, so a warpgroup starts on its chunk only once the other
// has seen the previous chunk's stages arrive (without that, under time
// slicing between processes, one could run two phases ahead and hang).
//   w8a8 (3q): int8 LN codes (48 KB), 4 Wi stages (3 at 512), two Wo slots.
//   bf16 (row 3): the bf16 LN rows take 96 KB at DM 768, so one Wo slot of
// 48 KB (64 KB at 512) is left beside 4 Wi stages (5 at 512). Each consumer
// warpgroup's half of it is a ring of its own with its own producer thread,
// handed back after each chunk's Wo product, so that the warpgroup whose
// GeGLU comes first refills its half without waiting for the other. 224 KB.
//   w8a8 + w8a8_wo (3qq): the row scale sg needs the absmax of gelu(a) * b over
// all F before any code, and the (64, F) intermediate does not fit beside the
// rings. The int8 Wi product is exact, so it is run twice and gives the same
// values both times: pass 0 runs the Wi product and the GeGLU of every chunk
// and keeps only each row's absmax (both warpgroups, an atomicMax per row in
// shared memory); pass 1 runs them again, quantises with the now known scale
// into a g tile of int8 codes that holds a chunk pair (each warpgroup writes its
// chunk's 64 bytes of each 128-byte row, codes_g), and both warpgroups
// multiply it by the pair's int8 Wo slot (wgmma s8 k32, N = 192 / 256 / 128,
// exact s32 accumulators). At DM 768 two column tiles would run the Wi
// product four times, so an item is 64 rows x all 768 columns: pass 1 keeps
// the tiles of every pair (64 x F bytes, 72 KB at F = 1152, the most this form
// takes at DM 768) beside its Wo product of columns 0-383 (one 48 KB Wo slot,
// 3 Wi stages), and a last pass multiplies the kept codes by columns 384-767.
// So the Wi product runs twice at every DM: 10 R DM F int8 operations.
//   w8a8_wo alone (3o): row 3's bf16 LN operand and Wi product (fp32 sums, h
// rounded to bf16) with 3qq's absmax pass over F and int8 Wo product. The
// bf16 Wi product gives the same sums for the same operands in the same
// order, so a quantising pass quantises the values the absmax pass measured.
// Row 3's layout holds no codes of all F beside the 96 KB bf16 LN operand at
// DM 768, so there an item of 64 rows x 768 columns runs one absmax pass, then
// one quantising pass per Wo half of 384 columns (the Wi product three times:
// 12 R DM F bf16 operations; no F limit), each with double-buffered code tiles
// of a chunk pair and one Wo slot (4 Wi stages; at 512 one half, 5 stages; at
// 256 6 stages, two slots). Keeping the codes of all F in a device scratch
// slot per block instead, so that the Wi product runs twice, was not tried.
// What holds them below the bound: the weight stages' turnover. Each 64-row
// tile streams all of Wi (twice at DM 768 in 3q and row 3) through a ring of
// 3-5 stages, as deep as shared memory allows; a copy of row 3 with its Wi
// product cut out keeps most of the time (PERF.md, PR 9).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ln_rows.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// The w8a8 form (int8 Wi, bf16 Wo): warp-specialised, persistent, TMA rings,
// wgmma (see the note at the top of the file).
namespace w8a8 {

constexpr int BM = 64;                 // rows per tile
constexpr int FC = 64;                 // F chunk: 64 columns of a and the same 64 of b
constexpr int KQ = 128;                // DM bytes of Wi per stage: one 128-byte swizzle row
constexpr int CM = 2;                  // CTAs of a cluster: consecutive row tiles sharing each weight stage
constexpr int WI_BYTES = 2 * FC * KQ;  // 16 KB: a rows, then b rows
constexpr int G_BYTES = BM * FC * 2;   // one bf16 g tile
constexpr int THREADS = 384;           // two consumer warpgroups + a producer warpgroup

template <int DM>
__host__ __device__ constexpr int out_cols() {  // output columns per tile; DM 768 takes two tiles per 64 rows
  return DM == 768 ? 384 : DM;
}
template <int DM>
__host__ __device__ constexpr int wi_stages() {
  return DM == 512 ? 3 : 4;
}
template <int DM>
__host__ __device__ constexpr int wo_bytes() {
  return out_cols<DM>() * FC * 2;
}
template <int DM>
constexpr int smem_bytes() {
  return 1024 + wi_stages<DM>() * WI_BYTES + 2 * wo_bytes<DM>() + BM * DM + 2 * G_BYTES + BM * 4 +
         (2 * wi_stages<DM>() + 10) * 8;
}

// acc (64 x NW) [+]= A (64 x 16) . B (NW x 16)^T over one K step, NW the warpgroup's output columns
template <int NW>
__device__ __forceinline__ void wgmma_wo(float (&acc)[NW / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NW == 128) sm90::wgmma_bf16_n128(acc, da, db, scale_d);
  else if constexpr (NW == 192) sm90::wgmma_bf16_n192(acc, da, db, scale_d);
  else sm90::wgmma_bf16_n256(acc, da, db, scale_d);
}

template <int DM>
__global__ void __cluster_dims__(CM, 1, 1) __launch_bounds__(THREADS, 1)
    ffn_kernel(const __grid_constant__ CUtensorMap map_wi, const __grid_constant__ CUtensorMap map_wo,
               const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ swi, __nv_bfloat16* __restrict__ out,
               int8_t* __restrict__ codes_y, int R, int F, float eps) {
  using namespace sm90;
  constexpr int NO = out_cols<DM>(), NP = DM / NO, NW = NO / 2;  // NW: columns per consumer warpgroup
  constexpr int WIS = wi_stages<DM>(), KBQ = DM / KQ, WO_BYTES = wo_bytes<DM>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sWi = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sWo = sWi + WIS * WI_BYTES;      // 2 slots of NO rows x FC
  unsigned char* sQ = sWo + 2 * WO_BYTES;         // KBQ blocks of 64 rows x 128 codes
  unsigned char* sG = sQ + BM * DM;               // 2 g tiles
  float* sSa = reinterpret_cast<float*>(sG + 2 * G_BYTES);      // BM row scales
  uint64_t* wi_full = reinterpret_cast<uint64_t*>(sSa + BM);
  uint64_t* wi_empty = wi_full + WIS;  // every consumer warp of the cluster is done with the stage
  uint64_t* wo_full = wi_empty + WIS;
  uint64_t* wo_empty = wo_full + 2;
  uint64_t* g_ready = wo_empty + 2;  // g tile b written by the warpgroup that owns its chunk
  uint64_t* g_free = g_ready + 2;    // g tile b no longer read by either warpgroup's Wo product
  uint64_t* landed = g_free + 2;     // warpgroup w has seen the last Wi stage of its chunk arrive

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = cluster_ctarank();
  const int chunks = F / FC;
  const int items = ((R + BM - 1) / BM + CM - 1) / CM * NP;  // (CM row tiles, output columns) of a cluster
  const int cluster = blockIdx.x / CM, clusters = gridDim.x / CM;
  constexpr uint16_t ALL = (1 << CM) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIS; ++s) mbar_init(&wi_full[s], 1), mbar_init(&wi_empty[s], 4 * CM);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&wo_full[s], 1), mbar_init(&wo_empty[s], 8 * CM);
      mbar_init(&g_ready[s], 4), mbar_init(&g_free[s], 8), mbar_init(&landed[s], 4);
    }
    fence_mbar_init();
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or remote arrival reaches them

  if (warp >= 8) {  // producer warpgroup: one thread keeps both rings full, in the order they are read
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      int si = 0, so = 0;
      uint32_t pi = 0, po = 0;
      for (int item = cluster; item < items; item += clusters) {
        const int n0 = item % NP * NO;
        for (int c = 0; c < chunks; ++c) {
          for (int kb = 0; kb < KBQ; ++kb) {
            mbar_wait(&wi_empty[si], pi ^ 1);
            mbar_expect_tx(&wi_full[si], WI_BYTES);
            unsigned char* dst = sWi + si * WI_BYTES + rank * (FC / CM) * KQ;
            tma_load_2d_multicast(dst, &map_wi, &wi_full[si], kb * KQ, c * FC + rank * (FC / CM), ALL);
            tma_load_2d_multicast(dst + FC * KQ, &map_wi, &wi_full[si], kb * KQ, F + c * FC + rank * (FC / CM), ALL);
            if (++si == WIS) si = 0, pi ^= 1;
          }
          mbar_wait(&wo_empty[so], po ^ 1);
          mbar_expect_tx(&wo_full[so], WO_BYTES);
          unsigned char* dst = sWo + so * WO_BYTES + rank * (NW / CM) * 128;
          tma_load_2d_multicast(dst, &map_wo, &wo_full[so], c * FC, n0 + rank * (NW / CM), ALL);
          tma_load_2d_multicast(dst + NW * 128, &map_wo, &wo_full[so], c * FC, n0 + NW + rank * (NW / CM), ALL);
          if (++so == 2) so = 0, po ^= 1;
        }
      }
      // stay until every consumer of the cluster has released every stage: no remote
      // arrival may reach this CTA after it exits
      for (int s = 0; s < WIS; ++s) {
        mbar_wait(&wi_empty[si], pi ^ 1);
        if (++si == WIS) si = 0, pi ^= 1;
      }
      for (int s = 0; s < 2; ++s) {
        mbar_wait(&wo_empty[so], po ^ 1);
        if (++so == 2) so = 0, po ^= 1;
      }
    }
    return;
  }

  // consumers: both warpgroups share the tile's 64 rows. The chunks alternate between them:
  // warpgroup wg runs the Wi product and the GeGLU of chunks c = wg mod 2 (all 64 a- and b-columns),
  // while the other one does the same for its chunk; both multiply every chunk's g tile by their
  // NW output columns of Wo.
  regs_alloc<232>();
  const int wg = warp >> 2, wl = warp & 3;
  float acc[NW / 2];
  int h[64];  // h of the own chunk: a columns in blocks 0-7, b columns in blocks 8-15
  int so = 0;
  uint32_t po = 0;
  int gc = 0;  // chunks of earlier tiles: chunk c of this tile is the block's chunk gc + c
  const int other_per_tile = wg == 1 ? (chunks + 1) / 2 : chunks / 2;  // chunks of the other warpgroup in a tile
  auto release = [&](uint64_t* bar) {
    if (lane == 0)
      for (int q = 0; q < CM; ++q) mbar_arrive_cluster(bar, q);
  };
  for (int item = cluster; item < items; item += clusters) {
    const int m0 = (item / NP * CM + rank) * BM, p = item % NP, n0 = p * NO;
    // ---- front end: LN (fp32), per-row int8 codes into the swizzled sQ, row scales
    named_barrier(1, 256);  // both warpgroups are done with the previous tile's sQ and sSa
    for (int r = warp; r < BM; r += 8) {
      const int row = m0 + r;
      if (row < R) {
        float2 y[DM / 64];
        ln_row_f32<DM>(x + (long long)row * DM, scale, bias, eps, lane, y);
        int8_t* cy = codes_y && p == 0 ? codes_y + (long long)row * DM : nullptr;
        const float sa = quant_row_int8_each<DM>(y, lane, [&](int c, char2 q) {
          *reinterpret_cast<char2*>(sQ + (c >> 7) * (BM * 128) + swizzle128(r, c & 127)) = q;
          if (cy) *reinterpret_cast<char2*>(cy + c) = q;
        });
        if (lane == 0) sSa[r] = sa;
      } else {
        for (int c = lane * 4; c < DM; c += 128)
          *reinterpret_cast<uint32_t*>(sQ + (c >> 7) * (BM * 128) + swizzle128(r, c & 127)) = 0u;
        if (lane == 0) sSa[r] = 0.f;
      }
    }
    fence_proxy_async();
    named_barrier(1, 256);

    for (int c0 = 0; c0 < chunks; c0 += 2) {
      const int c = c0 + wg;  // this warpgroup's chunk
      if (c < chunks) {
        // Wi product of chunk c: h (64 x 128) = codes (64 x DM) . [Wi_a | Wi_b]^T, exact
        // The block's Wi stages run in chunk order, the other warpgroup's chunks taking their share. A
        // parity wait tells apart only two phases of a stage's barrier, so ours are waited on only after
        // the other warpgroup has seen the stages of chunk c - 1 arrive.
        if (c > 0) mbar_wait(&landed[1 - wg], ((gc / chunks) * other_per_tile + (c - 1) / 2) & 1);
        const int t0 = (gc + c) * KBQ;
        for (int kb = 0; kb < KBQ; ++kb) {
          const int si = (t0 + kb) % WIS;
          mbar_wait(&wi_full[si], ((t0 + kb) / WIS) & 1);
          if (kb == KBQ - 1 && lane == 0) mbar_arrive(&landed[wg]);
          wgmma_fence();
          const uint64_t da = desc_sw128(sQ + kb * (BM * 128)), db = desc_sw128(sWi + si * WI_BYTES);
#pragma unroll
          for (int k = 0; k < KQ / 32; ++k) wgmma_s8_n128(h, da + 2 * k, db + 2 * k, kb | k);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: hand it back
          if (kb > 0) release(&wi_empty[(t0 + kb - 1) % WIS]);
        }
        wgmma_wait<0>();
        fence_regs(h);
        release(&wi_empty[(t0 + KBQ - 1) % WIS]);
        // GeGLU into g tile b: h = float(acc) * sa * swi[column], in that order
        const int b = (gc + c) & 1, use = (gc + c) >> 1;
        if (use > 0) mbar_wait(&g_free[b], (use - 1) & 1);
        unsigned char* g = sG + b * G_BYTES;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = 16 * wl + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int cc = 8 * (i >> 2) + 2 * (lane & 3);  // column in the chunk
          const int col = c * FC + cc;
          const float sa = sSa[r];
          const float a0 = bf16_round((float)h[i] * sa * swi[col]);
          const float a1 = bf16_round((float)h[i + 1] * sa * swi[col + 1]);
          const float b0 = bf16_round((float)h[i + 32] * sa * swi[F + col]);
          const float b1 = bf16_round((float)h[i + 33] * sa * swi[F + col + 1]);
          *reinterpret_cast<uint32_t*>(g + swizzle128(r, 2 * cc)) = pack_bf16(gelu_erf(a0) * b0, gelu_erf(a1) * b1);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&g_ready[b]);
      }
      // Wo products of chunks c0 and c0 + 1, each from the g tile its owner wrote
      const int last = c0 + 2 < chunks ? c0 + 2 : chunks;
      for (int j = c0; j < last; ++j) {
        mbar_wait(&g_ready[(gc + j) & 1], ((gc + j) >> 1) & 1);
        mbar_wait(&wo_full[so], po);
        wgmma_fence();
        const uint64_t da = desc_sw128(sG + ((gc + j) & 1) * G_BYTES);
        const uint64_t db = desc_sw128(sWo + so * WO_BYTES + wg * NW * 128);
#pragma unroll
        for (int k = 0; k < FC / 16; ++k) wgmma_wo<NW>(acc, da + 2 * k, db + 2 * k, j | k);
        wgmma_commit();
        if (++so == 2) so = 0, po ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      for (int j = c0; j < last; ++j) {  // hand back their Wo slots and g tiles
        release(&wo_empty[(so + j - last) & 1]);
        if (lane == 0) mbar_arrive(&g_free[(gc + j) & 1]);
      }
    }
    gc += chunks;

    // ---- epilogue: out = x + bf16(acc), rounded to bf16
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + 16 * wl + (lane >> 2) + 8 * hr;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const long long at = (long long)row * DM + n0 + NW * wg + 8 * j + 2 * (lane & 3);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
        const float o0 = bf16_round(acc[4 * j + 2 * hr]), o1 = bf16_round(acc[4 * j + 2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(xv.x + o0, xv.y + o1);
      }
    }
  }
}

template <int DM>
int launch(const void* x, const void* scale, const void* bias, const void* wi, const void* swi, const void* wo,
           void* out, void* codes_y, int R, int F, float eps, void* stream) {
  CUtensorMap map_wi, map_wo;
  if (!make_map_2d(&map_wi, wi, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2LL * F, DM, FC / CM, KQ) ||
      !make_map_2d(&map_wo, wo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, DM, F, out_cols<DM>() / 2 / CM, FC))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<DM>();
  const void* kernel = (const void*)ffn_kernel<DM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  static const int max_clusters = max_active_clusters(kernel, THREADS, bytes, CM);
  const int items = ((R + BM - 1) / BM + CM - 1) / CM * (DM / out_cols<DM>());
  ffn_kernel<DM><<<CM * (items < max_clusters ? items : max_clusters), THREADS, bytes, (cudaStream_t)stream>>>(
      map_wi, map_wo, (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (const float*)swi,
      (__nv_bfloat16*)out, (int8_t*)codes_y, R, F, eps);
  return (int)cudaGetLastError();
}

}  // namespace w8a8

// ---------------------------------------------------------------------------
// The bf16 form (row 3) and the w8a8 + w8a8_wo form (3qq): 3q's design with a bf16 Wi, or an int8 Wo
// (see the note at the top of the file).
namespace sm90_ffn {

constexpr int BM = 64;                   // rows per tile
constexpr int FC = 64;                   // F chunk: 64 columns of a and the same 64 of b
constexpr int CM = 2;                    // CTAs of a cluster: consecutive row tiles sharing each weight stage
constexpr int WI_BYTES = 2 * FC * 128;   // 16 KB: a rows, then b rows, of 128 bytes of DM
constexpr int G_BYTES = BM * 128;        // a g tile: one chunk's bf16 g, or a chunk pair's int8 codes
constexpr int THREADS = 384;             // two consumer warpgroups + a producer warpgroup

// row 3: bf16 Wi and Wo; row 3qq: int8 Wi and Wo; row 3o: a bf16 Wi and an int8 Wo
enum Form { BF16, W8A8_WO, W8A8_WO_ALONE };

template <int DM, int FORM>
struct Cfg {
  static constexpr bool QI = FORM == W8A8_WO;  // int8 LN codes and Wi (else the bf16 LN row and a bf16 Wi)
  static constexpr bool QO = FORM != BF16;     // g quantised per row over all F (an absmax pass first), int8 Wo
  // NC output columns per Wo pass, NW = NC / 2 of them per consumer warpgroup. At DM 768 (the
  // accumulators of 768 columns do not fit) the bf16 form takes two items of 384 columns per 64 rows;
  // the int8 Wo forms take one item whose Wo product runs in NH = 2 halves of 384 columns: 3qq from the
  // codes of all F, kept in shared memory (KEEP), 3o (no room for them beside the bf16 LN operand) in a
  // quantising pass over F of its own per half, after the one absmax pass.
  static constexpr int NC = DM == 768 ? 384 : DM, NW = NC / 2;
  static constexpr int NH = QO ? DM / NC : 1;
  static constexpr bool KEEP = QI && NH == 2;
  static constexpr int NO = NC * NH, NP = DM / NO;  // output columns per item, items per 64 rows
  static constexpr int KS = QI ? 128 : 64;         // DM columns per Wi stage (128 bytes)
  static constexpr int KB = DM / KS;                // Wi stages per chunk
  static constexpr int A_BYTES = BM * DM * (QI ? 1 : 2);  // LN operand: KB blocks of 64 rows x 128 bytes
  static constexpr int WO_BYTES = NC * 128;         // NC rows x one bf16 chunk or an int8 chunk pair
  static constexpr int WOS = QI ? (NH == 2 ? 1 : 2) : (DM == 256 ? 2 : 1);  // Wo slots
  // one Wo slot, bf16: each warpgroup's half of it is its own ring, so that neither waits on the other
  static constexpr bool WO_SPLIT = WOS == 1 && !QO;
  static constexpr int F_MAX = KEEP ? 1152 : 1 << 30;
  static constexpr int G_TILES = KEEP ? F_MAX / 128 : 2;  // g tiles: double-buffered, or one per chunk pair
  static constexpr int WIS = QI ? (DM == 256 ? 4 : 3) : (DM == 768 ? 4 : DM == 512 ? 5 : 6);  // Wi stages
  static constexpr int PASSES = !QO ? 1 : KEEP ? 2 : 1 + NH;  // over F: the absmax pass, then the quantising ones
  static constexpr int SMEM = 1024 + WIS * WI_BYTES + WOS * WO_BYTES + A_BYTES + G_TILES * G_BYTES + 2 * BM * 4 +
                              (2 * WIS + 2 * 2 + 6) * 8;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// h (64 x 128) [+]= A (64 x K) . B (128 x K)^T over one K step of the Wi product
__device__ __forceinline__ void wgmma_wi(float (&h)[64], uint64_t da, uint64_t db, int scale_d) {
  sm90::wgmma_bf16_n128(h, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_wi(int (&h)[64], uint64_t da, uint64_t db, int scale_d) {
  sm90::wgmma_s8_n128(h, da, db, scale_d);
}

// acc (64 x NW) [+]= A . B (NW x K)^T over one K step of the Wo product
template <int NW>
__device__ __forceinline__ void wgmma_wo(float (&acc)[NW / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NW == 128) sm90::wgmma_bf16_n128(acc, da, db, scale_d);
  else if constexpr (NW == 192) sm90::wgmma_bf16_n192(acc, da, db, scale_d);
  else sm90::wgmma_bf16_n256(acc, da, db, scale_d);
}
template <int NW>
__device__ __forceinline__ void wgmma_wo(int (&acc)[NW / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NW == 128) sm90::wgmma_s8_n128(acc, da, db, scale_d);
  else if constexpr (NW == 192) sm90::wgmma_s8_n192(acc, da, db, scale_d);
  else sm90::wgmma_s8_n256(acc, da, db, scale_d);
}

template <int DM, int FORM>
__device__ __forceinline__ void ffn_body(const CUtensorMap* map_wi, const CUtensorMap* map_wo,
                                         const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                                         const float* __restrict__ bias, const float* __restrict__ swi,
                                         const float* __restrict__ swo, __nv_bfloat16* __restrict__ out,
                                         int8_t* __restrict__ codes_y, int8_t* __restrict__ codes_g, int R, int F,
                                         float eps) {
  using namespace sm90;
  using C = Cfg<DM, FORM>;
  using HAcc = typename std::conditional<C::QI, int, float>::type;  // the Wi product's: exact s32, or fp32
  using OAcc = typename std::conditional<C::QO, int, float>::type;  // the Wo product's
  constexpr int NO = C::NO, NP = C::NP, NC = C::NC, NW = C::NW, NH = C::NH, KB = C::KB, WIS = C::WIS, WOS = C::WOS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sWi = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sWo = sWi + WIS * WI_BYTES;      // WOS slots of NC rows x 128 bytes of F
  unsigned char* sA = sWo + WOS * C::WO_BYTES;    // KB blocks of 64 rows x 128 bytes: LN rows, bf16 or codes
  unsigned char* sG = sA + C::A_BYTES;            // G_TILES g tiles
  float* sSa = reinterpret_cast<float*>(sG + C::G_TILES * G_BYTES);  // BM LN row scales (int8 Wi)
  unsigned int* sMax = reinterpret_cast<unsigned int*>(sSa + BM);    // BM absmax of gelu(a) * b, bits (int8 Wo)
  uint64_t* wi_full = reinterpret_cast<uint64_t*>(sMax + BM);
  uint64_t* wi_empty = wi_full + WIS;  // every consumer warp of the cluster is done with the stage
  uint64_t* wo_full = wi_empty + WIS;  // per slot, or per warpgroup's ring (WO_SPLIT)
  uint64_t* wo_empty = wo_full + 2;
  uint64_t* g_ready = wo_empty + 2;    // g tile b written (by the owner of its chunk; int8 Wo: by both)
  uint64_t* g_free = g_ready + 2;      // g tile b no longer read by either warpgroup's Wo product
  uint64_t* landed = g_free + 2;       // warpgroup w has seen the last Wi stage of its chunk arrive

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = cluster_ctarank();
  const int chunks = F / FC;
  const int items = ((R + BM - 1) / BM + CM - 1) / CM * NP;  // (CM row tiles, output columns) of a cluster
  const int cluster = blockIdx.x / CM, clusters = gridDim.x / CM;
  constexpr uint16_t ALL = (1 << CM) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIS; ++s) mbar_init(&wi_full[s], 1), mbar_init(&wi_empty[s], 4 * CM);
    for (int s = 0; s < 2; ++s) mbar_init(&wo_full[s], 1), mbar_init(&wo_empty[s], (C::WO_SPLIT ? 4 : 8) * CM);
    for (int s = 0; s < 2; ++s)
      mbar_init(&g_ready[s], C::QO ? 8 : 4), mbar_init(&g_free[s], 8), mbar_init(&landed[s], 4);
    fence_mbar_init();
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or remote arrival reaches them

  if (warp >= 8) {  // producer warpgroup: one thread per ring keeps it full, in the order it is read
    regs_dealloc<40>();
    if (lane == 0 && warp == 8) {  // Wi: every chunk of every pass
      int si = 0;
      uint32_t pi = 0;
      for (int item = cluster; item < items; item += clusters)
        for (int pass = 0; pass < C::PASSES; ++pass)
          for (int c = 0; c < chunks; ++c)
            for (int kb = 0; kb < KB; ++kb) {
              mbar_wait(&wi_empty[si], pi ^ 1);
              mbar_expect_tx(&wi_full[si], WI_BYTES);
              unsigned char* dst = sWi + si * WI_BYTES + rank * (FC / CM) * 128;
              tma_load_2d_multicast(dst, map_wi, &wi_full[si], kb * C::KS, c * FC + rank * (FC / CM), ALL);
              tma_load_2d_multicast(dst + FC * 128, map_wi, &wi_full[si], kb * C::KS, F + c * FC + rank * (FC / CM),
                                    ALL);
              if (++si == WIS) si = 0, pi ^= 1;
            }
      // stay until every consumer of the cluster has released every stage: no remote
      // arrival may reach this CTA after it exits
      for (int s = 0; s < WIS; ++s) {
        mbar_wait(&wi_empty[si], pi ^ 1);
        if (++si == WIS) si = 0, pi ^= 1;
      }
    } else if (lane == 0 && (warp == 9 || (C::WO_SPLIT && warp == 10))) {
      // Wo: a chunk (bf16) or a chunk pair (int8) a slot, for each Wo pass; with split rings one thread
      // feeds each consumer warpgroup's half of the one slot
      constexpr int SLOTS = C::WO_SPLIT ? 1 : WOS;
      const int ring = warp - 9;
      uint64_t* full = wo_full + ring;
      uint64_t* empty = wo_empty + ring;
      int so = 0;
      uint32_t po = 0;
      for (int item = cluster; item < items; item += clusters) {
        const int n0 = item % NP * NO;
        for (int half = 0; half < NH; ++half)
          for (int c = 0; c < chunks; c += C::QO ? 2 : 1) {
            mbar_wait(&empty[so], po ^ 1);
            mbar_expect_tx(&full[so], C::WO_BYTES / (C::WO_SPLIT ? 2 : 1));
            for (int w = C::WO_SPLIT ? ring : 0; w < (C::WO_SPLIT ? ring + 1 : 2); ++w) {
              const int r0 = w * NW + rank * (NW / CM);  // the slot rows this CTA loads for warpgroup w
              tma_load_2d_multicast(sWo + so * C::WO_BYTES + r0 * 128, map_wo, &full[so], c * FC, n0 + half * NC + r0,
                                    ALL);
            }
            if (++so == SLOTS) so = 0, po ^= 1;
          }
      }
      for (int s = 0; s < SLOTS; ++s) {
        mbar_wait(&empty[so], po ^ 1);
        if (++so == SLOTS) so = 0, po ^= 1;
      }
    }
    return;
  }

  // consumers: both warpgroups share the tile's 64 rows. The chunks alternate between them:
  // warpgroup wg runs the Wi product and the GeGLU of chunks c = wg mod 2 (all 64 a- and b-columns),
  // while the other one does the same for its chunk; both multiply every g tile by their
  // NW output columns of Wo.
  regs_alloc<232>();
  const int wg = warp >> 2, wl = warp & 3;
  OAcc acc[NW / 2];
  HAcc h[64];  // h of the own chunk: a columns in blocks 0-7, b columns in blocks 8-15
  int so = 0;
  uint32_t po = 0;
  int gc = 0;  // chunks of earlier passes: chunk c of this pass is the block's chunk gc + c
  int gp = 0;  // int8 Wo: chunk pairs of earlier items (the pair's g tile and its g_ready phase)
  const int other_per_pass = wg == 1 ? (chunks + 1) / 2 : chunks / 2;  // chunks of the other warpgroup in a pass
  auto release = [&](uint64_t* bar) {
    if (lane == 0)
      for (int q = 0; q < CM; ++q) mbar_arrive_cluster(bar, q);
  };
  float sg[2] = {1.f, 1.f};  // int8 Wo: the scales of this thread's rows 16 wl + lane / 4 (+ 8)
  // out = x + bf16(o), rounded to bf16 (int8 Wo: o = float(acc) * sg * swo[column]), over this
  // warpgroup's NW columns of the Wo pass that starts at column n0
  auto epilogue = [&](int m0, int n0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + 16 * wl + (lane >> 2) + 8 * hr;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = n0 + NW * wg + 8 * j + 2 * (lane & 3);
        const long long at = (long long)row * DM + col;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
        float o0, o1;
        if constexpr (C::QO) {
          o0 = bf16_round((float)acc[4 * j + 2 * hr] * sg[hr] * swo[col]);
          o1 = bf16_round((float)acc[4 * j + 2 * hr + 1] * sg[hr] * swo[col + 1]);
        } else {
          o0 = bf16_round(acc[4 * j + 2 * hr]), o1 = bf16_round(acc[4 * j + 2 * hr + 1]);
        }
        *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(xv.x + o0, xv.y + o1);
      }
    }
  };
  // int8 Wo: the Wo product of chunk pair kp (tile b, written by both warpgroups) over the columns of
  // the slot's Wo pass (a lone last chunk meets Wo columns past F, which the map gives as zeros)
  auto wo_pair = [&](int kp, int b) {
    mbar_wait(&wo_full[so], po);
    wgmma_fence();
    const uint64_t da = desc_sw128(sG + b * G_BYTES);
    const uint64_t db = desc_sw128(sWo + so * C::WO_BYTES + wg * NW * 128);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_wo<NW>(acc, da + 2 * k, db + 2 * k, kp | k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(&wo_empty[so]);
    if (++so == WOS) so = 0, po ^= 1;
  };
  for (int item = cluster; item < items; item += clusters) {
    const int m0 = (item / NP * CM + rank) * BM, p = item % NP, n0 = p * NO;
    // ---- front end: LN (fp32) into the swizzled sA, as bf16 or as per-row int8 codes with their scales
    named_barrier(1, 256);  // both warpgroups are done with the previous tile's sA, sSa and sMax
    for (int r = warp; r < BM; r += 8) {
      const int row = m0 + r;
      if (C::QO && lane == 0) sMax[r] = 0u;
      if (row < R) {
        float2 y[DM / 64];
        ln_row_f32<DM>(x + (long long)row * DM, scale, bias, eps, lane, y);
        if constexpr (C::QI) {
          int8_t* cy = codes_y && p == 0 ? codes_y + (long long)row * DM : nullptr;
          const float sa = quant_row_int8_each<DM>(y, lane, [&](int c, char2 q) {
            *reinterpret_cast<char2*>(sA + (c >> 7) * (BM * 128) + swizzle128(r, c & 127)) = q;
            if (cy) *reinterpret_cast<char2*>(cy + c) = q;
          });
          if (lane == 0) sSa[r] = sa;
        } else {
#pragma unroll
          for (int i = 0; i < DM / 64; ++i)  // columns 64 i + 2 lane, + 1: block i, bytes 4 lane
            *reinterpret_cast<uint32_t*>(sA + i * (BM * 128) + swizzle128(r, 4 * lane)) = pack_bf16(y[i].x, y[i].y);
        }
      } else {
        for (int c = lane * 4; c < C::A_BYTES / BM; c += 128)
          *reinterpret_cast<uint32_t*>(sA + (c >> 7) * (BM * 128) + swizzle128(r, c & 127)) = 0u;
        if (C::QI && lane == 0) sSa[r] = 0.f;
      }
    }
    fence_proxy_async();
    named_barrier(1, 256);

    for (int pass = 0; pass < C::PASSES; ++pass) {
      float gmax[2] = {0.f, 0.f};  // int8 Wo, pass 0: their absmax so far
      for (int c0 = 0; c0 < chunks; c0 += 2) {
        const int c = c0 + wg;  // this warpgroup's chunk
        if (c < chunks) {
          // Wi product of chunk c: h (64 x 128) = A (64 x DM) . [Wi_a | Wi_b]^T
          // The block's Wi stages run in chunk order, the other warpgroup's chunks taking their share. A
          // parity wait tells apart only two phases of a stage's barrier, so ours are waited on only after
          // the other warpgroup has seen the stages of chunk c - 1 arrive.
          if (c > 0) mbar_wait(&landed[1 - wg], ((gc / chunks) * other_per_pass + (c - 1) / 2) & 1);
          const int t0 = (gc + c) * KB;
          for (int kb = 0; kb < KB; ++kb) {
            const int si = (t0 + kb) % WIS;
            mbar_wait(&wi_full[si], ((t0 + kb) / WIS) & 1);
            if (kb == KB - 1 && lane == 0) mbar_arrive(&landed[wg]);
            wgmma_fence();
            const uint64_t da = desc_sw128(sA + kb * (BM * 128)), db = desc_sw128(sWi + si * WI_BYTES);
#pragma unroll
            for (int k = 0; k < 4; ++k) wgmma_wi(h, da + 2 * k, db + 2 * k, kb | k);
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's products are done: hand it back
            if (kb > 0) release(&wi_empty[(t0 + kb - 1) % WIS]);
          }
          wgmma_wait<0>();
          fence_regs(h);
          release(&wi_empty[(t0 + KB - 1) % WIS]);
          // GeGLU: h rounded to bf16 (int8 Wi: float(acc) * sa * swi[column], in that order, first)
          // into g tile b: double-buffered (the chunk's, or the int8 Wo pair's), or the pair's own
          const int b = !C::QO ? (gc + c) & 1 : C::KEEP ? c0 / 2 : gp & 1;
          const int use = C::QO ? gp >> 1 : (gc + c) >> 1;
          if (use > 0 && (!C::QO || (pass >= 1 && !C::KEEP))) mbar_wait(&g_free[b], (use - 1) & 1);
          unsigned char* g = sG + b * G_BYTES;
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int hr = (i >> 1) & 1;
            const int r = 16 * wl + (lane >> 2) + 8 * hr;
            const int cc = 8 * (i >> 2) + 2 * (lane & 3);  // column in the chunk
            float a0, a1, b0, b1;
            if constexpr (C::QI) {
              const int col = c * FC + cc;
              const float sa = sSa[r];
              a0 = bf16_round((float)h[i] * sa * swi[col]);
              a1 = bf16_round((float)h[i + 1] * sa * swi[col + 1]);
              b0 = bf16_round((float)h[i + 32] * sa * swi[F + col]);
              b1 = bf16_round((float)h[i + 33] * sa * swi[F + col + 1]);
            } else {
              a0 = bf16_round(h[i]), a1 = bf16_round(h[i + 1]);
              b0 = bf16_round(h[i + 32]), b1 = bf16_round(h[i + 33]);
            }
            const float g0 = gelu_erf(a0) * b0, g1 = gelu_erf(a1) * b1;
            if constexpr (!C::QO) {
              *reinterpret_cast<uint32_t*>(g + swizzle128(r, 2 * cc)) = pack_bf16(g0, g1);
            } else if (pass == 0) {
              gmax[hr] = fmaxf(gmax[hr], fmaxf(fabsf(g0), fabsf(g1)));
            } else {  // the pair's tile: this chunk's codes are bytes 64 wg .. 64 wg + 63 of each row
              char2 q;
              q.x = (signed char)quant_code(g0, sg[hr]);
              q.y = (signed char)quant_code(g1, sg[hr]);
              *reinterpret_cast<char2*>(g + swizzle128(r, 64 * wg + cc)) = q;
              if (codes_g && p == 0 && pass == 1 && m0 + r < R)
                *reinterpret_cast<char2*>(codes_g + (long long)(m0 + r) * F + c * FC + cc) = q;
            }
          }
          if (!C::QO || pass >= 1) fence_proxy_async();
          if constexpr (!C::QO) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&g_ready[b]);
          }
        }
        if constexpr (!C::QO) {
          // Wo products of chunks c0 and c0 + 1, each from the g tile its owner wrote
          const int last = c0 + 2 < chunks ? c0 + 2 : chunks;
          for (int j = c0; j < last; ++j) {
            mbar_wait(&g_ready[(gc + j) & 1], ((gc + j) >> 1) & 1);
            mbar_wait(&wo_full[C::WO_SPLIT ? wg : so], po);
            wgmma_fence();
            const uint64_t da = desc_sw128(sG + ((gc + j) & 1) * G_BYTES);
            const uint64_t db = desc_sw128(sWo + so * C::WO_BYTES + wg * NW * 128);
#pragma unroll
            for (int k = 0; k < FC / 16; ++k) wgmma_wo<NW>(acc, da + 2 * k, db + 2 * k, j | k);
            wgmma_commit();
            if constexpr (WOS == 1) {  // the slot (this warpgroup's ring) takes chunk j + 1 next: hand it back now
              wgmma_wait<0>();
              fence_regs(acc);
              release(&wo_empty[C::WO_SPLIT ? wg : so]);
              if (lane == 0) mbar_arrive(&g_free[(gc + j) & 1]);
            }
            if (++so == WOS) so = 0, po ^= 1;
          }
          if constexpr (WOS == 2) {
            wgmma_wait<0>();
            fence_regs(acc);
            for (int j = c0; j < last; ++j) {  // hand back their Wo slots and g tiles
              release(&wo_empty[(so + j - last) & 1]);
              if (lane == 0) mbar_arrive(&g_free[(gc + j) & 1]);
            }
          }
        } else if (pass >= 1) {  // the pair's Wo product (this pass's Wo half), once both halves are written
          __syncwarp();
          if (lane == 0) mbar_arrive(&g_ready[gp & 1]);
          mbar_wait(&g_ready[gp & 1], (gp >> 1) & 1);
          wo_pair(c0 / 2, C::KEEP ? c0 / 2 : gp & 1);
          if (!C::KEEP && lane == 0) mbar_arrive(&g_free[gp & 1]);
          ++gp;
        }
      }
      gc += chunks;
      if (C::QO && pass == 0) {  // every row's absmax over all F, from both warpgroups, then its scale
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float m = gmax[hr];
          m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 2));
          if ((lane & 3) == 0) atomicMax(&sMax[16 * wl + (lane >> 2) + 8 * hr], __float_as_uint(m));
        }
        named_barrier(1, 256);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          sg[hr] = fmaxf(__uint_as_float(sMax[16 * wl + (lane >> 2) + 8 * hr]), 1e-30f) * kInv127;
      }
      if (C::QO && !C::KEEP && pass >= 1) epilogue(m0, n0 + (pass - 1) * NC);  // this quantising pass's half
    }
    if (!C::QO || C::KEEP) epilogue(m0, n0);
    for (int half = 1; half < (C::KEEP ? NH : 1); ++half) {  // 3qq: the other Wo passes, from the kept codes
      for (int kp = 0; kp < (chunks + 1) / 2; ++kp) wo_pair(kp, kp);
      epilogue(m0, n0 + half * NC);
    }
  }
}

}  // namespace sm90_ffn

// One kernel per form, so that a profile names each.
namespace bf16 {

// row 3
template <int DM>
__global__ void __cluster_dims__(sm90_ffn::CM, 1, 1) __launch_bounds__(sm90_ffn::THREADS, 1)
    ffn_kernel(const __grid_constant__ CUtensorMap map_wi, const __grid_constant__ CUtensorMap map_wo,
               const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ swi, const float* __restrict__ swo, __nv_bfloat16* __restrict__ out,
               int8_t* __restrict__ codes_y, int8_t* __restrict__ codes_g, int R, int F, float eps) {
  sm90_ffn::ffn_body<DM, sm90_ffn::BF16>(&map_wi, &map_wo, x, scale, bias, swi, swo, out, codes_y, codes_g, R, F, eps);
}

// row 3o
template <int DM>
__global__ void __cluster_dims__(sm90_ffn::CM, 1, 1) __launch_bounds__(sm90_ffn::THREADS, 1)
    ffn_wo_kernel(const __grid_constant__ CUtensorMap map_wi, const __grid_constant__ CUtensorMap map_wo,
               const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ swi, const float* __restrict__ swo, __nv_bfloat16* __restrict__ out,
               int8_t* __restrict__ codes_y, int8_t* __restrict__ codes_g, int R, int F, float eps) {
  sm90_ffn::ffn_body<DM, sm90_ffn::W8A8_WO_ALONE>(&map_wi, &map_wo, x, scale, bias, swi, swo, out, codes_y, codes_g, R,
                                                  F, eps);
}

}  // namespace bf16

namespace w8a8 {

// row 3qq
template <int DM>
__global__ void __cluster_dims__(sm90_ffn::CM, 1, 1) __launch_bounds__(sm90_ffn::THREADS, 1)
    ffn_wo_kernel(const __grid_constant__ CUtensorMap map_wi, const __grid_constant__ CUtensorMap map_wo,
               const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ swi, const float* __restrict__ swo, __nv_bfloat16* __restrict__ out,
               int8_t* __restrict__ codes_y, int8_t* __restrict__ codes_g, int R, int F, float eps) {
  sm90_ffn::ffn_body<DM, sm90_ffn::W8A8_WO>(&map_wi, &map_wo, x, scale, bias, swi, swo, out, codes_y, codes_g, R, F, eps);
}

}  // namespace w8a8

namespace sm90_ffn {

template <int DM, int FORM>
int launch(const void* x, const void* scale, const void* bias, const void* wi, const void* swi, const void* wo,
           const void* swo, void* out, void* codes_y, void* codes_g, int R, int F, float eps, void* stream) {
  using C = Cfg<DM, FORM>;
  if (F > C::F_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = FORM == BF16      ? bf16::ffn_kernel<DM>
                : FORM == W8A8_WO ? w8a8::ffn_wo_kernel<DM>
                                  : bf16::ffn_wo_kernel<DM>;
  CUtensorMap map_wi, map_wo;
  if (!make_map_2d(&map_wi, wi, C::QI ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   C::QI ? 1 : 2, 2LL * F, DM, FC / CM, C::KS) ||
      !make_map_2d(&map_wo, wo, C::QO ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   C::QO ? 1 : 2, DM, F, C::NW / CM, C::QO ? 2 * FC : FC))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  static const int max_clusters = max_active_clusters((const void*)kernel, THREADS, C::SMEM, CM);
  const int items = ((R + BM - 1) / BM + CM - 1) / CM * C::NP;
  kernel<<<CM * (items < max_clusters ? items : max_clusters), THREADS, C::SMEM, (cudaStream_t)stream>>>(
      map_wi, map_wo, (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (const float*)swi,
      (const float*)swo, (__nv_bfloat16*)out, (int8_t*)codes_y, (int8_t*)codes_g, R, F, eps);
  return (int)cudaGetLastError();
}

}  // namespace sm90_ffn

template <int DM>
int dispatch_q(const void* x, const void* scale, const void* bias, const void* wi, const void* swi,
               const void* wo, const void* swo, void* out, void* codes_y, void* codes_g, int R, int F,
               float eps, int w8a8, int w8a8_wo, void* stream) {
  using namespace sm90_ffn;
  if (w8a8 && w8a8_wo)
    return launch<DM, W8A8_WO>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, stream);
  if (w8a8) return w8a8::launch<DM>(x, scale, bias, wi, swi, wo, out, codes_y, R, F, eps, stream);
  return launch<DM, W8A8_WO_ALONE>(x, scale, bias, wi, nullptr, wo, swo, out, nullptr, codes_g, R, F, eps, stream);
}

}  // namespace

// x, out: (R, DM) bf16; scale, bias: (DM,) fp32 (bias may be null);
// wi: (2F, DM) bf16 (nn.Linear layout of Wi); wo: (DM, F) bf16.
extern "C" int cm3p_fused_ln_ffn(const void* x, const void* scale, const void* bias,
                                 const void* wi, const void* wo, void* out, int R, int DM, int F,
                                 float eps, void* stream) {
  using sm90_ffn::BF16;
  using sm90_ffn::launch;
  if (R <= 0 || F <= 0 || F % sm90_ffn::FC != 0) return (int)cudaErrorInvalidValue;
  if (DM == 768) return launch<768, BF16>(x, scale, bias, wi, nullptr, wo, nullptr, out, nullptr, nullptr, R, F, eps, stream);
  if (DM == 512) return launch<512, BF16>(x, scale, bias, wi, nullptr, wo, nullptr, out, nullptr, nullptr, R, F, eps, stream);
  if (DM == 256) return launch<256, BF16>(x, scale, bias, wi, nullptr, wo, nullptr, out, nullptr, nullptr, R, F, eps, stream);
  return (int)cudaErrorInvalidValue;
}

// The W8A8 forms. As above, except: with w8a8, wi is (2F, DM) int8 codes and swi
// (2F,) fp32 scales; with w8a8_wo, wo is (DM, F) int8 codes and swo (DM,) fp32
// scales; a weight whose option is off stays bf16 and its scales are unused.
// codes_y (R, DM) and codes_g (R, F), int8 or null, receive the activation
// codes the kernel used (w8a8 and w8a8_wo respectively).
extern "C" int cm3p_fused_ln_ffn_q(const void* x, const void* scale, const void* bias,
                                   const void* wi, const void* swi, const void* wo, const void* swo,
                                   void* out, void* codes_y, void* codes_g, int R, int DM, int F,
                                   float eps, int w8a8, int w8a8_wo, void* stream) {
  if (R <= 0 || F <= 0 || F % sm90_ffn::FC != 0 || !(w8a8 || w8a8_wo)) return (int)cudaErrorInvalidValue;
  if ((w8a8 && swi == nullptr) || (w8a8_wo && swo == nullptr)) return (int)cudaErrorInvalidValue;
  if (DM == 768)
    return dispatch_q<768>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  if (DM == 512)
    return dispatch_q<512>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  if (DM == 256)
    return dispatch_q<256>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  return (int)cudaErrorInvalidValue;
}
