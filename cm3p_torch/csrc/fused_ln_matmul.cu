// Fused LayerNorm -> matmul (+ residual) for Hopper, bf16 in and out:
//     out = [res +] bf16( [LN_fp32](x) . W^T )
//
// Replaces the two TPU kernels of the JAX package's ops/fused_ln_matmul.py:
//   * bf16::ln_matmul_kernel   <- _lnmm_kernel   (driven by _pallas_ln_matmul)
//   * w8a8::ln_matmul_q_kernel <- _lnmm_q_kernel (driven by _pallas_ln_matmul_q), W8A8
// With LN (N = 3 DM) it is the attention pre-norm fused into the QKV
// projection; without LN and with a residual (N = DM) it is the attention
// out-projection with its residual add. W comes in the nn.Linear layout
// (N, DM): K-major, as wgmma takes it.
//
// Rounding points kept from the TPU kernels. bf16 form: LN statistics and
// output in fp32 (flax formula), LN output cast to bf16, fp32 accumulation,
// the product cast to bf16, then the bf16 residual added and rounded once
// more. W8A8 form: the whole fp32 LN row (or x as fp32 when there is no LN)
// is quantised per row, sa = max(amax, 1e-30) / 127 over all DM columns,
// codes by true division and round-half-even; int8 x int8 -> int32 products
// (exact); out = bf16(float(acc) * sa * sw[n]) in that order, then the
// residual.
//
// Bound on the H100 at the beatmap tower's shapes (323,584 rows, DM 768):
// the QKV form (N 2304) does 2 R DM N flops on 2 R (DM + N) bytes, about
// 1,150 flops per byte, so the tensor cores bound it in bf16 (1.16 ms); the
// Wo + residual form (N = DM) moves x, res and out, and the bytes bound it
// (0.45 ms); the int8 forms are bound by the bytes.
//
// bf16 form (ln_matmul_kernel, rows 5 and 5r), designed for Hopper.
// Persistent blocks of 384 threads, one per SM, in clusters of two: a cluster
// takes two consecutive 128-row tiles and walks all N in 256-column tiles for
// them, so the SMs stream W (at most 3.5 MB) in step and it stays in L2. A
// producer warp keeps a 4-stage TMA ring full: a stage is the tile's 128 x 64
// slice of x and the 256 x 64 slice of W (48 KB), both in the 128-byte
// swizzle that wgmma reads; each CTA loads half of the W slice and multicasts
// it to both, and rows past R and columns past N arrive as zeros. Two consumer
// warpgroups (setmaxnreg: 232 registers) own 64 rows each and issue wgmma
// m64n256k16 (fp32 accumulators, 128 registers) straight from the stage,
// keeping one stage's products in flight while they wait for the next. The LN
// form computes each row's mean and 1/std once per row tile (a warp per row,
// the TPU kernel's fp32 formula, next tile's x prefetched to L2) and
// normalises its 64 rows of each x slice in shared memory, in place, before
// the products. The residual of a tile is loaded into registers before its
// products; the epilogue turns each warp's 16 x 64 slices around in shared
// memory so that every lane adds the residual and stores 16 bytes.
// What holds it below the bound: the stages come from L2 at about 3 TB/s in
// all (measured: both forms run at the rate their stage bytes allow), and the
// epilogues of the two warpgroups do not overlap their products.
//
// int8 form (w8a8::ln_matmul_q_kernel, rows 6 and 6r), designed for Hopper on
// the bf16 form's plan. Bound by the bytes at both shapes (row 6: x in, three
// times as many bytes out; 6r: x and res in, out), so the design keeps W's L2
// traffic and the front end off the critical path. Persistent blocks of 384
// threads in clusters of two, a cluster taking two consecutive 128-row tiles.
// For each tile the two consumer warpgroups (setmaxnreg: 232 registers) run the
// front end for their 64 rows each, a warp per row and two rows at a time (x
// read 16 bytes a lane, the LN parameters from shared memory): the fp32 LN row
// (or x as fp32), quantised over all DM columns (a multiply by 1 / sa, the true
// division only for a row with a value within 1e-4 of a half), written 8 codes a
// lane into shared memory in the 128-byte swizzle that wgmma reads (96 KB at
// DM 768), with the row scales beside them. The codes stay resident while the tile walks all of
// N in 256-column tiles, so only W streams: a producer warp keeps a TMA ring of
// 256 x 128-byte W slices (32 KB; 3 stages at DM 768, 4 at 512, 5 at 256),
// each CTA loading half and multicasting it to both, columns past N arriving
// as zeros. So L2 serves W once per 256 rows, not once per 64 as the first
// version did. Each warpgroup issues wgmma m64n256k32 s8 x s8 -> s32 straight
// from the codes and the stage, one stage's products in flight while it waits
// for the next. A tile's weight scales are copied to shared memory and its
// residual prefetched to L2 before its products; the epilogue scales the exact
// s32 sums in their registers (float(acc) * sa * sw[n], the TPU kernel's
// order), writes each warp's 16 x 64 slices into shared memory, adds the
// residual there 16 bytes a lane, and hands each slice to a TMA store, so that
// the output (three quarters of row 6's bytes) drains behind the next products.
// What holds it below the bound (copies with one part cut out, timed beside it
// by compare_kernels.py --phase parts; readings in PERF.md): in each warpgroup
// the front end, the products and the epilogue run one after another, and the
// two warpgroups walk the shared ring in step, so their times add. The front
// end and the epilogue each cost about as much as the products and the ring
// together; the codes of a tile (96 KB at DM 768) leave no room for the next
// tile's, so its front end cannot run behind this tile's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_rows.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;

constexpr int BN = 128;  // N must be a multiple of this

// ---------------------------------------------------------------------------
// The bf16 form: warp-specialised, persistent, TMA ring, wgmma (see the note
// at the top of the file).
namespace bf16 {

constexpr int BM = 128;                // rows per tile: two consumer warpgroups of 64
constexpr int BNT = 256;               // output columns per tile (one wgmma N)
constexpr int BK = 64;                 // DM columns per stage: one 128-byte swizzle row
constexpr int STAGES = 4;              // ring depth
constexpr int CM = 2;                  // CTAs of a cluster: consecutive row tiles sharing each W stage
constexpr int A_BYTES = BM * BK * 2;   // 16 KB of x per stage
constexpr int W_BYTES = BNT * BK * 2;  // 32 KB of W per stage, loaded a 1 / CM slice by each CTA
constexpr int THREADS = 384;           // two consumer warpgroups + a producer warpgroup

constexpr int E_BYTES = 8 * 16 * 128;  // epilogue: 16 rows x 64 columns of bf16 for each consumer warp

template <int DM>
constexpr int smem_bytes() {
  return 1024 + STAGES * (A_BYTES + W_BYTES) + 2 * DM * 4 + 2 * BM * 4 + E_BYTES + 2 * STAGES * 8;
}

template <int DM, bool WITH_LN, bool RES>
__global__ void __cluster_dims__(CM, 1, 1) __launch_bounds__(THREADS, 1)
    ln_matmul_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                     const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ out, int R, int N, float eps) {
  using namespace sm90;
  constexpr int KB = DM / BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sW = sA + STAGES * A_BYTES;
  float* sScale = reinterpret_cast<float*>(sW + STAGES * W_BYTES);  // DM, LN form only
  float* sBias = sScale + DM;                                       // DM
  float* sMu = sBias + DM;                                          // BM row means
  float* sRstd = sMu + BM;                                          // BM
  unsigned char* sE = reinterpret_cast<unsigned char*>(sRstd + BM);  // E_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(sE + E_BYTES);       // STAGES: the stage's tiles landed
  uint64_t* empty = full + STAGES;  // STAGES: every consumer warp of the cluster is done with it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = cluster_ctarank();
  const int groups = ((R + BM - 1) / BM + CM - 1) / CM;  // a cluster's CM row tiles
  const int cluster = blockIdx.x / CM, clusters = gridDim.x / CM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * CM);
    }
    fence_mbar_init();
  }
  if (WITH_LN)
    for (int i = threadIdx.x; i < DM; i += THREADS) {
      sScale[i] = scale[i];
      sBias[i] = bias ? bias[i] : 0.f;
    }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or remote arrival reaches them

  if (warp >= 8) {  // producer warpgroup: one thread keeps the ring full
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int g = cluster; g < groups; g += clusters) {
        const int m0 = (g * CM + rank) * BM;
        for (int n0 = 0; n0 < N; n0 += BNT)
          for (int kb = 0; kb < KB; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], A_BYTES + W_BYTES);
            tma_load_2d(sA + stage * A_BYTES, &map_x, &full[stage], kb * BK, m0);
            tma_load_2d_multicast(sW + stage * W_BYTES + rank * (W_BYTES / CM), &map_w, &full[stage], kb * BK,
                                  n0 + rank * (BNT / CM), (1 << CM) - 1);
            if (++stage == STAGES) stage = 0, phase ^= 1;
          }
      }
      // stay until every consumer of the cluster has released every stage: no remote
      // arrival may reach this CTA after it exits
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  regs_alloc<232>();
  const int wg = warp >> 2, wl = warp & 3, tw = threadIdx.x & 127;
  float acc[BNT / 2];
  uint4 rv[2][4];  // residual of two epilogue slices, 8 columns each, in the epilogue's layout
  unsigned char* ebuf = sE + warp * (16 * 128);
  int stage = 0;
  uint32_t phase = 0;
  auto release = [&](int s) {
    if (lane == 0)
      for (int q = 0; q < CM; ++q) mbar_arrive_cluster(&empty[s], q);
  };
  for (int g = cluster; g < groups; g += clusters) {
    const int r0 = (g * CM + rank) * BM + 64 * wg;  // this warpgroup's first row
    if (WITH_LN) {
      // bring the next row tile's x towards L2, then this tile's row statistics (a warp per row)
      const int next = (g + clusters) * CM * BM + rank * BM + 64 * wg;
      for (int line = tw; line < 64 * DM / 64; line += 128) {
        const int row = next + line / (DM / 64);
        if (row < R) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(x + (long long)row * DM + line % (DM / 64) * 64));
      }
      for (int r = 16 * wl; r < 16 * wl + 16; r += 2) {
        float2 y0[DM / 64], y1[DM / 64];
        float mu0 = 0.f, rstd0 = 0.f, mu1 = 0.f, rstd1 = 0.f;
        if (r0 + r < R) ln_row_f32<DM>(x + (long long)(r0 + r) * DM, nullptr, nullptr, eps, lane, y0);
        if (r0 + r + 1 < R) ln_row_f32<DM>(x + (long long)(r0 + r + 1) * DM, nullptr, nullptr, eps, lane, y1);
        if (r0 + r < R) ln_moments<DM>(y0, eps, mu0, rstd0);
        if (r0 + r + 1 < R) ln_moments<DM>(y1, eps, mu1, rstd1);
        if (lane == 0) {
          sMu[64 * wg + r] = mu0, sRstd[64 * wg + r] = rstd0;
          sMu[64 * wg + r + 1] = mu1, sRstd[64 * wg + r + 1] = rstd1;
        }
      }
      named_barrier(1 + wg, 128);
    }
    for (int n0 = 0; n0 < N; n0 += BNT) {
      // epilogue layout: slice s of 64 columns; lane l owns rows l / 8 + 4 i of the warp's 16, columns 8 (l % 8)
      const int erow0 = r0 + 16 * wl + (lane >> 3), ecol = n0 + 8 * (lane & 7);
      auto load_res = [&](int sl) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = erow0 + 4 * i, col = ecol + 64 * sl;
          rv[sl & 1][i] = row < R && col < N ? __ldcs(reinterpret_cast<const uint4*>(res + (long long)row * N + col))
                                             : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      if constexpr (RES) {  // bring the tile's residual towards L2 now; it is loaded into registers with the last stage
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int line = tw + 128 * i, row = r0 + (line >> 2), col = n0 + (line & 3) * 64;
          if (row < R && col < N) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(res + (long long)row * N + col));
        }
      }
      int prev = -1;
      for (int kb = 0; kb < KB; ++kb) {
        mbar_wait(&full[stage], phase);
        unsigned char* a = sA + stage * A_BYTES + wg * (64 * 128);
        if (WITH_LN) {
          // LayerNorm in place on this warpgroup's 64 x 64 slice, in the swizzled layout
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int chunk = tw + 128 * j, r = chunk >> 3;
            const int col = kb * BK + (((chunk & 7) ^ (r & 7)) << 3);
            const float mu = sMu[64 * wg + r], rstd = sRstd[64 * wg + r];
            uint4 v = *reinterpret_cast<uint4*>(a + chunk * 16);
            uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = col + 2 * e;
              float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pv[e]));
              f.x = (f.x - mu) * (rstd * sScale[c]) + sBias[c];
              f.y = (f.y - mu) * (rstd * sScale[c + 1]) + sBias[c + 1];
              pv[e] = pack_bf16(f.x, f.y);
            }
            *reinterpret_cast<uint4*>(a + chunk * 16) = v;
          }
          fence_proxy_async();
          named_barrier(1 + wg, 128);
        }
        wgmma_fence();
        const uint64_t da = desc_sw128(a), db = desc_sw128(sW + stage * W_BYTES);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) wgmma_bf16_n256(acc, da + 2 * k, db + 2 * k, kb | k);
        wgmma_commit();
        if constexpr (RES)  // the first two slices' residual is read while the last stage's products run
          if (kb == KB - 1) load_res(0), load_res(1);
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (prev >= 0) release(prev);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);

      // epilogue: out = [res +] bf16(acc), while the producer already loads the next tile. Each
      // warp turns its 16 x 64 slices around in shared memory so that a lane stores 16 bytes.
#pragma unroll
      for (int sl = 0; sl < BNT / 64; ++sl) {
        if (n0 + 64 * sl >= N) break;
        __syncwarp();
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * sl + jj, r = (lane >> 2) + 8 * hr;
            *reinterpret_cast<uint32_t*>(ebuf + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * (lane & 3)) =
                pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
          }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (lane >> 3) + 4 * i, row = erow0 + 4 * i;
          uint4 v = *reinterpret_cast<const uint4*>(ebuf + r * 128 + (((lane & 7) ^ (r & 7)) << 4));
          if (row >= R) continue;
          if constexpr (RES) {
            uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
            const uint32_t* pr = reinterpret_cast<const uint32_t*>(&rv[sl & 1][i]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pv[e]));
              const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pr[e]));
              pv[e] = pack_bf16(o.x + rr.x, o.y + rr.y);
            }
          }
          __stcs(reinterpret_cast<uint4*>(out + (long long)row * N + ecol + 64 * sl), v);  // streamed past L2
        }
        if constexpr (RES)
          if (sl + 2 < BNT / 64) load_res(sl + 2);
      }
    }
  }
}

template <int DM, bool WITH_LN, bool RES>
int launch(const void* x, const void* scale, const void* bias, const void* w, const void* res, void* out, int R,
           int N, float eps, void* stream) {
  CUtensorMap map_x, map_w;
  if (!make_map_2d(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, R, DM, BM, BK) ||
      !make_map_2d(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, DM, BNT / CM, BK))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<DM>();
  const void* kernel = (const void*)ln_matmul_kernel<DM, WITH_LN, RES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  static const int max_clusters = max_active_clusters(kernel, THREADS, bytes, CM);
  const int groups = ((R + BM - 1) / BM + CM - 1) / CM;
  ln_matmul_kernel<DM, WITH_LN, RES>
      <<<CM * (groups < max_clusters ? groups : max_clusters), THREADS, bytes, (cudaStream_t)stream>>>(
          map_x, map_w, (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias,
          (const __nv_bfloat16*)res, (__nv_bfloat16*)out, R, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// The int8 form: the bf16 form's plan with the activation codes kept in shared
// memory for a tile's whole walk over N (see the note at the top of the file).
namespace w8a8 {

constexpr int BM = 128;                // rows per tile: two consumer warpgroups of 64
constexpr int BNT = 256;               // output columns per tile (one wgmma N)
constexpr int KQ = 128;                // DM codes per stage: one 128-byte swizzle row
constexpr int CM = 2;                  // CTAs of a cluster: consecutive row tiles sharing each W stage
constexpr int W_BYTES = BNT * KQ;      // 32 KB of W codes per stage, loaded a 1 / CM slice by each CTA
constexpr int THREADS = 384;           // two consumer warpgroups + a producer warpgroup
constexpr int E_BYTES = 8 * 16 * 128;  // epilogue: 16 rows x 64 columns of bf16 for each consumer warp

template <int DM>
__host__ __device__ constexpr int stages() {  // as deep as shared memory allows beside the BM x DM codes
  return DM == 768 ? 3 : DM == 512 ? 4 : 5;
}

template <int DM>
constexpr int smem_bytes() {
  return 1024 + BM * DM + stages<DM>() * W_BYTES + E_BYTES + 2 * 2 * BNT * 4 + 2 * DM * 4 + BM * 4 +
         2 * stages<DM>() * 8;
}

// The front end's lane layout: lane l holds columns 256 i + 8 l + j of a row (i < DM / 256, j < 8), so
// that it reads x and writes codes 16 and 8 bytes at a time.
template <int DM>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ xr, int lane, uint4 (&raw)[DM / 256]) {
#pragma unroll
  for (int i = 0; i < DM / 256; ++i) raw[i] = *reinterpret_cast<const uint4*>(xr + 256 * i + 8 * lane);
}

// The row's int8 codes (8 per 32-bit pair, the lane's columns of chunk i in code[i]) and its scale
// sa = max(amax, 1e-30) / 127: the flax LayerNorm in fp32 first when WITH_LN (scale and bias in shared
// memory), then quant_row_int8_x8 (csrc/ln_rows.cuh), whose codes are the plain quantiser's.
template <int DM, bool WITH_LN>
__device__ __forceinline__ float quant_row(const uint4 (&raw)[DM / 256], const float* sScale, const float* sBias,
                                           float eps, int lane, uint2 (&code)[DM / 256]) {
  constexpr int NC = DM / 256;
  float y[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(&raw[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p[e]));
      y[i][2 * e] = f.x, y[i][2 * e + 1] = f.y;
    }
  }
  if constexpr (WITH_LN) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s1 += y[i][j], s2 += y[i][j] * y[i][j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffff, s1, off);
      s2 += __shfl_xor_sync(0xffffffff, s2, off);
    }
    const float mu = s1 / DM, rstd = rsqrtf(fmaxf(s2 / DM - mu * mu, 0.f) + eps);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 256 * i + 8 * lane;
      const float4 sc[2] = {*reinterpret_cast<const float4*>(sScale + c), *reinterpret_cast<const float4*>(sScale + c + 4)};
      const float4 bi[2] = {*reinterpret_cast<const float4*>(sBias + c), *reinterpret_cast<const float4*>(sBias + c + 4)};
      const float* scv = reinterpret_cast<const float*>(sc);
      const float* biv = reinterpret_cast<const float*>(bi);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[i][j] = (y[i][j] - mu) * (rstd * scv[j]) + biv[j];
    }
  }
  return quant_row_int8_x8<NC>(y, code);
}

template <int DM, bool WITH_LN, bool RES>
__global__ void __cluster_dims__(CM, 1, 1) __launch_bounds__(THREADS, 1)
    ln_matmul_q_kernel(const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_out,
                       const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const float* __restrict__ sw,
                       const __nv_bfloat16* __restrict__ res, int8_t* __restrict__ codes_out, int R, int N, float eps) {
  using namespace sm90;
  constexpr int KB = DM / KQ, STAGES = stages<DM>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sW = sQ + BM * DM;                          // STAGES x (BNT rows x KQ codes)
  unsigned char* sE = sW + STAGES * W_BYTES;                 // E_BYTES
  float* sSw = reinterpret_cast<float*>(sE + E_BYTES);       // [warpgroup][N tile parity][BNT] weight scales
  float* sScale = sSw + 2 * 2 * BNT;                         // DM LN scale, LN form only
  float* sBias = sScale + DM;                                // DM LN bias (zeros without one)
  float* sSa = sBias + DM;                                   // BM row scales
  uint64_t* full = reinterpret_cast<uint64_t*>(sSa + BM);   // STAGES: the stage's W slice landed
  uint64_t* empty = full + STAGES;  // STAGES: every consumer warp of the cluster is done with it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = cluster_ctarank();
  const int groups = ((R + BM - 1) / BM + CM - 1) / CM;  // a cluster's CM row tiles
  const int cluster = blockIdx.x / CM, clusters = gridDim.x / CM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * CM);
    }
    fence_mbar_init();
  }
  if (WITH_LN)
    for (int i = threadIdx.x; i < DM; i += THREADS) {
      sScale[i] = scale[i];
      sBias[i] = bias ? bias[i] : 0.f;
    }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or remote arrival reaches them

  if (warp >= 8) {  // producer warpgroup: one thread keeps the ring of W slices full
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      prefetch_map(&map_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int g = cluster; g < groups; g += clusters)
        for (int n0 = 0; n0 < N; n0 += BNT)
          for (int kb = 0; kb < KB; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], W_BYTES);
            tma_load_2d_multicast(sW + stage * W_BYTES + rank * (W_BYTES / CM), &map_w, &full[stage], kb * KQ,
                                  n0 + rank * (BNT / CM), (1 << CM) - 1);
            if (++stage == STAGES) stage = 0, phase ^= 1;
          }
      // stay until every consumer of the cluster has released every stage: no remote
      // arrival may reach this CTA after it exits
      for (int s = 0; s < STAGES; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile, their codes and their products
  regs_alloc<232>();
  const int wg = warp >> 2, wl = warp & 3, tw = threadIdx.x & 127;
  const int rt = 64 * wg;  // the warpgroup's first row in the tile
  int acc[BNT / 2];
  uint4 rv[2][4];  // residual of two epilogue slices, 8 columns each, in the epilogue's layout
  unsigned char* ebuf = sE + warp * (16 * 128);
  int stage = 0, tile = 0;  // tile: N tiles walked so far, whose parity picks the weight-scale buffer
  uint32_t phase = 0;
  auto release = [&](int s) {
    if (lane == 0)
      for (int q = 0; q < CM; ++q) mbar_arrive_cluster(&empty[s], q);
  };
  for (int g = cluster; g < groups; g += clusters) {
    const int r0 = (g * CM + rank) * BM + rt;  // this warpgroup's first row
    // ---- front end: each warp's 16 rows, two at a time: LN (or x) in fp32, per-row int8 codes over all DM
    // columns into the swizzled code blocks, row scales. The warpgroup's codes are read by its own products
    // only: once all four warps have waited for the last of them, the previous tile's codes are free.
    named_barrier(1 + wg, 128);
    // A row past R is read as row 0 and its codes and scale are zeroed after: a branch around the row's
    // loads and shuffles made 6r 16 % slower on the card.
    for (int r = 16 * wl; r < 16 * wl + 16; r += 2) {
      uint4 raw[2][DM / 256];
#pragma unroll
      for (int h = 0; h < 2; ++h) load_row<DM>(x + (long long)(r0 + r + h < R ? r0 + r + h : 0) * DM, lane, raw[h]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + r + h, tr = rt + r + h;
        uint2 code[DM / 256];
        float sa = quant_row<DM, WITH_LN>(raw[h], sScale, sBias, eps, lane, code);
        if (row >= R) {
          sa = 0.f;
#pragma unroll
          for (int i = 0; i < DM / 256; ++i) code[i] = make_uint2(0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < DM / 256; ++i) {
          const int c = 256 * i + 8 * lane;
          *reinterpret_cast<uint2*>(sQ + (c >> 7) * (BM * KQ) + swizzle128(tr, c & 127)) = code[i];
          if (codes_out && row < R) *reinterpret_cast<uint2*>(codes_out + (long long)row * DM + c) = code[i];
        }
        if (lane == 0) sSa[tr] = sa;
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    // the row scales of the lane's two accumulator rows (its warp wrote them)
    const float sa0 = sSa[rt + 16 * wl + (lane >> 2)], sa1 = sSa[rt + 16 * wl + (lane >> 2) + 8];

    for (int n0 = 0; n0 < N; n0 += BNT, ++tile) {
      // the tile's weight scales into this warpgroup's buffer of the tile's parity (the other buffer may still
      // be read by a warp in the previous tile's epilogue; this one was last read two tiles ago, before the
      // barrier of the previous tile)
      float* csw = sSw + (2 * wg + (tile & 1)) * BNT;
      for (int i = tw; i < BNT; i += 128) csw[i] = n0 + i < N ? sw[n0 + i] : 0.f;
      named_barrier(1 + wg, 128);
      // epilogue layout: slice s of 64 columns; lane l owns rows l / 8 + 4 i of the warp's 16, columns 8 (l % 8)
      const int erow0 = r0 + 16 * wl + (lane >> 3), ecol = n0 + 8 * (lane & 7);
      auto load_res = [&](int sl) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = erow0 + 4 * i, col = ecol + 64 * sl;
          rv[sl & 1][i] = row < R && col < N ? __ldcs(reinterpret_cast<const uint4*>(res + (long long)row * N + col))
                                             : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      if constexpr (RES) {  // bring the tile's residual towards L2 now; it is loaded into registers with the last stage
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int line = tw + 128 * i, row = r0 + (line >> 2), col = n0 + (line & 3) * 64;
          if (row < R && col < N) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(res + (long long)row * N + col));
        }
      }
      int prev = -1;
      for (int kb = 0; kb < KB; ++kb) {
        mbar_wait_wg(&full[stage], phase);
        wgmma_fence();
        const uint64_t da = desc_sw128(sQ + kb * (BM * KQ) + rt * KQ), db = desc_sw128(sW + stage * W_BYTES);
#pragma unroll
        for (int k = 0; k < KQ / 32; ++k) wgmma_s8_n256(acc, da + 2 * k, db + 2 * k, kb | k);
        wgmma_commit();
        if constexpr (RES)  // the first two slices' residual is read while the last stage's products run
          if (kb == KB - 1) load_res(0), load_res(1);
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (prev >= 0) release(prev);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);

      // epilogue: out = [res +] bf16(float(acc) * sa * sw[n]), while the producer already loads the next
      // tile. Each warp writes its 16 x 64 slices into its buffer in the 128-byte swizzle, adds the residual
      // there 16 bytes a lane, and hands each slice to a TMA store, which drains it behind the next products.
#pragma unroll
      for (int sl = 0; sl < BNT / 64; ++sl) {
        if (n0 + 64 * sl >= N) break;
        if (lane == 0) bulk_wait_read<0>();  // the warp's previous store has read the buffer
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * sl + jj;
          const float2 s = *reinterpret_cast<const float2*>(csw + 8 * j + 2 * (lane & 3));
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = (lane >> 2) + 8 * hr;
            const float sa = hr ? sa1 : sa0;
            *reinterpret_cast<uint32_t*>(ebuf + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * (lane & 3)) =
                pack_bf16((float)acc[4 * j + 2 * hr] * sa * s.x, (float)acc[4 * j + 2 * hr + 1] * sa * s.y);
          }
        }
        if constexpr (RES) {
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = (lane >> 3) + 4 * i;
            uint4* p = reinterpret_cast<uint4*>(ebuf + r * 128 + (((lane & 7) ^ (r & 7)) << 4));
            uint4 v = *p;
            uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
            const uint32_t* pr = reinterpret_cast<const uint32_t*>(&rv[sl & 1][i]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pv[e]));
              const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pr[e]));
              pv[e] = pack_bf16(o.x + rr.x, o.y + rr.y);
            }
            *p = v;
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {  // rows past R are not written
          tma_store_2d(&map_out, ebuf, n0 + 64 * sl, r0 + 16 * wl);
          bulk_commit();
        }
        if constexpr (RES)
          if (sl + 2 < BNT / 64) load_res(sl + 2);
      }
    }
  }
  if (lane == 0) bulk_wait<0>();  // every store is done before the block's shared memory goes
}

template <int DM, bool WITH_LN, bool RES>
int launch(const void* x, const void* scale, const void* bias, const void* wq, const void* sw, const void* res,
           void* out, void* codes_out, int R, int N, float eps, void* stream) {
  CUtensorMap map_w, map_out;
  if (!make_map_2d(&map_w, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, DM, BNT / CM, KQ) ||
      !make_map_2d(&map_out, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, R, N, 16, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<DM>();
  const void* kernel = (const void*)ln_matmul_q_kernel<DM, WITH_LN, RES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  static const int max_clusters = max_active_clusters(kernel, THREADS, bytes, CM);
  const int groups = ((R + BM - 1) / BM + CM - 1) / CM;
  ln_matmul_q_kernel<DM, WITH_LN, RES>
      <<<CM * (groups < max_clusters ? groups : max_clusters), THREADS, bytes, (cudaStream_t)stream>>>(
          map_w, map_out, (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (const float*)sw,
          (const __nv_bfloat16*)res, (int8_t*)codes_out, R, N, eps);
  return (int)cudaGetLastError();
}

}  // namespace w8a8

}  // namespace

// x: (R, DM) bf16; scale, bias: (DM,) fp32 (bias may be null; both unused
// without LN); w: (N, DM) bf16; res: (R, N) bf16 or null; out: (R, N) bf16.
extern "C" int cm3p_ln_matmul(const void* x, const void* scale, const void* bias, const void* w,
                              const void* res, void* out, int R, int DM, int N, float eps,
                              int with_ln, void* stream) {
  if (R <= 0 || N <= 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (with_ln && scale == nullptr) return (int)cudaErrorInvalidValue;
#define CM3P_LNMM(D)                                                                              \
  if (DM == D) {                                                                                  \
    if (with_ln)                                                                                  \
      return res ? bf16::launch<D, true, true>(x, scale, bias, w, res, out, R, N, eps, stream)     \
                 : bf16::launch<D, true, false>(x, scale, bias, w, res, out, R, N, eps, stream);   \
    return res ? bf16::launch<D, false, true>(x, nullptr, nullptr, w, res, out, R, N, eps, stream) \
               : bf16::launch<D, false, false>(x, nullptr, nullptr, w, res, out, R, N, eps, stream); \
  }
  CM3P_LNMM(768)
  CM3P_LNMM(512)
  CM3P_LNMM(256)
#undef CM3P_LNMM
  return (int)cudaErrorInvalidValue;
}

// As above with wq: (N, DM) int8 codes and sw: (N,) fp32 scales; codes_out:
// (R, DM) int8 or null, the activation codes the kernel used.
extern "C" int cm3p_ln_matmul_q(const void* x, const void* scale, const void* bias, const void* wq,
                                const void* sw, const void* res, void* out, void* codes_out, int R,
                                int DM, int N, float eps, int with_ln, void* stream) {
  if (R <= 0 || N <= 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (with_ln && scale == nullptr) return (int)cudaErrorInvalidValue;
#define CM3P_LNMM_Q(D)                                                                                        \
  if (DM == D) {                                                                                              \
    if (with_ln)                                                                                              \
      return res ? w8a8::launch<D, true, true>(x, scale, bias, wq, sw, res, out, codes_out, R, N, eps, stream) \
                 : w8a8::launch<D, true, false>(x, scale, bias, wq, sw, res, out, codes_out, R, N, eps, stream); \
    return res ? w8a8::launch<D, false, true>(x, nullptr, nullptr, wq, sw, res, out, codes_out, R, N, eps, stream) \
               : w8a8::launch<D, false, false>(x, nullptr, nullptr, wq, sw, res, out, codes_out, R, N, eps, stream); \
  }
  CM3P_LNMM_Q(768)
  CM3P_LNMM_Q(512)
  CM3P_LNMM_Q(256)
#undef CM3P_LNMM_Q
  return (int)cudaErrorInvalidValue;
}
