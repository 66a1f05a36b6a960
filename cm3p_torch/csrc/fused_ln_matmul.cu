// Fused LayerNorm -> matmul (+ residual) for Hopper, bf16 in and out:
//     out = [res +] bf16( [LN_fp32](x) . W^T )
//
// Replaces the two TPU kernels of the JAX package's ops/fused_ln_matmul.py:
//   * ln_matmul_kernel   <- _lnmm_kernel   (driven by _pallas_ln_matmul)
//   * ln_matmul_q_kernel <- _lnmm_q_kernel (driven by _pallas_ln_matmul_q), W8A8
// With LN (N = 3 DM) it is the attention pre-norm fused into the QKV
// projection; without LN and with a residual (N = DM) it is the attention
// out-projection with its residual add. W comes in the nn.Linear layout
// (N, DM): K-major, as both wgmma and mma.sync take it.
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
// int8 form (ln_matmul_q_kernel, rows 6 and 6r), the first version: a block of
// 8 warps owns 64 rows. The front end gives each warp 8 rows (one row in
// registers, DM / 32 values a lane: statistics and absmax are warp shuffles);
// the int8 codes plus one scale per row go to shared memory. The block walks
// N in tiles of 128 columns, staging W through shared memory in slices of 128
// of DM; each warp owns a 32 x 32 piece of the tile (mma.sync). It re-reads W
// from L2 for every 64 rows and does not overlap loads with products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_rows.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;

constexpr int BN = 128;         // N must be a multiple of this
// int8 form
constexpr int BR = 64;          // rows per block
constexpr int NTHREADS = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int KSQ = 128;        // DM slice staged per step
constexpr int LDWQ = KSQ + 16;  // padded smem row of a staged int8 slice (bytes)

template <int DM>
constexpr int smem_bytes_q() {
  return BR * (DM + 16) + BN * LDWQ + BR * 4;
}

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

template <int DM, bool WITH_LN>
__global__ void __launch_bounds__(NTHREADS)
    ln_matmul_q_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, const int8_t* __restrict__ wq,
                       const float* __restrict__ sw, const __nv_bfloat16* __restrict__ res,
                       __nv_bfloat16* __restrict__ out, int8_t* __restrict__ codes_out, int R, int N,
                       float eps) {
  constexpr int LDQ = DM + 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);            // BR x LDQ   activation codes
  int8_t* sWq = sQ + BR * LDQ;                                 // BN x LDWQ  weight codes slice
  float* sSa = reinterpret_cast<float*>(sWq + BN * LDWQ);      // BR         row scales

  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- front end: LN (or x as fp32) in registers, row absmax, int8 codes
  for (int rr = warp; rr < BR; rr += NTHREADS / 32) {
    const int row = row0 + rr;
    if (row < R) {
      float2 y[DM / 64];
      ln_row_f32<DM>(x + (long long)row * DM, WITH_LN ? scale : nullptr, bias, eps, lane, y);
      const float sa = quant_row_int8<DM>(y, lane, sQ + rr * LDQ,
                                          codes_out ? codes_out + (long long)row * DM : nullptr);
      if (lane == 0) sSa[rr] = sa;
    } else {
      for (int c = lane * 16; c < DM; c += 512)
        *reinterpret_cast<uint4*>(sQ + rr * LDQ + c) = make_uint4(0u, 0u, 0u, 0u);
      if (lane == 0) sSa[rr] = 0.f;
    }
  }

  const int rg = warp & 1;
  const int cg = warp >> 1;

  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

    for (int k0 = 0; k0 < DM; k0 += KSQ) {
      __syncthreads();
      for (int item = threadIdx.x; item < BN * (KSQ / 16); item += NTHREADS) {
        const int r = item / (KSQ / 16);
        const int c = (item % (KSQ / 16)) * 16;
        *reinterpret_cast<uint4*>(sWq + r * LDWQ + c) =
            *reinterpret_cast<const uint4*>(wq + (long long)(n0 + r) * DM + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KSQ / 32; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int8_t* qp = sQ + (rg * 32 + mt * 16 + g) * LDQ + k0 + ks * 32 + t * 4;
          af[mt][0] = lds32(qp);
          af[mt][1] = lds32(qp + 8 * LDQ);
          af[mt][2] = lds32(qp + 16);
          af[mt][3] = lds32(qp + 8 * LDQ + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* wp = sWq + (cg * 32 + nt * 8 + g) * LDWQ + ks * 32 + t * 4;
          const uint32_t b0 = lds32(wp), b1 = lds32(wp + 16);
          mma_s8(acc[0][nt], af[0], b0, b1);
          mma_s8(acc[1][nt], af[1], b0, b1);
        }
      }
    }

    // ---- epilogue of the tile: out = [res +] bf16(float(acc) * sa * sw[n])
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rr = rg * 32 + mt * 16 + g + hr * 8;
        const int row = row0 + rr;
        if (row >= R) continue;
        const float sa = sSa[rr];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + cg * 32 + nt * 8 + t * 2;
          const long long at = (long long)row * N + col;
          float o0 = bf16_round((float)acc[mt][nt][2 * hr] * sa * sw[col]);
          float o1 = bf16_round((float)acc[mt][nt][2 * hr + 1] * sa * sw[col + 1]);
          if (res) {
            const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + at));
            o0 += rv.x;
            o1 += rv.y;
          }
          *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(o0, o1);
        }
      }
    }
  }
}

template <int DM, bool WITH_LN>
int launch_q(const void* x, const void* scale, const void* bias, const void* wq, const void* sw,
             const void* res, void* out, void* codes_out, int R, int N, float eps, void* stream) {
  constexpr int bytes = smem_bytes_q<DM>();
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_q_kernel<DM, WITH_LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ln_matmul_q_kernel<DM, WITH_LN><<<(R + BR - 1) / BR, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (const int8_t*)wq,
      (const float*)sw, (const __nv_bfloat16*)res, (__nv_bfloat16*)out, (int8_t*)codes_out, R, N, eps);
  return (int)cudaGetLastError();
}

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
#define CM3P_LNMM_Q(D)                                                                              \
  if (DM == D)                                                                                      \
    return with_ln                                                                                  \
               ? launch_q<D, true>(x, scale, bias, wq, sw, res, out, codes_out, R, N, eps, stream)  \
               : launch_q<D, false>(x, nullptr, nullptr, wq, sw, res, out, codes_out, R, N, eps, stream);
  CM3P_LNMM_Q(768)
  CM3P_LNMM_Q(512)
  CM3P_LNMM_Q(256)
#undef CM3P_LNMM_Q
  return (int)cudaErrorInvalidValue;
}
