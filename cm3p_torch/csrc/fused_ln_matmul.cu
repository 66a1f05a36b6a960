// Fused LayerNorm -> matmul (+ residual) for Hopper, bf16 in and out:
//     out = [res +] bf16( [LN_fp32](x) . W^T )
//
// Replaces the two TPU kernels of the JAX package's ops/fused_ln_matmul.py:
//   * ln_matmul_kernel   <- _lnmm_kernel   (driven by _pallas_ln_matmul)
//   * ln_matmul_q_kernel <- _lnmm_q_kernel (driven by _pallas_ln_matmul_q), W8A8
// With LN (N = 3 DM) it is the attention pre-norm fused into the QKV
// projection; without LN and with a residual (N = DM) it is the attention
// out-projection with its residual add. W comes in the nn.Linear layout
// (N, DM), which is the "col" operand of mma.sync as it lies in memory.
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
// Design. A block of 8 warps owns 64 rows. The front end gives each warp 8
// rows: a warp holds one row in registers (DM / 32 values a lane), so the
// statistics and the row's absmax are warp shuffles and the fp32 row never
// needs shared memory; what is stored is the matmul operand (bf16, or int8
// codes plus one scale per row). The block then walks N in tiles of 128
// columns; W tiles are staged through shared memory in slices of 32 (bf16) or
// 128 (int8) of DM; each warp owns a 32 x 32 piece of the 64 x 128 tile
// (2 x 4 mma tiles). Rows beyond R are zero operands and are never written.
// Bound on the H100 at the beatmap tower's QKV shape (DM 768, N 2304): 2 R DM N
// flops against 2 R (DM + N) bytes, about 1,150 flops per byte in bf16: the
// tensor cores bound the bf16 form, the bytes the int8 form and both Wo forms.
// This first kernel re-reads W from L2 for every 64 rows and does not overlap
// loads with products, so it runs below those bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_rows.cuh"

namespace {

using namespace cm3p;

constexpr int BR = 64;          // rows per block
constexpr int NTHREADS = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int BN = 128;         // output columns per tile
constexpr int KS = 32;          // bf16: DM slice staged per step (two blocks fit an SM at DM = 768)
constexpr int LDW = KS + 8;     // padded smem row of a staged bf16 slice (elements)
constexpr int KSQ = 128;        // int8: DM slice staged per step
constexpr int LDWQ = KSQ + 16;  // padded smem row of a staged int8 slice (bytes)

template <int DM>
constexpr int smem_bytes() {
  return (BR * (DM + 8) + BN * LDW) * 2;
}

template <int DM>
constexpr int smem_bytes_q() {
  return BR * (DM + 16) + BN * LDWQ + BR * 4;
}

template <int DM, bool WITH_LN>
__global__ void __launch_bounds__(NTHREADS, 2)
    ln_matmul_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out, int R,
                     int N, float eps) {
  constexpr int LDY = DM + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BR x LDY  operand rows
  __nv_bfloat16* sW = sY + BR * LDY;                               // BN x LDW  W slice

  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- front end: each warp prepares 8 rows of the bf16 operand
  for (int rr = warp; rr < BR; rr += NTHREADS / 32) {
    const int row = row0 + rr;
    if (row < R) {
      const __nv_bfloat16* xr = x + (long long)row * DM;
      if (WITH_LN) {
        float2 y[DM / 64];
        ln_row_f32<DM>(xr, scale, bias, eps, lane, y);
#pragma unroll
        for (int i = 0; i < DM / 64; ++i)
          *reinterpret_cast<uint32_t*>(sY + rr * LDY + i * 64 + lane * 2) = pack_bf16(y[i].x, y[i].y);
      } else {
        for (int c = lane * 8; c < DM; c += 256)
          *reinterpret_cast<uint4*>(sY + rr * LDY + c) = *reinterpret_cast<const uint4*>(xr + c);
      }
    } else {
      for (int c = lane * 8; c < DM; c += 256)
        *reinterpret_cast<uint4*>(sY + rr * LDY + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int rg = warp & 1;   // rows rg*32 .. rg*32+31 of the block
  const int cg = warp >> 1;  // columns cg*32 .. cg*32+31 of the tile

  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

    for (int k0 = 0; k0 < DM; k0 += KS) {
      __syncthreads();
      for (int item = threadIdx.x; item < BN * (KS / 8); item += NTHREADS) {
        const int r = item / (KS / 8);
        const int c = (item % (KS / 8)) * 8;
        *reinterpret_cast<uint4*>(sW + r * LDW + c) =
            *reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * DM + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* yp = sY + (rg * 32 + mt * 16 + g) * LDY + k0 + ks * 16 + t * 2;
          af[mt][0] = lds32(yp);
          af[mt][1] = lds32(yp + 8 * LDY);
          af[mt][2] = lds32(yp + 8);
          af[mt][3] = lds32(yp + 8 * LDY + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* wp = sW + (cg * 32 + nt * 8 + g) * LDW + ks * 16 + t * 2;
          const uint32_t b0 = lds32(wp), b1 = lds32(wp + 8);
          mma_bf16(acc[0][nt], af[0], b0, b1);
          mma_bf16(acc[1][nt], af[1], b0, b1);
        }
      }
    }

    // ---- epilogue of the tile: out = [res +] bf16(acc)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + rg * 32 + mt * 16 + g + hr * 8;
        if (row >= R) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const long long at = (long long)row * N + n0 + cg * 32 + nt * 8 + t * 2;
          float o0 = bf16_round(acc[mt][nt][2 * hr]), o1 = bf16_round(acc[mt][nt][2 * hr + 1]);
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
int launch(const void* x, const void* scale, const void* bias, const void* w, const void* res,
           void* out, int R, int N, float eps, void* stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_kernel<DM, WITH_LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ln_matmul_kernel<DM, WITH_LN><<<(R + BR - 1) / BR, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)res, (__nv_bfloat16*)out, R, N, eps);
  return (int)cudaGetLastError();
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
#define CM3P_LNMM(D)                                                                        \
  if (DM == D)                                                                              \
    return with_ln ? launch<D, true>(x, scale, bias, w, res, out, R, N, eps, stream)        \
                   : launch<D, false>(x, nullptr, nullptr, w, res, out, R, N, eps, stream);
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
