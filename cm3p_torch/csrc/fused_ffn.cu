// Fused LayerNorm + GeGLU half-block for Hopper, bf16 in and out:
//     out = x + Wo( gelu_erf(a) * b ),   [a | b] = Wi( LN_fp32(x) )
//
// Replaces the TPU kernel of the JAX package's ops/fused_ffn.py _ffn_kernel (driven by
// _pallas_ln_ffn), at the three tower widths DM = 768 (beatmap), 512 (audio)
// and 256 (metadata): fused_ln_ffn_kernel is its bf16 form, and
// fused_ln_ffn_q_kernel (below, with its own note) its w8a8 / w8a8_wo forms
// with an int8 Wi and / or Wo. The training path runs neither: under autograd
// the layer runs the plain composition and its analytic backward
// (ops/fused_ffn.py), as the JAX package does.
//
// Rounding points kept from the TPU kernel: LN statistics and output in
// fp32 (flax formula, var = E[x^2] - E[x]^2), LN output cast to bf16 before
// Wi, h = Wi(y) accumulated in fp32 and cast to bf16, gelu(a) * b in fp32
// then cast to bf16 before Wo, Wo accumulated in fp32 and cast to bf16,
// residual added to that bf16 value and rounded once more.
//
// Design: the TPU kernel keeps the (rows, 2F) intermediate in VMEM; on the
// H100 64 rows of it (295 KB at F = 1152) do not fit a block's 227 KB of
// shared memory, so the intermediate is chunked over F instead. A block of
// 8 warps owns 32 rows and the whole (32, DM) output accumulator in
// registers. For each chunk of 64 columns of a (and the matching 64 of b):
//   1. h_chunk (32 x 128) = y (32 x DM, bf16 in smem) . Wi_chunk^T, with Wi
//      staged through smem 64 columns of DM at a time;
//   2. g = bf16(gelu(bf16(a)) * bf16(b)) into smem (32 x 64);
//   3. acc (32 x DM) += g . Wo[:, chunk]^T, with the Wo chunk staged in smem.
// The intermediate never reaches device memory. Products are mma.sync
// m16n8k16 bf16 with fp32 accumulation.
// Bound on the H100: 6 * rows * DM * F flops against 4 * rows * DM bytes of
// activations, about 1,700 flops per byte at DM = 768: bound by the tensor
// cores. This first kernel re-reads both weight matrices from L2 for every
// 32 rows and does not overlap loads with products, so it runs well below
// that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_rows.cuh"

namespace {

using namespace cm3p;

constexpr int BR = 32;          // rows per block
constexpr int NTHREADS = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int FC = 64;          // F chunk (columns of a; the same of b)
constexpr int KS = 64;          // DM slice staged per step of the Wi product
constexpr int LDW = 64 + 8;     // padded smem row of a staged weight slice

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

template <int DM>
constexpr int smem_bytes() {
  return (BR * (DM + 8) + 2 * FC * LDW + BR * LDW + DM * LDW) * 2;
}

template <int DM>
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_ln_ffn_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, const __nv_bfloat16* __restrict__ wi,
                        const __nv_bfloat16* __restrict__ wo, __nv_bfloat16* __restrict__ out,
                        int R, int F, float eps) {
  constexpr int LDY = DM + 8;
  constexpr int NT = DM / 32;  // n-tiles of 8 output columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);                 // BR x LDY   LN output
  __nv_bfloat16* sWi = sY + BR * LDY;        // 2FC x LDW  Wi slice: a rows, then b rows
  __nv_bfloat16* sG = sWi + 2 * FC * LDW;    // BR x LDW   gelu(a) * b
  __nv_bfloat16* sWo = sG + BR * LDW;        // DM x LDW   Wo[:, chunk]

  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- LayerNorm: each warp normalises 4 rows into sY (bf16)
  for (int rr = warp; rr < BR; rr += NTHREADS / 32) {
    const int row = row0 + rr;
    if (row < R) {
      const __nv_bfloat16* xr = x + (long long)row * DM;
      float2 v[DM / 64];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < DM / 64; ++i) {
        v[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i * 64 + lane * 2));
        s1 += v[i].x + v[i].y;
        s2 += v[i].x * v[i].x + v[i].y * v[i].y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffff, s1, off);
        s2 += __shfl_xor_sync(0xffffffff, s2, off);
      }
      const float mu = s1 / DM;
      const float var = fmaxf(s2 / DM - mu * mu, 0.f);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < DM / 64; ++i) {
        const int c = i * 64 + lane * 2;
        const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
        const float y0 = (v[i].x - mu) * (rstd * scale[c]) + b0;
        const float y1 = (v[i].y - mu) * (rstd * scale[c + 1]) + b1;
        *reinterpret_cast<uint32_t*>(sY + rr * LDY + c) = pack_bf16(y0, y1);
      }
    } else {
      for (int c = lane * 2; c < DM; c += 64)
        *reinterpret_cast<uint32_t*>(sY + rr * LDY + c) = 0u;
    }
  }

  const int rg = warp & 1;   // rows rg*16 .. rg*16+15
  const int cg = warp >> 1;  // column group 0..3
  const int ar = rg * 16;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    // ---- 1. h chunk: this warp owns a-columns cg*16..cg*16+15 of the chunk
    //         (n-tiles 0, 1) and the same b-columns (n-tiles 2, 3)
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i][0] = h[i][1] = h[i][2] = h[i][3] = 0.f;
    for (int k0 = 0; k0 < DM; k0 += KS) {
      __syncthreads();
      for (int item = threadIdx.x; item < 2 * FC * (KS / 8); item += NTHREADS) {
        const int r = item / (KS / 8);
        const int c = (item % (KS / 8)) * 8;
        const int wrow = r < FC ? f0 + r : F + f0 + (r - FC);
        *reinterpret_cast<uint4*>(sWi + r * LDW + c) =
            *reinterpret_cast<const uint4*>(wi + (long long)wrow * DM + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        uint32_t af[4];
        const __nv_bfloat16* yp = sY + (ar + g) * LDY + k0 + ks * 16 + t * 2;
        af[0] = lds32(yp);
        af[1] = lds32(yp + 8 * LDY);
        af[2] = lds32(yp + 8);
        af[3] = lds32(yp + 8 * LDY + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int wr = (nt < 2 ? 0 : FC) + cg * 16 + (nt & 1) * 8 + g;
          const __nv_bfloat16* wp = sWi + wr * LDW + ks * 16 + t * 2;
          mma_bf16(h[nt], af, lds32(wp), lds32(wp + 8));
        }
      }
    }
    // ---- 2. g = bf16(gelu(a) * b) with a, b rounded to bf16 first
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float a0 = bf16_round(h[nt][2 * hr]), a1 = bf16_round(h[nt][2 * hr + 1]);
        const float b0 = bf16_round(h[nt + 2][2 * hr]), b1 = bf16_round(h[nt + 2][2 * hr + 1]);
        const int r = ar + g + hr * 8;
        const int c = cg * 16 + nt * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(sG + r * LDW + c) =
            pack_bf16(gelu_erf(a0) * b0, gelu_erf(a1) * b1);
      }
    }
    // stage Wo[:, f0:f0+64] as DM rows of 64
    for (int item = threadIdx.x; item < DM * (FC / 8); item += NTHREADS) {
      const int r = item / (FC / 8);
      const int c = (item % (FC / 8)) * 8;
      *reinterpret_cast<uint4*>(sWo + r * LDW + c) =
          *reinterpret_cast<const uint4*>(wo + (long long)r * F + f0 + c);
    }
    __syncthreads();
    // ---- 3. acc += g . Wo_chunk^T over this warp's DM/4 output columns
#pragma unroll
    for (int ks = 0; ks < FC / 16; ++ks) {
      uint32_t af[4];
      const __nv_bfloat16* gp = sG + (ar + g) * LDW + ks * 16 + t * 2;
      af[0] = lds32(gp);
      af[1] = lds32(gp + 8 * LDW);
      af[2] = lds32(gp + 8);
      af[3] = lds32(gp + 8 * LDW + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* wp = sWo + (cg * (DM / 4) + nt * 8 + g) * LDW + ks * 16 + t * 2;
        mma_bf16(acc[nt], af, lds32(wp), lds32(wp + 8));
      }
    }
  }

  // ---- epilogue: out = x + bf16(acc), rounded to bf16
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + ar + g + hr * 8;
    if (row >= R) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = cg * (DM / 4) + nt * 8 + t * 2;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (long long)row * DM + c));
      const float o0 = bf16_round(acc[nt][2 * hr]), o1 = bf16_round(acc[nt][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(out + (long long)row * DM + c) = pack_bf16(xv.x + o0, xv.y + o1);
    }
  }
}

template <int DM>
int launch(const void* x, const void* scale, const void* bias, const void* wi, const void* wo,
           void* out, int R, int F, float eps, void* stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(fused_ln_ffn_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BR - 1) / BR;
  fused_ln_ffn_kernel<DM><<<blocks, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias,
      (const __nv_bfloat16*)wi, (const __nv_bfloat16*)wo, (__nv_bfloat16*)out, R, F, eps);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The W8A8 forms (w8a8: int8 Wi; w8a8_wo: int8 Wo; either or both).
//
// QI (w8a8): the fp32 LN row is quantised per row over all DM columns (the
// warp that normalises a row holds it in registers, so the absmax is a warp
// shuffle) and Wi is int8 per output channel; h = bf16(float(acc) * sa * swi)
// with the int32 accumulator exact. The GeGLU follows as in the bf16 form.
// QO (w8a8_wo): the fp32 gelu(a) * b row is quantised per row over all F
// columns and Wo is int8; o = bf16(float(acc) * sg * swo).
//
// The row scale sg needs the absmax over all F columns, but this kernel never
// holds the (rows, F) intermediate: it walks F in chunks of 64. Holding 32
// rows of fp32 gelu(a) * b would take 147 KB of shared memory at F = 1152
// beside the operand rows and the staged weights, and 16-row blocks would halve
// the work per staged weight byte. So with QO the chunk loop runs twice: pass 0
// recomputes h and gelu(a) * b only to find each row's absmax (registers, then
// an atomicMax per row in shared memory), pass 1 recomputes them, quantises
// with the now known scale and accumulates the int8 Wo product in int32 (exact,
// so the chunk order does not matter). Both passes run the same instructions
// on the same operands, so the values quantised are the values measured. The
// price is the Wi product twice (10 instead of 6 R DM F operations, 4 of
// them doubled), paid only in the w8a8_wo form.
template <int DM, bool QI, bool QO>
constexpr int smem_bytes_q() {
  return (QI ? BR * (DM + 16) : BR * (DM + 8) * 2) + 2 * FC * LDW * 2 + BR * LDW * 2 +
         DM * (QO ? FC + 16 : LDW * 2) + 2 * BR * 4;
}

template <int DM, bool QI, bool QO>
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_ln_ffn_q_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, const void* __restrict__ wi_raw,
                          const float* __restrict__ swi, const void* __restrict__ wo_raw,
                          const float* __restrict__ swo, __nv_bfloat16* __restrict__ out,
                          int8_t* __restrict__ codes_y, int8_t* __restrict__ codes_g, int R, int F,
                          float eps) {
  constexpr int LDY = DM + 8;        // bf16 operand row (elements)
  constexpr int LDQ = DM + 16;       // int8 operand row (bytes)
  constexpr int KSI = QI ? 128 : KS;  // DM slice staged per step of the Wi product
  constexpr int LDWI = LDW * 2;      // staged Wi row in bytes (64 bf16 + 8, or 128 int8 + 16)
  constexpr int LDG = QO ? FC + 16 : LDW * 2;  // row of gelu(a) * b in bytes
  constexpr int LDO = LDG;           // staged Wo row in bytes
  constexpr int NT = DM / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sA = smem_raw;                                   // BR operand rows (bf16 or int8)
  unsigned char* sWi = sA + (QI ? BR * LDQ : BR * LDY * 2);       // 2FC x LDWI
  unsigned char* sG = sWi + 2 * FC * LDWI;                        // BR x LDG (space for LDW * 2)
  unsigned char* sWo = sG + BR * LDW * 2;                         // DM x LDO
  float* sSa = reinterpret_cast<float*>(sWo + DM * LDO);          // BR  LN row scales
  unsigned int* sMax = reinterpret_cast<unsigned int*>(sSa + BR); // BR  absmax of gelu(a) * b (bits)

  const __nv_bfloat16* wi = reinterpret_cast<const __nv_bfloat16*>(wi_raw);
  const int8_t* wiq = reinterpret_cast<const int8_t*>(wi_raw);
  const __nv_bfloat16* wo = reinterpret_cast<const __nv_bfloat16*>(wo_raw);
  const int8_t* woq = reinterpret_cast<const int8_t*>(wo_raw);

  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- LayerNorm: each warp normalises 4 rows; int8 codes or bf16 into sA
  for (int rr = warp; rr < BR; rr += NTHREADS / 32) {
    const int row = row0 + rr;
    if (lane == 0) sMax[rr] = 0u;
    if (row < R) {
      float2 y[DM / 64];
      ln_row_f32<DM>(x + (long long)row * DM, scale, bias, eps, lane, y);
      if (QI) {
        const float sa = quant_row_int8<DM>(y, lane, reinterpret_cast<int8_t*>(sA) + rr * LDQ,
                                            codes_y ? codes_y + (long long)row * DM : nullptr);
        if (lane == 0) sSa[rr] = sa;
      } else {
#pragma unroll
        for (int i = 0; i < DM / 64; ++i)
          *reinterpret_cast<uint32_t*>(sA + (rr * LDY + i * 64 + lane * 2) * 2) =
              pack_bf16(y[i].x, y[i].y);
      }
    } else {
      constexpr int row_bytes = QI ? LDQ : LDY * 2;
      for (int c = lane * 16; c < row_bytes; c += 512)
        *reinterpret_cast<uint4*>(sA + rr * row_bytes + c) = make_uint4(0u, 0u, 0u, 0u);
      if (lane == 0) sSa[rr] = 0.f;
    }
  }

  const int rg = warp & 1;   // rows rg*16 .. rg*16+15
  const int cg = warp >> 1;  // column group 0..3
  const int ar = rg * 16;

  float accf[NT][4];
  int acci[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    accf[i][0] = accf[i][1] = accf[i][2] = accf[i][3] = 0.f;
    acci[i][0] = acci[i][1] = acci[i][2] = acci[i][3] = 0;
  }
  float gmax[2] = {0.f, 0.f};  // pass 0: this thread's absmax for rows ar+g, ar+g+8
  float sg[2] = {1.f, 1.f};    // pass 1: those rows' scales

  for (int pass = QO ? 0 : 1; pass < 2; ++pass) {
    if (QO && pass == 1) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float m = gmax[hr];
        m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 2));
        if (t == 0) atomicMax(&sMax[ar + g + hr * 8], __float_as_uint(m));
      }
      __syncthreads();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        sg[hr] = fmaxf(__uint_as_float(sMax[ar + g + hr * 8]), 1e-30f) * kInv127;
    }
    for (int f0 = 0; f0 < F; f0 += FC) {
      // ---- 1. h chunk: this warp owns a-columns cg*16..cg*16+15 of the chunk
      //         (n-tiles 0, 1) and the same b-columns (n-tiles 2, 3)
      float h[4][4];
      int hi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i][0] = h[i][1] = h[i][2] = h[i][3] = 0.f;
        hi[i][0] = hi[i][1] = hi[i][2] = hi[i][3] = 0;
      }
      for (int k0 = 0; k0 < DM; k0 += KSI) {
        __syncthreads();
        // 2FC rows (a rows, then b rows) x 128 bytes of Wi, either type
        for (int item = threadIdx.x; item < 2 * FC * 8; item += NTHREADS) {
          const int r = item / 8;
          const int c = (item % 8) * 16;
          const long long wrow = r < FC ? f0 + r : F + f0 + (r - FC);
          const unsigned char* src = QI ? reinterpret_cast<const unsigned char*>(wiq + wrow * DM + k0)
                                        : reinterpret_cast<const unsigned char*>(wi + wrow * DM + k0);
          *reinterpret_cast<uint4*>(sWi + r * LDWI + c) = *reinterpret_cast<const uint4*>(src + c);
        }
        __syncthreads();
        if (QI) {
#pragma unroll
          for (int ks = 0; ks < KSI / 32; ++ks) {
            uint32_t af[4];
            const unsigned char* qp = sA + (ar + g) * LDQ + k0 + ks * 32 + t * 4;
            af[0] = lds32(qp);
            af[1] = lds32(qp + 8 * LDQ);
            af[2] = lds32(qp + 16);
            af[3] = lds32(qp + 8 * LDQ + 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int wr = (nt < 2 ? 0 : FC) + cg * 16 + (nt & 1) * 8 + g;
              const unsigned char* wp = sWi + wr * LDWI + ks * 32 + t * 4;
              mma_s8(hi[nt], af, lds32(wp), lds32(wp + 16));
            }
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < KSI / 16; ++ks) {
            uint32_t af[4];
            const unsigned char* yp = sA + ((ar + g) * LDY + k0 + ks * 16 + t * 2) * 2;
            af[0] = lds32(yp);
            af[1] = lds32(yp + 8 * LDY * 2);
            af[2] = lds32(yp + 16);
            af[3] = lds32(yp + 8 * LDY * 2 + 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int wr = (nt < 2 ? 0 : FC) + cg * 16 + (nt & 1) * 8 + g;
              const unsigned char* wp = sWi + wr * LDWI + (ks * 16 + t * 2) * 2;
              mma_bf16(h[nt], af, lds32(wp), lds32(wp + 16));
            }
          }
        }
      }
      if (QI) {
        // h = float(acc) * sa * swi[column], in that order
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = (nt < 2 ? 0 : F) + f0 + cg * 16 + (nt & 1) * 8 + t * 2;
          const float s0 = swi[col], s1 = swi[col + 1];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float sa = sSa[ar + g + hr * 8];
            h[nt][2 * hr] = (float)hi[nt][2 * hr] * sa * s0;
            h[nt][2 * hr + 1] = (float)hi[nt][2 * hr + 1] * sa * s1;
          }
        }
      }
      // ---- 2. gelu(a) * b in fp32, with a and b rounded to bf16 first
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float a0 = bf16_round(h[nt][2 * hr]), a1 = bf16_round(h[nt][2 * hr + 1]);
          const float b0 = bf16_round(h[nt + 2][2 * hr]), b1 = bf16_round(h[nt + 2][2 * hr + 1]);
          const float g0 = gelu_erf(a0) * b0, g1 = gelu_erf(a1) * b1;
          const int r = ar + g + hr * 8;
          const int c = cg * 16 + nt * 8 + t * 2;
          if (QO) {
            if (pass == 0) {
              gmax[hr] = fmaxf(gmax[hr], fmaxf(fabsf(g0), fabsf(g1)));
            } else {
              char2 q;
              q.x = (signed char)quant_code(g0, sg[hr]);
              q.y = (signed char)quant_code(g1, sg[hr]);
              *reinterpret_cast<char2*>(sG + r * LDG + c) = q;
              if (codes_g && row0 + r < R)
                *reinterpret_cast<char2*>(codes_g + (long long)(row0 + r) * F + f0 + c) = q;
            }
          } else {
            *reinterpret_cast<uint32_t*>(sG + r * LDG + c * 2) = pack_bf16(g0, g1);
          }
        }
      }
      if (pass == 0) continue;
      // stage Wo[:, f0:f0+64] as DM rows of 64 values
      if (QO) {
        for (int item = threadIdx.x; item < DM * (FC / 16); item += NTHREADS) {
          const int r = item / (FC / 16);
          const int c = (item % (FC / 16)) * 16;
          *reinterpret_cast<uint4*>(sWo + r * LDO + c) =
              *reinterpret_cast<const uint4*>(woq + (long long)r * F + f0 + c);
        }
      } else {
        for (int item = threadIdx.x; item < DM * (FC / 8); item += NTHREADS) {
          const int r = item / (FC / 8);
          const int c = (item % (FC / 8)) * 8;
          *reinterpret_cast<uint4*>(sWo + r * LDO + c * 2) =
              *reinterpret_cast<const uint4*>(wo + (long long)r * F + f0 + c);
        }
      }
      __syncthreads();
      // ---- 3. acc += g . Wo_chunk^T over this warp's DM/4 output columns
      if (QO) {
#pragma unroll
        for (int ks = 0; ks < FC / 32; ++ks) {
          uint32_t af[4];
          const unsigned char* gp = sG + (ar + g) * LDG + ks * 32 + t * 4;
          af[0] = lds32(gp);
          af[1] = lds32(gp + 8 * LDG);
          af[2] = lds32(gp + 16);
          af[3] = lds32(gp + 8 * LDG + 16);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const unsigned char* wp = sWo + (cg * (DM / 4) + nt * 8 + g) * LDO + ks * 32 + t * 4;
            mma_s8(acci[nt], af, lds32(wp), lds32(wp + 16));
          }
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < FC / 16; ++ks) {
          uint32_t af[4];
          const unsigned char* gp = sG + (ar + g) * LDG + (ks * 16 + t * 2) * 2;
          af[0] = lds32(gp);
          af[1] = lds32(gp + 8 * LDG);
          af[2] = lds32(gp + 16);
          af[3] = lds32(gp + 8 * LDG + 16);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const unsigned char* wp = sWo + (cg * (DM / 4) + nt * 8 + g) * LDO + (ks * 16 + t * 2) * 2;
            mma_bf16(accf[nt], af, lds32(wp), lds32(wp + 16));
          }
        }
      }
    }
  }

  // ---- epilogue: out = x + bf16(o), rounded to bf16; o = acc, or float(acc) * sg * swo[column]
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + ar + g + hr * 8;
    if (row >= R) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = cg * (DM / 4) + nt * 8 + t * 2;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (long long)row * DM + c));
      float o0, o1;
      if (QO) {
        o0 = bf16_round((float)acci[nt][2 * hr] * sg[hr] * swo[c]);
        o1 = bf16_round((float)acci[nt][2 * hr + 1] * sg[hr] * swo[c + 1]);
      } else {
        o0 = bf16_round(accf[nt][2 * hr]);
        o1 = bf16_round(accf[nt][2 * hr + 1]);
      }
      *reinterpret_cast<uint32_t*>(out + (long long)row * DM + c) = pack_bf16(xv.x + o0, xv.y + o1);
    }
  }
}

template <int DM, bool QI, bool QO>
int launch_q(const void* x, const void* scale, const void* bias, const void* wi, const void* swi,
             const void* wo, const void* swo, void* out, void* codes_y, void* codes_g, int R, int F,
             float eps, void* stream) {
  constexpr int bytes = smem_bytes_q<DM, QI, QO>();
  cudaError_t err = cudaFuncSetAttribute(fused_ln_ffn_q_kernel<DM, QI, QO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BR - 1) / BR;
  fused_ln_ffn_q_kernel<DM, QI, QO><<<blocks, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, wi, (const float*)swi, wo,
      (const float*)swo, (__nv_bfloat16*)out, (int8_t*)codes_y, (int8_t*)codes_g, R, F, eps);
  return (int)cudaGetLastError();
}

template <int DM>
int dispatch_q(const void* x, const void* scale, const void* bias, const void* wi, const void* swi,
               const void* wo, const void* swo, void* out, void* codes_y, void* codes_g, int R, int F,
               float eps, int w8a8, int w8a8_wo, void* stream) {
  if (w8a8 && w8a8_wo)
    return launch_q<DM, true, true>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, stream);
  if (w8a8)
    return launch_q<DM, true, false>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, stream);
  return launch_q<DM, false, true>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, stream);
}

}  // namespace

// x, out: (R, DM) bf16; scale, bias: (DM,) fp32 (bias may be null);
// wi: (2F, DM) bf16 (nn.Linear layout of Wi); wo: (DM, F) bf16.
extern "C" int cm3p_fused_ln_ffn(const void* x, const void* scale, const void* bias,
                                 const void* wi, const void* wo, void* out, int R, int DM, int F,
                                 float eps, void* stream) {
  if (R <= 0 || F <= 0 || F % FC != 0) return (int)cudaErrorInvalidValue;
  if (DM == 768) return launch<768>(x, scale, bias, wi, wo, out, R, F, eps, stream);
  if (DM == 512) return launch<512>(x, scale, bias, wi, wo, out, R, F, eps, stream);
  if (DM == 256) return launch<256>(x, scale, bias, wi, wo, out, R, F, eps, stream);
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
  if (R <= 0 || F <= 0 || F % FC != 0 || !(w8a8 || w8a8_wo)) return (int)cudaErrorInvalidValue;
  if ((w8a8 && swi == nullptr) || (w8a8_wo && swo == nullptr)) return (int)cudaErrorInvalidValue;
  if (DM == 768)
    return dispatch_q<768>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  if (DM == 512)
    return dispatch_q<512>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  if (DM == 256)
    return dispatch_q<256>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  return (int)cudaErrorInvalidValue;
}
