// Fused LayerNorm + GeGLU half-block for Hopper, bf16 in and out:
//     out = x + Wo( gelu_erf(a) * b ),   [a | b] = Wi( LN_fp32(x) )
//
// Replaces the TPU kernel of the JAX package's ops/fused_ffn.py _ffn_kernel (driven by
// _pallas_ln_ffn) in its bf16 form (no int8 Wi / Wo), at the three tower widths
// DM = 768 (beatmap), 512 (audio) and 256 (metadata). The training path does
// not run it: under autograd the layer runs the plain composition and its
// analytic backward (ops/fused_ffn.py), as the JAX package does.
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

namespace {

constexpr int BR = 32;          // rows per block
constexpr int NTHREADS = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int FC = 64;          // F chunk (columns of a; the same of b)
constexpr int KS = 64;          // DM slice staged per step of the Wi product
constexpr int LDW = 64 + 8;     // padded smem row of a staged weight slice

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
