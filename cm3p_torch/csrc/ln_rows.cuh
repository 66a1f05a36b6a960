// Row front ends shared by the fused LN kernels: one warp owns one row of DM
// bf16 values, lane l holding columns i * 64 + 2 * l + {0, 1} for i < DM / 64.
//
// * ln_row_f32: the flax LayerNorm in fp32 (var = max(E[x^2] - E[x]^2, 0)),
//   as _ln_f32 of the JAX package's ops/fused_ffn.py; ln_moments alone gives
//   a row's mean and 1 / std (the bf16 LN-matmul normalises in shared memory).
// * quant_row_int8_each (hands each code pair to a callback): the per-row symmetric int8 quantiser of _quant_rows_int8:
//   sa = max(amax, 1e-30) * (1 / 127), code = clip(rint(y / sa), +-127), with a
//   true division and round-half-even so that the plain PyTorch version
//   gives the same codes. Do not build with -use_fast_math.
// * quant_row_int8_x8: the same quantiser, the same codes, for a lane that
//   holds 8 consecutive columns of each 256-column chunk (the int8
//   LN-matmul's layout, which reads x 16 bytes and writes codes 8 bytes at a
//   time), without a division per value: a multiply by 1 / sa and a
//   1.5 x 2^23 add, with the true division on a warp-wide branch for a row
//   that has a value within 1e-4 of a half. It is the faster of the two on
//   the H100; the 2-column users (the int8 FFN front end, the int8 Wo
//   epilogue) keep quant_row_int8_each until they move to that layout. The
//   int8 LN-matmul applies the flax LayerNorm in its own layout too (the
//   arithmetic of ln_row_f32, scale and bias from shared memory).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cm3p {

constexpr float kInv127 = 0.007874015748031496f;  // float32(1.0 / 127.0)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// int8 x int8 -> int32, 16 x 8 x 32. Each A/B register holds four consecutive k.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Mean and 1 / sqrt(var + eps) of the row held in y (flax formula); every
// lane gets both.
template <int DM>
__device__ __forceinline__ void ln_moments(const float2 (&y)[DM / 64], float eps, float& mu, float& rstd) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < DM / 64; ++i) {
    s1 += y[i].x + y[i].y;
    s2 += y[i].x * y[i].x + y[i].y * y[i].y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffff, s1, off);
    s2 += __shfl_xor_sync(0xffffffff, s2, off);
  }
  mu = s1 / DM;
  const float var = fmaxf(s2 / DM - mu * mu, 0.f);
  rstd = rsqrtf(var + eps);
}

// Loads row xr into y as fp32; with scale != nullptr applies the LayerNorm.
template <int DM>
__device__ __forceinline__ void ln_row_f32(const __nv_bfloat16* __restrict__ xr,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, float eps, int lane,
                                           float2 (&y)[DM / 64]) {
#pragma unroll
  for (int i = 0; i < DM / 64; ++i)
    y[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i * 64 + lane * 2));
  if (scale == nullptr) return;
  float mu, rstd;
  ln_moments<DM>(y, eps, mu, rstd);
#pragma unroll
  for (int i = 0; i < DM / 64; ++i) {
    const int c = i * 64 + lane * 2;
    const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
    y[i].x = (y[i].x - mu) * (rstd * scale[c]) + b0;
    y[i].y = (y[i].y - mu) * (rstd * scale[c + 1]) + b1;
  }
}

__device__ __forceinline__ int quant_code(float v, float sa) {
  return max(-127, min(127, __float2int_rn(v / sa)));
}

// Quantises the row in y to int8 codes, handing each pair of codes to
// put(column, char2) (columns c, c + 1 with c even); returns the row scale sa.
template <int DM, typename Put>
__device__ __forceinline__ float quant_row_int8_each(const float2 (&y)[DM / 64], int lane, Put put) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < DM / 64; ++i) amax = fmaxf(amax, fmaxf(fabsf(y[i].x), fabsf(y[i].y)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, off));
  const float sa = fmaxf(amax, 1e-30f) * kInv127;
#pragma unroll
  for (int i = 0; i < DM / 64; ++i) {
    char2 q;
    q.x = (signed char)quant_code(y[i].x, sa);
    q.y = (signed char)quant_code(y[i].y, sa);
    put(i * 64 + lane * 2, q);
  }
  return sa;
}

// The row in y (y[i][j] is column 256 i + 8 lane + j) as int8 codes, 8 to a uint2 per chunk (code[i]);
// returns the row scale sa. y * (1 / sa) is within 3e-5 of the correctly rounded y / sa (|y / sa| <=
// 127.00002), so its nearest integer is the code unless it lies that close to a half. Adding 1.5 * 2^23
// rounds q to the nearest integer, half to even, and leaves in the sum's low byte that of the two's
// complement code (no conversion instruction). Where a value of the row lies within 1e-4 of a half
// (rarely), the true division decides every code of the row, on a branch the whole warp takes.
template <int NC>
__device__ __forceinline__ float quant_row_int8_x8(const float (&y)[NC][8], uint2 (&code)[NC]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(y[i][j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, off));
  const float sa = fmaxf(amax, 1e-30f) * kInv127, inv = 1.f / sa;
  bool near_half = false;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = y[i][j] * inv, big = q + 12582912.f;
      near_half |= fabsf(q - (big - 12582912.f)) >= 0.4999f;
      w[j >> 2] |= (__float_as_uint(big) & 0xff) << (8 * (j & 3));
    }
    code[i] = make_uint2(w[0], w[1]);
  }
  if (__any_sync(0xffffffff, near_half)) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j >> 2] |= (uint32_t)(quant_code(y[i][j], sa) & 0xff) << (8 * (j & 3));
      code[i] = make_uint2(w[0], w[1]);
    }
  }
  return sa;
}

}  // namespace cm3p
