// Row-tile pieces of the fp32 kernels (csrc/fused_ffn_f32.cu,
// csrc/fused_ln_matmul_f32.cu): a block of 256 threads owns a tile of RT = 16
// rows, normalises them into shared memory and multiplies them by a weight in
// 128-column tiles on the CUDA cores (fp32 FMA, or dp4a on int8 codes with
// exact int32 sums). No TF32: the plain fp32 versions multiply at "highest"
// precision.
//
// * ln_row: the flax LayerNorm of one fp32 row by one warp (var = max(E[x^2]
//   - E[x]^2, 0), y = (x - mu) * (rsqrt(var + eps) * scale) + bias), the
//   plain version's layer_norm_f32; without scale the row is copied.
// * quant_row: the per-row symmetric int8 quantiser of _quant_rows_int8 (sa
//   = max(amax, 1e-30) * (1 / 127), code = clip(rint(y / sa), +-127), a true
//   division; ln_rows.cuh's quant_code), as the plain quant_rows_int8.
// * tile_product: acc (rows 2 w, 2 w + 1 of warp w; columns 4 lane .. + 3)
//   of the 16 x 128 tile A . W^T, where A is RT rows of K words in shared
//   memory and W two groups of 64 rows in device memory (row-major, K words
//   a row), staged through shared memory 32 words of K at a time, transposed
//   so that a lane reads its 4 columns as one float4, the next slice's loads
//   in flight while the block multiplies the current one.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_rows.cuh"

namespace cm3p {
namespace f32rows {

constexpr int RT = 16;        // rows of a block's tile
constexpr int NT = 128;       // output columns of a product tile
constexpr int KW = 32;        // words of K per staged weight slice (32 fp32 values or 128 int8 codes)
constexpr int THREADS = 256;  // 8 warps
constexpr int LDW = NT + 4;   // words between the K rows of a staged slice
constexpr int STAGE_WORDS = KW * LDW;

// Row r (< n rows) of x (D fp32 values a row) into y, normalised when scale is given; zeros past n.
__device__ __forceinline__ void ln_row(float* y, const float* __restrict__ x, long long r, long long n, int D,
                                       const float* __restrict__ scale, const float* __restrict__ bias, float eps,
                                       int lane) {
  if (r >= n) {
    for (int c = 4 * lane; c < D; c += 128) *reinterpret_cast<float4*>(y + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float* xr = x + r * D;
  float4 v[6];  // D <= 768
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c >= D) break;
    v[i] = *reinterpret_cast<const float4*>(xr + c);
    s1 += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    s2 += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
  }
  float mu = 0.f, rstd = 1.f;
  if (scale != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    mu = s1 / D;
    rstd = rsqrtf(fmaxf(s2 / D - mu * mu, 0.f) + eps);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c >= D) break;
    float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    if (scale != nullptr)
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = (e[j] - mu) * (rstd * scale[c + j]) + (bias ? bias[c + j] : 0.f);
    *reinterpret_cast<float4*>(y + c) = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// Quantises the n fp32 values of y (one row, by one warp) into int8 codes q (and codes_out when not null);
// returns the row scale sa.
__device__ __forceinline__ float quant_row(const float* y, int n, int8_t* q, int8_t* codes_out, int lane) {
  float amax = 0.f;
  for (int c = lane; c < n; c += 32) amax = fmaxf(amax, fabsf(y[c]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float sa = fmaxf(amax, 1e-30f) * kInv127;
  for (int c = lane; c < n; c += 32) {
    const int8_t code = (int8_t)quant_code(y[c], sa);
    q[c] = code;
    if (codes_out != nullptr) codes_out[c] = code;
  }
  return sa;
}

// acc += A . W^T for one 16 x 128 tile (see the note at the top): A (RT x kwords words, row stride lda
// words, 16-byte aligned rows) in shared memory; tile columns 0 .. 63 are rows w0 .. w0 + 63 of W and
// columns 64 .. 127 rows w1 .. w1 + 63 (row-major, kwords words a row, a multiple of 4); stage is
// STAGE_WORDS of shared memory. Every thread of the block calls it. Each thread loads its part of the next
// slice into registers while the block multiplies the current one, so the L2 reads overlap the products.
template <bool INT8, typename Acc>
__device__ __forceinline__ void tile_product(Acc (&acc)[2][4], const uint32_t* A, int lda,
                                             const uint32_t* __restrict__ W, long long w0, long long w1,
                                             int kwords, uint32_t* stage) {
  constexpr int PER_THREAD = NT * (KW / 4) / THREADS;  // 16-byte pieces of a slice per thread
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4 next[PER_THREAD];
  auto fetch = [&](int kw0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int item = threadIdx.x + j * THREADS, n = item >> 3, c = (item & 7) * 4;
      const long long row = n < 64 ? w0 + n : w1 + (n - 64);
      next[j] = c < kwords - kw0 ? *reinterpret_cast<const uint4*>(W + row * kwords + kw0 + c)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(0);
  for (int kw0 = 0; kw0 < kwords; kw0 += KW) {
    const int kn = min(KW, kwords - kw0);
    __syncthreads();  // the previous slice is read
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int item = threadIdx.x + j * THREADS, n = item >> 3, c = (item & 7) * 4;
      stage[(c + 0) * LDW + n] = next[j].x;
      stage[(c + 1) * LDW + n] = next[j].y;
      stage[(c + 2) * LDW + n] = next[j].z;
      stage[(c + 3) * LDW + n] = next[j].w;
    }
    __syncthreads();
    if (kw0 + KW < kwords) fetch(kw0 + KW);
#pragma unroll 8
    for (int k = 0; k < kn; k += 4) {
      uint4 a[2], w[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) a[r] = *reinterpret_cast<const uint4*>(A + (2 * warp + r) * lda + kw0 + k);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const uint4*>(stage + (k + e) * LDW + 4 * lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t av[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t wv[4] = {w[e].x, w[e].y, w[e].z, w[e].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (INT8)
              acc[r][j] = __dp4a((int)av[e], (int)wv[j], acc[r][j]);
            else
              acc[r][j] = fmaf(__uint_as_float(av[e]), __uint_as_float(wv[j]), acc[r][j]);
          }
        }
      }
    }
  }
}

}  // namespace f32rows
}  // namespace cm3p
