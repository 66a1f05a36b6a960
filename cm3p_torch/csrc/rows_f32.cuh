// Row-tile pieces of the fp32 kernels (csrc/fused_ffn_f32.cu,
// csrc/fused_ln_matmul_f32.cu), on the CUDA cores (fp32 FMA, or dp4a on int8
// codes with exact int32 sums). No TF32: the plain fp32 versions multiply at
// "highest" precision.
//
// * ln_row: the flax LayerNorm of one fp32 row by one warp (var = max(E[x^2]
//   - E[x]^2, 0), y = (x - mu) * (rsqrt(var + eps) * scale) + bias), the
//   plain version's layer_norm_f32; without scale the row is copied.
//   ln_moments gives the same mu and rstd (the same sums and shuffle tree)
//   without writing the row.
// * quant_row: the per-row symmetric int8 quantiser of _quant_rows_int8 (sa
//   = max(amax, 1e-30) * (1 / 127), code = clip(rint(y / sa), +-127), a true
//   division; ln_rows.cuh's quant_code), as the plain quantiser.
// * tile_product: a block of 256 threads owns a tile of RT = 16 rows, kept
//   (normalised) in shared memory; acc (rows 2 w, 2 w + 1 of warp w; columns
//   4 lane .. + 3) of the 16 x 128 tile A . W^T, where W is two groups of 64
//   rows in device memory (row-major, K words a row), staged through shared
//   memory 32 words of K at a time, transposed so that a lane reads its 4
//   columns as one float4, the next slice's loads in flight while the block
//   multiplies the current one. Each lane issues six 16-byte shared-memory
//   loads for 32 FMAs, and every 16-row tile reads all of W again, so the
//   shared-memory loads set its pace (the int8 forms and the FFN use it).
// * row_tile_product (namespace f32tile): the register-tiled fp32 product of
//   the fp32-weight forms. A block of 256 threads owns 128 rows and walks
//   over N in 128 x 128 output tiles, each thread holding 8 x 8 sums (rows 4
//   ty .. + 3 and 64 + 4 ty .. + 3, columns 4 tx .. + 3 and 64 + 4 tx .. + 3
//   of the tile; a warp takes 4 x 8 of the 16 x 16 (ty, tx) grid). A and W
//   are staged in slices of 16 of K through two shared-memory buffers, both
//   K-major (a slice row holds one k of 128 rows, padded against bank
//   conflicts), W transposed as it is staged and A through the caller's
//   loader and staging map (which may normalise it as it is staged, a slice
//   after its load, so that the load's latency stalls nothing); the next
//   slice's global loads are in flight while the block multiplies the
//   current one, across column tiles too. Per k each thread makes four
//   16-byte loads for 64 FMAs, and W is read from L2 once per 128 rows.
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

// Lane lane's float4s of one fp32 row of D values (D <= 768): columns 4 lane + 128 i .. + 3.
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int D, int lane, float4 (&v)[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c >= D) break;
    v[i] = *reinterpret_cast<const float4*>(xr + c);
  }
}

// mu and rstd of one fp32 row by one warp (the flax formula; every lane gets them), and the lane's float4s of
// the row in v.
__device__ __forceinline__ void ln_moments(const float* __restrict__ xr, int D, float eps, int lane, float4 (&v)[6],
                                           float& mu, float& rstd) {
  load_row(xr, D, lane, v);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (4 * lane + 128 * i >= D) break;
    s1 += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    s2 += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  mu = s1 / D;
  rstd = rsqrtf(fmaxf(s2 / D - mu * mu, 0.f) + eps);
}

// Row r (< n rows) of x (D fp32 values a row) into y, normalised when scale is given; zeros past n.
__device__ __forceinline__ void ln_row(float* y, const float* __restrict__ x, long long r, long long n, int D,
                                       const float* __restrict__ scale, const float* __restrict__ bias, float eps,
                                       int lane) {
  if (r >= n) {
    for (int c = 4 * lane; c < D; c += 128) *reinterpret_cast<float4*>(y + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float4 v[6];  // D <= 768
  float mu = 0.f, rstd = 1.f;
  if (scale != nullptr)
    ln_moments(x + r * D, D, eps, lane, v, mu, rstd);
  else
    load_row(x + r * D, D, lane, v);
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

namespace f32tile {

constexpr int MT = 128;       // rows of a block's tile
constexpr int RI = MT / 16;   // rows of a thread's sums
constexpr int NT = 128;       // output columns of a product tile
constexpr int KS = 16;        // values of K per staged slice
constexpr int THREADS = 256;  // a 16 x 16 grid of threads, RI x 8 sums each
constexpr int LDA = MT + 4;   // floats between the K rows of a staged A slice (16-byte aligned, few bank conflicts)
constexpr int LDW = NT + 4;   // the same for a W slice
constexpr int SLICE_FLOATS = KS * (LDA + LDW);  // the A and W slices of one buffer
constexpr int SMEM_FLOATS = 2 * SLICE_FLOATS;

// This thread's place (ty, tx) in the 16 x 16 grid: a warp takes 4 x 8 of it (warp w: ty 4 (w / 2) .. + 3, tx
// 8 (w % 2) .. + 7), so that a k step's 16-byte shared-memory loads of a warp read 4 and 8 distinct float4s.
__device__ __forceinline__ int grid_ty() { return 4 * (threadIdx.x >> 6) + ((threadIdx.x >> 3) & 3); }
__device__ __forceinline__ int grid_tx() { return 8 * ((threadIdx.x >> 5) & 1) + (threadIdx.x & 7); }
// The tile row of this thread's sums i (0 .. RI - 1) and the tile column of its sums j (0 .. 7).
__device__ __forceinline__ int sum_row(int i) { return 4 * grid_ty() + (i & 3) + 64 * (i >> 2); }
__device__ __forceinline__ int sum_col(int j) { return 4 * grid_tx() + (j & 3) + 64 * (j >> 2); }

// For each 128-column tile n0 = 0, 128, .. < N: acc = A . W^T over K for the block's MT rows, then
// epilogue(n0, acc) (acc[i][j] at tile row sum_row(i), column n0 + sum_col(j)). load_a(row, k) returns A's
// values k .. k + 3 of tile row `row` as a float4 (zeros past the caller's rows); stage_a(row, k, v) maps them
// to what is staged (a LayerNorm, say) when the slice is written to shared memory, a slice after their loads, so
// that no load's latency stalls the products. W is (N, K) row-major fp32 in device memory, N a multiple of 128
// and K of KS. smem: SMEM_FLOATS of shared memory. Every thread of the block calls it.
template <typename LoadA, typename StageA, typename Epilogue>
__device__ __forceinline__ void row_tile_product(LoadA load_a, StageA stage_a, const float* __restrict__ W, int N,
                                                 int K, float* smem, Epilogue epilogue) {
  constexpr int ROW_LOADS = KS / 4, STEP = THREADS / ROW_LOADS;  // float4s of a slice row; rows a pass loads
  constexpr int LOADS_A = MT / STEP, LOADS_W = NT / STEP;        // float4 loads of a thread per slice
  static_assert(LOADS_A * STEP == MT && LOADS_W * STEP == NT && RI % 4 == 0, "whole loads, spread evenly");
  const int ty = grid_ty(), tx = grid_tx();
  // this thread's loads: slice rows lr + h STEP, values lk .. lk + 3 of K
  const int lr = threadIdx.x / ROW_LOADS, lk = 4 * (threadIdx.x % ROW_LOADS);
  const int nk = K / KS, steps = (N / NT) * nk;
  float4 ra[LOADS_A], rw[LOADS_W];
  auto fetch = [&](int t) {
    const int n0 = (t / nk) * NT, k0 = (t % nk) * KS;
#pragma unroll
    for (int h = 0; h < LOADS_A; ++h) ra[h] = load_a(lr + h * STEP, k0 + lk);
#pragma unroll
    for (int h = 0; h < LOADS_W; ++h)
      rw[h] = __ldg(reinterpret_cast<const float4*>(W + (long long)(n0 + lr + h * STEP) * K + k0 + lk));
  };
  auto stash = [&](int t) {  // the fetched slice t, K-major, into buffer t % 2
    float* a = smem + (t & 1) * SLICE_FLOATS;
    float* w = a + KS * LDA;
    const int k = (t % nk) * KS + lk;
#pragma unroll
    for (int h = 0; h < LOADS_A; ++h) {
      const int m = lr + h * STEP;
      const float4 v = stage_a(m, k, ra[h]);
      a[(lk + 0) * LDA + m] = v.x, a[(lk + 1) * LDA + m] = v.y;
      a[(lk + 2) * LDA + m] = v.z, a[(lk + 3) * LDA + m] = v.w;
    }
#pragma unroll
    for (int h = 0; h < LOADS_W; ++h) {
      const int m = lr + h * STEP;
      w[(lk + 0) * LDW + m] = rw[h].x, w[(lk + 1) * LDW + m] = rw[h].y;
      w[(lk + 2) * LDW + m] = rw[h].z, w[(lk + 3) * LDW + m] = rw[h].w;
    }
  };
  fetch(0);
  stash(0);
  __syncthreads();
  float acc[RI][8];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) fetch(t + 1);  // in flight during this slice's products
    const float* a = smem + (t & 1) * SLICE_FLOATS;
    const float* w = a + KS * LDA;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      float av[RI], wv[8];
#pragma unroll
      for (int q = 0; q < RI / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(a + k * LDA + 64 * q + 4 * ty);
        av[4 * q] = v.x, av[4 * q + 1] = v.y, av[4 * q + 2] = v.z, av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(w + k * LDW + 64 * q + 4 * tx);
        wv[4 * q] = v.x, wv[4 * q + 1] = v.y, wv[4 * q + 2] = v.z, wv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    if ((t + 1) % nk == 0) {
      epilogue((t / nk) * NT, acc);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (t + 1 < steps) stash(t + 1);  // the other buffer: its last readers passed the barrier below
    __syncthreads();
  }
}

}  // namespace f32tile
}  // namespace cm3p
