// Row-tile pieces of the fp32 kernels (csrc/fused_ffn_f32.cu,
// csrc/fused_ln_matmul_f32.cu): fp32 products on the CUDA cores (fp32 FMA; no
// TF32: the plain fp32 versions multiply at "highest" precision) and int8
// products on the tensor cores (mma.sync, exact int32 sums).
//
// * ln_moments / row_moments (namespace f32rows): the mean and rstd of one
//   fp32 row held by one warp as float4s (lane l: columns 4 l + 128 i .. + 3),
//   by the flax formula (var = max(E[x^2] - E[x]^2, 0), rstd = rsqrt(var +
//   eps)); the LN value of a column is then (x - mu) * (rstd * scale) + bias.
// * quant_code_fast / quant4: the per-row symmetric int8 quantiser of
//   _quant_rows_int8 (sa = max(amax, 1e-30) * (1 / 127), code = clip(rint(y
//   / sa), +-127)): the codes of ln_rows.cuh's quant_code (a true division,
//   half to even), from a multiply by 1 / sa, with the true division where
//   the product lies near a half.
// * row_tile_product (namespace f32tile): the register-tiled fp32 product. A
//   block of 256 threads owns 128 rows and walks over column tiles of 128,
//   each thread holding 8 x 8 sums (rows 4 ty .. + 3 and 64 + 4 ty .. + 3,
//   tile columns 4 tx .. + 3 and 64 + 4 tx .. + 3; a warp takes 4 x 8 of the
//   16 x 16 (ty, tx) grid). A and W are staged in slices of 16 of K through
//   two shared-memory buffers, both K-major (a slice row holds one k of 128
//   rows, padded against bank conflicts), W transposed as it is staged and A
//   through the caller's loader and staging map (which may normalise it as it
//   is staged, a slice after its load, so that the load's latency stalls
//   nothing); the next slice's global loads are in flight while the block
//   multiplies the current one, across column tiles too. Per k each thread
//   makes four 16-byte loads for 64 FMAs, and W is read from L2 once per 128
//   rows. The caller maps a tile column to its row of W (the FFN's Wi tile is
//   [64 a | 64 b], so a thread's sums j and j + 4 are a GeGLU pair).
// * row_tile_product_s8 (namespace f32tile): the int8 product on the tensor
//   cores. A block of 256 threads owns 128 rows and walks over column tiles
//   of 128 with int32 sums, warp w taking rows 32 (w / 2) .. + 31 and 64 of
//   the tile's columns as 2 x 8 tiles of mma.sync.m16n8k32 (s8). W streams
//   through NSTAGE shared-memory stages of 64 bytes of K by 16-byte cp.async
//   (.cg), the next stages' copies in flight while the block multiplies the
//   current one; A is either resident (the caller's 128 x K code tile in
//   shared memory, 16-byte chunks swizzled against bank conflicts) or streamed
//   beside W from device memory. Fragments come by ldmatrix. The tile's
//   columns are placed so that a thread's four consecutive sums form a float4
//   of the output and its sums p and p + 2 lie 64 columns apart (the GeGLU
//   pair again): s8_row / s8_col / s8_quad below.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_rows.cuh"

namespace cm3p {
namespace f32rows {

// Lane lane's float4s of one fp32 row of D values (D <= 768): columns 4 lane + 128 i .. + 3.
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int D, int lane, float4 (&v)[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c >= D) break;
    v[i] = *reinterpret_cast<const float4*>(xr + c);
  }
}

// mu and rstd of the row whose float4s the warp holds in v (load_row's layout; the flax formula; every lane gets
// them).
__device__ __forceinline__ void row_moments(const float4 (&v)[6], int D, float eps, int lane, float& mu,
                                            float& rstd) {
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

// mu and rstd of one fp32 row by one warp, and the lane's float4s of the row in v.
__device__ __forceinline__ void ln_moments(const float* __restrict__ xr, int D, float eps, int lane, float4 (&v)[6],
                                           float& mu, float& rstd) {
  load_row(xr, D, lane, v);
  row_moments(v, D, eps, lane, mu, rstd);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// quant_code(v, sa) from inv = 1 / sa: v * inv lies within 3e-5 of the correctly rounded v / sa (|v / sa| <=
// 127.00002), so the two round to the same integer unless v * inv lies within 1e-4 of a half, where the true
// division decides (rarely).
__device__ __forceinline__ int quant_code_fast(float v, float sa, float inv) {
  const float q = v * inv, r = rintf(q);
  if (fabsf(q - r) >= 0.4999f) return quant_code(v, sa);
  return max(-127, min(127, __float2int_rn(r)));
}

// The four codes of v at row scale sa as one word (v.x's code in the low byte: char4 order in memory).
__device__ __forceinline__ uint32_t quant4(float4 v, float sa, float inv) {
  return (uint32_t)(quant_code_fast(v.x, sa, inv) & 0xff) | ((uint32_t)(quant_code_fast(v.y, sa, inv) & 0xff) << 8) |
         ((uint32_t)(quant_code_fast(v.z, sa, inv) & 0xff) << 16) |
         ((uint32_t)(quant_code_fast(v.w, sa, inv) & 0xff) << 24);
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

// For each column tile t = 0 .. tiles - 1: acc = A . W^T over K for the block's MT rows, then epilogue(t, acc)
// (acc[i][j] at tile row sum_row(i), tile column sum_col(j)). Tile column c of tile t is row w_row(t, c) of W
// ((N, K) row-major fp32 in device memory, K a multiple of KS). load_a(row, k) returns A's values k .. k + 3 of
// tile row `row` as a float4 (zeros past the caller's rows); stage_a(row, k, v) maps them to what is staged (a
// LayerNorm, say) when the slice is written to shared memory, a slice after their loads, so that no load's latency
// stalls the products. smem: SMEM_FLOATS of shared memory. Every thread of the block calls it; it returns past a
// barrier, with every epilogue's stores made and shared memory free.
template <typename LoadA, typename StageA, typename WRow, typename Epilogue>
__device__ __forceinline__ void row_tile_product(LoadA load_a, StageA stage_a, const float* __restrict__ W,
                                                 WRow w_row, int tiles, int K, float* smem, Epilogue epilogue) {
  constexpr int ROW_LOADS = KS / 4, STEP = THREADS / ROW_LOADS;  // float4s of a slice row; rows a pass loads
  constexpr int LOADS_A = MT / STEP, LOADS_W = NT / STEP;        // float4 loads of a thread per slice
  static_assert(LOADS_A * STEP == MT && LOADS_W * STEP == NT && RI % 4 == 0, "whole loads, spread evenly");
  const int ty = grid_ty(), tx = grid_tx();
  // this thread's loads: slice rows lr + h STEP, values lk .. lk + 3 of K
  const int lr = threadIdx.x / ROW_LOADS, lk = 4 * (threadIdx.x % ROW_LOADS);
  const int nk = K / KS, steps = tiles * nk;
  float4 ra[LOADS_A], rw[LOADS_W];
  auto fetch = [&](int t) {
    const int tile = t / nk, k0 = (t % nk) * KS;
#pragma unroll
    for (int h = 0; h < LOADS_A; ++h) ra[h] = load_a(lr + h * STEP, k0 + lk);
#pragma unroll
    for (int h = 0; h < LOADS_W; ++h)
      rw[h] = __ldg(reinterpret_cast<const float4*>(W + w_row(tile, lr + h * STEP) * K + k0 + lk));
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
      epilogue(t / nk, acc);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (t + 1 < steps) stash(t + 1);  // the other buffer: its last readers passed the barrier below
    __syncthreads();
  }
}

// ---- the int8 product (row_tile_product_s8)

constexpr int KB = 64;              // bytes of K per stage
constexpr int S8_STAGE = MT * KB;   // bytes of one operand's stage: 128 rows of 64 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a stage (64-byte rows): chunk c ^ ((r / 2) % 4), so that the 8 rows
// an ldmatrix phase reads fall into 8 distinct bank groups.
__device__ __forceinline__ int stage_off(int r, int c) { return r * KB + ((c ^ ((r >> 1) & 3)) << 4); }
// Byte offset of byte b of row r in a resident code tile of K-byte rows (K a multiple of 128): 16-byte chunk
// b / 16 at chunk (b / 16) ^ (r % 8).
__device__ __forceinline__ int resident_off(int r, int b, int K) {
  return r * K + ((((b >> 4) ^ r) & 7) | ((b >> 4) & ~7)) * 16 + (b & 15);
}

// The tile column of the W row staged at stage row s (0 .. 127): warp column half wn = s / 64 reads stage rows
// 64 wn + 8 ni + x as mma tile ni's column x (0 .. 7), and that column holds tile column
// 64 (ni / 4) + 32 wn + 16 ((ni / 2) % 2) + 4 (x / 2) + 2 (ni % 2) + x % 2.
__device__ __forceinline__ int s8_stage_col(int s) {
  const int wn = s >> 6, ni = (s >> 3) & 7, x = s & 7;
  return 64 * (ni >> 2) + 32 * wn + 16 * ((ni >> 1) & 1) + 4 * (x >> 1) + 2 * (ni & 1) + (x & 1);
}
// A thread's sums: acc[mi][ni][e] (mi 0 .. 1, ni 0 .. 7, e 0 .. 3), read in quads: s8_quad(acc, mi, h, p) (h 0 .. 1,
// p 0 .. 3) holds the four sums at tile row s8_row(mi, h), tile columns s8_col(p) .. + 3; s8_col(p + 2) =
// s8_col(p) + 64.
__device__ __forceinline__ int s8_row(int mi, int h) {
  return 32 * (threadIdx.x >> 6) + 16 * mi + 8 * h + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int s8_col(int p) {
  return 64 * (p >> 1) + 32 * ((threadIdx.x >> 5) & 1) + 16 * (p & 1) + 4 * (threadIdx.x & 3);
}
__device__ __forceinline__ int4 s8_quad(const int (&acc)[2][8][4], int mi, int h, int p) {
  return make_int4(acc[mi][2 * p][2 * h], acc[mi][2 * p][2 * h + 1], acc[mi][2 * p + 1][2 * h],
                   acc[mi][2 * p + 1][2 * h + 1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// For each column tile t = 0 .. tiles - 1: acc = A . W^T over K (exact int32 sums) for the block's MT rows, then
// epilogue(t, acc) (the map above). Tile column c of tile t is row w_row(t, c) of W ((N, K) row-major int8 codes
// in device memory). A: with A_RESIDENT the caller's MT x K code tile in shared memory (resident_off's layout, K a
// multiple of 128), else MT x K codes row-major in device memory (K a multiple of KB), streamed beside W. smem:
// NSTAGE stages of S8_STAGE bytes (2 S8_STAGE when A streams), 16-byte aligned. Every thread of the block calls
// it; it returns past a barrier, with every epilogue's stores made and the stages free.
template <int NSTAGE, bool A_RESIDENT, typename WRow, typename Epilogue>
__device__ __forceinline__ void row_tile_product_s8(const int8_t* A, int K, const int8_t* __restrict__ W, WRow w_row,
                                                    int tiles, int8_t* smem, Epilogue epilogue) {
  static_assert(NSTAGE >= 2, "a stage in flight while one is multiplied");
  constexpr int STAGE = (A_RESIDENT ? 1 : 2) * S8_STAGE;  // W, then A when it streams
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int nk = K / KB, steps = tiles * nk;
  // this thread's copies: stage rows lrow and lrow + 64, chunk lch
  const int lrow = threadIdx.x >> 2, lch = threadIdx.x & 3;
  const int wcol0 = s8_stage_col(lrow), wcol1 = s8_stage_col(lrow + 64);
  auto issue = [&](int s) {  // step s's copies into its stage; a group is committed whether or not it copies
    if (s < steps) {
      const int tile = s / nk, k0 = (s % nk) * KB + 16 * lch;
      int8_t* st = smem + (s % NSTAGE) * STAGE;
      cp_async16(st + stage_off(lrow, lch), W + w_row(tile, wcol0) * K + k0);
      cp_async16(st + stage_off(lrow + 64, lch), W + w_row(tile, wcol1) * K + k0);
      if (!A_RESIDENT) {
        cp_async16(st + S8_STAGE + stage_off(lrow, lch), A + (long long)lrow * K + k0);
        cp_async16(st + S8_STAGE + stage_off(lrow + 64, lch), A + (long long)(lrow + 64) * K + k0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue(s);
  // ldmatrix rows of this lane: A rows 32 wm + 16 mi + a_row, B stage rows 64 wn + 16 q + b_row
  const int a_row = 8 * ((lane >> 3) & 1) + (lane & 7), a_ch = lane >> 4;
  const int b_row = 8 * (lane >> 4) + (lane & 7), b_ch = (lane >> 3) & 1;
  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step s's stage has landed for every thread, and every warp is past step s - 1's reads
    issue(s + NSTAGE - 1);  // into the stage step s - 1 read
    const int8_t* st = smem + (s % NSTAGE) * STAGE;
    const int kc0 = (s % nk) * (KB / 16);  // this stage's first 16-byte chunk of K
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk) {
      uint32_t a[2][4], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = 32 * wm + 16 * mi + a_row, c = 2 * kk + a_ch;
        ldsm_x4(a[mi], A_RESIDENT ? smem_addr(A + resident_off(r, 16 * (kc0 + c), K))
                                  : smem_addr(st + S8_STAGE + stage_off(r, c)));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) ldsm_x4(b[q], smem_addr(st + stage_off(64 * wn + 16 * q + b_row, 2 * kk + b_ch)));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
    }
    if ((s + 1) % nk == 0) {
      epilogue(s / nk, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace f32tile
}  // namespace cm3p
