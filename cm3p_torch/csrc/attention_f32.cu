// Window (local) and segment (global) attention in fp32, forward only.
//
// The fp32 form of the TPU kernels of the JAX package's ops/flash_attention.py
//   _window_fused_kernel (driven by _window_fused_fwd)  -> cm3p_window_attention_f32
//   _seg_unrolled_kernel (driven by _seg_unrolled_fwd)  -> cm3p_segment_attention_f32
//   _fa_kernel (the streaming route for windows wider than 128) -> cm3p_window_attention_f32
// which the JAX package runs at fp32 when the model's dtype is fp32 (its
// kernels accumulate in the activation dtype's _acc_t, fp32 here). The bf16
// kernels are csrc/attention.cu; this one serves a full-width model run in
// fp32 (python -m cm3p_torch.extract --dtype float32), a precision option
// and not the speed path. No lse: the training path runs in bf16.
//
// Semantics (those of csrc/attention.cu, in fp32 throughout):
//   q, k, v: head-minor (B, L, H, 64) fp32 views with a position stride; k, v
//     (B, Lk, H, 64) in the rectangular segment form (Lk != L, no rope).
//   key j is visible to query i iff j < Lk, kseg[j] > 0, qseg[i] == kseg[j]
//     and, for the window form, |i - j| <= window.
//   rope (rotate-half, arange positions) from (L, 32) fp32 cos/sin tables,
//     with the plain version's arithmetic (rope8 of attention_fwd.cuh: each
//     product rounded, then the sum) and no rounding after it (fp32).
//   softmax scale 1/8, natural exponent (expf) with a running max, the
//   output divided by the row sum; a query that sees no key writes 0.
//
// Design: one block of 256 threads per (64-query tile, head, batch row). The
// block rotates its Q tile once into shared memory, then for each key tile of
// its range (window: the tiles meeting [q0 - w, q0 + 63 + w], any w; segment:
// [start, start + count) from key_tile_ranges_kernel of csrc/attention.cu)
// stages K (rotated, stored dim-major), V and the key segments, forms the
// 64 x 64 scores with fp32 FMAs (thread: 4 query rows x 4 keys, float4
// operands), masks, updates the running max and sum (the 16 threads of a row
// group reduce by shuffles), writes P to shared memory and accumulates P V
// (thread: 4 rows x 4 dims). Bound on the H100: 2 x 64 x 64 x 64 x 2 flops
// per key tile visit against 32 KB of K and V from L2, at the CUDA cores'
// 67 TFLOP/s fp32 rate (no tensor cores: no TF32, the plain fp32 version runs
// at "highest" precision), so the segment form is bound by its operations;
// this simple kernel reads every operand from shared memory and runs well
// below that rate.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

namespace f32 {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // queries per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 row groups of 4 queries x 16 column groups of 4 keys / dims
constexpr int LD = D + 4;      // row of a staged tile (floats): float4 rows, rows of a group in other banks
constexpr int SMEM_FLOATS = 3 * BQ * LD + BK * D + BK;  // Q, K^T, P, V, key segments
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  long long q_bstride, k_bstride, v_bstride;  // elements between batch rows
  long long q_pstride, k_pstride, v_pstride;  // elements between positions
  const int* qseg;                            // (B, L)
  const int* kseg;                            // (B, Lk)
  const float* cos_t;                         // (L, 32) or null
  const float* sin_t;
  const int* tile_start;                      // (B, nq), segment form only
  const int* tile_count;
  float* out;                                 // (B, L, H, 64)
  int L, Lk, H, window;
};

// 64 rows of a head from pos0 (zeros past n), rotated with rope when tables are given, into shared memory:
// row-major (dst[r * LD + c]) or, with TRANSPOSE, dim-major (dst[c * LD + r]). Thread t takes row t / 4 and
// dims 8 (t % 4) .. + 7 with their partners 32 further.
template <bool TRANSPOSE>
__device__ __forceinline__ void stage_rows(float* dst, const float* base, long long pstride, int pos0, int n,
                                           const float* cos_t, const float* sin_t) {
  const int r = threadIdx.x >> 2, c = (threadIdx.x & 3) * 8, pos = pos0 + r;
  float x[8], y[8];
  if (pos < n) {
    const float4* px = reinterpret_cast<const float4*>(base + (long long)pos * pstride + c);
    const float4* py = reinterpret_cast<const float4*>(base + (long long)pos * pstride + c + D / 2);
    const float4 x0 = px[0], x1 = px[1], y0 = py[0], y1 = py[1];
    x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w, x[4] = x1.x, x[5] = x1.y, x[6] = x1.z, x[7] = x1.w;
    y[0] = y0.x, y[1] = y0.y, y[2] = y0.z, y[3] = y0.w, y[4] = y1.x, y[5] = y1.y, y[6] = y1.z, y[7] = y1.w;
    if (cos_t != nullptr)
      cm3p::attn::rope8(x, y, cos_t + (long long)pos * (D / 2) + c, sin_t + (long long)pos * (D / 2) + c);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = y[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (TRANSPOSE) {
      dst[(c + i) * LD + r] = x[i];
      dst[(c + D / 2 + i) * LD + r] = y[i];
    } else {
      dst[r * LD + c + i] = x[i];
      dst[r * LD + c + D / 2 + i] = y[i];
    }
  }
}

template <bool WINDOW>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [query][dim]
  float* sKt = sQ + BQ * LD;                    // [dim][key]
  float* sP = sKt + D * LD;                     // [query][key]
  float* sV = sP + BQ * LD;                     // [key][dim]
  int* sKseg = reinterpret_cast<int*>(sV + BK * D);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, Lk = p.Lk, H = p.H, q0 = qt * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;  // rows 4 ty .. + 3; keys / dims 4 tx .. + 3
  int kt_begin, kt_end;
  if (WINDOW) {
    kt_begin = max(0, q0 - p.window) / BK;
    kt_end = min(Lk - 1, q0 + BQ - 1 + p.window) / BK + 1;
  } else {
    kt_begin = p.tile_start[b * gridDim.x + qt];
    kt_end = kt_begin + p.tile_count[b * gridDim.x + qt];
  }

  int qi[4], qs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qi[i] = q0 + 4 * ty + i;
    qs[i] = qi[i] < L ? p.qseg[(long long)b * L + qi[i]] : -1;
  }
  stage_rows<false>(sQ, p.q + b * p.q_bstride + h * D, p.q_pstride, q0, L, p.cos_t, p.sin_t);

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  const float* kbase = p.k + b * p.k_bstride + h * D;
  const float* vbase = p.v + b * p.v_bstride + h * D;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are read
    stage_rows<true>(sKt, kbase, p.k_pstride, k0, Lk, p.cos_t, p.sin_t);
    for (int item = threadIdx.x; item < BK * D / 4; item += THREADS) {
      const int r = item >> 4, c = (item & 15) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Lk) u = *reinterpret_cast<const float4*>(vbase + (long long)(k0 + r) * p.v_pstride + c);
      *reinterpret_cast<float4*>(sV + r * D + c) = u;
    }
    if (threadIdx.x < BK) sKseg[threadIdx.x] = k0 + threadIdx.x < Lk ? p.kseg[(long long)b * Lk + k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sQ + (4 * ty + i) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const float4*>(sKt + (d + e) * LD + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][0] = fmaf(av[e], w[e].x, s[i][0]);
          s[i][1] = fmaf(av[e], w[e].y, s[i][1]);
          s[i][2] = fmaf(av[e], w[e].z, s[i][2]);
          s[i][3] = fmaf(av[e], w[e].w, s[i][3]);
        }
      }
    }
    int ks[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ks[j] = sKseg[4 * tx + j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool ok = ks[j] > 0 && ks[j] == qs[i];
        if (WINDOW) ok = ok && abs(qi[i] - (k0 + 4 * tx + j)) <= p.window;
        s[i][j] = ok ? s[i][j] * 0.125f : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx), base = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[i] - base);
      m[i] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        ls += s[i][j];
        o[i][j] *= alpha;
      }
      l[i] = l[i] * alpha + ls;
      *reinterpret_cast<float4*>(sP + (4 * ty + i) * LD + 4 * tx) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sP + (4 * ty + i) * LD + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const float4*>(sV + (kk + e) * D + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[i][0] = fmaf(av[e], w[e].x, o[i][0]);
          o[i][1] = fmaf(av[e], w[e].y, o[i][1]);
          o[i][2] = fmaf(av[e], w[e].z, o[i][2]);
          o[i][3] = fmaf(av[e], w[e].w, o[i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ls = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (qi[i] >= L) continue;
    const float den = ls > 0.f ? ls : 1.f;  // no visible key: o is 0, and so is the output
    *reinterpret_cast<float4*>(p.out + (((long long)b * L + qi[i]) * H + h) * D + 4 * tx) =
        make_float4(o[i][0] / den, o[i][1] / den, o[i][2] / den, o[i][3] / den);
  }
}

template <bool WINDOW>
int launch(const Params& p, int B, void* stream) {
  if (p.L <= 0 || p.Lk <= 0 || B <= 0 || B > 65535 || p.H <= 0 || p.H > 65535) return (int)cudaErrorInvalidValue;
  if ((p.cos_t == nullptr) != (p.sin_t == nullptr) || (p.cos_t != nullptr && p.Lk != p.L))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)attention_kernel<WINDOW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.L + BQ - 1) / BQ, p.H, B);
  attention_kernel<WINDOW><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, long long q_bstride, long long k_bstride,
                   long long v_bstride, long long q_pstride, long long k_pstride, long long v_pstride,
                   const void* qseg, const void* kseg, const void* cos_t, const void* sin_t, void* out, int L,
                   int Lk, int H) {
  Params p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.q_bstride = q_bstride;
  p.k_bstride = k_bstride;
  p.v_bstride = v_bstride;
  p.q_pstride = q_pstride;
  p.k_pstride = k_pstride;
  p.v_pstride = v_pstride;
  p.qseg = (const int*)qseg;
  p.kseg = (const int*)kseg;
  p.cos_t = (const float*)cos_t;
  p.sin_t = (const float*)sin_t;
  p.tile_start = nullptr;
  p.tile_count = nullptr;
  p.out = (float*)out;
  p.L = L;
  p.Lk = Lk;
  p.H = H;
  p.window = 0;
  return p;
}

}  // namespace f32

}  // namespace

// q, k, v: head-minor (B, L, H, 64) fp32 views (strides in elements, 16-byte
// aligned rows); qseg, kseg (B, L) int32; cos_t, sin_t (L, 32) fp32 or null;
// out (B, L, H, 64) contiguous fp32.
extern "C" int cm3p_window_attention_f32(const void* q, const void* k, const void* v, long long q_bstride,
                                         long long k_bstride, long long v_bstride, long long q_pstride,
                                         long long k_pstride, long long v_pstride, const void* qseg,
                                         const void* kseg, const void* cos_t, const void* sin_t, void* out, int B,
                                         int L, int H, int window, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  f32::Params p = f32::make_params(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride, v_pstride,
                                   qseg, kseg, cos_t, sin_t, out, L, L, H);
  p.window = window;
  return f32::launch<true>(p, B, stream);
}

// As above with k, v (B, Lk, H, 64) and kseg (B, Lk); tile_start, tile_count
// (B, ceil(L / 64)) int32 key-tile ranges (cm3p_key_tile_ranges). Lk == L but
// in the rectangular form, which takes no rope tables.
extern "C" int cm3p_segment_attention_f32(const void* q, const void* k, const void* v, long long q_bstride,
                                          long long k_bstride, long long v_bstride, long long q_pstride,
                                          long long k_pstride, long long v_pstride, const void* qseg,
                                          const void* kseg, const void* cos_t, const void* sin_t,
                                          const void* tile_start, const void* tile_count, void* out, int B, int L,
                                          int Lk, int H, void* stream) {
  f32::Params p = f32::make_params(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride, v_pstride,
                                   qseg, kseg, cos_t, sin_t, out, L, Lk, H);
  p.tile_start = (const int*)tile_start;
  p.tile_count = (const int*)tile_count;
  return f32::launch<false>(p, B, stream);
}
