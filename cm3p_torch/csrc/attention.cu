// Window (local) and segment (global) attention for Hopper, bf16 in and out.
//
// Replaces the TPU kernels of the JAX package's ops/flash_attention.py
//   _window_fused_kernel (driven by _window_fused_fwd)  -> cm3p_window_attention
//   _seg_unrolled_kernel (driven by _seg_unrolled_fwd)  -> cm3p_segment_attention
// forward, with the optional lse output of the training path; no Wo epilogue.
// Their backward is csrc/attention_bwd.cu.
//
// Semantics (the masks and rope of the TPU kernels, not their layout):
//   q, k, v: head-minor (B, L, H, 64) bf16; a position stride is passed so
//     q/k/v may be the three views of the fused Wqkv output.
//   key j is visible to query i iff j < L, kseg[j] > 0, qseg[i] == kseg[j]
//     and, for the window kernel, |i - j| <= window.
//   rope (rotate-half, arange positions) is applied in the kernel from raw
//     q/k with cos/sin tables of shape (L, 32) fp32 that the wrapper builds;
//     the rotated values are rounded to bf16 like the plain version does.
//   softmax scale 1/sqrt(64), fp32 scores and statistics, base-2 exponent.
//   A query with no visible key writes 0, not NaN.
//   lse (optional, fp32 (B, H, L)): the base-2 log-sum-exp of the scaled
//     scores, m + log2(l), written only when the caller passes a buffer (the
//     no-grad path passes none). A query with no visible key gets
//     log2(1e-30), the TPU kernels' value; the backward masks it anyway.
// The TPU kernels shift scores by a fixed power of two instead of tracking
// a running max; that equals the max-stabilised softmax outside a clamp band
// that LayerNormed activations never reach, so this port uses the running
// (online) max.
//
// Design: one block of 4 warps per (query tile of 64 rows, head, batch row).
// Each warp owns 16 query rows and keeps its Q fragments in registers. Key
// tiles of 64 are staged in shared memory (K rotated, V transposed) and the
// block streams over them with an online softmax (FlashAttention-2 style),
// using mma.sync m16n8k16 bf16 with fp32 accumulation.
//   window kernel : visits only the key tiles that meet [q0 - w, q0 + 63 + w]
//                   (3 tiles at w = 64), so a local layer costs O(L * w).
//   segment kernel: visits the key-tile range [start, start + count) that the
//                   wrapper computes from the segment ids (the work of
//                   _block_ranges): tiles whose segment interval cannot meet
//                   the query tile's are skipped, so a packed row costs
//                   about sum(segment_len^2), not L^2.
// Bound on the H100: at head dim 64 each key tile brings 64 x 64 x 2 x 2
// bytes for 2 x 64 x 64 x 64 x 2 flops per query tile, so attention over a
// window of 129 keys sits near the ridge; this first kernel is bound by its
// own instruction issue (mma.sync, scalar masking, no load/compute overlap).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int LDS = D + 8;     // padded smem row (bf16), 144 bytes
constexpr int LDV = BK + 8;    // padded row of the transposed V tile

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

__device__ __forceinline__ void unpack8(uint4 u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  return u;
}

// Load 64 positions x 64 dims starting at pos0, rotate them (rope) when
// tables are given, and store bf16 rows into smem (row stride LDS). Each
// item is 8 dims of the first half plus their 8 partners of the second half.
__device__ __forceinline__ void load_rows_rope(__nv_bfloat16* sm, const __nv_bfloat16* base,
                                               long long pos_stride, int pos0, int L,
                                               const float* cos_t, const float* sin_t) {
  for (int item = threadIdx.x; item < 64 * 4; item += NTHREADS) {
    const int r = item >> 2;
    const int c = (item & 3) * 8;
    const int pos = pos0 + r;
    float x[8], y[8];
    if (pos < L) {
      const __nv_bfloat16* p = base + (long long)pos * pos_stride;
      unpack8(*reinterpret_cast<const uint4*>(p + c), x);
      unpack8(*reinterpret_cast<const uint4*>(p + c + D / 2), y);
      if (cos_t != nullptr) {
        const float* ct = cos_t + (long long)pos * (D / 2) + c;
        const float* st = sin_t + (long long)pos * (D / 2) + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = x[i], b = y[i], cs = ct[i], sn = st[i];
          x[i] = a * cs - b * sn;
          y[i] = b * cs + a * sn;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = y[i] = 0.f;
    }
    *reinterpret_cast<uint4*>(sm + r * LDS + c) = pack8(x);
    *reinterpret_cast<uint4*>(sm + r * LDS + c + D / 2) = pack8(y);
  }
}

// V tile stored transposed: sm[d * LDV + key].
__device__ __forceinline__ void load_v_transposed(__nv_bfloat16* sm, const __nv_bfloat16* base,
                                                  long long pos_stride, int pos0, int L) {
  for (int item = threadIdx.x; item < 64 * 8; item += NTHREADS) {
    const int r = item >> 3;
    const int c = (item & 7) * 8;
    const int pos = pos0 + r;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (pos < L) u = *reinterpret_cast<const uint4*>(base + (long long)pos * pos_stride + c);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) sm[(c + i) * LDV + r] = h[i];
  }
}

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long q_bstride, k_bstride, v_bstride;  // elements between batch rows
  long long q_pstride, k_pstride, v_pstride;  // elements between positions
  const int* qseg;                            // (B, L)
  const int* kseg;                            // (B, L)
  const float* cos_t;                         // (L, 32) or null
  const float* sin_t;
  const int* tile_start;                      // (B, nq), segment kernel only
  const int* tile_count;
  __nv_bfloat16* out;                         // (B, L, H, 64) contiguous
  float* lse;                                 // (B, H, L) or null
  int L, H, window;
};

template <bool WINDOW>
__global__ void __launch_bounds__(NTHREADS) attention_kernel(AttnArgs a) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * LDV];
  __shared__ int sQseg[BQ];
  __shared__ int sKseg[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L;
  const int q0 = qt * BQ;
  const int nq = gridDim.x;

  const __nv_bfloat16* qbase = a.q + (long long)b * a.q_bstride + h * D;
  const __nv_bfloat16* kbase = a.k + (long long)b * a.k_bstride + h * D;
  const __nv_bfloat16* vbase = a.v + (long long)b * a.v_bstride + h * D;
  const int* qseg = a.qseg + (long long)b * L;
  const int* kseg = a.kseg + (long long)b * L;

  load_rows_rope(sQ, qbase, a.q_pstride, q0, L, a.cos_t, a.sin_t);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) sQseg[r] = (q0 + r < L) ? qseg[q0 + r] : -1;

  int kt_begin, kt_end;
  if (WINDOW) {
    const int lo = max(0, q0 - a.window);
    const int hi = min(L - 1, q0 + BQ - 1 + a.window);
    kt_begin = lo / BK;
    kt_end = hi / BK + 1;
  } else {
    kt_begin = a.tile_start[b * nq + qt];
    kt_end = kt_begin + a.tile_count[b * nq + qt];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = lds32(&sQ[(r0 + g) * LDS + ks * 16 + t * 2]);
    qa[ks][1] = lds32(&sQ[(r0 + g + 8) * LDS + ks * 16 + t * 2]);
    qa[ks][2] = lds32(&sQ[(r0 + g) * LDS + ks * 16 + t * 2 + 8]);
    qa[ks][3] = lds32(&sQ[(r0 + g + 8) * LDS + ks * 16 + t * 2 + 8]);
  }
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int qs[2] = {sQseg[r0 + g], sQseg[r0 + g + 8]};

  // 1/sqrt(64) folded with log2(e): scores live in base-2 units
  const float sc = 0.125f * 1.4426950408889634f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_rows_rope(sK, kbase, a.k_pstride, k0, L, a.cos_t, a.sin_t);
    load_v_transposed(sVt, vbase, a.v_pstride, k0, L);
    for (int r = threadIdx.x; r < BK; r += NTHREADS) sKseg[r] = (k0 + r < L) ? kseg[k0 + r] : 0;
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* kp = &sK[(nt * 8 + g) * LDS + ks * 16 + t * 2];
        mma_bf16(s[nt], qa[ks], lds32(kp), lds32(kp + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int j = k0 + col;
        const int hr = e >> 1;
        const int ksg = sKseg[col];
        bool ok = ksg > 0 && ksg == qs[hr];
        if (WINDOW) ok = ok && abs(qi[hr] - j) <= a.window;
        const float val = ok ? s[nt][e] * sc : -INFINITY;
        s[nt][e] = val;
        mx[hr] = fmaxf(mx[hr], val);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffff, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffff, mx[hr], 2));
      const float mn = fmaxf(m[hr], mx[hr]);
      base[hr] = (mn == -INFINITY) ? 0.f : mn;
      alpha[hr] = exp2f(m[hr] - base[hr]);
      m[hr] = mn;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = exp2f(s[nt][e] - base[hr]);
        s[nt][e] = p;
        ls[hr] += p;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * alpha[hr] + ls[hr];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const __nv_bfloat16* vp = &sVt[(dt * 8 + g) * LDV + ks * 16 + t * 2];
        mma_bf16(o[dt], pa, lds32(vp), lds32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffff, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffff, l[hr], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
  if (a.lse != nullptr && t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (qi[hr] < L)
        a.lse[((long long)b * a.H + h) * L + qi[hr]] =
            l[hr] > 0.f ? m[hr] + log2f(l[hr]) : -99.65784284662087f;  // log2(1e-30)
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= L) continue;
    __nv_bfloat16* op = a.out + (((long long)b * L + qi[hr]) * a.H + h) * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8) =
          pack_bf16(o[dt][2 * hr] * inv[hr], o[dt][2 * hr + 1] * inv[hr]);
    }
  }
}

template <bool WINDOW>
int launch(const AttnArgs& a, int B, void* stream) {
  if (a.L <= 0 || B <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  const int nq = (a.L + BQ - 1) / BQ;
  if (a.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(nq, a.H, B);
  attention_kernel<WINDOW><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

AttnArgs make_args(const void* q, const void* k, const void* v, long long q_bstride,
                   long long k_bstride, long long v_bstride, long long q_pstride,
                   long long k_pstride, long long v_pstride, const void* qseg, const void* kseg,
                   const void* cos_t, const void* sin_t, void* out, void* lse, int L, int H) {
  AttnArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.q_bstride = q_bstride;
  a.k_bstride = k_bstride;
  a.v_bstride = v_bstride;
  a.q_pstride = q_pstride;
  a.k_pstride = k_pstride;
  a.v_pstride = v_pstride;
  a.qseg = (const int*)qseg;
  a.kseg = (const int*)kseg;
  a.cos_t = (const float*)cos_t;
  a.sin_t = (const float*)sin_t;
  a.tile_start = nullptr;
  a.tile_count = nullptr;
  a.out = (__nv_bfloat16*)out;
  a.lse = (float*)lse;
  a.L = L;
  a.H = H;
  a.window = 0;
  return a;
}

}  // namespace

extern "C" int cm3p_window_attention(const void* q, const void* k, const void* v,
                                     long long q_bstride, long long k_bstride, long long v_bstride,
                                     long long q_pstride, long long k_pstride, long long v_pstride,
                                     const void* qseg, const void* kseg, const void* cos_t,
                                     const void* sin_t, void* out, void* lse, int B, int L,
                                     int H, int window, void* stream) {
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride,
                         v_pstride, qseg, kseg, cos_t, sin_t, out, lse, L, H);
  if (window < 0) return (int)cudaErrorInvalidValue;
  a.window = window;
  return launch<true>(a, B, stream);
}

extern "C" int cm3p_segment_attention(const void* q, const void* k, const void* v,
                                      long long q_bstride, long long k_bstride, long long v_bstride,
                                      long long q_pstride, long long k_pstride, long long v_pstride,
                                      const void* qseg, const void* kseg, const void* cos_t,
                                      const void* sin_t, const void* tile_start,
                                      const void* tile_count, void* out, void* lse, int B,
                                      int L, int H, void* stream) {
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride,
                         v_pstride, qseg, kseg, cos_t, sin_t, out, lse, L, H);
  a.tile_start = (const int*)tile_start;
  a.tile_count = (const int*)tile_count;
  return launch<false>(a, B, stream);
}
