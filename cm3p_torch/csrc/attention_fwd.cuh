// Pieces the attention kernels share: the forward's arguments, the rope of
// 8 dims and their partners with the plain version's rounding (rope8), and the
// item of the rope passes (rope_item) that rotate k (the forward) or q and k
// (the backward, once for both of its kernels) into a contiguous buffer.
//
// Rope is rotate-half at arange positions from (L, 32) fp32 cos/sin tables;
// rotated values are rounded to bf16 like the plain version. Queries and keys
// have one length L (Lk == L) but in the rectangular segment form, where Lq =
// L query rows of a shard attend over Lk gathered keys.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bounds.cuh"
#include "ln_rows.cuh"

namespace cm3p {
namespace attn {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long q_bstride, k_bstride, v_bstride;  // elements between batch rows
  long long q_pstride, k_pstride, v_pstride;  // elements between positions
  const int* qseg;                            // (B, L)
  const int* kseg;                            // (B, Lk)
  const float* cos_t;                         // (L, 32) or null (square forms only)
  const float* sin_t;
  const int* tile_start;                      // (B, nq), segment form only
  const int* tile_count;
  int L, Lk, H, window;                       // L: query rows; Lk: keys (== L but in the rectangular form)
};

inline AttnArgs make_args(const void* q, const void* k, const void* v, long long q_bstride,
                          long long k_bstride, long long v_bstride, long long q_pstride,
                          long long k_pstride, long long v_pstride, const void* qseg,
                          const void* kseg, const void* cos_t, const void* sin_t, int L, int H) {
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
  a.L = L;
  a.Lk = L;
  a.H = H;
  a.window = 0;
  return a;
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

// Rotate-half rope of 8 dims x of the first half and their partners y of the
// second half at one position, from that position's fp32 table entries. The
// rounding is pinned to the plain version's (ops/attention.py apply_rope: each
// product rounded to fp32, then the sum; the intrinsics keep the compiler from
// contracting them into a fused multiply-add), so the rotated bf16 tiles equal
// the plain version's bit for bit, and every kernel that rotates a tile gets
// the same bits: the backward kernels (csrc/attention_bwd.cu) recompute the
// forward's scores from tiles rotated by their rope pass.
__device__ __forceinline__ void rope8(float x[8], float y[8], const float* ct, const float* st) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = x[i], b = y[i], cs = ct[i], sn = st[i];
    x[i] = __fsub_rn(__fmul_rn(a, cs), __fmul_rn(b, sn));
    y[i] = __fadd_rn(__fmul_rn(b, cs), __fmul_rn(a, sn));
  }
}

// The (L, 32) tables' entries c .. c + 7 at position pos (zeros where the checked build refuses the read).
__device__ __forceinline__ void load_tables(const float* cos_t, const float* sin_t, int pos, int c, float (&cs)[8],
                                            float (&sn)[8], int kid) {
  const long long at = (long long)pos * (D / 2) + c;
  const float4* cp = reinterpret_cast<const float4*>(cos_t + at);
  const float4* sp = reinterpret_cast<const float4*>(sin_t + at);
  const bool cok = BOUNDS_OK(kid, bounds::COS, at, 8), sok = BOUNDS_OK(kid, bounds::SIN, at, 8);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 c0 = cok ? __ldg(cp) : zero, c1 = cok ? __ldg(cp + 1) : zero;
  const float4 s0 = sok ? __ldg(sp) : zero, s1 = sok ? __ldg(sp + 1) : zero;
  cs[0] = c0.x, cs[1] = c0.y, cs[2] = c0.z, cs[3] = c0.w, cs[4] = c1.x, cs[5] = c1.y, cs[6] = c1.z, cs[7] = c1.w;
  sn[0] = s0.x, sn[1] = s0.y, sn[2] = s0.z, sn[3] = s0.w, sn[4] = s1.x, sn[5] = s1.y, sn[6] = s1.z, sn[7] = s1.w;
}

// Rotates 8 packed dims of the first half and their 8 partners with rope8.
__device__ __forceinline__ void rope_packed(uint4& ux, uint4& uy, const float (&cs)[8], const float (&sn)[8]) {
  float x[8], y[8];
  unpack8(ux, x);
  unpack8(uy, y);
  rope8(x, y, cs, sn);
  ux = pack8(x);
  uy = pack8(y);
}

// One item of a rope pass: item i of a strided (B, L, H, 64) bf16 view, 8 dims of the first half and their 8
// partners, rotated with rope8's arithmetic and bf16 rounding into out, contiguous (B, L, H, 64), so that a
// kernel reading the rotated rows sees the bits a kernel that rotates on load sees. Neighbouring items take
// neighbouring dims and heads. The passes are the forward's k pass (rope_k_kernel, csrc/attention.cu) and
// the backward's q and k pass (rope_qk_kernel, csrc/attention_bwd.cu).
constexpr int ROPE_BLOCK = 256;  // threads of a rope pass's block, one item each

// In the checked build kid names the pass, src_t the tensor src points into (Q or K) and out0 the element offset
// of out in the rot scratch.
__device__ __forceinline__ void rope_item(const __nv_bfloat16* src, long long bstride, long long pstride,
                                          const float* cos_t, const float* sin_t, __nv_bfloat16* out, int L, int H,
                                          long long i, int kid, int src_t, long long out0) {
  const int c = (int)(i & 3) * 8;
  i >>= 2;
  const int h = (int)(i % H);
  i /= H;
  const int pos = (int)(i % L);
  const int b = (int)(i / L);
  const long long at = b * bstride + pos * pstride + h * D;
  const __nv_bfloat16* row = src + at;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 ux = BOUNDS_OK(kid, src_t, at + c, 8) ? *reinterpret_cast<const uint4*>(row + c) : zero;
  uint4 uy = BOUNDS_OK(kid, src_t, at + c + D / 2, 8) ? *reinterpret_cast<const uint4*>(row + c + D / 2) : zero;
  float cs[8], sn[8];
  load_tables(cos_t, sin_t, pos, c, cs, sn, kid);
  rope_packed(ux, uy, cs, sn);
  const long long to = (((long long)b * L + pos) * H + h) * D;
  __nv_bfloat16* dst = out + to;
  if (BOUNDS_OK(kid, bounds::ROT, out0 + to + c, 8)) *reinterpret_cast<uint4*>(dst + c) = ux;
  if (BOUNDS_OK(kid, bounds::ROT, out0 + to + c + D / 2, 8)) *reinterpret_cast<uint4*>(dst + c + D / 2) = uy;
}

}  // namespace attn
}  // namespace cm3p
