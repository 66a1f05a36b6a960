// The forward attention body shared by csrc/attention.cu (one block per
// query tile and head) and csrc/attention_wo.cu (one block per query tile,
// all heads in turn, then the out-projection epilogue).
//
// A group of 4 warps (128 threads) computes one head of one 64-query tile:
// each warp owns 16 query rows and keeps its Q fragments in registers; key
// tiles of 64 are staged in shared memory (K rotated, V transposed) and the
// group streams over them with an online softmax (FlashAttention-2 style),
// using mma.sync m16n8k16 bf16 with fp32 accumulation.
//
// Masks: key j is visible to query i iff j < Lk, kseg[j] > 0, qseg[i] ==
// kseg[j] and, for the window form, |i - j| <= window. Queries and keys have
// one length L (Lk == L) but in the rectangular segment form, where Lq = L
// query rows of a shard attend over Lk gathered keys. Rope (rotate-half,
// arange positions) is applied while a tile is staged, from (L, 32) fp32
// cos/sin tables; rotated values are rounded to bf16 like the plain version.
// Scores are fp32 in base-2 units (softmax scale 1/sqrt(64) folded with
// log2(e)).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ln_rows.cuh"

namespace cm3p {
namespace attn {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int GROUP = 128;     // threads of a head group: 4 warps x 16 query rows
constexpr int LDS = D + 8;     // padded smem row of a staged K tile (bf16), 144 bytes
constexpr int LDV = BK + 8;    // padded row of the transposed V tile
constexpr int KV_SMEM_BYTES = (BK * LDS + D * LDV) * 2 + BK * 4;  // sK, sVt, sKseg of one group

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

// Barrier of the threads that share a staging buffer: the whole block
// (bar_id 0, a block of GROUP threads) or one named group of GROUP threads.
__device__ __forceinline__ void group_sync(int bar_id) {
  if (bar_id == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "n"(GROUP) : "memory");
  }
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
// forward's scores from tiles they rotate themselves.
__device__ __forceinline__ void rope8(float x[8], float y[8], const float* ct, const float* st) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = x[i], b = y[i], cs = ct[i], sn = st[i];
    x[i] = __fsub_rn(__fmul_rn(a, cs), __fmul_rn(b, sn));
    y[i] = __fadd_rn(__fmul_rn(b, cs), __fmul_rn(a, sn));
  }
}

// Load 64 positions x 64 dims starting at pos0, rotate them (rope) when
// tables are given, and store bf16 rows into smem (row stride ld) and, when
// smt is not null, also transposed (smt[dim * ldt + pos]; the backward
// kernels' second copy). Each item is 8 dims of the first half plus their 8
// partners of the second half; tid runs over GROUP threads.
__device__ __forceinline__ void load_rows_rope(__nv_bfloat16* sm, int ld, const __nv_bfloat16* base,
                                               long long pos_stride, int pos0, int L,
                                               const float* cos_t, const float* sin_t, int tid,
                                               __nv_bfloat16* smt = nullptr, int ldt = 0) {
  for (int item = tid; item < 64 * 4; item += GROUP) {
    const int r = item >> 2;
    const int c = (item & 3) * 8;
    const int pos = pos0 + r;
    float x[8], y[8];
    if (pos < L) {
      const __nv_bfloat16* p = base + (long long)pos * pos_stride;
      unpack8(*reinterpret_cast<const uint4*>(p + c), x);
      unpack8(*reinterpret_cast<const uint4*>(p + c + D / 2), y);
      if (cos_t != nullptr)
        rope8(x, y, cos_t + (long long)pos * (D / 2) + c, sin_t + (long long)pos * (D / 2) + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = y[i] = 0.f;
    }
    const uint4 ux = pack8(x), uy = pack8(y);
    *reinterpret_cast<uint4*>(sm + r * ld + c) = ux;
    *reinterpret_cast<uint4*>(sm + r * ld + c + D / 2) = uy;
    if (smt != nullptr) {
      const __nv_bfloat16* hx = reinterpret_cast<const __nv_bfloat16*>(&ux);
      const __nv_bfloat16* hy = reinterpret_cast<const __nv_bfloat16*>(&uy);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        smt[(c + i) * ldt + r] = hx[i];
        smt[(c + D / 2 + i) * ldt + r] = hy[i];
      }
    }
  }
}

// V tile stored transposed: sm[d * LDV + key].
__device__ __forceinline__ void load_v_transposed(__nv_bfloat16* sm, const __nv_bfloat16* base,
                                                  long long pos_stride, int pos0, int L, int tid) {
  for (int item = tid; item < 64 * 8; item += GROUP) {
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

// Key-tile range [begin, end) of query tile qt of batch row b.
template <bool WINDOW>
__device__ __forceinline__ void key_tiles(const AttnArgs& a, int b, int qt, int nq, int& begin, int& end) {
  if (WINDOW) {
    const int q0 = qt * BQ;
    const int lo = max(0, q0 - a.window);
    const int hi = min(a.Lk - 1, q0 + BQ - 1 + a.window);
    begin = lo / BK;
    end = hi / BK + 1;
  } else {
    begin = a.tile_start[b * nq + qt];
    end = begin + a.tile_count[b * nq + qt];
  }
}

// One head of one query tile, by one group. On entry the group's rotated Q
// tile is in sQ (row stride ldq) and sQseg holds the tile's query segments
// (-1 past L); both are visible to the group. Leaves in the registers of
// lane (g, t) of warp w the unnormalised output o of rows 16 w + g (+ 8), its
// running max m (base 2) and its row sum l, already summed over the quad.
template <bool WINDOW>
__device__ __forceinline__ void head_forward(const AttnArgs& a, int b, int h, int q0, int kt_begin,
                                             int kt_end, const __nv_bfloat16* sQ, int ldq,
                                             __nv_bfloat16* sK, __nv_bfloat16* sVt, int* sKseg,
                                             const int* sQseg, int tid, int bar_id, float (&o)[8][4],
                                             float (&m)[2], float (&l)[2]) {
  const int Lk = a.Lk;
  const __nv_bfloat16* kbase = a.k + (long long)b * a.k_bstride + h * D;
  const __nv_bfloat16* vbase = a.v + (long long)b * a.v_bstride + h * D;
  const int* kseg = a.kseg + (long long)b * Lk;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = lds32(&sQ[(r0 + g) * ldq + ks * 16 + t * 2]);
    qa[ks][1] = lds32(&sQ[(r0 + g + 8) * ldq + ks * 16 + t * 2]);
    qa[ks][2] = lds32(&sQ[(r0 + g) * ldq + ks * 16 + t * 2 + 8]);
    qa[ks][3] = lds32(&sQ[(r0 + g + 8) * ldq + ks * 16 + t * 2 + 8]);
  }
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const int qs[2] = {sQseg[r0 + g], sQseg[r0 + g + 8]};

  const float sc = 0.125f * 1.4426950408889634f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    group_sync(bar_id);  // every warp of the group is done with the previous tile
    load_rows_rope(sK, LDS, kbase, a.k_pstride, k0, Lk, a.cos_t, a.sin_t, tid);
    load_v_transposed(sVt, vbase, a.v_pstride, k0, Lk, tid);
    for (int r = tid; r < BK; r += GROUP) sKseg[r] = (k0 + r < Lk) ? kseg[k0 + r] : 0;
    group_sync(bar_id);

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
}

}  // namespace attn
}  // namespace cm3p
