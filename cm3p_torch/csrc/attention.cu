// Window (local) and segment (global) attention for Hopper, bf16 in and out.
//
// Replaces the TPU kernels of the JAX package's ops/flash_attention.py
//   _window_fused_kernel (driven by _window_fused_fwd)  -> cm3p_window_attention
//   _seg_unrolled_kernel (driven by _seg_unrolled_fwd)  -> cm3p_segment_attention
// forward, with the optional lse output of the training path. Their forms
// with the out-projection epilogue are csrc/attention_wo.cu; their backward is
// csrc/attention_bwd.cu. The rectangular form (cm3p_segment_attention with
// Lk != L) is the TPU kernel's Lq != Lk case: a shard of Lq queries over all
// Lk keys that sequence parallelism gathered, with a key mask as the key
// segments; it has no rope, no window and no lse.
//
// Semantics (the masks and rope of the TPU kernels, not their layout):
//   q, k, v: head-minor (B, L, H, 64) bf16; a position stride is passed so
//     q/k/v may be the three views of the fused Wqkv output.
//   key j is visible to query i iff j < Lk, kseg[j] > 0, qseg[i] == kseg[j]
//     and, for the window kernel, |i - j| <= window. Lk == L but in the
//     rectangular form, whose k, v are (B, Lk, H, 64) and kseg (B, Lk).
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
// Design: one block of 4 warps per (query tile of 64 rows, head, batch row),
// running the head body of csrc/attention_fwd.cuh: each warp owns 16 query
// rows and keeps its Q fragments in registers; key tiles of 64 are staged in
// shared memory (K rotated, V transposed) and the block streams over them
// with an online softmax (FlashAttention-2 style), using mma.sync m16n8k16
// bf16 with fp32 accumulation.
//   window kernel : visits only the key tiles that meet [q0 - w, q0 + 63 + w]
//                   (3 tiles at w = 64), so a local layer costs O(L * w).
//   segment kernel: visits the key-tile range [start, start + count) that the
//                   wrapper computes from the segment ids (the work of
//                   _block_ranges): tiles whose segment interval cannot meet
//                   the query tile's are skipped, so a packed row costs
//                   about sum(segment_len^2), not L^2. The rectangular
//                   form is the same kernel: its grid runs over the Lq
//                   query tiles and its ranges over the Lk key tiles.
// Bound on the H100: at head dim 64 each key tile brings 64 x 64 x 2 x 2
// bytes for 2 x 64 x 64 x 64 x 2 flops per query tile, so attention over a
// window of 129 keys sits near the ridge; this first kernel is bound by its
// own instruction issue (mma.sync, scalar masking, no load/compute overlap).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

using namespace cm3p;
using namespace cm3p::attn;

struct OutArgs {
  __nv_bfloat16* out;  // (B, L, H, 64) contiguous
  float* lse;          // (B, H, L) or null
};

template <bool WINDOW>
__global__ void __launch_bounds__(GROUP) attention_kernel(AttnArgs a, OutArgs w) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * LDV];
  __shared__ int sQseg[BQ];
  __shared__ int sKseg[BK];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;

  const int* qseg = a.qseg + (long long)b * L;
  load_rows_rope(sQ, LDS, a.q + (long long)b * a.q_bstride + h * D, a.q_pstride, q0, L, a.cos_t, a.sin_t, tid);
  for (int r = tid; r < BQ; r += GROUP) sQseg[r] = (q0 + r < L) ? qseg[q0 + r] : -1;
  int kt_begin, kt_end;
  key_tiles<WINDOW>(a, b, qt, gridDim.x, kt_begin, kt_end);
  __syncthreads();

  float o[8][4], m[2], l[2];
  head_forward<WINDOW>(a, b, h, q0, kt_begin, kt_end, sQ, LDS, sK, sVt, sKseg, sQseg, tid, 0, o, m, l);

  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
  if (w.lse != nullptr && t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (qi[hr] < L)
        w.lse[((long long)b * a.H + h) * L + qi[hr]] =
            l[hr] > 0.f ? m[hr] + log2f(l[hr]) : -99.65784284662087f;  // log2(1e-30)
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= L) continue;
    __nv_bfloat16* op = w.out + (((long long)b * L + qi[hr]) * a.H + h) * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + dt * 8) =
          pack_bf16(o[dt][2 * hr] * inv[hr], o[dt][2 * hr + 1] * inv[hr]);
    }
  }
}

template <bool WINDOW>
int launch(const AttnArgs& a, const OutArgs& w, int B, void* stream) {
  if (a.L <= 0 || B <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  const int nq = (a.L + BQ - 1) / BQ;
  if (a.H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(nq, a.H, B);
  attention_kernel<WINDOW><<<grid, GROUP, 0, (cudaStream_t)stream>>>(a, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cm3p_window_attention(const void* q, const void* k, const void* v,
                                     long long q_bstride, long long k_bstride, long long v_bstride,
                                     long long q_pstride, long long k_pstride, long long v_pstride,
                                     const void* qseg, const void* kseg, const void* cos_t,
                                     const void* sin_t, void* out, void* lse, int B, int L,
                                     int H, int window, void* stream) {
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride,
                         v_pstride, qseg, kseg, cos_t, sin_t, L, H);
  if (window < 0) return (int)cudaErrorInvalidValue;
  a.window = window;
  return launch<true>(a, OutArgs{(__nv_bfloat16*)out, (float*)lse}, B, stream);
}

// q (B, L, H, 64) and k, v (B, Lk, H, 64) bf16 views; qseg (B, L) and kseg
// (B, Lk) int32; tile_start, tile_count (B, ceil(L / 64)) int32 key-tile
// ranges; out (B, L, H, 64) contiguous bf16. Lk == L but in the rectangular
// form, which takes no rope tables and no lse.
extern "C" int cm3p_segment_attention(const void* q, const void* k, const void* v,
                                      long long q_bstride, long long k_bstride, long long v_bstride,
                                      long long q_pstride, long long k_pstride, long long v_pstride,
                                      const void* qseg, const void* kseg, const void* cos_t,
                                      const void* sin_t, const void* tile_start,
                                      const void* tile_count, void* out, void* lse, int B,
                                      int L, int Lk, int H, void* stream) {
  if (Lk <= 0 || (Lk != L && (cos_t != nullptr || lse != nullptr))) return (int)cudaErrorInvalidValue;
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride,
                         v_pstride, qseg, kseg, cos_t, sin_t, L, H);
  a.Lk = Lk;
  a.tile_start = (const int*)tile_start;
  a.tile_count = (const int*)tile_count;
  return launch<false>(a, OutArgs{(__nv_bfloat16*)out, (float*)lse}, B, stream);
}
