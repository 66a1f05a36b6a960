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
//   softmax scale 1/8 with a running max, the exponent taken as exp2f with
//   log2(e) folded into the scale; the output divided by the row sum; a
//   query that sees no key writes 0.
//
// Design: one block of 128 threads per (64-query tile, head, batch row), three
// blocks an SM (67.75 KB of shared memory each, at most 170 registers a
// thread). The block stages its Q tile by cp.async and rotates it once in
// shared memory, then walks the key tiles of 64 of its range (window: the
// tiles meeting [q0 - w, q0 + 63 + w], any w; segment: [start, start + count)
// from key_tile_ranges_kernel of csrc/attention.cu). Thread (ty, tx) of a 16 x
// 8 grid (a warp holds 4 x 8 of it) owns query rows 4 ty .. + 3, keys tx + 8 j
// (j 0 .. 7) of the scores and dims 4 tx .. + 3, 32 + 4 tx .. + 3 of the
// output: 4 x 8 sums in each product, register-tiled fp32 FMA (no TF32: the
// plain fp32 version runs at "highest" precision). S = Q K^T reads Q and K
// row-major in float4s along the head dim (per 4 dims: 4 + 8 loads, 128 FMAs),
// P V reads P^T (written key-major by the softmax) and V (per key: 3 loads,
// 32 FMAs): 2.7 FMAs per loaded float, the first version's 4 x 4 sums 2. Row
// statistics (running max, sum) live with the 8 lanes of a row and reduce by
// shuffles. K and V stream by cp.async (.cg, zero-filled past Lk), each a tile
// ahead: the next K tile's copy starts as soon as the scores have read K, the
// next V tile's as soon as P V has read V, so each copy runs under the other
// product. In the segment form k arrives rotated by rope_k_kernel, one fp32
// pass per call into a contiguous scratch (rope8's arithmetic, so the bits
// equal the in-kernel rotation), because every query tile of a segment visits
// each key tile (about 20 times at the corpus's segments); the window form,
// whose tiles are visited 2-3 times, rotates each landed K tile in shared
// memory. A warp (16 query rows) skips the products of a key tile its rows
// cannot see: all of them padding (segment 0), or the tile wholly outside
// their window. RPT 8 (128-query blocks, 8 x 8 sums a thread, 4 FMAs per
// loaded float, 255 registers, two blocks an SM) ran the long segment rows 5 %
// faster on an H100 but the window forms 18-37 % and the short metadata
// segments 42 % slower (compare_kernels.py --phase f32parts builds it as an
// edit of this file), so 4 query rows a thread serve every form.
// Bound on the H100: 4 x 64 flops per visible (query, key) pair and head at
// the CUDA cores' 67 TFLOP/s fp32 rate against q, k, v and the output once
// at 3.35 TB/s: the segment and window forms are bound by their operations.
// What is left above the bound: the masked pairs of the tiles a warp visits
// (a window warp computes 192 keys for 129 visible), the softmax between the
// products, and four barriers a key tile.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

namespace f32 {

constexpr int D = 64;          // head dim
constexpr int RPT = 4;         // query rows of a thread: one float4 of P^T
constexpr int BQ = 64;         // queries per block: one query tile of the key-tile ranges (csrc/attention.cu)
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 128;   // a 16 x 8 grid: query rows RPT ty .. + RPT - 1; keys tx + 8 j; dims 4 tx .., 32 + ..
constexpr int LDQ = D + 4;     // floats between staged Q and K rows: the 8 rows a phase of K loads reads fall in
                               // distinct banks
constexpr int LDP = BQ + 4;    // floats between the key rows of P^T: likewise for the softmax's stores
constexpr int SMEM_BYTES = 4 * (BQ * LDQ + BK * LDQ + BK * D + BK * LDP + 2 * BK + BQ);  // Q, K, V, P^T, segments
constexpr int BLOCKS_PER_SM = 3;  // 67.75 KB of shared memory and at most 170 registers a thread
static_assert(RPT == 4 && BQ == 16 * RPT, "one float4 of P^T a thread and key row, a 16-row grid of threads");
constexpr float SCALE_LOG2 = 0.125f * 1.44269504088896341f;  // 1/8 of the scores, in base 2
constexpr int ROPE_BLOCK = 256;

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
  const int* tile_start;                      // (B, ceil(L / 64)), segment form only
  const int* tile_count;
  float* out;                                 // (B, L, H, 64)
  int L, Lk, H, window;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes (zero-filled where src_bytes < 16) by cp.async, around L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// Rotates dims c .. c + 7 and their partners c + 32 .. of a row at position pos with rope8.
__device__ __forceinline__ void rope_row8(float (&x)[8], float (&y)[8], const float* cos_t, const float* sin_t,
                                          int pos, int c) {
  float cs[8], sn[8];
  cm3p::attn::load_tables(cos_t, sin_t, pos, c, cs, sn, cm3p::bounds::NONE);
  cm3p::attn::rope8(x, y, cs, sn);
}

// ROWS rows from position k0 of one head (zeros past n) into a shared tile of rows LD floats apart, by cp.async.
template <int ROWS, int LD>
__device__ __forceinline__ void issue_rows(float* dst, const float* base, long long pstride, int k0, int n) {
#pragma unroll
  for (int m = 0; m < ROWS * D / 4 / THREADS; ++m) {
    const int i = threadIdx.x + m * THREADS, r = i >> 4, c = (i & 15) * 4;
    const bool ok = k0 + r < n;
    cp_async16(dst + r * LD + c, ok ? base + (long long)(k0 + r) * pstride + c : base, ok ? 16 : 0);
  }
}
// The key segments of the tile at k0 (zeros past Lk), with its K rows.
__device__ __forceinline__ void issue_kseg(int* dst, const int* kseg_row, int k0, int Lk) {
  if (threadIdx.x < BK) {
    const bool ok = k0 + (int)threadIdx.x < Lk;
    cp_async4(dst + threadIdx.x, ok ? kseg_row + k0 + threadIdx.x : kseg_row, ok ? 4 : 0);
  }
}

// Rotates rows [0, ROWS) of a staged tile in place (the rows at positions pos0 + r < L), 8 dims and their
// partners an item.
template <int ROWS>
__device__ __forceinline__ void rope_rows(float* tile, int pos0, int L, const float* cos_t, const float* sin_t) {
#pragma unroll
  for (int it = 0; it < ROWS * 4 / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS, r = i >> 2, c = (i & 3) * 8;
    if (pos0 + r < L) {
      float x[8], y[8];
      load8(tile + r * LDQ + c, x);
      load8(tile + r * LDQ + c + D / 2, y);
      rope_row8(x, y, cos_t, sin_t, pos0 + r, c);
      store8(tile + r * LDQ + c, x);
      store8(tile + r * LDQ + c + D / 2, y);
    }
  }
}

template <bool WINDOW>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) attention_kernel(const Params p) {
  constexpr int WR = 4 * RPT;  // query rows of a warp
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [query][dim], LDQ
  float* sK = sQ + BQ * LDQ;                    // [key][dim], LDQ
  float* sV = sK + BK * LDQ;                    // [key][dim], D
  float* sPt = sV + BK * D;                     // [key][query], LDP
  int* sKseg = reinterpret_cast<int*>(sPt + BK * LDP);  // two buffers of BK
  int* sQseg = sKseg + 2 * BK;                          // BQ

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, Lk = p.Lk, q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = 4 * warp + (lane >> 3), tx = lane & 7;
  const bool rope = p.cos_t != nullptr;
  // this warp's query rows [wr0, wr1]
  const int wr0 = q0 + WR * warp, wr1 = min(wr0 + WR - 1, L - 1);
  int kt_begin, kt_end;
  if (WINDOW) {
    kt_begin = max(0, q0 - p.window) / BK;
    kt_end = min(Lk - 1, min(q0 + BQ - 1, L - 1) + p.window) / BK + 1;
  } else {  // the key-tile range of this query tile
    const long long t = (long long)b * ((L + BQ - 1) / BQ) + qt;
    kt_begin = p.tile_start[t];
    kt_end = kt_begin + p.tile_count[t];
  }
  // warp-uniform: does this warp hold a query with a positive segment (one that may see a key)?
  const int qr = wr0 + (lane & (WR - 1));
  const bool has_rows = __any_sync(0xffffffffu, qr < L && p.qseg[(long long)b * L + qr] > 0);
  const float* qbase = p.q + b * p.q_bstride + h * D;
  const float* kbase = p.k + b * p.k_bstride + h * D;
  const float* vbase = p.v + b * p.v_bstride + h * D;
  const int* kseg_row = p.kseg + (long long)b * Lk;
  if (kt_begin < kt_end) {  // the Q tile (raw) with the first K tile, then the first V tile
    issue_rows<BQ, LDQ>(sQ, qbase, p.q_pstride, q0, L);
    issue_rows<BK, LDQ>(sK, kbase, p.k_pstride, kt_begin * BK, Lk);
    issue_kseg(sKseg + (kt_begin & 1) * BK, kseg_row, kt_begin * BK, Lk);
    cp_async_commit();
    issue_rows<BK, D>(sV, vbase, p.v_pstride, kt_begin * BK, Lk);
    cp_async_commit();
  }
  if (threadIdx.x < BQ)
    sQseg[threadIdx.x] = q0 + (int)threadIdx.x < L ? p.qseg[(long long)b * L + q0 + threadIdx.x] : -1;

  float o[RPT][8], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int* ks = sKseg + (kt & 1) * BK;
    cp_async_wait<1>();  // this thread's copies of K (and the segments, and Q); V may still be in flight
    __syncthreads();     // everyone's
    if (rope && (kt == kt_begin || WINDOW)) {  // Q once; each K tile of the window form
      if (kt == kt_begin) rope_rows<BQ>(sQ, q0, L, p.cos_t, p.sin_t);
      if (WINDOW) rope_rows<BK>(sK, k0, L, p.cos_t, p.sin_t);
      __syncthreads();
    }
    // warp-uniform: may this warp's rows see a key of the tile?
    const bool live = has_rows && (!WINDOW || (k0 <= wr1 + p.window && k0 + BK - 1 >= wr0 - p.window));
    float s[RPT][8];
    if (live) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = *reinterpret_cast<const float4*>(sQ + (RPT * ty + i) * LDQ + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(sK + (tx + 8 * j) * LDQ + d);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            s[i][j] = fmaf(a[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(a[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(a[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(a[i].w, kv.w, s[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every warp has read K: the next tile's copy may overwrite it
    if (kt + 1 < kt_end) {
      issue_rows<BK, LDQ>(sK, kbase, p.k_pstride, k0 + BK, Lk);
      issue_kseg(sKseg + ((kt + 1) & 1) * BK, kseg_row, k0 + BK, Lk);
    }
    cp_async_commit();
    if (live) {
      int kseg[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kseg[j] = ks[tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = RPT * ty + i, qs = sQseg[row];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bool ok = kseg[j] > 0 && kseg[j] == qs;
          if (WINDOW) ok = ok && abs(q0 + row - (k0 + tx + 8 * j)) <= p.window;
          s[i][j] = ok ? s[i][j] * SCALE_LOG2 : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[i], mx), base = mn == -INFINITY ? 0.f : mn;
        const float alpha = exp2f(m[i] - base);
        m[i] = mn;
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = exp2f(s[i][j] - base);
          ls += s[i][j];
          o[i][j] *= alpha;
        }
        l[i] = l[i] * alpha + ls;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)  // P^T: key row tx + 8 j, this thread's RPT queries
        *reinterpret_cast<float4*>(sPt + (tx + 8 * j) * LDP + RPT * ty) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    cp_async_wait<1>();  // this thread's copies of V of tile kt; the next K may still be in flight
    __syncthreads();     // everyone's, and P^T
    if (live) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 t = *reinterpret_cast<const float4*>(sPt + kk * LDP + RPT * ty);
        const float pv[RPT] = {t.x, t.y, t.z, t.w};
        const float4 v0 = *reinterpret_cast<const float4*>(sV + kk * D + 4 * tx);
        const float4 v1 = *reinterpret_cast<const float4*>(sV + kk * D + D / 2 + 4 * tx);
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
      }
    }
    __syncthreads();  // every warp has read V and P^T
    if (kt + 1 < kt_end) issue_rows<BK, D>(sV, vbase, p.v_pstride, k0 + BK, Lk);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float ls = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    const int row = q0 + RPT * ty + i;
    if (row >= L) continue;
    const float den = ls > 0.f ? ls : 1.f;  // no visible key: o is 0, and so is the output
    float* dst = p.out + (((long long)b * L + row) * p.H + h) * D;
    *reinterpret_cast<float4*>(dst + 4 * tx) = make_float4(o[i][0] / den, o[i][1] / den, o[i][2] / den, o[i][3] / den);
    *reinterpret_cast<float4*>(dst + D / 2 + 4 * tx) =
        make_float4(o[i][4] / den, o[i][5] / den, o[i][6] / den, o[i][7] / den);
  }
}

// The segment form's rope pass: k (a strided (B, L, H, 64) view) rotated with rope8 into out, contiguous
// (B, L, H, 64); one item (8 dims and their partners of one row) a thread, neighbouring items on neighbouring
// dims and heads.
__global__ void __launch_bounds__(ROPE_BLOCK)
    rope_k_kernel(const float* k, long long bstride, long long pstride, const float* cos_t, const float* sin_t,
                  float* out, int B, int L, int H) {
  long long i = (long long)blockIdx.x * ROPE_BLOCK + threadIdx.x;
  if (i >= (long long)B * L * H * 4) return;
  const int c = (int)(i & 3) * 8;
  i >>= 2;
  const int h = (int)(i % H);
  i /= H;
  const int pos = (int)(i % L), b = (int)(i / L);
  const float* row = k + b * bstride + pos * pstride + h * D;
  float x[8], y[8];
  load8(row + c, x);
  load8(row + c + D / 2, y);
  rope_row8(x, y, cos_t, sin_t, pos, c);
  float* dst = out + (((long long)b * L + pos) * H + h) * D;
  store8(dst + c, x);
  store8(dst + c + D / 2, y);
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
// aligned rows); qseg, kseg (B, L) int32; cos_t, sin_t (L, 32) fp32 or null
// (then q and k are rotated inside the kernel); out (B, L, H, 64) contiguous
// fp32.
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
// in the rectangular form, which takes no rope tables. With rope tables the
// kernel rotates q only: k must come rotated, as cm3p_rope_k_f32 gives it.
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

// The segment form's rope pass: k, a (B, L, H, 64) fp32 view (16-byte aligned rows), rotated with the (L, 32)
// tables into out, contiguous (B, L, H, 64) fp32.
extern "C" int cm3p_rope_k_f32(const void* k, long long k_bstride, long long k_pstride, const void* cos_t,
                               const void* sin_t, void* out, int B, int L, int H, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || cos_t == nullptr || sin_t == nullptr) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * L * H * 4;
  f32::rope_k_kernel<<<(unsigned)((items + f32::ROPE_BLOCK - 1) / f32::ROPE_BLOCK), f32::ROPE_BLOCK, 0,
                       (cudaStream_t)stream>>>((const float*)k, k_bstride, k_pstride, (const float*)cos_t,
                                               (const float*)sin_t, (float*)out, B, L, H);
  return (int)cudaGetLastError();
}
