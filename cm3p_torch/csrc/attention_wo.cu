// Window and segment attention with the out-projection epilogue for Hopper:
//     out = res + bf16( bf16(attention(q, k, v)) . Wo^T )            (bf16 form)
//     out = res + bf16( float(int8(o) . Wo_q^T) * sa * sw )           (int8 form)
//
// Replaces the fuse_wo forms of the TPU kernels of the JAX package's
// ops/flash_attention.py (the CM3P_FUSED_WO / CM3P_FUSED_WO_Q gates):
//   _window_fused_kernel (driven by _window_fused_fwd), epilogue :444-461
//       -> cm3p_attention_wo with window >= 0
//   _seg_unrolled_kernel (driven by _seg_unrolled_fwd), epilogue :671-685
//       -> cm3p_attention_wo with a key-tile range (segment form)
// Attention semantics (masks, rope, online softmax) are those of
// csrc/attention.cu; the attention output o never reaches device memory.
//
// Rounding points kept from the TPU kernels: each head's normalised o is
// rounded to bf16 (o_scr); the product accumulates in fp32 and is cast to
// bf16; then the bf16 residual is added and rounded once more. The int8 form
// quantises each bf16 o row over all H*64 columns with the quantiser of
// csrc/ln_rows.cuh (sa = max(amax, 1e-30) / 127, true division, round half
// to even), multiplies int8 x int8 -> int32 (exact) with Wo codes per output
// channel and forms bf16(float(acc) * sa * sw[n]) in that order, then adds
// the residual. A query that sees no key has o = 0, so its row is the
// residual exactly in both forms.
//
// Design. The epilogue is a product over all H*64 columns of a query row, so
// one block of 16 warps owns one (64-query tile, batch row) and every head.
// The warps form four groups of 4; group w runs heads w, w + 4, ... with the
// per-head body of csrc/attention_fwd.cuh and its own K/V staging buffers and
// named barrier, so a group waits only for its own warps. A head's Q tile is staged in the head's 64 columns of one
// (64, H*64 + 8) bf16 tile in dynamic shared memory, and the head's
// normalised output replaces it there (each warp reads and writes only its
// own 16 rows). After the heads, all 16 warps multiply that tile by Wo with
// mma.sync: Wo is staged through the (now free) K/V buffers in slices of
// 128 output columns x 64 (bf16) or 128 (int8) input columns; each warp owns
// a 32 x 16 piece of a 64 x 128 output tile. The int8 form first quantises
// the tile into a (64, H*64 + 16) int8 tile, one row per warp in registers.
// Shared memory at H*64 = 768: 99,328 + 4 x 18,688 + 512 bytes (+ 50,176 for
// the codes), one block of 16 warps per SM, at most 128 registers a thread
// (the forward kernel of csrc/attention.cu also holds 16 warps per SM).
// Bound on the H100: at the extraction shape the epilogue adds 2 x 64 x 768
// x 768 flops per tile to the attention's, against only the residual read
// and the output write; the window forms are bound by their bytes, the
// segment forms by their operations. This first kernel is far from either
// bound: one block per SM, Wo re-read from L2 for every 64 rows, no
// load/compute overlap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

using namespace cm3p;
using namespace cm3p::attn;

constexpr int NGROUPS = 4;                 // head groups of a block
constexpr int NTHREADS = NGROUPS * GROUP;  // 16 warps
constexpr int BN = 128;              // output columns per epilogue tile
constexpr int WN = BN / (NTHREADS / 64);   // epilogue: output columns per warp (two row halves)
constexpr int NT = WN / 8;                 // mma n-tiles per warp
constexpr int KS = 64;               // bf16: input columns of Wo staged per step
constexpr int LDW = KS + 8;          // padded smem row of a staged bf16 slice (elements)
constexpr int KSQ = 128;             // int8: input columns staged per step
constexpr int LDWQ = KSQ + 16;       // padded smem row of a staged int8 slice (bytes)
static_assert(BN * LDW * 2 <= NGROUPS * KV_SMEM_BYTES, "bf16 Wo slice must fit the K/V buffers");
static_assert(BN * LDWQ <= NGROUPS * KV_SMEM_BYTES, "int8 Wo slice must fit the K/V buffers");

struct WoArgs {
  const void* wo;              // (N, HD) bf16, or int8 codes in the int8 form
  const float* sw;             // (N,) fp32 weight scales (int8 form)
  const __nv_bfloat16* res;    // (B, L, N)
  __nv_bfloat16* out;          // (B, L, N)
  __nv_bfloat16* o_out;        // (B, L, HD) or null: the bf16 o tile, for checks only
  int8_t* codes_out;           // (B, L, HD) or null: the int8 o codes, for checks only
  int N;
};

template <int HD, bool QUANT>
constexpr int smem_bytes() {
  return BQ * (HD + 8) * 2 + NGROUPS * KV_SMEM_BYTES + BQ * 4 + BQ * 4 + (QUANT ? BQ * (HD + 16) : 0);
}

template <bool WINDOW, int HD, bool QUANT>
__global__ void __launch_bounds__(NTHREADS, 1) attention_wo_kernel(AttnArgs a, WoArgs w) {
  constexpr int H = HD / D;
  constexpr int LDO = HD + 8;   // row stride of the o tile (bf16 elements)
  constexpr int LDQ = HD + 16;  // row stride of the int8 code tile (bytes)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* kv = smem_raw + BQ * LDO * 2;  // the groups' K/V buffers, then Wo slices
  int* sQseg = reinterpret_cast<int*>(kv + NGROUPS * KV_SMEM_BYTES);
  float* sSa = reinterpret_cast<float*>(sQseg + BQ);
  int8_t* sQ8 = reinterpret_cast<int8_t*>(sSa + BQ);  // int8 form: the o tile's codes

  const int qt = blockIdx.x, b = blockIdx.y;
  const int L = a.L;
  const int q0 = qt * BQ;
  const int grp = threadIdx.x / GROUP, tid = threadIdx.x % GROUP;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(kv + grp * KV_SMEM_BYTES);
  __nv_bfloat16* sVt = sK + BK * LDS;
  int* sKseg = reinterpret_cast<int*>(sVt + D * LDV);

  const int* qseg = a.qseg + (long long)b * L;
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) sQseg[r] = (q0 + r < L) ? qseg[q0 + r] : -1;
  int kt_begin, kt_end;
  key_tiles<WINDOW>(a, b, qt, gridDim.x, kt_begin, kt_end);
  __syncthreads();

  // ---- attention, head by head: group grp takes heads grp, grp + NGROUPS, ...
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  {
    const int r0 = (tid >> 5) * 16;
    for (int h = grp; h < H; h += NGROUPS) {
      __nv_bfloat16* slot = sO + h * D;
      load_rows_rope(slot, LDO, a.q + (long long)b * a.q_bstride + h * D, a.q_pstride, q0, L, a.cos_t,
                     a.sin_t, tid);
      group_sync(1 + grp);
      float o[8][4], m[2], l[2];
      head_forward<WINDOW>(a, b, h, q0, kt_begin, kt_end, slot, LDO, sK, sVt, sKseg, sQseg, tid, 1 + grp, o,
                           m, l);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float inv = l[hr] > 0.f ? 1.f / l[hr] : 0.f;
        __nv_bfloat16* op = slot + (r0 + g + hr * 8) * LDO + t * 2;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
          *reinterpret_cast<uint32_t*>(op + dt * 8) = pack_bf16(o[dt][2 * hr] * inv, o[dt][2 * hr + 1] * inv);
      }
    }
  }
  __syncthreads();  // the o tile is complete; the K/V buffers are free

  const int warp = threadIdx.x >> 5;
  if (w.o_out != nullptr) {
    for (int item = threadIdx.x; item < BQ * (HD / 8); item += NTHREADS) {
      const int r = item / (HD / 8), c = (item % (HD / 8)) * 8;
      if (q0 + r < L)
        *reinterpret_cast<uint4*>(w.o_out + ((long long)b * L + q0 + r) * HD + c) =
            *reinterpret_cast<const uint4*>(sO + r * LDO + c);
    }
  }
  if (QUANT) {
    for (int rr = warp; rr < BQ; rr += NTHREADS / 32) {
      float2 y[HD / 64];
#pragma unroll
      for (int i = 0; i < HD / 64; ++i)
        y[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sO + rr * LDO + i * 64 + lane * 2));
      const bool live = q0 + rr < L;
      const float sa = quant_row_int8<HD>(
          y, lane, sQ8 + rr * LDQ,
          (w.codes_out != nullptr && live) ? w.codes_out + ((long long)b * L + q0 + rr) * HD : nullptr);
      if (lane == 0) sSa[rr] = sa;
    }
  }

  // ---- epilogue: out = res + bf16(o . Wo^T), 64 x BN tiles, 16 warps of 32 x WN
  const int rg = warp & 1;   // rows rg*32 .. rg*32+31 of the tile
  const int cg = warp >> 1;  // columns cg*WN .. cg*WN+WN-1 of the tile
  const int N = w.N;
  const long long row_base = (long long)b * L + q0;
  for (int n0 = 0; n0 < N; n0 += BN) {
    float accf[2][NT][4];
    int acci[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accf[mt][nt][e] = 0.f;
          acci[mt][nt][e] = 0;
        }
    if (!QUANT) {
      const __nv_bfloat16* wo = reinterpret_cast<const __nv_bfloat16*>(w.wo);
      __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(kv);
      for (int k0 = 0; k0 < HD; k0 += KS) {
        __syncthreads();
        for (int item = threadIdx.x; item < BN * (KS / 8); item += NTHREADS) {
          const int r = item / (KS / 8);
          const int c = (item % (KS / 8)) * 8;
          *reinterpret_cast<uint4*>(sW + r * LDW + c) =
              *reinterpret_cast<const uint4*>(wo + (long long)(n0 + r) * HD + k0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks) {
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const __nv_bfloat16* yp = sO + (rg * 32 + mt * 16 + g) * LDO + k0 + ks * 16 + t * 2;
            af[mt][0] = lds32(yp);
            af[mt][1] = lds32(yp + 8 * LDO);
            af[mt][2] = lds32(yp + 8);
            af[mt][3] = lds32(yp + 8 * LDO + 8);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* wp = sW + (cg * WN + nt * 8 + g) * LDW + ks * 16 + t * 2;
            const uint32_t b0 = lds32(wp), b1 = lds32(wp + 8);
            mma_bf16(accf[0][nt], af[0], b0, b1);
            mma_bf16(accf[1][nt], af[1], b0, b1);
          }
        }
      }
    } else {
      const int8_t* wq = reinterpret_cast<const int8_t*>(w.wo);
      int8_t* sWq = reinterpret_cast<int8_t*>(kv);
      for (int k0 = 0; k0 < HD; k0 += KSQ) {
        __syncthreads();
        for (int item = threadIdx.x; item < BN * (KSQ / 16); item += NTHREADS) {
          const int r = item / (KSQ / 16);
          const int c = (item % (KSQ / 16)) * 16;
          *reinterpret_cast<uint4*>(sWq + r * LDWQ + c) =
              *reinterpret_cast<const uint4*>(wq + (long long)(n0 + r) * HD + k0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < KSQ / 32; ++ks) {
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int8_t* qp = sQ8 + (rg * 32 + mt * 16 + g) * LDQ + k0 + ks * 32 + t * 4;
            af[mt][0] = lds32(qp);
            af[mt][1] = lds32(qp + 8 * LDQ);
            af[mt][2] = lds32(qp + 16);
            af[mt][3] = lds32(qp + 8 * LDQ + 16);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int8_t* wp = sWq + (cg * WN + nt * 8 + g) * LDWQ + ks * 32 + t * 4;
            const uint32_t b0 = lds32(wp), b1 = lds32(wp + 16);
            mma_s8(acci[0][nt], af[0], b0, b1);
            mma_s8(acci[1][nt], af[1], b0, b1);
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rr = rg * 32 + mt * 16 + g + hr * 8;
        if (q0 + rr >= L) continue;
        const float sa = QUANT ? sSa[rr] : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = n0 + cg * WN + nt * 8 + t * 2;
          const long long at = (row_base + rr) * N + col;
          float y0, y1;
          if (QUANT) {
            y0 = bf16_round((float)acci[mt][nt][2 * hr] * sa * w.sw[col]);
            y1 = bf16_round((float)acci[mt][nt][2 * hr + 1] * sa * w.sw[col + 1]);
          } else {
            y0 = bf16_round(accf[mt][nt][2 * hr]);
            y1 = bf16_round(accf[mt][nt][2 * hr + 1]);
          }
          const float2 rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w.res + at));
          *reinterpret_cast<uint32_t*>(w.out + at) = pack_bf16(rv.x + y0, rv.y + y1);
        }
      }
    }
  }
}

template <bool WINDOW, int HD, bool QUANT>
int launch(const AttnArgs& a, const WoArgs& w, int B, void* stream) {
  constexpr int bytes = smem_bytes<HD, QUANT>();
  cudaError_t err = cudaFuncSetAttribute(attention_wo_kernel<WINDOW, HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.L + BQ - 1) / BQ, B);
  attention_wo_kernel<WINDOW, HD, QUANT><<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(a, w);
  return (int)cudaGetLastError();
}

template <bool WINDOW>
int dispatch(const AttnArgs& a, const WoArgs& w, int B, bool quant, void* stream) {
#define CM3P_ATTN_WO(HD)                                                                       \
  if (a.H * D == HD)                                                                           \
    return quant ? launch<WINDOW, HD, true>(a, w, B, stream) : launch<WINDOW, HD, false>(a, w, B, stream);
  CM3P_ATTN_WO(768)
  CM3P_ATTN_WO(512)
  CM3P_ATTN_WO(256)
#undef CM3P_ATTN_WO
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: head-minor (B, L, H, 64) bf16 views (strides in elements);
// qseg, kseg: (B, L) int32; cos_t, sin_t: (L, 32) fp32 or null; window >= 0
// selects the window form, window < 0 the segment form with the key-tile
// range tile_start/tile_count (B, nq) int32. wo: (N, H*64) bf16, or int8
// codes with sw (N,) fp32 when quant != 0; res, out: (B, L, N) bf16;
// o_out (B, L, H*64) bf16 and codes_out (B, L, H*64) int8 are optional
// outputs for checks. H*64 in {256, 512, 768}, N a positive multiple of 128.
extern "C" int cm3p_attention_wo(const void* q, const void* k, const void* v, long long q_bstride,
                                 long long k_bstride, long long v_bstride, long long q_pstride,
                                 long long k_pstride, long long v_pstride, const void* qseg,
                                 const void* kseg, const void* cos_t, const void* sin_t,
                                 const void* tile_start, const void* tile_count, const void* wo,
                                 const void* sw, const void* res, void* out, void* o_out,
                                 void* codes_out, int B, int L, int H, int N, int window, int quant,
                                 void* stream) {
  if (L <= 0 || B <= 0 || B > 65535 || N <= 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (quant && sw == nullptr) return (int)cudaErrorInvalidValue;
  if (window < 0 && (tile_start == nullptr || tile_count == nullptr)) return (int)cudaErrorInvalidValue;
  AttnArgs a = make_args(q, k, v, q_bstride, k_bstride, v_bstride, q_pstride, k_pstride, v_pstride, qseg,
                         kseg, cos_t, sin_t, L, H);
  WoArgs w{wo, (const float*)sw, (const __nv_bfloat16*)res, (__nv_bfloat16*)out, (__nv_bfloat16*)o_out,
           (int8_t*)codes_out, N};
  if (window >= 0) {
    a.window = window;
    return dispatch<true>(a, w, B, quant != 0, stream);
  }
  a.tile_start = (const int*)tile_start;
  a.tile_count = (const int*)tile_count;
  return dispatch<false>(a, w, B, quant != 0, stream);
}
