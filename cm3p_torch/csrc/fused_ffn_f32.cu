// Fused LayerNorm + GeGLU half-block in fp32.
//
// The fp32 form of the TPU kernel of the JAX package's ops/fused_ffn.py
//   _ffn_kernel (driven by _pallas_ln_ffn, with its w8a8 / w8a8_wo options)
//       -> cm3p_fused_ln_ffn_f32
// which the JAX package runs at fp32 where its weight-size guard lets it. The
// bf16 kernels are csrc/fused_ffn.cu; this one serves a full-width model run
// in fp32, a precision option and not the speed path.
//
// f32::ffn_kernel<W8A8, W8A8_WO>, per row (x fp32 (R, D), Wi (2F, D), Wo (D, F)):
//   y   = LN_fp32(x) (flax formula)
//   h   = y . Wi^T                                (fp32 Wi)       W8A8 = 0
//   h   = float(codes(y) . Wiq^T) * sa * swi[n]   (int8 Wi)       W8A8 = 1
//   g   = gelu_erf(h[:F]) * h[F:]                 (exact erf)
//   o   = g . Wo^T                                (fp32 Wo)       W8A8_WO = 0
//   o   = float(codes(g) . Woq^T) * sg * swo[d]   (int8 Wo)       W8A8_WO = 1
//   out = x + o
// with the plain version's rounding points at fp32 (ops/fused_ffn.py
// fused_ln_ffn_plain: no cast between them); codes(.) is the row quantiser
// (rows_f32.cuh quant4: the true division's codes; over all D columns of y,
// over all F columns of the stored g), int8 products sum exactly in int32.
// codes_y (R, D) and codes_g (R, F) (int8, optional) receive the activation
// codes for checks.
//
// Design: a persistent grid of 256-thread blocks, two an SM, each walking
// over 128-row tiles. Per tile:
// 1. front end: fp32 Wi: each row's mean and rstd into shared memory (LN is
//    applied as A is staged, as in the fp32 LN-matmul); int8 Wi: each row's y,
//    scale and codes, the codes into the block's slot of a device scratch.
// 2. Wi product in [64 a | 64 b] column tiles (Wi rows j0 .. j0 + 63 and F +
//    j0 .. + 63), so that every thread holds its own a / b pairs and the
//    epilogue computes g = gelu(a) * b in registers and stores it (fp32,
//    float4) into the block's scratch slot: fp32 Wi on rows_f32.cuh
//    f32tile::row_tile_product (8 x 8 FMA sums a thread), int8 Wi on
//    f32tile::row_tile_product_s8 (mma.sync, y codes streamed beside Wi).
//    With an int8 Wo the epilogue also keeps each row's max |g| (a shuffle
//    within the warp, then a shared-memory atomic max over the tiles).
// 3. int8 Wo: each row's scale sg from that max, and g's codes from the
//    stored g into the slot.
// 4. Wo product over K = F: fp32 Wo on row_tile_product reading the slot's g,
//    int8 Wo on row_tile_product_s8 streaming g's codes; out = x + o with
//    float4 loads and stores.
// g cannot stay on chip (128 rows of F 1152 are 590 KB), so it makes a round
// trip through the scratch (L2 where it fits); nothing in shared memory grows
// with F, so any F that is a multiple of 64 launches. The scratch is one slot
// per block of the grid (cm3p_fused_ln_ffn_f32_scratch_bytes: g fp32, y's and
// g's codes where the form has them), read and written only by its block: a
// barrier orders g's stores before its loads (plain loads through L2, not the
// read-only path), and the next tile's first barrier orders the last reads
// before the slot is written again. Bound on the H100: 6 R D F operations, at
// the CUDA cores' fp32 rate (67 TFLOP/s) for the fp32 products and the tensor
// cores' int8 rate (1,979 TOP/s) for the int8 ones, against the bytes of x,
// out and the weights; the fp32 products run at the FMA loop's pace (PERF.md
// §6), the int8 forms nearer the scratch's traffic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows_f32.cuh"

namespace {

namespace f32 {

namespace ft = cm3p::f32tile;
using namespace cm3p::f32rows;

struct Args {
  const float* x;          // (R, D)
  const float* scale;      // (D,)
  const float* bias;       // (D,) or null
  const void* wi;          // (2F, D) fp32, or int8 codes
  const float* swi;        // (2F,) int8 Wi only
  const void* wo;          // (D, F) fp32, or int8 codes
  const float* swo;        // (D,) int8 Wo only
  float* out;              // (R, D)
  int8_t* codes_y;         // (R, D) or null
  int8_t* codes_g;         // (R, F) or null
  uint8_t* scratch;        // one slot (slot_bytes) per block of the grid
  long long R;
  int D, F;
  float eps;
};

constexpr int STAGES = 4;  // cp.async stages of the int8 products

// A block's scratch slot: g (fp32, MT x F), then y's codes (MT x D, int8 Wi), then g's codes (MT x F, int8 Wo).
__host__ __device__ constexpr long long slot_bytes(int D, int F, bool w8a8, bool w8a8_wo) {
  return (long long)ft::MT * (4LL * F + (w8a8 ? D : 0) + (w8a8_wo ? F : 0));
}

// Dynamic shared memory: the stages of whichever product is larger.
__host__ __device__ constexpr int smem_bytes(bool w8a8, bool w8a8_wo) {
  return (w8a8 || w8a8_wo) ? STAGES * 2 * ft::S8_STAGE : ft::SMEM_FLOATS * 4;
}

__device__ __forceinline__ float gelu_erf(float a) { return 0.5f * a * (1.f + erff(a * 0.7071067811865476f)); }

__device__ __forceinline__ float4 gelu_glu(float4 a, float4 b) {
  return make_float4(gelu_erf(a.x) * b.x, gelu_erf(a.y) * b.y, gelu_erf(a.z) * b.z, gelu_erf(a.w) * b.w);
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

template <bool W8A8, bool W8A8_WO>
__global__ void __launch_bounds__(ft::THREADS, 2) ffn_kernel(const Args a) {  // 128 registers
  extern __shared__ __align__(128) uint4 smem4[];
  __shared__ float mu_s[ft::MT], rstd_s[ft::MT], scale_s[W8A8 ? 1 : 768], bias_s[W8A8 ? 1 : 768];
  __shared__ float sa_s[ft::MT], sg_s[ft::MT];
  __shared__ int gmax_s[ft::MT];  // each row's max |g|, as the bits of a non-negative float (they order as ints)
  const int D = a.D, F = a.F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* g = reinterpret_cast<float*>(a.scratch + blockIdx.x * slot_bytes(D, F, W8A8, W8A8_WO));  // MT x F
  int8_t* yq = reinterpret_cast<int8_t*>(g + (long long)ft::MT * F);                             // MT x D
  int8_t* gq = yq + (W8A8 ? ft::MT * D : 0);                                                      // MT x F
  int8_t* smem8 = reinterpret_cast<int8_t*>(smem4);
  if (!W8A8)
    for (int c = threadIdx.x; c < D; c += ft::THREADS) scale_s[c] = a.scale[c], bias_s[c] = a.bias ? a.bias[c] : 0.f;
  const long long row_tiles = (a.R + ft::MT - 1) / ft::MT;
  for (long long rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const long long r0 = rt * ft::MT;
    __syncthreads();  // the previous tile's last reads of the slot and of shared memory are done

    // 1. front end: warp w takes rows 16 w .. + 15 (two rows in flight spill at the 128-register cap: slower)
    for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
      const bool live = r0 + r < a.R;
      float4 v[6];
      float mu = 0.f, rstd = 1.f;
      if (live) ln_moments(a.x + (r0 + r) * D, D, a.eps, lane, v, mu, rstd);
      if (!W8A8) {
        if (lane == 0) mu_s[r] = mu, rstd_s[r] = rstd;
        continue;
      }
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int c = 4 * lane + 128 * i;
        if (c >= D) break;
        float e[4] = {0.f, 0.f, 0.f, 0.f};
        if (live) {
          e[0] = v[i].x, e[1] = v[i].y, e[2] = v[i].z, e[3] = v[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = (e[j] - mu) * (rstd * a.scale[c + j]) + (a.bias ? a.bias[c + j] : 0.f);
        }
        v[i] = make_float4(e[0], e[1], e[2], e[3]);
        amax = fmaxf(amax, abs_max4(v[i]));
      }
      const float sa = fmaxf(warp_max(amax), 1e-30f) * cm3p::kInv127, inv = 1.f / sa;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int c = 4 * lane + 128 * i;
        if (c >= D) break;
        const uint32_t q = quant4(v[i], sa, inv);
        *reinterpret_cast<uint32_t*>(yq + r * D + c) = q;
        if (a.codes_y != nullptr && live) *reinterpret_cast<uint32_t*>(a.codes_y + (r0 + r) * D + c) = q;
      }
      if (lane == 0) sa_s[r] = sa;
    }
    if (W8A8_WO && threadIdx.x < ft::MT) gmax_s[threadIdx.x] = 0;
    __syncthreads();

    // 2. Wi product: tile t is [64 a | 64 b], Wi rows 64 t .. + 63 and F + 64 t .. + 63; g into the slot
    auto wi_row = [F](int t, int c) { return (long long)(c < 64 ? 64 * t + c : F + 64 * t + c - 64); };
    if (W8A8) {
      auto epilogue = [&](int t, const int (&acc)[2][8][4]) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ft::s8_row(mi, h);
            const float s = sa_s[r];
            float m = 0.f;
#pragma unroll
            for (int p = 0; p < 2; ++p) {  // a at s8_col(p), its b partner at s8_col(p + 2) = s8_col(p) + 64
              const int j = 64 * t + ft::s8_col(p);
              const int4 qa = ft::s8_quad(acc, mi, h, p), qb = ft::s8_quad(acc, mi, h, p + 2);
              const float4 wa = __ldg(reinterpret_cast<const float4*>(a.swi + j));
              const float4 wb = __ldg(reinterpret_cast<const float4*>(a.swi + F + j));
              const float4 ha = make_float4((float)qa.x * s * wa.x, (float)qa.y * s * wa.y, (float)qa.z * s * wa.z,
                                            (float)qa.w * s * wa.w);
              const float4 hb = make_float4((float)qb.x * s * wb.x, (float)qb.y * s * wb.y, (float)qb.z * s * wb.z,
                                            (float)qb.w * s * wb.w);
              const float4 gv = gelu_glu(ha, hb);
              *reinterpret_cast<float4*>(g + r * F + j) = gv;
              m = fmaxf(m, abs_max4(gv));
            }
            if (W8A8_WO) {  // the row's 64 columns of this tile: 4 lanes here and 4 in the partner warp
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
              if ((lane & 3) == 0) atomicMax(&gmax_s[r], __float_as_int(m));
            }
          }
      };
      ft::row_tile_product_s8<STAGES, false>(yq, D, static_cast<const int8_t*>(a.wi), wi_row, F / 64, smem8,
                                             epilogue);
    } else {
      auto load_a = [&](int row, int k) {
        if (r0 + row >= a.R) return make_float4(0.f, 0.f, 0.f, 0.f);
        return __ldg(reinterpret_cast<const float4*>(a.x + (r0 + row) * D + k));
      };
      auto stage_a = [&](int row, int k, float4 v) {  // ln_row's expression
        const float mu = mu_s[row], rstd = rstd_s[row];
        v.x = (v.x - mu) * (rstd * scale_s[k]) + bias_s[k];
        v.y = (v.y - mu) * (rstd * scale_s[k + 1]) + bias_s[k + 1];
        v.z = (v.z - mu) * (rstd * scale_s[k + 2]) + bias_s[k + 2];
        v.w = (v.w - mu) * (rstd * scale_s[k + 3]) + bias_s[k + 3];
        return v;
      };
      auto epilogue = [&](int t, const float (&acc)[ft::RI][8]) {  // sums j, j + 4: a and its b partner
        const int j = 64 * t + ft::sum_col(0);
#pragma unroll
        for (int i = 0; i < ft::RI; ++i) {
          const int r = ft::sum_row(i);
          const float4 gv = gelu_glu(make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]),
                                     make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
          *reinterpret_cast<float4*>(g + r * F + j) = gv;
          if (W8A8_WO) {  // the row's 64 columns of this tile: 8 lanes here and 8 in the partner warp
            float m = abs_max4(gv);
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
            if ((lane & 7) == 0) atomicMax(&gmax_s[r], __float_as_int(m));
          }
        }
      };
      ft::row_tile_product(load_a, stage_a, static_cast<const float*>(a.wi), wi_row, F / 64, D,
                           reinterpret_cast<float*>(smem4), epilogue);
    }
    // both products return past a barrier: g and the rows' max |g| are complete

    // 3. int8 Wo: g's row scales and codes, from the stored g
    if (W8A8_WO) {
      for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
        const bool live = r0 + r < a.R;
        const float sg = fmaxf(__int_as_float(gmax_s[r]), 1e-30f) * cm3p::kInv127, inv = 1.f / sg;
        for (int c = 4 * lane; c < F; c += 128) {
          const uint32_t q = quant4(__ldcg(reinterpret_cast<const float4*>(g + r * F + c)), sg, inv);
          *reinterpret_cast<uint32_t*>(gq + r * F + c) = q;
          if (a.codes_g != nullptr && live) *reinterpret_cast<uint32_t*>(a.codes_g + (r0 + r) * F + c) = q;
        }
        if (lane == 0) sg_s[r] = sg;
      }
      __syncthreads();
    }

    // 4. Wo product: out = x + o, D in tiles of 128
    auto wo_row = [](int t, int c) { return (long long)(t * ft::NT + c); };
    if (W8A8_WO) {
      auto epilogue = [&](int t, const int (&acc)[2][8][4]) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ft::s8_row(mi, h);
            if (r0 + r >= a.R) continue;
            const float s = sg_s[r];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int n = t * ft::NT + ft::s8_col(p);
              const int4 q = ft::s8_quad(acc, mi, h, p);
              const float4 w = __ldg(reinterpret_cast<const float4*>(a.swo + n));
              const float4 xr = __ldg(reinterpret_cast<const float4*>(a.x + (r0 + r) * D + n));
              *reinterpret_cast<float4*>(a.out + (r0 + r) * D + n) =
                  make_float4(xr.x + (float)q.x * s * w.x, xr.y + (float)q.y * s * w.y, xr.z + (float)q.z * s * w.z,
                              xr.w + (float)q.w * s * w.w);
            }
          }
      };
      ft::row_tile_product_s8<STAGES, false>(gq, F, static_cast<const int8_t*>(a.wo), wo_row, D / ft::NT, smem8,
                                             epilogue);
    } else {
      auto load_a = [&](int row, int k) { return __ldcg(reinterpret_cast<const float4*>(g + row * F + k)); };
      auto stage_a = [](int, int, float4 v) { return v; };
      auto epilogue = [&](int t, const float (&acc)[ft::RI][8]) {
#pragma unroll
        for (int i = 0; i < ft::RI; ++i) {
          const long long r = r0 + ft::sum_row(i);
          if (r >= a.R) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = t * ft::NT + ft::sum_col(4 * h);
            const float4 xr = __ldg(reinterpret_cast<const float4*>(a.x + r * D + n));
            *reinterpret_cast<float4*>(a.out + r * D + n) = make_float4(
                xr.x + acc[i][4 * h], xr.y + acc[i][4 * h + 1], xr.z + acc[i][4 * h + 2], xr.w + acc[i][4 * h + 3]);
          }
        }
      };
      ft::row_tile_product(load_a, stage_a, static_cast<const float*>(a.wo), wo_row, D / ft::NT, F,
                           reinterpret_cast<float*>(smem4), epilogue);
    }
  }
}

template <bool W8A8, bool W8A8_WO>
int launch_form(const Args& a, unsigned blocks, void* stream) {
  ffn_kernel<W8A8, W8A8_WO><<<blocks, ft::THREADS, smem_bytes(W8A8, W8A8_WO), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const void* form_kernel(int w8a8, int w8a8_wo) {
  if (w8a8) return w8a8_wo ? (const void*)ffn_kernel<true, true> : (const void*)ffn_kernel<true, false>;
  return w8a8_wo ? (const void*)ffn_kernel<false, true> : (const void*)ffn_kernel<false, false>;
}

// The persistent grid: every block the card holds at once, or one per row tile when there are fewer tiles.
int grid_blocks(long long R, int w8a8, int w8a8_wo, long long& blocks) {
  const void* kernel = form_kernel(w8a8, w8a8_wo);
  const int bytes = smem_bytes(w8a8, w8a8_wo);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ft::THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (R + ft::MT - 1) / ft::MT;
  blocks = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  return 0;
}

bool valid(long long R, int D, int F) { return R > 0 && (D == 256 || D == 512 || D == 768) && F > 0 && F % 64 == 0; }

}  // namespace f32

}  // namespace

// The bytes of scratch cm3p_fused_ln_ffn_f32 needs for R rows in the given form, into *bytes: a slot per block of
// its persistent grid on the current device.
extern "C" int cm3p_fused_ln_ffn_f32_scratch_bytes(long long R, int D, int F, int w8a8, int w8a8_wo,
                                                   long long* bytes) {
  if (!f32::valid(R, D, F) || bytes == nullptr) return (int)cudaErrorInvalidValue;
  long long blocks = 0;
  const int err = f32::grid_blocks(R, w8a8, w8a8_wo, blocks);
  if (err) return err;
  *bytes = blocks * f32::slot_bytes(D, F, w8a8, w8a8_wo);
  return 0;
}

// x (R, D) fp32, D in {256, 512, 768}; scale (D,) and bias (D,) or null fp32;
// wi (2F, D) and wo (D, F): fp32, or int8 codes where w8a8 / w8a8_wo are set,
// with fp32 scales swi (2F,) / swo (D,); F a multiple of 64; out (R, D) fp32;
// codes_y (R, D) and codes_g (R, F) int8 or null; scratch: device memory of
// scratch_bytes >= cm3p_fused_ln_ffn_f32_scratch_bytes(R, D, F, w8a8, w8a8_wo),
// 16-byte aligned.
extern "C" int cm3p_fused_ln_ffn_f32(const void* x, const void* scale, const void* bias, const void* wi,
                                     const void* swi, const void* wo, const void* swo, void* out, void* codes_y,
                                     void* codes_g, void* scratch, long long scratch_bytes, long long R, int D, int F,
                                     float eps, int w8a8, int w8a8_wo, void* stream) {
  if (!f32::valid(R, D, F) || scale == nullptr || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if ((w8a8 && swi == nullptr) || (w8a8_wo && swo == nullptr)) return (int)cudaErrorInvalidValue;
  long long blocks = 0;
  const int err = f32::grid_blocks(R, w8a8, w8a8_wo, blocks);
  if (err) return err;
  if (scratch_bytes < blocks * f32::slot_bytes(D, F, w8a8, w8a8_wo)) return (int)cudaErrorInvalidValue;
  const f32::Args a{(const float*)x, (const float*)scale, (const float*)bias, wi, (const float*)swi, wo,
                    (const float*)swo, (float*)out, (int8_t*)codes_y, (int8_t*)codes_g, (uint8_t*)scratch, R, D, F,
                    eps};
  if (w8a8)
    return w8a8_wo ? f32::launch_form<true, true>(a, (unsigned)blocks, stream)
                   : f32::launch_form<true, false>(a, (unsigned)blocks, stream);
  return w8a8_wo ? f32::launch_form<false, true>(a, (unsigned)blocks, stream)
                 : f32::launch_form<false, false>(a, (unsigned)blocks, stream);
}
