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
// fused_ln_ffn_plain: no cast between them); codes(.) is the row quantiser of
// rows_f32.cuh (over all D columns of y, over all F columns of g), int8
// products sum exactly in int32 (dp4a). codes_y (R, D) and codes_g (R, F)
// (int8, optional) receive the activation codes for checks.
//
// Design: one block of 256 threads per 16-row tile keeps the tile's y and all
// F columns of its g in shared memory (so the int8 Wo form quantises g over
// the whole row without a second pass), and runs the two products with
// rows_f32.cuh's tile_product: for each 64 columns of F the 64 a columns and
// their 64 b partners as one 128-column tile of Wi, the GeGLU through a small
// shared tile, then D in 128-column tiles of Wo with the residual. Shared
// memory: 16 x (D + F) fp32 and their codes, about 175 KB at D 768, F 1152.
// Bound on the H100: 6 R D F operations at the CUDA cores' fp32 rate (67
// TFLOP/s); each 16-row tile reads both weights from L2, and the products
// read their operands from shared memory, so this simple kernel runs below it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "rows_f32.cuh"

namespace {

namespace f32 {

using namespace cm3p::f32rows;

struct Args {
  const float* x;          // (R, D)
  const float* scale;      // (D,)
  const float* bias;       // (D,) or null
  const uint32_t* wi;      // (2F, D) fp32, or int8 codes, as words
  const float* swi;        // (2F,) int8 Wi only
  const uint32_t* wo;      // (D, F) fp32, or int8 codes, as words
  const float* swo;        // (D,) int8 Wo only
  float* out;              // (R, D)
  int8_t* codes_y;         // (R, D) or null
  int8_t* codes_g;         // (R, F) or null
  long long R;
  int D, F;
  float eps;
};

constexpr int SMEM_BYTES = 232448;  // the most dynamic shared memory a block may take on sm_90

// y, y codes, g, g codes, the h tile, the weight stage, row scales of y and of g
__host__ __device__ constexpr int smem_words(int D, int F) {
  return RT * D + RT * D / 4 + RT * F + RT * F / 4 + RT * NT + STAGE_WORDS + 2 * RT;
}

__device__ __forceinline__ float gelu_erf(float a) { return 0.5f * a * (1.f + erff(a * 0.7071067811865476f)); }

template <bool W8A8, bool W8A8_WO>
__global__ void __launch_bounds__(THREADS) ffn_kernel(const Args a) {
  extern __shared__ uint4 smem4[];
  const int D = a.D, F = a.F;
  float* y = reinterpret_cast<float*>(smem4);         // RT x D
  int8_t* yq = reinterpret_cast<int8_t*>(y + RT * D);  // RT x D
  float* g = reinterpret_cast<float*>(yq + RT * D);    // RT x F
  int8_t* gq = reinterpret_cast<int8_t*>(g + RT * F);  // RT x F
  float* ht = reinterpret_cast<float*>(gq + RT * F);   // RT x NT
  uint32_t* stage = reinterpret_cast<uint32_t*>(ht + RT * NT);
  float* sa = reinterpret_cast<float*>(stage + STAGE_WORDS);
  float* sg = sa + RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * RT;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    ln_row(y + r * D, a.x, r0 + r, a.R, D, a.scale, a.bias, a.eps, lane);
    if (W8A8) {
      __syncwarp();
      const float s = quant_row(y + r * D, D, yq + r * D,
                                a.codes_y != nullptr && r0 + r < a.R ? a.codes_y + (r0 + r) * D : nullptr, lane);
      if (lane == 0) sa[r] = s;
    }
  }
  __syncthreads();

  // h = [a | b] 64 columns of F at a time, then g = gelu(a) * b into g
  {
    using Acc = typename std::conditional<W8A8, int, float>::type;
    const uint32_t* A = W8A8 ? reinterpret_cast<const uint32_t*>(yq) : reinterpret_cast<const uint32_t*>(y);
    const int kwords = W8A8 ? D / 4 : D;
    for (int j0 = 0; j0 < F; j0 += 64) {
      Acc acc[2][4] = {};
      tile_product<W8A8>(acc, A, kwords, a.wi, j0, F + j0, kwords, stage);
      const int c = 4 * lane, n = lane < 16 ? j0 + c : F + j0 + (c - 64);  // this lane's Wi rows
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = W8A8 ? (float)acc[i][j] * sa[r] * a.swi[n + j] : (float)acc[i][j];
        *reinterpret_cast<float4*>(ht + r * NT + c) = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      for (int item = threadIdx.x; item < RT * 64; item += THREADS) {
        const int r = item >> 6, j = item & 63;
        g[r * F + j0 + j] = gelu_erf(ht[r * NT + j]) * ht[r * NT + 64 + j];
      }
      // the next tile_product's first barrier orders these reads of ht before its next writes
    }
  }
  __syncthreads();
  if (W8A8_WO) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      const float s = quant_row(g + r * F, F, gq + r * F,
                                a.codes_g != nullptr && r0 + r < a.R ? a.codes_g + (r0 + r) * F : nullptr, lane);
      if (lane == 0) sg[r] = s;
    }
    __syncthreads();
  }

  // out = x + g . Wo^T, 128 columns of D at a time
  {
    using Acc = typename std::conditional<W8A8_WO, int, float>::type;
    const uint32_t* A = W8A8_WO ? reinterpret_cast<const uint32_t*>(gq) : reinterpret_cast<const uint32_t*>(g);
    const int kwords = W8A8_WO ? F / 4 : F;
    for (int n0 = 0; n0 < D; n0 += NT) {
      Acc acc[2][4] = {};
      tile_product<W8A8_WO>(acc, A, kwords, a.wo, n0, n0 + 64, kwords, stage);
      const int n = n0 + 4 * lane;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r0 + r >= a.R) continue;
        const float4 xr = *reinterpret_cast<const float4*>(a.x + (r0 + r) * D + n);
        const float xv[4] = {xr.x, xr.y, xr.z, xr.w};
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = xv[j] + (W8A8_WO ? (float)acc[i][j] * sg[r] * a.swo[n + j] : (float)acc[i][j]);
        *reinterpret_cast<float4*>(a.out + (r0 + r) * D + n) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <bool W8A8, bool W8A8_WO>
int launch_form(const Args& a, void* stream) {
  const int bytes = smem_words(a.D, a.F) * 4;
  const void* kernel = (const void*)ffn_kernel<W8A8, W8A8_WO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.R + RT - 1) / RT;
  ffn_kernel<W8A8, W8A8_WO><<<(unsigned)blocks, THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

// x (R, D) fp32, D in {256, 512, 768}; scale (D,) and bias (D,) or null fp32;
// wi (2F, D) and wo (D, F): fp32, or int8 codes where w8a8 / w8a8_wo are set,
// with fp32 scales swi (2F,) / swo (D,); F a multiple of 64 with the tile's
// y, g and their codes within the block's shared memory (F <= 1152 at D 768);
// out (R, D) fp32; codes_y (R, D) and codes_g (R, F) int8 or null.
extern "C" int cm3p_fused_ln_ffn_f32(const void* x, const void* scale, const void* bias, const void* wi,
                                     const void* swi, const void* wo, const void* swo, void* out, void* codes_y,
                                     void* codes_g, long long R, int D, int F, float eps, int w8a8, int w8a8_wo,
                                     void* stream) {
  if (R <= 0 || (D != 256 && D != 512 && D != 768) || F <= 0 || F % 64 || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((w8a8 && swi == nullptr) || (w8a8_wo && swo == nullptr)) return (int)cudaErrorInvalidValue;
  if (f32::smem_words(D, F) * 4 > f32::SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const f32::Args a{(const float*)x, (const float*)scale, (const float*)bias, (const uint32_t*)wi,
                    (const float*)swi, (const uint32_t*)wo, (const float*)swo, (float*)out, (int8_t*)codes_y,
                    (int8_t*)codes_g, R, D, F, eps};
  if (w8a8)
    return w8a8_wo ? f32::launch_form<true, true>(a, stream) : f32::launch_form<true, false>(a, stream);
  return w8a8_wo ? f32::launch_form<false, true>(a, stream) : f32::launch_form<false, false>(a, stream);
}

// The largest F (a multiple of 64) that cm3p_fused_ln_ffn_f32 takes at width D: the wrapper's limit and its
// message, read from the layout above rather than copied.
extern "C" int cm3p_fused_ln_ffn_f32_max_f(int D) {
  int F = 0;
  while (f32::smem_words(D, F + 64) * 4 <= f32::SMEM_BYTES) F += 64;
  return F;
}
