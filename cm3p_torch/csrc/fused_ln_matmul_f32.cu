// Fused LayerNorm -> matmul (+ residual) in fp32.
//
// The fp32 form of the TPU kernels of the JAX package's ops/fused_ln_matmul.py
//   _lnmm_kernel (driven by _pallas_ln_matmul)      -> cm3p_ln_matmul_f32
//   _lnmm_q_kernel (driven by _pallas_ln_matmul_q)  -> cm3p_ln_matmul_q_f32
// which the JAX package runs at fp32 where lnmm_fusable admits the shape. The
// bf16 kernels are csrc/fused_ln_matmul.cu; this one serves a full-width model
// run in fp32, a precision option and not the speed path.
//
// f32::ln_matmul_kernel<WITH_LN, INT8>, per row (x fp32 (R, D), W (N, D)):
//   y   = LN_fp32(x) (flax formula) with WITH_LN, else x
//   out = y . W^T (fp32 W, fp32 FMA sums)                          INT8 = 0
//   out = float(codes(y) . Wq^T) * sa * sw[n] (exact int32 sums)   INT8 = 1
//         codes(y): the row quantiser over all D columns (rows_f32.cuh)
//   out = residual + out (when residual is given)
// with the plain versions' rounding points (ops/fused_ln_matmul.py at fp32:
// no cast between them). codes_out (int8 (R, D), optional) receives the
// activation codes for checks.
//
// Design: one block of 256 threads per 16-row tile; each warp normalises two
// rows into shared memory (and quantises them), then the block walks over N
// in 128-column tiles (rows_f32.cuh tile_product: W staged 32 words of K at a
// time, fp32 FMA or dp4a) and writes each tile with its residual. Bound on
// the H100: 2 R D N operations at the CUDA cores' fp32 rate (67 TFLOP/s) for
// the fp32 form; the int8 form moves fewer bytes and its dp4a runs at four
// products per instruction. Each 16-row tile reads all of W from L2, which
// with the products from shared memory keeps this simple kernel below its
// bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rows_f32.cuh"

namespace {

namespace f32 {

using namespace cm3p::f32rows;

struct Args {
  const float* x;          // (R, D)
  const float* scale;      // (D,) LN, or null without LN
  const float* bias;       // (D,) or null
  const uint32_t* w;       // (N, D) fp32, or (N, D) int8 codes, as words
  const float* sw;         // (N,) weight scales, int8 form only
  const float* residual;   // (R, N) or null
  float* out;              // (R, N)
  int8_t* codes_out;       // (R, D) or null
  long long R;
  int D, N;
  float eps;
};

__host__ __device__ constexpr int smem_words(int D) { return RT * D + RT * D / 4 + STAGE_WORDS + RT; }

template <bool WITH_LN, bool INT8>
__global__ void __launch_bounds__(THREADS) ln_matmul_kernel(const Args a) {
  extern __shared__ uint4 smem4[];
  float* y = reinterpret_cast<float*>(smem4);                  // RT x D
  int8_t* yq = reinterpret_cast<int8_t*>(y + RT * a.D);         // RT x D codes
  uint32_t* stage = reinterpret_cast<uint32_t*>(yq + RT * a.D);
  float* sa = reinterpret_cast<float*>(stage + STAGE_WORDS);    // RT row scales
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * RT;
  const int D = a.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    ln_row(y + r * D, a.x, r0 + r, a.R, D, WITH_LN ? a.scale : nullptr, a.bias, a.eps, lane);
    if (INT8) {
      __syncwarp();
      const float s = quant_row(y + r * D, D, yq + r * D,
                                a.codes_out != nullptr && r0 + r < a.R ? a.codes_out + (r0 + r) * D : nullptr, lane);
      if (lane == 0) sa[r] = s;
    }
  }
  __syncthreads();
  const uint32_t* A = INT8 ? reinterpret_cast<const uint32_t*>(yq) : reinterpret_cast<const uint32_t*>(y);
  const int kwords = INT8 ? D / 4 : D;
  using Acc = typename std::conditional<INT8, int, float>::type;
  for (int n0 = 0; n0 < a.N; n0 += NT) {
    Acc acc[2][4] = {};
    tile_product<INT8>(acc, A, kwords, a.w, n0, n0 + 64, kwords, stage);
    const int n = n0 + 4 * lane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r0 + r >= a.R) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = INT8 ? (float)acc[i][j] * sa[r] * a.sw[n + j] : (float)acc[i][j];
      if (a.residual != nullptr) {
        const float4 res = *reinterpret_cast<const float4*>(a.residual + (r0 + r) * a.N + n);
        v[0] = res.x + v[0], v[1] = res.y + v[1], v[2] = res.z + v[2], v[3] = res.w + v[3];
      }
      *reinterpret_cast<float4*>(a.out + (r0 + r) * a.N + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool WITH_LN, bool INT8>
int launch_form(const Args& a, void* stream) {
  const int bytes = smem_words(a.D) * 4;
  const void* kernel = (const void*)ln_matmul_kernel<WITH_LN, INT8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.R + RT - 1) / RT;
  ln_matmul_kernel<WITH_LN, INT8><<<(unsigned)blocks, THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch(const Args& a, int with_ln, void* stream) {
  if (a.R <= 0 || a.R > (long long)RT * 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((a.D != 256 && a.D != 512 && a.D != 768) || a.N <= 0 || a.N % NT) return (int)cudaErrorInvalidValue;
  if (with_ln && a.scale == nullptr) return (int)cudaErrorInvalidValue;
  return with_ln ? launch_form<true, INT8>(a, stream) : launch_form<false, INT8>(a, stream);
}

}  // namespace f32

}  // namespace

// x (R, D) fp32, D in {256, 512, 768}; scale, bias (D,) fp32 or null (bias
// only with scale); w (N, D) fp32, N a multiple of 128; residual (R, N) fp32
// or null; out (R, N) fp32. with_ln = 0 skips the LayerNorm.
extern "C" int cm3p_ln_matmul_f32(const void* x, const void* scale, const void* bias, const void* w,
                                  const void* residual, void* out, long long R, int D, int N, float eps,
                                  int with_ln, void* stream) {
  const f32::Args a{(const float*)x, (const float*)scale, (const float*)bias, (const uint32_t*)w, nullptr,
                    (const float*)residual, (float*)out, nullptr, R, D, N, eps};
  return f32::launch<false>(a, with_ln, stream);
}

// The int8 form: wq (N, D) int8 codes, sw (N,) fp32 scales; codes_out (R, D)
// int8 or null.
extern "C" int cm3p_ln_matmul_q_f32(const void* x, const void* scale, const void* bias, const void* wq,
                                    const void* sw, const void* residual, void* out, void* codes_out, long long R,
                                    int D, int N, float eps, int with_ln, void* stream) {
  const f32::Args a{(const float*)x, (const float*)scale, (const float*)bias, (const uint32_t*)wq,
                    (const float*)sw, (const float*)residual, (float*)out, (int8_t*)codes_out, R, D, N, eps};
  return f32::launch<true>(a, with_ln, stream);
}
