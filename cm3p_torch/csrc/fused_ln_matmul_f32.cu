// Fused LayerNorm -> matmul (+ residual) in fp32.
//
// The fp32 form of the TPU kernels of the JAX package's ops/fused_ln_matmul.py
//   _lnmm_kernel (driven by _pallas_ln_matmul)      -> cm3p_ln_matmul_f32
//   _lnmm_q_kernel (driven by _pallas_ln_matmul_q)  -> cm3p_ln_matmul_q_f32
// which the JAX package runs at fp32 where lnmm_fusable admits the shape. The
// bf16 kernels are csrc/fused_ln_matmul.cu; this one serves a full-width model
// run in fp32, a precision option and not the speed path.
//
// f32::ln_matmul_kernel<WITH_LN> and f32::ln_matmul_q_kernel<WITH_LN>, per row
// (x fp32 (R, D), W (N, D)):
//   y   = LN_fp32(x) (flax formula) with WITH_LN, else x
//   out = y . W^T (fp32 W, fp32 FMA sums)                          ln_matmul_kernel
//   out = float(codes(y) . Wq^T) * sa * sw[n] (exact int32 sums)   ln_matmul_q_kernel
//         codes(y): the row quantiser over all D columns (rows_f32.cuh)
//   out = residual + out (when residual is given)
// with the plain versions' rounding points (ops/fused_ln_matmul.py at fp32:
// no cast between them). codes_out (int8 (R, D), optional) receives the
// activation codes for checks.
//
// Design, fp32-weight forms (f32::ln_matmul_kernel<WITH_LN>): one block of
// 256 threads per 128-row tile, two blocks an SM (128 registers a thread).
// With LN each warp first takes the mean and rstd of an eighth of the rows
// (rows_f32.cuh ln_moments: ln_row's sums and shuffle tree) into shared
// memory, beside the LN scale and bias. Then the block walks over N in 128 x
// 128 output tiles (rows_f32.cuh f32tile::row_tile_product: 8 x 8 fp32 sums a
// thread, A and W staged 16 values of K at a time through two K-major
// shared-memory buffers, the next slice's loads in flight); each A slice is
// normalised with ln_row's expression as it is staged, a slice after its load
// (128 normalised rows of 768 would not fit in shared memory), and the
// epilogue adds the residual with float4 loads and stores. Bound on the H100:
// 2 R D N operations at the CUDA cores' fp32 rate (67 TFLOP/s). Four 16-byte
// shared-memory loads per 64 FMAs, and W read from L2 once per 128 rows; the
// first version (16-row tiles of tile_product: six such loads per 32 FMAs, W
// read once per 16 rows) ran at 23-25 % of that rate, below one torch.addmm.
// Tried and measured (compare_kernels.py --phase f32parts, PERF.md §6): a
// copy without the slices' loads and stores (products alone, wrong sums) runs
// at 61 % (Wo form) and 69 % (LN form) of the fp32 rate, so the FMA loop at
// the 128-register cap of two blocks an SM sets the pace (ptxas spills a few
// registers); one block an SM (no spills) was 38 % slower, 8 values of K a
// slice 27 % slower (twice the barriers). Normalising A as it was fetched
// stalled the products on each load; it is normalised as it is staged.
// Int8 forms (f32::ln_matmul_q_kernel<WITH_LN>): one block of 256 threads per
// 16-row tile; each warp normalises two rows into shared memory and
// quantises them, then the block walks over N in 128-column tiles
// (tile_product: W staged 32 words of K at a time, dp4a) and writes each
// tile with its residual. Its dp4a runs at four products per instruction and
// it moves fewer bytes.
#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool WITH_LN>
__global__ void __launch_bounds__(cm3p::f32tile::THREADS, 2) ln_matmul_kernel(const Args a) {  // 128 registers
  namespace ft = cm3p::f32tile;
  __shared__ __align__(16) float smem[ft::SMEM_FLOATS];
  // with LN: the rows' statistics, and the LN scale and bias (768 at most)
  __shared__ float mu_s[ft::MT], rstd_s[ft::MT], scale_s[WITH_LN ? 768 : 1], bias_s[WITH_LN ? 768 : 1];
  const long long r0 = (long long)blockIdx.x * ft::MT;
  const int D = a.D;
  if (WITH_LN) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int c = threadIdx.x; c < D; c += ft::THREADS) scale_s[c] = a.scale[c], bias_s[c] = a.bias ? a.bias[c] : 0.f;
    for (int r = ft::MT / 8 * warp; r < ft::MT / 8 * (warp + 1); ++r) {
      float4 v[6];
      float mu = 0.f, rstd = 1.f;
      if (r0 + r < a.R) ln_moments(a.x + (r0 + r) * D, D, a.eps, lane, v, mu, rstd);
      if (lane == 0) mu_s[r] = mu, rstd_s[r] = rstd;
    }
    __syncthreads();
  }
  // A: x (rows past R read as zeros), normalised with LN as it is staged (ln_row's expression)
  auto load_a = [&](int row, int k) {
    if (r0 + row >= a.R) return make_float4(0.f, 0.f, 0.f, 0.f);
    return __ldg(reinterpret_cast<const float4*>(a.x + (r0 + row) * D + k));
  };
  auto stage_a = [&](int row, int k, float4 v) {
    if (WITH_LN) {
      const float mu = mu_s[row], rstd = rstd_s[row];
      v.x = (v.x - mu) * (rstd * scale_s[k]) + bias_s[k];
      v.y = (v.y - mu) * (rstd * scale_s[k + 1]) + bias_s[k + 1];
      v.z = (v.z - mu) * (rstd * scale_s[k + 2]) + bias_s[k + 2];
      v.w = (v.w - mu) * (rstd * scale_s[k + 3]) + bias_s[k + 3];
    }
    return v;
  };
  auto store = [&](int n0, const float (&acc)[ft::RI][8]) {
#pragma unroll
    for (int i = 0; i < ft::RI; ++i) {
      const long long r = r0 + ft::sum_row(i);
      if (r >= a.R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + ft::sum_col(4 * h);
        float4 o = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (a.residual != nullptr) {
          const float4 res = __ldg(reinterpret_cast<const float4*>(a.residual + r * a.N + n));
          o = make_float4(res.x + o.x, res.y + o.y, res.z + o.z, res.w + o.w);
        }
        *reinterpret_cast<float4*>(a.out + r * a.N + n) = o;
      }
    }
  };
  ft::row_tile_product(load_a, stage_a, reinterpret_cast<const float*>(a.w), a.N, D, smem, store);
}

template <bool WITH_LN>
__global__ void __launch_bounds__(THREADS) ln_matmul_q_kernel(const Args a) {
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
    __syncwarp();
    const float s = quant_row(y + r * D, D, yq + r * D,
                              a.codes_out != nullptr && r0 + r < a.R ? a.codes_out + (r0 + r) * D : nullptr, lane);
    if (lane == 0) sa[r] = s;
  }
  __syncthreads();
  const int kwords = D / 4;
  for (int n0 = 0; n0 < a.N; n0 += NT) {
    int acc[2][4] = {};
    tile_product<true>(acc, reinterpret_cast<const uint32_t*>(yq), kwords, a.w, n0, n0 + 64, kwords, stage);
    const int n = n0 + 4 * lane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r0 + r >= a.R) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (float)acc[i][j] * sa[r] * a.sw[n + j];
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
  if (!INT8) {
    const long long blocks = (a.R + cm3p::f32tile::MT - 1) / cm3p::f32tile::MT;
    ln_matmul_kernel<WITH_LN><<<(unsigned)blocks, cm3p::f32tile::THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int bytes = smem_words(a.D) * 4;
  const void* kernel = (const void*)ln_matmul_q_kernel<WITH_LN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.R + RT - 1) / RT;
  ln_matmul_q_kernel<WITH_LN><<<(unsigned)blocks, THREADS, bytes, (cudaStream_t)stream>>>(a);
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
