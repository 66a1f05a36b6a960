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
// first version (16-row tiles: six such loads per 32 FMAs, W
// read once per 16 rows) ran at 23-25 % of that rate, below one torch.addmm.
// Tried and measured (compare_kernels.py --phase f32parts, PERF.md §6): a
// copy without the slices' loads and stores (products alone, wrong sums) runs
// at 61 % (Wo form) and 69 % (LN form) of the fp32 rate, so the FMA loop at
// the 128-register cap of two blocks an SM sets the pace (ptxas spills a few
// registers); one block an SM (no spills) was 38 % slower, 8 values of K a
// slice 27 % slower (twice the barriers). Normalising A as it was fetched
// stalled the products on each load; it is normalised as it is staged.
// Int8 forms (f32::ln_matmul_q_kernel<WITH_LN>): one block of 256 threads per
// 128-row tile, two blocks an SM. In a front end each warp takes 16 of the
// rows, two at a time (both rows' loads in flight together): the row's mean
// and rstd as above, its values by ln_row's expression, its amax and scale,
// and its codes (rows_f32.cuh quant4: the true division's codes) into the
// block's resident 128 x D code tile (swizzled) and codes_out. Then the block
// walks over N in 128 x 128 tiles (rows_f32.cuh f32tile::row_tile_product_s8:
// int8 mma.sync with exact int32 sums, W through two cp.async stages of 64
// bytes of K) and each epilogue writes float(acc) * sa * sw (+ residual) with
// float4 stores. The codes and sums are the first version's (dp4a on 16-row
// tiles), so the outputs are too, bit for bit. Bound on the H100: bytes (fp32
// x in, fp32 out, the residual). Measured (compare_kernels.py --phase
// f32parts, PERF.md §6): the products alone take a fraction of the time; the
// front end and the epilogue's stores, which one block runs one after the
// other, set the pace, and a second block an SM overlaps them with its
// products (four stages at one block an SM were 17-19 % slower). Staging the
// output in shared memory and writing it by 128-byte bulk copies was slower
// still, and four front-end rows in flight did not help.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_f32.cuh"

namespace {

namespace f32 {

namespace ft = cm3p::f32tile;
using namespace cm3p::f32rows;

struct Args {
  const float* x;          // (R, D)
  const float* scale;      // (D,) LN, or null without LN
  const float* bias;       // (D,) or null
  const void* w;           // (N, D) fp32, or (N, D) int8 codes
  const float* sw;         // (N,) weight scales, int8 form only
  const float* residual;   // (R, N) or null
  float* out;              // (R, N)
  int8_t* codes_out;       // (R, D) or null
  long long R;
  int D, N;
  float eps;
};

// cp.async stages of the int8 product: two, so that two blocks fit on an SM at D 768 (96 KB of codes and 16 KB of
// stages each), which overlaps one block's front end and stores with the other's products
constexpr int Q_STAGES = 2;
constexpr int FRONT_ROWS = 2;  // rows a warp of the int8 front end has in flight

// the resident code tile, the product's stages, the rows' scales
__host__ __device__ constexpr int q_smem_bytes(int D) { return ft::MT * D + Q_STAGES * ft::S8_STAGE + ft::MT * 4; }

template <bool WITH_LN>
__global__ void __launch_bounds__(ft::THREADS, 2) ln_matmul_kernel(const Args a) {  // 128 registers
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
  auto store = [&](int tile, const float (&acc)[ft::RI][8]) {
#pragma unroll
    for (int i = 0; i < ft::RI; ++i) {
      const long long r = r0 + ft::sum_row(i);
      if (r >= a.R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tile * ft::NT + ft::sum_col(4 * h);
        float4 o = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (a.residual != nullptr) {
          const float4 res = __ldg(reinterpret_cast<const float4*>(a.residual + r * a.N + n));
          o = make_float4(res.x + o.x, res.y + o.y, res.z + o.z, res.w + o.w);
        }
        *reinterpret_cast<float4*>(a.out + r * a.N + n) = o;
      }
    }
  };
  auto w_row = [](int tile, int c) { return (long long)(tile * ft::NT + c); };
  ft::row_tile_product(load_a, stage_a, static_cast<const float*>(a.w), w_row, a.N / ft::NT, D, smem, store);
}

template <bool WITH_LN>
__global__ void __launch_bounds__(ft::THREADS, 2) ln_matmul_q_kernel(const Args a) {  // 128 registers
  extern __shared__ __align__(128) uint4 smem4[];
  const int D = a.D;
  int8_t* codes = reinterpret_cast<int8_t*>(smem4);  // MT x D, resident (rows_f32.cuh resident_off)
  int8_t* stages = codes + ft::MT * D;
  float* sa_s = reinterpret_cast<float*>(stages + Q_STAGES * ft::S8_STAGE);  // the rows' scales
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * ft::MT;
  // front end: warp w takes rows 16 w .. + 15, FRONT_ROWS at a time
  for (int r = 16 * warp; r < 16 * warp + 16; r += FRONT_ROWS) {
    float4 v[FRONT_ROWS][6];
#pragma unroll
    for (int u = 0; u < FRONT_ROWS; ++u) {
      if (r0 + r + u < a.R) {
        load_row(a.x + (r0 + r + u) * D, D, lane, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) v[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < FRONT_ROWS; ++u) {
      const bool live = r0 + r + u < a.R;
      float mu = 0.f, rstd = 1.f;
      if (WITH_LN && live) row_moments(v[u], D, a.eps, lane, mu, rstd);
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int c = 4 * lane + 128 * i;
        if (c >= D) break;
        if (WITH_LN && live) {  // ln_row's expression
          float e[4] = {v[u][i].x, v[u][i].y, v[u][i].z, v[u][i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = (e[j] - mu) * (rstd * a.scale[c + j]) + (a.bias ? a.bias[c + j] : 0.f);
          v[u][i] = make_float4(e[0], e[1], e[2], e[3]);
        }
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[u][i].x), fabsf(v[u][i].y)), fmaxf(fabsf(v[u][i].z), fabsf(v[u][i].w))));
      }
      const float sa = fmaxf(warp_max(amax), 1e-30f) * cm3p::kInv127, inv = 1.f / sa;
      int8_t* codes_row = a.codes_out != nullptr && live ? a.codes_out + (r0 + r + u) * D : nullptr;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int c = 4 * lane + 128 * i;
        if (c >= D) break;
        const uint32_t q = live ? quant4(v[u][i], sa, inv) : 0u;
        *reinterpret_cast<uint32_t*>(codes + ft::resident_off(r + u, c, D)) = q;
        if (codes_row != nullptr) *reinterpret_cast<uint32_t*>(codes_row + c) = q;
      }
      if (lane == 0) sa_s[r + u] = sa;
    }
  }
  __syncthreads();
  auto store = [&](int tile, const int (&acc)[2][8][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ft::s8_row(mi, h);
        if (r0 + r >= a.R) continue;
        const float s = sa_s[r];
        float* out_row = a.out + (r0 + r) * a.N;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int n = tile * ft::NT + ft::s8_col(p);
          const int4 q = ft::s8_quad(acc, mi, h, p);
          const float4 w = __ldg(reinterpret_cast<const float4*>(a.sw + n));
          float4 o = make_float4((float)q.x * s * w.x, (float)q.y * s * w.y, (float)q.z * s * w.z, (float)q.w * s * w.w);
          if (a.residual != nullptr) {
            const float4 res = __ldg(reinterpret_cast<const float4*>(a.residual + (r0 + r) * a.N + n));
            o = make_float4(res.x + o.x, res.y + o.y, res.z + o.z, res.w + o.w);
          }
          *reinterpret_cast<float4*>(out_row + n) = o;
        }
      }
  };
  auto w_row = [](int tile, int c) { return (long long)(tile * ft::NT + c); };
  ft::row_tile_product_s8<Q_STAGES, true>(codes, D, static_cast<const int8_t*>(a.w), w_row, a.N / ft::NT,
                                          stages, store);
}

template <bool WITH_LN, bool INT8>
int launch_form(const Args& a, void* stream) {
  const long long blocks = (a.R + ft::MT - 1) / ft::MT;
  if (!INT8) {
    ln_matmul_kernel<WITH_LN><<<(unsigned)blocks, ft::THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int bytes = q_smem_bytes(a.D);
  const void* kernel = (const void*)ln_matmul_q_kernel<WITH_LN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ln_matmul_q_kernel<WITH_LN><<<(unsigned)blocks, ft::THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool INT8>
int launch(const Args& a, int with_ln, void* stream) {
  if (a.R <= 0 || a.R > (long long)ft::MT * 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((a.D != 256 && a.D != 512 && a.D != 768) || a.N <= 0 || a.N % ft::NT) return (int)cudaErrorInvalidValue;
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
  const f32::Args a{(const float*)x, (const float*)scale, (const float*)bias, w, nullptr,
                    (const float*)residual, (float*)out, nullptr, R, D, N, eps};
  return f32::launch<false>(a, with_ln, stream);
}

// The int8 form: wq (N, D) int8 codes, sw (N,) fp32 scales; codes_out (R, D)
// int8 or null.
extern "C" int cm3p_ln_matmul_q_f32(const void* x, const void* scale, const void* bias, const void* wq,
                                    const void* sw, const void* residual, void* out, void* codes_out, long long R,
                                    int D, int N, float eps, int with_ln, void* stream) {
  const f32::Args a{(const float*)x, (const float*)scale, (const float*)bias, wq,
                    (const float*)sw, (const float*)residual, (float*)out, (int8_t*)codes_out, R, D, N, eps};
  return f32::launch<true>(a, with_ln, stream);
}
