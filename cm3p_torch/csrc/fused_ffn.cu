// Fused LayerNorm + GeGLU half-block for Hopper, bf16 in and out:
//     out = x + Wo( gelu_erf(a) * b ),   [a | b] = Wi( LN_fp32(x) )
//
// Replaces the TPU kernel of the JAX package's ops/fused_ffn.py _ffn_kernel (driven by
// _pallas_ln_ffn), at the three tower widths DM = 768 (beatmap), 512 (audio)
// and 256 (metadata): fused_ln_ffn_kernel is its bf16 form (row 3),
// w8a8::ffn_kernel its w8a8 form with an int8 Wi (row 3q, the extraction
// tool's default; designed for Hopper, note below), and fused_ln_ffn_q_kernel
// (with its own note further down) the forms with an int8 Wo (w8a8_wo, alone
// or with w8a8). The training path runs neither: under autograd
// the layer runs the plain composition and its analytic backward
// (ops/fused_ffn.py), as the JAX package does.
//
// Rounding points kept from the TPU kernel: LN statistics and output in
// fp32 (flax formula, var = E[x^2] - E[x]^2), LN output cast to bf16 before
// Wi, h = Wi(y) accumulated in fp32 and cast to bf16, gelu(a) * b in fp32
// then cast to bf16 before Wo, Wo accumulated in fp32 and cast to bf16,
// residual added to that bf16 value and rounded once more.
//
// Design: the TPU kernel keeps the (rows, 2F) intermediate in VMEM; on the
// H100 64 rows of it (295 KB at F = 1152) do not fit a block's 227 KB of
// shared memory, so the intermediate is chunked over F instead. A block of
// 8 warps owns 32 rows and the whole (32, DM) output accumulator in
// registers. For each chunk of 64 columns of a (and the matching 64 of b):
//   1. h_chunk (32 x 128) = y (32 x DM, bf16 in smem) . Wi_chunk^T, with Wi
//      staged through smem 64 columns of DM at a time;
//   2. g = bf16(gelu(bf16(a)) * bf16(b)) into smem (32 x 64);
//   3. acc (32 x DM) += g . Wo[:, chunk]^T, with the Wo chunk staged in smem.
// The intermediate never reaches device memory. Products are mma.sync
// m16n8k16 bf16 with fp32 accumulation.
// Bound on the H100: 6 * rows * DM * F flops against 4 * rows * DM bytes of
// activations, about 1,700 flops per byte at DM = 768: bound by the tensor
// cores (with an int8 Wi: 4 R DM F int8 operations and 2 R DM F bf16 flops,
// 1.16 ms at 323,584 rows, DM 768, F 1152). This first kernel (row 3, and
// fused_ln_ffn_q_kernel) re-reads both weight matrices from L2 for every 32
// rows and does not overlap loads with products, so it runs well below it.
//
// The w8a8 form for Hopper (w8a8::ffn_kernel). Persistent blocks of 384
// threads, one per SM, in clusters of two; a cluster walks pairs of 64-row
// tiles x NO output columns (NO = 384 at DM 768, so two column tiles per 64
// rows; DM at 512 and 256). A producer warp feeds two TMA rings in the order
// they are read: Wi stages of 64 a-rows and 64 b-rows x 128 DM bytes (16 KB;
// 4 stages, 3 at DM 512) and Wo stages of NO rows x one 64-column F chunk (2
// slots); each CTA of the cluster loads half of every stage and multicasts it
// to both, so L2 serves each weight byte once per 128 rows. Two consumer
// warpgroups share the tile's 64 rows. The front end normalises each row in
// fp32 (a warp per row, as row 3), quantises it and writes its int8 codes in
// wgmma's swizzled layout (codes_y from the first column tile only). The F
// chunks alternate between the warpgroups: the owner of chunk c runs its Wi
// product as wgmma m64n128k32 s8 x s8 -> s32 (exact; a- and b-columns side by
// side, 64 registers), turns it into g = bf16(gelu(bf16(h_a)) * bf16(h_b)) in
// registers and writes the 64 x 64 bf16 g tile, while the other warpgroup
// does the same for chunk c + 1; both multiply each g tile by their NO / 2 rows
// of the Wo chunk (wgmma m64nNk16 bf16, N = 192 / 256 / 128, fp32 accumulators
// held across all of F: 96 / 128 / 64 registers; setmaxnreg gives consumers
// 232). So one warpgroup's GeGLU overlaps the other's products. g tiles are
// double-buffered between mbarriers (written, and freed by both). Both
// warpgroups wait on the one Wi ring; a parity wait tells apart only two
// phases of a stage, so a warpgroup starts on its chunk only once the other
// has seen the previous chunk's stages arrive (without that, under time
// slicing between processes, one could run two phases ahead and hang). Why two
// column tiles at DM 768: the fp32 accumulator of 64 rows x 768 columns is
// 49,152 registers, three quarters of an SM's, which cannot sit beside the Wi
// product's; the price is the Wi product (int8, at twice the bf16 rate) run
// twice. What holds it below the bound: the weights are streamed from L2 for
// every 128 rows (Wi twice at DM 768), a stage in flight per 16 KB of int8
// product keeps the ring short of the latency, and the exact erff GeGLU is
// ALU work of the same order as the products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_rows.cuh"
#include "sm90.cuh"

namespace {

using namespace cm3p;

constexpr int BR = 32;          // rows per block
constexpr int NTHREADS = 256;   // 8 warps: 2 row groups x 4 column groups
constexpr int FC = 64;          // F chunk (columns of a; the same of b)
constexpr int KS = 64;          // DM slice staged per step of the Wi product
constexpr int LDW = 64 + 8;     // padded smem row of a staged weight slice

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

template <int DM>
constexpr int smem_bytes() {
  return (BR * (DM + 8) + 2 * FC * LDW + BR * LDW + DM * LDW) * 2;
}

template <int DM>
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_ln_ffn_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, const __nv_bfloat16* __restrict__ wi,
                        const __nv_bfloat16* __restrict__ wo, __nv_bfloat16* __restrict__ out,
                        int R, int F, float eps) {
  constexpr int LDY = DM + 8;
  constexpr int NT = DM / 32;  // n-tiles of 8 output columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);                 // BR x LDY   LN output
  __nv_bfloat16* sWi = sY + BR * LDY;        // 2FC x LDW  Wi slice: a rows, then b rows
  __nv_bfloat16* sG = sWi + 2 * FC * LDW;    // BR x LDW   gelu(a) * b
  __nv_bfloat16* sWo = sG + BR * LDW;        // DM x LDW   Wo[:, chunk]

  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- LayerNorm: each warp normalises 4 rows into sY (bf16)
  for (int rr = warp; rr < BR; rr += NTHREADS / 32) {
    const int row = row0 + rr;
    if (row < R) {
      const __nv_bfloat16* xr = x + (long long)row * DM;
      float2 v[DM / 64];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < DM / 64; ++i) {
        v[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i * 64 + lane * 2));
        s1 += v[i].x + v[i].y;
        s2 += v[i].x * v[i].x + v[i].y * v[i].y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffff, s1, off);
        s2 += __shfl_xor_sync(0xffffffff, s2, off);
      }
      const float mu = s1 / DM;
      const float var = fmaxf(s2 / DM - mu * mu, 0.f);
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < DM / 64; ++i) {
        const int c = i * 64 + lane * 2;
        const float b0 = bias ? bias[c] : 0.f, b1 = bias ? bias[c + 1] : 0.f;
        const float y0 = (v[i].x - mu) * (rstd * scale[c]) + b0;
        const float y1 = (v[i].y - mu) * (rstd * scale[c + 1]) + b1;
        *reinterpret_cast<uint32_t*>(sY + rr * LDY + c) = pack_bf16(y0, y1);
      }
    } else {
      for (int c = lane * 2; c < DM; c += 64)
        *reinterpret_cast<uint32_t*>(sY + rr * LDY + c) = 0u;
    }
  }

  const int rg = warp & 1;   // rows rg*16 .. rg*16+15
  const int cg = warp >> 1;  // column group 0..3
  const int ar = rg * 16;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    // ---- 1. h chunk: this warp owns a-columns cg*16..cg*16+15 of the chunk
    //         (n-tiles 0, 1) and the same b-columns (n-tiles 2, 3)
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i][0] = h[i][1] = h[i][2] = h[i][3] = 0.f;
    for (int k0 = 0; k0 < DM; k0 += KS) {
      __syncthreads();
      for (int item = threadIdx.x; item < 2 * FC * (KS / 8); item += NTHREADS) {
        const int r = item / (KS / 8);
        const int c = (item % (KS / 8)) * 8;
        const int wrow = r < FC ? f0 + r : F + f0 + (r - FC);
        *reinterpret_cast<uint4*>(sWi + r * LDW + c) =
            *reinterpret_cast<const uint4*>(wi + (long long)wrow * DM + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        uint32_t af[4];
        const __nv_bfloat16* yp = sY + (ar + g) * LDY + k0 + ks * 16 + t * 2;
        af[0] = lds32(yp);
        af[1] = lds32(yp + 8 * LDY);
        af[2] = lds32(yp + 8);
        af[3] = lds32(yp + 8 * LDY + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int wr = (nt < 2 ? 0 : FC) + cg * 16 + (nt & 1) * 8 + g;
          const __nv_bfloat16* wp = sWi + wr * LDW + ks * 16 + t * 2;
          mma_bf16(h[nt], af, lds32(wp), lds32(wp + 8));
        }
      }
    }
    // ---- 2. g = bf16(gelu(a) * b) with a, b rounded to bf16 first
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float a0 = bf16_round(h[nt][2 * hr]), a1 = bf16_round(h[nt][2 * hr + 1]);
        const float b0 = bf16_round(h[nt + 2][2 * hr]), b1 = bf16_round(h[nt + 2][2 * hr + 1]);
        const int r = ar + g + hr * 8;
        const int c = cg * 16 + nt * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(sG + r * LDW + c) =
            pack_bf16(gelu_erf(a0) * b0, gelu_erf(a1) * b1);
      }
    }
    // stage Wo[:, f0:f0+64] as DM rows of 64
    for (int item = threadIdx.x; item < DM * (FC / 8); item += NTHREADS) {
      const int r = item / (FC / 8);
      const int c = (item % (FC / 8)) * 8;
      *reinterpret_cast<uint4*>(sWo + r * LDW + c) =
          *reinterpret_cast<const uint4*>(wo + (long long)r * F + f0 + c);
    }
    __syncthreads();
    // ---- 3. acc += g . Wo_chunk^T over this warp's DM/4 output columns
#pragma unroll
    for (int ks = 0; ks < FC / 16; ++ks) {
      uint32_t af[4];
      const __nv_bfloat16* gp = sG + (ar + g) * LDW + ks * 16 + t * 2;
      af[0] = lds32(gp);
      af[1] = lds32(gp + 8 * LDW);
      af[2] = lds32(gp + 8);
      af[3] = lds32(gp + 8 * LDW + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* wp = sWo + (cg * (DM / 4) + nt * 8 + g) * LDW + ks * 16 + t * 2;
        mma_bf16(acc[nt], af, lds32(wp), lds32(wp + 8));
      }
    }
  }

  // ---- epilogue: out = x + bf16(acc), rounded to bf16
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + ar + g + hr * 8;
    if (row >= R) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = cg * (DM / 4) + nt * 8 + t * 2;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (long long)row * DM + c));
      const float o0 = bf16_round(acc[nt][2 * hr]), o1 = bf16_round(acc[nt][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(out + (long long)row * DM + c) = pack_bf16(xv.x + o0, xv.y + o1);
    }
  }
}

template <int DM>
int launch(const void* x, const void* scale, const void* bias, const void* wi, const void* wo,
           void* out, int R, int F, float eps, void* stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(fused_ln_ffn_kernel<DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BR - 1) / BR;
  fused_ln_ffn_kernel<DM><<<blocks, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias,
      (const __nv_bfloat16*)wi, (const __nv_bfloat16*)wo, (__nv_bfloat16*)out, R, F, eps);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The forms with an int8 Wo (w8a8_wo; with w8a8 also an int8 Wi): the int8
// Wo is always on here, QI selects the int8 Wi. The w8a8 form alone runs
// w8a8::ffn_kernel below.
//
// QI (w8a8): the fp32 LN row is quantised per row over all DM columns (the
// warp that normalises a row holds it in registers, so the absmax is a warp
// shuffle) and Wi is int8 per output channel; h = bf16(float(acc) * sa * swi)
// with the int32 accumulator exact. The GeGLU follows as in the bf16 form.
// int8 Wo (w8a8_wo): the fp32 gelu(a) * b row is quantised per row over all F
// columns and Wo is int8; o = bf16(float(acc) * sg * swo).
//
// The row scale sg needs the absmax over all F columns, but this kernel never
// holds the (rows, F) intermediate: it walks F in chunks of 64. Holding 32
// rows of fp32 gelu(a) * b would take 147 KB of shared memory at F = 1152
// beside the operand rows and the staged weights, and 16-row blocks would halve
// the work per staged weight byte. So the chunk loop runs twice: pass 0
// recomputes h and gelu(a) * b only to find each row's absmax (registers, then
// an atomicMax per row in shared memory), pass 1 recomputes them, quantises
// with the now known scale and accumulates the int8 Wo product in int32 (exact,
// so the chunk order does not matter). Both passes run the same instructions
// on the same operands, so the values quantised are the values measured. The
// price is the Wi product twice (10 instead of 6 R DM F operations, 4 of
// them doubled), paid only in the w8a8_wo form.
template <int DM, bool QI>
constexpr int smem_bytes_q() {
  return (QI ? BR * (DM + 16) : BR * (DM + 8) * 2) + 2 * FC * LDW * 2 + BR * LDW * 2 + DM * (FC + 16) +
         2 * BR * 4;
}

template <int DM, bool QI>
__global__ void __launch_bounds__(NTHREADS, 1)
    fused_ln_ffn_q_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, const void* __restrict__ wi_raw,
                          const float* __restrict__ swi, const void* __restrict__ wo_raw,
                          const float* __restrict__ swo, __nv_bfloat16* __restrict__ out,
                          int8_t* __restrict__ codes_y, int8_t* __restrict__ codes_g, int R, int F,
                          float eps) {
  constexpr int LDY = DM + 8;        // bf16 operand row (elements)
  constexpr int LDQ = DM + 16;       // int8 operand row (bytes)
  constexpr int KSI = QI ? 128 : KS;  // DM slice staged per step of the Wi product
  constexpr int LDWI = LDW * 2;      // staged Wi row in bytes (64 bf16 + 8, or 128 int8 + 16)
  constexpr int LDG = FC + 16;       // row of int8 gelu(a) * b codes in bytes
  constexpr int LDO = LDG;           // staged Wo row in bytes
  constexpr int NT = DM / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sA = smem_raw;                                   // BR operand rows (bf16 or int8)
  unsigned char* sWi = sA + (QI ? BR * LDQ : BR * LDY * 2);       // 2FC x LDWI
  unsigned char* sG = sWi + 2 * FC * LDWI;                        // BR x LDG (space for LDW * 2)
  unsigned char* sWo = sG + BR * LDW * 2;                         // DM x LDO
  float* sSa = reinterpret_cast<float*>(sWo + DM * LDO);          // BR  LN row scales
  unsigned int* sMax = reinterpret_cast<unsigned int*>(sSa + BR); // BR  absmax of gelu(a) * b (bits)

  const __nv_bfloat16* wi = reinterpret_cast<const __nv_bfloat16*>(wi_raw);
  const int8_t* wiq = reinterpret_cast<const int8_t*>(wi_raw);
  const int8_t* woq = reinterpret_cast<const int8_t*>(wo_raw);

  const int row0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // ---- LayerNorm: each warp normalises 4 rows; int8 codes or bf16 into sA
  for (int rr = warp; rr < BR; rr += NTHREADS / 32) {
    const int row = row0 + rr;
    if (lane == 0) sMax[rr] = 0u;
    if (row < R) {
      float2 y[DM / 64];
      ln_row_f32<DM>(x + (long long)row * DM, scale, bias, eps, lane, y);
      if (QI) {
        const float sa = quant_row_int8<DM>(y, lane, reinterpret_cast<int8_t*>(sA) + rr * LDQ,
                                            codes_y ? codes_y + (long long)row * DM : nullptr);
        if (lane == 0) sSa[rr] = sa;
      } else {
#pragma unroll
        for (int i = 0; i < DM / 64; ++i)
          *reinterpret_cast<uint32_t*>(sA + (rr * LDY + i * 64 + lane * 2) * 2) =
              pack_bf16(y[i].x, y[i].y);
      }
    } else {
      constexpr int row_bytes = QI ? LDQ : LDY * 2;
      for (int c = lane * 16; c < row_bytes; c += 512)
        *reinterpret_cast<uint4*>(sA + rr * row_bytes + c) = make_uint4(0u, 0u, 0u, 0u);
      if (lane == 0) sSa[rr] = 0.f;
    }
  }

  const int rg = warp & 1;   // rows rg*16 .. rg*16+15
  const int cg = warp >> 1;  // column group 0..3
  const int ar = rg * 16;

  int acci[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acci[i][0] = acci[i][1] = acci[i][2] = acci[i][3] = 0;
  float gmax[2] = {0.f, 0.f};  // pass 0: this thread's absmax for rows ar+g, ar+g+8
  float sg[2] = {1.f, 1.f};    // pass 1: those rows' scales

  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float m = gmax[hr];
        m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffff, m, 2));
        if (t == 0) atomicMax(&sMax[ar + g + hr * 8], __float_as_uint(m));
      }
      __syncthreads();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        sg[hr] = fmaxf(__uint_as_float(sMax[ar + g + hr * 8]), 1e-30f) * kInv127;
    }
    for (int f0 = 0; f0 < F; f0 += FC) {
      // ---- 1. h chunk: this warp owns a-columns cg*16..cg*16+15 of the chunk
      //         (n-tiles 0, 1) and the same b-columns (n-tiles 2, 3)
      float h[4][4];
      int hi[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i][0] = h[i][1] = h[i][2] = h[i][3] = 0.f;
        hi[i][0] = hi[i][1] = hi[i][2] = hi[i][3] = 0;
      }
      for (int k0 = 0; k0 < DM; k0 += KSI) {
        __syncthreads();
        // 2FC rows (a rows, then b rows) x 128 bytes of Wi, either type
        for (int item = threadIdx.x; item < 2 * FC * 8; item += NTHREADS) {
          const int r = item / 8;
          const int c = (item % 8) * 16;
          const long long wrow = r < FC ? f0 + r : F + f0 + (r - FC);
          const unsigned char* src = QI ? reinterpret_cast<const unsigned char*>(wiq + wrow * DM + k0)
                                        : reinterpret_cast<const unsigned char*>(wi + wrow * DM + k0);
          *reinterpret_cast<uint4*>(sWi + r * LDWI + c) = *reinterpret_cast<const uint4*>(src + c);
        }
        __syncthreads();
        if (QI) {
#pragma unroll
          for (int ks = 0; ks < KSI / 32; ++ks) {
            uint32_t af[4];
            const unsigned char* qp = sA + (ar + g) * LDQ + k0 + ks * 32 + t * 4;
            af[0] = lds32(qp);
            af[1] = lds32(qp + 8 * LDQ);
            af[2] = lds32(qp + 16);
            af[3] = lds32(qp + 8 * LDQ + 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int wr = (nt < 2 ? 0 : FC) + cg * 16 + (nt & 1) * 8 + g;
              const unsigned char* wp = sWi + wr * LDWI + ks * 32 + t * 4;
              mma_s8(hi[nt], af, lds32(wp), lds32(wp + 16));
            }
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < KSI / 16; ++ks) {
            uint32_t af[4];
            const unsigned char* yp = sA + ((ar + g) * LDY + k0 + ks * 16 + t * 2) * 2;
            af[0] = lds32(yp);
            af[1] = lds32(yp + 8 * LDY * 2);
            af[2] = lds32(yp + 16);
            af[3] = lds32(yp + 8 * LDY * 2 + 16);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int wr = (nt < 2 ? 0 : FC) + cg * 16 + (nt & 1) * 8 + g;
              const unsigned char* wp = sWi + wr * LDWI + (ks * 16 + t * 2) * 2;
              mma_bf16(h[nt], af, lds32(wp), lds32(wp + 16));
            }
          }
        }
      }
      if (QI) {
        // h = float(acc) * sa * swi[column], in that order
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = (nt < 2 ? 0 : F) + f0 + cg * 16 + (nt & 1) * 8 + t * 2;
          const float s0 = swi[col], s1 = swi[col + 1];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float sa = sSa[ar + g + hr * 8];
            h[nt][2 * hr] = (float)hi[nt][2 * hr] * sa * s0;
            h[nt][2 * hr + 1] = (float)hi[nt][2 * hr + 1] * sa * s1;
          }
        }
      }
      // ---- 2. gelu(a) * b in fp32, with a and b rounded to bf16 first
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float a0 = bf16_round(h[nt][2 * hr]), a1 = bf16_round(h[nt][2 * hr + 1]);
          const float b0 = bf16_round(h[nt + 2][2 * hr]), b1 = bf16_round(h[nt + 2][2 * hr + 1]);
          const float g0 = gelu_erf(a0) * b0, g1 = gelu_erf(a1) * b1;
          const int r = ar + g + hr * 8;
          const int c = cg * 16 + nt * 8 + t * 2;
          if (pass == 0) {
            gmax[hr] = fmaxf(gmax[hr], fmaxf(fabsf(g0), fabsf(g1)));
          } else {
            char2 q;
            q.x = (signed char)quant_code(g0, sg[hr]);
            q.y = (signed char)quant_code(g1, sg[hr]);
            *reinterpret_cast<char2*>(sG + r * LDG + c) = q;
            if (codes_g && row0 + r < R)
              *reinterpret_cast<char2*>(codes_g + (long long)(row0 + r) * F + f0 + c) = q;
          }
        }
      }
      if (pass == 0) continue;
      // stage Wo[:, f0:f0+64] as DM rows of 64 codes
      for (int item = threadIdx.x; item < DM * (FC / 16); item += NTHREADS) {
        const int r = item / (FC / 16);
        const int c = (item % (FC / 16)) * 16;
        *reinterpret_cast<uint4*>(sWo + r * LDO + c) =
            *reinterpret_cast<const uint4*>(woq + (long long)r * F + f0 + c);
      }
      __syncthreads();
      // ---- 3. acc += g . Wo_chunk^T over this warp's DM/4 output columns
#pragma unroll
      for (int ks = 0; ks < FC / 32; ++ks) {
        uint32_t af[4];
        const unsigned char* gp = sG + (ar + g) * LDG + ks * 32 + t * 4;
        af[0] = lds32(gp);
        af[1] = lds32(gp + 8 * LDG);
        af[2] = lds32(gp + 16);
        af[3] = lds32(gp + 8 * LDG + 16);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* wp = sWo + (cg * (DM / 4) + nt * 8 + g) * LDO + ks * 32 + t * 4;
          mma_s8(acci[nt], af, lds32(wp), lds32(wp + 16));
        }
      }
    }
  }

  // ---- epilogue: out = x + bf16(o), rounded to bf16; o = float(acc) * sg * swo[column]
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + ar + g + hr * 8;
    if (row >= R) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = cg * (DM / 4) + nt * 8 + t * 2;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (long long)row * DM + c));
      const float o0 = bf16_round((float)acci[nt][2 * hr] * sg[hr] * swo[c]);
      const float o1 = bf16_round((float)acci[nt][2 * hr + 1] * sg[hr] * swo[c + 1]);
      *reinterpret_cast<uint32_t*>(out + (long long)row * DM + c) = pack_bf16(xv.x + o0, xv.y + o1);
    }
  }
}

template <int DM, bool QI>
int launch_q(const void* x, const void* scale, const void* bias, const void* wi, const void* swi,
             const void* wo, const void* swo, void* out, void* codes_y, void* codes_g, int R, int F,
             float eps, void* stream) {
  constexpr int bytes = smem_bytes_q<DM, QI>();
  cudaError_t err = cudaFuncSetAttribute(fused_ln_ffn_q_kernel<DM, QI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BR - 1) / BR;
  fused_ln_ffn_q_kernel<DM, QI><<<blocks, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, wi, (const float*)swi, wo,
      (const float*)swo, (__nv_bfloat16*)out, (int8_t*)codes_y, (int8_t*)codes_g, R, F, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The w8a8 form (int8 Wi, bf16 Wo): warp-specialised, persistent, TMA rings,
// wgmma (see the note at the top of the file).
namespace w8a8 {

constexpr int BM = 64;                 // rows per tile
constexpr int FC = 64;                 // F chunk: 64 columns of a and the same 64 of b
constexpr int KQ = 128;                // DM bytes of Wi per stage: one 128-byte swizzle row
constexpr int CM = 2;                  // CTAs of a cluster: consecutive row tiles sharing each weight stage
constexpr int WI_BYTES = 2 * FC * KQ;  // 16 KB: a rows, then b rows
constexpr int G_BYTES = BM * FC * 2;   // one bf16 g tile
constexpr int THREADS = 384;           // two consumer warpgroups + a producer warpgroup

template <int DM>
__host__ __device__ constexpr int out_cols() {  // output columns per tile; DM 768 takes two tiles per 64 rows
  return DM == 768 ? 384 : DM;
}
template <int DM>
__host__ __device__ constexpr int wi_stages() {
  return DM == 512 ? 3 : 4;
}
template <int DM>
__host__ __device__ constexpr int wo_bytes() {
  return out_cols<DM>() * FC * 2;
}
template <int DM>
constexpr int smem_bytes() {
  return 1024 + wi_stages<DM>() * WI_BYTES + 2 * wo_bytes<DM>() + BM * DM + 2 * G_BYTES + BM * 4 +
         (2 * wi_stages<DM>() + 10) * 8;
}

// acc (64 x NW) [+]= A (64 x 16) . B (NW x 16)^T over one K step, NW the warpgroup's output columns
template <int NW>
__device__ __forceinline__ void wgmma_wo(float (&acc)[NW / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (NW == 128) sm90::wgmma_bf16_n128(acc, da, db, scale_d);
  else if constexpr (NW == 192) sm90::wgmma_bf16_n192(acc, da, db, scale_d);
  else sm90::wgmma_bf16_n256(acc, da, db, scale_d);
}

template <int DM>
__global__ void __cluster_dims__(CM, 1, 1) __launch_bounds__(THREADS, 1)
    ffn_kernel(const __grid_constant__ CUtensorMap map_wi, const __grid_constant__ CUtensorMap map_wo,
               const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ swi, __nv_bfloat16* __restrict__ out,
               int8_t* __restrict__ codes_y, int R, int F, float eps) {
  using namespace sm90;
  constexpr int NO = out_cols<DM>(), NP = DM / NO, NW = NO / 2;  // NW: columns per consumer warpgroup
  constexpr int WIS = wi_stages<DM>(), KBQ = DM / KQ, WO_BYTES = wo_bytes<DM>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sWi = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sWo = sWi + WIS * WI_BYTES;      // 2 slots of NO rows x FC
  unsigned char* sQ = sWo + 2 * WO_BYTES;         // KBQ blocks of 64 rows x 128 codes
  unsigned char* sG = sQ + BM * DM;               // 2 g tiles
  float* sSa = reinterpret_cast<float*>(sG + 2 * G_BYTES);      // BM row scales
  uint64_t* wi_full = reinterpret_cast<uint64_t*>(sSa + BM);
  uint64_t* wi_empty = wi_full + WIS;  // every consumer warp of the cluster is done with the stage
  uint64_t* wo_full = wi_empty + WIS;
  uint64_t* wo_empty = wo_full + 2;
  uint64_t* g_ready = wo_empty + 2;  // g tile b written by the warpgroup that owns its chunk
  uint64_t* g_free = g_ready + 2;    // g tile b no longer read by either warpgroup's Wo product
  uint64_t* landed = g_free + 2;     // warpgroup w has seen the last Wi stage of its chunk arrive

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = cluster_ctarank();
  const int chunks = F / FC;
  const int items = ((R + BM - 1) / BM + CM - 1) / CM * NP;  // (CM row tiles, output columns) of a cluster
  const int cluster = blockIdx.x / CM, clusters = gridDim.x / CM;
  constexpr uint16_t ALL = (1 << CM) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIS; ++s) mbar_init(&wi_full[s], 1), mbar_init(&wi_empty[s], 4 * CM);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&wo_full[s], 1), mbar_init(&wo_empty[s], 8 * CM);
      mbar_init(&g_ready[s], 4), mbar_init(&g_free[s], 8), mbar_init(&landed[s], 4);
    }
    fence_mbar_init();
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or remote arrival reaches them

  if (warp >= 8) {  // producer warpgroup: one thread keeps both rings full, in the order they are read
    regs_dealloc<40>();
    if (warp == 8 && lane == 0) {
      int si = 0, so = 0;
      uint32_t pi = 0, po = 0;
      for (int item = cluster; item < items; item += clusters) {
        const int n0 = item % NP * NO;
        for (int c = 0; c < chunks; ++c) {
          for (int kb = 0; kb < KBQ; ++kb) {
            mbar_wait(&wi_empty[si], pi ^ 1);
            mbar_expect_tx(&wi_full[si], WI_BYTES);
            unsigned char* dst = sWi + si * WI_BYTES + rank * (FC / CM) * KQ;
            tma_load_2d_multicast(dst, &map_wi, &wi_full[si], kb * KQ, c * FC + rank * (FC / CM), ALL);
            tma_load_2d_multicast(dst + FC * KQ, &map_wi, &wi_full[si], kb * KQ, F + c * FC + rank * (FC / CM), ALL);
            if (++si == WIS) si = 0, pi ^= 1;
          }
          mbar_wait(&wo_empty[so], po ^ 1);
          mbar_expect_tx(&wo_full[so], WO_BYTES);
          unsigned char* dst = sWo + so * WO_BYTES + rank * (NW / CM) * 128;
          tma_load_2d_multicast(dst, &map_wo, &wo_full[so], c * FC, n0 + rank * (NW / CM), ALL);
          tma_load_2d_multicast(dst + NW * 128, &map_wo, &wo_full[so], c * FC, n0 + NW + rank * (NW / CM), ALL);
          if (++so == 2) so = 0, po ^= 1;
        }
      }
      // stay until every consumer of the cluster has released every stage: no remote
      // arrival may reach this CTA after it exits
      for (int s = 0; s < WIS; ++s) {
        mbar_wait(&wi_empty[si], pi ^ 1);
        if (++si == WIS) si = 0, pi ^= 1;
      }
      for (int s = 0; s < 2; ++s) {
        mbar_wait(&wo_empty[so], po ^ 1);
        if (++so == 2) so = 0, po ^= 1;
      }
    }
    return;
  }

  // consumers: both warpgroups share the tile's 64 rows. The chunks alternate between them:
  // warpgroup wg runs the Wi product and the GeGLU of chunks c = wg mod 2 (all 64 a- and b-columns),
  // while the other one does the same for its chunk; both multiply every chunk's g tile by their
  // NW output columns of Wo.
  regs_alloc<232>();
  const int wg = warp >> 2, wl = warp & 3;
  float acc[NW / 2];
  int h[64];  // h of the own chunk: a columns in blocks 0-7, b columns in blocks 8-15
  int so = 0;
  uint32_t po = 0;
  int gc = 0;  // chunks of earlier tiles: chunk c of this tile is the block's chunk gc + c
  const int other_per_tile = wg == 1 ? (chunks + 1) / 2 : chunks / 2;  // chunks of the other warpgroup in a tile
  auto release = [&](uint64_t* bar) {
    if (lane == 0)
      for (int q = 0; q < CM; ++q) mbar_arrive_cluster(bar, q);
  };
  for (int item = cluster; item < items; item += clusters) {
    const int m0 = (item / NP * CM + rank) * BM, p = item % NP, n0 = p * NO;
    // ---- front end: LN (fp32), per-row int8 codes into the swizzled sQ, row scales
    named_barrier(1, 256);  // both warpgroups are done with the previous tile's sQ and sSa
    for (int r = warp; r < BM; r += 8) {
      const int row = m0 + r;
      if (row < R) {
        float2 y[DM / 64];
        ln_row_f32<DM>(x + (long long)row * DM, scale, bias, eps, lane, y);
        int8_t* cy = codes_y && p == 0 ? codes_y + (long long)row * DM : nullptr;
        const float sa = quant_row_int8_each<DM>(y, lane, [&](int c, char2 q) {
          *reinterpret_cast<char2*>(sQ + (c >> 7) * (BM * 128) + swizzle128(r, c & 127)) = q;
          if (cy) *reinterpret_cast<char2*>(cy + c) = q;
        });
        if (lane == 0) sSa[r] = sa;
      } else {
        for (int c = lane * 4; c < DM; c += 128)
          *reinterpret_cast<uint32_t*>(sQ + (c >> 7) * (BM * 128) + swizzle128(r, c & 127)) = 0u;
        if (lane == 0) sSa[r] = 0.f;
      }
    }
    fence_proxy_async();
    named_barrier(1, 256);

    for (int c0 = 0; c0 < chunks; c0 += 2) {
      const int c = c0 + wg;  // this warpgroup's chunk
      if (c < chunks) {
        // Wi product of chunk c: h (64 x 128) = codes (64 x DM) . [Wi_a | Wi_b]^T, exact
        // The block's Wi stages run in chunk order, the other warpgroup's chunks taking their share. A
        // parity wait tells apart only two phases of a stage's barrier, so ours are waited on only after
        // the other warpgroup has seen the stages of chunk c - 1 arrive.
        if (c > 0) mbar_wait(&landed[1 - wg], ((gc / chunks) * other_per_tile + (c - 1) / 2) & 1);
        const int t0 = (gc + c) * KBQ;
        for (int kb = 0; kb < KBQ; ++kb) {
          const int si = (t0 + kb) % WIS;
          mbar_wait(&wi_full[si], ((t0 + kb) / WIS) & 1);
          if (kb == KBQ - 1 && lane == 0) mbar_arrive(&landed[wg]);
          wgmma_fence();
          const uint64_t da = desc_sw128(sQ + kb * (BM * 128)), db = desc_sw128(sWi + si * WI_BYTES);
#pragma unroll
          for (int k = 0; k < KQ / 32; ++k) wgmma_s8_n128(h, da + 2 * k, db + 2 * k, kb | k);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: hand it back
          if (kb > 0) release(&wi_empty[(t0 + kb - 1) % WIS]);
        }
        wgmma_wait<0>();
        fence_regs(h);
        release(&wi_empty[(t0 + KBQ - 1) % WIS]);
        // GeGLU into g tile b: h = float(acc) * sa * swi[column], in that order
        const int b = (gc + c) & 1, use = (gc + c) >> 1;
        if (use > 0) mbar_wait(&g_free[b], (use - 1) & 1);
        unsigned char* g = sG + b * G_BYTES;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = 16 * wl + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int cc = 8 * (i >> 2) + 2 * (lane & 3);  // column in the chunk
          const int col = c * FC + cc;
          const float sa = sSa[r];
          const float a0 = bf16_round((float)h[i] * sa * swi[col]);
          const float a1 = bf16_round((float)h[i + 1] * sa * swi[col + 1]);
          const float b0 = bf16_round((float)h[i + 32] * sa * swi[F + col]);
          const float b1 = bf16_round((float)h[i + 33] * sa * swi[F + col + 1]);
          *reinterpret_cast<uint32_t*>(g + swizzle128(r, 2 * cc)) = pack_bf16(gelu_erf(a0) * b0, gelu_erf(a1) * b1);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&g_ready[b]);
      }
      // Wo products of chunks c0 and c0 + 1, each from the g tile its owner wrote
      const int last = c0 + 2 < chunks ? c0 + 2 : chunks;
      for (int j = c0; j < last; ++j) {
        mbar_wait(&g_ready[(gc + j) & 1], ((gc + j) >> 1) & 1);
        mbar_wait(&wo_full[so], po);
        wgmma_fence();
        const uint64_t da = desc_sw128(sG + ((gc + j) & 1) * G_BYTES);
        const uint64_t db = desc_sw128(sWo + so * WO_BYTES + wg * NW * 128);
#pragma unroll
        for (int k = 0; k < FC / 16; ++k) wgmma_wo<NW>(acc, da + 2 * k, db + 2 * k, j | k);
        wgmma_commit();
        if (++so == 2) so = 0, po ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      for (int j = c0; j < last; ++j) {  // hand back their Wo slots and g tiles
        release(&wo_empty[(so + j - last) & 1]);
        if (lane == 0) mbar_arrive(&g_free[(gc + j) & 1]);
      }
    }
    gc += chunks;

    // ---- epilogue: out = x + bf16(acc), rounded to bf16
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + 16 * wl + (lane >> 2) + 8 * hr;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const long long at = (long long)row * DM + n0 + NW * wg + 8 * j + 2 * (lane & 3);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
        const float o0 = bf16_round(acc[4 * j + 2 * hr]), o1 = bf16_round(acc[4 * j + 2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(xv.x + o0, xv.y + o1);
      }
    }
  }
}

template <int DM>
int launch(const void* x, const void* scale, const void* bias, const void* wi, const void* swi, const void* wo,
           void* out, void* codes_y, int R, int F, float eps, void* stream) {
  CUtensorMap map_wi, map_wo;
  if (!make_map_2d(&map_wi, wi, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2LL * F, DM, FC / CM, KQ) ||
      !make_map_2d(&map_wo, wo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, DM, F, out_cols<DM>() / 2 / CM, FC))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes<DM>();
  const void* kernel = (const void*)ffn_kernel<DM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  static const int max_clusters = max_active_clusters(kernel, THREADS, bytes, CM);
  const int items = ((R + BM - 1) / BM + CM - 1) / CM * (DM / out_cols<DM>());
  ffn_kernel<DM><<<CM * (items < max_clusters ? items : max_clusters), THREADS, bytes, (cudaStream_t)stream>>>(
      map_wi, map_wo, (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (const float*)swi,
      (__nv_bfloat16*)out, (int8_t*)codes_y, R, F, eps);
  return (int)cudaGetLastError();
}

}  // namespace w8a8

template <int DM>
int dispatch_q(const void* x, const void* scale, const void* bias, const void* wi, const void* swi,
               const void* wo, const void* swo, void* out, void* codes_y, void* codes_g, int R, int F,
               float eps, int w8a8, int w8a8_wo, void* stream) {
  if (w8a8 && w8a8_wo)
    return launch_q<DM, true>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, stream);
  if (w8a8) return w8a8::launch<DM>(x, scale, bias, wi, swi, wo, out, codes_y, R, F, eps, stream);
  return launch_q<DM, false>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, stream);
}

}  // namespace

// x, out: (R, DM) bf16; scale, bias: (DM,) fp32 (bias may be null);
// wi: (2F, DM) bf16 (nn.Linear layout of Wi); wo: (DM, F) bf16.
extern "C" int cm3p_fused_ln_ffn(const void* x, const void* scale, const void* bias,
                                 const void* wi, const void* wo, void* out, int R, int DM, int F,
                                 float eps, void* stream) {
  if (R <= 0 || F <= 0 || F % FC != 0) return (int)cudaErrorInvalidValue;
  if (DM == 768) return launch<768>(x, scale, bias, wi, wo, out, R, F, eps, stream);
  if (DM == 512) return launch<512>(x, scale, bias, wi, wo, out, R, F, eps, stream);
  if (DM == 256) return launch<256>(x, scale, bias, wi, wo, out, R, F, eps, stream);
  return (int)cudaErrorInvalidValue;
}

// The W8A8 forms. As above, except: with w8a8, wi is (2F, DM) int8 codes and swi
// (2F,) fp32 scales; with w8a8_wo, wo is (DM, F) int8 codes and swo (DM,) fp32
// scales; a weight whose option is off stays bf16 and its scales are unused.
// codes_y (R, DM) and codes_g (R, F), int8 or null, receive the activation
// codes the kernel used (w8a8 and w8a8_wo respectively).
extern "C" int cm3p_fused_ln_ffn_q(const void* x, const void* scale, const void* bias,
                                   const void* wi, const void* swi, const void* wo, const void* swo,
                                   void* out, void* codes_y, void* codes_g, int R, int DM, int F,
                                   float eps, int w8a8, int w8a8_wo, void* stream) {
  if (R <= 0 || F <= 0 || F % FC != 0 || !(w8a8 || w8a8_wo)) return (int)cudaErrorInvalidValue;
  if ((w8a8 && swi == nullptr) || (w8a8_wo && swo == nullptr)) return (int)cudaErrorInvalidValue;
  if (DM == 768)
    return dispatch_q<768>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  if (DM == 512)
    return dispatch_q<512>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  if (DM == 256)
    return dispatch_q<256>(x, scale, bias, wi, swi, wo, swo, out, codes_y, codes_g, R, F, eps, w8a8, w8a8_wo, stream);
  return (int)cudaErrorInvalidValue;
}
