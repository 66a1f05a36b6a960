// Bounds checks of the attention kernels' checked build, the stand-in for a
// memory checker on a machine that has none.
//
// csrc/attention.cu and csrc/attention_bwd.cu (with the headers they include)
// are built twice: the default build, where every check below is the
// constant true and compiles away, and the checked build (-lineinfo
// -DATTN_BOUNDS_CHECK, ops/_build.py's `checked` argument), where
//   * every global load and store of the kernels is checked against the
//     extent of the tensor it addresses, in elements from the pointer the
//     wrapper passed (the wrapper arms the extents before each launch:
//     cm3p_bounds_arm), and every index read from a tensor (tile ranges) and
//     every TMA coordinate and ring stage against its range;
//   * the first violation of a launch is kept in a device fault record
//     (kernel, line, what, block, thread, index, extent) that the wrapper
//     reads after the launch (cm3p_bounds_fault) and raises on;
//   * a checked access that fails is skipped (a load gives 0), so the launch
//     runs to its end and the record survives: a trap would end the context
//     and lose it. A TMA coordinate out of range is recorded and its load still
//     issued (the tensor map bounds it and fills zeros), so no ring waits for
//     bytes that never come.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace cm3p {
namespace bounds {

// What a check names: a tensor the wrapper passed (its extent comes from cm3p_bounds_arm) ...
enum Tensor : int { Q, K, V, DOUT, QSEG, KSEG, COS, SIN, START, COUNT, RANGE_SCRATCH, OUT, LSE, DELTA, DQ, DK, DV, ROT,
                    NTENSORS };
// ... or a range that is not a tensor (its extent comes with the check)
enum Range : int { TILE = NTENSORS, HEAD, ROW, STAGE };
// The kernel that made the access
enum Kernel : int { NONE, RANGES, ROPE_K, ATTN_WINDOW, ATTN_SEGMENT, ROPE_QK, DQ_WINDOW, DQ_SEGMENT, DKV_WINDOW,
                    DKV_SEGMENT };

struct Fault {  // the first violation since the last arm; kernel NONE: none
  int kernel, line, what, thread;
  int block[3];
  int pad;
  long long index, extent;
};

#ifdef ATTN_BOUNDS_CHECK
static __device__ Fault fault;
static __device__ long long extent[NTENSORS];

__device__ __noinline__ void record(int kernel, int line, int what, long long index, long long n) {
  if (atomicCAS(&fault.kernel, NONE, -1) != NONE) return;  // another thread holds the record
  fault.line = line;
  fault.what = what;
  fault.thread = threadIdx.x;
  fault.block[0] = blockIdx.x;
  fault.block[1] = blockIdx.y;
  fault.block[2] = blockIdx.z;
  fault.index = index;
  fault.extent = n;
  __threadfence();
  atomicExch(&fault.kernel, kernel);
}

// Elements [index, index + width) of tensor t lie inside it; else the record, and false.
__device__ __forceinline__ bool ok(int kernel, int line, int t, long long index, int width) {
  const long long n = extent[t];
  if (index >= 0 && index + width <= n) return true;
  record(kernel, line, t, index, n);
  return false;
}

// 0 <= index < n for a range that is not a tensor; else the record, and false.
__device__ __forceinline__ bool in_range(int kernel, int line, int what, long long index, long long n) {
  if (index >= 0 && index < n) return true;
  record(kernel, line, what, index, n);
  return false;
}
#else
__device__ __forceinline__ constexpr bool ok(int, int, int, long long, int) { return true; }
__device__ __forceinline__ constexpr bool in_range(int, int, int, long long, long long) { return true; }
#endif

}  // namespace bounds
}  // namespace cm3p

// BOUNDS_OK(kernel, tensor, first element, elements): the access may go ahead (always, in the default build).
#define BOUNDS_OK(kernel, t, index, width) cm3p::bounds::ok(kernel, __LINE__, t, index, width)
// IN_RANGE(kernel, what, index, n): 0 <= index < n for a TMA coordinate, a ring stage or a tile range.
#define IN_RANGE(kernel, what, index, n) cm3p::bounds::in_range(kernel, __LINE__, what, index, n)

#ifdef ATTN_BOUNDS_CHECK
// The entry points of a checked library. cm3p_bounds_arm: the extents (elements, NTENSORS of them, 0 for a
// tensor not passed) of the next launch on `stream`, and an empty record; cm3p_bounds_fault: the record, after
// the caller synchronised the device.
extern "C" int cm3p_bounds_arm(const long long* extents, void* stream) {
  const cm3p::bounds::Fault none = {};
  cudaError_t err = cudaMemcpyToSymbolAsync(cm3p::bounds::extent, extents, sizeof(long long) * cm3p::bounds::NTENSORS,
                                            0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbolAsync(cm3p::bounds::fault, &none, sizeof(none), 0, cudaMemcpyHostToDevice,
                                      (cudaStream_t)stream);
}

extern "C" int cm3p_bounds_fault(void* record) {
  return (int)cudaMemcpyFromSymbol(record, cm3p::bounds::fault, sizeof(cm3p::bounds::Fault));
}
#endif
