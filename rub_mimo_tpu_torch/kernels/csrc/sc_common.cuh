// Shared device code of the Schmidl&Cox kernels (sc_metric.cu, sc_sync.cu):
// the per-thread item count, the padded shared-memory index, and the warp-
// and block-wide reductions and scans they use.
//
// Both kernels form the metric the same way over a window of samples held in
// shared memory: each thread takes kItems consecutive samples, forms the lag
// products conj(x[j - M/2]) x[j] and the energies |x[j]|^2, sums them in
// registers, then across its warp by shuffles, then adds the earlier warps'
// totals; for output j,
//   corr   = -(P[j] - P[j - M/2]),  energy = 0.5 (E[j] - E[j - M]),
//   metric = |corr|^2 / energy^2,
// the chunk-local cumsum-difference form of the plain moving sums.  A window
// of zeros has metric 0/0 = NaN in the reference's FIR sums; float prefix
// sums combined in a tree need not cancel exactly there, so an exact integer
// count of nonzero samples decides that case.  NaN > threshold is false, as
// in C; the builds do not use fast math.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace sc {

constexpr int kItems = 16;  // consecutive samples per thread
constexpr int kMaxStreams = 8;
constexpr unsigned kFull = 0xffffffffu;

// One entry of pad per 32 (4-byte entries): entry u of each thread's run of
// 16 (entries 16 apart) and 32 consecutive entries both fall on distinct
// banks.
__host__ __device__ constexpr int padded(int j) { return j + (j >> 5); }

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Exclusive prefix max of v over the threads of the block (-1 for thread
// 0).  red: >= 32 ints.
__device__ __forceinline__ int block_exclusive_max(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, o);
  }
  int exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = -1;
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) exc = max(exc, red[w]);
  __syncthreads();
  return exc;
}

}  // namespace sc
