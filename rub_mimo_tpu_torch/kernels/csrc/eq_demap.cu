// Equalize + hard demap (K3) and hard demap alone (K4) for Hopper
// (sm_90a), in natural subcarrier order.
//
// Replace the TPU Pallas kernels of rub_mimo_tpu/kernels/eq_demap.py:
//   K3 eq_demap:  eq[o][k][sc] = (sum_j W[sc][o][j] X[j][k][sc]) * gain[sc],
//                 X the FFT of the CP-stripped payload already scaled by
//                 the DFT normalizer, then the demap of eq;
//   K4 demap:     the nearest-neighbour decision of each symbol.
// The TPU kernels worked on [frames, M] tiles with M % 128 == 0 (the
// 128-lane tile) and at most 64 points; here any length is taken, and K4
// takes up to 256 points, so every modulation (QAM256 included) demaps on
// the card.
//
// What bounds them: memory.  At the reference operating point (2 streams,
// 1000 frames, M = 2048) K3 reads 33 MB of symbols and writes 49 MB
// (complex64 + int32), a floor of ~25 us at 3.35 TB/s; K4 reads 33 MB and
// writes 16 MB, ~15 us.  The demap's up-to-K score evaluations per symbol
// (32 at the operating point) stay well under the card's float32 rate.
// One thread per symbol (K4) or per (frame, subcarrier) with its S
// streams (K3): neighbouring threads read and write neighbouring
// addresses, the points sit in shared memory, and the arithmetic is
// payload_common.cuh's, shared with K1 and K2.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include "payload_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDemapPoints = 256;
constexpr int kMaxEqPoints = 64;

__global__ void __launch_bounds__(kThreads)
demap_kernel(const float2* __restrict__ y, long long n,
             const float* __restrict__ points, int n_points,
             int* __restrict__ out) {
  __shared__ float cr[kMaxDemapPoints];
  __shared__ float ci[kMaxDemapPoints];
  __shared__ float cb[kMaxDemapPoints];
  payload::load_points(points, n_points, cr, ci, cb);
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float2 v = y[i];
  out[i] = payload::demap(v.x, v.y, cr, ci, cb, n_points);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
eq_demap_kernel(const float2* __restrict__ X, const float2* __restrict__ W,
                const float* __restrict__ gain,
                const float* __restrict__ points, int n_points, int M,
                int n_sym, int* __restrict__ rx_data,
                float2* __restrict__ rx_sig) {
  __shared__ float cr[kMaxEqPoints];
  __shared__ float ci[kMaxEqPoints];
  __shared__ float cb[kMaxEqPoints];
  payload::load_points(points, n_points, cr, ci, cb);
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long plane = (long long)n_sym * M;
  if (i >= plane) return;
  const int sc = (int)(i % M);
  float2 x[S];
#pragma unroll
  for (int j = 0; j < S; ++j) x[j] = X[j * plane + i];
  float er[S];
  float ei[S];
  payload::equalize<S>(x, W, sc, gain[sc], er, ei);
#pragma unroll
  for (int o = 0; o < S; ++o) {
    rx_data[o * plane + i] = payload::demap(er[o], ei[o], cr, ci, cb,
                                            n_points);
    if (rx_sig != nullptr) rx_sig[o * plane + i] = make_float2(er[o], ei[o]);
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int S>
cudaError_t launch_eq(const float2* X, const float2* W, const float* gain,
                      const float* points, int n_points, int M, int n_sym,
                      int* rx_data, float2* rx_sig, cudaStream_t stream) {
  eq_demap_kernel<S><<<blocks_for((long long)n_sym * M), kThreads, 0,
                       stream>>>(X, W, gain, points, n_points, M, n_sym,
                                 rx_data, rx_sig);
  return cudaGetLastError();
}

}  // namespace

// y: [n] complex64; points: [3, n_points] f32 rows (Re c, Im c, |c|^2/2),
// 1 <= n_points <= 256; out: [n] int32.  Requires 1 <= n < 2^39.
// Returns a cudaError_t.
extern "C" int hard_demap(const float2* y, long long n, const float* points,
                          int n_points, int* out, void* stream) {
  if (n < 1 || n_points < 1 || n_points > kMaxDemapPoints ||
      n > (long long)kThreads * 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  demap_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(y, n, points, n_points,
                                                      out);
  return (int)cudaGetLastError();
}

// X: [S, n_sym, M] complex64 (already scaled by the DFT normalizer)
// W: [M, S(out), S(rx)] complex64; gain: [M] f32
// points: [3, n_points] f32 rows, 1 <= n_points <= 64
// rx_data: [S, n_sym, M] int32; rx_sig: [S, n_sym, M] complex64 or null
// Requires 1 <= S <= 4, M >= 1, n_sym >= 1.  Returns a cudaError_t.
extern "C" int eq_demap(const float2* X, const float2* W, const float* gain,
                        const float* points, int n_points, int S, int M,
                        int n_sym, int* rx_data, float2* rx_sig,
                        void* stream) {
  if (n_points < 1 || n_points > kMaxEqPoints || M < 1 || n_sym < 1 ||
      (long long)n_sym * M > (long long)kThreads * 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return (int)launch_eq<1>(X, W, gain, points, n_points, M, n_sym,
                               rx_data, rx_sig, st);
    case 2:
      return (int)launch_eq<2>(X, W, gain, points, n_points, M, n_sym,
                               rx_data, rx_sig, st);
    case 3:
      return (int)launch_eq<3>(X, W, gain, points, n_points, M, n_sym,
                               rx_data, rx_sig, st);
    case 4:
      return (int)launch_eq<4>(X, W, gain, points, n_points, M, n_sym,
                               rx_data, rx_sig, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
