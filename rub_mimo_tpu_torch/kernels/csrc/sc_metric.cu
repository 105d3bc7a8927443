// Schmidl&Cox timing metric over a whole capture for Hopper (sm_90a), one
// pass.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/sc_metric.py::sc_metric_pallas
// whose grid ran in order over blocks with a zero-padded previous block as
// the M-sample history.  Here every (tile, stream) pair is an independent
// thread block that loads its own left halo, so the tiles run in any order
// (sc_common.cuh has the tile code):
//
//   metric[s][t] = |corr[s][t]|^2 / energy[s][t]^2,
//   corr[t]   = -sum_{k<M/2} conj(x[t-k-M/2]) x[t-k],
//   energy[t] = 0.5 sum_{k<M} |x[t-k]|^2          (framing.cc:626-637)
//
// What bounds it: memory.  At the reference operating point (2 streams of
// 2,297,248 complex64 samples, M = 2048) it reads the 37 MB capture twice
// (each 4096-sample tile re-reads its 2048-sample halo) and writes the
// 18 MB metric: ~92 MB, a floor of ~27 us at 3.35 TB/s.  The prefix sums
// are ~15 operations per sample, negligible.  The design keeps every
// intermediate (lag products, prefix sums) in shared memory and writes each
// metric sample once, coalesced.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "sc_common.cuh"

namespace {

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
sc_metric_kernel(const float2* __restrict__ x, int T, int M,
                 float* __restrict__ metric) {
  constexpr int L = THREADS * sc::kItems;
  extern __shared__ float2 smem[];
  const sc::Tile tile(smem, L);
  const int s = blockIdx.y;
  const int B = L - M;
  const int t0 = blockIdx.x * B;
  sc::tile_prefix<THREADS>(x + (long long)s * T, T, M, t0, tile);
  float* out = metric + (long long)s * T;
  for (int i = threadIdx.x; i < B; i += THREADS) {
    const int t = t0 + i;
    if (t >= T) break;
    out[t] = sc::metric_at(tile, i + M, M);
  }
}

template <int THREADS>
cudaError_t launch(const float2* x, int S, int T, int M, float* metric,
                   cudaStream_t stream) {
  constexpr int L = THREADS * sc::kItems;
  const size_t smem = sc::tile_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      sc_metric_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int B = L - M;
  const dim3 grid((T + B - 1) / B, S);
  sc_metric_kernel<THREADS><<<grid, THREADS, smem, stream>>>(x, T, M,
                                                              metric);
  return cudaGetLastError();
}

}  // namespace

// x: [S, T] complex64 (interleaved re, im); metric: [S, T] float32.
// Requires 1 <= S <= 65535, T >= 1, M a multiple of 32 in [32, 4096].
// Returns a cudaError_t.
extern "C" int sc_metric(const float2* x, int S, int T, int M, float* metric,
                         void* stream) {
  if (S < 1 || S > 65535 || T < 1 || M < 32 || M > 4096 || M % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sc::tile_threads(M) == 256) {
    return (int)launch<256>(x, S, T, M, metric, st);
  }
  return (int)launch<512>(x, S, T, M, metric, st);
}
