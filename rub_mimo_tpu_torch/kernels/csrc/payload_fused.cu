// Fused payload tail for Hopper (sm_90a): M-point FFT + per-subcarrier
// S x S equalize + hard demap of CP-stripped OFDM symbols, one thread
// block per frame.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/payload_fused.py::payload_fused (body _kernel /
//   _fft_eq_demap),
// whose packed 128x128 matmul factorisation of the DFT was shaped by the
// TPU's matrix unit and is not carried over.  Outputs are in natural
// subcarrier order with exactly n_sym frames.  As in the TPU kernel,
// dft_norm is folded into the equalizer gain (the equalize is linear).
//
// What bounds it: memory.  At the reference operating point (M=2048,
// S=2, 1000 frames) it reads 33 MB of complex64 symbols and writes 49 MB
// (int32 decisions + complex64 symbols): a floor of ~25 us at the card's
// 3.35 TB/s; the FFT is ~0.2 GFLOP.  The design is K1's
// (payload_fused_strip.cu) with a contiguous interleaved-complex load in
// place of the CP strip: each block reads its frame once, coalesced,
// transforms it in shared memory (S * M * 8 bytes) and writes each output
// once.  Steps 2-4 are payload_common.cuh's fft_eq_demap_frame.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include "payload_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPoints = 64;

template <int S>
__global__ void __launch_bounds__(kThreads)
payload_fused_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ W,
                     const float* __restrict__ gain,
                     const float* __restrict__ points, int n_points,
                     const float2* __restrict__ twiddle, float dft_norm,
                     int M, int log2M, int n_sym,
                     int* __restrict__ rx_data,
                     float2* __restrict__ rx_sig) {
  extern __shared__ float2 buf[];  // [S][M]
  __shared__ float cr[kMaxPoints];
  __shared__ float ci[kMaxPoints];
  __shared__ float cb[kMaxPoints];

  const int k = blockIdx.x;
  payload::load_points(points, n_points, cr, ci, cb);

  // 1. bit-reversed load of x[s][k][:]
  for (int i = threadIdx.x; i < S * M; i += kThreads) {
    const int s = i >> log2M;
    const int n = i & (M - 1);
    buf[s * M + payload::bit_reverse(n, log2M)] =
        x[((long long)s * n_sym + k) * M + n];
  }
  __syncthreads();

  payload::fft_eq_demap_frame<S>(buf, M, log2M, twiddle, W, gain, dft_norm,
                                 cr, ci, cb, n_points, k, n_sym, rx_data,
                                 rx_sig);
}

template <int S>
cudaError_t launch(const float2* x, const float2* W, const float* gain,
                   const float* points, int n_points, const float2* twiddle,
                   float dft_norm, int M, int log2M, int n_sym, int* rx_data,
                   float2* rx_sig, cudaStream_t stream) {
  const size_t smem = (size_t)S * M * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      payload_fused_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  payload_fused_kernel<S><<<n_sym, kThreads, smem, stream>>>(
      x, W, gain, points, n_points, twiddle, dft_norm, M, log2M, n_sym,
      rx_data, rx_sig);
  return cudaGetLastError();
}

}  // namespace

// x: [S, n_sym, M] complex64 CP-stripped symbols
// W: [M, S(out), S(rx)] complex64; gain: [M] f32
// points: [3, n_points] f32 rows (Re c, Im c, |c|^2/2), n_points <= 64
// twiddle: [M/2] complex64, exp(-2 pi i j / M)
// rx_data: [S, n_sym, M] int32; rx_sig: [S, n_sym, M] complex64 or null
// Requires M a power of two in [64, 4096], 1 <= S <= 4, n_sym >= 1.
// Returns a cudaError_t.
extern "C" int payload_fused(const float2* x, const float2* W,
                             const float* gain, const float* points,
                             int n_points, const float2* twiddle,
                             float dft_norm, int S, int M, int log2M,
                             int n_sym, int* rx_data, float2* rx_sig,
                             void* stream) {
  if (n_points < 1 || n_points > kMaxPoints || n_sym < 1 ||
      M != (1 << log2M) || M < 64 || M > 4096) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return (int)launch<1>(x, W, gain, points, n_points, twiddle, dft_norm,
                            M, log2M, n_sym, rx_data, rx_sig, st);
    case 2:
      return (int)launch<2>(x, W, gain, points, n_points, twiddle, dft_norm,
                            M, log2M, n_sym, rx_data, rx_sig, st);
    case 3:
      return (int)launch<3>(x, W, gain, points, n_points, twiddle, dft_norm,
                            M, log2M, n_sym, rx_data, rx_sig, st);
    case 4:
      return (int)launch<4>(x, W, gain, points, n_points, twiddle, dft_norm,
                            M, log2M, n_sym, rx_data, rx_sig, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
