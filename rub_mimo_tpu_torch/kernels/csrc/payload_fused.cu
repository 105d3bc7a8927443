// Fused payload tail for Hopper (sm_90a): M-point FFT + per-subcarrier
// S x S equalize + hard demap of CP-stripped OFDM symbols, a persistent
// block per SM slot walking over the frames.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/payload_fused.py::payload_fused (body _kernel /
//   _fft_eq_demap),
// whose packed 128x128 matmul factorisation of the DFT was shaped by the
// TPU's matrix unit and is not carried over.  Outputs are in natural
// subcarrier order with exactly n_sym frames.  As in the TPU kernel,
// dft_norm is folded into the equalizer gain (the equalize is linear).
//
// What bounds it: the bytes at least.  At the reference operating point
// (M=2048, S=2, 1000 frames) it reads 33 MB of complex64 symbols and
// writes 49 MB (int32 decisions + complex64 symbols): a floor of ~25 us
// at the card's 3.35 TB/s.  In practice the instructions, as for K1.
// The design is K1's (payload_fused_strip.cu, the block in
// payload_fft.cuh) with contiguous interleaved-complex rows in place of
// the CP strip: 16-byte cp.async copies where the rows are 16-byte
// aligned, else 8-byte.  Measured at the operating point on an NVIDIA
// H100 80GB HBM3, power limit 700 W: 0.0637 ms device time
// (chip_smoke.py, torch.profiler), 38 % of the bytes bound.

// Plain C interface for ctypes; the launcher returns a cudaError_t.

#include <cuda_runtime.h>

#include "payload_common.cuh"
#include "payload_fft.cuh"

namespace {

// Frame k's row s is x[s][k][:]; the stage buffer holds [S][M] float2.
struct RowsIn {
  const float2* x;
  int n_sym, vec;  // vec: 16-byte copies

  // Starts frame k's copy: into the natural-order stage buffer when two,
  // else into the padded work rows (8-byte copies).
  __device__ __forceinline__ void issue(int k, float2* dst, bool two, int S,
                                        int M, int RS, int i0,
                                        int nt) const {
    for (int s = 0; s < S; ++s) {
      const float2* src = x + ((long long)s * n_sym + k) * M;
      if (two && vec) {
        for (int i = 2 * i0; i < M; i += 2 * nt)
          pfft::cp_async16(dst + s * M + i, src + i);
      } else if (two) {
        for (int i = i0; i < M; i += nt)
          pfft::cp_async8(dst + s * M + i, src + i);
      } else {
        for (int i = i0; i < M; i += nt)
          pfft::cp_async8(dst + s * RS + pfft::pad(i), src + i);
      }
    }
  }

  int M_;
  __device__ __forceinline__ float2 read(const float2* stage, int s,
                                         int n) const {
    return stage[s * M_ + n];
  }
};

template <int S, bool TWO>
__global__ void __launch_bounds__(TWO ? 256 : 1024)
payload_fused_kernel(const RowsIn in, const pfft::Tail a) {
  pfft::frames<S, TWO>(in, a);
}

template <int S, bool TWO>
cudaError_t run(const RowsIn& in, const pfft::Tail& a, cudaStream_t stream,
                int* geo) {
  const pfft::Geometry g = pfft::geometry(S, a.M, a.n_tw);
  int bps = 0, n_sm = 0;
  cudaError_t e = pfft::occupancy<payload_fused_kernel<S, TWO>>(
      a.log2M, g, &bps, &n_sm);
  if (e != cudaSuccess) return e;
  const int grid = a.n_sym < bps * n_sm ? a.n_sym : bps * n_sm;
  if (geo != nullptr) {
    geo[0] = grid; geo[1] = bps; geo[2] = n_sm;
    geo[3] = g.threads; geo[4] = g.smem; geo[5] = g.two_stage;
    return cudaSuccess;
  }
  payload_fused_kernel<S, TWO><<<grid, g.threads, g.smem, stream>>>(in, a);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch(const RowsIn& in, const pfft::Tail& a,
                     cudaStream_t stream, int* geo) {
  if (pfft::geometry(S, a.M, a.n_tw).two_stage)
    return run<S, true>(in, a, stream, geo);
  if constexpr (S > 1) return run<S, false>(in, a, stream, geo);
  return cudaErrorInvalidValue;  // S = 1 always fits two stages
}

int launch(const float2* x, const float2* W, const float* gain,
           const float* points, int n_points, const int* plan, int n_pass,
           const float2* twiddle, float dft_norm, int S, int M, int log2M,
           int n_sym, int* rx_data, float2* rx_sig, void* stream, int* geo) {
  if (n_sym < 1 || M != (1 << log2M) || M < 64 || M > 4096 || S < 1 ||
      S > 4) {
    return (int)cudaErrorInvalidValue;
  }
  pfft::Tail a{};
  if (!pfft::fill_tail(a, points, n_points, plan, n_pass, M))
    return (int)cudaErrorInvalidValue;
  a.W = W; a.gain = gain; a.tw = twiddle; a.rx_data = rx_data;
  a.rx_sig = rx_sig; a.dft_norm = dft_norm; a.M = M; a.log2M = log2M;
  a.n_sym = n_sym;
  const RowsIn in{x, n_sym, reinterpret_cast<size_t>(x) % 16 == 0, M};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return (int)dispatch<1>(in, a, st, geo);
    case 2: return (int)dispatch<2>(in, a, st, geo);
    case 3: return (int)dispatch<3>(in, a, st, geo);
    default: return (int)dispatch<4>(in, a, st, geo);
  }
}

}  // namespace

// x: [S, n_sym, M] complex64 CP-stripped symbols
// W: [M, S(out), S(rx)] complex64; gain: [M] f32
// points: host [3, 64] f32 rows (Re c, Im c, |c|^2/2), the first
// n_points used, n_points <= 64 (copied into the kernel's parameters)
// plan: host [n_pass] radices, 16 first, product M
// twiddle: complex64 payload_fused.pass_twiddles(M), the [R][Ns]
// twiddles of each pass after the first
// rx_data: [S, n_sym, M] int32; rx_sig: [S, n_sym, M] complex64 or null
// Requires M a power of two in [64, 4096], 1 <= S <= 4, n_sym >= 1.
// Returns a cudaError_t.
extern "C" int payload_fused(const float2* x, const float2* W,
                             const float* gain, const float* points,
                             int n_points, const int* plan, int n_pass,
                             const float2* twiddle, float dft_norm, int S,
                             int M, int log2M, int n_sym, int* rx_data,
                             float2* rx_sig, void* stream) {
  return launch(x, W, gain, points, n_points, plan, n_pass, twiddle,
                dft_norm, S, M, log2M, n_sym, rx_data, rx_sig, stream,
                nullptr);
}

// The launch payload_fused would make, without launching: geo[6] = grid,
// blocks per SM, SMs, threads per block, dynamic shared bytes, two-stage
// (1/0).  Returns a cudaError_t.
extern "C" int payload_fused_geometry(int S, int M, int log2M, int n_sym,
                                      const int* plan, int n_pass,
                                      int* geo) {
  float points[3 * pfft::kMaxPoints] = {};
  return launch(nullptr, nullptr, nullptr, points, 1, plan, n_pass, nullptr,
                1.f, S, M, log2M, n_sym, nullptr, nullptr, nullptr, geo);
}
