// Strip-fused payload tail for Hopper (sm_90a): CP strip + M-point FFT +
// per-subcarrier S x S equalize + hard demap, one thread block per frame.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/payload_fused.py::payload_fused_strip
//   (body _kernel_strip / _fft_eq_demap),
// whose 128x128 matmul factorisation of the DFT was shaped by the TPU's
// matrix unit and is not carried over.  Outputs are in natural subcarrier
// order with exactly n_sym frames (no packed order, no pad frames).
//
// What bounds it: memory.  At the reference operating point (M=2048,
// CP=152, S=2, 1000 frames) it reads ~37 MB of f32 payload planes and
// writes ~49 MB (int32 decisions + complex64 symbols): ~86 MB, a floor of
// tens of microseconds at the card's 3.35 TB/s.  The FFT is ~0.2 GFLOP,
// negligible.  So the design keeps every intermediate on chip: each block
// reads its frame's samples once (coalesced, CP skipped by the load
// offset), transforms them in shared memory (S * M * 8 bytes, 32 KB at the
// operating point), and writes each output element once, coalesced.
//
// Per block (frame k):
//   1. load x[s][n] = p[s][k*sym + cp + n] into shared memory at the
//      bit-reversed position of n;
//   2. log2(M) in-place radix-2 decimation-in-time stages; the twiddles
//      exp(-2 pi i j / M), j < M/2, come from a table the wrapper builds
//      in float64 and rounds to float32;
//   3. per subcarrier: eq[o] = (sum_j W[sc][o][j] X[j]) * gain[sc] * dft_norm
//      (j in order 0..S-1), then the demap
//      argmax_q Re(eq) cr[q] + Im(eq) ci[q] - cb[q] with a strict '>' so
//      the first maximum wins;
//   4. write rx_data[o][k][sc] (int32) and, when rx_sig is non-null,
//      rx_sig[o][k][sc] (complex64).
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPoints = 64;

template <int S>
__global__ void __launch_bounds__(kThreads)
payload_fused_strip_kernel(const float* __restrict__ p_re,
                           const float* __restrict__ p_im,
                           long long plane_len,
                           const float2* __restrict__ W,
                           const float* __restrict__ gain,
                           const float* __restrict__ points,
                           int n_points,
                           const float2* __restrict__ twiddle,
                           float dft_norm,
                           int M, int log2M, int n_sym, int sym, int cp,
                           int* __restrict__ rx_data,
                           float2* __restrict__ rx_sig) {
  extern __shared__ float2 buf[];  // [S][M]
  __shared__ float cr[kMaxPoints];
  __shared__ float ci[kMaxPoints];
  __shared__ float cb[kMaxPoints];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  for (int q = tid; q < n_points; q += kThreads) {
    cr[q] = points[q];
    ci[q] = points[n_points + q];
    cb[q] = points[2 * n_points + q];
  }

  // 1. CP strip + bit-reversed load
  const long long frame_off = (long long)k * sym + cp;
  for (int i = tid; i < S * M; i += kThreads) {
    const int s = i >> log2M;
    const int n = i & (M - 1);
    const long long g = (long long)s * plane_len + frame_off + n;
    const int r = (int)(__brev((unsigned)n) >> (32 - log2M));
    buf[s * M + r] = make_float2(p_re[g], p_im[g]);
  }
  __syncthreads();

  // 2. radix-2 DIT stages, butterfly half-size h = 2^lh
  const int half = M >> 1;
  for (int lh = 0; lh < log2M; ++lh) {
    const int h = 1 << lh;
    for (int b = tid; b < S * half; b += kThreads) {
      const int s = b >> (log2M - 1);
      const int j = b & (half - 1);
      const int pos = j & (h - 1);
      const int i0 = ((j >> lh) << (lh + 1)) + pos;
      const int i1 = i0 + h;
      const float2 w = twiddle[pos << (log2M - 1 - lh)];
      float2* x = buf + s * M;
      const float2 a = x[i0];
      const float2 c = x[i1];
      const float2 t = make_float2(w.x * c.x - w.y * c.y,
                                   w.x * c.y + w.y * c.x);
      x[i0] = make_float2(a.x + t.x, a.y + t.y);
      x[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }

  // 3-4. equalize + demap + store
  for (int sc = tid; sc < M; sc += kThreads) {
    float2 X[S];
#pragma unroll
    for (int j = 0; j < S; ++j) X[j] = buf[j * M + sc];
    const float g = gain[sc] * dft_norm;
#pragma unroll
    for (int o = 0; o < S; ++o) {
      float ar = 0.f;
      float ai = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float2 w = W[(sc * S + o) * S + j];
        ar += w.x * X[j].x - w.y * X[j].y;
        ai += w.x * X[j].y + w.y * X[j].x;
      }
      ar *= g;
      ai *= g;
      float best = -CUDART_INF_F;
      int idx = 0;
      for (int q = 0; q < n_points; ++q) {
        const float score = ar * cr[q] + ai * ci[q] - cb[q];
        if (score > best) {
          best = score;
          idx = q;
        }
      }
      const long long o_off = ((long long)o * n_sym + k) * M + sc;
      rx_data[o_off] = idx;
      if (rx_sig != nullptr) rx_sig[o_off] = make_float2(ar, ai);
    }
  }
}

template <int S>
cudaError_t launch(const float* p_re, const float* p_im, long long plane_len,
                   const float2* W, const float* gain, const float* points,
                   int n_points, const float2* twiddle, float dft_norm,
                   int M, int log2M, int n_sym, int sym, int cp,
                   int* rx_data, float2* rx_sig, cudaStream_t stream) {
  const size_t smem = (size_t)S * M * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      payload_fused_strip_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  payload_fused_strip_kernel<S><<<n_sym, kThreads, smem, stream>>>(
      p_re, p_im, plane_len, W, gain, points, n_points, twiddle, dft_norm,
      M, log2M, n_sym, sym, cp, rx_data, rx_sig);
  return cudaGetLastError();
}

}  // namespace

// p_re, p_im: [S, plane_len] f32 flat payload planes (CPs in place)
// W: [M, S(out), S(rx)] complex64; gain: [M] f32
// points: [3, n_points] f32 rows (Re c, Im c, |c|^2/2), n_points <= 64
// twiddle: [M/2] complex64, exp(-2 pi i j / M)
// rx_data: [S, n_sym, M] int32; rx_sig: [S, n_sym, M] complex64 or null
// Requires M a power of two in [64, 4096], 1 <= S <= 4, n_sym >= 1,
// plane_len >= n_sym * sym, sym == M + cp.  Returns a cudaError_t.
extern "C" int payload_fused_strip(
    const float* p_re, const float* p_im, long long plane_len,
    const float2* W, const float* gain, const float* points, int n_points,
    const float2* twiddle, float dft_norm, int S, int M, int log2M,
    int n_sym, int sym, int cp, int* rx_data, float2* rx_sig,
    void* stream) {
  if (n_points < 1 || n_points > kMaxPoints || n_sym < 1 ||
      M != (1 << log2M) || M < 64 || M > 4096 || sym != M + cp) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return (int)launch<1>(p_re, p_im, plane_len, W, gain, points, n_points,
                            twiddle, dft_norm, M, log2M, n_sym, sym, cp,
                            rx_data, rx_sig, st);
    case 2:
      return (int)launch<2>(p_re, p_im, plane_len, W, gain, points, n_points,
                            twiddle, dft_norm, M, log2M, n_sym, sym, cp,
                            rx_data, rx_sig, st);
    case 3:
      return (int)launch<3>(p_re, p_im, plane_len, W, gain, points, n_points,
                            twiddle, dft_norm, M, log2M, n_sym, sym, cp,
                            rx_data, rx_sig, st);
    case 4:
      return (int)launch<4>(p_re, p_im, plane_len, W, gain, points, n_points,
                            twiddle, dft_norm, M, log2M, n_sym, sym, cp,
                            rx_data, rx_sig, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
