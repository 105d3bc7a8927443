// Device code shared by the payload kernels (sm_90a): the demap constants
// in shared memory, the nearest-neighbour hard demap, the per-subcarrier
// S x S equalize, and the per-frame shared-memory FFT + equalize + demap
// block of the fused payload tails.
//
//   K1 payload_fused_strip.cu  CP strip + FFT + equalize + demap (flat planes)
//   K2 payload_fused.cu        FFT + equalize + demap (CP-stripped symbols)
//   K3 eq_demap.cu (eq_demap)  equalize + demap after a separate FFT
//   K4 eq_demap.cu (demap)     hard demap alone
//
// The arithmetic is written once here so that every kernel rounds as K1
// does: the equalize sums j = 0..S-1 in order and scales by the gain
// last; the demap scores Re(y) cr[q] + Im(y) ci[q] - cb[q] over the
// points in order from -inf with a strict '>', so the first maximum
// wins.  nvcc may contract the products into FMAs (no --use_fast_math),
// so a decision may differ from the plain PyTorch version only where two
// scores tie to within a rounding.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace payload {

// Copy the demap constants, [3, n] rows (Re c, Im c, |c|^2 / 2), into
// shared memory.  Every thread of the block calls it; the caller
// synchronizes before reading.
__device__ __forceinline__ void load_points(const float* __restrict__ points,
                                            int n, float* cr, float* ci,
                                            float* cb) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    cr[q] = points[q];
    ci[q] = points[n + q];
    cb[q] = points[2 * n + q];
  }
}

// argmax_q ar cr[q] + ai ci[q] - cb[q], the first maximum winning.
__device__ __forceinline__ int demap(float ar, float ai, const float* cr,
                                     const float* ci, const float* cb,
                                     int n) {
  float best = -CUDART_INF_F;
  int idx = 0;
  for (int q = 0; q < n; ++q) {
    const float score = ar * cr[q] + ai * ci[q] - cb[q];
    if (score > best) {
      best = score;
      idx = q;
    }
  }
  return idx;
}

// eq[o] = (sum_j W[sc][o][j] X[j]) * g for o < S; W is [M][S][S].
template <int S>
__device__ __forceinline__ void equalize(const float2 (&X)[S],
                                         const float2* __restrict__ W,
                                         int sc, float g, float (&er)[S],
                                         float (&ei)[S]) {
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
    er[o] = ar * g;
    ei[o] = ai * g;
  }
}

// Bit-reversed position of n < 2^log2M.
__device__ __forceinline__ int bit_reverse(int n, int log2M) {
  return (int)(__brev((unsigned)n) >> (32 - log2M));
}

// One frame of the fused tails, after the block has written its S rows
// of M samples into buf [S][M] at bit-reversed positions (and called
// __syncthreads): log2(M) in-place radix-2 decimation-in-time stages,
// then per subcarrier the equalize with gain[sc] * dft_norm and the
// demap, written to rx_data[o][k][sc] and, when rx_sig is not null,
// rx_sig[o][k][sc].  The twiddles exp(-2 pi i j / M), j < M/2, come from
// a table the wrapper builds in float64 and rounds to float32.
template <int S>
__device__ __forceinline__ void fft_eq_demap_frame(
    float2* buf, int M, int log2M, const float2* __restrict__ twiddle,
    const float2* __restrict__ W, const float* __restrict__ gain,
    float dft_norm, const float* cr, const float* ci, const float* cb,
    int n_points, int k, int n_sym, int* __restrict__ rx_data,
    float2* __restrict__ rx_sig) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int half = M >> 1;
  for (int lh = 0; lh < log2M; ++lh) {
    const int h = 1 << lh;
    for (int b = tid; b < S * half; b += nthreads) {
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

  for (int sc = tid; sc < M; sc += nthreads) {
    float2 X[S];
#pragma unroll
    for (int j = 0; j < S; ++j) X[j] = buf[j * M + sc];
    float er[S];
    float ei[S];
    equalize<S>(X, W, sc, gain[sc] * dft_norm, er, ei);
#pragma unroll
    for (int o = 0; o < S; ++o) {
      const long long o_off = ((long long)o * n_sym + k) * M + sc;
      rx_data[o_off] = demap(er[o], ei[o], cr, ci, cb, n_points);
      if (rx_sig != nullptr) rx_sig[o_off] = make_float2(er[o], ei[o]);
    }
  }
}

}  // namespace payload
