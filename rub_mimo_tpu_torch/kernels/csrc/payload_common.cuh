// Device code shared by the payload kernels (sm_90a): one step of the
// nearest-neighbour hard demap and the per-subcarrier S x S equalize.
//
//   K3 eq_demap.cu (eq_demap)  equalize + demap after a separate FFT
//   K4 eq_demap.cu (demap)     hard demap alone
//
// K3 and K4 demap through demap_search.cuh's region search.  The fused
// tails K1 (payload_fused_strip.cu) and K2 (payload_fused.cu) run their
// frame block from payload_fft.cuh, which calls equalize and demap_step
// with the points in its parameter struct.  Every kernel
// rounds alike: the equalize sums j = 0..S-1 in order and scales by the
// gain last; the demap scores fma(Re(y), cr[q], fma(Im(y), ci[q], -cb[q]))
// over the points in order from -inf with a strict '>', so the first
// maximum wins.  A decision may differ from the plain PyTorch version
// only where two scores tie to within a rounding.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace payload {

// One point of the demap's search: the score of (ar, ai) against the
// point (cr, ci, cb) replaces (best, idx) when strictly larger.
__device__ __forceinline__ void demap_step(float ar, float ai, float cr,
                                           float ci, float cb, int q,
                                           float& best, int& idx) {
  const float score = fmaf(ar, cr, fmaf(ai, ci, -cb));
  if (score > best) {
    best = score;
    idx = q;
  }
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

}  // namespace payload
