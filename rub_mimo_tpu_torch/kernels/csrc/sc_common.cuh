// Shared device code of the Schmidl&Cox kernels (sc_metric.cu, sc_sync.cu):
// the per-tile metric and the block-wide reductions and scans they use.
//
// A tile covers B = L - M output positions [t0, t0 + B) of one stream.  Its
// block (THREADS threads, kItems samples each, L = THREADS * kItems) loads
// the L samples x[t0 - M + j], j < L: the tile plus its M-sample left halo.
// Positions before 0 read zeros (liquid's zero filter state,
// framing.cc:381-388) and positions at or past T read zeros too; those only
// reach outputs at or past T, which no caller writes.
//
// Per local position j the block forms
//   prod[j] = conj(x[j - M/2]) x[j]   (0 for j < M/2)
//   e[j]    = |x[j]|^2
// and the count nz[j] of nonzero samples, and their inclusive prefix sums
// P, E and C over the tile, each thread summing its kItems consecutive
// samples in registers, then warp shuffles, then the warps' totals.  For
// output t (local j = t - t0 + M):
//   corr[t]   = -(P[j] - P[j - M/2])
//   energy[t] = 0.5 (E[j] - E[j - M])
//   metric[t] = |corr[t]|^2 / energy[t]^2
// the chunk-local cumsum-difference form of the plain moving sums, over a
// chunk of L samples.  A window of zeros has metric 0/0 = NaN in the
// reference's FIR sums; float prefix sums combined in a tree need not
// cancel exactly there, so the exact integer count C decides that case.
// NaN > threshold is false, as in C; the build does not use fast math.
//
// Shared memory: P (float2), E (float) and C (int), L + L/32 entries each:
// one pad entry per 32 keeps the threads' strided chunk reads free of most
// bank conflicts.  The tile's samples are staged in P's storage first.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace sc {

constexpr int kItems = 16;  // samples per thread in a tile
constexpr int kMaxStreams = 8;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int padded(int j) { return j + (j >> 5); }

// Tile length for M: 4096 samples up to M = 2048, 8192 up to M = 4096.
__host__ __device__ constexpr int tile_threads(int M) {
  return M <= 2048 ? 256 : 512;
}

// Views of a tile block's dynamic shared memory (L local samples).
struct Tile {
  float2* P;
  float* E;
  int* C;
  __device__ Tile(void* smem, int L)
      : P(static_cast<float2*>(smem)),
        E(reinterpret_cast<float*>(P + padded(L))),
        C(reinterpret_cast<int*>(E + padded(L))) {}
};

__host__ __device__ constexpr size_t tile_smem_bytes(int L) {
  return (size_t)padded(L) * (sizeof(float2) + sizeof(float) + sizeof(int));
}

// Loads the tile of stream row xs and leaves the prefix sums in tile.
// Must be called by all THREADS threads of the block.
template <int THREADS>
__device__ void tile_prefix(const float2* __restrict__ xs, int T, int M,
                            int t0, const Tile& tile) {
  constexpr int L = THREADS * kItems;
  constexpr int kWarps = THREADS / 32;
  __shared__ float warp_tot[3][kWarps];
  __shared__ int warp_cnt[kWarps];
  float2* P = tile.P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int M2 = M >> 1;
  const int base = t0 - M;

  for (int j = tid; j < L; j += THREADS) {
    const int k = base + j;
    P[padded(j)] = (k >= 0 && k < T) ? xs[k] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  float pr[kItems], pi[kItems], en[kItems];
  int nz[kItems];
  const int j0 = tid * kItems;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int j = j0 + u;
    const float2 b = P[padded(j)];
    en[u] = b.x * b.x + b.y * b.y;
    nz[u] = (b.x != 0.f || b.y != 0.f) ? 1 : 0;
    if (j >= M2) {
      const float2 a = P[padded(j - M2)];
      pr[u] = a.x * b.x + a.y * b.y;
      pi[u] = a.x * b.y - a.y * b.x;
    } else {
      pr[u] = 0.f;
      pi[u] = 0.f;
    }
  }
  __syncthreads();  // the samples in P are overwritten below

#pragma unroll
  for (int u = 1; u < kItems; ++u) {
    pr[u] += pr[u - 1];
    pi[u] += pi[u - 1];
    en[u] += en[u - 1];
    nz[u] += nz[u - 1];
  }
  // inclusive scan of the threads' totals within the warp
  float sr = pr[kItems - 1], si = pi[kItems - 1], se = en[kItems - 1];
  int sc = nz[kItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float r = __shfl_up_sync(kFull, sr, d);
    const float i = __shfl_up_sync(kFull, si, d);
    const float e = __shfl_up_sync(kFull, se, d);
    const int c = __shfl_up_sync(kFull, sc, d);
    if (lane >= d) {
      sr += r;
      si += i;
      se += e;
      sc += c;
    }
  }
  if (lane == 31) {
    warp_tot[0][warp] = sr;
    warp_tot[1][warp] = si;
    warp_tot[2][warp] = se;
    warp_cnt[warp] = sc;
  }
  // exclusive offset of this thread: the earlier lanes, then earlier warps
  float oR = __shfl_up_sync(kFull, sr, 1);
  float oI = __shfl_up_sync(kFull, si, 1);
  float oE = __shfl_up_sync(kFull, se, 1);
  int oC = __shfl_up_sync(kFull, sc, 1);
  if (lane == 0) {
    oR = 0.f;
    oI = 0.f;
    oE = 0.f;
    oC = 0;
  }
  __syncthreads();
  float wR = 0.f, wI = 0.f, wE = 0.f;
  for (int w = 0; w < warp; ++w) {
    wR += warp_tot[0][w];
    wI += warp_tot[1][w];
    wE += warp_tot[2][w];
    oC += warp_cnt[w];
  }
  oR += wR;
  oI += wI;
  oE += wE;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int q = padded(j0 + u);
    P[q] = make_float2(pr[u] + oR, pi[u] + oI);
    tile.E[q] = en[u] + oE;
    tile.C[q] = nz[u] + oC;
  }
  __syncthreads();
}

// The metric at local position j (M <= j < L) from the tile's prefix
// sums.
__device__ __forceinline__ float metric_at(const Tile& tile, int j, int M) {
  if (tile.C[padded(j)] == tile.C[padded(j - M)]) return CUDART_NAN_F;
  const float2 p1 = tile.P[padded(j)];
  const float2 p0 = tile.P[padded(j - (M >> 1))];
  const float cr = -(p1.x - p0.x);
  const float ci = -(p1.y - p0.y);
  const float en = 0.5f * (tile.E[padded(j)] - tile.E[padded(j - M)]);
  return (cr * cr + ci * ci) / (en * en);
}

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

// Block-wide max of v, returned to every thread.  red: >= 33 ints of
// shared memory.  blockDim.x must be a multiple of 32.
__device__ __forceinline__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < n_warps ? red[lane] : -1);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

// Block-wide sum of v, returned to every thread.  red: >= 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < n_warps ? red[lane] : 0.f);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
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
