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
// writes 16 MB, ~15 us.  A demap that scores every point costs each
// symbol five instructions per point (two FMAs, a compare, two selects),
// which at 32 points and two streams outlasts the bytes; so both kernels
// decide through demap_search.cuh's decision-region search (one shared
// load per symbol, one more and one score per candidate where a cell has
// several; the full scan only outside the grid's box).
//
// K3: a block of kEqThreads threads owns a tile of subcarriers, one per
// thread, and walks a range of frames: each thread loads its W[sc] and
// gain once into registers (with its first frame, before the block's
// table copy) and loads frame k + 1's S symbols while it equalizes,
// demaps and stores frame k.  The grid is the tiles times the
// frame ranges, sized by the occupancy calculator to one wave
// (kernels/eq_demap.py::eq_block_plan is the same plan).
// K4: a grid-stride loop over an occupancy-sized grid, the next step's
// loads in flight.  Where that still gives every SM kFillBlocks blocks,
// each thread takes four symbols a step with two 16-byte loads and one
// 16-byte store where the output is 16-byte aligned (a y that is only
// 8-byte aligned starts with one symbol alone; the head and the last
// numel % 4 symbols go to block 0's first threads); a shorter call, such
// as one channel-tracking block, takes one symbol a thread.  Each block
// starts the loads of its first symbols, then copies the table into
// shared memory (cp.async, all copies in flight).
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "demap_search.cuh"
#include "payload_common.cuh"

namespace {

constexpr int kThreads = 256;    // K4
constexpr int kEqThreads = 256;  // K3: subcarriers per tile
constexpr int kMaxDemapPoints = 256;
constexpr int kMaxEqPoints = 64;
constexpr int kDevs = 16;
constexpr int kFillBlocks = 4;  // K4: blocks per SM that V = 4 must give

// K4 on symbols [0, n), V = 4: `head` (0 or 1) symbols before y + head
// is 16-byte aligned, then nv = (n - head) / 4 steps of four, then the
// rest; V = 1 (head 0): n steps of one.
template <int V>
__global__ void __launch_bounds__(kThreads)
demap_kernel(const float2* __restrict__ y, long long n, int head,
             int vec_out, const uint4* __restrict__ table,
             const search::Grid g, int* __restrict__ out) {
  __shared__ uint4 tab[search::kCellVecs + kMaxDemapPoints];
  const long long nv = (n - head) / V;
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  float yr[V], yi[V];
  // this thread's first symbols, loaded before the table
  auto load = [&](long long step, float (&ar)[V], float (&ai)[V]) {
    if constexpr (V == 4) {
      const float4* y4 = reinterpret_cast<const float4*>(y + head);
      const float4 a = __ldcs(y4 + 2 * step), b = __ldcs(y4 + 2 * step + 1);
      ar[0] = a.x, ai[0] = a.y, ar[1] = a.z, ai[1] = a.w;
      ar[2] = b.x, ai[2] = b.y, ar[3] = b.z, ai[3] = b.w;
    } else {
      const float2 a = __ldcs(y + step);
      ar[0] = a.x, ai[0] = a.y;
    }
  };
  if (v < nv) load(v, yr, yi);
  search::load_table(table, g.n, tab);
  __syncthreads();
  // V = 4: the head and tail symbols, one thread each
  const int t = threadIdx.x;
  const long long rest = n - head - V * nv;
  if (blockIdx.x == 0 && t < head + rest) {
    const long long i = t < head ? 0 : V * nv + t;
    const float2 s = y[i];
    float ar[1] = {s.x}, ai[1] = {s.y};
    int d[1];
    search::demap<1>(ar, ai, g, tab, d);
    out[i] = d[0];
  }
  for (; v < nv; v += stride) {
    float nr[V] = {}, ni[V] = {};
    if (v + stride < nv) load(v + stride, nr, ni);
    int d[V];
    search::demap<V>(yr, yi, g, tab, d);
    int* o = out + head + V * v;
    if constexpr (V == 4) {
      if (vec_out) {
        __stcs(reinterpret_cast<int4*>(o), make_int4(d[0], d[1], d[2], d[3]));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) __stcs(o + e, d[e]);
      }
    } else {
      __stcs(o, d[0]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      yr[e] = nr[e];
      yi[e] = ni[e];
    }
  }
}

// K3: block b owns subcarriers [tile * kEqThreads, +kEqThreads) of frames
// r, r + ranges, r + 2 ranges, ... below n_sym, tile = b % tiles, r =
// b / tiles (so the grid works on neighbouring frames at any time).  A
// thread loads its weights, gain and first frame before the block copies
// the table.
template <int S>
__global__ void __launch_bounds__(kEqThreads)
eq_demap_kernel(const float2* __restrict__ X, const float2* __restrict__ W,
                const float* __restrict__ gain,
                const uint4* __restrict__ table, const search::Grid grid,
                int M, int n_sym, int tiles, int ranges,
                int* __restrict__ rx_data, float2* __restrict__ rx_sig) {
  __shared__ uint4 tab[search::kCellVecs + kMaxEqPoints];
  const int tile = blockIdx.x % tiles;
  const int k0 = blockIdx.x / tiles;
  const int sc = min(tile * kEqThreads + (int)threadIdx.x, M - 1);
  const bool live = tile * kEqThreads + (int)threadIdx.x < M;
  const long long plane = (long long)n_sym * M;
  float2 w[S * S];
#pragma unroll
  for (int i = 0; i < S * S; ++i) w[i] = __ldg(W + sc * S * S + i);
  const float g = __ldg(gain + sc);
  long long off = (long long)k0 * M + sc;
  float2 x[S];
#pragma unroll
  for (int j = 0; j < S; ++j) x[j] = __ldcs(X + j * plane + off);
  search::load_table(table, grid.n, tab);
  __syncthreads();
  if (!live) return;
  const long long step = (long long)ranges * M;
  for (int k = k0; k < n_sym; k += ranges, off += step) {
    float2 xn[S];
#pragma unroll
    for (int j = 0; j < S; ++j) xn[j] = x[j];
    if (k + ranges < n_sym) {
#pragma unroll
      for (int j = 0; j < S; ++j) xn[j] = __ldcs(X + j * plane + off + step);
    }
    float er[S], ei[S];
    payload::equalize<S>(x, w, 0, g, er, ei);
    int d[S];
    search::demap<S>(er, ei, grid, tab, d);
#pragma unroll
    for (int o = 0; o < S; ++o) {
      __stcs(rx_data + o * plane + off, d[o]);
      if (rx_sig != nullptr)
        __stcs(rx_sig + o * plane + off, make_float2(er[o], ei[o]));
    }
#pragma unroll
    for (int j = 0; j < S; ++j) x[j] = xn[j];
  }
}

// Blocks of `kernel` per SM (static shared memory, kBlock threads) and
// the SM count of the current device, cached per instance and device.
template <auto Kernel, int kBlock>
cudaError_t occupancy(int* blocks_per_sm, int* n_sm) {
  static int cache[kDevs];
  static int sms[kDevs];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevs) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int s = 0;
    e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms[dev] = s;
  }
  if (cache[dev] == 0) {
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, Kernel, kBlock, 0);
    if (e != cudaSuccess) return e;
    if (b < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = b;
  }
  *blocks_per_sm = cache[dev];
  *n_sm = sms[dev];
  return cudaSuccess;
}

// K3's plan: tiles of kEqThreads subcarriers times frame ranges, as many
// ranges as fill one wave of blocks_per_sm * n_sm blocks (at least one,
// at most n_sym).
struct EqPlan {
  int tiles, ranges, blocks_per_sm, n_sm;
};

template <int S>
cudaError_t eq_plan(int M, int n_sym, EqPlan* plan) {
  EqPlan& g = *plan;
  cudaError_t e =
      occupancy<eq_demap_kernel<S>, kEqThreads>(&g.blocks_per_sm, &g.n_sm);
  if (e != cudaSuccess) return e;
  g.tiles = (M + kEqThreads - 1) / kEqThreads;
  const int fill = g.blocks_per_sm * g.n_sm / g.tiles;
  g.ranges = fill < 1 ? 1 : (fill < n_sym ? fill : n_sym);
  return cudaSuccess;
}

template <int S>
cudaError_t launch_eq(const float2* X, const float2* W, const float* gain,
                      const uint4* table, const search::Grid& grid, int M,
                      int n_sym, int* rx_data, float2* rx_sig,
                      cudaStream_t stream) {
  EqPlan g;
  cudaError_t e = eq_plan<S>(M, n_sym, &g);
  if (e != cudaSuccess) return e;
  eq_demap_kernel<S><<<g.tiles * g.ranges, kEqThreads, 0, stream>>>(
      X, W, gain, table, grid, M, n_sym, g.tiles, g.ranges, rx_data,
      rx_sig);
  return cudaGetLastError();
}

cudaError_t eq_plan_for(int S, int M, int n_sym, EqPlan* g) {
  switch (S) {
    case 1: return eq_plan<1>(M, n_sym, g);
    case 2: return eq_plan<2>(M, n_sym, g);
    case 3: return eq_plan<3>(M, n_sym, g);
    case 4: return eq_plan<4>(M, n_sym, g);
    default: return cudaErrorInvalidValue;
  }
}

// K4's launch: four symbols a thread and step (V = 4) where that gives
// every SM kFillBlocks blocks, else one (V = 1: four times the threads
// for a short call); one thread per step, at most one wave of the
// instance's blocks.  geo[0] = V, [1] = blocks, [2] = blocks per SM,
// [3] = SMs.
cudaError_t demap_grid(long long n, int head, int* geo) {
  int bps = 0, n_sm = 0;
  cudaError_t e = occupancy<demap_kernel<1>, kThreads>(&bps, &n_sm);
  if (e != cudaSuccess) return e;
  const int V =
      (n - head) / 4 >= (long long)kFillBlocks * n_sm * kThreads ? 4 : 1;
  if (V == 4) {
    e = occupancy<demap_kernel<4>, kThreads>(&bps, &n_sm);
    if (e != cudaSuccess) return e;
  }
  const long long wave = (long long)bps * n_sm;
  const long long need =
      ((n - (V == 4 ? head : 0)) / V + kThreads - 1) / kThreads;
  geo[0] = V;
  geo[1] = (int)(need < 1 ? 1 : (need < wave ? need : wave));
  geo[2] = bps;
  geo[3] = n_sm;
  return cudaSuccess;
}

bool grid_ok(const void* table, int n_points, int max_points, float box,
             float scale) {
  return n_points >= 1 && n_points <= max_points && box > 0.f &&
         scale > 0.f && ((uintptr_t)table & 15) == 0;
}

int head_of(const float2* y) {
  return ((uintptr_t)y & 15) == 0 ? 0 : 1;
}

}  // namespace

// y: [n] complex64 (8-byte aligned); table: the device region table of
// the points (kernels/eq_demap.py::device_table: 64 x 64 cell words, then
// n_points float4 (Re c, Im c, |c|^2 / 2, 0)), 1 <= n_points <= 256;
// box, scale: the table's grid; out: [n] int32.  Requires 1 <= n < 2^40.
// Returns a cudaError_t.
extern "C" int hard_demap(const float2* y, long long n, const void* table,
                          int n_points, float box, float scale, int* out,
                          void* stream) {
  if (n < 1 || n >= (1LL << 40) || ((uintptr_t)y & 7) != 0 ||
      !grid_ok(table, n_points, kMaxDemapPoints, box, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  int head = head_of(y);
  int geo[4];
  cudaError_t e = demap_grid(n, head, geo);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  const search::Grid g{n_points, box, scale};
  if (geo[0] == 4) {
    demap_kernel<4><<<geo[1], kThreads, 0, st>>>(
        y, n, head, ((uintptr_t)(out + head) & 15) == 0, t, g, out);
  } else {
    demap_kernel<1><<<geo[1], kThreads, 0, st>>>(y, n, 0, 0, t, g, out);
  }
  return (int)cudaGetLastError();
}

// K4's launch for n symbols of which `head` (0 or 1) come before the
// first 16-byte aligned one: out[0] = symbols a thread and step, [1] =
// grid, [2] = blocks per SM, [3] = SMs, [4] = threads.  Launches
// nothing.  Returns a cudaError_t.
extern "C" int demap_geometry(long long n, int head, int* out) {
  if (n < 1 || head < 0 || head > 1) return (int)cudaErrorInvalidValue;
  out[4] = kThreads;
  return (int)demap_grid(n, head, out);
}

// X: [S, n_sym, M] complex64 (already scaled by the DFT normalizer)
// W: [M, S(out), S(rx)] complex64; gain: [M] f32
// table, box, scale: as hard_demap's, 1 <= n_points <= 64
// rx_data: [S, n_sym, M] int32; rx_sig: [S, n_sym, M] complex64 or null
// Requires 1 <= S <= 4, M >= 1, n_sym >= 1.  Returns a cudaError_t.
extern "C" int eq_demap(const float2* X, const float2* W, const float* gain,
                        const void* table, int n_points, float box,
                        float scale, int S, int M, int n_sym, int* rx_data,
                        float2* rx_sig, void* stream) {
  if (M < 1 || n_sym < 1 ||
      !grid_ok(table, n_points, kMaxEqPoints, box, scale)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint4* t = static_cast<const uint4*>(table);
  const search::Grid g{n_points, box, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return (int)launch_eq<1>(X, W, gain, t, g, M, n_sym, rx_data, rx_sig,
                               st);
    case 2:
      return (int)launch_eq<2>(X, W, gain, t, g, M, n_sym, rx_data, rx_sig,
                               st);
    case 3:
      return (int)launch_eq<3>(X, W, gain, t, g, M, n_sym, rx_data, rx_sig,
                               st);
    case 4:
      return (int)launch_eq<4>(X, W, gain, t, g, M, n_sym, rx_data, rx_sig,
                               st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3's plan for S streams, M subcarriers, n_sym frames: out[0] = tiles,
// [1] = frame ranges, [2] = blocks per SM, [3] = SMs, [4] = threads.
// Launches nothing.  Returns a cudaError_t.
extern "C" int eq_demap_geometry(int S, int M, int n_sym, int* out) {
  if (M < 1 || n_sym < 1) return (int)cudaErrorInvalidValue;
  EqPlan g;
  const cudaError_t e = eq_plan_for(S, M, n_sym, &g);
  if (e != cudaSuccess) return (int)e;
  out[0] = g.tiles;
  out[1] = g.ranges;
  out[2] = g.blocks_per_sm;
  out[3] = g.n_sm;
  out[4] = kEqThreads;
  return (int)cudaSuccess;
}
