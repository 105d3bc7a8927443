// Schmidl&Cox timing metric over a whole capture for Hopper (sm_90a), one
// launch.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/sc_metric.py::sc_metric_pallas
// whose grid walked each stream's blocks in order and kept the previous
// block as the next one's M-sample history.  Here a persistent grid makes
// the same walk, one span of it per thread block:
//
//   metric[s][t] = |corr[s][t]|^2 / energy[s][t]^2,
//   corr[t]   = -sum_{k<M/2} conj(x[t-k-M/2]) x[t-k],
//   energy[t] = 0.5 sum_{k<M} |x[t-k]|^2          (framing.cc:626-637)
//
// with zeros before t = 0 on every row (liquid's zero filter state,
// framing.cc:381-388).
//
// The span plan.  Each row is cut into chunks of C = W - M output positions,
// W = THREADS * 16 window samples (4096 up to M = 2048, 8192 up to M = 4096).
// The N = S * ceil(T / C) chunks, in row-major order, are split into one
// contiguous span per block of a persistent grid of G = min(N, blocks per SM
// x SMs) blocks (the occupancy calculator's count): block b takes chunks
// [b N / G, (b + 1) N / G) and walks them in order.  K6 writes every output,
// so there is no ticket, no atomic and no early exit, and no block waits on
// another.
//
// The carried history.  Chunk [c0, c0 + C) reads the window of samples
// [c0 - M, c0 + C).  The block keeps a ring of W samples in shared memory,
// sample g at slot g mod W.  When the next chunk continues the row, the
// first M samples of its window are the last M of this one and stay where
// they are; only its C new samples [c0 + C, c0 + 2C) are copied, into the
// slots of [c0 - M, c0 + C - M), which this chunk has read into registers by
// then.  A span's first chunk, and a chunk where the span crosses into the
// next row, load their whole window instead: zeros before 0 and at or past
// T (those reach only outputs past T, which are not written).  So device
// memory sees each sample once, plus one M-sample history per span, and
// stacked rows of any length need no special case.  Carrying is exact: the
// ring holds the very samples a reload would bring.
//
// Per chunk, three barriers (the copy landed; the samples read and the
// warps' totals in; the prefix sums in):
//   1. each thread takes 16 consecutive window positions j from the ring and
//      forms prod[j] = conj(x[j - M/2]) x[j] (0 for j < M/2: no output reads
//      those) and e[j] = |x[j]|^2, their inclusive prefix over its items,
//      then over its warp by shuffles;
//   2. the next chunk's copy starts (cp.async, 8 bytes a sample: a row starts
//      only 8-byte aligned when T is odd) and runs under the rest; each
//      thread adds the earlier warps' totals and stores the prefix sums P and
//      E over the window in shared memory;
//   3. output t = c0 + i (i < C, t < T) at window position j = M + i, the
//      threads in turn over i, one coalesced store each:
//        corr = -(P[j] - P[j - M/2]),  energy = 0.5 (E[j] - E[j - M]),
//        metric = |corr|^2 / energy^2  (IEEE division: no fast math).
//
// Precision.  The prefix sums restart at 0 at each chunk's window, so every
// difference that forms an output spans at most W = C + M samples (at most
// 8192, within the plain version's block of 2^15 + M): its error is that of
// a W-sample float32 sum, whatever the span or T.  The history's prefix is
// recomputed from the kept samples at each chunk.  Carrying the previous
// chunk's sums instead (rebased at each chunk) halves the prefix work, but
// measured only 5 % faster at the operating point and slower on short
// spans, which then need a chunk without outputs first (PERF.md §6).
//
// Zeros.  A window of zeros is 0/0 = NaN in the reference's FIR sums; float
// prefix sums combined in a tree need not cancel exactly there, so an exact
// integer count of nonzero samples decides that case (NaN where the counts
// at j and j - M are equal).  Only a window that holds a zero sample can
// contain such a window: the block learns at barrier 2 (__syncthreads_or)
// whether its window does, and only then forms the counts (one more
// barrier) and reads them per output.
//
// What bounds it: memory.  It must read the [S, T] complex64 capture once
// and write the [S, T] float32 metric once, 12 S T bytes: 16.5 us at
// 3.35 TB/s at the reference operating point ([2, 2,297,248], M = 2048).  It
// loads S T samples plus M per span.  The prefix work is W / C per output (2
// at M = 2048), in registers and shared memory.
//
// Plain C interface for ctypes; the launcher returns a cudaError_t.

#include "sc_common.cuh"

namespace {

constexpr int kDevs = 16;

// Threads of the block for M: window W = THREADS * kItems > M.
constexpr int threads_for(int M) { return M <= 2048 ? 256 : 512; }

// One float2 of pad per 16 entries: a thread's 16 consecutive entries
// (threads 16 entries apart) and 32 consecutive entries both fall on
// distinct banks, two wavefronts a warp.
__host__ __device__ constexpr int pad16(int j) { return j + (j >> 4); }

// Dynamic shared memory for a window of W samples: the ring of samples,
// then the prefix sums P (float2), E (float) and the nonzero counts (int)
// over the window.
struct Layout {
  size_t P, E, C, bytes;
  __host__ __device__ constexpr explicit Layout(int W)
      : P(sizeof(float2) * pad16(W)),
        E(P + sizeof(float2) * pad16(W)),
        C(E + sizeof(float) * sc::padded(W)),
        bytes(C + sizeof(int) * sc::padded(W)) {}
};

// Starts the copy of samples x[g], g in [g0, g0 + n), of row xs into their
// ring slots g mod W (zeros before 0 and at or past T), 8 bytes a copy, as
// one cp.async group.  g0 and n are multiples of 32.
template <int THREADS>
__device__ __forceinline__ void load_ring(float2* ring, const float2* xs,
                                          int T, int g0, int n) {
  constexpr int W = THREADS * sc::kItems;
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const int g = g0 + j;
    const bool in = g >= 0 && g < T;
    const unsigned d =
        (unsigned)__cvta_generic_to_shared(ring + pad16(g & (W - 1)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(in ? xs + g : xs), "r"(in ? 8 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS <= 256 ? 2 : 1)
sc_metric_kernel(const float2* __restrict__ x, int T, int M,
                 int row_chunks, long long n_chunks,
                 float* __restrict__ metric) {
  constexpr int W = THREADS * sc::kItems;
  constexpr int kWarps = THREADS / 32;
  constexpr Layout lay(W);
  extern __shared__ __align__(16) unsigned char smem[];
  float2* ring = reinterpret_cast<float2*>(smem);
  float2* P = reinterpret_cast<float2*>(smem + lay.P);
  float* E = reinterpret_cast<float*>(smem + lay.E);
  int* Cn = reinterpret_cast<int*>(smem + lay.C);
  __shared__ float warp_tot[3][kWarps];
  __shared__ int warp_cnt[kWarps];
  const int C = W - M;
  const int M2 = M >> 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = tid * sc::kItems;

  // this block's span of chunks, row-major
  long long q = blockIdx.x * n_chunks / gridDim.x;
  const long long q_end = (blockIdx.x + 1) * n_chunks / gridDim.x;
  int s = (int)(q / row_chunks);
  int k = (int)(q - (long long)s * row_chunks);
  load_ring<THREADS>(ring, x + (long long)s * T, T, k * C - M, W);

  for (;;) {
    const int c0 = k * C;
    copy_wait();
    __syncthreads();  // the window is in the ring

    // (j0 and M/2 are multiples of 16, and so is c0 - M: a thread's items
    // and their lags are 16 consecutive slots of one pad group, and all or
    // none of them have a lag product)
    const int base = c0 - M + j0;
    const float2* rb = ring + pad16(base & (W - 1));
    const float2* ra = ring + pad16((base - M2) & (W - 1));
    const bool lag = j0 >= M2;
    float pr[sc::kItems], pi[sc::kItems], en[sc::kItems];
    unsigned nzm = 0u;  // bit u: item u is nonzero
#pragma unroll
    for (int u = 0; u < sc::kItems; ++u) {
      const float2 b = rb[u];
      en[u] = b.x * b.x + b.y * b.y;
      nzm |= (b.x != 0.f || b.y != 0.f ? 1u : 0u) << u;
      if (lag) {
        const float2 a = ra[u];
        pr[u] = a.x * b.x + a.y * b.y;
        pi[u] = a.x * b.y - a.y * b.x;
      } else {
        pr[u] = 0.f;
        pi[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 1; u < sc::kItems; ++u) {
      pr[u] += pr[u - 1];
      pi[u] += pi[u - 1];
      en[u] += en[u - 1];
    }
    // inclusive scan of the threads' totals within the warp
    float sr = pr[sc::kItems - 1], si = pi[sc::kItems - 1];
    float se = en[sc::kItems - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float r = __shfl_up_sync(sc::kFull, sr, d);
      const float i = __shfl_up_sync(sc::kFull, si, d);
      const float e = __shfl_up_sync(sc::kFull, se, d);
      if (lane >= d) {
        sr += r;
        si += i;
        se += e;
      }
    }
    if (lane == 31) {
      warp_tot[0][warp] = sr;
      warp_tot[1][warp] = si;
      warp_tot[2][warp] = se;
    }
    // exclusive offset of this thread: the earlier lanes, then earlier warps
    float oR = __shfl_up_sync(sc::kFull, sr, 1);
    float oI = __shfl_up_sync(sc::kFull, si, 1);
    float oE = __shfl_up_sync(sc::kFull, se, 1);
    if (lane == 0) {
      oR = 0.f;
      oI = 0.f;
      oE = 0.f;
    }
    // the ring is read and the warps' totals are in
    const bool zeros = __syncthreads_or(nzm != 0xffffu);

    // the next chunk's copy runs under the rest of this one: its C new
    // samples when it continues the row, else its whole window
    const bool more = q + 1 < q_end;
    int ns = s, nk = k + 1;
    if (nk == row_chunks) {
      ++ns;
      nk = 0;
    }
    if (more) {
      const float2* xs = x + (long long)ns * T;
      if (ns == s) {
        load_ring<THREADS>(ring, xs, T, c0 + C, C);
      } else {
        load_ring<THREADS>(ring, xs, T, -M, W);
      }
    }

    float wR = 0.f, wI = 0.f, wE = 0.f;
    for (int w = 0; w < warp; ++w) {
      wR += warp_tot[0][w];
      wI += warp_tot[1][w];
      wE += warp_tot[2][w];
    }
    oR += wR;
    oI += wI;
    oE += wE;
    float2* pb = P + pad16(j0);
    float* eb = E + sc::padded(j0);
#pragma unroll
    for (int u = 0; u < sc::kItems; ++u) {
      pb[u] = make_float2(pr[u] + oR, pi[u] + oI);
      eb[u] = en[u] + oE;
    }
    if (zeros) {
      // the exact nonzero counts, only for a window with a zero sample:
      // the items' prefix from the mask, the threads' by a warp scan and
      // the warps' totals in order
      int sn = __popc(nzm);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int c = __shfl_up_sync(sc::kFull, sn, d);
        if (lane >= d) sn += c;
      }
      if (lane == 31) warp_cnt[warp] = sn;
      int oC = __shfl_up_sync(sc::kFull, sn, 1);
      if (lane == 0) oC = 0;
      __syncthreads();
      for (int w = 0; w < warp; ++w) oC += warp_cnt[w];
      int* cb = Cn + sc::padded(j0);
#pragma unroll
      for (int u = 0; u < sc::kItems; ++u) {
        cb[u] = oC + __popc(nzm & ((2u << u) - 1u));
      }
    }
    __syncthreads();  // the prefix sums are in

    float* out = metric + (long long)s * T + c0;
    const int n_out = min(C, T - c0);
#pragma unroll 4
    for (int i = tid; i < n_out; i += THREADS) {
      const int j = M + i;
      const float2 p1 = P[pad16(j)];
      const float2 p0 = P[pad16(j - M2)];
      const float cr = -(p1.x - p0.x);
      const float ci = -(p1.y - p0.y);
      const float e = 0.5f * (E[sc::padded(j)] - E[sc::padded(j - M)]);
      float m = (cr * cr + ci * ci) / (e * e);
      // without a zero sample in the window no count can be equal and
      // the counts are not read
      if (zeros && Cn[sc::padded(j)] == Cn[sc::padded(j - M)]) {
        m = CUDART_NAN_F;
      }
      out[i] = m;
    }
    if (!more) return;  // no copy is in flight
    ++q;
    s = ns;
    k = nk;
  }
}

// Blocks of sc_metric_kernel<THREADS> per SM and the SM count of the
// current device, cached per device; the dynamic shared-memory limit is
// raised once per device.
template <int THREADS>
cudaError_t occupancy(int* blocks_per_sm, int* n_sm) {
  static int cache[kDevs];
  static int sms[kDevs];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevs) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    const int smem = (int)Layout(THREADS * sc::kItems).bytes;
    e = cudaFuncSetAttribute(sc_metric_kernel<THREADS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, sc_metric_kernel<THREADS>, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (b < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
    cache[dev] = b;
  }
  *blocks_per_sm = cache[dev];
  *n_sm = sms[dev];
  return cudaSuccess;
}

// geo (may be null): grid, blocks per SM, SMs, threads, chunk length,
// dynamic shared memory bytes; with geo the kernel is not launched.
template <int THREADS>
cudaError_t launch(const float2* x, int S, int T, int M, float* metric,
                   cudaStream_t stream, int* geo) {
  constexpr int W = THREADS * sc::kItems;
  const int smem = (int)Layout(W).bytes;
  const int C = W - M;
  const int row_chunks = (T + C - 1) / C;
  const long long n_chunks = (long long)S * row_chunks;
  int bps = 0, n_sm = 0;
  cudaError_t e = occupancy<THREADS>(&bps, &n_sm);
  if (e != cudaSuccess) return e;
  const long long full = (long long)bps * n_sm;
  const int grid = (int)(n_chunks < full ? n_chunks : full);
  if (geo != nullptr) {
    geo[0] = grid; geo[1] = bps; geo[2] = n_sm;
    geo[3] = THREADS; geo[4] = C; geo[5] = smem;
    return cudaSuccess;
  }
  sc_metric_kernel<THREADS><<<grid, THREADS, smem, stream>>>(
      x, T, M, row_chunks, n_chunks, metric);
  return cudaGetLastError();
}

int dispatch(const float2* x, int S, int T, int M, float* metric,
             void* stream, int* geo) {
  if (S < 1 || S > 65535 || T < 1 || T >= (1 << 30) || M < 32 ||
      M > 4096 || M % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads_for(M) == 256) {
    return (int)launch<256>(x, S, T, M, metric, st, geo);
  }
  return (int)launch<512>(x, S, T, M, metric, st, geo);
}

}  // namespace

// The launch's geometry on the current device for (S, T, M): geo[6] =
// grid, blocks per SM, SMs, threads, chunk length C, dynamic shared
// bytes.  Launches nothing.  Returns a cudaError_t.
extern "C" int sc_metric_geometry(int S, int T, int M, int* geo) {
  return dispatch(nullptr, S, T, M, nullptr, nullptr, geo);
}

// x: [S, T] complex64 (interleaved re, im); metric: [S, T] float32.
// Requires 1 <= S <= 65535, 1 <= T < 2^30, M a multiple of 32 in
// [32, 4096].  Returns a cudaError_t.
extern "C" int sc_metric(const float2* x, int S, int T, int M, float* metric,
                         void* stream) {
  return dispatch(x, S, T, M, metric, stream, nullptr);
}
