// The whole Schmidl&Cox sync stage for Hopper (sm_90a): metric, plateau
// runs, the first sample where every stream fires, and the correlation
// there (the CFO observable).
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/sc_sync.py::sc_sync_fused
// which carried the last-below-threshold index and the fired flag in SMEM
// from one grid step to the next: TPU grid steps run in order.  Thread
// blocks on the H100 run in no order, so nothing is carried block to
// block; the scan is split into three launches on the caller's stream:
//
//   1. tiles (grid: tiles x streams).  Each block computes its tile's metric
//      (sc_common.cuh), writes one bit per sample, above[s][t] =
//      metric > threshold (a warp ballot per 32 samples; NaN is not
//      above, as in C), and the tile's last below-threshold index
//      tile_lb[s][tile] (-1 if none).  Block (0, 0) resets t*.
//   2. fire (grid: tiles).  Each block takes as carry the max of tile_lb
//      over the earlier tiles, then one thread per 32-bit word of the tile
//      finds the last below index before its word (a block-wide exclusive
//      prefix max of the words' last zero bits), walks its 32 samples
//      with the run start = last below + 1, and tests
//         above && t - run_start > cp_len   on every stream.
//      The first sample that passes is atomicMin'd into t*.
//   3. final (one block).  synced = (t* was set); t* = 0 when not (the
//      full scan's argmax-of-nothing default).  Per stream: the run start
//      at t* (carry of the earlier tiles and the in-tile bits up to t*),
//      and corr[t*] = -sum over the M/2 lag products that end at t*,
//      summed directly.
//
// So this replicates the plain version (the full metric, the cummax
// plateau scan with the all-streams rule, corr at t*) except for the
// rounding of the metric's prefix sums, which are chunk-local like the
// plain moving sums: a metric within ~1 ulp of the threshold could decide
// a run differently.
//
// What bounds it: memory.  Pass 1 reads the capture twice (halo) and
// writes one bit per sample (~0.6 MB at the reference operating point);
// pass 2 reads the bits and tile_lb; pass 3 reads M samples per stream.
// ~75 MB in all at the operating point, a floor of ~23 us at 3.35 TB/s.
// Nothing is read back to the host.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "sc_common.cuh"

namespace {

constexpr int kBig = 1 << 30;  // "no fire yet"; positions are below it
constexpr int kFireThreads = 256;  // >= words per tile (tile < 8192)
constexpr int kFinalThreads = 256;

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
sc_sync_tiles(const float2* __restrict__ x, int T, int M, float thr,
              int n_tiles, int n_words, unsigned* __restrict__ above,
              int* __restrict__ tile_lb, int* __restrict__ tstar) {
  constexpr int L = THREADS * sc::kItems;
  extern __shared__ float2 smem[];
  __shared__ int red[33];
  const sc::Tile tile(smem, L);
  const int s = blockIdx.y;
  const int B = L - M;  // a multiple of 32: whole words per tile
  const int t0 = blockIdx.x * B;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *tstar = kBig;
  sc::tile_prefix<THREADS>(x + (long long)s * T, T, M, t0, tile);

  int lb = -1;
  // i runs over whole warps (B % 32 == 0): each warp ballots 32
  // consecutive samples into one word
  for (int i = threadIdx.x; i < B; i += THREADS) {
    const int t = t0 + i;
    bool up = false;
    if (t < T) {
      up = sc::metric_at(tile, i + M, M) > thr;
      if (!up) lb = t;
    }
    const unsigned word = __ballot_sync(sc::kFull, up);
    const int w = t >> 5;
    if ((threadIdx.x & 31) == 0 && w < n_words) {
      above[(long long)s * n_words + w] = word;
    }
  }
  lb = sc::block_max(lb, red);
  if (threadIdx.x == 0) tile_lb[(long long)s * n_tiles + blockIdx.x] = lb;
}

// Last index of a zero bit in word w (bit i is sample 32 w + i), or -1.
__device__ __forceinline__ int last_zero(unsigned word, int w) {
  const unsigned inv = ~word;
  return inv ? w * 32 + 31 - __clz(inv) : -1;
}

__global__ void __launch_bounds__(kFireThreads)
sc_sync_fire(const unsigned* __restrict__ above,
             const int* __restrict__ tile_lb, int T, int S, int cp,
             int n_tiles, int n_words, int words_per_tile,
             int* __restrict__ tstar) {
  __shared__ int red[33];
  const int b = blockIdx.x;
  const int gw = b * words_per_tile + threadIdx.x;
  const bool mine = threadIdx.x < words_per_tile && gw < n_words;
  unsigned word[sc::kMaxStreams];
  int prev[sc::kMaxStreams];
  for (int s = 0; s < S; ++s) {
    int carry = -1;
    for (int q = threadIdx.x; q < b; q += kFireThreads) {
      carry = max(carry, tile_lb[(long long)s * n_tiles + q]);
    }
    carry = sc::block_max(carry, red);
    word[s] = mine ? above[(long long)s * n_words + gw] : sc::kFull;
    prev[s] = max(carry,
                  sc::block_exclusive_max(last_zero(word[s], gw), red));
  }
  if (!mine) return;
  for (int i = 0; i < 32; ++i) {
    const int t = gw * 32 + i;
    if (t >= T) break;
    bool all = true;
    for (int s = 0; s < S; ++s) {
      if ((word[s] >> i) & 1u) {
        all = all && (t - (prev[s] + 1) > cp);
      } else {
        prev[s] = t;
        all = false;
      }
    }
    if (all) {
      atomicMin(tstar, t);
      return;
    }
  }
}

__global__ void __launch_bounds__(kFinalThreads)
sc_sync_final(const float2* __restrict__ x, const unsigned* __restrict__ above,
              const int* __restrict__ tile_lb, int T, int S, int M,
              int tile_len, int n_tiles, int n_words,
              const int* __restrict__ tstar, unsigned char* synced_out,
              long long* tstar_out, long long* starts,
              float2* __restrict__ corr) {
  __shared__ int ired[33];
  __shared__ float fred[33];
  const int raw = *tstar;
  const bool fired = raw < kBig;
  const int t = fired ? raw : 0;
  const int b = t / tile_len;
  const int w_lo = (b * tile_len) >> 5;
  const int w_hi = t >> 5;
  const int M2 = M >> 1;
  for (int s = 0; s < S; ++s) {
    int lb = -1;
    for (int q = threadIdx.x; q < b; q += kFinalThreads) {
      lb = max(lb, tile_lb[(long long)s * n_tiles + q]);
    }
    for (int w = w_lo + threadIdx.x; w <= w_hi; w += kFinalThreads) {
      unsigned word = above[(long long)s * n_words + w];
      const int i = t & 31;
      if (w == w_hi && i < 31) word |= sc::kFull << (i + 1);  // past t
      lb = max(lb, last_zero(word, w));
    }
    lb = sc::block_max(lb, ired);
    const float2* xs = x + (long long)s * T;
    float cr = 0.f, ci = 0.f;
    for (int k = t - M2 + 1 + threadIdx.x; k <= t; k += kFinalThreads) {
      if (k >= M2) {  // x before sample 0 is zero
        const float2 a = xs[k - M2];
        const float2 c = xs[k];
        cr += a.x * c.x + a.y * c.y;
        ci += a.x * c.y - a.y * c.x;
      }
    }
    cr = sc::block_sum(cr, fred);
    ci = sc::block_sum(ci, fred);
    if (threadIdx.x == 0) {
      starts[s] = lb + 1;
      corr[s] = make_float2(-cr, -ci);
    }
  }
  if (threadIdx.x == 0) {
    *synced_out = fired ? 1 : 0;
    *tstar_out = t;
  }
}

template <int THREADS>
cudaError_t launch(const float2* x, int S, int T, int M, int cp, float thr,
                   unsigned* above, int* tile_lb, int* tstar,
                   unsigned char* synced, long long* tstar_out,
                   long long* starts, float2* corr, cudaStream_t stream) {
  constexpr int L = THREADS * sc::kItems;
  const size_t smem = sc::tile_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      sc_sync_tiles<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int B = L - M;
  const int n_tiles = (T + B - 1) / B;
  const int n_words = (T + 31) / 32;
  sc_sync_tiles<THREADS><<<dim3(n_tiles, S), THREADS, smem, stream>>>(
      x, T, M, thr, n_tiles, n_words, above, tile_lb, tstar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sc_sync_fire<<<n_tiles, kFireThreads, 0, stream>>>(
      above, tile_lb, T, S, cp, n_tiles, n_words, B / 32, tstar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sc_sync_final<<<1, kFinalThreads, 0, stream>>>(
      x, above, tile_lb, T, S, M, B, n_tiles, n_words, tstar, synced,
      tstar_out, starts, corr);
  return cudaGetLastError();
}

}  // namespace

// Tile length (output samples per tile) for M; the caller sizes tile_lb
// as [S, ceil(T / tile_len)].
extern "C" int sc_sync_tile_len(int M) {
  return sc::tile_threads(M) * sc::kItems - M;
}

// x: [S, T] complex64 (interleaved re, im).
// Scratch: above [S, ceil(T/32)] uint32, tile_lb [S, n_tiles] int32,
// tstar [1] int32.  Outputs: synced [1] uint8 (bool), tstar_out [1] int64,
// starts [S] int64, corr [S] complex64.
// Requires 1 <= S <= 8, 1 <= T < 2^30, M a multiple of 32 in [32, 4096],
// cp >= 0.  Returns a cudaError_t.
extern "C" int sc_sync(const float2* x, int S, int T, int M, int cp,
                       float thr, unsigned* above, int* tile_lb, int* tstar,
                       unsigned char* synced, long long* tstar_out,
                       long long* starts, float2* corr, void* stream) {
  if (S < 1 || S > sc::kMaxStreams || T < 1 || T >= kBig || M < 32 ||
      M > 4096 || M % 32 != 0 || cp < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sc::tile_threads(M) == 256) {
    return (int)launch<256>(x, S, T, M, cp, thr, above, tile_lb, tstar,
                            synced, tstar_out, starts, corr, st);
  }
  return (int)launch<512>(x, S, T, M, cp, thr, above, tile_lb, tstar,
                          synced, tstar_out, starts, corr, st);
}
