// Halo exchange along the mesh's "time" axis for Hopper (sm_90a): every
// shard (t, s) receives the [rows, len] complex64 halo of shard (t-1, s);
// the shards of t = 0 receive zeros.  One launch moves every shard's halo.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/halo_dma.py::ring_shift_right
//   (body _shift_kernel),
// whose symmetric ring of make_async_remote_copy DMAs between chips (with
// the wrap-around copy into shard 0 masked to zeros afterwards) was shaped
// by the TPU's inter-chip links.  Here the mesh's shards sit on one card:
// each block copies one destination shard's halo from its left
// neighbour's buffer and the t = 0 shards are written with zeros by the
// kernel itself, so there is no wrap-around copy to mask.  Complex samples
// move as float2; the TPU kernel's [S, 2, H] float32 planes were a Pallas
// TPU limit (no complex dtype) and are not carried over.
//
// The source and destination pointers of every shard come by value in the
// kernel's parameter struct (at most kMaxShards shards): no pointer table
// is copied to the device before the launch.
//
// What bounds it: memory, and at the sizes the sharded decode gives it,
// launch latency.  At the reference operating point (M=2048, S=2, a
// (4, 1) mesh) it reads three halos and writes four, [2, 2047] complex64
// each: ~229 KB, well under a microsecond at the card's 3.35 TB/s.  Each
// thread moves one float2; neighbouring threads touch neighbouring
// addresses of a row.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

}  // namespace

// One exchange.  Shard i = t * n_sc + s.  src[i]: shard i's halo, row r at
// src[i] + r * src_row_stride (float2 elements); dst[i]: where shard i's
// received halo goes, [rows, len] contiguous.
struct HaloParams {
  const float2* src[kMaxShards];
  float2* dst[kMaxShards];
  long long src_row_stride;
  int rows;
  int len;
  int n_time;
  int n_sc;
};

namespace {

__global__ void __launch_bounds__(kThreads)
ring_shift_right_kernel(const HaloParams p) {
  const int i = blockIdx.y;  // destination shard
  const int t = i / p.n_sc;
  const int s = i - t * p.n_sc;
  float2* __restrict__ dst = p.dst[i];
  const long long n = (long long)p.rows * p.len;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t == 0) {
    for (long long e = first; e < n; e += step) {
      dst[e] = make_float2(0.f, 0.f);
    }
    return;
  }
  const float2* __restrict__ src = p.src[(t - 1) * p.n_sc + s];
  for (long long e = first; e < n; e += step) {
    const long long r = e / p.len;
    const long long c = e - r * p.len;
    dst[e] = src[r * p.src_row_stride + c];
  }
}

}  // namespace

// p: the exchange (host memory; passed to the kernel by value).
// Requires 1 <= n_time, 1 <= n_sc, n_time * n_sc <= 64, rows >= 1,
// len >= 1, src_row_stride >= len.  Returns a cudaError_t.
extern "C" int ring_shift_right(const HaloParams* p, void* stream) {
  if (p == nullptr || p->n_time < 1 || p->n_sc < 1 ||
      p->n_time * p->n_sc > kMaxShards || p->rows < 1 || p->len < 1 ||
      p->src_row_stride < p->len) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)p->rows * p->len;
  long long gx = (n + kThreads - 1) / kThreads;
  if (gx > kMaxBlocksX) gx = kMaxBlocksX;
  const dim3 grid((unsigned)gx, (unsigned)(p->n_time * p->n_sc));
  ring_shift_right_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}
