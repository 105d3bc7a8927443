// Halo exchange along the mesh's "time" axis for Hopper (sm_90a): every
// shard (t, s) receives the [rows, len] complex64 halo of shard (t-1, s);
// the shards of t = 0 receive zeros.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/halo_dma.py::ring_shift_right
//   (body _shift_kernel),
// whose symmetric ring of make_async_remote_copy DMAs between chips (each
// chip pushes to its right neighbour and waits for its own send and
// receive, with the wrap-around copy into shard 0 masked to zeros
// afterwards) was shaped by the TPU's inter-chip links.  Here each
// destination pulls: a block copies one destination shard's halo from its
// left neighbour's buffer, and the t = 0 shards are written with zeros by
// the kernel itself, so there is no wrap-around copy to mask.
//
// One launch covers the destination shards of one card.  A mesh on one
// card is one launch; a mesh over several cards is one launch per card
// that holds a destination shard (kernels/halo_dma.py groups them), on
// that card's stream.  A source may lie on another card: with peer access
// enabled (enable_peer_access below) unified addressing makes its pointer
// valid in the kernel, and the loads go over NVLink.  The ordering of the
// two cards' streams around the read is the caller's (the wrapper's
// events), as is the choice of card.
//
// Complex samples move as float2; the TPU kernel's [S, 2, H] float32
// planes were a Pallas TPU limit (no complex dtype) and are not carried
// over.  The source and destination pointers come by value in the
// kernel's parameter struct (at most kMaxShards destinations): no pointer
// table is copied to the device before the launch.
//
// What bounds it: memory, and at the sizes the sharded decode gives it,
// launch latency.  At the reference operating point (M=2048, S=2) a
// destination's halo is [2, 2047] complex64, 32,752 bytes: well under a
// microsecond from HBM at 3.35 TB/s or over NVLink at 450 GB/s one way.
// Each thread moves one float2; neighbouring threads touch neighbouring
// addresses of a row, so a peer read is whole 32-byte sectors.
//
// Across processes (one rank a card, or several ranks on one card) the
// kernel is the same: each rank copies its shards' halos into a buffer it
// exports once with ipc_export, its neighbour maps that buffer once with
// ipc_open, and the neighbour's destination then pulls through the mapped
// pointer.  The two ranks' host handshake around the launch (the
// wrapper's) orders the copy, the pull and the next copy, where the TPU
// kernel had its send and receive semaphores.
//
// Plain C interface for ctypes; the functions return a cudaError_t.

#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

}  // namespace

// One launch.  Destination k (blockIdx.y): src[k] is the halo it
// receives, row r at src[k] + r * src_row_stride (float2 elements), or
// null for a shard of t = 0 (zeros); dst[k] is where it goes, [rows, len]
// contiguous, on the launch's card.
struct HaloParams {
  const float2* src[kMaxShards];
  float2* dst[kMaxShards];
  long long src_row_stride;
  int rows;
  int len;
  int n_dst;
};

namespace {

__global__ void __launch_bounds__(kThreads)
ring_shift_right_kernel(const HaloParams p) {
  const int k = blockIdx.y;
  float2* __restrict__ dst = p.dst[k];
  const float2* __restrict__ src = p.src[k];
  const long long n = (long long)p.rows * p.len;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (src == nullptr) {
    for (long long e = first; e < n; e += step) {
      dst[e] = make_float2(0.f, 0.f);
    }
    return;
  }
  for (long long e = first; e < n; e += step) {
    const long long r = e / p.len;
    const long long c = e - r * p.len;
    dst[e] = src[r * p.src_row_stride + c];
  }
}

}  // namespace

// p: one launch's destinations (host memory; passed to the kernel by
// value), on the current device's `stream`.  Requires 1 <= n_dst <= 64,
// rows >= 1, len >= 1, src_row_stride >= len.
extern "C" int ring_shift_right(const HaloParams* p, void* stream) {
  if (p == nullptr || p->n_dst < 1 || p->n_dst > kMaxShards ||
      p->rows < 1 || p->len < 1 || p->src_row_stride < p->len) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)p->rows * p->len;
  long long gx = (n + kThreads - 1) / kThreads;
  if (gx > kMaxBlocksX) gx = kMaxBlocksX;
  const dim3 grid((unsigned)gx, (unsigned)p->n_dst);
  ring_shift_right_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

// Peer access: lets kernels on `device` read memory of `peer`.  Returns
// cudaErrorPeerAccessUnsupported where cudaDeviceCanAccessPeer says no
// (the wrapper raises; there is no other route).  Access that is already
// enabled, by an earlier call or by PyTorch for its own cross-device
// copies, counts as success; that call leaves
// cudaErrorPeerAccessAlreadyEnabled as the thread's last error, which is
// cleared here, or the next launch's cudaGetLastError() would report it.
// The current device is restored before returning.
extern "C" int enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int current = 0;
  err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restore);
}

// ---- buffers shared across processes -------------------------------------

namespace {

// cuMemGetAddressRange_v2 of libcuda, looked up at first use (the
// library links only the CUDA runtime)
typedef int (*AddressRangeFn)(unsigned long long*, size_t*,
                              unsigned long long);

AddressRangeFn address_range() {
  static AddressRangeFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      fn = reinterpret_cast<AddressRangeFn>(
          dlsym(lib, "cuMemGetAddressRange_v2"));
    }
  }
  return fn;
}

}  // namespace

// Export the allocation that holds `ptr` (memory of `device`) for other
// processes: its handle into *handle and ptr's byte offset from the
// allocation's base into *offset.  A handle names the whole cudaMalloc
// block, which a caching allocator shares among tensors, so the importer
// adds the offset to the base it maps.  The current device is restored.
extern "C" int ipc_export(int device, const void* ptr,
                          cudaIpcMemHandle_t* handle, long long* offset) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(nullptr);  // the context is current
  if (err == cudaSuccess) {
    const AddressRangeFn fn = address_range();
    unsigned long long base = 0;
    size_t size = 0;
    if (fn == nullptr) {
      err = cudaErrorSharedObjectSymbolNotFound;
    } else if (fn(&base, &size, reinterpret_cast<unsigned long long>(ptr))
               != 0) {
      err = cudaErrorInvalidDevicePointer;
    } else {
      err = cudaIpcGetMemHandle(handle, reinterpret_cast<void*>(base));
      *offset = (long long)(reinterpret_cast<unsigned long long>(ptr) - base);
    }
  }
  const cudaError_t restore = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restore);
}

// Map another process's exported allocation into this one on `device`:
// *base is where its base lies here.  cudaIpcMemLazyEnablePeerAccess lets
// a card read another card's allocation; on the exporter's own card (two
// ranks on one card) no peer access is involved.  A process cannot open
// its own handle.  The current device is restored.
extern "C" int ipc_open(int device, const cudaIpcMemHandle_t* handle,
                        void** base) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaIpcOpenMemHandle(base, *handle,
                               cudaIpcMemLazyEnablePeerAccess);
  }
  const cudaError_t restore = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restore);
}

// Unmap what ipc_open mapped; before the exporter frees its buffer.
extern "C" int ipc_close(int device, void* base) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(base);
  const cudaError_t restore = cudaSetDevice(current);
  return (int)(err != cudaSuccess ? err : restore);
}
