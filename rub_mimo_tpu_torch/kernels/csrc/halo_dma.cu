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
// One controller (ring_shift_right): one launch covers the destination
// shards of one card.  A mesh on one card is one launch; a mesh over
// several cards is one launch per card that holds a destination shard
// (kernels/halo_dma.py groups them), on that card's stream.  A source may
// lie on another card: with peer access enabled (enable_peer_access below)
// unified addressing makes its pointer valid in the kernel, and the loads
// go over NVLink.  The ordering of the two cards' streams around the read
// is the caller's (the wrapper's events), as is the choice of card.  The
// destinations may be strided views (the rows of the sharded decode's
// stage A), so the received halo is written once, where it is read.
//
// Across processes (halo_exchange, kernels/halo_dma.py ProcessHalo): the
// TPU kernel's send and receive semaphores become flag words in device
// memory, in the same exported allocation as the halos, so one launch a
// rank a call does what the TPU kernel's DMAs and semaphores did, with no
// host barrier and no stream synchronization.  Every flag a rank waits on
// is a word of its own, kept twice: in its exported device buffer, which
// its kernel acquires, and in host memory shared by the ranks (a POSIX
// shared memory page each rank maps and registers with CUDA), which its
// stream waits on.  The rank that raises a flag writes both from its
// kernel, the device word first, through its mappings:
//   publish  the rank copies each halo a neighbour rank reads straight
//            from its strided source view into slot epoch % 2 of its
//            exported buffer; after every publishing block's stores a
//            last-block-done counter, a system-scope fence and
//            st.release.sys stores raise arrived = epoch in the reader's
//            words of that pull;
//   pull     a destination whose left neighbour is another rank reads
//            that rank's slot through the IPC mapping (L2 loads, after
//            an acquire of its arrived word and a block barrier) into its
//            rows, then raises consumed = epoch in the source rank's
//            words of that halo (remote release stores);
//   reuse    a publishing block overwrites its slot only once consumed >=
//            epoch - 2: the reader is done with the slot's previous halo.
//            Two slots are what let both host barriers go.
// The waits themselves are the stream's: before the launch the wrapper
// queues one cuStreamWaitValue64 a word (stream_wait_geq below), which
// the card's front end holds, so a waiting rank holds no SM and, where
// two ranks share a card, does not keep the other rank's context off it
// for a time slice.  The stream waits on the host word, because a wait
// the peer never ends must be ended from the host: a stream held by a
// wait holds the hardware queue it shares with other streams, so no copy
// or kernel of the waiting process is sure to run, while a store from the
// CPU is (scripts/stream_wait_release.py).  In the kernel, thread 0 of
// each waiting block then acquires the device word (ld.acquire.sys),
// which is what orders the data loads and stores after the other rank's
// release; an acquire of the host word costs a PCIe read, 14-15 us for a
// launch's blocks.  It spins, with __nanosleep back-off, only where the
// device word is still short (never after the stream's wait), reading
// the host word meanwhile, and traps past the caller's time limit.  A
// host word set to kAbort (the wrapper's watchdog releases a wait that
// outlived its limit so, by a store from the host) traps at once: the
// caller's next synchronization raises, and nothing returns stale data or
// zeros.
// A destination whose left neighbour is on the same rank copies straight
// from that source view, and t = 0 writes zeros: neither waits.  The waits
// form a chain along "time" (t = 0 reads nothing), never a cycle.
//
// Complex samples move as float2; the TPU kernel's [S, 2, H] float32
// planes were a Pallas TPU limit (no complex dtype) and are not carried
// over.  Pointers come by value in the kernels' parameter structs (at most
// kMaxShards destinations): no pointer table is copied to the device
// before a launch.
//
// What bounds it: memory, and at the sizes the sharded decode gives it,
// launch latency (one controller) or the neighbour's progress (across
// processes).  At the reference operating point (M=2048, S=2) a
// destination's halo is [2, 2047] complex64, 32,752 bytes: well under a
// microsecond from HBM at 3.35 TB/s or over NVLink at 450 GB/s one way.
// Each thread moves one float2; neighbouring threads touch neighbouring
// addresses of a row, so a peer read is whole 32-byte sectors.
//
// Plain C interface for ctypes; the functions return a cudaError_t.

#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdio>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

// A rank's flag words, 8 bytes each (offsets in words; kernels/
// halo_dma.py's buffer_layout mirrors them), at the head of its exported
// device buffer; its host page holds the wait words at the same offsets.
// The publish counter has a 128-byte line of its own.
constexpr int kPublishCountWord = 0;  // publishing blocks done this launch
constexpr int kArrivedWord = 16;     // + k: the last epoch pull k's halo
                                     // was published (by its source)
constexpr int kConsumedWord = 96;    // + p: the last epoch halo p was pulled
constexpr int kPullCountWord = 160;  // + k: pull k's blocks done this launch
constexpr int kFlagWords = 256;      // the slots start 2,048 bytes in
// A wait word at or above this value was released by the watchdog
// (which writes kAbort | 0x7FFFFFFF: the front end's wait compares the low
// 32 bits).
constexpr unsigned long long kAbort = 1ULL << 62;

// Marks a block of halo_exchange_kernel writes where the caller asks for
// them: globaltimer at its start, after its wait, after its copy (ns),
// and clock64 at the same three points.
constexpr int kMarks = 6;

}  // namespace

// One launch.  Destination k (blockIdx.y): src[k] is the halo it
// receives, row r at src[k] + r * src_row_stride (float2 elements), or
// null for a shard of t = 0 (zeros); dst[k] is where it goes, [rows, len]
// with row r at dst[k] + r * dst_row_stride (0: rows of len, contiguous),
// on the launch's card.
struct HaloParams {
  const float2* src[kMaxShards];
  float2* dst[kMaxShards];
  long long src_row_stride;
  int rows;
  int len;
  int n_dst;
  long long dst_row_stride;
};

// One rank's launch of a cross-process exchange.  Jobs (blockIdx.y): the
// n_pub halos this rank publishes, then its n_dst destinations.
//   pub_src[p]   a halo this rank publishes (row stride src_row_stride),
//                into pub_slot + p * rows * len;
//   arrived[p], arrived_dev[p]  the reader's arrived word of halo p in
//                its host page and in its device buffer (mapped);
//   pull_src[k]  destination k's halo: null (t = 0, zeros), a source view
//                of this rank (consumed[k] null; row stride
//                src_row_stride) or the left neighbour rank's slot of
//                this epoch through the IPC mapping (rows contiguous);
//   consumed[k], consumed_dev[k]  for a pull from another rank: the
//                source rank's consumed word of the halo read in its host
//                page and in its device buffer (mapped); null otherwise;
//   dst[k]       where destination k's halo goes (row stride
//                dst_row_stride);
//   flags        this rank's host page (mapped);
//   words        this rank's device words (its exported buffer's head);
//   marks        null, or kMarks words a block (blockIdx.y * gridDim.x +
//                blockIdx.x).
struct ExchangeParams {
  const float2* pub_src[kMaxShards];
  const float2* pull_src[kMaxShards];
  float2* dst[kMaxShards];
  unsigned long long* arrived[kMaxShards];
  unsigned long long* arrived_dev[kMaxShards];
  unsigned long long* consumed[kMaxShards];
  unsigned long long* consumed_dev[kMaxShards];
  float2* pub_slot;
  unsigned long long* flags;
  unsigned long long* words;
  long long* marks;
  long long src_row_stride;
  long long dst_row_stride;
  unsigned long long epoch;
  unsigned long long timeout_ns;
  int rows;
  int len;
  int n_pub;
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
  const long long dst_stride = p.dst_row_stride > 0 ? p.dst_row_stride
                                                    : p.len;
  for (long long e = first; e < n; e += step) {
    const long long r = e / p.len;
    const long long c = e - r * p.len;
    dst[r * dst_stride + c] = src == nullptr
        ? make_float2(0.f, 0.f) : src[r * p.src_row_stride + c];
  }
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* word,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(word), "l"(v) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long ld_relaxed_sys(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(word) : "memory");
  return v;
}

// Thread 0: acquire the device word *word (system scope) until it is >=
// want, spinning with back-off while it is short; trap where its host
// copy *host shows the watchdog released the wait (kAbort) or once
// timeout_ns have passed (the peer is late past the caller's limit, or
// gone).
__device__ void wait_at_least(const unsigned long long* word,
                              const unsigned long long* host,
                              unsigned long long want,
                              unsigned long long timeout_ns) {
  unsigned long long v = ld_acquire_sys(word);
  const long long start = global_ns();
  unsigned int pause = 32;
  while (v < want) {
    if (ld_relaxed_sys(host) >= kAbort ||
        (unsigned long long)(global_ns() - start) > timeout_ns) {
      printf("halo_exchange: epoch %llu not reached within the time "
             "limit (block %d, %d)\n", want, (int)blockIdx.x,
             (int)blockIdx.y);
      __trap();
    }
    __nanosleep(pause);
    if (pause < 2048) pause <<= 1;
    v = ld_acquire_sys(word);
  }
}

__device__ __forceinline__ void mark(long long* marks, int at) {
  if (marks != nullptr && threadIdx.x == 0) {
    long long* m = marks + (long long)kMarks *
                   (blockIdx.y * gridDim.x + blockIdx.x);
    m[at] = global_ns();
    m[3 + at] = clock64();
  }
}

// Thread 0, after the block's barrier: count this block done in *count
// (of `blocks`); the last block resets the counter for the next launch
// and returns true.  The fence before the count orders the block's
// accesses (the barrier makes them the thread's) before it.
__device__ __forceinline__ bool last_block(unsigned long long* count,
                                           unsigned int blocks) {
  __threadfence_system();
  if (atomicAdd(count, 1ULL) != blocks - 1) return false;
  *count = 0;
  __threadfence_system();
  return true;
}

__global__ void __launch_bounds__(kThreads)
halo_exchange_kernel(const ExchangeParams p) {
  const int job = blockIdx.y;
  const long long n = (long long)p.rows * p.len;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  mark(p.marks, 0);
  if (job < p.n_pub) {
    // publish halo `job` into this epoch's slot, once its reader is done
    // with the slot's previous halo (two epochs ago)
    if (threadIdx.x == 0) {
      wait_at_least(p.words + kConsumedWord + job,
                    p.flags + kConsumedWord + job,
                    p.epoch > 2 ? p.epoch - 2 : 0, p.timeout_ns);
    }
    __syncthreads();
    mark(p.marks, 1);
    const float2* __restrict__ src = p.pub_src[job];
    float2* __restrict__ slot = p.pub_slot + job * n;
    for (long long e = first; e < n; e += step) {
      const long long r = e / p.len;
      slot[e] = src[r * p.src_row_stride + (e - r * p.len)];
    }
    __syncthreads();
    mark(p.marks, 2);
    if (threadIdx.x == 0 &&
        last_block(p.words + kPublishCountWord, p.n_pub * gridDim.x)) {
      for (int q = 0; q < p.n_pub; ++q) {
        st_release_sys(p.arrived_dev[q], p.epoch);
        st_release_sys(p.arrived[q], p.epoch);
      }
    }
    return;
  }
  const int k = job - p.n_pub;
  const float2* __restrict__ src = p.pull_src[k];
  float2* __restrict__ dst = p.dst[k];
  const bool remote = p.consumed[k] != nullptr;
  if (remote) {
    if (threadIdx.x == 0) {
      wait_at_least(p.words + kArrivedWord + k, p.flags + kArrivedWord + k,
                    p.epoch, p.timeout_ns);
    }
    __syncthreads();
  }
  mark(p.marks, 1);
  for (long long e = first; e < n; e += step) {
    const long long r = e / p.len;
    const long long c = e - r * p.len;
    float2 v = make_float2(0.f, 0.f);
    if (remote) {
      v = __ldcg(src + e);  // L2, never an L1 line of an earlier epoch
    } else if (src != nullptr) {
      v = src[r * p.src_row_stride + c];
    }
    dst[r * p.dst_row_stride + c] = v;
  }
  if (!remote) {
    mark(p.marks, 2);
    return;
  }
  __syncthreads();
  mark(p.marks, 2);
  if (threadIdx.x == 0 &&
      last_block(p.words + kPullCountWord + k, gridDim.x)) {
    st_release_sys(p.consumed_dev[k], p.epoch);
    st_release_sys(p.consumed[k], p.epoch);
  }
}

}  // namespace

// p: one launch's destinations (host memory; passed to the kernel by
// value), on the current device's `stream`.  Requires 1 <= n_dst <= 64,
// rows >= 1, len >= 1, src_row_stride >= len, dst_row_stride 0 or >= len.
extern "C" int ring_shift_right(const HaloParams* p, void* stream) {
  if (p == nullptr || p->n_dst < 1 || p->n_dst > kMaxShards ||
      p->rows < 1 || p->len < 1 || p->src_row_stride < p->len ||
      (p->dst_row_stride != 0 && p->dst_row_stride < p->len)) {
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

// One rank's launch of a cross-process exchange (ExchangeParams) on the
// current device's `stream`, after the stream's waits (stream_wait_geq).
// Requires 0 <= n_dst, n_pub <= 64, one job at least, rows >= 1, len >=
// 1, both row strides >= len, epoch >= 1, flags and words set and, with
// n_pub > 0,
// pub_slot set.  Waits for nothing on the host.
extern "C" int halo_exchange(const ExchangeParams* p, void* stream) {
  if (p == nullptr || p->n_dst < 0 || p->n_dst > kMaxShards ||
      p->n_pub < 0 || p->n_pub > kMaxShards || p->n_pub + p->n_dst < 1 ||
      p->rows < 1 || p->len < 1 ||
      p->src_row_stride < p->len || p->dst_row_stride < p->len ||
      p->epoch < 1 || p->flags == nullptr || p->words == nullptr ||
      (p->n_pub > 0 && p->pub_slot == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)p->rows * p->len;
  long long gx = (n + kThreads - 1) / kThreads;
  if (gx > kMaxBlocksX) gx = kMaxBlocksX;
  const dim3 grid((unsigned)gx, (unsigned)(p->n_pub + p->n_dst));
  halo_exchange_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

namespace {

// cuStreamWaitValue64 of libcuda, looked up at first use
typedef int (*WaitValueFn)(void*, unsigned long long, unsigned long long,
                           unsigned int);

WaitValueFn wait_value() {
  static WaitValueFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      fn = reinterpret_cast<WaitValueFn>(
          dlsym(lib, "cuStreamWaitValue64_v2"));
    }
  }
  return fn;
}

}  // namespace

// The stream waits, in the card's front end, until the 64-bit word at
// `word` (device memory of this context, or mapped into it) is >= value
// (cuStreamWaitValue64, CU_STREAM_WAIT_VALUE_GEQ: (int64)(*word - value)
// >= 0).  Work queued after it starts only then; no block runs meanwhile.
// Returns the call's CUresult (cudaErrorSharedObjectSymbolNotFound where
// libcuda lacks it).
extern "C" int stream_wait_geq(void* stream, const void* word,
                               unsigned long long value) {
  const WaitValueFn fn = wait_value();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  return fn(stream, reinterpret_cast<unsigned long long>(word), value, 0);
}

// Load the exchange kernel into the current device's context now.  With
// CUDA's lazy loading a kernel is loaded at its first launch, and that
// load waits for the legacy default stream: behind a stream wait that a
// late peer holds, the first launch would block the host until the peer
// arrives.
extern "C" int halo_exchange_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, halo_exchange_kernel);
}

// Register `bytes` of host memory at `ptr` (a shared memory page) with
// CUDA, mapped into the device's address space: *dev_ptr is where this
// process's kernels and stream waits reach it.  Portable: every card of
// the process.
extern "C" int host_register(void* ptr, long long bytes, void** dev_ptr) {
  cudaError_t err = cudaHostRegister(
      ptr, (size_t)bytes, cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (err == cudaSuccess) err = cudaHostGetDevicePointer(dev_ptr, ptr, 0);
  return (int)err;
}

extern "C" int host_unregister(void* ptr) {
  return (int)cudaHostUnregister(ptr);
}

// The exchange's blocks a job (gridDim.x) for a halo of `elements` float2:
// the caller sizes its marks with it.
extern "C" int halo_exchange_blocks(long long elements) {
  long long gx = (elements + kThreads - 1) / kThreads;
  return (int)(gx > kMaxBlocksX ? kMaxBlocksX : gx);
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
