// Device stage marks for Hopper (sm_90a): one thread writes
// (sequence number, mark, %globaltimer ns) into a ring the program owns.
//
// No TPU counterpart: the decode's stage bounds inside a CUDA graph
// replay, which host-side records cannot split (a replay is one launch).
// The decode launches one mark at each of its stage bounds
// (utils/profiling.py MARKS); each mark is its own kernel,
// span_mark_<mark>, so a profiler trace names it.  Mark 0
// (decode.begin) increments the sequence word, the others read it.
//
// word[0]: the sequence number (decodes marked so far); word[1]: marks
// written so far (the ring's next slot is word[1] % cap).  The ring is
// [cap, 3] int64.  One thread, a few stores: its time is a launch's.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mark(long long* ring,
                                     unsigned long long* word, int cap,
                                     int id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long seq =
      id == 0 ? atomicAdd(&word[0], 1ULL) + 1ULL
              : *reinterpret_cast<volatile unsigned long long*>(&word[0]);
  const unsigned long long i =
      atomicAdd(&word[1], 1ULL) % static_cast<unsigned long long>(cap);
  ring[3 * i] = static_cast<long long>(seq);
  ring[3 * i + 1] = id;
  ring[3 * i + 2] = static_cast<long long>(t);
}

}  // namespace

#define SPAN_MARK(NAME, ID)                                             \
  __global__ void span_mark_##NAME(long long* ring,                     \
                                   unsigned long long* word, int cap) { \
    mark(ring, word, cap, ID);                                          \
  }

SPAN_MARK(begin, 0)
SPAN_MARK(complex, 1)
SPAN_MARK(sync, 2)
SPAN_MARK(timing, 3)
SPAN_MARK(channel, 4)
SPAN_MARK(window, 5)
SPAN_MARK(end, 6)

// Launch mark `id` (0..6) on `stream`.  Returns a cudaError_t.
extern "C" int span_mark(int id, long long* ring, unsigned long long* word,
                         int cap, void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (id) {
    case 0: span_mark_begin<<<1, 1, 0, s>>>(ring, word, cap); break;
    case 1: span_mark_complex<<<1, 1, 0, s>>>(ring, word, cap); break;
    case 2: span_mark_sync<<<1, 1, 0, s>>>(ring, word, cap); break;
    case 3: span_mark_timing<<<1, 1, 0, s>>>(ring, word, cap); break;
    case 4: span_mark_channel<<<1, 1, 0, s>>>(ring, word, cap); break;
    case 5: span_mark_window<<<1, 1, 0, s>>>(ring, word, cap); break;
    case 6: span_mark_end<<<1, 1, 0, s>>>(ring, word, cap); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
