// Per-symbol cyclic-prefix strip for Hopper (sm_90a):
//   out[r][k][:] = in[r][k * pitch + drop : k * pitch + drop + keep]
// over 32-bit words, so one kernel serves float32 planes (pitch = sym,
// drop = cp, keep = M) and interleaved complex64 rows (all three doubled).
//
// Replaces the TPU Pallas kernel rub_mimo_tpu/kernels/cp_strip.py::cp_strip
// (a grid of static-offset block copies shaped by the TPU's 128-lane
// tiles; its M % 128 limit is not carried over: any M is taken).
//
// What bounds it: memory.  At the reference operating point (2 streams,
// 1000 frames of 2200 complex64 samples) it reads the 2048 kept samples
// of each frame, 33 MB (the CP's 1216 bytes are whole 32-byte sectors,
// never fetched), and writes 33 MB: a floor of ~19.6 us at the card's
// 3.35 TB/s.  One block per (frame, row)
// copies its frame's kept words, neighbouring threads on neighbouring
// addresses; where both the source and the destination of a frame are
// 16-byte aligned (the operating point's are) it moves 16 bytes a
// thread with float4 loads and stores.  The output is bit-for-bit the
// plain reshape-and-slice.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cp_strip_kernel(const float* __restrict__ in, long long row_len, int n_sym,
                int pitch, int drop, int keep, float* __restrict__ out) {
  const int k = blockIdx.x;
  const int r = blockIdx.y;
  const float* src = in + (long long)r * row_len + (long long)k * pitch + drop;
  float* dst = out + ((long long)r * n_sym + k) * keep;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0;
  int done = 0;
  if (vec) {
    const int n4 = keep >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kThreads) dst4[i] = src4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < keep; i += kThreads) dst[i] = src[i];
}

}  // namespace

// in: [rows, row_len] 32-bit words; out: [rows, n_sym, keep] words.
// Requires 1 <= rows <= 65535, n_sym >= 1, keep >= 1, drop >= 0,
// drop + keep <= pitch and n_sym * pitch <= row_len.  Returns a
// cudaError_t.
extern "C" int cp_strip(const float* in, long long row_len, int rows,
                        int n_sym, int pitch, int drop, int keep, float* out,
                        void* stream) {
  if (rows < 1 || rows > 65535 || n_sym < 1 || keep < 1 || drop < 0 ||
      drop + keep > pitch || (long long)n_sym * pitch > row_len) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_sym, rows);
  cp_strip_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, row_len, n_sym, pitch, drop, keep, out);
  return (int)cudaGetLastError();
}
