// Soft-decision Viterbi decoder of the rate-1/2, K = 7 convolutional code
// (generators 171/133 octal) for Hopper (sm_90a): the add-compare-select
// recursion over every step and the traceback, one warp per row.
//
// Not a TPU kernel: the JAX package runs this recursion as a lax.scan pair,
// rub_mimo_tpu/ofdm/fec.py:141 (_viterbi_pairs), vmapped by _viterbi_1d
// (:182) and _viterbi_windowed_1d (:197).  It computes their bits exactly:
//   bm   = s0 * (0.5 l0) + s1 * (0.5 l1)       s = +-1 from the trellis
//   cand = pm[pred] + bm                        for both predecessors
//   take1 = cand1 > cand0 (ties to cand0), pm' = the taken candidate,
//   pm'' = pm' - max(pm')                       every step
// Each product is exact and every add rounds once in round-to-nearest
// (__fmul_rn / __fadd_rn / __fsub_rn: nothing is contracted into an FMA),
// and the max is order-free, so the decisions equal the plain version's
// (kernels/viterbi.py::viterbi_plain) and the JAX CPU scan's bit for bit.
// Traceback from state 0 (a pinned row: start state 0, end state 0) or from
// the first state holding the maximum metric (a window: uniform prior).
//
// Layout: lane l holds the metrics of states l and l + 32.  Both states'
// predecessors are 2l and 2l + 1, which lanes (2l) & 31 and (2l + 1) & 31
// hold, so four shuffles bring them over; the maximum is a five-step
// butterfly; the step's 64 decisions are two ballots, kept as one 64-bit
// word per step in a [rows, T] buffer in device memory (at the operating
// point 2,500 windows x 4,352 steps = 87 MB, so every window runs in one
// wave; shared memory would hold ~8 windows an SM).  The warp loads 32
// LLR pairs at a time (one a lane, coalesced) and broadcasts each step's
// pair by shuffle; it stores 32 decision words at a time.  The traceback
// reads the words back 32 at a time and walks them by shuffle; every lane
// follows the state, and lane k keeps step k's bit for a coalesced store.
//
// What bounds it: the dependent chain.  ~6 float operations per state and
// step (4.2e9 at the operating point, ~62 us at 67 TFLOP/s) and 131 MB of
// LLRs and bits (~39 us at 3.35 TB/s) are far below the latency of 4,352
// steps of shuffle, add, compare and a five-shuffle max, one after another:
// a few hundred cycles a step.  Many warps an SM hide each other's latency.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;           // rows a block, one warp each
constexpr unsigned kPoly0 = 0171u;  // generator polynomials, MSB = input
constexpr unsigned kPoly1 = 0133u;

// +1 for coded bit 0, -1 for coded bit 1, of the register (input << 6) | s
__device__ __forceinline__ float out_sign(unsigned reg, unsigned poly) {
  return (__popc(reg & poly) & 1) ? -1.0f : 1.0f;
}

__device__ __forceinline__ float branch(float a, float b, float h0, float h1) {
  return __fadd_rn(__fmul_rn(a, h0), __fmul_rn(b, h1));
}

__global__ void __launch_bounds__(32 * kWarps)
viterbi_kernel(const float2* __restrict__ pairs,
               const unsigned char* __restrict__ pinned, int rows, int T,
               unsigned long long* __restrict__ dec, int* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float2* p = pairs + (long long)row * T;
  unsigned long long* d = dec + (long long)row * T;
  int* out = bits + (long long)row * T;
  const bool pin = pinned[row] != 0;

  // predecessors of states lane (input 0) and lane + 32 (input 1)
  const unsigned q0 = 2u * lane, q1 = q0 + 1u;
  const float a00 = out_sign(q0, kPoly0), a01 = out_sign(q0, kPoly1);
  const float a10 = out_sign(q1, kPoly0), a11 = out_sign(q1, kPoly1);
  const float b00 = out_sign(64u | q0, kPoly0);
  const float b01 = out_sign(64u | q0, kPoly1);
  const float b10 = out_sign(64u | q1, kPoly0);
  const float b11 = out_sign(64u | q1, kPoly1);
  const int src0 = q0 & 31, src1 = q1 & 31;
  const bool upper = lane >= 16;  // predecessors are states 32..63

  float pmA, pmB;  // states lane and lane + 32
  if (pin) {
    pmA = lane == 0 ? 0.0f : -1e30f;
    pmB = -1e30f;
  } else {
    pmA = pmB = 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int n = min(32, T - t0);
    const float2 mine = lane < n ? p[t0 + lane] : make_float2(0.0f, 0.0f);
    unsigned long long word = 0ull;
    for (int k = 0; k < n; ++k) {
      const float h0 = __fmul_rn(0.5f, __shfl_sync(kFull, mine.x, k));
      const float h1 = __fmul_rn(0.5f, __shfl_sync(kFull, mine.y, k));
      const float x0 = __shfl_sync(kFull, pmA, src0);
      const float y0 = __shfl_sync(kFull, pmB, src0);
      const float x1 = __shfl_sync(kFull, pmA, src1);
      const float y1 = __shfl_sync(kFull, pmB, src1);
      const float pm0 = upper ? y0 : x0;  // metric of state 2 lane
      const float pm1 = upper ? y1 : x1;  // metric of state 2 lane + 1
      const float c0A = __fadd_rn(pm0, branch(a00, a01, h0, h1));
      const float c1A = __fadd_rn(pm1, branch(a10, a11, h0, h1));
      const float c0B = __fadd_rn(pm0, branch(b00, b01, h0, h1));
      const float c1B = __fadd_rn(pm1, branch(b10, b11, h0, h1));
      const bool tA = c1A > c0A, tB = c1B > c0B;
      const float nA = tA ? c1A : c0A, nB = tB ? c1B : c0B;
      float m = fmaxf(nA, nB);
#pragma unroll
      for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      pmA = __fsub_rn(nA, m);
      pmB = __fsub_rn(nB, m);
      const unsigned lo = __ballot_sync(kFull, tA);
      const unsigned hi = __ballot_sync(kFull, tB);
      if (lane == k) {
        word = (unsigned long long)lo | ((unsigned long long)hi << 32);
      }
    }
    if (lane < n) d[t0 + lane] = word;
  }

  // start: state 0, or the first state whose normalised metric is the
  // maximum 0 (x - max == 0 only where x == max)
  int state = 0;
  if (!pin) {
    const unsigned lo = __ballot_sync(kFull, pmA == 0.0f);
    const unsigned hi = __ballot_sync(kFull, pmB == 0.0f);
    state = lo ? __ffs(lo) - 1 : 32 + __ffs(hi) - 1;
  }
  __syncwarp();  // the warp's decision stores before its loads
  for (int t0 = ((T - 1) / 32) * 32; t0 >= 0; t0 -= 32) {
    const int n = min(32, T - t0);
    const unsigned long long mine = lane < n ? d[t0 + lane] : 0ull;
    int bit = 0;
    for (int k = n - 1; k >= 0; --k) {
      const unsigned long long w = __shfl_sync(kFull, mine, k);
      if (lane == k) bit = state >> 5;  // the input bit this step consumed
      state = ((state << 1) & 63) | (int)((w >> state) & 1ull);
    }
    if (lane < n) out[t0 + lane] = bit;
  }
}

}  // namespace

// pairs: [rows, T] float2 (l0, l1); pinned: [rows] bytes, nonzero for a
// pinned row; dec: [rows, T] 64-bit scratch; bits: [rows, T] int32 out.
// Requires rows >= 1, T >= 1 and 8-byte aligned pairs.  Returns a
// cudaError_t.
extern "C" int viterbi(const float* pairs, const unsigned char* pinned,
                       int rows, int T, unsigned long long* dec, int* bits,
                       void* stream) {
  if (rows < 1 || T < 1 || (reinterpret_cast<uintptr_t>(pairs) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  viterbi_kernel<<<blocks, 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(pairs), pinned, rows, T, dec, bits);
  return (int)cudaGetLastError();
}
