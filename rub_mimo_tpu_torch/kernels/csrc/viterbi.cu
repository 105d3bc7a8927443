// Soft-decision Viterbi decoder of the rate-1/2, K = 7 convolutional code
// (generators 171/133 octal) for Hopper (sm_90a): the add-compare-select
// recursion over every step and the traceback, 8 lanes a row (4 rows a
// warp) with a block's last rows on one-row warps.
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
// (kernels/viterbi.py::viterbi_plain) and the JAX CPU scan's bit for bit
// on finite LLRs (a metric is never -0, so a state's new metric is the
// larger candidate; NaN pairs are outside this, as they were before).
// Both generators tap the newest and the oldest register bit, so the four
// branches of a butterfly (states 2k, 2k + 1 into k, k + 32) carry +-bm of
// one bm in {+-A, +-B}, A = fl(h0 + h1), B = fl(h0 - h1), h = 0.5 l: the
// same values as the plain version's four sums (a negated sum rounds to
// the negated value), so a candidate is one add or subtract of A or B.
// Rounding is monotone, so the largest of a butterfly's four candidates
// is fl(max(pm[2k], pm[2k + 1]) + |bm|): the step's maximum comes from the
// predecessors and |bm| alone and its reduction runs beside the
// compare-selects.
// Traceback from state 0 (a pinned row: start state 0, end state 0) or from
// the first state holding the maximum metric (a window: uniform prior).
//
// Layouts (each path has its own note below): a row on 8 lanes of 8
// states, in place (no predecessor crosses lanes for three steps in four,
// then a transpose through shared memory), 4 rows a warp; a block holds 4
// such warps and 4 one-row warps (32 lanes, strided: the predecessors
// brought over by shuffle every step), so that the rows past 16 an SM (388
// of the operating point's 2,500 on 132 SMs) run one a partition beside an
// in-place warp rather than doubling one.  Of the widths measured on the
// operating point's rows (8, 16 and 32 lanes a row) 8 was the fastest
// (PERF.md).  A group past the last row shadows it, storing nothing, so
// every lane of a warp takes part in each shuffle, ballot and reduction.
//
// What bounds it: the dependent chain of each row and the issue slots of
// the few warps an SM partition holds.  ~6 float operations per state and
// step (4.2e9 at the operating point, ~62 us at 67 TFLOP/s) and 131 MB of
// LLRs and bits (~39 us at 3.35 TB/s) are far below 4,352 steps of
// subtract, max and a group maximum (three xor-shuffle levels in place, a
// whole-warp integer reduction on a one-row warp), one after another, with the
// step's ~80 compare-select instructions issued around it, then the walk
// back (a select, a shift and a mask a step).  One row a warp (the
// previous kernel's layout) puts ~5 warps of shuffle trees on each SM
// partition; in-place groups of 8 carry 4 rows a warp with no predecessor
// shuffles, and the step's maximum, taken from the predecessors, overlaps
// the compare-selects.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block

// parity of a 6-bit state mask (folds to a constant for constant x)
__host__ __device__ constexpr bool parity(unsigned x) {
  return ((x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5)) & 1u)
         != 0u;
}
// the bits of predecessor 2k that generator 171 (a butterfly's sign) and
// 171 ^ 133 (A or B) tap, for the branch from 2k into state k
constexpr unsigned kSignTaps = 0x38u;  // 0b111000
constexpr unsigned kPairTaps = 0x22u;  // 0b100010

// the maximum of x over the group of L lanes holding a row (L = 8 or 32):
// a butterfly of xor-shuffles in a group, and for a whole warp one integer
// reduction
// on the floats' order-preserving keys (finite metrics; -0 falls below
// +0, the same value).  Reductions over part of a warp run far slower.
template <int L>
__device__ __forceinline__ float group_max(float x) {
  static_assert(L == 8 || L == 32, "groups of 8 or 32 lanes");
  if constexpr (L < 32) {
#pragma unroll
    for (int o = L / 2; o; o >>= 1) {
      x = fmaxf(x, __shfl_xor_sync(kFull, x, o, L));
    }
    return x;
  } else {
    int key = __float_as_int(x);
    key ^= (key >> 31) & 0x7fffffff;
    key = __reduce_max_sync(kFull, key);
    key ^= (key >> 31) & 0x7fffffff;
    return __int_as_float(key);
  }
}

// bit s of a 64-bit decision word held as two halves
__device__ __forceinline__ int word_bit(unsigned lo, unsigned hi, int s) {
  return (int)(((s & 32) ? hi : lo) >> (s & 31)) & 1;
}

// ---- one row a warp: lane j holds states j and j + 32 (strided)
//
// Predecessors 2k and 2k + 1 of the butterfly outputs k = j and k + 32
// sit in slot h (h = j >= 16) of lanes 2j mod 32 and 2j + 1 mod 32; the
// lanes of one parity trade in the same shuffle, so 2 shuffles a step
// (each lane sends the slot of its own parity, each receiver swaps by h)
// bring every predecessor over.  The warp decodes row `row`.
__device__ __forceinline__ void strided_warp(
    const float2* __restrict__ pairs, const unsigned char* __restrict__ pinned,
    int row, int T, unsigned long long* __restrict__ dec,
    int* __restrict__ bits) {
  constexpr int L = 32;       // lanes of the row
  constexpr int M = 64 / L;   // states a lane
  const int j = threadIdx.x & 31;
  const float2* p = pairs + (long long)row * T;
  // a word a step; rows 4 ceil(T / 4) words apart, as the in-place path's
  unsigned long long* d = dec + (long long)row * (4 * ((T + 3) / 4));
  int* out = bits + (long long)row * T;
  const bool pin = pinned[row] != 0;

  const bool h = j >= L / 2;
  const int par = j & 1;
  const int src0 = (2 * j) % L, src1 = src0 + 1;
  const int ra = h ? src1 : src0, rb = h ? src0 : src1;
  const bool lane_sign = parity((unsigned)(2 * j) & kSignTaps);
  const bool lane_pair = parity((unsigned)(2 * j) & kPairTaps);

  // metrics of states j + L i, not yet normalised by the step's maximum m
  float nv[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    nv[i] = (pin && (j != 0 || i != 0)) ? -1e30f : 0.0f;
  }
  float m = 0.0f;

  // the LLR pairs L steps at a time, one a lane, the next L prefetched;
  // each step's pair is broadcast one step ahead of its use
  float2 mine = j < T ? p[j] : make_float2(0.0f, 0.0f);
  float2 next = L + j < T ? p[L + j] : make_float2(0.0f, 0.0f);
  float lx = __shfl_sync(kFull, mine.x, 0, L);
  float ly = __shfl_sync(kFull, mine.y, 0, L);
  for (int t0 = 0; t0 < T; t0 += L) {
    const int n = min(L, T - t0);
    for (int k = 0; k < n; ++k) {
      const float h0 = __fmul_rn(0.5f, lx), h1 = __fmul_rn(0.5f, ly);
      {
        const bool in_chunk = k + 1 < L;
        const int src = (k + 1) & (L - 1);
        lx = __shfl_sync(kFull, in_chunk ? mine.x : next.x, src, L);
        ly = __shfl_sync(kFull, in_chunk ? mine.y : next.y, src, L);
      }
      // predecessors: slot 2q + parity from lane ra, the other from rb
      float a[M / 2], b[M / 2];
#pragma unroll
      for (int q = 0; q < M / 2; ++q) {
        a[q] = __shfl_sync(kFull, par ? nv[2 * q + 1] : nv[2 * q], ra, L);
        b[q] = __shfl_sync(kFull, par ? nv[2 * q] : nv[2 * q + 1], rb, L);
      }
      const float A = __fadd_rn(h0, h1), B = __fsub_rn(h0, h1);
      float U = lane_pair ? B : A, V = lane_pair ? A : B;
      if (lane_sign) {
        U = -U;
        V = -V;
      }
      unsigned ballot[M];
      float mx = 0.0f;
#pragma unroll
      for (int q = 0; q < M / 2; ++q) {
        const float P0 = __fsub_rn(h ? b[q] : a[q], m);  // metric of 2k
        const float P1 = __fsub_rn(h ? a[q] : b[q], m);  // metric of 2k + 1
        const unsigned reg = 2u * L * q;  // the slot's bits of 2k
        const float X = parity(reg & kPairTaps) ? V : U;
        // the largest of the butterfly's four candidates
        const float e = __fadd_rn(fmaxf(P0, P1), fabsf(X));
        mx = q == 0 ? e : fmaxf(mx, e);
        // state k: P0 + bm, P1 - bm; state k + 32: P0 - bm, P1 + bm
        float c0k, c1k, c0u, c1u;
        if (parity(reg & kSignTaps)) {  // bm = -X
          c0k = __fsub_rn(P0, X);
          c1k = __fadd_rn(P1, X);
          c0u = __fadd_rn(P0, X);
          c1u = __fsub_rn(P1, X);
        } else {  // bm = X
          c0k = __fadd_rn(P0, X);
          c1k = __fsub_rn(P1, X);
          c0u = __fsub_rn(P0, X);
          c1u = __fadd_rn(P1, X);
        }
        const bool tk = c1k > c0k, tu = c1u > c0u;
        nv[q] = tk ? c1k : c0k;
        nv[q + M / 2] = tu ? c1u : c0u;
        ballot[q] = __ballot_sync(kFull, tk);
        ballot[q + M / 2] = __ballot_sync(kFull, tu);
      }
      m = group_max<L>(mx);
      if (j == k) {
        d[t0 + k] = (unsigned long long)ballot[0] |
                    ((unsigned long long)ballot[1] << 32);
      }
    }
    mine = next;
    if (t0 + 2 * L + j < T) next = p[t0 + 2 * L + j];
  }

  // start: state 0, or the first state whose normalised metric is the
  // maximum 0 (x - max == 0 only where x == max)
  int state = 0;
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    const unsigned field = __ballot_sync(kFull, nv[i] == m);
    if (!pin && field) state = L * i + __ffs(field) - 1;
  }
  __syncwarp();  // the warp's decision stores before its loads
  // the walk back, 32 steps at a time: every lane gathers the chunk's 32
  // words by shuffle first, so each step's dependent work is a select, a
  // shift and a mask
  const int top = ((T - 1) / 32) * 32;
  unsigned long long word = top + j < T ? d[top + j] : 0ull;
  for (int t0 = top; t0 >= 0; t0 -= 32) {
    const unsigned long long ahead = t0 - 32 + j >= 0 ? d[t0 - 32 + j] : 0ull;
    unsigned lo[32], hi[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const unsigned long long w = __shfl_sync(kFull, word, k);
      lo[k] = (unsigned)w;
      hi[k] = (unsigned)(w >> 32);
    }
    const int n = min(32, T - t0);
    int bit = 0;
    if (n == 32) {  // every chunk but the last step's: no branch a step
#pragma unroll
      for (int k = 31; k >= 0; --k) {
        if (j == k) bit = state >> 5;  // the bit it consumed
        state = ((state << 1) & 63) | word_bit(lo[k], hi[k], state);
      }
    } else {
#pragma unroll
      for (int k = 31; k >= 0; --k) {
        if (k < n) {
          if (j == k) bit = state >> 5;
          state = ((state << 1) & 63) | word_bit(lo[k], hi[k], state);
        }
      }
    }
    if (t0 + j < T) out[t0 + j] = bit;
    word = ahead;
  }
}

// ---- groups of 8 lanes, in place: no predecessor crosses lanes for three
// steps in four
//
// A lane holds 8 states in registers r = 0 .. 7, in one of four layouts
// (phase a): the state of lane j, register r is
//   s_a(j, r) = (r mod 2^(3-a)) | j << (3-a) | (r >> (3-a)) << (6-a),
// blocked (s = 8j + r) at a = 0, strided (s = j + 8r) at a = 3.  In phases
// 0, 1 and 2 registers 2q and 2q + 1 hold a butterfly's predecessors 2k and
// 2k + 1, so the lane computes its outputs k and k + 32 into registers q
// and q + 4 by itself, and the layout moves on to phase a + 1.  After every
// third step the group transposes strided to blocked through shared memory
// (8 stores and two 16-byte loads a lane).  A state's new metric is the
// larger candidate and its decision the sign of cand0 - cand1 (negative
// exactly when cand1 > cand0: no metric is ever -0), shifted into a
// per-lane word (bit r of a byte for register r, a byte a step) that the
// lane stores every fourth step: 8 words of 4 steps a row and block.  The
// traceback reassembles a step's word (bit 8j + r for lane j, register r)
// from its block by byte permutes and turns it into a natural word (bit s
// for state s) by the index-bit swaps of s_a.
constexpr int kGroupsIP = 4;     // rows a warp
constexpr int kChunkIP = 24;     // steps an LLR and traceback chunk
constexpr int kBlockIP = 12;     // steps a block of the forward pass
constexpr int kStrideIP = 72;    // floats a group's transpose buffer: the
                                 // stores of one register hit 32 banks

__host__ __device__ constexpr int state_at(int j, int r, int a) {
  return (r & ((1 << (3 - a)) - 1)) | (j << (3 - a)) |
         ((r >> (3 - a)) << (6 - a));
}

// exchange the bits of x at indices p and p + D where p has the bits of
// MASK (Hacker's Delight 7-1): one swap of two index bits
template <int D, unsigned long long MASK>
__device__ __forceinline__ unsigned long long delta_swap(
    unsigned long long x) {
  const unsigned long long t = ((x >> D) ^ x) & MASK;
  return x ^ t ^ (t << D);
}

// a step's word with bit 8j + r for the state of lane j, register r in
// phase A, as a word with bit s for state s (the index-bit swaps of s_a)
template <int A>
__device__ __forceinline__ unsigned long long natural_word(
    unsigned long long x) {
  if constexpr (A == 1) {  // index bits (0 1 2 3 4 5) -> (0 1 5 2 3 4)
    x = delta_swap<4, 0x00f000f000f000f0ull>(x);
    x = delta_swap<8, 0x0000ff000000ff00ull>(x);
    return delta_swap<16, 0x00000000ffff0000ull>(x);
  } else if constexpr (A == 2) {  // (0 1 2 3 4 5) -> (0 4 5 1 2 3)
    x = delta_swap<6, 0x00cc00cc00cc00ccull>(x);
    x = delta_swap<12, 0x0000f0f00000f0f0ull>(x);
    x = delta_swap<24, 0x00000000ff00ff00ull>(x);
    return delta_swap<16, 0x00000000ffff0000ull>(x);
  } else {  // strided: (0 1 2 3 4 5) -> (3 4 5 0 1 2), an 8 x 8 transpose
    x = delta_swap<7, 0x00aa00aa00aa00aaull>(x);
    x = delta_swap<14, 0x0000cccc0000ccccull>(x);
    return delta_swap<28, 0x00000000f0f0f0f0ull>(x);
  }
}

// one step in phase PH: the registers R (un-normalised metrics, m their
// maximum over the row) advance one step on the lane's branch values
// uv = (U, V) of the step (A and B, ordered and signed by the lane's bits
// of the predecessors); the 8 decisions go into acc, a byte
template <int PH>
__device__ __forceinline__ void inplace_step(float (&R)[8], float& m,
                                             float2 uv, unsigned& acc) {
  const float U = uv.x, V = uv.y;
  float N[8], D[8], E[4];  // new metrics; cand0 - cand1; butterfly maxima
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // the register's bits of predecessor 2k
    const unsigned reg = (unsigned)state_at(0, 2 * q, PH);
    const float X = parity(reg & kPairTaps) ? V : U;
    const float P0 = __fsub_rn(R[2 * q], m);      // metric of 2k
    const float P1 = __fsub_rn(R[2 * q + 1], m);  // metric of 2k + 1
    float c0k, c1k, c0u, c1u;
    if (parity(reg & kSignTaps)) {  // bm = -X
      c0k = __fsub_rn(P0, X);
      c1k = __fadd_rn(P1, X);
      c0u = __fadd_rn(P0, X);
      c1u = __fsub_rn(P1, X);
    } else {  // bm = X
      c0k = __fadd_rn(P0, X);
      c1k = __fsub_rn(P1, X);
      c0u = __fsub_rn(P0, X);
      c1u = __fadd_rn(P1, X);
    }
    N[q] = fmaxf(c0k, c1k);
    N[q + 4] = fmaxf(c0u, c1u);
    D[q] = __fsub_rn(c0k, c1k);
    D[q + 4] = __fsub_rn(c0u, c1u);
    // the largest of the four candidates, from the predecessors alone
    E[q] = __fadd_rn(fmaxf(P0, P1), fabsf(X));
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) R[r] = N[r];
  m = group_max<8>(fmaxf(fmaxf(E[0], E[1]), fmaxf(E[2], E[3])));
#pragma unroll
  for (int r = 7; r >= 0; --r) {
    acc = __funnelshift_l(__float_as_uint(D[r]), acc, 1);  // sign bit
  }
}

struct __align__(16) InplaceSmem {
  float xchg[2][kGroupsIP * kStrideIP];  // strided -> blocked transposes
  // the chunk's branch values in four forms, (A, B), (B, A), (-A, -B)
  // and (-B, -A)
  float2 uv[kGroupsIP][4][kChunkIP];
};

// strided -> blocked: store by state, load states 8j .. 8j + 7
__device__ __forceinline__ void transpose(float (&R)[8], float* x, int j) {
#pragma unroll
  for (int r = 0; r < 8; ++r) x[j + 8 * r] = R[r];
  __syncwarp();
  const float4 lo = *reinterpret_cast<const float4*>(x + 8 * j);
  const float4 hi = *reinterpret_cast<const float4*>(x + 8 * j + 4);
  R[0] = lo.x;
  R[1] = lo.y;
  R[2] = lo.z;
  R[3] = lo.w;
  R[4] = hi.x;
  R[5] = hi.y;
  R[6] = hi.z;
  R[7] = hi.w;
}

// step i of a block of the forward pass (the block starts at a multiple of
// 12 steps, so its phase is i mod 3 and its byte of the lane's word i mod
// 4); stores the word after the fourth step of each 4
template <int I>
__device__ __forceinline__ void forward_step(
    float (&R)[8], float& m, float2 uv, unsigned& acc, int& xsel,
    InplaceSmem& sm, int g, int j, unsigned* store) {
  if constexpr (I % 3 == 0) {
    inplace_step<0>(R, m, uv, acc);
  } else if constexpr (I % 3 == 1) {
    inplace_step<1>(R, m, uv, acc);
  } else {
    inplace_step<2>(R, m, uv, acc);
    transpose(R, sm.xchg[xsel] + g * kStrideIP, j);
    xsel ^= 1;
  }
  if constexpr (I % 4 == 3) {
    if (store != nullptr) store[(I / 4) * 8 + j] = acc;
  }
}

template <int... I>
__device__ __forceinline__ void forward_block(
    float (&R)[8], float& m, const float2 (&v)[kBlockIP], unsigned& acc,
    int& xsel, InplaceSmem& sm, int g, int j, unsigned* store, int n,
    std::integer_sequence<int, I...>) {
  if (n >= kBlockIP) {
    (forward_step<I>(R, m, v[I], acc, xsel, sm, g, j, store), ...);
  } else {  // the row's last steps
    ((I < n ? forward_step<I>(R, m, v[I], acc, xsel, sm, g, j, store)
            : void()),
     ...);
  }
}

__device__ __forceinline__ void inplace_warp(
    const float2* __restrict__ pairs, const unsigned char* __restrict__ pinned,
    int row0, int row_end, int T, unsigned long long* __restrict__ dec,
    int* __restrict__ bits, InplaceSmem& sm) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 3, j = lane & 7;
  const bool live = row0 + g < row_end;
  const int row = live ? row0 + g : row_end - 1;
  const float2* p = pairs + (long long)row * T;
  // 8 words of 4 steps a block of the row's decisions
  const int blocks = (T + 3) / 4;
  unsigned* d = reinterpret_cast<unsigned*>(dec) + (long long)row * 8 * blocks;
  int* out = bits + (long long)row * T;
  const bool pin = pinned[row] != 0;
  // the form of (A, B) each phase reads: by the lane's bits of a
  // butterfly's predecessor 2k, B first (pair) and negated (sign)
  const float2* uv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const unsigned lane_bits = (unsigned)state_at(j, 0, a);
    uv[a] = sm.uv[g][(parity(lane_bits & kPairTaps) ? 1 : 0) +
                     (parity(lane_bits & kSignTaps) ? 2 : 0)];
  }

  float R[8];  // blocked: state 8j + r
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    R[r] = (pin && (j != 0 || r != 0)) ? -1e30f : 0.0f;
  }
  float m = 0.0f;
  int xsel = 0;  // the transpose buffer, alternating
  unsigned acc = 0u;

  float2 pre[3];  // the next chunk's pairs, steps t0 + j + 8u
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    pre[u] = j + 8 * u < T ? p[j + 8 * u] : make_float2(0.0f, 0.0f);
  }
  for (int t0 = 0; t0 < T; t0 += kChunkIP) {
    __syncwarp();  // the last chunk's reads before these writes
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const float h0 = __fmul_rn(0.5f, pre[u].x);
      const float h1 = __fmul_rn(0.5f, pre[u].y);
      const float A = __fadd_rn(h0, h1), B = __fsub_rn(h0, h1);
      const int k = j + 8 * u;
      sm.uv[g][0][k] = make_float2(A, B);
      sm.uv[g][1][k] = make_float2(B, A);
      sm.uv[g][2][k] = make_float2(-A, -B);
      sm.uv[g][3][k] = make_float2(-B, -A);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = t0 + kChunkIP + j + 8 * u;
      if (t < T) pre[u] = p[t];
    }
    const int n = min(kChunkIP, T - t0);
    for (int k = 0; k < n; k += kBlockIP) {
      float2 v[kBlockIP];
#pragma unroll
      for (int i = 0; i < kBlockIP; ++i) v[i] = uv[i % 3][k + i];
      forward_block(R, m, v, acc, xsel, sm, g, j,
                    live ? d + ((t0 + k) / 4) * 8 : nullptr, n - k,
                    std::make_integer_sequence<int, kBlockIP>{});
    }
  }
  if (T % 4 != 0 && live) {  // the last block's steps, step c at byte 3 - c
    d[(blocks - 1) * 8 + j] = acc << (8 * (4 - T % 4));
  }

  // start: state 0, or the first state whose normalised metric is the
  // maximum 0, in the layout of the last step (blocked after a transpose)
  const int lay = T % 3;
  int best = 64;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int s = (r & ((1 << (3 - lay)) - 1)) | (j << (3 - lay)) |
                  ((r >> (3 - lay)) << (6 - lay));
    if (R[r] == m) best = min(best, s);
  }
#pragma unroll
  for (int o = 4; o; o >>= 1) {
    best = min(best, __shfl_xor_sync(kFull, best, o, 8));
  }
  int state = (!pin && best < 64) ? best : 0;

  __syncwarp();  // the warp's decision stores before its loads
  // the walk back, a chunk at a time.  Lane j rebuilds the chunk's words
  // of steps j, j + 8 and j + 16, one of each phase: slot v the step k with
  // k mod 3 = v, from the 8 words of its block, as a natural word (bit s
  // for state s); then every lane gathers the chunk's 24 words by
  // shuffle, so each step's dependent work is a select, a shift and a mask
  const int top = ((T - 1) / kChunkIP) * kChunkIP;
  int step_of[3];  // the chunk's step of slot v
  unsigned sel[3];  // byte 3 - (step mod 4) of each of two words
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    step_of[v] = j + 8 * ((2 * (v - j + kChunkIP)) % 3);
    const unsigned c = 3u - (unsigned)(step_of[v] & 3);
    sel[v] = c | ((c + 4u) << 4);
  }
  uint4 ahead[3][2];
  auto load = [&](int t0) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const int t = t0 + step_of[v];
      ahead[v][0] = ahead[v][1] = make_uint4(0u, 0u, 0u, 0u);
      if (live && t >= 0 && t < T) {
        const uint4* b = reinterpret_cast<const uint4*>(d + (t / 4) * 8);
        ahead[v][0] = b[0];
        ahead[v][1] = b[1];
      }
    }
  };
  auto word = [&](int v) {
    const uint4 a = ahead[v][0], b = ahead[v][1];
    const unsigned lo = __byte_perm(__byte_perm(a.x, a.y, sel[v]),
                                    __byte_perm(a.z, a.w, sel[v]), 0x5410);
    const unsigned hi = __byte_perm(__byte_perm(b.x, b.y, sel[v]),
                                    __byte_perm(b.z, b.w, sel[v]), 0x5410);
    return (unsigned long long)lo | ((unsigned long long)hi << 32);
  };
  load(top);
  for (int t0 = top; t0 >= 0; t0 -= kChunkIP) {
    unsigned long long words[3];
    words[0] = natural_word<1>(word(0));
    words[1] = natural_word<2>(word(1));
    words[2] = natural_word<3>(word(2));
    load(t0 - kChunkIP);
    unsigned lo[kChunkIP], hi[kChunkIP];
#pragma unroll
    for (int k = 0; k < kChunkIP; ++k) {
      const unsigned long long w = __shfl_sync(kFull, words[k % 3], k % 8, 8);
      lo[k] = (unsigned)w;
      hi[k] = (unsigned)(w >> 32);
    }
    const int n = min(kChunkIP, T - t0);
    int bit[3];
    if (n == kChunkIP) {  // every chunk but the last step's
#pragma unroll
      for (int k = kChunkIP - 1; k >= 0; --k) {
        if (j == k % 8) bit[k / 8] = state >> 5;  // the bit it consumed
        state = ((state << 1) & 63) | word_bit(lo[k], hi[k], state);
      }
    } else {
#pragma unroll
      for (int k = kChunkIP - 1; k >= 0; --k) {
        if (k < n) {
          if (j == k % 8) bit[k / 8] = state >> 5;
          state = ((state << 1) & 63) | word_bit(lo[k], hi[k], state);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = t0 + j + 8 * u;
      if (live && t < T) out[t] = bit[u];
    }
  }
}

// a block of kWarps in-place warps (rows 16 b ..) and kWarps one-row
// warps (rows R8 + 4 b ..), so that the rows past 16 an SM land one a
// partition beside the in-place warps instead of doubling one
__global__ void __launch_bounds__(64 * kWarps)
viterbi_kernel(const float2* __restrict__ pairs,
               const unsigned char* __restrict__ pinned, int rows, int rows8,
               int T, unsigned long long* __restrict__ dec,
               int* __restrict__ bits) {
  __shared__ InplaceSmem sm[kWarps];
  const int warp = threadIdx.x >> 5;
  if (warp < kWarps) {
    const int row0 = (blockIdx.x * kWarps + warp) * kGroupsIP;
    if (row0 >= rows8) return;  // the whole warp leaves together
    inplace_warp(pairs, pinned, row0, rows8, T, dec, bits, sm[warp]);
  } else {
    const int row = rows8 + blockIdx.x * kWarps + warp - kWarps;
    if (row >= rows) return;
    strided_warp(pairs, pinned, row, T, dec, bits);
  }
}

}  // namespace

// pairs: [rows, T] float2 (l0, l1); pinned: [rows] bytes, nonzero for a
// pinned row; dec: [rows, 4 ceil(T / 4)] 64-bit scratch; bits: [rows, T]
// int32 out.  Requires rows >= 1, T >= 1 and 8-byte aligned pairs.
// Returns a cudaError_t.
extern "C" int viterbi(const float* pairs, const unsigned char* pinned,
                       int rows, int T, unsigned long long* dec, int* bits,
                       void* stream) {
  if (rows < 1 || T < 1 || (reinterpret_cast<uintptr_t>(pairs) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // one block an SM while it holds every row: 16 in place and 4 in one-row
  // warps; beyond that, blocks of 20 rows
  const int per_block = (kGroupsIP + 1) * kWarps;
  const int blocks =
      std::max(std::max(sms, 1), (rows + per_block - 1) / per_block);
  const int rows8 = std::min(rows, kGroupsIP * kWarps * blocks);
  viterbi_kernel<<<blocks, 64 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(pairs), pinned, rows, rows8, T, dec,
      bits);
  return (int)cudaGetLastError();
}
