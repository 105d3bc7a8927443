// The frame block of the fused payload tails K1 (payload_fused_strip.cu)
// and K2 (payload_fused.cu) for Hopper (sm_90a): a persistent block that
// walks over frames, copies each frame in with cp.async while the one
// before it transforms, runs a self-sorting (Stockham) FFT with radix-16
// passes in registers, then equalizes, demaps and stores each subcarrier.
//
// Layout of one block (S streams, M subcarriers, T = M / 16):
//   - S * T threads (rounded up to whole warps) own one FFT row slice
//     each (row s, index t < T) and hold 16 complex points in registers
//     in every pass.  A radix-R pass (R in {2, 4, 8, 16}) does 16 / R
//     butterflies on the adjacent indices j = (16 / R) t + b.  The plan
//     is the wrapper's (payload_fused.fft_plan(M)): radix 16 first, then
//     16s, then what is left, e.g. 2048 = 16 * 16 * 8, so log2(M) radix-2
//     stages take ceil(log2(M) / 4) passes.
//   - Pass of radix R after the radices whose product is Ns:
//       v[r] = x[j + r M / R] * tw_p[r Ns + j mod Ns],  r < R
//       y    = DFT_R(v)
//       x[(j - j mod Ns) R + j mod Ns + q Ns] = y[q],   q < R
//     in place in `work` (all reads, a barrier, all writes, a barrier).
//     The last pass leaves X in natural order.  tw_p[r Ns + k] =
//     exp(-2 pi i r k / (Ns R)) is the wrapper's float64-built table
//     exp(-2 pi i m / M), rounded to float32, gathered per pass
//     (payload_fused.pass_twiddles) so that a warp's lanes read adjacent
//     entries; each block copies it into shared memory once.  The DFT_R
//     constants are float32 literals of the same values.
//   - `work` is [S][M + M/16] float2: one float2 of padding after every
//     16, so the first pass's stride-16 writes and the stride-1, -2 and
//     -4 reads are free of bank conflicts.
//   - Two-stage (S * M <= 4096; 85 KB at M = 2048, S = 2, two blocks per
//     SM): a natural-order `stage` buffer [S][M] (plus the input side's
//     slack) beside `work`.  Frame
//     k + grid is copied into it (16-byte cp.async where the source rows
//     are 16-byte aligned, else 4- or 8-byte) as soon as the first pass
//     has read frame k out of it, so the copy overlaps the rest of frame
//     k.  One-stage (larger S * M): the copy goes straight into `work`,
//     and the other blocks on the SM hide it.
//   - The equalize and demap: see equalize_demap_store.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "payload_common.cuh"

namespace pfft {

constexpr int kP = 16;          // points per thread and row in each pass
constexpr int kMaxPoints = 64;  // demap points in the parameter struct
constexpr int kMaxPasses = 4;
constexpr int kTwoStageMax = 4096;  // S * M up to which two stages are used

// The demap constants, [3][64] (Re c, Im c, |c|^2 / 2), by value.
struct Points {
  float cr[kMaxPoints];
  float ci[kMaxPoints];
  float cb[kMaxPoints];
};

struct Plan {
  int n_pass;
  int radix[kMaxPasses];
};

// Everything but the input: by value in the kernel's parameter struct.
struct Tail {
  const float2* __restrict__ W;      // [M][S][S]
  const float* __restrict__ gain;    // [M]
  const float2* __restrict__ tw;     // the passes' twiddles, pass 2 on,
                                     // n_tw of them
  int* __restrict__ rx_data;         // [S][n_sym][M]
  float2* __restrict__ rx_sig;       // [S][n_sym][M] or null
  float dft_norm;
  int M, log2M, n_sym, n_points, n_tw;
  Plan plan;
  Points pts;
};

__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
__host__ __device__ __forceinline__ int row_stride(int M) {
  return M + (M >> 4);
}

// ---- launch geometry (host) ----

struct Geometry {
  int threads, smem, two_stage;
};

// Twiddles of a plan's passes after the first: sum of R * Ns.
inline int plan_twiddles(const Plan& plan) {
  int n = 0, Ns = plan.radix[0];
  for (int p = 1; p < plan.n_pass; ++p) {
    n += plan.radix[p] * Ns;
    Ns *= plan.radix[p];
  }
  return n;
}

// Shared memory: work [S][RS], the twiddles (rounded up to an even
// count, 16-byte aligned), then the stage [S][M] when two-stage.
__host__ __device__ __forceinline__ int twiddle_slots(int n_tw) {
  return (n_tw + 1) & ~1;
}

// S * M / 16 threads (one FFT slice each) rounded up to whole warps;
// shared memory for work, the twiddles and, two-stage, the stage with
// `slack` float2 beyond its S * M (the input side's own margin).
inline Geometry geometry(int S, int M, int n_tw, int slack = 0) {
  Geometry g;
  g.two_stage = S * M <= kTwoStageMax;
  g.threads = (S * M / kP + 31) & ~31;
  g.smem = (int)sizeof(float2) * (S * row_stride(M) + twiddle_slots(n_tw) +
                                  (g.two_stage ? S * M + slack : 0));
  return g;
}

// Blocks of `kernel` per SM at `g` and the SM count of the current
// device.  The dynamic shared-memory limit, an attribute of each
// device's context, is raised once per kernel instance and device; the
// occupancy is cached per instance, device and log2(M).
template <auto Kernel>
cudaError_t occupancy(int log2M, const Geometry& g, int* blocks_per_sm,
                      int* n_sm) {
  constexpr int kDevs = 16;
  static bool attr_set[kDevs];
  static int cache[kDevs][13];
  static int sms[kDevs];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevs) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    attr_set[dev] = true;
  }
  if (sms[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms[dev] = n;
  }
  if (cache[dev][log2M] == 0) {
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, Kernel, g.threads,
                                                      g.smem);
    if (e != cudaSuccess) return e;
    if (b < 1) return cudaErrorInvalidConfiguration;
    cache[dev][log2M] = b;
  }
  *blocks_per_sm = cache[dev][log2M];
  *n_sm = sms[dev];
  return cudaSuccess;
}

// Checks the plan (radix 16 first, each radix 2/4/8/16, product M) and
// fills the Tail's plan and points from host arrays.
inline bool fill_tail(Tail& a, const float* points, int n_points,
                      const int* plan, int n_pass, int M) {
  if (n_points < 1 || n_points > kMaxPoints || n_pass < 1 ||
      n_pass > kMaxPasses || plan[0] != kP)
    return false;
  long long prod = 1;
  a.plan.n_pass = n_pass;
  for (int p = 0; p < kMaxPasses; ++p) {
    const int r = p < n_pass ? plan[p] : 1;
    if (p < n_pass && r != 2 && r != 4 && r != 8 && r != 16) return false;
    a.plan.radix[p] = r;
    prod *= r;
  }
  if (prod != M) return false;
  a.n_tw = plan_twiddles(a.plan);
  for (int q = 0; q < kMaxPoints; ++q) {
    const bool in = q < n_points;
    a.pts.cr[q] = in ? points[q] : 0.f;
    a.pts.ci[q] = in ? points[kMaxPoints + q] : 0.f;
    a.pts.cb[q] = in ? points[2 * kMaxPoints + q] : 0.f;
  }
  a.n_points = n_points;
  return true;
}

// ---- async copies ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- complex arithmetic and the in-register DFTs ----

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(w.x * a.x - w.y * a.y, w.x * a.y + w.y * a.x);
}
__device__ __forceinline__ float2 mul_mi(float2 a) {  // a * (-i)
  return make_float2(a.y, -a.x);
}

// a * exp(-2 pi i e / 16), e a compile-time constant after unrolling
__device__ __forceinline__ float2 w16(float2 a, int e) {
  switch (e & 15) {
    case 0: return a;
    case 1: return cmul(a, make_float2(0.923879532511286756f,
                                       -0.382683432365089772f));
    case 2: return cmul(a, make_float2(0.707106781186547524f,
                                       -0.707106781186547524f));
    case 3: return cmul(a, make_float2(0.382683432365089772f,
                                       -0.923879532511286756f));
    case 4: return mul_mi(a);
    case 6: return cmul(a, make_float2(-0.707106781186547524f,
                                       -0.707106781186547524f));
    case 9: return cmul(a, make_float2(-0.923879532511286756f,
                                       0.382683432365089772f));
    default:  // the DFTs below use no other exponent
      __builtin_unreachable();
  }
}

// In-place DFT_4 of x[0], x[ST], x[2 ST], x[3 ST], natural order out.
template <int ST>
__device__ __forceinline__ void dft4(float2* x) {
  const float2 t0 = cadd(x[0], x[2 * ST]);
  const float2 t1 = csub(x[0], x[2 * ST]);
  const float2 t2 = cadd(x[ST], x[3 * ST]);
  const float2 t3 = mul_mi(csub(x[ST], x[3 * ST]));
  x[0] = cadd(t0, t2);
  x[2 * ST] = csub(t0, t2);
  x[ST] = cadd(t1, t3);
  x[3 * ST] = csub(t1, t3);
}

template <int R>
__device__ __forceinline__ void dft(float2* x);

template <>
__device__ __forceinline__ void dft<2>(float2* x) {
  const float2 a = x[0];
  x[0] = cadd(a, x[1]);
  x[1] = csub(a, x[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2* x) {
  dft4<1>(x);
}

template <>
__device__ __forceinline__ void dft<8>(float2* x) {
  dft4<2>(x);      // even inputs: E[q] at x[2q]
  dft4<2>(x + 1);  // odd inputs:  O[q] at x[2q + 1]
  float2 y[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 o = w16(x[2 * q + 1], 2 * q);
    y[q] = cadd(x[2 * q], o);
    y[q + 4] = csub(x[2 * q], o);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) x[q] = y[q];
}

template <>
__device__ __forceinline__ void dft<16>(float2* x) {
  // x[4 r1 + r2]: DFT_4 over r1, twiddle w16^(r2 q1), DFT_4 over r2;
  // y[q1 + 4 q2] ends in x[4 q1 + q2]
#pragma unroll
  for (int r2 = 0; r2 < 4; ++r2) dft4<4>(x + r2);
#pragma unroll
  for (int q1 = 1; q1 < 4; ++q1)
#pragma unroll
    for (int r2 = 1; r2 < 4; ++r2)
      x[4 * q1 + r2] = w16(x[4 * q1 + r2], r2 * q1);
#pragma unroll
  for (int q1 = 0; q1 < 4; ++q1) dft4<1>(x + 4 * q1);
  float2 y[16];
#pragma unroll
  for (int q1 = 0; q1 < 4; ++q1)
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) y[q1 + 4 * q2] = x[4 * q1 + q2];
#pragma unroll
  for (int q = 0; q < 16; ++q) x[q] = y[q];
}

// ---- one Stockham pass ----

// A row read from `work` (padded).
struct PaddedRow {
  const float2* p;
  __device__ __forceinline__ float2 operator()(int i) const {
    return p[pad(i)];
  }
};

// Load, twiddle and transform the 16 / R butterflies of slice t.  tw is
// the pass's [R][Ns] block in shared memory; butterfly b of slice t has
// k = k0 + b, so its B twiddles of one r are adjacent (read as float4).
template <int R, class Row>
__device__ __forceinline__ void pass_load(const Row& row, float2 (&v)[kP],
                                          const float2* tw, int M, int Ns,
                                          int t) {
  constexpr int B = kP / R;
  const int step = M / R;
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = row(B * t + b + r * step);
  if (Ns > 1) {
    const int k0 = (B * t) & (Ns - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2* w = tw + r * Ns + k0;
      if constexpr (B == 1) {
        v[r] = cmul(v[r], *w);
      } else {
#pragma unroll
        for (int b = 0; b < B; b += 2) {
          const float4 w2 = *reinterpret_cast<const float4*>(w + b);
          v[b * R + r] = cmul(v[b * R + r], make_float2(w2.x, w2.y));
          v[(b + 1) * R + r] =
              cmul(v[(b + 1) * R + r], make_float2(w2.z, w2.w));
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) dft<R>(v + b * R);
}

template <int R>
__device__ __forceinline__ void pass_store(float2* row, const float2 (&v)[kP],
                                           int Ns, int t) {
  constexpr int B = kP / R;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = B * t + b;
    const int k = j & (Ns - 1);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) row[pad(base + q * Ns)] = v[b * R + q];
  }
}

// Passes 2.. of the plan, in place in this slice's row of `work`.
__device__ __forceinline__ void later_passes(float2* row, float2 (&v)[kP],
                                             const float2* tw, const Tail& a,
                                             bool active, int t) {
  int Ns = kP;  // tw: this pass's [R][Ns] twiddles
  for (int p = 1; p < a.plan.n_pass; ++p) {
    const int R = a.plan.radix[p];
    if (active) {
      const PaddedRow src{row};
      switch (R) {
        case 2: pass_load<2>(src, v, tw, a.M, Ns, t); break;
        case 4: pass_load<4>(src, v, tw, a.M, Ns, t); break;
        case 8: pass_load<8>(src, v, tw, a.M, Ns, t); break;
        default: pass_load<16>(src, v, tw, a.M, Ns, t); break;
      }
    }
    __syncthreads();
    if (active) {
      switch (R) {
        case 2: pass_store<2>(row, v, Ns, t); break;
        case 4: pass_store<4>(row, v, Ns, t); break;
        case 8: pass_store<8>(row, v, Ns, t); break;
        default: pass_store<16>(row, v, Ns, t); break;
      }
    }
    __syncthreads();
    tw += R * Ns;
    Ns *= R;
  }
}

// The V subcarriers a chunk of thread i of nt takes: sc0 + v * nt.
template <int S>
constexpr int kChunk = S <= 2 ? 4 : 2;

// ---- the equalize of one subcarrier ----
//
// eq[o] = (sum_j W[sc][o][j] X[j]) * (gain[sc] * dft_norm), X[j] read from
// work, is payload_common.cuh's payload::equalize (j in order, the gain
// last).  Threads take subcarriers a thread count apart, so a warp's
// lanes read adjacent W rows (W is [M][S][S]).
template <int S>
__device__ __forceinline__ void equalize_at(const float2* work,
                                            const Tail& a, int sc,
                                            float (&er)[S], float (&ei)[S]) {
  const int RS = row_stride(a.M);
  float2 w[S * S];  // W[sc], through the read-only cache
  if constexpr (S % 2 == 0) {
    const float4* wp =
        reinterpret_cast<const float4*>(a.W + (long long)sc * S * S);
#pragma unroll
    for (int q = 0; q < S * S / 2; ++q) {
      const float4 f = __ldg(wp + q);
      w[2 * q] = make_float2(f.x, f.y);
      w[2 * q + 1] = make_float2(f.z, f.w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < S * S; ++q)
      w[q] = __ldg(a.W + (long long)sc * S * S + q);
  }
  float2 X[S];
#pragma unroll
  for (int j = 0; j < S; ++j) X[j] = work[j * RS + pad(sc)];
  payload::equalize<S>(X, w, 0, __ldg(a.gain + sc) * a.dft_norm, er, ei);
}

// ---- equalize + demap + store of frame k from `work` (natural X) ----
//
// Each thread takes V subcarriers a thread count apart per chunk,
// equalizes them (equalize_at) and demaps the chunk's V * S symbols with
// payload_common.cuh's demap_step (two FMAs a score, strict '>', first
// maximum wins, the rule of K3 and K4), the points read from the kernel's
// parameter struct (constant bank) in
// a loop unrolled to 64 with a q < n exit, each point's constants shared
// by the chunk's V * S symbols.  Decisions differ from the plain version
// only at near-ties of two scores.  Stores are per element, evict-first,
// and coalesced: a warp writes 128 / 256 contiguous bytes per
// instruction.  (Adjacent subcarriers per lane would allow int4 / float4
// stores, but spread each lane's W load over its own cache line, 32 per
// warp instruction; the demap's compares, not the stores, bound this
// phase.)
template <int S>
__device__ __forceinline__ void equalize_demap_store(const float2* work,
                                                     const Tail& a, int k,
                                                     int i, int nt) {
  constexpr int V = kChunk<S>;
  constexpr int E = V * S;  // symbols per chunk, [v * S + o]
  const int M = a.M;
  for (int sc0 = i; sc0 < M; sc0 += V * nt) {
    float er[E], ei[E];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int sc = sc0 + v * nt < M ? sc0 + v * nt : sc0;
      float yr[S], yi[S];
      equalize_at<S>(work, a, sc, yr, yi);
#pragma unroll
      for (int o = 0; o < S; ++o) {
        er[v * S + o] = yr[o];
        ei[v * S + o] = yi[o];
      }
    }
    float best[E];
    int idx[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      best[e] = -CUDART_INF_F;
      idx[e] = 0;
    }
#pragma unroll
    for (int q = 0; q < kMaxPoints; ++q) {
      if (q >= a.n_points) break;
      const float cr = a.pts.cr[q];
      const float ci = a.pts.ci[q];
      const float cb = a.pts.cb[q];
#pragma unroll
      for (int e = 0; e < E; ++e)
        payload::demap_step(er[e], ei[e], cr, ci, cb, q, best[e], idx[e]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int sc = sc0 + v * nt;
      if (sc >= M) break;
#pragma unroll
      for (int o = 0; o < S; ++o) {
        const long long off = ((long long)o * a.n_sym + k) * M + sc;
        __stcs(a.rx_data + off, idx[v * S + o]);
        if (a.rx_sig != nullptr)
          __stcs(a.rx_sig + off, make_float2(er[v * S + o], ei[v * S + o]));
      }
    }
  }
}

// ---- the persistent frame loop ----
//
// In supplies the input side:
//   void issue(int k, float2* dst, bool two, int S, int M, int RS, int i,
//              int nt)
//     thread i of nt starts its part of frame k's copy (into the stage
//     when two, else into work, padded)
//   float2 read(const float2* stage, int s, int n)
//     frame sample (s, n) from the stage
//
// Two-stage: frame k + grid is copied into the stage once the first pass
// has read frame k out of it, so the copy overlaps the rest of frame k.
// One-stage: frame k is copied into work when the last frame is stored.
// Per frame: 1 + 2 * passes barriers (7 at M = 2048).
template <int S, bool TWO, class In>
__device__ __forceinline__ void frames(const In& in, const Tail& a) {
  extern __shared__ __align__(16) float2 smem[];
  const int M = a.M;
  const int RS = row_stride(M);
  float2* work = smem;
  float2* tw = smem + S * RS;
  float2* stage = tw + twiddle_slots(a.n_tw);
  const int log2T = a.log2M - 4;
  const int T = 1 << log2T;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool active = tid < S * T;
  const int s_u = active ? tid >> log2T : 0;
  const int t = tid & (T - 1);
  float2* row = work + s_u * RS;
  struct StageRow {
    const In& in;
    const float2* stage;
    int s;
    __device__ __forceinline__ float2 operator()(int n) const {
      return in.read(stage, s, n);
    }
  } staged{in, stage, s_u};

  for (int i = tid; i < a.n_tw; i += nt) tw[i] = a.tw[i];
  if (TWO && (int)blockIdx.x < a.n_sym) {
    in.issue(blockIdx.x, stage, true, S, M, RS, tid, nt);
    cp_async_commit();
  }
  float2 v[kP];
  for (int k = blockIdx.x; k < a.n_sym; k += gridDim.x) {
    if (!TWO) {
      __syncthreads();  // the last frame's demap has read work
      in.issue(k, work, false, S, M, RS, tid, nt);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    // pass 1 (radix 16, no twiddles) out of the copy
    if (active) {
      if (TWO)
        pass_load<kP>(staged, v, tw, M, 1, t);
      else
        pass_load<kP>(PaddedRow{row}, v, tw, M, 1, t);
    }
    __syncthreads();  // the copy is read out: start the next one
    if (TWO && k + (int)gridDim.x < a.n_sym) {
      in.issue(k + gridDim.x, stage, true, S, M, RS, tid, nt);
      cp_async_commit();
    }
    if (active) pass_store<kP>(row, v, 1, t);
    __syncthreads();
    later_passes(row, v, tw, a, active, t);
    equalize_demap_store<S>(work, a, k, tid, nt);
  }
}

}  // namespace pfft
