// The whole Schmidl&Cox sync stage for Hopper (sm_90a): metric, plateau
// runs, the first sample where every stream fires, and the correlation
// there (the CFO observable).
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/sc_sync.py::sc_sync_fused
// which walked the capture in grid order and carried the last
// below-threshold index and the fired flag in SMEM from one step to the
// next.  Thread blocks on the H100 run in no order, and here no block
// ever waits on another.  The stage is two launches on the caller's
// stream, after a memset of three counters (ticket, bound, chunks
// scanned):
//
//   1. sc_sync_scan, persistent (blocks per SM x SMs, from the occupancy
//      calculator: one 512-thread block per SM).  A ticket counter
//      (atomicAdd) hands out chunks of C = 8192 - M output positions in
//      capture order, all S streams of a chunk to one block.  Per stream
//      (a "job") the block forms the chunk's metric from chunk-local
//      prefix sums over the chunk and its M-sample left halo (the
//      arithmetic of sc_common.cuh's note and sc_metric.cu), writes
//      one bit per sample, above[s][t] = metric > threshold (a warp
//      ballot per 32 samples; NaN is not above, as in C), and the
//      chunk's first and last below-threshold index.  Then it
//      finds the chunk's first fire in its body (below) and lowers a
//      global bound to it.  The next job's samples are copied with
//      cp.async while the current one computes; the halo was loaded
//      moments earlier by the previous ticket, so it comes mostly from L2.
//   2. sc_sync_resolve, one block.  Settles the chunks' heads with the
//      carry, then writes t*, the run starts and corr at t*.
//
// The head rule.  A stream's run start at t is (last index <= t whose
// metric is not above) + 1, and t fires when on every stream the metric
// at t is above and t - run_start > cp.  So stream s passes at t iff no
// sample of [t - cp - 1, t] is below, counting indices before 0 as below.
// For t >= c0 + cp + 1 that window lies inside the chunk [c0, c0 + C), so
// the chunk's body fires are exact from its own bits, whatever the
// earlier chunks hold.  Only the head [c0, c0 + cp] depends on the carry
// (the last below index before c0, -1 if none).  There stream s passes at
// t iff t lies before its first below in the chunk and t >= carry + cp +
// 2, so the head's first fire is
//     h = max(c0, max_s carry_s + cp + 2)
// if h <= c0 + cp, h < T and h < min_s first_below_s, and none otherwise.
// Launch 2 takes each chunk's carries as the exclusive prefix max of the
// chunks' last below (a block scan) and evaluates h for every chunk.
//
// The early exit.  Each job compares its chunk's start with the bound (a
// load that lands while the job's prefix sums run) and the block stops
// if the start lies past it.  Tickets go out in capture order and the
// bound only falls, so every chunk that starts at or before the final
// bound was scanned, and
//     t* = min(bound, the first head fire of those chunks)
// is exact: a fire before the bound lies in such a chunk, in its head,
// since a body fire would have lowered the bound.  After the fire each
// resident block reads about one more chunk, and drops it after one job.
//
// The threshold test is K6's metric (sc_metric.cu): n / d > thr with n =
// |corr|^2 and d = energy^2, and its zero-count rule (a window with no
// nonzero sample is 0/0, NaN, and not above).
//
// The run starts at t* come from the carry of t*'s chunk and its bits up
// to t*; corr[t*] = -sum of the M/2 lag products that end at t*, summed
// directly.  When nothing fires, t* = 0 (the full scan's argmax of
// nothing), with the run starts and corr at 0.  So this replicates the
// plain version (the full metric, the cummax plateau scan with the
// all-streams rule, corr at t*) except for the rounding of the metric's
// prefix sums, which are chunk-local like the plain moving sums: a metric
// within ~1 ulp of the threshold could decide a run differently.
//
// What bounds it: memory.  The stage must read the samples up to t*,
// S (t* + 1) 8 bytes, when it fires, and the whole capture, S T 8 bytes,
// when it does not; the bits and the chunks' marks it writes are 1/64
// of that and less.  Launch 1 loads each chunk's halo again (from L2
// when the previous ticket's block is still near), and launch 2 reads
// 8 bytes per stream and chunk and M samples per stream.  Nothing is
// read back to the host.
//
// Plain C interface for ctypes; the launcher returns a cudaError_t.

#include "sc_common.cuh"

namespace {

constexpr int kNone = 0x7fffffff;  // no index: a first below, a fire
// Launch 1's block: 512 threads of 16 samples, L = 8192 local samples and
// chunks of C = L - M outputs (6,144 at M = 2048: each sample is read
// 1.33 times with the halos).  One such block fits an SM (202 KB of shared
// memory).  256-thread blocks, two per SM, read each sample twice: on an
// H100 80GB at 700 W they scanned a [2, 2,297,248] capture with no fire
// in 39.7 us against 33.5 (scripts/time_k5.py).
constexpr int kThreads = 512;
constexpr int kL = kThreads * sc::kItems;
constexpr int kResolveThreads = 512;
constexpr int kDevs = 16;

// The counters the launcher zeroes before launch 1, each on a 128-byte
// line of its own.  The bound is kept as ~t, so 0 is "no fire yet" and
// atomicMax keeps the earliest fire.
enum { kTicket = 0, kBound = 32, kScanned = 64, kStateWords = 65 };

__device__ __forceinline__ int bound_of(unsigned enc) {
  return enc ? (int)~enc : kNone;
}

// The bound as it stands (a relaxed load at device scope).
__device__ __forceinline__ unsigned load_bound(const unsigned* state) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(state + kBound)
               : "memory");
  return v;
}

// The bits of the word of samples [t, t + 32) that lie before T.
__device__ __forceinline__ unsigned valid_bits(int t, int T) {
  const int n = T - t;
  return n >= 32 ? sc::kFull : n <= 0 ? 0u : (1u << n) - 1u;
}

// Last index of a zero bit in word w (bit i is sample 32 w + i), or -1.
__device__ __forceinline__ int last_zero(unsigned word, int w) {
  const unsigned inv = ~word;
  return inv ? w * 32 + 31 - __clz(inv) : -1;
}

// Shared-memory layouts, with pad so that a thread's 16 consecutive
// entries (threads 16 entries apart) and 32 consecutive entries both fall
// on distinct banks:
//   pad16:      the copied samples and the prefix sums P, one float2 of
//               pad per 16;
//   sc::padded: E and C, one entry of pad per 32.
__host__ __device__ constexpr int pad16(int j) { return j + (j >> 4); }

// Launch 1's dynamic shared memory for L local samples: the copy of the
// next job, then the current job's P (float2), E (float) and C (int).
struct Layout {
  size_t P, E, C, bytes;
  __host__ __device__ constexpr explicit Layout(int L)
      : P(sizeof(float2) * pad16(L)),
        E(P + sizeof(float2) * pad16(L)),
        C(E + sizeof(float) * sc::padded(L)),
        bytes(C + sizeof(int) * sc::padded(L)) {}
};

// Starts the copy of samples x[base + j], j < L, of stream row xs into
// raw (zeros before 0 and at or past T), 8 bytes a copy, as one cp.async
// group.
__device__ __forceinline__ void load_job(float2* raw, const float2* xs,
                                         int T, int base) {
#pragma unroll 4
  for (int j = threadIdx.x; j < kL; j += kThreads) {
    const int k = base + j;
    const bool in = k >= 0 && k < T;
    const unsigned d = (unsigned)__cvta_generic_to_shared(raw + pad16(j));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(in ? xs + k : xs), "r"(in ? 8 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// metric(j) > thr from the prefix sums at j (p1, e1) and at j - M/2
// (p0) and j - M (e0), as sc_metric.cu forms the metric (the
// zero-count rule is the caller's).
__device__ __forceinline__ bool above_of(float2 p1, float2 p0, float e1,
                                         float e0, float thr) {
  const float cr = -(p1.x - p0.x);
  const float ci = -(p1.y - p0.y);
  const float en = 0.5f * (e1 - e0);
  return (cr * cr + ci * ci) / (en * en) > thr;
}

__global__ void __launch_bounds__(kThreads, 1)
sc_sync_scan(const float2* __restrict__ x, int S, int T, int M, int cp,
             float thr, int n_chunks, int n_words,
             unsigned* __restrict__ above, int* __restrict__ first_below,
             int* __restrict__ last_below, unsigned* __restrict__ state) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kMaxWords = kThreads / 2;  // C <= L - 32: C / 32 words
  constexpr Layout lay(kL);
  extern __shared__ __align__(16) unsigned char smem[];
  float2* raw = reinterpret_cast<float2*>(smem);
  float2* P = reinterpret_cast<float2*>(smem + lay.P);
  float* E = reinterpret_cast<float*>(smem + lay.E);
  int* Cn = reinterpret_cast<int*>(smem + lay.C);
  __shared__ unsigned words[sc::kMaxStreams][kMaxWords];
  __shared__ float warp_tot[3][kWarps];
  __shared__ int warp_cnt[kWarps];
  __shared__ int red[33];
  __shared__ int s_first[sc::kMaxStreams], s_last[sc::kMaxStreams];
  __shared__ int s_any[sc::kMaxStreams];
  __shared__ int s_next, s_fire, s_go;
  const int C = kL - M;
  const int n_w = C >> 5;
  const int M2 = M >> 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = tid * sc::kItems;
  unsigned done = 0u;  // chunks this block scanned (thread 0)

  if (tid == 0) {
    const int k0 = (int)atomicAdd(state + kTicket, 1u);
    s_next = k0 < n_chunks ? k0 : -1;
  }
  __syncthreads();
  int k = s_next;
  if (k < 0) return;
  load_job(raw, x, T, k * C - M);

  for (;;) {
    const int c0 = k * C;
    if (tid < S) {
      s_first[tid] = kNone;
      s_last[tid] = -1;
      s_any[tid] = 0;
    }
    if (tid == 0) s_fire = kNone;
    for (int s = 0; s < S; ++s) {
      copy_wait();
      __syncthreads();  // raw holds job (k, s); every thread has read k
      // thread 0 reads the bound and, on the chunk's last stream, takes
      // the next chunk's ticket; both land while the prefix runs
      unsigned enc = 0u;
      int nk = -1;
      if (tid == 0) {
        enc = load_bound(state);
        if (s == S - 1) nk = (int)atomicAdd(state + kTicket, 1u);
      }

      // the prefix sums of sc_metric.cu, operation for
      // operation: per thread 16 consecutive samples in registers, then
      // warp shuffles, then the warps' totals in order
      // (j0 and M/2 are multiples of 16: a thread's items share one pad
      // group, and all or none of them have a lag product)
      float pr[sc::kItems], pi[sc::kItems], en[sc::kItems];
      unsigned nzm = 0u;  // bit u: item u is nonzero
      const float2* rb = raw + pad16(j0);
      const float2* ra = rb - pad16(M2);
      const bool lag = j0 >= M2;
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
      float oR = __shfl_up_sync(sc::kFull, sr, 1);
      float oI = __shfl_up_sync(sc::kFull, si, 1);
      float oE = __shfl_up_sync(sc::kFull, se, 1);
      if (lane == 0) {
        oR = 0.f;
        oI = 0.f;
        oE = 0.f;
      }
      if (tid == 0) {
        // a chunk that starts past the earliest fire so far is not needed
        s_go = (long long)c0 <= bound_of(enc) ? 1 : 0;
        if (s == S - 1) s_next = nk < n_chunks ? nk : -1;
      }
      // raw is read; the warps' totals, s_go and s_next are in
      const bool zeros = __syncthreads_or(nzm != 0xffffu);
      if (!s_go) {  // no copy is in flight
        if (tid == 0 && done) atomicAdd(state + kScanned, done);
        return;
      }

      // the next job's copy overlaps the rest of this one
      if (s + 1 < S) {
        load_job(raw, x + (long long)(s + 1) * T, T, c0 - M);
      } else if (s_next >= 0) {
        load_job(raw, x, T, s_next * C - M);
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
        // the exact nonzero counts, only for a tile with a zero sample:
        // the items' prefix from the mask, the threads' by a warp scan
        // and the warps' totals in order
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
      __syncthreads();

      // the test at i = tid + r kThreads, j = i + M, into bit r of ups
      // (r < 16: C < L), with no branch so that the iterations' loads
      // overlap; kThreads is a multiple of 32, so each pointer steps by a
      // constant.  Then i runs over whole warps (C % 32 == 0): each warp
      // ballots 32 consecutive samples into one word.
      constexpr int kStepP = kThreads + kThreads / 16;
      constexpr int kStepE = kThreads + kThreads / 32;
      const float2* p1 = P + pad16(M + tid);
      const float2* p0 = P + pad16(M2 + tid);
      const float* e1 = E + sc::padded(M + tid);
      const float* e0 = E + sc::padded(tid);
      const int* n1 = Cn + sc::padded(M + tid);
      const int* n0 = Cn + sc::padded(tid);
      unsigned ups = 0u;
#pragma unroll 4
      for (int r = 0; tid + r * kThreads < C; ++r) {
        bool up = above_of(p1[r * kStepP], p0[r * kStepP], e1[r * kStepE],
                           e0[r * kStepE], thr);
        // without a zero sample in the tile no window's nonzero count can
        // be 0 and C is not read; with one, an equal count is 0/0
        if (zeros) up = up & (n1[r * kStepE] != n0[r * kStepE]);
        ups |= (unsigned)(up & (c0 + tid + r * kThreads < T)) << r;
      }
      for (int r = 0; tid + r * kThreads < C; ++r) {
        const unsigned word = __ballot_sync(sc::kFull, (ups >> r) & 1u);
        if (lane == 0) words[s][warp + r * kWarps] = word;
      }
    }
    __syncthreads();  // every stream's words are in

    // Per (stream, word), one a thread: the bits to device memory, the
    // chunk's first and last below index (reduced over the lanes of one
    // stream, then one shared atomic per stream and warp) and whether the
    // stream has an above bit.
    for (int q = tid; q < S * n_w; q += kThreads) {
      const int s = q / n_w;
      const int w = q - s * n_w;
      const unsigned word = words[s][w];
      const int t = c0 + 32 * w;
      if ((t >> 5) < n_words) above[(long long)s * n_words + (t >> 5)] = word;
      const unsigned below = ~word & valid_bits(t, T);
      const int first = below ? t + __ffs(below) - 1 : kNone;
      const int last = below ? t + 31 - __clz(below) : -1;
      const unsigned same = __match_any_sync(__activemask(), s);
      const int f = __reduce_min_sync(same, first);
      const int l = __reduce_max_sync(same, last);
      if (lane == __ffs(same) - 1) {
        if (f != kNone) atomicMin(&s_first[s], f);
        if (l >= 0) atomicMax(&s_last[s], l);
      }
      if (word) s_any[s] = 1;
    }
    __syncthreads();

    // The body's first fire, only where every stream has an above bit:
    // a word w per thread, a = the AND of the streams' bits (0 past T);
    // prev = the last zero of a before the current sample (c0 - 1 at
    // most: what lies before c0 cannot stop a body fire); t fires when
    // t - prev > cp + 1.
    bool may_fire = true;
    for (int s = 0; s < S; ++s) may_fire = may_fire && s_any[s];
    if (may_fire) {
      unsigned a = 0;
      int lz = -1;
      if (tid < n_w) {
        a = sc::kFull;
        for (int s = 0; s < S; ++s) a &= words[s][tid];
        lz = last_zero(a, (c0 >> 5) + tid);
      }
      int prev = max(sc::block_exclusive_max(lz, red), c0 - 1);
      if (tid < n_w && a != 0u) {
        const int tw = c0 + 32 * tid;
        for (int i = 0; i < 32; ++i) {
          if (!((a >> i) & 1u)) {
            prev = tw + i;
          } else if (tw + i - prev > cp + 1) {
            atomicMin(&s_fire, tw + i);
            break;
          }
        }
      }
    }
    if (tid < S) {
      first_below[(long long)tid * n_chunks + k] = s_first[tid];
      last_below[(long long)tid * n_chunks + k] = s_last[tid];
    }
    __syncthreads();
    if (tid == 0) {
      if (s_fire != kNone) atomicMax(state + kBound, ~(unsigned)s_fire);
      ++done;
    }
    k = s_next;  // rewritten only after the next job's first barrier
    if (k < 0) {  // no copy was started
      if (tid == 0) atomicAdd(state + kScanned, done);
      return;
    }
  }
}

__global__ void __launch_bounds__(kResolveThreads)
sc_sync_resolve(const float2* __restrict__ x,
                const unsigned* __restrict__ above,
                const int* __restrict__ first_below,
                const int* __restrict__ last_below,
                const unsigned* __restrict__ state, int S, int T, int M,
                int cp, int C, int n_chunks, int n_words,
                unsigned char* synced_out, long long* tstar_out,
                long long* starts, float2* __restrict__ corr) {
  constexpr int kWarps = kResolveThreads / 32;
  __shared__ int wmax[sc::kMaxStreams][kWarps];
  __shared__ float wsum[2][sc::kMaxStreams][kWarps];
  __shared__ int s_head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bound = bound_of(state[kBound]);
  // the chunks that start at or before the bound: all were scanned
  const int n_live =
      bound == kNone ? n_chunks : min(n_chunks, bound / C + 1);
  const int M2 = M >> 1;

  // Each thread takes a run of consecutive chunks, over all chunks so that
  // their loads need not wait for the bound's (the chunks past n_live were
  // not scanned and are masked).  carry[s] = the last below index before
  // the run's first chunk: an exclusive prefix max over the threads (warp
  // shuffles, then a scan of the warps' maxima).
  const int per = (n_chunks + kResolveThreads - 1) / kResolveThreads;
  const int k_lo = min(tid * per, n_chunks);
  const int k_hi = min(k_lo + per, n_chunks);
  if (tid == 0) s_head = kNone;
  int carry[sc::kMaxStreams];
#pragma unroll
  for (int s = 0; s < sc::kMaxStreams; ++s) carry[s] = -1;
#pragma unroll 4
  for (int k = k_lo; k < k_hi; ++k) {
#pragma unroll
    for (int s = 0; s < sc::kMaxStreams; ++s) {
      if (s < S) {
        const int lb = last_below[(long long)s * n_chunks + k];
        if (k < n_live) carry[s] = max(carry[s], lb);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < sc::kMaxStreams; ++s) {
    if (s < S) {
      int inc = carry[s];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(sc::kFull, inc, d);
        if (lane >= d) inc = max(inc, o);
      }
      carry[s] = __shfl_up_sync(sc::kFull, inc, 1);
      if (lane == 0) carry[s] = -1;
      if (lane == 31) wmax[s][warp] = inc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < sc::kMaxStreams; ++s) {
    if (s < S) {
      // the maximum over the earlier warps: an exclusive scan of wmax
      int inc = lane < kWarps ? wmax[s][lane] : -1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(sc::kFull, inc, d);
        if (lane >= d) inc = max(inc, o);
      }
      const int before = warp ? __shfl_sync(sc::kFull, inc, warp - 1) : -1;
      carry[s] = max(carry[s], before);
    }
  }
  // the run's first head fire (the marks were loaded above: L1 hits)
  int head = kNone;
  for (int k = k_lo; k < min(k_hi, n_live); ++k) {
    const int c0 = k * C;
    const int h_end = min(c0 + cp, min(c0 + C, T) - 1);
    int h = c0, first = kNone;
#pragma unroll
    for (int s = 0; s < sc::kMaxStreams; ++s) {
      if (s < S) {
        h = max(h, carry[s] + cp + 2);
        first = min(first, first_below[(long long)s * n_chunks + k]);
      }
    }
    if (h <= h_end && h < first) {
      head = h;  // the run's later chunks start later
      break;
    }
#pragma unroll
    for (int s = 0; s < sc::kMaxStreams; ++s) {
      if (s < S) {
        carry[s] = max(carry[s], last_below[(long long)s * n_chunks + k]);
      }
    }
  }
  if (head != kNone) atomicMin(&s_head, head);
  __syncthreads();
  const int fire = min(s_head, bound);
  const bool fired = fire != kNone;
  const int t = fired ? fire : 0;

  // per stream: the run start at t (the chunks before t's, from the
  // marks this thread holds, and t's bits up to t) and corr[t] = -(the
  // M/2 lag products that end at t); every stream's loads first
  const int b = t / C;
  const int w_lo = (b * C) >> 5;
  const int w_hi = t >> 5;
  int lb[sc::kMaxStreams];
  float cr[sc::kMaxStreams], ci[sc::kMaxStreams];
#pragma unroll
  for (int s = 0; s < sc::kMaxStreams; ++s) {
    lb[s] = -1;
    cr[s] = 0.f;
    ci[s] = 0.f;
    if (s < S) {
      for (int q = k_lo; q < min(k_hi, b); ++q) {
        lb[s] = max(lb[s], last_below[(long long)s * n_chunks + q]);
      }
      for (int w = w_lo + tid; w <= w_hi; w += kResolveThreads) {
        unsigned word = above[(long long)s * n_words + w];
        const int i = t & 31;
        if (w == w_hi && i < 31) word |= sc::kFull << (i + 1);  // past t
        lb[s] = max(lb[s], last_zero(word, w));
      }
      const float2* xs = x + (long long)s * T;
#pragma unroll 4
      for (int k = t - M2 + 1 + tid; k <= t; k += kResolveThreads) {
        if (k >= M2) {  // x before sample 0 is zero
          const float2 u = xs[k - M2];
          const float2 v = xs[k];
          cr[s] += u.x * v.x + u.y * v.y;
          ci[s] += u.x * v.y - u.y * v.x;
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < sc::kMaxStreams; ++s) {
    if (s < S) {
      const int l = sc::warp_max(lb[s]);
      const float r = sc::warp_sum(cr[s]);
      const float i = sc::warp_sum(ci[s]);
      if (lane == 0) {
        wmax[s][warp] = l;  // its carry reads are behind a barrier
        wsum[0][s][warp] = r;
        wsum[1][s][warp] = i;
      }
    }
  }
  __syncthreads();
  if (tid < S) {
    int l = -1;
    float r = 0.f, i = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      l = max(l, wmax[tid][w]);
      r += wsum[0][tid][w];
      i += wsum[1][tid][w];
    }
    starts[tid] = l + 1;
    corr[tid] = make_float2(-r, -i);
  }
  if (tid == 0) {
    *synced_out = fired ? 1 : 0;
    *tstar_out = t;
  }
}

// Blocks of sc_sync_scan per SM and the SM count of the current device,
// cached per device; the dynamic shared-memory limit is raised once per
// device.
cudaError_t occupancy(int* blocks_per_sm, int* n_sm) {
  static int cache[kDevs];
  static int sms[kDevs];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevs) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    const int smem = (int)Layout(kL).bytes;
    e = cudaFuncSetAttribute(sc_sync_scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, sc_sync_scan, kThreads, smem);
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
// dynamic shared memory bytes of launch 1.
cudaError_t launch(const float2* x, int S, int T, int M, int cp, float thr,
                   unsigned* above, int* first_below, int* last_below,
                   unsigned* state, unsigned char* synced,
                   long long* tstar_out, long long* starts, float2* corr,
                   cudaStream_t stream, int* geo) {
  const int smem = (int)Layout(kL).bytes;
  const int C = kL - M;
  const int n_chunks = (T + C - 1) / C;
  const int n_words = (T + 31) / 32;
  int bps = 0, n_sm = 0;
  cudaError_t e = occupancy(&bps, &n_sm);
  if (e != cudaSuccess) return e;
  const int grid = n_chunks < bps * n_sm ? n_chunks : bps * n_sm;
  if (geo != nullptr) {
    geo[0] = grid; geo[1] = bps; geo[2] = n_sm;
    geo[3] = kThreads; geo[4] = C; geo[5] = smem;
    return cudaSuccess;
  }
  e = cudaMemsetAsync(state, 0, kStateWords * sizeof(unsigned), stream);
  if (e != cudaSuccess) return e;
  sc_sync_scan<<<grid, kThreads, smem, stream>>>(
      x, S, T, M, cp, thr, n_chunks, n_words, above,
      first_below, last_below, state);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sc_sync_resolve<<<1, kResolveThreads, 0, stream>>>(
      x, above, first_below, last_below, state, S, T, M, cp, C, n_chunks,
      n_words, synced, tstar_out, starts, corr);
  return cudaGetLastError();
}

bool valid(int S, int T, int M, int cp) {
  return S >= 1 && S <= sc::kMaxStreams && T >= 1 && T < (1 << 30) &&
         M >= 32 && M <= 4096 && M % 32 == 0 && cp >= 0;
}

int dispatch(const float2* x, int S, int T, int M, int cp, float thr,
             unsigned* above, int* first_below, int* last_below,
             unsigned* state, unsigned char* synced, long long* tstar_out,
             long long* starts, float2* corr, void* stream, int* geo) {
  if (!valid(S, T, M, cp)) return (int)cudaErrorInvalidValue;
  // t - run_start <= t < T: a cp of T or more never fires, as T does,
  // and min(cp, T) keeps the index sums below 2^31
  cp = cp < T ? cp : T;
  return (int)launch(x, S, T, M, cp, thr, above, first_below, last_below,
                     state, synced, tstar_out, starts, corr,
                     static_cast<cudaStream_t>(stream), geo);
}

}  // namespace

// Chunk length C (output positions per ticket) for M, a multiple of 32;
// the caller sizes the chunks' marks as [S, ceil(T / C)] each.
extern "C" int sc_sync_chunk_len(int M) { return kL - M; }

// Launch 1's geometry on the current device for (S, T, M): geo[6] =
// grid, blocks per SM, SMs, threads, chunk length, dynamic shared bytes.
// Launches nothing.  Returns a cudaError_t.
extern "C" int sc_sync_geometry(int S, int T, int M, int* geo) {
  return dispatch(nullptr, S, T, M, 0, 0.f, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, geo);
}

// x: [S, T] complex64 (interleaved re, im).
// Scratch: above [S, ceil(T/32)] uint32, first_below and last_below
// [S, ceil(T/C)] int32 each, state [65] uint32 (zeroed here: the ticket
// at 0, the bound at 32, the chunks scanned at 64, which holds the
// count afterwards).
// Outputs: synced [1] uint8 (bool), tstar_out [1] int64, starts [S]
// int64, corr [S] complex64.  Requires 1 <= S <= 8, 1 <= T < 2^30, M a
// multiple of 32 in [32, 4096], cp >= 0.  Returns a cudaError_t.
extern "C" int sc_sync(const float2* x, int S, int T, int M, int cp,
                       float thr, unsigned* above, int* first_below,
                       int* last_below, unsigned* state,
                       unsigned char* synced, long long* tstar_out,
                       long long* starts, float2* corr, void* stream) {
  return dispatch(x, S, T, M, cp, thr, above, first_below, last_below,
                  state, synced, tstar_out, starts, corr, stream, nullptr);
}
