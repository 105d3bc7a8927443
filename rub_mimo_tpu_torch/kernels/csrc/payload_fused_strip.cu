// Strip-fused payload tail for Hopper (sm_90a): CP strip + M-point FFT +
// per-subcarrier S x S equalize + hard demap, a persistent block per SM
// slot walking over the frames.
//
// Replaces the TPU Pallas kernel
//   rub_mimo_tpu/kernels/payload_fused.py::payload_fused_strip
//   (body _kernel_strip / _fft_eq_demap),
// whose 128x128 matmul factorisation of the DFT was shaped by the TPU's
// matrix unit and is not carried over.  Outputs are in natural subcarrier
// order with exactly n_sym frames (no packed order, no pad frames).
//
// What bounds it.  The bytes: at the reference operating point (M=2048,
// CP=152, S=2, 1000 frames) it reads the kept 33 MB of the f32 payload
// planes (the CP's 608 bytes per plane are whole 32-byte sectors, never
// fetched) and writes ~49 MB (int32 decisions + complex64 symbols):
// ~82 MB, a floor of ~24.5 us at the card's 3.35 TB/s.  In practice the
// instructions: the demap's 32-point search costs two FMAs and three
// compare/select instructions per point and symbol, the compares on the
// half-rate ALU pipe, and the FFT ~10 float operations per point and
// pass.
//
// Design (payload_fft.cuh has the block, shared with K2): a grid of
// min(n_sym, blocks per SM x SMs) blocks, each striding over frames;
// frame k + grid is copied with cp.async into a natural-order stage
// buffer (16-byte copies where plane_len, sym, cp and the plane pointers
// are multiples of 4 floats / 16 bytes, else 4-byte copies) while frame
// k runs its FFT.  The frames are read either from a compact payload
// window or straight from a whole capture at a window start held on the
// device (the served decode's, which no gather copies out first): the
// start's alignment is known only on the device, so each frame's 16-byte
// copies take the aligned span that encloses it, one copy more a row,
// and the stage is read at the start's offset mod 4; only frames that
// reach outside the capture take 4-byte copies and zeros.  Then a
// Stockham FFT of radix-16 register passes (2048 = 16 * 16 * 8) through
// a padded, conflict-free shared buffer, then the equalize, the demap over points passed by value in the
// kernel's parameters, and evict-first stores.  Measured at the
// operating point on an NVIDIA H100 80GB HBM3, power limit 700 W:
// 0.0629 ms device time (chip_smoke.py, torch.profiler), 39 % of the
// bytes bound; the demap costs ~0.9 us per constellation point
// (chip_smoke.py, k1_k2_times, K1 per modulation).

// Plain C interface for ctypes; the launcher returns a cudaError_t.

#include <cuda_runtime.h>

#include "payload_common.cuh"
#include "payload_fft.cuh"

namespace {

// The CP-strip load: frame k's row s is p[s][f0 : f0 + M], f0 = start +
// k*sym + cp, of two f32 planes of plane_len samples a row, with zeros
// for positions outside [0, plane_len).  `start` is a device scalar (the
// decode's window start in a whole capture, never read on the host) or
// null for 0 (a compact window).  The stage buffer holds [2][S][M + 4]
// floats: a row's samples begin at `shift`.
constexpr int kSlack = 4;  // stage floats a row beyond M

// A frame that reaches outside the planes: 4-byte copies of its samples
// inside them and zeros for the rest, into the stage when two, else into
// the padded work rows.  Kept out of line so that its registers and
// predicates stay off the copies of the frames inside.
__device__ __noinline__ void edge_copy(const float* p_re, const float* p_im,
                                       long long plane_len, long long f0,
                                       int shift, float* d, bool two, int S,
                                       int M, int RS, int i0, int nt) {
  for (int r = 0; r < 2 * S; ++r) {  // r = plane * S + s
    const int s = r < S ? r : r - S;
    const float* row = (r < S ? p_re : p_im) + s * plane_len;
    for (int i = i0; i < M; i += nt) {
      const long long p = f0 + i;
      float* to = two ? d + r * (M + kSlack) + shift + i
                      : d + 2 * s * RS + (r < S ? 0 : 1) + 2 * pfft::pad(i);
      if (p >= 0 && p < plane_len)
        pfft::cp_async4(to, row + p);
      else
        *to = 0.f;
    }
  }
}

struct StripIn {
  const float* p_re;
  const float* p_im;
  const long long* start;
  long long plane_len;
  int sym, cp, vec;  // vec: 16-byte copies (plane rows, sym, cp aligned)
  int S_, M_;
  // set once a block by begin()
  long long base;  // the window's start
  int shift;       // base mod 4 where vec, else 0

  __device__ __forceinline__ void begin() {
    base = start != nullptr ? __ldg(start) : 0;
    shift = vec ? (int)(base & 3) : 0;
  }

  // Starts frame k's copy: into the natural-order stage buffer when two
  // (16-byte copies where vec, else 4-byte), else into the padded work
  // rows (4-byte copies).  Where vec, a frame takes the 16-byte copies of
  // the aligned span that holds it: sym and cp are multiples of 4, so
  // every frame has the same offset `shift` in its first 16 bytes.
  __device__ __forceinline__ void issue(int k, float2* dst, bool two, int S,
                                        int M, int RS, int i0,
                                        int nt) const {
    const long long f0 = base + (long long)k * sym + cp;
    float* d = reinterpret_cast<float*>(dst);
    if (f0 < 0 || f0 + M > plane_len) {
      edge_copy(p_re, p_im, plane_len, f0, shift, d, two, S, M, RS, i0, nt);
      return;
    }
    for (int r = 0; r < 2 * S; ++r) {  // r = plane * S + s
      const int s = r < S ? r : r - S;
      const float* src = (r < S ? p_re : p_im) + s * plane_len + f0;
      if (two && vec) {
        float* st = d + r * (M + kSlack);
        src -= shift;
        const int n4 = (shift + M + 3) >> 2;
        for (int j = i0; j < n4; j += nt)
          pfft::cp_async16(st + 4 * j, src + 4 * j);
      } else if (two) {
        float* st = d + r * (M + kSlack);
        for (int i = i0; i < M; i += nt) pfft::cp_async4(st + i, src + i);
      } else {
        float* wk = d + 2 * s * RS + (r < S ? 0 : 1);
        for (int i = i0; i < M; i += nt)
          pfft::cp_async4(wk + 2 * pfft::pad(i), src + i);
      }
    }
  }

  __device__ __forceinline__ float2 read(const float2* stage, int s,
                                         int n) const {
    const float* st = reinterpret_cast<const float*>(stage) + shift + n;
    return make_float2(st[s * (M_ + kSlack)], st[(S_ + s) * (M_ + kSlack)]);
  }
};

template <int S, bool TWO>
__global__ void __launch_bounds__(TWO ? 256 : 1024)
payload_fused_strip_kernel(const StripIn in, const pfft::Tail a) {
  StripIn w = in;
  w.begin();
  pfft::frames<S, TWO>(w, a);
}

template <int S, bool TWO>
cudaError_t run(const StripIn& in, const pfft::Tail& a, int n_sym,
                cudaStream_t stream, int* geo) {
  const pfft::Geometry g = pfft::geometry(S, a.M, a.n_tw, kSlack * S);
  int bps = 0, n_sm = 0;
  cudaError_t e = pfft::occupancy<payload_fused_strip_kernel<S, TWO>>(
      a.log2M, g, &bps, &n_sm);
  if (e != cudaSuccess) return e;
  const int grid = n_sym < bps * n_sm ? n_sym : bps * n_sm;
  if (geo != nullptr) {
    geo[0] = grid; geo[1] = bps; geo[2] = n_sm;
    geo[3] = g.threads; geo[4] = g.smem; geo[5] = g.two_stage;
    return cudaSuccess;
  }
  payload_fused_strip_kernel<S, TWO><<<grid, g.threads, g.smem, stream>>>(
      in, a);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch(const StripIn& in, const pfft::Tail& a, int n_sym,
                     cudaStream_t stream, int* geo) {
  if (pfft::geometry(S, a.M, a.n_tw).two_stage)
    return run<S, true>(in, a, n_sym, stream, geo);
  if constexpr (S > 1) return run<S, false>(in, a, n_sym, stream, geo);
  return cudaErrorInvalidValue;  // S = 1 always fits two stages
}

int launch(const float* p_re, const float* p_im, long long plane_len,
           const long long* start, const float2* W, const float* gain,
           const float* points, int n_points, const int* plan, int n_pass,
           const float2* twiddle, float dft_norm, int S, int M, int log2M,
           int n_sym, int sym, int cp, int* rx_data, float2* rx_sig,
           void* stream, int* geo) {
  if (n_sym < 1 || M != (1 << log2M) || M < 64 || M > 4096 || cp < 0 ||
      sym < M + cp || S < 1 || S > 4) {
    return (int)cudaErrorInvalidValue;
  }
  pfft::Tail a{};
  if (!pfft::fill_tail(a, points, n_points, plan, n_pass, M))
    return (int)cudaErrorInvalidValue;
  a.W = W; a.gain = gain; a.tw = twiddle; a.rx_data = rx_data;
  a.rx_sig = rx_sig; a.dft_norm = dft_norm; a.M = M; a.log2M = log2M;
  a.n_sym = n_sym;
  const int vec = plane_len % 4 == 0 && sym % 4 == 0 && cp % 4 == 0 &&
                  reinterpret_cast<size_t>(p_re) % 16 == 0 &&
                  reinterpret_cast<size_t>(p_im) % 16 == 0;
  const StripIn in{p_re, p_im, start, plane_len, sym, cp, vec, S, M, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return (int)dispatch<1>(in, a, n_sym, st, geo);
    case 2: return (int)dispatch<2>(in, a, n_sym, st, geo);
    case 3: return (int)dispatch<3>(in, a, n_sym, st, geo);
    default: return (int)dispatch<4>(in, a, n_sym, st, geo);
  }
}

}  // namespace

// p_re, p_im: [S, plane_len] f32 planes: the flat payload (CPs in
// place) when start is null, else a whole capture whose window starts at
// *start (a device int64; frame k at *start + k*sym + cp, zeros outside
// [0, plane_len))
// W: [M, S(out), S(rx)] complex64; gain: [M] f32
// points: host [3, 64] f32 rows (Re c, Im c, |c|^2/2), the first
// n_points used, n_points <= 64 (copied into the kernel's parameters)
// plan: host [n_pass] radices, 16 first, product M
// twiddle: complex64 payload_fused.pass_twiddles(M), the [R][Ns]
// twiddles of each pass after the first
// rx_data: [S, n_sym, M] int32; rx_sig: [S, n_sym, M] complex64 or null
// Requires M a power of two in [64, 4096], 1 <= S <= 4, n_sym >= 1,
// sym >= M + cp (a pitch above M + cp skips the samples between
// symbols), and plane_len >= n_sym * sym when start is null.  Returns a
// cudaError_t.
extern "C" int payload_fused_strip(
    const float* p_re, const float* p_im, long long plane_len,
    const long long* start, const float2* W, const float* gain,
    const float* points, int n_points, const int* plan, int n_pass,
    const float2* twiddle, float dft_norm, int S, int M, int log2M,
    int n_sym, int sym, int cp, int* rx_data, float2* rx_sig,
    void* stream) {
  return launch(p_re, p_im, plane_len, start, W, gain, points, n_points,
                plan, n_pass, twiddle, dft_norm, S, M, log2M, n_sym, sym,
                cp, rx_data, rx_sig, stream, nullptr);
}

// The launch payload_fused_strip would make, without launching:
// geo[6] = grid, blocks per SM, SMs, threads per block, dynamic shared
// bytes, two-stage (1/0).  Returns a cudaError_t.
extern "C" int payload_fused_strip_geometry(int S, int M, int log2M,
                                            int n_sym, const int* plan,
                                            int n_pass, int* geo) {
  float points[3 * pfft::kMaxPoints] = {};
  return launch(nullptr, nullptr, 0, nullptr, nullptr, nullptr, points, 1,
                plan, n_pass, nullptr, 1.f, S, M, log2M, n_sym, M, 0,
                nullptr, nullptr, nullptr, geo);
}
