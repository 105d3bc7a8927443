// The hard demap of K3 and K4 (eq_demap.cu) for Hopper (sm_90a): a
// decision-region search over a grid of cells, with the full scan of
// every point as the exact path where the grid cannot decide.
//
// The region table (kernels/eq_demap.py::region_table builds it on the
// host from the points, one per table and device) covers the box
// [-R, R]^2, R = 2.5 max|c|, with a kGrid x kGrid grid.  Each cell's
// word holds up to kSlots candidate indices, one byte each, ascending,
// the last repeated into the unused slots; the word kFullScan (slot 0 =
// 255, slot 1 = 0: never an ascending list) sends the cell to the full
// scan.  A point is a candidate of a cell unless a single other point
// scores more than a tolerance above it at all four corners of the cell
// widened by a thousandth of its side (the score is affine in y, so such
// a point cannot win, or tie, anywhere in the cell under float32
// rounding).  So the first maximum over the candidates, in ascending
// order with payload_common.cuh's demap_step, is the first maximum over
// all the points: the decision equals the full scan's bit for bit.  One
// candidate decides without a score.
//
// Per symbol inside the box: the box test (false for NaN and Inf, so
// they take the full scan), the cell, one 32-bit shared load, and for a
// cell of several candidates one 16-byte shared load per candidate,
// (Re c, Im c, |c|^2 / 2, 0).  The full scan reads the same float4s,
// every point in order.
//
// The device table: [kCells] cell words, then [K] float4 points;
// load_table copies it into shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "payload_common.cuh"

namespace search {

constexpr int kGrid = 64;
constexpr int kCells = kGrid * kGrid;
constexpr int kSlots = 4;
constexpr unsigned kFullScan = 0xFFu;
constexpr int kCellVecs = kCells / 4;  // the cell words as uint4

// The grid's geometry and the point count: cell (ix, iy) of y is
// ((Re y + box) * scale, (Im y + box) * scale) truncated, scale =
// kGrid / (2 box) rounded to float32 on the host.
struct Grid {
  int n;
  float box;
  float scale;
};

// Copies the device table (kCellVecs + n uint4) into shared memory with
// 16-byte cp.async copies, all in flight at once, and waits for this
// thread's; every thread of the block calls it, and the caller
// synchronizes.
__device__ __forceinline__ void load_table(const uint4* __restrict__ table,
                                           int n, uint4* smem) {
  for (int i = threadIdx.x; i < kCellVecs + n; i += blockDim.x) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(table + i)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first maximum over all the points, in order (strict '>': a NaN
// score never wins, so NaN input decides 0).
__device__ __forceinline__ int full_scan(float yr, float yi, int n,
                                         const float4* pts) {
  float best = -CUDART_INF_F;
  int idx = 0;
#pragma unroll 4
  for (int q = 0; q < n; ++q) {
    const float4 c = pts[q];
    payload::demap_step(yr, yi, c.x, c.y, c.z, q, best, idx);
  }
  return idx;
}

// The decision of y from its cell, or -1 where the full scan decides
// (outside the box, NaN, Inf, or a kFullScan cell).  `table` is the
// shared copy: kCells words, then the points as float4.
__device__ __forceinline__ int region(float yr, float yi, const Grid& g,
                                      const uint4* table) {
  if (!(fabsf(yr) < g.box && fabsf(yi) < g.box)) return -1;
  const int ix = min((int)((yr + g.box) * g.scale), kGrid - 1);
  const int iy = min((int)((yi + g.box) * g.scale), kGrid - 1);
  const unsigned w =
      reinterpret_cast<const unsigned*>(table)[iy * kGrid + ix];
  if (w == kFullScan) return -1;
  int q = w & 0xFF;
  if (((w >> 8) & 0xFF) == (unsigned)q) return q;  // one candidate
  const float4* pts = reinterpret_cast<const float4*>(table + kCellVecs);
  float best = -CUDART_INF_F;
  int idx = 0;
  float4 c = pts[q];
  payload::demap_step(yr, yi, c.x, c.y, c.z, q, best, idx);
#pragma unroll
  for (int s = 1; s < kSlots; ++s) {
    const int qs = (w >> (8 * s)) & 0xFF;
    if (qs == q) break;  // the last candidate, repeated
    q = qs;
    c = pts[q];
    payload::demap_step(yr, yi, c.x, c.y, c.z, q, best, idx);
  }
  return idx;
}

// Decides E symbols (yr[e], yi[e]) into idx[e]: the region search for
// each, then one full scan per symbol it left, one at a time, so the
// scan's code appears once.
template <int E>
__device__ __forceinline__ void demap(const float (&yr)[E],
                                      const float (&yi)[E], const Grid& g,
                                      const uint4* table, int (&idx)[E]) {
  unsigned left = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    idx[e] = region(yr[e], yi[e], g, table);
    if (idx[e] < 0) left |= 1u << e;
  }
  const float4* pts = reinterpret_cast<const float4*>(table + kCellVecs);
  while (left != 0) {
    const int f = __ffs(left) - 1;
    left &= left - 1;
    float ar = yr[0], ai = yi[0];
#pragma unroll
    for (int e = 1; e < E; ++e) {
      ar = f == e ? yr[e] : ar;
      ai = f == e ? yi[e] : ai;
    }
    const int q = full_scan(ar, ai, g.n, pts);
#pragma unroll
    for (int e = 0; e < E; ++e) idx[e] = f == e ? q : idx[e];
  }
}

}  // namespace search
