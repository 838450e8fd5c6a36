// Shared device code of the K-step temporal kernels (heat_e_temporal.cu,
// heat_e_uni_temporal.cu): the step phase that follows a block's load of
// its framed tile. The kernels differ only in how they load. (The
// sharded block kernels heat_g_*.cu step with their own register-blocked
// loop, heat_g.cuh.)
// heat_a_resident.cu steps its resident tiles with heat_e_tile_step_any.

#pragma once

#include <cuda_pipeline.h>

#include "heat_common.cuh"

// v clamped to [lo, hi], as an int (lo and hi are tile coordinates).
__device__ __forceinline__ int heat_clamp_local(int64_t v, int lo, int hi) {
  return static_cast<int>(v < lo ? lo : (v > hi ? hi : v));
}

// One step over rows [r0, r1) and columns [c0, c1) of the shared tile
// (row stride sx), for this thread's rows. An inner step writes dst, a
// tile of the same layout as src. The last step (kLast) writes the grid
// in global memory instead, cell (r, c) of the tile at
// dst[base + r * ld + c], and folds
// the residual's bit pattern into *rmax. With kEdge the tile reaches
// past the grid's interior, rows [r_lo, r_hi] and columns [c_lo, c_hi]
// in tile coordinates, and the cells outside it are copied; without it
// every cell is updated and nothing is tested. The combine is computed
// everywhere and selected, which keeps the loop free of branches.
template <bool kLast, bool kEdge>
__device__ __forceinline__ void heat_e_tile_step(
    const float* __restrict__ src, float* __restrict__ dst, int sx,
    int64_t base, int64_t ld, int r0, int r1, int c0, int c1, int r_lo,
    int r_hi, int c_lo, int c_hi, float a0, float cx, float cy,
    uint32_t* rmax) {
  if (r0 >= r1) return;
  for (int c = c0 + static_cast<int>(threadIdx.x); c < c1; c += blockDim.x) {
    const bool col_in = !kEdge || (c >= c_lo && c <= c_hi);
    const float* p = src + r0 * sx + c;  // row r
    const float* pd = p + sx;            // row r + 1
    float up = p[-sx];
    float cc = *p;
    float* q = kLast ? dst + (base + r0 * ld + c) : dst + (r0 * sx + c);
    for (int r = r0; r < r1; ++r) {
      const float down = *pd;
      const float w = heat_combine(cc, up, down, p[-1], p[1], a0, cx, cy);
      const bool in = !kEdge || (col_in && r >= r_lo && r <= r_hi);
      const float v = kEdge ? (in ? w : cc) : w;
      if (kLast && in) *rmax = max(*rmax, heat_diff_bits(v, cc));
      *q = v;
      if (kLast) q += ld; else q += sx;
      p = pd;
      pd += sx;
      up = cc;
      cc = down;
    }
  }
}

// heat_e_tile_step with kEdge chosen at run time (uniform per block).
template <bool kLast>
__device__ __forceinline__ void heat_e_tile_step_any(
    bool edge, const float* __restrict__ src, float* __restrict__ dst,
    int sx, int64_t base, int64_t ld, int r0, int r1, int c0, int c1,
    int r_lo, int r_hi, int c_lo, int c_hi, float a0, float cx, float cy,
    uint32_t* rmax) {
  if (edge)
    heat_e_tile_step<kLast, true>(src, dst, sx, base, ld, r0, r1, c0, c1,
                                  r_lo, r_hi, c_lo, c_hi, a0, cx, cy, rmax);
  else
    heat_e_tile_step<kLast, false>(src, dst, sx, base, ld, r0, r1, c0, c1,
                                   r_lo, r_hi, c_lo, c_hi, a0, cx, cy, rmax);
}

// Steps 1 .. K of one block, after its load of the framed tile was
// issued (cp.async) and committed: `src` holds sy rows of sw cells at a
// row stride of sx floats, and shared cell (0, 0) is global cell (gy0,
// gx0) of an m x n grid, whose interior decides update or copy. Waits
// for the load, runs the K steps ping-ponging between src and dst, and
// writes the last step's tile rows [w_r0, w_r1) and columns [k, w_c1)
// to out[base + r * ld + c]; with `res` non-null it reduces the
// residual of exactly those cells into *res. Every thread of the block
// must call it. heat_e_steps writes into the grid itself; the sharded
// block kernels (heat_g.cuh) write into a block of it.
__device__ __forceinline__ void heat_tile_steps(
    float* src, float* dst, int sx, int sy, int sw, int64_t gy0,
    int64_t gx0, int64_t m, int64_t n, int k, int w_r0, int w_r1, int w_c1,
    float a0, float cx, float cy, float* __restrict__ out, int64_t base,
    int64_t ld, uint32_t* res) {
  // The grid's interior, rows 1 .. m-2 and columns 1 .. n-2, in tile
  // coordinates (clamped to the tile, so an empty range stays empty).
  const int r_lo = heat_clamp_local(1 - gy0, 0, sy);
  const int r_hi = heat_clamp_local(m - 2 - gy0, -1, sy - 1);
  const int c_lo = heat_clamp_local(1 - gx0, 0, sw);
  const int c_hi = heat_clamp_local(n - 2 - gx0, -1, sw - 1);
  // This thread's run of rows.
  const int run = (sy + blockDim.y - 1) / blockDim.y;
  const int t_r0 = threadIdx.y * run;
  const int t_r1 = min(t_r0 + run, sy);
  // Does the tile reach past the interior? Uniform across the block.
  const bool edge = r_lo > 0 || r_hi < sy - 1 || c_lo > 0 || c_hi < sw - 1;
  __pipeline_wait_prior(0);
  __syncthreads();

  // Steps 1 .. K-1 over the shrinking valid region.
  for (int s = 1; s < k; ++s) {
    heat_e_tile_step_any<false>(edge, src, dst, sx, 0, sx, max(t_r0, s),
                                min(t_r1, sy - s), s, sw - s, r_lo, r_hi,
                                c_lo, c_hi, a0, cx, cy, nullptr);
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // Step K: the rows and columns asked for, written to global memory,
  // with the residual.
  uint32_t rmax = 0u;
  heat_e_tile_step_any<true>(edge, src, out, sx, base, ld,
                             max(t_r0, w_r0), min(t_r1, w_r1), k, w_c1, r_lo,
                             r_hi, c_lo, c_hi, a0, cx, cy, &rmax);
  if (res != nullptr) heat_block_max(rmax, res);
}

// heat_tile_steps for a tile of the grid itself (kernels E and E-uni):
// the central TY x TX tile, cut at the grid's edge, lands in `out`, an
// m x n grid like the input.
__device__ __forceinline__ void heat_e_steps(
    float* src, float* dst, int sx, int sy, int sw, int64_t gy0,
    int64_t gx0, int64_t m, int64_t n, int k, int tile_y, int tile_x,
    float a0, float cx, float cy, float* __restrict__ out, uint32_t* res) {
  const int r_end = heat_clamp_local(m - gy0, 0, k + tile_y);
  const int c_end = heat_clamp_local(n - gx0, 0, k + tile_x);
  heat_tile_steps(src, dst, sx, sy, sw, gy0, gx0, m, n, k, k, r_end, c_end,
                  a0, cx, cy, out, gy0 * n + gx0, n, res);
}
