// Shared code of the sharded 2D block kernels heat_g_block_padded.cu,
// heat_g_block_circular.cu, heat_g_block_fused.cu, heat_g_block_uniform.cu
// and heat_g_band_fix.cu: K Jacobi steps on one bx x by block of an
// m x n grid cut over a device mesh, from the block and the K-deep halo
// its neighbours sent (parallel/temporal.py), with the residual of the
// last step.
//
// Replaces the kernel-G family of parallel_heat_tpu/ops/pallas_stencil.py
// (_build_temporal_block, _build_temporal_block_circular,
// _build_temporal_block_fused, _build_temporal_block_uniform,
// _build_band_fix_2d). Each TPU builder keeps its own entry point here.
//
// Bound on the H100: a round reads the block once and writes its core
// once for K steps, plus each tile's K-deep frame, about
// 8*(1+2K/TY)*(1+2K/TX)/K bytes per cell-step (kernel E's), plus the
// tail and halo pieces, 4*(2K*bx + 2K*(by+2K)) bytes a block. Across the
// mesh a block also recomputes 2K(bx+by+2K) cells per round that its
// neighbours own, under 0.3% of a 16384 x 8192 block at K = 8; the
// design keeps that share small by taking K deep and by never assembling
// the extended block in HBM (the fused and uniform forms gather the
// pieces straight into shared memory). Below the bytes lie the step
// loop's shared-memory traffic and instruction issue: with E's column
// walk (heat_temporal.cuh) each cell-step read three operands from
// shared memory and stored one, 16 bytes and about 14 instructions, which
// held the family at 4x its byte bound.
//
// Design. Tiles of TY x TX output cells with a K-deep frame on all four
// sides, ping-pong in shared memory, the last step written straight to
// global memory and the residual folded by atomicMax on the float's bits.
// The step loop is the family's own, register-blocked (heat_g_rows): a
// warp walks a run of rows of the tile, each lane owning a group of 4
// adjacent columns with the rows above, at and below it in float4
// registers. Per row a lane reads the row below with one 16-byte load,
// takes the cell left of its group from the lane to its left and the
// cell right of it from the lane to its right (warp shuffles; lanes 0
// and 31 read that one cell from shared memory) and stores its 4 results
// with one 16-byte store: 8 bytes of shared traffic and about 9
// instructions a cell-step, 7 of them the combine's rounded operations.
// Shared rows are padded so that the core columns start on a 16-byte
// boundary (tile column K at a multiple of 4 floats) in every layout.
// A step updates the whole 4-column groups that cover its valid region
// (columns [s, TX+2K-s) at step s), so it also writes up to 3 cells on
// each side that lie outside the K-step cone of the outputs, computed
// from stale or never-loaded cells. That changes no output bit: a cell
// valid at step s reads only cells valid at step s-1, so no value from
// outside the cone ever reaches a cell that is written out, and the
// last step stores (and counts in the residual) exactly the output
// cells. Cells outside the global interior are copied, never recomputed,
// so the Dirichlet ring stays bit-exact even in a diverging run, and a
// block's K steps are bitwise kernel E's K steps on the same cells of
// the global grid (the TPU kernels pin the ring multiplicatively and
// re-pin it afterwards; this family needs neither). A block's framed
// tile is gathered in global coordinates (row_off, col_off of the
// block's cell (0, 0), int64) from
//   - u, the block, for its own cells;
//   - tail = [hi | lo] (bx x 2K): hi for global columns
//     [col_off+by, col_off+by+K), lo for [col_off-K, col_off) -- the
//     circular order of pallas_stencil.py:1648-1650;
//   - halo_n / halo_s (K x (by+2K)), the K rows above and below, corners
//     included, their columns in the same circular order [u | hi | lo];
//   - zero outside the global grid, and beyond the block's K-deep frame
//     (a ragged last tile reaches past it; those cells are K or more
//     cells from any output and never reach one in K steps).
// The assembled layouts read one buffer instead: circular (the pieces
// stacked as [halo_n ; u | hi | lo ; halo_s]) and padded ([lo | u | hi]
// between the halo rows, the JAX package's exchange_halos_deep_2d).
// The deferred bulk (halo_n = halo_s = null) writes only output rows
// [K, bx-K), whose K-step cone stays inside the block; the band kernel
// writes rows [0, K) and [bx-K, bx) from two (3K) x (TX+2K) windows into
// the bulk's output in place. Each counts the residual of exactly the
// rows it writes, so max(bulk, band) is the monolithic kernel's residual.
//
// Launch shapes (heat_g_launch refuses others; ops/hopper_params.py
// g_takes is the same rule): thread blocks of 32 x W threads, W <= 16,
// one warp per row of threads, so that the shuffles stay inside a row of
// lanes; output tiles TX a multiple of 4, so that every tile's core
// starts a group. A warp's run of rows is ceil((TY+2K) / W); a row wider than 32
// groups is walked in passes of 32.

#pragma once

#include "heat_temporal.cuh"

enum HeatGLayout { kHeatGFused = 0, kHeatGCircular = 1, kHeatGPadded = 2 };

// One row of lanes: the launch shapes' thread block is 32 x W, W at most
// kHeatGMaxWarps, so that the kernels may take up to 128 registers a
// thread (__launch_bounds__(kHeatGMaxThreads)) and the loop's float4 rows
// never spill.
constexpr int kHeatGLanes = 32;
constexpr int kHeatGMaxWarps = 16;
constexpr int kHeatGMaxThreads = kHeatGLanes * kHeatGMaxWarps;
constexpr unsigned kHeatGWarp = 0xffffffffu;

// Shared-memory layout of one buffer at depth k and tile width tile_x: the
// row stride in floats (a multiple of 4) and the pad that puts tile
// column k on a 16-byte boundary. ops/hopper_params.py g_row_floats is
// the same rule.
__host__ __device__ __forceinline__ int heat_g_pad(int k) {
  return (4 - k % 4) % 4;
}
__host__ __device__ __forceinline__ int heat_g_row_floats(int k,
                                                          int tile_x) {
  return (heat_g_pad(k) + tile_x + 2 * k + 3) / 4 * 4;
}

// One step of this warp's rows [r0, r1) over the 4-column groups
// [g0, g1) of the shared tile: group g holds shared floats [4g, 4g+4) of
// each row, tile columns [4g - pad, 4g - pad + 4). src and dst are
// 16-byte aligned buffers with a row stride of sx floats. Lanes take the
// groups in passes of 32; every lane of the warp runs every pass, so the
// shuffles see the whole warp, and a lane past g1 loads its own group
// (or the row's last) and stores nothing. An inner step writes dst. The
// last step (kLast) writes the grid in global memory instead, tile cell
// (r, c) at out[base + r * ld + c], for the columns below c_end only,
// 16 bytes at a time where vec_out says the address allows it, and folds
// the residual's bit pattern of exactly those cells into rmax. With
// kEdge the tile reaches past the grid's interior, rows [r_lo, r_hi] and
// columns [c_lo, c_hi] in tile coordinates, and the cells outside it are
// copied; without it every cell is updated and nothing is tested.
template <bool kLast, bool kEdge>
__device__ __forceinline__ void heat_g_rows(
    const float* __restrict__ src, float* __restrict__ dst,
    float* __restrict__ out, int sx, int pad, int64_t base, int64_t ld,
    bool vec_out, int r0, int r1, int g0, int g1, int c_end, int r_lo,
    int r_hi, int c_lo, int c_hi, float a0, float cx, float cy,
    uint32_t& rmax) {
  if (r0 >= r1) return;  // uniform across the warp
  const int lane = static_cast<int>(threadIdx.x);
  const int sx4 = sx >> 2;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
  for (int gb = g0; gb < g1; gb += kHeatGLanes) {
    const int g = gb + lane;
    const bool active = g < g1;
    const int gl = min(g, sx4 - 1);
    const int c = 4 * gl - pad;  // the group's first tile column
    // Lane 31 reads the cell right of its group from shared memory, lane
    // 0 the cell left of its own (row r's float before or after the
    // group: the row above's last or the row below's first where the
    // group ends the row; r >= 1 and r + 1 < rows always). The other lanes
    // read lane 0's cell too, a broadcast: one load for the warp, with no
    // branch around it.
    const int e_col = lane == kHeatGLanes - 1 ? 4 * gl + 4 : 4 * gb - 1;
    bool ci0 = true, ci1 = true, ci2 = true, ci3 = true;
    if (kEdge) {
      ci0 = c >= c_lo && c <= c_hi;
      ci1 = c + 1 >= c_lo && c + 1 <= c_hi;
      ci2 = c + 2 >= c_lo && c + 2 <= c_hi;
      ci3 = c + 3 >= c_lo && c + 3 <= c_hi;
    }
    bool st0 = false, st1 = false, st2 = false, st3 = false;
    if (kLast) {
      st0 = active && c < c_end;
      st1 = active && c + 1 < c_end;
      st2 = active && c + 2 < c_end;
      st3 = active && c + 3 < c_end;
    }
    const float4* p = s4 + gl;
    float4 up = p[(r0 - 1) * sx4];
    float4 cc = p[r0 * sx4];
    float4 dn = p[(r0 + 1) * sx4];
    const float* pe = src + r0 * sx + e_col;
    float* q = kLast ? out + (base + static_cast<int64_t>(r0) * ld + c)
                     : dst + (r0 * sx + 4 * gl);
    // Row r from the rows above, at and below it in registers; the row
    // below the next is read ahead by the loop, which stops one row short
    // so that the read stays inside the rows (r1 < rows), and the last
    // row runs on its own.
    auto row = [&](int r) {
      const float e = *pe;
      float lf = __shfl_up_sync(kHeatGWarp, cc.w, 1);
      float rt = __shfl_down_sync(kHeatGWarp, cc.x, 1);
      if (lane == 0) lf = e;
      if (lane == kHeatGLanes - 1) rt = e;
      float4 v;
      v.x = heat_combine(cc.x, up.x, dn.x, lf, cc.y, a0, cx, cy);
      v.y = heat_combine(cc.y, up.y, dn.y, cc.x, cc.z, a0, cx, cy);
      v.z = heat_combine(cc.z, up.z, dn.z, cc.y, cc.w, a0, cx, cy);
      v.w = heat_combine(cc.w, up.w, dn.w, cc.z, rt, a0, cx, cy);
      const bool rin = !kEdge || (r >= r_lo && r <= r_hi);
      const bool in0 = rin && ci0, in1 = rin && ci1, in2 = rin && ci2,
                 in3 = rin && ci3;
      if (kEdge) {
        v.x = in0 ? v.x : cc.x;
        v.y = in1 ? v.y : cc.y;
        v.z = in2 ? v.z : cc.z;
        v.w = in3 ? v.w : cc.w;
      }
      if (kLast) {
        if (st0 && in0) rmax = max(rmax, heat_diff_bits(v.x, cc.x));
        if (st1 && in1) rmax = max(rmax, heat_diff_bits(v.y, cc.y));
        if (st2 && in2) rmax = max(rmax, heat_diff_bits(v.z, cc.z));
        if (st3 && in3) rmax = max(rmax, heat_diff_bits(v.w, cc.w));
        if (vec_out && st3) {
          *reinterpret_cast<float4*>(q) = v;
        } else {
          if (st0) q[0] = v.x;
          if (st1) q[1] = v.y;
          if (st2) q[2] = v.z;
          if (st3) q[3] = v.w;
        }
        q += ld;
      } else {
        if (active) *reinterpret_cast<float4*>(q) = v;
        q += sx;
      }
      pe += sx;
    };
    int r = r0;
#pragma unroll 4
    for (; r < r1 - 1; ++r) {
      const float4 nx = p[(r + 2) * sx4];
      row(r);
      up = cc;
      cc = dn;
      dn = nx;
    }
    row(r);
  }
}

// heat_g_rows with kEdge chosen at run time (uniform per block).
template <bool kLast>
__device__ __forceinline__ void heat_g_rows_any(
    bool edge, const float* __restrict__ src, float* __restrict__ dst,
    float* __restrict__ out, int sx, int pad, int64_t base, int64_t ld,
    bool vec_out, int r0, int r1, int g0, int g1, int c_end, int r_lo,
    int r_hi, int c_lo, int c_hi, float a0, float cx, float cy,
    uint32_t& rmax) {
  if (edge)
    heat_g_rows<kLast, true>(src, dst, out, sx, pad, base, ld, vec_out, r0,
                             r1, g0, g1, c_end, r_lo, r_hi, c_lo, c_hi, a0,
                             cx, cy, rmax);
  else
    heat_g_rows<kLast, false>(src, dst, out, sx, pad, base, ld, vec_out, r0,
                              r1, g0, g1, c_end, r_lo, r_hi, c_lo, c_hi, a0,
                              cx, cy, rmax);
}

// Steps 1 .. K of one block, after its load of the framed tile was
// issued (cp.async) and committed: buffer `src` holds sy rows of sw
// cells, tile cell (r, c) at src[r * sx + pad + c], and shared cell
// (0, 0) is global cell (gy0, gx0) of an m x n grid, whose interior
// decides update or copy. Waits for the load, runs the K steps
// ping-ponging between src and dst, and writes the last step's tile rows
// [w_r0, w_r1) and columns [k, w_c1) to out[base + r * ld + c]; with
// `res` non-null it reduces the residual of exactly those cells into
// *res. Every thread of the block must call it.
__device__ __forceinline__ void heat_g_steps(
    float* src, float* dst, int sx, int pad, int sy, int sw, int64_t gy0,
    int64_t gx0, int64_t m, int64_t n, int k, int w_r0, int w_r1, int w_c1,
    float a0, float cx, float cy, float* __restrict__ out, int64_t base,
    int64_t ld, uint32_t* res) {
  // The grid's interior, rows 1 .. m-2 and columns 1 .. n-2, in tile
  // coordinates (clamped to the tile, so an empty range stays empty).
  const int r_lo = heat_clamp_local(1 - gy0, 0, sy);
  const int r_hi = heat_clamp_local(m - 2 - gy0, -1, sy - 1);
  const int c_lo = heat_clamp_local(1 - gx0, 0, sw);
  const int c_hi = heat_clamp_local(n - 2 - gx0, -1, sw - 1);
  // This warp's run of rows.
  const int run = (sy + blockDim.y - 1) / blockDim.y;
  const int t_r0 = threadIdx.y * run;
  const int t_r1 = min(t_r0 + run, sy);
  // Does the tile reach past the interior? Uniform across the block.
  const bool edge = r_lo > 0 || r_hi < sy - 1 || c_lo > 0 || c_hi < sw - 1;
  // Can the last step store a group as one 16-byte write? Uniform too.
  const bool vec_out =
      ld % 4 == 0 && (reinterpret_cast<uint64_t>(out) +
                      4 * static_cast<uint64_t>(base - pad)) % 16 == 0;
  __pipeline_wait_prior(0);
  __syncthreads();

  uint32_t rmax = 0u;
  // Steps 1 .. K-1 over the whole groups that cover the valid region.
  for (int s = 1; s < k; ++s) {
    heat_g_rows_any<false>(edge, src, dst, nullptr, sx, pad, 0, 0, false,
                           max(t_r0, s), min(t_r1, sy - s), (pad + s) / 4,
                           (pad + sw - s + 3) / 4, 0, r_lo, r_hi, c_lo, c_hi,
                           a0, cx, cy, rmax);
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // Step K: the rows and columns asked for, written to global memory,
  // with the residual.
  heat_g_rows_any<true>(edge, src, nullptr, out, sx, pad, base, ld, vec_out,
                        max(t_r0, w_r0), min(t_r1, w_r1), (pad + k) / 4,
                        (pad + w_c1 + 3) / 4, w_c1, r_lo, r_hi, c_lo, c_hi,
                        a0, cx, cy, rmax);
  if (res != nullptr) heat_block_max(rmax, res);
}

// The address of block-local cell (lr, lc), -K <= lr < bx + K and
// -K <= lc < by + K, in the layout's buffers; null where the fused
// layout has no halo row (the deferred bulk), which loads as 0.
template <int kLayout>
__device__ __forceinline__ const float* heat_g_src(
    const float* u, const float* tail, const float* hn, const float* hs,
    int64_t bx, int64_t by, int k, int64_t lr, int64_t lc) {
  const int64_t w = by + 2 * k;  // a halo row, or an assembled row
  if (kLayout == kHeatGPadded) return u + (lr + k) * w + (lc + k);
  const int64_t cc = lc < 0 ? lc + w : lc;  // circular column
  if (kLayout == kHeatGCircular) return u + (lr + k) * w + cc;
  if (lr < 0) return hn != nullptr ? hn + (lr + k) * w + cc : nullptr;
  if (lr >= bx) return hs != nullptr ? hs + (lr - bx) * w + cc : nullptr;
  if (lc >= 0 && lc < by) return u + lr * by + lc;
  return tail + lr * (2 * k) + (cc - by);
}

// The parameters of every G kernel, and their names: each entry point
// defines its own __global__ function (so a profile names it) whose body
// is heat_g_tile with its layout and load.
#define HEAT_G_PARAMS                                                       \
  const float *__restrict__ u, const float *__restrict__ tail,              \
      const float *__restrict__ hn, const float *__restrict__ hs,           \
      float *__restrict__ out, uint32_t *res, int64_t m, int64_t n,         \
      int64_t bx, int64_t by, int64_t row_off, int64_t col_off, int k,      \
      int64_t r_begin0, int64_t r_begin1, int64_t rows,                     \
      int64_t n_col_tiles, int tile_y, int tile_x, float a0, float cx,      \
      float cy
#define HEAT_G_ARGS                                                         \
  u, tail, hn, hs, out, res, m, n, bx, by, row_off, col_off, k, r_begin0,   \
      r_begin1, rows, n_col_tiles, tile_y, tile_x, a0, cx, cy

typedef void (*HeatGKernel)(const float*, const float*, const float*,
                            const float*, float*, uint32_t*, int64_t,
                            int64_t, int64_t, int64_t, int64_t, int64_t, int,
                            int64_t, int64_t, int64_t, int64_t, int, int,
                            float, float, float);

// One block of the launch: the output tile of TY x TX cells whose first
// row is block row r0 and first column c0, in region blockIdx.y (its
// first row r_begin0 or r_begin1, `rows` rows long), K steps, written to
// `out` (bx x by) and its residual folded into *res.
template <int kLayout, bool kUni>
__device__ __forceinline__ void heat_g_tile(HEAT_G_PARAMS) {
  extern __shared__ __align__(16) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  // Two buffers of sy rows of sx floats; tile column k (the core's
  // first) on a 16-byte boundary, as the step loop's groups need.
  const int pad = heat_g_pad(k);
  const int sx = heat_g_row_floats(k, tile_x);
  float* src = smem + pad;
  const int64_t region = blockIdx.y == 0 ? r_begin0 : r_begin1;
  const int64_t r0 = region + (blockIdx.x / n_col_tiles) * tile_y;
  const int64_t c0 = (blockIdx.x % n_col_tiles) * tile_x;
  // Block-local coordinates of shared cell (0, 0).
  const int64_t lr0 = r0 - k;
  const int64_t lc0 = c0 - k;

  // Does the framed tile lie inside the block? Then each of its rows is
  // one run of one buffer, whatever the layout.
  const bool inside = lr0 >= 0 && lr0 + sy <= bx && lc0 >= 0 &&
                      lc0 + sw <= by;
  if (kUni && inside) {
    // Kernel E-uni's load from u: 16-byte copies for the core columns
    // and no test per copy.
    const int vecs = tile_x / 4;
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const float* g = u + (lr0 + r) * by + lc0;
      float* s = src + r * sx;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x)
        __pipeline_memcpy_async(s + k + 4 * v, g + k + 4 * v, 16);
      for (int e = threadIdx.x; e < 2 * k; e += blockDim.x) {
        const int c = e < k ? e : tile_x + e;
        __pipeline_memcpy_async(s + c, g + c, 4);
      }
    }
  } else if (inside) {
    // Kernel E's load of an interior tile: one 4-byte copy per cell,
    // from the row's start in the layout's buffer.
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const float* g =
          heat_g_src<kLayout>(u, tail, hn, hs, bx, by, k, lr0 + r, lc0);
      for (int c = threadIdx.x; c < sw; c += blockDim.x)
        __pipeline_memcpy_async(src + r * sx + c, g + c, 4);
    }
  } else {
    // A tile at the block's edge: one checked 4-byte copy per cell from
    // the piece that holds it, zero-filled where none does.
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const int64_t lr = lr0 + r;
      const int64_t gi = row_off + lr;
      const bool row_in = gi >= 0 && gi < m && lr >= -k && lr < bx + k;
      for (int c = threadIdx.x; c < sw; c += blockDim.x) {
        const int64_t lc = lc0 + c;
        const int64_t gj = col_off + lc;
        const float* p =
            row_in && gj >= 0 && gj < n && lc >= -k && lc < by + k
                ? heat_g_src<kLayout>(u, tail, hn, hs, bx, by, k, lr, lc)
                : nullptr;
        __pipeline_memcpy_async(src + r * sx + c, p != nullptr ? p : u, 4,
                                p != nullptr ? 0 : 4);
      }
    }
  }
  __pipeline_commit();

  // The tile's output rows and columns, cut at the region's and the
  // block's end.
  const int64_t r_left = region + rows - r0;
  const int64_t c_left = by - c0;
  const int w_r1 = k + static_cast<int>(r_left < tile_y ? r_left : tile_y);
  const int w_c1 = k + static_cast<int>(c_left < tile_x ? c_left : tile_x);
  heat_g_steps(smem, smem + sy * sx, sx, pad, sy, sw, row_off + lr0,
               col_off + lc0, m, n, k, k, w_r1, w_c1, a0, cx, cy, out,
               lr0 * by + lc0, by, res);
}

// The launch shapes the step loop takes (ops/hopper_params.py g_takes
// is the same rule): rows of 32 lanes, at most kHeatGMaxWarps of them,
// output tiles whose width is a multiple of 4.
inline bool heat_g_takes(int tile_y, int tile_x, int block_x, int block_y) {
  return tile_y >= 1 && tile_x >= 4 && tile_x % 4 == 0 &&
         block_x == kHeatGLanes && block_y >= 1 && block_y <= kHeatGMaxWarps;
}

// Dynamic shared memory of one block: two buffers of tile_y + 2k rows
// (ops/hopper_params.py g_smem_bytes).
inline size_t heat_g_smem_bytes(int k, int tile_y, int tile_x) {
  return sizeof(float) * 2 * static_cast<size_t>(tile_y + 2 * k) *
         static_cast<size_t>(heat_g_row_floats(k, tile_x));
}

// Thread blocks of `kernel` that one SM holds at once at depth k, tile
// and thread block, into *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at the launch's dynamic shared memory). Returns a cudaError_t.
inline int heat_g_occupancy(HeatGKernel kernel, int k, int tile_y,
                            int tile_x, int block_x, int block_y,
                            int* blocks) {
  if (blocks == nullptr || k < 1 ||
      !heat_g_takes(tile_y, tile_x, block_x, block_y))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(heat_g_smem_bytes(k, tile_y, tile_x));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_x * block_y, smem));
}

// Checks the arguments, zeroes *res, and launches `kernel` over
// `regions` (1 or 2) row regions of `rows` rows each, starting at block
// rows r_begin0 and r_begin1, on `stream`. Returns a cudaError_t: 0, or
// the reason the launch was refused.
// `kernel` is the entry point's __global__ function; `uni` says whether
// its body loads as kernel E-uni does (16-byte copies from u, so the
// block's width a multiple of 4 and u 16-byte aligned).
inline int heat_g_launch(HeatGKernel kernel, bool uni, const float* u,
                         const float* tail, const float* hn, const float* hs,
                         float* out, uint32_t* res, int64_t m, int64_t n,
                         int64_t bx, int64_t by, int64_t row_off,
                         int64_t col_off, int k, int64_t r_begin0,
                         int64_t r_begin1, int64_t rows, int regions,
                         int tile_y, int tile_x, int block_x, int block_y,
                         float a0, float cx, float cy, void* stream) {
  if (m < 3 || n < 3 || bx < 1 || by < 1 || k < 1 || k > bx || k > by ||
      row_off < 0 || col_off < 0 || row_off + bx > m || col_off + by > n ||
      rows < 1 || r_begin0 < 0 || r_begin1 + rows > bx || regions < 1 ||
      regions > 2 || !heat_g_takes(tile_y, tile_x, block_x, block_y))
    return static_cast<int>(cudaErrorInvalidValue);
  if (uni && (by % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_col_tiles = (by + tile_x - 1) / tile_x;
  const int64_t blocks = n_col_tiles * ((rows + tile_y - 1) / tile_y);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = heat_g_smem_bytes(k, tile_y, tile_x);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), regions),
           dim3(block_x, block_y), smem, s>>>(
      u, tail, hn, hs, out, res, m, n, bx, by, row_off, col_off, k, r_begin0,
      r_begin1, rows, n_col_tiles, tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}
