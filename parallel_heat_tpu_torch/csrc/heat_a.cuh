// The resident step phase of kernels A and M (heat_a_resident.cu,
// heat_m_ensemble.cu): a block holds one tile of a grid (or of a member)
// and a d-deep frame around it in two shared buffers, and advances it K
// steps in groups of at most d, each step through the register-blocked
// tile loop of heat_temporal.cuh (heat_rows); between groups the frame
// is refilled from the neighbours' edge bands through a global exchange
// plane. Also kernel A itself and its launch, compiled once per variant
// of the anatomy probe (heat_probe_kernel.cu, tools/kernel_probe.py):
// each variant cuts one cost out of A's launch, and only kHeatAFull
// computes A's function:
//   - kHeatANoBarrier: no grid-wide barrier between groups of steps;
//   - kHeatANoExchange: no band written and no frame read;
//   - kHeatACopyStep: each cell-step a copy instead of the combine, with
//     the loop's addressing, shuffles and barriers kept;
//   - kHeatANoEdge: every block stepped as one inside the interior.
// And once per neighbour form of the tile loop (heat_probe_roll_pad.cu,
// tools/probe_roll_pad.py): heat_a_loop_kernel<kLoop> is A's kernel with
// the loop's variant kLoop (heat_temporal.cuh kHeatLoopPadSlice,
// kHeatLoopNbr4), which computes A's function too.
//
// The layout is the tile loop's: rows of heat_row_floats(d, tile_x)
// floats, tile cell (r, c) of the framed tile at src[r * sx + pad + c]
// with pad = heat_row_pad(d), so the tile's first column starts a group
// of 4 floats; launch shapes are heat_a_takes's (32 lanes by at most
// 16 warps, tile widths a multiple of 4 or the grid's).
//
// Why the bits hold across groups. Step s of a group of j steps updates
// the whole groups of 4 columns that cover the region e = d - (j - s)
// cells in from the framed tile's edge, rows [e, sh - e): the frame's
// valid region shrinks by one cell a side and step, so after the group
// the tile is exact (heat_temporal.cuh says why the up to 3 cells a side
// that a step computes outside the region reach no output). Those cells
// lie in the frame, and the exchange rewrites every frame cell inside
// the grid from the neighbours' exact bands before the next group reads
// it; frame cells outside the grid are never read by an interior cell
// (the Dirichlet ring lies between) and are copied, never updated.
// Nothing else of the buffers is read before it is written, so neither
// buffer is cleared.
//
// Storage precision. The shared buffers and the exchange planes hold
// float32 at every storage dtype: a bfloat16 grid (heat_a_resident_bf16)
// is widened as its tile lands, every level rounds its updated cells to
// bfloat16 (the tile loop's kRound, heat_temporal.cuh), so a band holds
// values that are bfloat16 already and crosses the plane exactly, and the
// last step stores bfloat16. A runs no f32chunk form: the JAX picker never
// takes A under accumulate="f32chunk", and neither does the port's.

#pragma once

#include <cooperative_groups.h>

#include "heat_temporal.cuh"

namespace cg = cooperative_groups;

constexpr int kHeatAFull = 0;
constexpr int kHeatANoBarrier = 1;
constexpr int kHeatANoExchange = 2;
constexpr int kHeatACopyStep = 3;
constexpr int kHeatANoEdge = 4;

// Does the step phase take tile_y x tile_x tiles of a grid n wide under
// block_x x block_y threads? The tile loop's rule (heat_loop_takes), but
// a tile as wide as the grid, one column of tiles, may have any width:
// the rule's multiple of 4 puts every tile's first column on a group,
// and the only tile of a column starts at column 0 (ops/hopper_params.py
// a_takes is the same rule).
inline bool heat_a_takes(int64_t n, int tile_y, int tile_x, int block_x,
                         int block_y) {
  return heat_loop_takes(tile_y, (tile_x + 3) / 4 * 4, block_x, block_y) &&
         (tile_x % 4 == 0 || tile_x >= n);
}

// One block's tile of an m x n grid: tile `tile` of the row-major tiling
// by tile_y x tile_x tiles over n_col_tiles columns, cut at the grid's
// edge to h x w, with a d-deep frame (sh x sw cells framed); shared cell
// (0, 0) is grid cell (gy0, gx0), at float pad of a row of sx.
struct HeatATile {
  int i0, j0, h, w, d, pad, sx, sh, sw, gy0, gx0;
};

__device__ __forceinline__ HeatATile heat_a_tile(int m, int n, int tile,
                                                 int n_col_tiles, int tile_y,
                                                 int tile_x, int d) {
  HeatATile t;
  t.i0 = (tile / n_col_tiles) * tile_y;
  t.j0 = (tile % n_col_tiles) * tile_x;
  t.h = min(tile_y, m - t.i0);
  t.w = min(tile_x, n - t.j0);
  t.d = d;
  t.pad = heat_row_pad(d);
  t.sx = heat_row_floats(d, tile_x);
  t.sh = t.h + 2 * d;
  t.sw = t.w + 2 * d;
  t.gy0 = t.i0 - d;
  t.gx0 = t.j0 - d;
  return t;
}

// The framed tile of `u` into src: one 4-byte cp.async a cell, cells
// outside the grid zero-filled; returns once it has landed for the whole
// block.
// A bfloat16 grid's tile is widened as it lands: a plain 2-byte load a
// cell, then the block's barrier.
__device__ __forceinline__ void heat_a_load(
    const __nv_bfloat16* __restrict__ u, float* src, const HeatATile& t,
    int m, int n) {
  for (int r = threadIdx.y; r < t.sh; r += blockDim.y) {
    const int gi = t.gy0 + r;
    const bool row_in = gi >= 0 && gi < m;
    float* s = src + r * t.sx + t.pad;
    for (int c = threadIdx.x; c < t.sw; c += blockDim.x) {
      const int gj = t.gx0 + c;
      s[c] = row_in && gj >= 0 && gj < n ? heat_widen(u[gi * n + gj]) : 0.f;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void heat_a_load(const float* __restrict__ u,
                                            float* src, const HeatATile& t,
                                            int m, int n) {
  for (int r = threadIdx.y; r < t.sh; r += blockDim.y) {
    const int gi = t.gy0 + r;
    const bool row_in = gi >= 0 && gi < m;
    float* s = src + r * t.sx + t.pad;
    for (int c = threadIdx.x; c < t.sw; c += blockDim.x) {
      const int gj = t.gx0 + c;
      const bool in = row_in && gj >= 0 && gj < n;
      __pipeline_memcpy_async(s + c, in ? u + gi * n + gj : u, 4,
                              in ? 0 : 4);
    }
  }
  __pipeline_commit();
  HeatCpAsyncWait{}();
}

// The tile's d-deep edge band, from src to the exchange plane (an m x n
// grid, written at L2): a row is whole in the tile's first and last d
// rows, and in a tile at most 2d wide; elsewhere its first and last d
// cells. One flat index over the band's cells, so the block's threads
// share it evenly.
__device__ __forceinline__ void heat_a_band_out(const float* src,
                                                const HeatATile& t,
                                                float* plane, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int whole_rows = min(t.h, 2 * t.d);
  const int side = min(t.w, 2 * t.d);
  const int whole = whole_rows * t.w;
  const int cells = whole + (t.h - whole_rows) * side;
  for (int f = tid; f < cells; f += threads) {
    int r, c;
    if (f < whole) {
      r = f / t.w;
      c = f - r * t.w;
      if (r >= t.d) r += t.h - whole_rows;
    } else {
      const int g = f - whole;
      r = g / side;
      c = g - r * side;
      r += t.d;
      if (c >= t.d && side < t.w) c += t.w - 2 * t.d;
    }
    __stcg(plane + (t.i0 + r) * n + (t.j0 + c),
           src[(t.d + r) * t.sx + t.pad + t.d + c]);
  }
}

// The frame's cells inside the grid, from the exchange plane (read at L2)
// into src: the first and last d rows of the framed tile whole, d cells
// each side elsewhere. Each thread issues kBatch loads before it stores
// any, so a block waits about one L2 round trip, not one per cell; then
// the block synchronises.
__device__ __forceinline__ void heat_a_frame_in(float* src,
                                                const HeatATile& t,
                                                const float* plane, int m,
                                                int n) {
  constexpr int kBatch = 4;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int rows = 2 * t.d * t.sw;
  const int cells = rows + 2 * t.d * t.h;
  for (int f0 = tid; f0 < cells; f0 += kBatch * threads) {
    float v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int f = f0 + q * threads;
      int r, c;
      if (f < rows) {
        r = f / t.sw;
        c = f - r * t.sw;
        if (r >= t.d) r += t.h;
      } else {
        const int g = f - rows;
        r = g / (2 * t.d);
        c = g - r * 2 * t.d;
        r += t.d;
        if (c >= t.d) c += t.w;
      }
      const int gi = t.gy0 + r, gj = t.gx0 + c;
      const bool in = f < cells && gi >= 0 && gi < m && gj >= 0 && gj < n;
      at[q] = in ? r * t.sx + t.pad + c : -1;
      v[q] = in ? __ldcg(plane + gi * n + gj) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (at[q] >= 0) src[at[q]] = v[q];
  }
  __syncthreads();
}

// K steps of the tile t, loaded into src (dst the other buffer), in
// groups of at most t.d steps; `exchange(src, group)`, which every thread
// calls after each group but the last, refills src's frame. The last step
// writes the tile's cells to the m x n grid `out` (16 bytes a group where
// the address allows it) and folds their residual's bit pattern into
// rmax. Every thread of the block must call it. kLoop is the tile loop's
// variant (kHeatLoopFull but in the neighbour-form probe); Tout and kRound
// its storage precision (heat_temporal.cuh).
template <int kProbe, int kLoop = kHeatLoopFull, typename Tout = float,
          bool kRound = false, class Exchange>
__device__ __forceinline__ void heat_a_steps(
    float* src, float* dst, const HeatATile& t, int m, int n, int k,
    typename HeatSame<Tout>::type* __restrict__ out, float a0, float cx,
    float cy, uint32_t& rmax, Exchange exchange) {
  constexpr int kVar = kProbe == kHeatACopyStep ? kHeatLoopCopyStep : kLoop;
  // The grid's interior in tile coordinates, this warp's run of rows,
  // and whether the framed tile reaches past the interior (uniform
  // across the block), as heat_tile_steps works them out.
  const int r_lo = heat_clamp_local(1 - t.gy0, 0, t.sh);
  const int r_hi = heat_clamp_local(m - 2 - t.gy0, -1, t.sh - 1);
  const int c_lo = heat_clamp_local(1 - t.gx0, 0, t.sw);
  const int c_hi = heat_clamp_local(n - 2 - t.gx0, -1, t.sw - 1);
  const int run = (t.sh + blockDim.y - 1) / blockDim.y;
  const int t_r0 = threadIdx.y * run;
  const int t_r1 = min(t_r0 + run, t.sh);
  const bool edge =
      kProbe != kHeatANoEdge &&
      (r_lo > 0 || r_hi < t.sh - 1 || c_lo > 0 || c_hi < t.sw - 1);
  const int64_t base = static_cast<int64_t>(t.gy0) * n + t.gx0;
  const bool vec_out = heat_vec_out(out, n, base, t.pad);
  for (int done = 0, group = 0;; ++group) {
    const int j = min(t.d, k - done);
    for (int s = 1; s <= j; ++s) {
      const int e = t.d - (j - s);
      if (done + s == k) {
        heat_rows_any<true, kVar, Tout, kRound>(
            edge, src, nullptr, out, t.sx, t.pad, base, n, vec_out,
            max(t_r0, t.d), min(t_r1, t.d + t.h), (t.pad + t.d) / 4,
            (t.pad + t.d + t.w + 3) / 4, t.d + t.w, r_lo, r_hi, c_lo, c_hi,
            a0, cx, cy, rmax);
      } else {
        heat_rows_any<false, kVar, Tout, kRound>(
            edge, src, dst, nullptr, t.sx, t.pad, 0, 0, false, max(t_r0, e),
            min(t_r1, t.sh - e), (t.pad + e) / 4,
            (t.pad + t.sw - e + 3) / 4, 0, r_lo, r_hi, c_lo, c_hi, a0, cx,
            cy, rmax);
        __syncthreads();
        float* tmp = src;
        src = dst;
        dst = tmp;
      }
    }
    done += j;
    if (done == k) return;
    exchange(src, group);
  }
}

// Kernel A: one cooperative block per tile of the m x n grid, all
// resident at once (heat_a_resident.cu has the design). After each group
// of steps but the last, a block writes its band to the group's plane of
// `xch` (two m x n planes), the grid synchronises (cooperative_groups
// grid.sync(), which also orders the writes), and each block reads its
// frame back. The planes alternate by group, so one barrier a group is
// enough: a plane is rewritten two groups later, after every block has
// passed the barrier that ends its reads. heat_a_block is a block's work;
// the kernels below are its instances. T is the grid's storage type: a
// bfloat16 grid rounds every level (heat_a_resident_bf16).
template <int kProbe, int kLoop = kHeatLoopFull, typename T = float>
__device__ __forceinline__ void heat_a_block(
    const T* __restrict__ u, T* __restrict__ out, float* xch,
    uint32_t* res, int m, int n, int n_col_tiles, int k, int depth,
    int tile_y, int tile_x, float a0, float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  const HeatATile t = heat_a_tile(m, n, static_cast<int>(blockIdx.x),
                                  n_col_tiles, tile_y, tile_x, depth);
  float* const src = smem;
  float* const dst = smem + (tile_y + 2 * depth) * t.sx;
  heat_a_load(u, src, t, m, n);
  uint32_t rmax = 0u;
  heat_a_steps<kProbe, kLoop, T, !std::is_same<T, float>::value>(
      src, dst, t, m, n, k, out, a0, cx, cy, rmax,
      [&](float* s, int group) {
        float* plane = xch + (group & 1) * (m * n);
        if (kProbe != kHeatANoExchange) heat_a_band_out(s, t, plane, n);
        if (kProbe != kHeatANoBarrier) cg::this_grid().sync();
        if (kProbe != kHeatANoExchange)
          heat_a_frame_in(s, t, plane, m, n);
        else
          __syncthreads();
      });
  if (res != nullptr) heat_block_max(rmax, res);
}

// Kernel A (anatomy variant kProbe).
template <int kProbe>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_a_resident_kernel(const float* __restrict__ u, float* __restrict__ out,
                       float* xch, uint32_t* res, int m, int n,
                       int n_col_tiles, int k, int depth, int tile_y,
                       int tile_x, float a0, float cx, float cy) {
  heat_a_block<kProbe>(u, out, xch, res, m, n, n_col_tiles, k, depth, tile_y,
                       tile_x, a0, cx, cy);
}

// Kernel A on a bfloat16 grid: every level rounded to bfloat16, the
// buffers and planes float32 (the storage precision above). A template,
// so that only a library that launches it compiles it.
template <typename T>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_a_resident_bf16_kernel(const T* __restrict__ u, T* __restrict__ out,
                            float* xch, uint32_t* res, int m, int n,
                            int n_col_tiles, int k, int depth, int tile_y,
                            int tile_x, float a0, float cx, float cy) {
  heat_a_block<kHeatAFull, kHeatLoopFull, T>(u, out, xch, res, m, n,
                                             n_col_tiles, k, depth, tile_y,
                                             tile_x, a0, cx, cy);
}

// Kernel A on the tile loop's variant kLoop (a neighbour form): a kernel
// of its own, so that A's instances keep their names and machine code.
template <int kLoop>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_a_loop_kernel(const float* __restrict__ u, float* __restrict__ out,
                   float* xch, uint32_t* res, int m, int n, int n_col_tiles,
                   int k, int depth, int tile_y, int tile_x, float a0,
                   float cx, float cy) {
  heat_a_block<kHeatAFull, kLoop>(u, out, xch, res, m, n, n_col_tiles, k,
                                  depth, tile_y, tile_x, a0, cx, cy);
}

// Kernel A's launch (variant kProbe; with kLoop other than kHeatLoopFull,
// heat_a_loop_kernel<kLoop>; with T bfloat16, heat_a_resident_bf16_kernel,
// kProbe and kLoop the full ones): K steps of the m x n grid
// `u` into `out` (distinct buffers, both on the current device) in one
// cooperative launch of one block of block_x x block_y threads per
// tile_y x tile_x tile, exchanging a `depth`-deep halo every `depth`
// steps. `xch` is scratch of 2 * m * n floats for the exchange (unused,
// and may be null, when k <= depth). With `res` non-null, the last
// step's residual bit pattern lands in *res. Launches on `stream` and
// does not synchronise. Returns a cudaError_t: 0, or the reason the
// launch was refused (cudaErrorCooperativeLaunchTooLarge when the blocks
// do not all fit on the card at once).
template <int kProbe, int kLoop = kHeatLoopFull, typename T = float>
inline int heat_a_launch(const T* u, T* out, float* xch,
                         uint32_t* res, int64_t m, int64_t n, int k,
                         int depth, int tile_y, int tile_x, int block_x,
                         int block_y, float a0, float cx, float cy,
                         void* stream) {
  if (m < 3 || n < 3 || k < 1 || depth < 1 ||
      !heat_a_takes(n, tile_y, tile_x, block_x, block_y) ||
      2 * m * n > 0x7fffffffLL || (k > depth && xch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int n_col_tiles = static_cast<int>((n + tile_x - 1) / tile_x);
  const int64_t blocks = n_col_tiles * ((m + tile_y - 1) / tile_y);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = heat_loop_smem_bytes(depth, tile_y, tile_x);
  const void* kernel;
  static_assert(std::is_same<T, float>::value ||
                    (kProbe == kHeatAFull && kLoop == kHeatLoopFull),
                "kernel A's bfloat16 form is the full kernel");
  if constexpr (!std::is_same<T, float>::value)
    kernel = reinterpret_cast<const void*>(heat_a_resident_bf16_kernel<T>);
  else if constexpr (kLoop == kHeatLoopFull)
    kernel = reinterpret_cast<const void*>(heat_a_resident_kernel<kProbe>);
  else
    kernel = reinterpret_cast<const void*>(heat_a_loop_kernel<kLoop>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int mi = static_cast<int>(m), ni = static_cast<int>(n);
  void* args[] = {&u, &out,   &xch,    &res,    &mi, &ni, &n_col_tiles,
                  &k, &depth, &tile_y, &tile_x, &a0, &cx, &cy};
  err = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(block_x, block_y),
      args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
