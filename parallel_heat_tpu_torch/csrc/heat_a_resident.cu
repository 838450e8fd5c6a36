// heat_a_resident — K Jacobi steps in one launch, with the whole grid
// resident in shared memory across the card, and the residual of the
// last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_vmem_multistep
// (pallas_call name "heat_a_vmem_multistep", defined at :117, call :219).
//
// Bound on the H100: a launch reads the grid once and writes it once for
// all K steps, 8 B per cell over HBM, plus the halo exchange through L2.
// The arithmetic is 7 float32 operations per cell-step. At the sizes
// this kernel takes (a grid that fits in the card's shared memory, up to
// about 3.4 M cells) neither is what holds it: a step of 1000^2 is 7 M
// operations, about 0.1 us of the card's float32 rate. What costs is the
// grid-wide barrier, a few microseconds, and the issue of each thread's
// few cells per step.
//
// Design: the TPU kernel keeps the whole double-buffered grid in one
// core's 128 MiB of VMEM and loops K steps with no trip to HBM. An H100
// has 227 KB of shared memory per block, but 132 SMs of it, about 30 MB
// in all, so:
//   - the launch is cooperative: one block of 32 x 32 threads on each SM
//     it uses, all resident at once, each owning one tile of the grid
//     (ops/hopper_params.py picks the tile so that the blocks cover the
//     grid and fit on the card, or declines);
//   - a block keeps its tile and a D-deep frame around it in two shared
//     buffers and ping-pongs between them for K steps, so the grid is
//     read from HBM once and written once per launch;
//   - the steps run in groups of D. Within a group the frame's valid
//     region shrinks by one cell per side and step, as in heat_e_temporal,
//     and only the region the tile still needs is updated, by the
//     column walk of heat_temporal.cuh (heat_e_tile_step: a run of rows
//     per thread with the rows above and below in registers, no test in
//     a block whose framed tile lies inside the interior). After each
//     group but the last, a block writes its tile's D-deep edge band to a
//     global exchange plane, the whole grid synchronises
//     (cooperative_groups grid.sync(), which also orders the writes), and
//     each block reads its frame back from the neighbours' bands. So the
//     grid-wide barrier comes once per D steps, for some redundant work
//     on the frame. The planes alternate by group, so one barrier per
//     group is enough: a plane is rewritten two groups later, after every
//     block has passed the barrier that ends its reads. The plane is read
//     and written at L2 (__ldcg/__stcg), never through a stale L1 line;
//   - the last step writes the tile straight to the output grid and
//     reduces the residual as heat_b_step does (heat_common.cuh);
//   - global boundary cells are copied, never recomputed, and every
//     step rounds to float32 like a launch of heat_b_step, which makes a
//     launch of K steps bitwise K launches of B.
// The grid is at most a few million cells, so indices are int32; the
// entry point refuses a grid whose two exchange planes pass 2^31 cells.

#include <cooperative_groups.h>

#include "heat_temporal.cuh"

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024, 1)
heat_a_resident_kernel(const float* __restrict__ u, float* __restrict__ out,
                       float* xch, uint32_t* res, int m, int n,
                       int n_col_tiles, int k, int depth, int tile_y,
                       int tile_x, float a0, float cx, float cy) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int d = depth;
  const int sx = tile_x + 2 * d;
  float* src = smem;
  float* dst = smem + (tile_y + 2 * d) * sx;
  // The tile, cut at the grid's edge to h x w, sits at shared cell
  // (d, d) inside a d-deep frame; shared cell (0, 0) is global cell
  // (gy0, gx0).
  const int i0 = static_cast<int>(blockIdx.x / n_col_tiles) * tile_y;
  const int j0 = static_cast<int>(blockIdx.x % n_col_tiles) * tile_x;
  const int h = min(tile_y, m - i0);
  const int w = min(tile_x, n - j0);
  const int gy0 = i0 - d, gx0 = j0 - d;
  const int sh = h + 2 * d, sw = w + 2 * d;  // the framed tile

  // The grid's interior in tile coordinates, this thread's run of rows,
  // and whether the framed tile reaches past the interior (uniform
  // across the block), as heat_e_steps works them out.
  const int r_lo = heat_clamp_local(1 - gy0, 0, sh);
  const int r_hi = heat_clamp_local(m - 2 - gy0, -1, sh - 1);
  const int c_lo = heat_clamp_local(1 - gx0, 0, sw);
  const int c_hi = heat_clamp_local(n - 2 - gx0, -1, sw - 1);
  const int run = (sh + blockDim.y - 1) / blockDim.y;
  const int t_r0 = threadIdx.y * run;
  const int t_r1 = min(t_r0 + run, sh);
  const bool edge = r_lo > 0 || r_hi < sh - 1 || c_lo > 0 || c_hi < sw - 1;
  const int64_t base = static_cast<int64_t>(gy0) * n + gx0;

  // The framed tile; cells outside the grid are 0, and stay 0 (they are
  // copied, never updated), in both buffers.
  for (int r = threadIdx.y; r < sh; r += blockDim.y) {
    const int gi = gy0 + r;
    for (int c = threadIdx.x; c < sw; c += blockDim.x) {
      const int gj = gx0 + c;
      const bool in = gi >= 0 && gi < m && gj >= 0 && gj < n;
      src[r * sx + c] = in ? u[gi * n + gj] : 0.f;
      dst[r * sx + c] = 0.f;
    }
  }
  __syncthreads();

  uint32_t rmax = 0u;
  for (int done = 0, group = 0;; ++group) {
    // A group of j <= d steps from a frame of depth d. Step s updates the
    // region j - s cells around the tile, which the frame's shrinking
    // valid region (s cells in from its edge) always contains, so the
    // tile is exact after the group. The steps are the column walk of
    // heat_temporal.cuh (heat_e_tile_step).
    const int j = min(d, k - done);
    for (int s = 1; s <= j; ++s) {
      const int e = d - (j - s);
      if (done + s == k) {
        heat_e_tile_step_any<true>(edge, src, out, sx, base, n, max(t_r0, d),
                                   min(t_r1, d + h), d, d + w, r_lo, r_hi,
                                   c_lo, c_hi, a0, cx, cy, &rmax);
      } else {
        heat_e_tile_step_any<false>(edge, src, dst, sx, 0, sx, max(t_r0, e),
                                    min(t_r1, sh - e), e, sw - e, r_lo, r_hi,
                                    c_lo, c_hi, a0, cx, cy, nullptr);
        __syncthreads();
        float* t = src;
        src = dst;
        dst = t;
      }
    }
    done += j;
    if (done == k) break;
    // Exchange: the tile's d-deep edge band goes to this group's plane;
    // after the barrier, the frame comes back from the neighbours' bands.
    // A row of the band is whole in its first and last d rows (and in a
    // tile at most 2d wide), and its first and last d cells elsewhere;
    // likewise the frame.
    float* plane = xch + (group & 1) * (m * n);
    for (int r = threadIdx.y; r < h; r += blockDim.y) {
      const bool whole = r < d || r >= h - d || w <= 2 * d;
      const int cells = whole ? w : 2 * d;
      for (int e = threadIdx.x; e < cells; e += blockDim.x) {
        const int c = whole || e < d ? e : w - 2 * d + e;
        __stcg(plane + (i0 + r) * n + (j0 + c), src[(r + d) * sx + c + d]);
      }
    }
    grid.sync();
    for (int r = threadIdx.y; r < sh; r += blockDim.y) {
      const int gi = gy0 + r;
      if (gi < 0 || gi >= m) continue;
      const bool whole = r < d || r >= d + h;
      const int cells = whole ? sw : 2 * d;
      for (int e = threadIdx.x; e < cells; e += blockDim.x) {
        const int c = whole || e < d ? e : w + e;
        const int gj = gx0 + c;
        if (gj >= 0 && gj < n) src[r * sx + c] = __ldcg(plane + gi * n + gj);
      }
    }
    __syncthreads();
  }
  if (res != nullptr) heat_block_max(rmax, res);
}

// K steps of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device) in one cooperative launch of one block per
// tile_y x tile_x tile, exchanging a `depth`-deep halo every `depth`
// steps. `xch` is scratch of 2 * m * n floats for the exchange (unused,
// and may be null, when k <= depth). With `res` non-null, the last
// step's residual bit pattern lands in *res. Launches on `stream` and
// does not synchronise. Returns a cudaError_t: 0, or the reason the
// launch was refused (cudaErrorCooperativeLaunchTooLarge when the blocks
// do not all fit on the card at once).
extern "C" int heat_a_resident(const float* u, float* out, float* xch,
                               uint32_t* res, int64_t m, int64_t n, int k,
                               int depth, int tile_y, int tile_x,
                               int block_x, int block_y, float a0, float cx,
                               float cy, void* stream) {
  const int threads = block_x * block_y;
  if (m < 3 || n < 3 || k < 1 || depth < 1 || tile_y < 1 || tile_x < 1 ||
      block_x < 1 || block_y < 1 || threads % 32 != 0 || threads > 1024 ||
      2 * m * n > 0x7fffffffLL || (k > depth && xch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int n_col_tiles = static_cast<int>((n + tile_x - 1) / tile_x);
  int blocks = n_col_tiles * static_cast<int>((m + tile_y - 1) / tile_y);
  const size_t smem = 2 * sizeof(float) *
                      static_cast<size_t>(tile_y + 2 * depth) *
                      static_cast<size_t>(tile_x + 2 * depth);
  cudaError_t err = cudaFuncSetAttribute(
      heat_a_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int mi = static_cast<int>(m), ni = static_cast<int>(n);
  void* args[] = {&u, &out,    &xch,    &res, &mi, &ni, &n_col_tiles,
                  &k, &depth, &tile_y, &tile_x, &a0, &cx, &cy};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(heat_a_resident_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(block_x, block_y), args, smem,
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_a_resident_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
