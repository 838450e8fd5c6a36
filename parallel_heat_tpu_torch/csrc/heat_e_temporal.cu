// heat_e_temporal — K Jacobi steps per pass through global memory
// (temporal blocking), with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_temporal_strip
// (pallas_call name "heat_e_temporal_strip", defined at :607, call :774) in
// its storage-dtype form, with and without the residual. The acc_f32
// variant (f32 carry across the K steps) is not ported yet.
//
// Bound on the H100: a pass reads the grid once and writes it once for
// K steps, plus the halo: about 8*(1+2K/TY)*(1+2K/TX)/K bytes per
// cell-step through HBM (1.33 B at the default 96 x 112 tile and K = 8,
// against heat_b_step's 8 B). Below that lies instruction issue: 7
// float32 operations per cell-step, which the bitwise contract keeps
// from fusing into FMAs, three shared-memory loads and one store, plus
// the redundant halo steps (about 14% more cells at the default tile and
// K). As compiled for sm_90a the step loop of an interior block issues
// about 15 instructions per cell-step, and the issue rate and the
// shared-memory pipe, not HBM, set the kernel's time (PERF.md).
//
// Design (the load is here; the step phase, shared with
// heat_e_uni_temporal.cu, is in heat_temporal.cuh): the TPU kernel
// streams full-width row strips with K-deep row halos through VMEM.
// Hopper's shared memory is 227 KB per block, and one 16384-wide
// float32 row is already 64 KB, so this kernel cuts 2D tiles instead:
//   - each block loads a TY x TX output tile plus a K-deep halo on all
//     four sides into shared memory with asynchronous copies (cp.async),
//     so all of a thread's loads are in flight at once; cells outside the
//     grid load as 0. They never reach the interior: the Dirichlet ring
//     lies between, and it never updates;
//   - it runs K steps, ping-ponging between two shared buffers; step s
//     updates the region s cells in from the loaded edge, so the valid
//     region shrinks by one cell per side and step, and after K steps
//     exactly the central tile is valid;
//   - each thread walks a run of consecutive rows of one column and
//     keeps the cells above and below in registers, so a cell-step costs
//     three shared-memory loads (down, left, right) and one store; the
//     32 lanes of a warp take 32 neighbouring columns, which is free of
//     bank conflicts;
//   - where the grid's interior lies in the tile is worked out once per
//     block in the tile's own int coordinates; a block whose tile lies
//     inside the interior, nearly every block of a large grid, runs a
//     step loop with no test at all, and only the blocks at the grid's
//     edge select between update and copy;
//   - global boundary cells (and cells outside the grid) are copied,
//     never recomputed, so they keep their value at every step; the
//     intermediate steps round to float32 like a launch of heat_b_step
//     does, which makes E(K) bitwise K steps of B;
//   - the last step writes only the central tile, straight to global
//     memory, and reduces its residual as heat_b_step does.
// The tile shape and K come from ops/hopper_params.py: two ping-pong
// buffers of (TY+2K) x (TX+2K) floats, sized so that two blocks stay
// resident per SM. Global offsets are computed in int64.

#include "heat_temporal.cuh"

__global__ void __launch_bounds__(1024)
heat_e_temporal_kernel(const float* __restrict__ u, float* __restrict__ out,
                       uint32_t* res, int64_t m, int64_t n,
                       int64_t n_col_tiles, int k, int tile_y, int tile_x,
                       float a0, float cx, float cy) {
  extern __shared__ float smem[];
  const int sy = tile_y + 2 * k;
  const int sx = tile_x + 2 * k;
  float* src = smem;
  float* dst = smem + sy * sx;
  // Global coordinates of shared cell (0, 0).
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;

  for (int r = threadIdx.y; r < sy; r += blockDim.y) {
    const int64_t gi = gy0 + r;
    const bool row_in = gi >= 0 && gi < m;
    for (int c = threadIdx.x; c < sx; c += blockDim.x) {
      const int64_t gj = gx0 + c;
      // An asynchronous copy (cp.async); outside the grid it reads
      // nothing and zero-fills the cell.
      const bool in = row_in && gj >= 0 && gj < n;
      __pipeline_memcpy_async(src + r * sx + c, in ? u + gi * n + gj : u, 4,
                              in ? 0 : 4);
    }
  }
  __pipeline_commit();

  heat_e_steps(src, dst, sx, sy, sx, gy0, gx0, m, n, k, tile_y, tile_x, a0,
               cx, cy, out, res);
}

// K steps of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device). With `res` non-null, the last step's
// residual bit pattern lands in *res; with null, no residual is
// reduced. Launches on `stream` and does not synchronise. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_e_temporal(const float* u, float* out, uint32_t* res,
                               int64_t m, int64_t n, int k, int tile_y,
                               int tile_x, int block_x, int block_y,
                               float a0, float cx, float cy, void* stream) {
  const int threads = block_x * block_y;
  if (m < 3 || n < 3 || k < 1 || tile_y < 1 || tile_x < 1 || block_x < 1 ||
      block_y < 1 || threads % 32 != 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_col_tiles = (n + tile_x - 1) / tile_x;
  const int64_t blocks = n_col_tiles * ((m + tile_y - 1) / tile_y);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(tile_y + 2 * k) *
                      static_cast<size_t>(tile_x + 2 * k);
  cudaError_t err = cudaFuncSetAttribute(
      heat_e_temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  heat_e_temporal_kernel<<<static_cast<unsigned>(blocks),
                           dim3(block_x, block_y), smem, s>>>(
      u, out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_e_temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
