// heat_g_band_fix — the band pass of the overlapped sharded round: the
// K-step values of a block's first and last K rows, from the block, its
// tail and the halo rows, with the residual of exactly those rows.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_band_fix_2d
// (pallas_call name "heat_g_band_fix_2d", defined at :2093, call :2231).
//
// Bound on the H100, and the design: heat_g.cuh. One launch of two row
// regions (blockIdx.y): tiles of K x TX output cells whose framed
// (3K) x (TX+2K) windows read the halo rows, the block's edge rows and
// the tail, with the fused form's per-cell load and the family's
// register-blocked step loop (a 256-column window row is two passes of
// 32 groups). The rows land in the deferred bulk's output buffer in
// place (the TPU kernel returns them and the caller splices them in), so
// no splice copy is needed. 2K of bx rows: under 0.1% of a 16384-row block's cells, in
// 2 x 35 blocks at the default 240-column tiles (ops/hopper_params.py),
// one wave, so its time is close to a launch's.

#include "heat_g.cuh"

__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_band_fix_kernel(HEAT_G_PARAMS) {
  heat_g_tile<kHeatGFused, false>(HEAT_G_ARGS);
}

// Rows [0, K) and [bx-K, bx) of K steps of the bx x by block `u` at
// (row_off, col_off) of the m x n grid, written into `out` (bx x by) in
// place; bx must be at least 2K. With `res` non-null their residual
// lands in *res. Returns a cudaError_t: 0, or the reason the launch was
// refused.
extern "C" int heat_g_band_fix(const float* u, const float* tail,
                               const float* halo_n, const float* halo_s,
                               float* out, uint32_t* res, int64_t m,
                               int64_t n, int64_t bx, int64_t by,
                               int64_t row_off, int64_t col_off, int k,
                               int tile_x, int block_x, int block_y,
                               float a0, float cx, float cy, void* stream) {
  if (halo_n == nullptr || halo_s == nullptr || bx < 2 * k)
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_g_launch(
      heat_g_band_fix_kernel, false, u, tail, halo_n, halo_s, out, res, m, n,
      bx, by, row_off, col_off, k, 0, bx - k, k, 2, k, tile_x, block_x, block_y,
      a0, cx, cy, stream);
}

extern "C" const char* heat_g_band_fix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
