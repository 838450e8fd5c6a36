// heat_g_block_circular — K Jacobi steps on one block of a sharded 2D
// grid, from a caller-assembled extended block in the circular column
// layout, with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_circular (pallas_call name
// "heat_g_block_circular", defined at :1343, call :1476), in its float32
// and bfloat16 storage forms (heat_g_block_circular_bf16).
//
// Bound on the H100, and the design: heat_g.cuh. The caller writes the
// (bx+2K) x (by+2K) block [halo_n ; u | hi | lo ; halo_s] to HBM first,
// one more full-block copy per round than the fused form: the TPU layout
// exists to keep every piece lane-aligned, which Hopper's 4-byte
// cp.async does not need. The solver takes this kernel only when it is
// pinned (tune site block_temporal_2d).

#include "heat_g.cuh"

__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_block_circular_kernel(HEAT_G_PARAMS) {
  heat_g_tile<kHeatGCircular, false>(HEAT_G_ARGS);
}

// K steps of block (row_off, col_off), bx x by, of the m x n grid, read
// from `ext` ((bx+2K) x (by+2K), circular columns), into `out` (bx x by).
// With `res` non-null the block's residual lands in *res. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_g_block_circular(
    const float* ext, float* out, uint32_t* res, int64_t m, int64_t n,
    int64_t bx, int64_t by, int64_t row_off, int64_t col_off, int k,
    int tile_y, int tile_x, int block_x, int block_y, float a0, float cx,
    float cy, void* stream) {
  return heat_g_launch(
      heat_g_block_circular_kernel, false, ext, nullptr, nullptr, nullptr, out,
      res, m, n, bx, by, row_off, col_off, k, 0, 0, bx, 1, tile_y, tile_x,
      block_x, block_y, a0, cx, cy, stream);
}

// The bfloat16 form (the builder's dtype_name="bfloat16"): bfloat16 in
// and out, every level rounded (heat_g.cuh heat_g_tile_bf16).
__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_block_circular_bf16_kernel(HEAT_G_PARAMS_OF(__nv_bfloat16)) {
  heat_g_tile_bf16<kHeatGCircular, false>(HEAT_G_ARGS);
}

// heat_g_block_circular on bfloat16 buffers: `ext` and `out` bfloat16, the
// residual float32. Returns a cudaError_t.
extern "C" int heat_g_block_circular_bf16(
    const void* ext, void* out, uint32_t* res, int64_t m, int64_t n,
    int64_t bx, int64_t by, int64_t row_off, int64_t col_off, int k,
    int tile_y, int tile_x, int block_x, int block_y, float a0, float cx,
    float cy, void* stream) {
  return heat_g_launch(
      heat_g_block_circular_bf16_kernel, false,
      static_cast<const __nv_bfloat16*>(ext), nullptr, nullptr, nullptr,
      static_cast<__nv_bfloat16*>(out), res, m, n, bx, by, row_off, col_off,
      k, 0, 0, bx, 1, tile_y, tile_x, block_x, block_y, a0, cx, cy, stream);
}

extern "C" const char* heat_g_block_circular_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
