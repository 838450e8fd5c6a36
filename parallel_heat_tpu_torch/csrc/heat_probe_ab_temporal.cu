// heat_probe_ab_temporal — how kernel E-uni pins the Dirichlet ring, A
// against B: E-uni's own launch in variants that differ only in how the
// tiles that reach past the grid's interior (edge tiles) keep the ring
// fixed. Interior tiles run the same code in every variant.
//
// Replaces: tools/ab_temporal.py::build (pallas_call name
// "heat_probe_ab_temporal", defined at :63, call :233), the TPU probe's
// batched A/B of kernel E's boundary forms. Its vzero and vzero2 zeroed
// the garbage bands that its DMA window left in scratch; E-uni's TMA box
// lands zeros outside the grid (heat_e_uni_temporal.cu), so no band is
// left to zero and neither is built.
//
// Bound on the H100: E-uni's (heat_e_uni_temporal.cu), per grid.
//
// Design: heat_e_uni.cuh compiles E-uni's block once per boundary form
// of the tile loop (heat_temporal.cuh heat_rows) and launches it exactly
// as heat_e_uni_temporal does:
//   - prod (kHeatLoopFull): as shipped: an edge tile tests each cell's
//     row and column and copies the cells outside the interior;
//   - vcoeff (kHeatLoopVCoeff): per-lane coefficient vectors (a0 -> 1,
//     cx and cy -> 0 on columns outside the interior) and the
//     coefficients (1, 0, 0) on rows outside it, one uniform branch a row
//     and no test a cell. A measurement only: 0 * inf poisons the ring of
//     a diverging grid, and -0.0 + 0 turns a -0.0 ring cell into +0.0;
//   - rowcopy (kHeatLoopRowCopy): columns by the coefficient vectors; the
//     ring rows are restored after every step from the step's source
//     buffer, which holds them as loaded, and copied in the last step by
//     a test a row. Bitwise prod on finite grids whose ring holds no
//     -0.0 (and whose interior stays finite).

#include "heat_e_uni.cuh"

// At least one block an SM (the second bound): without it ptxas cut a
// cheaper variant to 64 registers and spilled, to fit more blocks than the
// launch's shared memory lets run.
template <int kVar>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_ab_temporal_kernel(float* __restrict__ out, uint32_t* res,
                              int64_t m, int64_t n, int64_t n_col_tiles,
                              int k, int tile_y, int tile_x, float a0,
                              float cx, float cy,
                              const __grid_constant__ CUtensorMap umap) {
  heat_e_uni_tile<kVar>(out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0,
                        cx, cy, &umap);
}

// Boundary form `variant` (kHeatLoopFull, kHeatLoopVCoeff or
// kHeatLoopRowCopy) of E-uni's launch, with heat_e_uni_temporal's
// arguments after it. Returns a cudaError_t: 0, or the reason the launch
// was refused; or a tensor-map encoding error.
extern "C" int heat_probe_ab_temporal(int variant, const float* u,
                                      float* out, uint32_t* res, int64_t m,
                                      int64_t n, int k, int tile_y,
                                      int tile_x, int block_x, int block_y,
                                      float a0, float cx, float cy,
                                      void* stream) {
#define HEAT_PROBE_LAUNCH(V)                                                 \
  heat_e_uni_launch(heat_probe_ab_temporal_kernel<V>, u, out, res, m, n, k, \
                    tile_y, tile_x, block_x, block_y, a0, cx, cy, stream)
  switch (variant) {
    case kHeatLoopFull:
      return HEAT_PROBE_LAUNCH(kHeatLoopFull);
    case kHeatLoopVCoeff:
      return HEAT_PROBE_LAUNCH(kHeatLoopVCoeff);
    case kHeatLoopRowCopy:
      return HEAT_PROBE_LAUNCH(kHeatLoopRowCopy);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HEAT_PROBE_LAUNCH
}

extern "C" const char* heat_probe_ab_temporal_error_string(int code) {
  return heat_tma_error_string(code);
}
