// heat_i_tile_temporal — K Jacobi steps per pass through global memory
// over column bands streamed down the grid, with the residual of the
// last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_tile_temporal_2d
// (pallas_call name "heat_i_tile_temporal", defined at :3294, call :3419)
// in its float32 form; its bfloat16 forms, storage and acc_f32, are
// heat_i_tile_temporal_bf16.cu.
//
// Bound on the H100: a pass reads the grid once and writes it once for K
// steps, plus the column margin and the rows recomputed where a segment
// starts: about 8*(128/TX)*(1+2K/L)/K bytes per cell-step through HBM for
// bands of TX output columns and segments of L rows. Below that lies
// instruction issue: 7 float32 operations per cell-step and half a
// shuffle, on (128/TX)(1+2K/L) cells per output cell.
//
// Design: the TPU kernel runs kernel E's K-step sweeps under kernel C's
// two-axis windows, (T, CW) tiles with row and column margins, so that a
// grid too wide for E's full-width strips still gets K steps per fetch.
// On the card heat_e_temporal already cuts 2D tiles with K-deep margins
// on all four sides, so this kernel takes the other way to window both
// axes: bands of 128 columns with column margins, each streamed down its
// rows by one warp with every level of the K steps in flight at once in
// the lanes' registers, so that no row margin is recomputed except where
// a segment starts (heat_i_loop.cuh has the scheme). Its rows reach
// shared memory by cp.async, each lane copying its own 4 cells (16 bytes
// at once where they lie inside the grid on a 16-byte boundary), so that
// it takes a grid of any width.

#include "heat_i_loop.cuh"

template <int K>
__global__ void __launch_bounds__(kIMaxThreads, 2)
heat_i_tile_temporal_kernel(const __grid_constant__ HeatIArgs args,
                            const __grid_constant__ CUtensorMap map) {
  heat_i_block<K, false>(args, &map);
}

static const HeatIKernel kHeatIKernels[kIMaxK] = {
    heat_i_tile_temporal_kernel<1>,
    heat_i_tile_temporal_kernel<2>,
    heat_i_tile_temporal_kernel<3>,
    heat_i_tile_temporal_kernel<4>,
    heat_i_tile_temporal_kernel<5>,
    heat_i_tile_temporal_kernel<6>,
    heat_i_tile_temporal_kernel<7>,
    heat_i_tile_temporal_kernel<8>};

// K steps of `u` into `out` as heat_i_launch says (heat_i_loop.cuh).
extern "C" int heat_i_tile_temporal(const float* u, float* out, uint32_t* res,
                                    int64_t m, int64_t n, int k,
                                    int64_t seg_rows, int warps, int rows,
                                    int stages, float a0, float cx, float cy,
                                    void* stream) {
  return heat_i_launch<false>(kHeatIKernels, u, out, res, m, n, k, seg_rows,
                              warps, rows, stages, a0, cx, cy, stream);
}

// Thread blocks of the kernel of depth k that one SM holds at once, into
// *blocks (heat_i_occupancy). Returns a cudaError_t.
extern "C" int heat_i_tile_temporal_occupancy(int k, int warps, int rows,
                                              int stages, int* blocks) {
  return heat_i_occupancy(kHeatIKernels, k, warps, rows, stages, blocks);
}

extern "C" const char* heat_i_tile_temporal_error_string(int code) {
  return heat_tma_error_string(code);
}
