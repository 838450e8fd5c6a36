// heat_i_uni_tile_temporal — heat_i_tile_temporal with a uniform load:
// bitwise the same outputs.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_tile_temporal_2d_uniform (pallas_call name
// "heat_i_uni_tile_temporal", defined at :3456, call :3608) in its
// float32 form; its bfloat16 forms are heat_i_uni_tile_temporal_bf16.cu.
//
// Bound on the H100: heat_i_tile_temporal's (heat_i_loop.cuh), whose
// band stream it shares.
//
// Design: the TPU kernel fetches kernel I's windows in fixed-shape
// streams, conditional only at the grid's edges, so that its steady state
// has no branch. Here the grid's width is a multiple of 4 floats (the
// entry point refuses other grids), so a stage of a band's rows, `rows`
// rows of the band's 128 columns from grid column b TX - P (a multiple of
// 4), is a plain 2D box of the grid whose rows start on 16-byte
// boundaries: one lane of the warp asks for it from a tensor map of the
// grid (the Tensor Memory Accelerator, heat_tma.cuh) onto the stage's
// mbarrier, and no other lane issues a copy or computes an address.
// Cells outside the grid arrive as zeros, I's rule for them, so the bands
// and segments at the grid's edges take the same load, with no branch.
// The steps, the stores and the residual are I's, line for line.

#include <stdint.h>

#include "heat_i_loop.cuh"

template <int K>
__global__ void __launch_bounds__(kIMaxThreads, 2)
heat_i_uni_tile_temporal_kernel(const __grid_constant__ HeatIArgs args,
                                const __grid_constant__ CUtensorMap map) {
  heat_i_block<K, true>(args, &map);
}

static const HeatIKernel kHeatIUniKernels[kIMaxK] = {
    heat_i_uni_tile_temporal_kernel<1>,
    heat_i_uni_tile_temporal_kernel<2>,
    heat_i_uni_tile_temporal_kernel<3>,
    heat_i_uni_tile_temporal_kernel<4>,
    heat_i_uni_tile_temporal_kernel<5>,
    heat_i_uni_tile_temporal_kernel<6>,
    heat_i_uni_tile_temporal_kernel<7>,
    heat_i_uni_tile_temporal_kernel<8>};

// K steps of `u` into `out` as heat_i_launch says (heat_i_loop.cuh),
// each stage of rows one TMA box; the grid's width must be a multiple of
// 4 and `u` 16-byte aligned. Returns a cudaError_t, or a tensor-map
// encoding error (heat_i_uni_tile_temporal_error_string).
extern "C" int heat_i_uni_tile_temporal(const float* u, float* out,
                                        uint32_t* res, int64_t m, int64_t n,
                                        int k, int64_t seg_rows, int warps,
                                        int rows, int stages, float a0,
                                        float cx, float cy, void* stream) {
  return heat_i_launch<true>(kHeatIUniKernels, u, out, res, m, n, k,
                             seg_rows, warps, rows, stages, a0, cx, cy,
                             stream);
}

// Thread blocks of the kernel of depth k that one SM holds at once, into
// *blocks (heat_i_occupancy). Returns a cudaError_t.
extern "C" int heat_i_uni_tile_temporal_occupancy(int k, int warps, int rows,
                                                  int stages, int* blocks) {
  return heat_i_occupancy(kHeatIUniKernels, k, warps, rows, stages, blocks);
}

extern "C" const char* heat_i_uni_tile_temporal_error_string(int code) {
  return heat_tma_error_string(code);
}
