// heat_i_uni_tile_temporal — heat_i_tile_temporal with a uniform,
// vectorised load: bitwise the same outputs.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_tile_temporal_2d_uniform (pallas_call name
// "heat_i_uni_tile_temporal", defined at :3456, call :3608).
//
// Bound on the H100: heat_i_tile_temporal's (heat_band.cuh), whose step
// loop it shares.
//
// Design: the TPU kernel fetches kernel I's windows in fixed-shape
// streams, conditional only at the grid's edges, so that its steady state
// has no branch. Here a band row that lies wholly inside the grid, on a
// 16-byte boundary, is copied in 16-byte pieces by a quarter of the
// block's threads with no test (heat_band_load_row with kUniform); a
// row at the grid's edge, or of a band whose first column is not on a
// 16-byte boundary (the column margin K is not a multiple of 4), takes
// I's checked copy of one float per thread. The entry point needs a
// 16-byte aligned grid.

#include <stdint.h>

#include "heat_band.cuh"

template <int K>
__global__ void __launch_bounds__(256)
heat_i_uni_tile_temporal_kernel(const float* __restrict__ u,
                                float* __restrict__ out, uint32_t* res,
                                int64_t m, int64_t n, int64_t n_bands,
                                int tile_x, int seg_rows, float a0, float cx,
                                float cy) {
  heat_band_run<K, true>(u, out, res, m, n, n_bands, tile_x, seg_rows, a0,
                         cx, cy);
}

static const HeatBandKernel kHeatIUniKernels[8] = {
    heat_i_uni_tile_temporal_kernel<1>, heat_i_uni_tile_temporal_kernel<2>,
    heat_i_uni_tile_temporal_kernel<3>, heat_i_uni_tile_temporal_kernel<4>,
    heat_i_uni_tile_temporal_kernel<5>, heat_i_uni_tile_temporal_kernel<6>,
    heat_i_uni_tile_temporal_kernel<7>, heat_i_uni_tile_temporal_kernel<8>};

// K steps of `u` into `out` as heat_band_launch says (heat_band.cuh);
// `u` must be 16-byte aligned.
extern "C" int heat_i_uni_tile_temporal(const float* u, float* out,
                                        uint32_t* res, int64_t m, int64_t n,
                                        int k, int tile_x, int seg_rows,
                                        int block_x, float a0, float cx,
                                        float cy, void* stream) {
  if (reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_band_launch(kHeatIUniKernels, u, out, res, m, n, k, tile_x,
                          seg_rows, block_x, a0, cx, cy, stream);
}

extern "C" const char* heat_i_uni_tile_temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
