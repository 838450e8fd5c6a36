// heat_i_tile_temporal — K Jacobi steps per pass through global memory
// over column bands streamed down the grid, with the residual of the
// last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_tile_temporal_2d
// (pallas_call name "heat_i_tile_temporal", defined at :3294, call :3419)
// in its storage-dtype form. The acc_f32 variant is not ported yet.
//
// Bound on the H100: a pass reads the grid once and writes it once for K
// steps, plus the column halo and the rows recomputed where a segment
// starts: about 8*(1+2K/TX)*(1+2K/L)/K bytes per cell-step through HBM
// for bands of TX columns and segments of L rows. Below that lies
// instruction issue: 7 float32 operations per cell-step, two neighbour
// reads and one write in shared memory, on (1+2K/TX)(1+2K/L) cells per
// output cell.
//
// Design: the TPU kernel runs kernel E's K-step sweeps under kernel C's
// two-axis windows, (T, CW) tiles with row and column margins, so that a
// grid too wide for E's full-width strips still gets K steps per fetch.
// On the card heat_e_temporal already cuts 2D tiles with K-deep margins
// on all four sides, so this kernel takes the other way to window both
// axes: bands of columns with K-deep column margins, each streamed down
// its rows with every level of the K steps in flight at once, so that no
// row margin is recomputed except where a segment starts
// (heat_band.cuh has the scheme).

#include "heat_band.cuh"

template <int K>
__global__ void __launch_bounds__(256)
heat_i_tile_temporal_kernel(const float* __restrict__ u,
                            float* __restrict__ out, uint32_t* res, int64_t m,
                            int64_t n, int64_t n_bands, int tile_x,
                            int seg_rows, float a0, float cx, float cy) {
  heat_band_run<K, false>(u, out, res, m, n, n_bands, tile_x, seg_rows, a0,
                          cx, cy);
}

static const HeatBandKernel kHeatIKernels[8] = {
    heat_i_tile_temporal_kernel<1>, heat_i_tile_temporal_kernel<2>,
    heat_i_tile_temporal_kernel<3>, heat_i_tile_temporal_kernel<4>,
    heat_i_tile_temporal_kernel<5>, heat_i_tile_temporal_kernel<6>,
    heat_i_tile_temporal_kernel<7>, heat_i_tile_temporal_kernel<8>};

// K steps of `u` into `out` as heat_band_launch says (heat_band.cuh).
extern "C" int heat_i_tile_temporal(const float* u, float* out, uint32_t* res,
                                    int64_t m, int64_t n, int k, int tile_x,
                                    int seg_rows, int block_x, float a0,
                                    float cx, float cy, void* stream) {
  return heat_band_launch(kHeatIKernels, u, out, res, m, n, k, tile_x,
                          seg_rows, block_x, a0, cx, cy, stream);
}

extern "C" const char* heat_i_tile_temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
