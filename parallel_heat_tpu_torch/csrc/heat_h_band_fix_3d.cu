// heat_h_band_fix_3d — the band pass of the overlapped sharded 3D round:
// the K-step values of a block's first and last K x-planes, from the
// block, its tails and the x slabs, with the residual of exactly those
// planes.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_band_fix_3d
// (pallas_call name "heat_h_band_fix_3d", defined at :4934, call :5124).
//
// Bound on the H100, and the design: heat_h.cuh. One launch of two
// regions (blockIdx.y), each one segment of K output planes streamed
// from 3K input planes (xlo | u[0, 2K) and u[bx-2K, bx) | xhi), with the
// fused form's load and F's step phase, so the planes are bitwise the
// monolithic round's (the TPU kernel agrees with it only to f32 ulps:
// XLA may contract FMAs where every operation here is rounded). They
// land in the deferred bulk's output buffer in place (the TPU kernel
// returns them and the caller splices them in), so no splice copy is
// needed.

#include "heat_h.cuh"

template <int K, int R>
__global__ void __launch_bounds__(512)
    heat_h_band_fix_3d_kernel(HEAT_H_PARAMS) {
  heat_h_body<K, R>(HEAT_H_ARGS, nullptr);
}

static const HeatHKernel kHeatHBand[3][kHMaxK] =
    HEAT_H_TABLE(heat_h_band_fix_3d_kernel);

// Planes [0, k) and [bx-k, bx) of k steps of the bx x by x bz block `u`
// at (ox, oy, oz) of the nx x ny x nz grid, written into `out` in place;
// the pieces as for heat_h_block_3d_fused, x slabs required (hx = k) and
// bx >= 2k. With `res` non-null their residual lands in *res. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_h_band_fix_3d(
    const float* u, const float* ztail, const float* ytail, const float* xlo,
    const float* xhi, float* out, uint32_t* res, int64_t nx, int64_t ny,
    int64_t nz, int64_t bx, int64_t by, int64_t bz, int64_t ox, int64_t oy,
    int64_t oz, int hx, int hy, int hz, int k, int block_z, int block_y,
    int rows, float a0, float cx, float cy, float cz, void* stream) {
  if ((hz != 0) != (ztail != nullptr) || (hy != 0) != (ytail != nullptr) ||
      hx != k || xlo == nullptr || xhi == nullptr || bx < 2 * k)
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_h_launch(heat_h_pick(kHeatHBand, k, rows), false, u, ztail,
                       ytail, xlo, xhi, out, res, nx, ny, nz, bx, by, bz, ox,
                       oy, oz, hx, hy, hz, k, 0, bx - k, k, 2, block_z,
                       block_y, rows, k, a0, cx, cy, cz, stream);
}

extern "C" const char* heat_h_band_fix_3d_error_string(int code) {
  return heat_tma_error_string(code);
}
