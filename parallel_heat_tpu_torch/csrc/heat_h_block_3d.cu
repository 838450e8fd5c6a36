// heat_h_block_3d — K 7-point Jacobi steps on one block of a sharded 3D
// grid, read from the block assembled with its K-deep halo in one
// buffer, with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_3d (pallas_call name "heat_h_block_3d", defined
// at :4353, call :4539).
//
// Bound on the H100, and the design: heat_h.cuh. This form reads the
// circular block (x [lo | u | hi], y and z [u | hi | lo], a halo only on
// the sharded axes) that its caller assembles in HBM, one more read and
// write of the block a round than the fused form; it runs only when
// pinned (tune site block_temporal_3d, choice "H").

#include "heat_h.cuh"

template <int K, int R>
__global__ void __launch_bounds__(512)
    heat_h_block_3d_kernel(HEAT_H_PARAMS) {
  heat_h_body<K, R, kHeatHCircular>(HEAT_H_ARGS, nullptr);
}

static const HeatHKernel kHeatH[3][kHMaxK] =
    HEAT_H_TABLE(heat_h_block_3d_kernel);

// K steps of the bx x by x bz block at (ox, oy, oz) of the nx x ny x nz
// grid into `out` (bx x by x bz, distinct from ext), from `ext`, the
// (bx+2hx) x (by+2hy) x (bz+2hz) circular block; hx, hy, hz are each k
// (axis sharded) or 0 (the block spans the grid along it). Thread blocks
// of block_z x block_y threads, `rows` rows each, over segments of `seg`
// X planes. With `res` non-null the residual lands in *res. Launches on
// `stream` and does not synchronise. Returns a cudaError_t: 0, or the
// reason the launch was refused.
extern "C" int heat_h_block_3d(const float* ext, float* out, uint32_t* res,
                               int64_t nx, int64_t ny, int64_t nz,
                               int64_t bx, int64_t by, int64_t bz,
                               int64_t ox, int64_t oy, int64_t oz, int hx,
                               int hy, int hz, int k, int block_z,
                               int block_y, int rows, int64_t seg, float a0,
                               float cx, float cy, float cz, void* stream) {
  return heat_h_launch(heat_h_pick(kHeatH, k, rows), false, ext, nullptr,
                       nullptr, nullptr, nullptr, out, res, nx, ny, nz, bx,
                       by, bz, ox, oy, oz, hx, hy, hz, k, 0, 0, bx, 1,
                       block_z, block_y, rows, seg, a0, cx, cy, cz, stream);
}

extern "C" const char* heat_h_block_3d_error_string(int code) {
  return heat_tma_error_string(code);
}
