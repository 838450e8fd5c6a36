// heat_h_block_3d_fused — K 7-point Jacobi steps on one block of a
// sharded 3D grid, gathered from the block and its exchanged pieces as
// separate operands, with the residual of the last step; or, with
// defer_x, the deferred bulk of the overlapped round.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_3d_fused (pallas_call name
// "heat_h_block_3d_fused", defined at :4579, call :4877), with and
// without defer_x.
//
// Bound on the H100, and the design: heat_h.cuh. This form reads u,
// ztail, ytail and the x slabs straight into shared memory, so the
// extended block is never written to HBM; it is the default round's
// kernel. Its tiles inside the block load u's planes by TMA where the
// geometry allows it (tma != 0: heat_h_tma_fits, which the wrappers'
// rule ops/hopper_params.py h_tma_fits repeats), by one checked 4-byte
// cp.async per cell elsewhere; the tiles at the block's edge always by
// cp.async. With defer_x it takes no x slab, writes only planes
// [K, bx-K) and their residual (heat_h_band_fix_3d writes the rest), and
// so reads nothing of the exchange's third phase.

// The bfloat16 form, on the same body: heat_h_block_3d_fused_bf16.cu.

#include "heat_h.cuh"

template <int K, int R, bool kTma>
__global__ void __launch_bounds__(512)
    heat_h_block_3d_fused_kernel(HEAT_H_PARAMS,
                                 const __grid_constant__ CUtensorMap umap) {
  heat_h_body<K, R, kTma>(HEAT_H_ARGS, &umap);
}

static const HeatHFusedKernel kHeatHFused[3][kHMaxK] =
    HEAT_H_TABLE_OF(heat_h_block_3d_fused_kernel, false);
static const HeatHFusedKernel kHeatHFusedTma[kHMaxK] =
    HEAT_H_DEPTHS_OF(heat_h_block_3d_fused_kernel, kHTmaRows, true);

// The instance of (k, rows) under the load `tma` asks for, or null.
static HeatHFusedKernel heat_h_fused_pick(int k, int rows, bool tma) {
  if (!tma) return heat_h_pick(kHeatHFused, k, rows);
  return rows == kHTmaRows && k >= 1 && k <= kHMaxK ? kHeatHFusedTma[k - 1]
                                                   : nullptr;
}

// K steps of the bx x by x bz block `u` at (ox, oy, oz) of the
// nx x ny x nz grid into `out` (distinct from u), from ztail
// (bx x by x 2k, when hz = k), ytail (bx x 2k x (bz+2hz), when hy = k)
// and xlo / xhi (k x (by+2hy) x (bz+2hz), when hx = k); a piece of an
// unsharded axis (h = 0) is null. defer_x != 0: the deferred bulk,
// planes [k, bx-k) only, xlo and xhi not read (bx >= 2k). tma != 0: the
// tiles inside the block load by TMA, refused unless heat_h_tma_fits. With
// `res` non-null the residual of the planes written lands in *res.
// Returns 0, a cudaError_t saying why the launch was refused, or a
// tensor-map encoding error (heat_h_block_3d_fused_error_string).
extern "C" int heat_h_block_3d_fused(
    const float* u, const float* ztail, const float* ytail, const float* xlo,
    const float* xhi, float* out, uint32_t* res, int64_t nx, int64_t ny,
    int64_t nz, int64_t bx, int64_t by, int64_t bz, int64_t ox, int64_t oy,
    int64_t oz, int hx, int hy, int hz, int defer_x, int tma, int k,
    int block_z, int block_y, int rows, int64_t seg, float a0, float cx,
    float cy, float cz, void* stream) {
  if ((hz != 0) != (ztail != nullptr) || (hy != 0) != (ytail != nullptr) ||
      (!defer_x && (hx != 0) != (xlo != nullptr && xhi != nullptr)) ||
      (defer_x && bx <= 2 * k))
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_h_launch(heat_h_fused_pick(k, rows, tma != 0), tma != 0, u,
                       ztail, ytail, xlo, xhi, out, res, nx, ny, nz, bx, by,
                       bz, ox, oy, oz, hx, hy, hz, k, defer_x ? k : 0, 0,
                       defer_x ? bx - 2 * k : bx, 1, block_z, block_y, rows,
                       seg, a0, cx, cy, cz, stream);
}

// Thread blocks of the (k, rows, tma) instance that one SM holds at once
// under thread blocks of block_z x block_y threads, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's dynamic
// shared memory). Returns a cudaError_t.
extern "C" int heat_h_block_3d_fused_occupancy(int k, int rows, int tma,
                                               int block_z, int block_y,
                                               int* blocks) {
  const HeatHFusedKernel kernel = heat_h_fused_pick(k, rows, tma != 0);
  if (kernel == nullptr || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = heat_h_smem_bytes(k, block_y * rows, block_z, tma != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_z * block_y, smem));
}

extern "C" const char* heat_h_block_3d_fused_error_string(int code) {
  return heat_tma_error_string(code);
}
