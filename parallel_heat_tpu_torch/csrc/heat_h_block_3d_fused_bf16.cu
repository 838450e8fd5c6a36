// heat_h_block_3d_fused_bf16 — H-fused on a bfloat16 grid: K 7-point
// Jacobi steps on one block of a sharded 3D grid, gathered from the
// bfloat16 block and its exchanged pieces as separate operands, every
// level stored in bfloat16, with the residual of the last step; or, with
// defer_x, the deferred bulk of the overlapped round.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_3d_fused (pallas_call name
// "heat_h_block_3d_fused", defined at :4579, call :4877) at dtype
// bfloat16, with and without defer_x, where the TPU kernel stores every
// level it steps in the grid's dtype (new.astype(dtype), :4825, :4850).
//
// Bound on the H100: half of H-fused's bytes (heat_h.cuh), a round
// reading the block and its pieces once and writing the block once, 2 B
// a cell: 0.163 ms at a 512^3 block and K = 3 against 0.060 ms for the
// operations.
//
// Design: H-fused's (heat_h_block_3d_fused.cu, heat_h.cuh heat_h_body) on
// the same tiles, pieces and step loop (heat_temporal3d.cuh
// heat_t3d_stream), a library of its own so that its nvcc runs beside
// H-fused's. The ring and the level planes stay float32: each thread's
// cell of a plane is widened as it loads, by one plain 2-byte load from
// u, the z tail, the y tail or an x slab (zero outside the grid and the
// K-deep frame), stored before the block barrier that publishes the
// plane. Each level below K is rounded to bfloat16 before it lands in the
// level planes and registers, the copied cells keeping their bits, so K
// steps are bitwise K launches of heat_d_step3d_bf16; level K's float32
// update against level K - 1 is the residual, and the store rounds the
// updated cells and narrows the copied ones exactly. Every tile takes this
// one load (the launch refuses tma): a bfloat16 row of a block is a
// multiple of 16 bytes only at bz % 8 == 0, and a bfloat16 box does not
// widen as it lands.

#include "heat_h.cuh"

template <int K, int R>
__global__ void __launch_bounds__(512)
    heat_h_block_3d_fused_bf16_kernel(
        HEAT_H_PARAMS_OF(__nv_bfloat16),
        const __grid_constant__ CUtensorMap umap) {
  heat_h_body<K, R, false>(HEAT_H_ARGS, &umap);
}

using HeatHFusedBf16Kernel = HeatHFusedKernelOf<__nv_bfloat16>;

static const HeatHFusedBf16Kernel kHeatHFusedBf16[3][kHMaxK] =
    HEAT_H_TABLE(heat_h_block_3d_fused_bf16_kernel);

// heat_h_block_3d_fused on bfloat16 blocks and pieces into the bfloat16
// `out`, with the same arguments: K steps in float32, each level below K
// rounded to bfloat16 (storage mode), the cells outside the global
// interior copied bit for bit; the residual of the planes written, the
// last step's float32 update against the level it read, lands in *res
// when res is non-null. tma must be 0 (this form has one load). Returns
// 0 or a cudaError_t saying why the launch was refused.
extern "C" int heat_h_block_3d_fused_bf16(
    const __nv_bfloat16* u, const __nv_bfloat16* ztail,
    const __nv_bfloat16* ytail, const __nv_bfloat16* xlo,
    const __nv_bfloat16* xhi, __nv_bfloat16* out, uint32_t* res, int64_t nx,
    int64_t ny, int64_t nz, int64_t bx, int64_t by, int64_t bz, int64_t ox,
    int64_t oy, int64_t oz, int hx, int hy, int hz, int defer_x, int tma,
    int k, int block_z, int block_y, int rows, int64_t seg, float a0,
    float cx, float cy, float cz, void* stream) {
  if ((hz != 0) != (ztail != nullptr) || (hy != 0) != (ytail != nullptr) ||
      (!defer_x && (hx != 0) != (xlo != nullptr && xhi != nullptr)) ||
      (defer_x && bx <= 2 * k) || tma != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_h_launch(heat_h_pick(kHeatHFusedBf16, k, rows), false, u,
                       ztail, ytail, xlo, xhi, out, res, nx, ny, nz, bx, by,
                       bz, ox, oy, oz, hx, hy, hz, k, defer_x ? k : 0, 0,
                       defer_x ? bx - 2 * k : bx, 1, block_z, block_y, rows,
                       seg, a0, cx, cy, cz, stream);
}

// Thread blocks of the bfloat16 (k, rows) instance that one SM holds at
// once under thread blocks of block_z x block_y threads, into *blocks
// (tma must be 0). Returns a cudaError_t.
extern "C" int heat_h_block_3d_fused_bf16_occupancy(int k, int rows, int tma,
                                                    int block_z, int block_y,
                                                    int* blocks) {
  const HeatHFusedBf16Kernel kernel = heat_h_pick(kHeatHFusedBf16, k, rows);
  if (kernel == nullptr || blocks == nullptr || tma != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = heat_h_smem_bytes(k, block_y * rows, block_z, false);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_z * block_y, smem));
}

extern "C" const char* heat_h_block_3d_fused_bf16_error_string(int code) {
  return heat_tma_error_string(code);
}
