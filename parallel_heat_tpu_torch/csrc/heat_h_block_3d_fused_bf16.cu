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
// Design: H-fused's tiles, pieces and step phase (heat_h.cuh
// heat_h_body_bf16, heat_temporal3d.cuh heat_f_levels) on a plane loop of
// its own, heat_t3d_stream_bf16, in a library of its own so that its nvcc
// runs beside H-fused's. The ring and the level planes stay float32; each
// level below K is rounded to bfloat16 before it lands in the level
// planes and registers, the copied cells keeping their bits, so K steps
// are bitwise K launches of heat_d_step3d_bf16; level K's float32 update
// against level K - 1 is the residual, and the store rounds the updated
// cells and narrows the copied ones exactly. No thread waits on a load
// before the step of its plane (a plain 2-byte load a cell, which each
// thread waited out on every plane, cost 1.329 ms at the 512^3 block and
// K = 3 against float32's 1.044: PERF.md): every plane is copied
// kHBf16Prefetch planes ahead into a staging slot and widened into the
// float32 ring at the top of its own iteration. The tiles inside the
// block take u's planes as one bfloat16 TMA box each (tma != 0, where
// bz % 8 == 0 and the block holds such a tile: heat_h_tma_fits);
// every other cell comes by a 4-byte cp.async of the word that holds it.
// Compiled at kHTmaRows rows a thread (h_rows, the rows the pickers
// take), every depth, each with and without the box.

#include "heat_h.cuh"

// The levels' layout of the (K, rows) instances: packed from K = 7, where
// the float layout spilled past the float32 twins' (ptxas at 128
// registers: <7, 4, true> 68 bytes stored against none, <8, 4, false>
// 164 against 68; PERF.md), floats below, where nothing spills.
__host__ __device__ constexpr bool heat_h_bf16_packed(int k) {
  return k >= 7;
}

template <int K, int R, bool kTma>
__global__ void __launch_bounds__(512)
    heat_h_block_3d_fused_bf16_kernel(
        HEAT_H_PARAMS_OF(__nv_bfloat16),
        const __grid_constant__ CUtensorMap umap) {
  heat_h_body_bf16<K, R, kTma, heat_h_bf16_packed(K)>(HEAT_H_ARGS, &umap);
}

using HeatHFusedBf16Kernel = HeatHFusedKernelOf<__nv_bfloat16>;

static const HeatHFusedBf16Kernel kHeatHFusedBf16[2][kHMaxK] = {
    HEAT_H_DEPTHS_OF(heat_h_block_3d_fused_bf16_kernel, kHTmaRows, false),
    HEAT_H_DEPTHS_OF(heat_h_block_3d_fused_bf16_kernel, kHTmaRows, true)};

// The instance of (k, rows) under the load `tma` asks for, or null.
static HeatHFusedBf16Kernel heat_h_fused_bf16_pick(int k, int rows,
                                                   bool tma) {
  return rows == kHTmaRows && k >= 1 && k <= kHMaxK
             ? kHeatHFusedBf16[tma ? 1 : 0][k - 1]
             : nullptr;
}

// heat_h_block_3d_fused on bfloat16 blocks and pieces into the bfloat16
// `out`, with the same arguments: K steps in float32, each level below K
// rounded to bfloat16 (storage mode), the cells outside the global
// interior copied bit for bit; the residual of the planes written, the
// last step's float32 update against the level it read, lands in *res
// when res is non-null. tma != 0: the tiles inside the block load by TMA
// boxes, refused unless heat_h_tma_fits. Returns 0, a cudaError_t
// saying why the launch was refused, or a tensor-map encoding error.
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
      (defer_x && bx <= 2 * k))
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_h_launch(heat_h_fused_bf16_pick(k, rows, tma != 0), tma != 0,
                       u, ztail, ytail, xlo, xhi, out, res, nx, ny, nz, bx,
                       by, bz, ox, oy, oz, hx, hy, hz, k, defer_x ? k : 0, 0,
                       defer_x ? bx - 2 * k : bx, 1, block_z, block_y, rows,
                       seg, a0, cx, cy, cz, stream);
}

// Thread blocks of the bfloat16 (k, rows, tma) instance that one SM
// holds at once under thread blocks of block_z x block_y threads, into
// *blocks. Returns a cudaError_t.
extern "C" int heat_h_block_3d_fused_bf16_occupancy(int k, int rows, int tma,
                                                    int block_z, int block_y,
                                                    int* blocks) {
  const HeatHFusedBf16Kernel kernel =
      heat_h_fused_bf16_pick(k, rows, tma != 0);
  if (kernel == nullptr || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = heat_h_bf16_smem_bytes(k, block_y * rows, block_z);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_z * block_y, smem));
}

extern "C" const char* heat_h_block_3d_fused_bf16_error_string(int code) {
  return heat_tma_error_string(code);
}
