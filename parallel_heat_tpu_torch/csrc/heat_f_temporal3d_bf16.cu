// heat_f_temporal3d_bf16 — kernel F on a bfloat16 grid: K 7-point Jacobi
// steps per pass through global memory, every level stored in bfloat16,
// with the residual of the last step optional.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_xslab_3d
// (pallas_call name "heat_f_xslab_3d", defined at :3932, call :4072) at
// dtype bfloat16, where the TPU kernel stores every level it steps in the
// grid's dtype (dst[...] = new.astype(dtype), :4027).
//
// Bound on the H100: a pass reads the grid once and writes it once for K
// steps, 4 B per cell per pass at bfloat16, against 10 float32
// operations per cell-step: at 512^3 the bytes need 0.160 ms a pass at
// 3.35 TB/s, and K = 3 steps' operations 0.060 ms at 67 TFLOP/s.
//
// Design: kernel F's (heat_f_temporal3d.cu) on the same plane loop
// (heat_temporal3d.cuh HeatFLoop with Tin = Tout = __nv_bfloat16 and a
// bfloat16 level layout), a library of its own so that its nvcc runs
// beside F's. Its 1- and 2-row instances at K >= 4 are bound at 12 warps
// (heat_f_max_warps at 2 bytes): at 16 they spilled more than their
// float32 twins. The ring holds the grid's bfloat16 cells, widened
// exactly as a lane reads its group; the arithmetic is float32, and each
// level below K is rounded to bfloat16 before the next one reads it, so
// K steps are bitwise K launches of heat_d_step3d_bf16. The halo along Z
// is 8 cells (heat_f_pad at 2 bytes), so the output tile is 112 cells
// wide at every K and a plane's tile is one TMA box (128 cells, 256-byte
// rows) of a bfloat16 tensor map that starts on 16 bytes: the TMA load
// needs nz % 8 == 0 and a 16-byte aligned grid (ops/stencil_kernels_3d.py
// f_load). Elsewhere a lane copies its 4 cells of a row by one 8-byte
// cp.async where they lie inside the grid on 8 bytes, else by plain
// 2-byte loads, zeros outside the grid. The store rounds the updated
// cells and narrows the copied ones (the six faces) exactly, 8 bytes a
// group where the rows allow it.

#include "heat_f.cuh"

// The level layout of the (K, R) instances, both loads
// (heat_temporal3d.cuh kHeatFBf16*): both layouts compute the same bits,
// and each instance takes one that ptxas compiles with no more spill than
// its float32 twin's (chip_smoke.py's build phase holds it to that):
// float4 levels rounded in pairs, the fastest at the main path's K = 3,
// but at 4 rows from K = 5, where they spill more than the float32 twin
// and the packed ones (half the registers) less. Measured by compiling
// every instance in each layout (PERF.md §6).
__host__ __device__ constexpr int heat_f_bf16_layout(int k, int rows) {
  return rows == 4 && k >= 5 ? kHeatFBf16Packed : kHeatFBf16Pair;
}

// One block: kernel F's (heat_f_block.inc) on bfloat16 cells.
template <int K, int R, bool kTma>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(R, K, 2))
heat_f_temporal3d_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                              __nv_bfloat16* __restrict__ out, uint32_t* res,
                              int64_t nx, int64_t ny, int64_t nz,
                              int64_t tiles_z, int64_t tiles_y, int seg,
                              int prefetch, int vec_out, float a0, float cx,
                              float cy, float cz,
                              const __grid_constant__ CUtensorMap umap) {
  using Loop = HeatFLoop<K, R, kTma, kHeatFFull, false, 0, __nv_bfloat16,
                         __nv_bfloat16, heat_f_bf16_layout(K, R)>;
#include "heat_f_block.inc"
}

using HeatFBf16Kernel = HeatFKernelOf<__nv_bfloat16>;

// kHeatFBf16Kernels[tma][r][k - 1]: depth k, rows per thread 1 << r, the
// load.
#define HEAT_F_DEPTHS(R, T)                                                 \
  {heat_f_temporal3d_bf16_kernel<1, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<2, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<3, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<4, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<5, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<6, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<7, R, T>,                                  \
   heat_f_temporal3d_bf16_kernel<8, R, T>}
static const HeatFBf16Kernel kHeatFBf16Kernels[2][3][kFMaxK] = {
    {HEAT_F_DEPTHS(1, false), HEAT_F_DEPTHS(2, false),
     HEAT_F_DEPTHS(4, false)},
    {HEAT_F_DEPTHS(1, true), HEAT_F_DEPTHS(2, true), HEAT_F_DEPTHS(4, true)}};
#undef HEAT_F_DEPTHS

// The instance of (k, rows, tma), or null where none is compiled.
static HeatFBf16Kernel heat_f_bf16_pick(int k, int rows, int tma) {
  const int r = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
  return r < 0 || k < 1 || k > kFMaxK ? nullptr
                                      : kHeatFBf16Kernels[tma != 0][r][k - 1];
}

// heat_f_temporal3d on a bfloat16 grid `u` into the bfloat16 `out`, with
// the same arguments: K steps in float32, each level below K rounded to
// bfloat16 (storage mode), the six faces copied bit for bit; with `res`
// non-null the last step's residual, its float32 update against the
// level it read, lands in *res. tma needs nz % 8 == 0 and `u` 16-byte
// aligned. Returns a cudaError_t, or a tensor-map encoding error
// (heat_f_temporal3d_bf16_error_string).
extern "C" int heat_f_temporal3d_bf16(const __nv_bfloat16* u,
                                      __nv_bfloat16* out, uint32_t* res,
                                      int64_t nx, int64_t ny, int64_t nz,
                                      int k, int block_x, int block_y,
                                      int rows, int seg, int prefetch,
                                      int tma, float a0, float cx, float cy,
                                      float cz, void* stream) {
  return heat_f_launch(heat_f_bf16_pick(k, rows, tma), u, out, res, nx, ny,
                       nz, k, block_x, block_y, rows, seg, prefetch, tma, a0,
                       cx, cy, cz, stream);
}

// Thread blocks of the bfloat16 (k, rows, tma) instance that one SM holds
// at once under thread blocks of 32 x block_y threads and `prefetch`
// planes in flight, into *blocks (the CUDA occupancy calculator,
// registers included). Returns a cudaError_t.
extern "C" int heat_f_temporal3d_bf16_occupancy(int k, int block_y, int rows,
                                                int tma, int prefetch,
                                                int* blocks) {
  if (blocks == nullptr || prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(kFLanes, block_y, rows, k, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeatFBf16Kernel kernel = heat_f_bf16_pick(k, rows, tma);
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch, 2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kFLanes * block_y, smem));
}

extern "C" const char* heat_f_temporal3d_bf16_error_string(int code) {
  return heat_tma_error_string(code);
}
