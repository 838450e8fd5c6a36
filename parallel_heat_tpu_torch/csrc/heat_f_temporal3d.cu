// heat_f_temporal3d — K 7-point Jacobi steps per pass through global
// memory, with the residual of the last step optional.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_xslab_3d
// (pallas_call name "heat_f_xslab_3d", defined at :3932, call :4072).
//
// Bound on the H100: a pass reads the grid once and writes it once for K
// steps, 8 B per cell per pass, against 10 float32 operations per
// cell-step (and 2 for the residual of the last step): at 512^3 and
// K = 3 the bytes need 0.32 ms per pass at 3.35 TB/s and the operations
// 0.060 ms at 67 TFLOP/s, so bytes bound it. What a pass really moves
// is about 4*(1+2K/TY)(1+2P/TZ)(1+2K/L) B read and 4 B written per
// output cell for (TY, TZ) output tiles and segments of L planes,
// whatever of the halo L2 does not serve; at the defaults (26 x 120
// output cells of a 32 x 128 extended tile, K = 3) a tile steps 1.31
// cells per output cell. Below that lies instruction issue: the 10
// rounded operations of the combine per cell-step and what the loop adds.
//
// Design: the TPU kernel keeps whole (Y, Z) planes in VMEM and streams
// X-slabs with K halo planes per side. At 512^3 one float32 plane is
// 1 MiB, and a block here has at most 227 KB of shared memory, so the
// (Y, Z) plane is tiled too: a block owns a tile of output cells plus a
// K-deep halo along Y and a halo of heat_f_pad(K) cells (K rounded up to
// 4) along Z, the extended tile of W R rows by 128 cells, and a segment
// of output planes [x0, x1); it streams the input planes
// [x0 - K, x1 + K) with all K levels in flight through
// heat_temporal3d.cuh's register-blocked plane loop (HeatFLoop): a lane
// owns 4 adjacent z cells of R rows in float4 registers, Z neighbours by
// warp shuffle, Y neighbours in registers but at a thread's first and
// last row, X neighbours in registers, renamed by a plane loop unrolled
// by 3. The sharded block kernels heat_h_* step with heat_f_levels, one z
// cell a thread with its neighbours in shared memory (PERF.md has both
// loops' costs).
// A plane's tile arrives by TMA where the grid's rows are multiples of 16
// bytes (nz % 4 == 0): one box of a 3D tensor map of the grid, which
// starts at a z that is a multiple of 4 (the halo along Z is rounded up
// for that) and is zero-filled outside the grid, so tiles at the grid's
// edge take the same load as the others. Elsewhere every thread copies
// its cells by cp.async, 4 bytes each, zero-filled outside the grid; the
// caller chooses (ops/stencil_kernels_3d.py f_load) and nothing falls
// back. Only the central tile is written back, 16 bytes a group where
// the rows allow it. Cells outside the grid load as 0; they cannot reach
// the interior, since the faces between them and the interior never
// update. The six Dirichlet faces are copied, never computed, and every
// step rounds to float32 like a launch of heat_d_step3d, which makes K
// steps bitwise K launches of D. Offsets are int64.

#include "heat_f.cuh"

// One block: the (Y, Z) tile and the X segment of blockIdx.x; blockDim is
// (32, W), the extended tile 128 cells by W * R rows. The loop is
// HeatFLoop's; kTma picks the load.
template <int K, int R, bool kTma>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(R))
heat_f_temporal3d_kernel(const float* __restrict__ u, float* __restrict__ out,
                         uint32_t* res, int64_t nx, int64_t ny, int64_t nz,
                         int64_t tiles_z, int64_t tiles_y, int seg,
                         int prefetch, int vec_out, float a0, float cx,
                         float cy, float cz,
                         const __grid_constant__ CUtensorMap umap) {
  using Loop = HeatFLoop<K, R, kTma>;
#include "heat_f_block.inc"
}

// kHeatF[tma][r][k - 1]: depth k, rows per thread 1 << r, the load.
#define HEAT_F_DEPTHS(R, T)                                                  \
  {heat_f_temporal3d_kernel<1, R, T>, heat_f_temporal3d_kernel<2, R, T>,     \
   heat_f_temporal3d_kernel<3, R, T>, heat_f_temporal3d_kernel<4, R, T>,     \
   heat_f_temporal3d_kernel<5, R, T>, heat_f_temporal3d_kernel<6, R, T>,     \
   heat_f_temporal3d_kernel<7, R, T>, heat_f_temporal3d_kernel<8, R, T>}
static const HeatFKernel kHeatF[2][3][kFMaxK] = {
    {HEAT_F_DEPTHS(1, false), HEAT_F_DEPTHS(2, false),
     HEAT_F_DEPTHS(4, false)},
    {HEAT_F_DEPTHS(1, true), HEAT_F_DEPTHS(2, true), HEAT_F_DEPTHS(4, true)}};
#undef HEAT_F_DEPTHS

// The instance of (k, rows, tma), or null where none is compiled.
static HeatFKernel heat_f_pick(int k, int rows, int tma) {
  const int r = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
  return r < 0 || k < 1 || k > kFMaxK ? nullptr
                                      : kHeatF[tma != 0][r][k - 1];
}

// K steps of the nx x ny x nz float32 grid `u` (z contiguous) into `out`
// (distinct buffers on the current device), with thread blocks of
// block_x x block_y threads, each `rows` rows deep (heat_f_takes: 32
// lanes, 1, 2 or 4 rows, at most heat_f_max_warps(rows) warps,
// 1 <= k <= 8, 2k < block_y * rows), over segments of `seg` X planes,
// with `prefetch` planes in flight (1 .. kFMaxPrefetch). tma: each
// plane's tile as one TMA box, which needs nz % 4 == 0 and `u` 16-byte
// aligned; else by cp.async. With `res` non-null, the last step's
// residual bit pattern lands in *res. Launches on `stream` and does not
// synchronise. Returns a cudaError_t: 0, or the reason the launch was
// refused; or a tensor-map encoding error
// (heat_f_temporal3d_error_string).
extern "C" int heat_f_temporal3d(const float* u, float* out, uint32_t* res,
                                 int64_t nx, int64_t ny, int64_t nz, int k,
                                 int block_x, int block_y, int rows, int seg,
                                 int prefetch, int tma, float a0, float cx,
                                 float cy, float cz, void* stream) {
  return heat_f_launch(heat_f_pick(k, rows, tma), u, out, res, nx, ny, nz, k,
                       block_x, block_y, rows, seg, prefetch, tma, a0, cx, cy,
                       cz, stream);
}

// Thread blocks of the (k, rows, tma) instance that one SM holds at once
// under thread blocks of 32 x block_y threads and `prefetch` planes in
// flight, into *blocks (the CUDA occupancy calculator, registers
// included). Returns a cudaError_t.
extern "C" int heat_f_temporal3d_occupancy(int k, int block_y, int rows,
                                           int tma, int prefetch,
                                           int* blocks) {
  if (blocks == nullptr || prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(kFLanes, block_y, rows, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeatFKernel kernel = heat_f_pick(k, rows, tma);
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kFLanes * block_y, smem));
}

extern "C" const char* heat_f_temporal3d_error_string(int code) {
  return heat_tma_error_string(code);
}
