// heat_h_band_fix_3d_bf16 — the band pass of the overlapped sharded 3D
// round on a bfloat16 grid: the K-step values of each block's first and
// last K x-planes, every level stored in bfloat16, with the residual of
// exactly those planes; every block of a round in one launch.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_band_fix_3d
// (pallas_call name "heat_h_band_fix_3d", defined at :4934, call :5124)
// at dtype bfloat16, where the TPU kernel stores every level it steps in
// the grid's dtype (new.astype(dtype), :5080, :5105).
//
// Bound on the H100: half of the float32 band's bytes
// (heat_h_band_fix_3d.cu), 0.0306 ms for the 8 blocks of 1024^3 on
// (2, 2, 2) at K = 3.
//
// Design: the float32 band's (heat_h_band_fix_3d.cu; heat_hb.cuh) on the
// same table of blocks, tiles and plane loop (heat_temporal3d.cuh
// HeatFLoop::run_band with Tin = Tout = __nv_bfloat16 and kernel F's
// bfloat16 level layouts, the levels outside the output's cone not
// stepped), a library of its own so that its nvcc runs beside the
// float32 band's. The ring holds the pieces' bfloat16 cells, widened
// exactly as a lane reads its group (HeatHBandSeg::load_bf16: one 8-byte
// cp.async where a lane's 4 cells of a row are one aligned run of one
// piece inside the K-deep frame, the vector load taking the runs of u
// untested where every block is 16-byte aligned with bz % 8 == 0, else
// plain 2-byte loads and zeros). Arithmetic is float32, each level below
// K is rounded to bfloat16 before the next one reads it, and the copied
// cells keep their bits, so the bands are bitwise the monolithic bfloat16
// round's planes, and K launches of heat_d_step3d_bf16's.

#include "heat_hb.cuh"

// One thread block: heat_h_band_fix_3d_kernel's, on bfloat16 cells; the
// 2-row instances at K >= 4 are bound at 12 warps, as F's bfloat16 ones
// (heat_f_max_warps at 2 bytes).
template <int K, int R, int kLoad>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(R, K, 2))
    heat_h_band_fix_3d_bf16_kernel(
        const __grid_constant__ HeatHBandTable table,
        const __grid_constant__ HeatHBandArgs a) {
  constexpr int P = heat_f_pad(K, 2);
  const int wy = blockDim.y * R;
  const int64_t b = blockIdx.x;
  const int64_t tz = b % a.tiles_z;
  const int64_t ty = b / a.tiles_z;
  heat_hb_tile<K, R, kLoad, __nv_bfloat16>(
      table, a, blockIdx.y, static_cast<int>(ty * (wy - 2 * K) - K),
      static_cast<int>(tz * (kFWidth - 2 * P) - P));
}

// kHeatHBandBf16[load][r][k - 1]: the loads at 2 and 4 rows a thread
// (r = 0, 1), depth k.
#define HEAT_HB_DEPTHS(R, L)                                                 \
  {heat_h_band_fix_3d_bf16_kernel<1, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<2, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<3, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<4, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<5, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<6, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<7, R, L>,                                  \
   heat_h_band_fix_3d_bf16_kernel<8, R, L>}
static const HeatHBandKernel kHeatHBandBf16[2][2][kFMaxK] = {
    {HEAT_HB_DEPTHS(2, kHeatHBandCells), HEAT_HB_DEPTHS(4, kHeatHBandCells)},
    {HEAT_HB_DEPTHS(2, kHeatHBandVec), HEAT_HB_DEPTHS(4, kHeatHBandVec)}};
#undef HEAT_HB_DEPTHS

// heat_h_band_fix_3d on bfloat16 blocks, tails and slabs (the table's
// pointers point at bfloat16 cells), written into each entry's bfloat16
// `out` in place, with the same arguments: K steps in float32, each level
// below K rounded to bfloat16, the cells outside the global interior
// copied bit for bit; the residual of all the bands, float32 updates
// against the levels they read. The vector load (load 1, or -1 where the
// blocks take it) needs bz % 8 == 0 and every block 16-byte aligned.
// Returns a cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_h_band_fix_3d_bf16(
    const HeatHBandEntry* entries, int count, int load, uint32_t* res,
    int64_t nx, int64_t ny, int64_t nz, int64_t bx, int64_t by, int64_t bz,
    int hy, int hz, int k, int block_x, int block_y, int rows, int prefetch,
    float a0, float cx, float cy, float cz, void* stream) {
  return heat_hb_launch(kHeatHBandBf16, 2, entries, count, load, res, nx, ny,
                        nz, bx, by, bz, hy, hz, k, block_x, block_y, rows,
                        prefetch, a0, cx, cy, cz, stream);
}

extern "C" const char* heat_h_band_fix_3d_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
