// heat_h_block_3d_bf16 — kernel H on a bfloat16 grid: K 7-point Jacobi
// steps on one block of a sharded 3D grid, read from the bfloat16 block
// assembled with its K-deep halo in one buffer, every level stored in
// bfloat16, with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_3d (pallas_call name "heat_h_block_3d", defined
// at :4353, call :4539) at dtype bfloat16, where the TPU kernel stores
// every level it steps in the grid's dtype (new.astype(dtype), :4491,
// :4520).
//
// Bound on the H100: the circular block read once and the block written
// once, 2 * ((bx+2hx)(by+2hy)(bz+2hz) + bx*by*bz) bytes; at a 512^3
// block and K = 3, 0.163 ms at 3.35 TB/s against 0.060 ms for the
// operations, so bytes bound it.
//
// Design: kernel H's (heat_h_block_3d.cu) on the same tiles and plane
// loop (heat_hc.cuh heat_hc_tile, HeatFLoop with Tin = Tout =
// __nv_bfloat16 and kernel F's bfloat16 level layouts), a library of its
// own so that its nvcc runs beside H's. The ring holds the block's
// bfloat16 cells, widened exactly as a lane reads its group; arithmetic
// is float32, each level below K is rounded to bfloat16 before the next
// one reads it, and the copied cells keep their bits, so K steps are
// bitwise K launches of heat_d_step3d_bf16 on the same cells. The halo
// along Z is 8 cells (heat_f_pad at 2 bytes), so the output tile is 112
// cells wide and a boxed tile's plane is one TMA box (128 cells, 256-byte
// rows) of a bfloat16 tensor map over the circular block, whose rows are
// padded to a multiple of 8 cells (ops/hopper_params.py hc_pitch). A
// wrapped tile (the first row or column of tiles along a sharded axis,
// which needs the lo piece) copies a lane's 4 cells of a row by one 8-byte
// cp.async where they lie in the K-deep frame on 8 bytes, else by plain
// 2-byte loads and zeros (HeatFLoop's kCirc fetch). The store rounds the
// updated cells and narrows the copied ones exactly, 8 bytes a group
// where the rows allow it.

#include "heat_hc.cuh"

// One block: kernel H's (heat_h_block_3d_kernel) on bfloat16 cells; the
// 1- and 2-row instances at K >= 4 are bound at 12 warps, as F's
// bfloat16 ones (heat_f_max_warps at 2 bytes).
template <int K, int R>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(R, K, 2))
    heat_h_block_3d_bf16_kernel(const HeatHcBf16Args a,
                                const __grid_constant__ CUtensorMap emap) {
  constexpr int P = heat_f_pad(K, 2);
  const int wy = blockDim.y * R;
  const int64_t b = blockIdx.x;
  const int64_t tz = b % a.tiles_z;
  const int64_t ty = (b / a.tiles_z) % a.tiles_y;
  const int64_t x0 = b / a.tiles_z / a.tiles_y * a.seg;
  const int64_t z0 = tz * (kFWidth - 2 * P) - P;
  const int64_t y0 = ty * (wy - 2 * K) - K;
  if (a.tma && (y0 >= 0 || a.hy == 0) && (z0 >= 0 || a.hz == 0))
    heat_hc_tile<K, R, true>(a, &emap, x0, y0, z0);
  else
    heat_hc_tile<K, R, false>(a, &emap, x0, y0, z0);
}

using HeatHcBf16Kernel = void (*)(const HeatHcBf16Args, const CUtensorMap);

// kHeatHcBf16[r][k - 1]: depth k, rows per thread 1 << r.
#define HEAT_HC_DEPTHS(R)                                                    \
  {heat_h_block_3d_bf16_kernel<1, R>, heat_h_block_3d_bf16_kernel<2, R>,     \
   heat_h_block_3d_bf16_kernel<3, R>, heat_h_block_3d_bf16_kernel<4, R>,     \
   heat_h_block_3d_bf16_kernel<5, R>, heat_h_block_3d_bf16_kernel<6, R>,     \
   heat_h_block_3d_bf16_kernel<7, R>, heat_h_block_3d_bf16_kernel<8, R>}
static const HeatHcBf16Kernel kHeatHcBf16[3][kFMaxK] = {
    HEAT_HC_DEPTHS(1), HEAT_HC_DEPTHS(2), HEAT_HC_DEPTHS(4)};
#undef HEAT_HC_DEPTHS

// The instance of (k, rows), or null where none is compiled.
static HeatHcBf16Kernel heat_hc_bf16_pick(int k, int rows) {
  const int r = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
  return r < 0 || k < 1 || k > kFMaxK ? nullptr : kHeatHcBf16[r][k - 1];
}

// heat_h_block_3d on the bfloat16 circular block `ext` (rows of `pitch`
// bfloat16 cells) into the bfloat16 `out`, with the same arguments: K
// steps in float32, each level below K rounded to bfloat16 (storage
// mode), the cells outside the global interior copied bit for bit; with
// `res` non-null the last step's residual, its float32 update against the
// level it read, lands in *res. tma needs pitch % 8 == 0 and `ext`
// 16-byte aligned. Returns a cudaError_t, or a tensor-map encoding error
// (heat_h_block_3d_bf16_error_string).
extern "C" int heat_h_block_3d_bf16(
    const __nv_bfloat16* ext, __nv_bfloat16* out, uint32_t* res, int64_t nx,
    int64_t ny, int64_t nz, int64_t bx, int64_t by, int64_t bz, int64_t ox,
    int64_t oy, int64_t oz, int hx, int hy, int hz, int64_t pitch, int k,
    int block_x, int block_y, int rows, int64_t seg, int prefetch, int tma,
    float a0, float cx, float cy, float cz, void* stream) {
  return heat_hc_launch(heat_hc_bf16_pick(k, rows), ext, out, res, nx, ny,
                        nz, bx, by, bz, ox, oy, oz, hx, hy, hz, pitch, k,
                        block_x, block_y, rows, seg, prefetch, tma, a0, cx,
                        cy, cz, stream);
}

// Thread blocks of the bfloat16 (k, rows) instance that one SM holds at
// once under thread blocks of 32 x block_y threads and `prefetch` planes
// in flight, into *blocks. Returns a cudaError_t.
extern "C" int heat_h_block_3d_bf16_occupancy(int k, int block_y, int rows,
                                              int prefetch, int* blocks) {
  return heat_hc_occupancy(heat_hc_bf16_pick(k, rows), 2, k, block_y, rows,
                           prefetch, blocks);
}

extern "C" const char* heat_h_block_3d_bf16_error_string(int code) {
  return heat_tma_error_string(code);
}
