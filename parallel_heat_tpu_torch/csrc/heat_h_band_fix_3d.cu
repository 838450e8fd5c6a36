// heat_h_band_fix_3d — the band pass of the overlapped sharded 3D round:
// the K-step values of each block's first and last K x-planes, from the
// block, its tails and the x slabs, with the residual of exactly those
// planes; every block of a round in one launch.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_band_fix_3d
// (pallas_call name "heat_h_band_fix_3d", defined at :4934, call :5124).
//
// Bound on the H100: the bands read 4K planes of the block and the tails'
// planes beside them, the slabs' 2K planes, and write 2K planes, 0.0076
// ms at a 512^3 block and K = 3, 0.0612 for the 8 blocks of 1024^3 on
// (2, 2, 2). A band is short (3K input planes for K output planes), so
// its time is a few planes' loads and steps a tile, not bytes: 0.1953 ms
// a round of 8 blocks (PERF.md).
//
// Design. The TPU kernel fixes one block's bands a call; here one launch
// takes a table of blocks (their pieces, output and int64 origin), passed
// by value as a __grid_constant__ parameter, as heat_g_band_fix.cu does
// in 2D, so that a round's bands cost one launch, one residual word
// zeroed once, and no per-block host call. A segment is one block's
// region: output planes [0, K) or [bx-K, bx), from input planes [-K, 2K)
// or [bx-2K, bx+K). The grid is (tiles, segments): a thread block steps
// one (Y, Z) tile of one segment on kernel F's register-blocked plane
// loop (heat_temporal3d.cuh HeatFLoop::run_band): a lane owns 4 z cells
// of R rows in float4 registers, Z neighbours by shuffle, one barrier a
// plane, F's arithmetic and so F's bits. The levels outside the output's
// cone are not stepped (2K^2 - K plane-levels a segment of the 3K^2 F's
// loop steps). The tiles are F's over the block (an extended tile of W R
// rows by 128 cells, output rows [K, W R - K) and cells [P, 128 - P),
// P = heat_f_pad(K)), as kernel H's. At 32 x 16 threads of 2 rows a
// thread block takes 114 registers a thread, one an SM, and the 8 blocks
// of 1024^3 on (2, 2, 2) at K = 3 are 1600 thread blocks, 12 waves.
// The load (heat_hb.cuh HeatHBandSeg::load): input plane t of a block
// comes from u for t in [0, bx), from xlo or xhi outside (y and z
// circular, [u | hi | lo]); inside a plane of u, a row of the block comes
// from u and, past
// bz or below 0, from the z tail [hi | lo], a row past by or below 0
// from the y tail (z circular); zeros past the K-deep frame. Each row's
// piece and offset are worked out as a plane is loaded, from the thread's
// first row and cell (every block of a launch has one shape), a few
// integer operations a row before its copies: a 4-byte cp.async a cell
// (kHeatHBandCells), or a 16-byte one where a lane's four cells are one
// aligned run of u (kHeatHBandVec, bz % 4 == 0 and every block 16-byte
// aligned). Every thread arrives on the slot's mbarrier. The x slabs' rows (bz + 2hz floats, 518 at K = 3) are no
// multiple of 16 bytes and stay 4 bytes a cell.
// The planes land in the deferred bulk's output buffer in place (the TPU
// kernel returns them and the caller splices them in), so no splice copy
// is needed. Cells outside the global interior are copied, never
// computed: the bands are bitwise the monolithic round's planes.

// The bfloat16 form, on the same table and loop: heat_h_band_fix_3d_bf16.cu.

#include "heat_hb.cuh"

// One thread block: segment blockIdx.y (entry blockIdx.y / 2, region
// blockIdx.y % 2), the (Y, Z) tile of blockIdx.x; blockDim is (32, W).
template <int K, int R, int kLoad>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(R))
    heat_h_band_fix_3d_kernel(const __grid_constant__ HeatHBandTable table,
                              const __grid_constant__ HeatHBandArgs a) {
  constexpr int P = heat_f_pad(K);
  const int wy = blockDim.y * R;
  const int64_t b = blockIdx.x;
  const int64_t tz = b % a.tiles_z;
  const int64_t ty = b / a.tiles_z;
  heat_hb_tile<K, R, kLoad>(table, a, blockIdx.y,
                            static_cast<int>(ty * (wy - 2 * K) - K),
                            static_cast<int>(tz * (kFWidth - 2 * P) - P));
}

// kHeatHBand[load][r][k - 1]: the plane loop's loads at 2 and 4 rows a
// thread (r = 0, 1), depth k.
#define HEAT_HB_DEPTHS(R, L)                                                 \
  {heat_h_band_fix_3d_kernel<1, R, L>, heat_h_band_fix_3d_kernel<2, R, L>,   \
   heat_h_band_fix_3d_kernel<3, R, L>, heat_h_band_fix_3d_kernel<4, R, L>,   \
   heat_h_band_fix_3d_kernel<5, R, L>, heat_h_band_fix_3d_kernel<6, R, L>,   \
   heat_h_band_fix_3d_kernel<7, R, L>, heat_h_band_fix_3d_kernel<8, R, L>}
static const HeatHBandKernel kHeatHBand[2][2][kFMaxK] = {
    {HEAT_HB_DEPTHS(2, kHeatHBandCells), HEAT_HB_DEPTHS(4, kHeatHBandCells)},
    {HEAT_HB_DEPTHS(2, kHeatHBandVec), HEAT_HB_DEPTHS(4, kHeatHBandVec)}};
#undef HEAT_HB_DEPTHS

// Planes [0, K) and [bx-K, bx) of K steps of each of the `count`
// bx x by x bz blocks of `entries` (a host array), written into each
// entry's `out` in place; every block lies in the nx x ny x nz grid at its
// origin, has at least 2K planes and x slabs (hx = K); hy and hz are K
// or 0 (the block spans the grid along that axis: no tail, zt or yt
// null). `load` is a HeatHBandLoad, or -1: the 16-byte load where the
// blocks take it, else the 4-byte one (the 16-byte load where they do
// not is refused). Thread blocks of block_x x block_y threads of `rows`
// rows (heat_f_takes, rows 2 or 4), `prefetch` planes in flight (1 ..
// kFMaxPrefetch). Launches in chunks of kHeatHBandTable blocks. With
// `res` non-null it is zeroed once and the residual of all the bands
// lands in *res. Returns a cudaError_t: 0, or the reason the launch was
// refused.
extern "C" int heat_h_band_fix_3d(const HeatHBandEntry* entries, int count,
                                  int load, uint32_t* res, int64_t nx,
                                  int64_t ny, int64_t nz, int64_t bx,
                                  int64_t by, int64_t bz, int hy, int hz,
                                  int k, int block_x, int block_y, int rows,
                                  int prefetch, float a0, float cx, float cy,
                                  float cz, void* stream) {
  return heat_hb_launch(kHeatHBand, 4, entries, count, load, res, nx, ny, nz,
                        bx, by, bz, hy, hz, k, block_x, block_y, rows,
                        prefetch, a0, cx, cy, cz, stream);
}

extern "C" const char* heat_h_band_fix_3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
