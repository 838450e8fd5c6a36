// heat_h_block_3d — K 7-point Jacobi steps on one block of a sharded 3D
// grid, read from the block assembled with its K-deep halo in one
// buffer, with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_3d (pallas_call name "heat_h_block_3d", defined
// at :4353, call :4539).
//
// Bound on the H100: the circular block read once and the block written
// once, 4 * ((bx+2hx)(by+2hy)(bz+2hz) + bx*by*bz) bytes; at a 512^3
// block and K = 3, 0.326 ms at 3.35 TB/s against 0.060 ms for the
// operations (10 a cell-step), so bytes bound it, as they bound kernel F.
// It runs only when pinned (tune site block_temporal_3d, choice "H"): its
// caller assembles the circular block in HBM, one more read and write of
// the block a round than the fused form's.
//
// Design. The TPU kernel streams the circular block's x planes through
// VMEM. Here kernel F's register-blocked plane loop (heat_temporal3d.cuh
// HeatFLoop) runs on the block: a lane owns 4 adjacent z cells of R rows
// in float4 registers, Z neighbours by warp shuffle, Y and X neighbours
// in registers, one block barrier a plane, the plane loop unrolled by 3,
// so the arithmetic, and the bits, are F's. What is H's is the geometry:
//   - the (Y, Z) tiles cover the block, not the grid, F's extended tile
//     of W R rows by 128 cells, output rows [K, W R - K) and cells
//     [P, 128 - P), P = heat_f_pad(K); a thread block also takes a
//     segment of x planes, as in F. The interior test and the output's
//     offsets use the block's global origin (ox, oy, oz), int64;
//   - the input is the JAX package's circular block (parallel/
//     temporal3d.py assemble_circular): x in the natural order [lo | u |
//     hi] (plane t of the block is plane t + hx), y and z in the order
//     [u | hi | lo]; a halo only on the sharded axes (hx, hy, hz each K
//     or 0). Its rows may be padded: `pitch` floats a row, at least
//     bz + 2hz (parallel/temporal3d.py allocates it rounded up to 4, so
//     that a tensor map can be encoded over it).
// The load. A tile whose extended tile starts at y >= 0 and z >= 0 (or
// at negative y or z along an unsharded axis, whose cells there lie
// outside the grid) finds its cells where a tensor map of the circular
// block puts them: one TMA box of 128 x W R cells a plane, as F's tiles
// take theirs, zeros past the block. Cells past u | hi land from the lo
// piece or as zeros, which is no matter: they lie K or more cells past
// the block, outside the K-step cone of every output, or outside the
// grid, and cells outside the grid are never read by a computed cell.
// A tile that starts at y < 0 or z < 0 along a sharded axis, the first
// row or column of tiles, needs the lo piece, which sits at the far end
// of the row or plane: it loads by HeatFLoop's per-cell cp.async, 4 bytes
// a cell, each row's source offset fixed for the run (the circular y of
// the row and the circular z of the lane's 4 cells, which share a sign:
// a lane's first cell is a multiple of 4), zeros outside the K-deep frame
// and past the planes. A box split into pieces (the lo strip and the
// rest) was not taken: a box lands with its own row pitch, so a z strip
// would be a box a row. Where the rows are not multiples of 16 bytes
// (pitch % 4 != 0) or the block is not 16-byte aligned, every tile loads
// by cp.async; the caller chooses (tma), and a TMA load the geometry
// refuses is refused, never replaced. Both loads give the same bits. The
// two loads are two copies of the plane loop in one instance, chosen per
// thread block; one copy with the load a branch of its fetch took 119
// registers against 128 and 4% less time at the 512^3 block, but faulted
// (illegal address) at K = 8 on the card, where its instance spills
// (PERF.md), so it was not kept.
// Cells outside the global interior are copied, never computed, and every
// step rounds to float32 like a launch of heat_d_step3d: H(K) is bitwise
// F(K) on the same cells. No tensor core computes: every cell-step rounds
// each float32 operation in the plain version's order (SEMANTICS.md),
// which no wgmma form keeps.

// The bfloat16 form, on the same tiles and loop: heat_h_block_3d_bf16.cu.

#include "heat_hc.cuh"

// One block: the (Y, Z) tile and the X segment of blockIdx.x; blockDim is
// (32, W). With tma, a tile that needs no lo cell takes the box load.
template <int K, int R>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(R))
    heat_h_block_3d_kernel(const HeatHcArgs a,
                           const __grid_constant__ CUtensorMap emap) {
  constexpr int P = heat_f_pad(K);
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

using HeatHcKernel = void (*)(const HeatHcArgs, const CUtensorMap);

// kHeatHc[r][k - 1]: depth k, rows per thread 1 << r.
#define HEAT_HC_DEPTHS(R)                                                    \
  {heat_h_block_3d_kernel<1, R>, heat_h_block_3d_kernel<2, R>,               \
   heat_h_block_3d_kernel<3, R>, heat_h_block_3d_kernel<4, R>,               \
   heat_h_block_3d_kernel<5, R>, heat_h_block_3d_kernel<6, R>,               \
   heat_h_block_3d_kernel<7, R>, heat_h_block_3d_kernel<8, R>}
static const HeatHcKernel kHeatHc[3][kFMaxK] = {
    HEAT_HC_DEPTHS(1), HEAT_HC_DEPTHS(2), HEAT_HC_DEPTHS(4)};
#undef HEAT_HC_DEPTHS

// The instance of (k, rows), or null where none is compiled.
static HeatHcKernel heat_hc_pick(int k, int rows) {
  const int r = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
  return r < 0 || k < 1 || k > kFMaxK ? nullptr : kHeatHc[r][k - 1];
}

// K steps of the bx x by x bz block at (ox, oy, oz) of the nx x ny x nz
// grid into `out` (bx x by x bz, contiguous, distinct from ext), from
// `ext`, the (bx+2hx) x (by+2hy) x (bz+2hz) circular block with rows of
// `pitch` floats (pitch >= bz+2hz) and planes of (by+2hy) rows; hx, hy,
// hz are each k (axis sharded) or 0 (the block spans the grid along it).
// Thread blocks of block_x x block_y threads of `rows` rows each
// (heat_f_takes), over segments of `seg` X planes, `prefetch` planes in
// flight (1 .. kFMaxPrefetch). tma: the tiles that need no lo cell load
// each plane as one TMA box, which needs pitch % 4 == 0 and ext 16-byte
// aligned; else every tile by cp.async. With `res` non-null the residual
// lands in *res. Launches on `stream` and does not synchronise. Returns a
// cudaError_t: 0, or the reason the launch was refused; or a tensor-map
// encoding error (heat_h_block_3d_error_string).
extern "C" int heat_h_block_3d(const float* ext, float* out, uint32_t* res,
                               int64_t nx, int64_t ny, int64_t nz,
                               int64_t bx, int64_t by, int64_t bz,
                               int64_t ox, int64_t oy, int64_t oz, int hx,
                               int hy, int hz, int64_t pitch, int k,
                               int block_x, int block_y, int rows,
                               int64_t seg, int prefetch, int tma, float a0,
                               float cx, float cy, float cz, void* stream) {
  return heat_hc_launch(heat_hc_pick(k, rows), ext, out, res, nx, ny, nz,
                        bx, by, bz, ox, oy, oz, hx, hy, hz, pitch, k, block_x,
                        block_y, rows, seg, prefetch, tma, a0, cx, cy, cz,
                        stream);
}

// Thread blocks of the (k, rows) instance that one SM holds at once under
// thread blocks of 32 x block_y threads and `prefetch` planes in flight,
// into *blocks (the CUDA occupancy calculator, registers included).
// Returns a cudaError_t.
extern "C" int heat_h_block_3d_occupancy(int k, int block_y, int rows,
                                         int prefetch, int* blocks) {
  return heat_hc_occupancy(heat_hc_pick(k, rows), 4, k, block_y, rows,
                           prefetch, blocks);
}

extern "C" const char* heat_h_block_3d_error_string(int code) {
  return heat_tma_error_string(code);
}
