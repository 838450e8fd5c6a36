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

#include "heat_temporal3d.cuh"

// The launch's arguments: the block's geometry in the grid, the circular
// block's (ye = by + 2hy, ze = bz + 2hz, rows of `pitch` floats), the
// tile grid and X segment, the ring's planes in flight, the load.
struct HeatHcArgs {
  const float* ext;
  float* out;
  uint32_t* res;
  int64_t nx, ny, nz, bx, by, bz, ox, oy, oz;
  int64_t ye, ze, pitch, tiles_z, tiles_y, seg;
  int hx, hy, hz, prefetch, tma, vec_out;
  float a0, cx, cy, cz;
};

// One thread block's tile (extended tile's first row y0, first cell z0,
// block-local) and segment [x0, x0 + seg) of output planes, under the
// box load (kTma) or the per-cell one.
template <int K, int R, bool kTma>
__device__ __forceinline__ void heat_hc_tile(const HeatHcArgs a,
                                             const CUtensorMap* emap,
                                             int64_t x0, int64_t y0,
                                             int64_t z0) {
  extern __shared__ __align__(128) float smem[];
  using Loop = HeatFLoop<K, R, kTma, kHeatFFull, true>;
  constexpr int P = heat_f_pad(K);
  constexpr int E = Loop::kEdgeRows;
  const int lane = threadIdx.x, w = threadIdx.y, warps = blockDim.y;
  const int wy = warps * R;            // extended tile rows
  const int64_t lz0 = z0 + 4 * lane;   // this lane's first cell
  const int64_t ly0 = y0 + w * R;      // this thread's first row

  Loop f;
  f.u = a.ext;
  f.map = emap;
  f.out = a.out;
  // The loop's planes are global (its interior test reads them); output
  // plane t of the block lands at out + (t - ox) * plane, rows of bz.
  f.nx = a.nx;
  f.nz = a.bz;
  f.plane = a.by * a.bz;
  f.x0 = a.ox + x0;
  f.x1 = a.ox + (x0 + a.seg < a.bx ? x0 + a.seg : a.bx);
  f.z0 = static_cast<int>(z0);
  f.y0 = static_cast<int>(y0);
  f.a0 = a.a0;
  f.cx = a.cx;
  f.cy = a.cy;
  f.cz = a.cz;
  f.vec_out = a.vec_out != 0;
  f.leader = lane == 0 && w == 0;
  f.slots = a.prefetch + 2;
  f.prefetch = a.prefetch;
  f.slot_f = heat_f_slot_floats(wy);
  f.edge_f = heat_f_edge_floats(warps, R);
  // As in F: the ring from the first 128-byte boundary, the level
  // buffers, the mbarriers.
  f.ring = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  f.lev = f.ring + f.slots * f.slot_f;
  f.full = reinterpret_cast<uint64_t*>(f.lev + 2 * (K - 1) * f.edge_f);
  f.own = (1 + w * R) * kFWidth + 4 * lane;
  f.lev_first = (1 + E * w) * kFWidth + 4 * lane;
  f.lev_last = f.lev_first + (E - 1) * kFWidth;
  f.lev_up = E * w * kFWidth + 4 * lane;
  f.lev_dn = (1 + E * (w + 1)) * kFWidth + 4 * lane;
  f.src = ly0 * a.bz + lz0 - a.ox * f.plane;
  f.xsh = a.hx - a.ox;
  f.ext_x = a.bx + 2 * a.hx;
  f.xpitch = a.ye * a.pitch;
  // The lane's cells in the circular z order: all four below 0, or none.
  const int64_t zc0 = lz0 < 0 ? lz0 + a.ze : lz0;
  f.cin = f.yin = f.zin = f.yout = f.zout = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t gz = a.oz + lz0 + j;
    const int c = 4 * lane + j;
    f.zin |= static_cast<unsigned>(gz >= 1 && gz <= a.nz - 2) << j;
    f.zout |= static_cast<unsigned>(c >= P && c < kFWidth - P &&
                                    lz0 + j < a.bz)
              << j;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t ly = ly0 + r;
    const int64_t gy = a.oy + ly;
    const int row = w * R + r;
    f.yin |= static_cast<unsigned>(gy >= 1 && gy <= a.ny - 2) << r;
    f.yout |= static_cast<unsigned>(row >= K && row < wy - K && ly < a.by)
              << r;
    f.coff[r] = static_cast<int32_t>((ly < 0 ? ly + a.ye : ly) * a.pitch +
                                     zc0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t lz = lz0 + j;
      f.cin |= static_cast<unsigned>(ly >= -a.hy && ly < a.by + a.hy &&
                                     lz >= -a.hz && lz < a.bz + a.hz)
               << (4 * r + j);
    }
  }
  f.has_out = f.yout != 0u && f.zout != 0u;
  f.box_bytes = static_cast<uint32_t>(sizeof(float) * kFWidth * wy);
  f.cur = 0;
  f.lap = 0u;
  f.rmax = 0u;
  if (f.leader) {
    for (int i = 0; i < f.slots; ++i)
      heat_mbar_init_count(&f.full[i], kTma ? 1u : kFLanes * warps);
    heat_mbar_init_fence();
  }
  __syncthreads();
  // Does the extended tile reach past the global interior? Uniform across
  // the block.
  const int64_t gy0 = a.oy + y0, gz0 = a.oz + z0;
  if (gy0 < 1 || gy0 + wy > a.ny - 1 || gz0 < 1 || gz0 + kFWidth > a.nz - 1)
    f.template run<true>();
  else
    f.template run<false>();
  if (a.res != nullptr) heat_block_max(f.rmax, a.res);
}

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
  const HeatHcKernel kernel = heat_hc_pick(k, rows);
  const auto halo_ok = [k](int h) { return h == 0 || h == k; };
  const int64_t ye = by + 2 * hy, ze = bz + 2 * hz, ext_x = bx + 2 * hx;
  if (kernel == nullptr || ext == nullptr || out == nullptr ||
      static_cast<const void*>(ext) == static_cast<const void*>(out) ||
      nx < 3 || ny < 3 || nz < 3 || bx < 1 || by < 1 || bz < 1 || ox < 0 ||
      oy < 0 || oz < 0 || ox + bx > nx || oy + by > ny || oz + bz > nz ||
      !halo_ok(hx) || !halo_ok(hy) || !halo_ok(hz) || pitch < ze ||
      ye * pitch > 0x7fffffffLL || ext_x > 0x7fffffffLL || seg < 1 ||
      prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(block_x, block_y, rows, k) ||
      (tma && (pitch % 4 != 0 || reinterpret_cast<uintptr_t>(ext) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wy = block_y * rows;
  const int tile_z = kFWidth - 2 * heat_f_pad(k);
  HeatHcArgs a;
  a.ext = ext;
  a.out = out;
  a.res = res;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.bx = bx;
  a.by = by;
  a.bz = bz;
  a.ox = ox;
  a.oy = oy;
  a.oz = oz;
  a.ye = ye;
  a.ze = ze;
  a.pitch = pitch;
  a.tiles_z = (bz + tile_z - 1) / tile_z;
  a.tiles_y = (by + wy - 2 * k - 1) / (wy - 2 * k);
  a.seg = seg;
  a.hx = hx;
  a.hy = hy;
  a.hz = hz;
  a.prefetch = prefetch;
  a.tma = tma != 0;
  a.vec_out = bz % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.a0 = a0;
  a.cx = cx;
  a.cy = cy;
  a.cz = cz;
  const int64_t blocks = a.tiles_z * a.tiles_y * ((bx + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map = {};
  if (tma) {
    // The circular block, innermost z first: ze cells a row at `pitch`,
    // ye rows a plane, ext_x planes; a box is a plane of the extended
    // tile, 128 cells by wy rows.
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ze),
                                static_cast<cuuint64_t>(ye),
                                static_cast<cuuint64_t>(ext_x)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch) * 4,
                                   static_cast<cuuint64_t>(ye * pitch) * 4};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kFWidth),
                               static_cast<cuuint32_t>(wy), 1};
    const int err = heat_tma_encode(&map, ext, 3, dims, strides, box);
    if (err != 0) return err;
  }
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(block_x, block_y), smem, s>>>(
      a, map);
  return static_cast<int>(cudaGetLastError());
}

// Thread blocks of the (k, rows) instance that one SM holds at once under
// thread blocks of 32 x block_y threads and `prefetch` planes in flight,
// into *blocks (the CUDA occupancy calculator, registers included).
// Returns a cudaError_t.
extern "C" int heat_h_block_3d_occupancy(int k, int block_y, int rows,
                                         int prefetch, int* blocks) {
  if (blocks == nullptr || prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(kFLanes, block_y, rows, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeatHcKernel kernel = heat_hc_pick(k, rows);
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kFLanes * block_y, smem));
}

extern "C" const char* heat_h_block_3d_error_string(int code) {
  return heat_tma_error_string(code);
}
