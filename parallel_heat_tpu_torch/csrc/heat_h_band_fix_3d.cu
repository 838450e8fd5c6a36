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
// The load (HeatHBandSeg::load): input plane t of a block comes from u
// for t in [0, bx), from xlo or xhi outside (y and z circular, [u | hi |
// lo]); inside a plane of u, a row of the block comes from u and, past
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

#include "heat_temporal3d.cuh"

// One block of the launch: its pieces as heat_h.cuh lays them out (zt,
// yt null along an unsharded axis), the bulk's output it writes the
// bands into, and its origin in the grid (72 bytes;
// ops/stencil_kernels_block_3d.py _BandEntry3D is the same layout).
struct HeatHBandEntry {
  const float* u;
  const float* zt;
  const float* yt;
  const float* xlo;
  const float* xhi;
  float* out;
  int64_t ox, oy, oz;
};

// The blocks a launch takes: 48 entries keep the kernel's parameters
// under 4 KB (ops/stencil_kernels_block_3d.py BAND_TABLE_3D).
constexpr int kHeatHBandTable = 48;
struct HeatHBandTable {
  HeatHBandEntry e[kHeatHBandTable];
};

// What every block of a launch shares: the grid, the block's shape and
// halos (hx = K), the tile grid, the ring's planes in flight, whether
// every output (vec_out) and every block (vec_in) is 16-byte aligned
// with bz % 4 == 0.
struct HeatHBandArgs {
  uint32_t* res;
  int64_t nx, ny, nz, bx, by, bz, tiles_z, tiles_y;
  int hy, hz, prefetch, vec_out, vec_in;
  float a0, cx, cy, cz;
};

// The loads (ops/stencil_kernels_block_3d.py BAND_LOADS_3D).
enum HeatHBandLoad { kHeatHBandCells = 0, kHeatHBandVec = 1 };

// A thread block's segment g of the launch: entry g / 2's region g % 2
// (output planes [0, K) or [bx-K, bx)). HeatFLoop::run_band has it set
// the loop's output state (enter) and load each input plane (load). Per
// thread it holds only the tile's place: its first row row0 and first
// cell cell0 (block-local), and the lane's masks; the pieces come from the
// table and the geometry from the launch's arguments (both kernel
// parameters, read from the constant bank), and each row's piece and
// offset are worked out as a plane is loaded, a few integer operations a
// row, so that they cost the plane loop no registers. load() hides the
// segment and the place from the compiler at each plane: left in sight,
// they are loop-invariant, and it holds the entry and every row's offsets
// in registers across the loop instead (<3, 2, 1> spilled 248 bytes, 212
// with only the segment hidden, none with both; ptxas).
template <int K, int R, int kLoad>
struct HeatHBandSeg {
  const HeatHBandTable& table;
  const HeatHBandArgs& a;
  int g;
  int row0, cell0;
  // Bit j: the lane's cell j lies in the K-deep frame along Z (zfr), past
  // the block along Z (zsel); bit 8: its four cells are one 16-byte run
  // of the block (kHeatHBandVec copies such a row whole).
  unsigned mask;

  // Input plane i in [0, 3K) of the segment, this thread's R rows into
  // dst (row r at dst + r * kFWidth): from the block for a block-local
  // plane l in [0, bx), row by row from u, the z tail (past bz or below
  // 0) or the y tail (past by or below 0, z circular); from an x slab
  // outside (y and z circular); zeros past the K-deep frame and outside
  // the grid's planes.
  __device__ __forceinline__ void load(float* dst, int i) const {
    int g = this->g, ly0 = row0, lz0 = cell0;
    unsigned masks = mask;
    asm volatile("" : "+r"(g), "+r"(ly0), "+r"(lz0), "+r"(masks));
    const HeatHBandEntry& e = table.e[g >> 1];
    const int64_t l = ((g & 1) ? a.bx - 2 * K : -K) + i;
    const int64_t t = e.ox + l;
    const int k2 = 2 * K;
    const int ze = static_cast<int>(a.bz) + 2 * a.hz;
    const int zc0 = lz0 < 0 ? lz0 + ze : lz0;  // circular z
    const unsigned zfr = masks & 0xfu, zsel = (masks >> 4) & 0xfu;
    if (l >= 0 && l < a.bx) {
      const float* pu = e.u + l * (a.by * a.bz);
      const float* pz = e.zt + l * (a.by * k2);
      const float* py = e.yt + l * (k2 * ze);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ly = ly0 + r;
        const bool in_u = ly >= 0 && ly < a.by;
        const unsigned in = ly >= -a.hy && ly < a.by + a.hy ? zfr : 0u;
        if (kLoad == kHeatHBandVec && in_u && (masks >> 8)) {
          __pipeline_memcpy_async(
              reinterpret_cast<float4*>(dst + r * kFWidth),
              reinterpret_cast<const float4*>(pu + (ly * a.bz + lz0)), 16);
          continue;
        }
        const float* row =
            in_u ? pu + (ly * a.bz + lz0)
                 : py + ((ly >= a.by ? ly - a.by : ly + k2) * ze + zc0);
        const float* zrow =
            pz + (ly * k2 + (lz0 < 0 ? lz0 + k2 : lz0 - a.bz));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool cell_in = (in >> c) & 1u;
          const float* q = in_u && ((zsel >> c) & 1u) ? zrow + c : row + c;
          __pipeline_memcpy_async(dst + r * kFWidth + c, cell_in ? q : e.u,
                                  4, cell_in ? 0 : 4);
        }
      }
    } else {
      const bool t_in = t >= 0 && t < a.nx && l >= -K && l < a.bx + K;
      const int ye = static_cast<int>(a.by) + 2 * a.hy;
      const float* slab = (l < 0 ? e.xlo + (l + K) * (ye * ze)
                                 : e.xhi + (l - a.bx) * (ye * ze)) +
                          zc0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ly = ly0 + r;
        const unsigned in =
            t_in && ly >= -a.hy && ly < a.by + a.hy ? zfr : 0u;
        const float* row = slab + (ly < 0 ? ly + ye : ly) * ze;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool cell_in = (in >> c) & 1u;
          __pipeline_memcpy_async(dst + r * kFWidth + c,
                                  cell_in ? row + c : e.u, 4,
                                  cell_in ? 0 : 4);
        }
      }
    }
  }

  // The segment's output state: its block's output, origin and region.
  template <class Loop>
  __device__ __forceinline__ void enter(Loop& f) const {
    const HeatHBandEntry& e = table.e[g >> 1];
    f.out = e.out;
    f.x0 = e.ox + ((g & 1) ? a.bx - K : 0);
    f.x1 = f.x0 + K;
    f.src = static_cast<int64_t>(row0) * a.bz + cell0 - e.ox * f.plane;
    unsigned zin = 0u, yin = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t gz = e.oz + cell0 + c;
      zin |= static_cast<unsigned>(gz >= 1 && gz <= a.nz - 2) << c;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t gy = e.oy + row0 + r;
      yin |= static_cast<unsigned>(gy >= 1 && gy <= a.ny - 2) << r;
    }
    f.zin = zin;
    f.yin = yin;
  }
};

// One thread block's tile (extended tile's first row y0, first cell z0,
// block-local) of segment g.
template <int K, int R, int kLoad>
__device__ __forceinline__ void heat_hb_tile(const HeatHBandTable& table,
                                             const HeatHBandArgs& a, int g,
                                             int y0, int z0) {
  extern __shared__ __align__(128) float smem[];
  using Loop = HeatFLoop<K, R, false, kHeatFFull, false, kHeatFBand>;
  constexpr int P = heat_f_pad(K);
  constexpr int E = Loop::kEdgeRows;
  const int lane = threadIdx.x, w = threadIdx.y, warps = blockDim.y;
  const int wy = warps * R;     // extended tile rows
  const int lz0 = z0 + 4 * lane;  // this lane's first cell
  const int ly0 = y0 + w * R;     // this thread's first row
  // The lane's cells along Z: in the K-deep frame (zfr), past the block
  // (zsel: from the z tail in the block's rows), all four one 16-byte
  // run of the block (kHeatHBandVec). The lane's cells lie all below 0
  // or none (lz0 is a multiple of 4). Past the frame, and along an
  // unsharded axis past the block (outside the grid), a cell is zero.
  // (The pieces hold zeros where a block has no neighbour, and no value
  // outside the grid reaches an output: only the Dirichlet faces read
  // it, and they are copied.)
  unsigned zfr = 0u, zsel = 0u, zout = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int lz = lz0 + c;
    const int cell = 4 * lane + c;
    zfr |= static_cast<unsigned>(lz >= -a.hz && lz < a.bz + a.hz) << c;
    zsel |= static_cast<unsigned>(lz < 0 || lz >= a.bz) << c;
    zout |= static_cast<unsigned>(cell >= P && cell < kFWidth - P &&
                                  lz < a.bz)
            << c;
  }
  const bool vec = a.vec_in != 0 && lz0 >= 0 && lz0 + 4 <= a.bz;
  const HeatHBandSeg<K, R, kLoad> seg{
      table, a, g, ly0, lz0,
      zfr | zsel << 4 | static_cast<unsigned>(vec) << 8};

  Loop f;
  // The loop's planes are global (its interior test reads them); output
  // plane t of a block lands at out + (t - ox) * plane, rows of bz (enter
  // sets out, src, x0, x1 and the interior masks).
  f.nx = a.nx;
  f.nz = a.bz;
  f.plane = a.by * a.bz;
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
  f.zout = zout;
  f.yout = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = w * R + r;
    f.yout |= static_cast<unsigned>(row >= K && row < wy - K &&
                                    ly0 + r < a.by)
              << r;
  }
  f.has_out = f.yout != 0u && f.zout != 0u;
  f.cur = 0;
  f.lap = 0u;
  f.rmax = 0u;
  if (f.leader) {
    for (int i = 0; i < f.slots; ++i)
      heat_mbar_init_count(&f.full[i], kFLanes * warps);
    heat_mbar_init_fence();
  }
  __syncthreads();
  // Does the extended tile reach past the global interior? Uniform across
  // the thread block.
  const HeatHBandEntry& e = table.e[g >> 1];
  const int64_t gy0 = e.oy + y0, gz0 = e.oz + z0;
  if (gy0 < 1 || gy0 + wy > a.ny - 1 || gz0 < 1 || gz0 + kFWidth > a.nz - 1)
    f.template run_band<true>(seg);
  else
    f.template run_band<false>(seg);
  if (a.res != nullptr) heat_block_max(f.rmax, a.res);
}

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

using HeatHBandKernel = void (*)(const HeatHBandTable, const HeatHBandArgs);

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

// Does the 16-byte load take these blocks: rows of a multiple of 4 floats
// and every block 16-byte aligned (ops/hopper_params.py h_band_vec_fits
// is the geometry's half)?
static bool heat_hb_aligned(const HeatHBandEntry* entries, int count,
                            int64_t bz, bool outs) {
  if (bz % 4 != 0) return false;
  for (int i = 0; i < count; ++i) {
    const void* p = outs ? static_cast<const void*>(entries[i].out)
                         : static_cast<const void*>(entries[i].u);
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

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
  const auto halo_ok = [k](int h) { return h == 0 || h == k; };
  const int64_t ye = by + 2 * hy, ze = bz + 2 * hz;
  if (entries == nullptr || count < 1 || nx < 3 || ny < 3 || nz < 3 ||
      k < 1 || k > kFMaxK || bx < 2 * k || by < 1 || bz < 1 ||
      bx > nx || by > ny || bz > nz || !halo_ok(hy) || !halo_ok(hz) ||
      ye * ze > 0x7fffffffLL || by * bz > 0x7fffffffLL ||
      load < -1 || load > kHeatHBandVec ||
      !heat_f_takes(block_x, block_y, rows, k) || rows == 1 ||
      prefetch < 1 || prefetch > kFMaxPrefetch)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    const HeatHBandEntry& e = entries[i];
    if (e.u == nullptr || e.xlo == nullptr || e.xhi == nullptr ||
        e.out == nullptr || static_cast<const void*>(e.u) == e.out ||
        (hz != 0) != (e.zt != nullptr) || (hy != 0) != (e.yt != nullptr) ||
        e.ox < 0 || e.oy < 0 || e.oz < 0 || e.ox + bx > nx ||
        e.oy + by > ny || e.oz + bz > nz)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_in = heat_hb_aligned(entries, count, bz, false);
  if (load < 0) load = vec_in ? kHeatHBandVec : kHeatHBandCells;
  if (load == kHeatHBandVec && !vec_in)
    return static_cast<int>(cudaErrorInvalidValue);
  HeatHBandArgs a;
  a.res = res;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.bx = bx;
  a.by = by;
  a.bz = bz;
  a.hy = hy;
  a.hz = hz;
  a.prefetch = prefetch;
  a.vec_out = heat_hb_aligned(entries, count, bz, true);
  a.vec_in = vec_in;
  a.a0 = a0;
  a.cx = cx;
  a.cy = cy;
  a.cz = cz;
  const HeatHBandKernel kernel =
      kHeatHBand[load == kHeatHBandVec][rows == 4][k - 1];
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch);
  const int wy = block_y * rows;
  a.tiles_z = (bz + kFWidth - 2 * heat_f_pad(k) - 1) /
              (kFWidth - 2 * heat_f_pad(k));
  a.tiles_y = (by + wy - 2 * k - 1) / (wy - 2 * k);
  if (a.tiles_z * a.tiles_y > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  HeatHBandTable table{};
  for (int first = 0; first < count; first += kHeatHBandTable) {
    const int blocks =
        count - first < kHeatHBandTable ? count - first : kHeatHBandTable;
    for (int i = 0; i < blocks; ++i) table.e[i] = entries[first + i];
    // A thread block a (Y, Z) tile of a segment (a block's region).
    const dim3 grid(static_cast<unsigned>(a.tiles_z * a.tiles_y),
                    2 * blocks);
    kernel<<<grid, dim3(block_x, block_y), smem, s>>>(table, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* heat_h_band_fix_3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
