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

#include "heat_temporal3d.cuh"

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
  extern __shared__ __align__(128) float smem[];
  constexpr int P = heat_f_pad(K);
  constexpr int E = HeatFLoop<K, R, kTma>::kEdgeRows;
  const int lane = threadIdx.x, w = threadIdx.y, warps = blockDim.y;
  const int wy = warps * R;  // extended tile rows
  const int64_t b = blockIdx.x;
  const int64_t tz = b % tiles_z;
  const int64_t ty = (b / tiles_z) % tiles_y;
  const int64_t x0 = b / tiles_z / tiles_y * seg;
  const int64_t z0 = tz * (kFWidth - 2 * P) - P;
  const int64_t y0 = ty * (wy - 2 * K) - K;
  const int64_t gz0 = z0 + 4 * lane;  // this lane's first cell
  const int64_t gy0 = y0 + w * R;     // this thread's first row

  HeatFLoop<K, R, kTma> f;
  f.u = u;
  f.map = &umap;
  f.out = out;
  f.nx = nx;
  f.nz = nz;
  f.plane = ny * nz;
  f.x0 = x0;
  f.x1 = x0 + seg < nx ? x0 + seg : nx;
  f.z0 = static_cast<int>(z0);
  f.y0 = static_cast<int>(y0);
  f.a0 = a0;
  f.cx = cx;
  f.cy = cy;
  f.cz = cz;
  f.vec_out = vec_out != 0;
  f.leader = lane == 0 && w == 0;
  f.slots = prefetch + 2;
  f.prefetch = prefetch;
  f.slot_f = heat_f_slot_floats(wy);
  f.edge_f = heat_f_edge_floats(warps, R);
  // The ring from the first 128-byte boundary (the boxes' alignment), the
  // level buffers, the mbarriers. An offset into smem, not an address
  // rounded as an integer, so that the pointers stay shared ones.
  f.ring = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  f.lev = f.ring + f.slots * f.slot_f;
  f.full = reinterpret_cast<uint64_t*>(f.lev + 2 * (K - 1) * f.edge_f);
  f.own = (1 + w * R) * kFWidth + 4 * lane;
  f.lev_first = (1 + E * w) * kFWidth + 4 * lane;
  f.lev_last = f.lev_first + (E - 1) * kFWidth;
  f.lev_up = E * w * kFWidth + 4 * lane;
  f.lev_dn = (1 + E * (w + 1)) * kFWidth + 4 * lane;
  f.src = gy0 * nz + gz0;
  f.cin = f.yin = f.zin = f.yout = f.zout = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t gz = gz0 + j;
    const int c = 4 * lane + j;
    f.zin |= static_cast<unsigned>(gz >= 1 && gz <= nz - 2) << j;
    f.zout |= static_cast<unsigned>(c >= P && c < kFWidth - P && gz < nz)
              << j;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t gy = gy0 + r;
    const int row = w * R + r;
    f.yin |= static_cast<unsigned>(gy >= 1 && gy <= ny - 2) << r;
    f.yout |= static_cast<unsigned>(row >= K && row < wy - K && gy < ny)
              << r;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f.cin |= static_cast<unsigned>(gy >= 0 && gy < ny && gz0 + j >= 0 &&
                                     gz0 + j < nz)
               << (4 * r + j);
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
  if (y0 < 1 || y0 + wy > ny - 1 || z0 < 1 || z0 + kFWidth > nz - 1)
    f.template run<true>();
  else
    f.template run<false>();
  if (res != nullptr) heat_block_max(f.rmax, res);
}

using HeatFKernel = void (*)(const float*, float*, uint32_t*, int64_t,
                             int64_t, int64_t, int64_t, int64_t, int, int,
                             int, float, float, float, float,
                             const CUtensorMap);

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
  if (nx < 3 || ny < 3 || nz < 3 || seg < 1 || prefetch < 1 ||
      prefetch > kFMaxPrefetch || !heat_f_takes(block_x, block_y, rows, k) ||
      nx > 0x7fffffffLL || ny > 0x7fffffffLL || nz > 0x7fffffffLL ||
      (tma && (nz % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wy = block_y * rows;
  const int tile_z = kFWidth - 2 * heat_f_pad(k);
  const int64_t tiles_z = (nz + tile_z - 1) / tile_z;
  const int64_t tiles_y = (ny + wy - 2 * k - 1) / (wy - 2 * k);
  const int64_t blocks = tiles_z * tiles_y * ((nx + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map = {};
  if (tma) {
    const int err = heat_tma_encode_3d(&map, u, nx, ny, nz, kFWidth, wy);
    if (err != 0) return err;
  }
  const HeatFKernel kernel = heat_f_pick(k, rows, tma);
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_out =
      nz % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), dim3(block_x, block_y), smem, s>>>(
      u, out, res, nx, ny, nz, tiles_z, tiles_y, seg, prefetch, vec_out, a0,
      cx, cy, cz, map);
  return static_cast<int>(cudaGetLastError());
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
