// Shared code of the sharded 3D block kernels heat_h_block_3d.cu,
// heat_h_block_3d_fused.cu and heat_h_band_fix_3d.cu: K 7-point Jacobi
// steps on one bx x by x bz block of an nx x ny x nz grid cut over a
// device mesh, from the block and the K-deep halo its neighbours sent
// (parallel/temporal3d.py), with the residual of the last step.
//
// Replaces the kernel-H family of parallel_heat_tpu/ops/pallas_stencil.py
// (_build_temporal_block_3d, _build_temporal_block_3d_fused,
// _build_band_fix_3d). Each TPU builder keeps its own entry point here.
//
// Bound on the H100: a round reads the block once and writes it once for
// K steps, plus the exchanged pieces, 4 * (2K*bx*by + 2K*bx*(bz+2hz) +
// 2K*(by+2hy)*(bz+2hz)) bytes a block; at a 512^3 block and K = 3 the
// bytes need 0.32 ms and the operations (10 a cell-step) 0.060 ms, so
// bytes bound it, as they bound kernel F. What the tiles really move, and
// the instruction issue of the shared-memory step loop below that, are
// F's (heat_f_temporal3d.cu): the family runs F's step phase line for
// line (heat_temporal3d.cuh). Across the mesh a block also recomputes the
// K-deep frame that its neighbours own, under 4% of a 512^3 block at
// K = 3.
//
// Design. A thread block owns a (Y, Z) tile of the block's output cells
// plus a K-deep halo on its four sides, and a segment of output planes,
// exactly as in F; the tile grid covers the block, not the global grid.
// What is new is the load: each input plane's extended tile is gathered
// in global coordinates (origin ox, oy, oz of the block's cell (0, 0),
// int64) from
//   - u, the block, for its own cells;
//   - ztail = [hi | lo] (bx x by x 2K) for z in [bz, bz+K) and [-K, 0);
//   - ytail (bx x 2K x Ze, Ze = bz + 2hz), the y neighbours' rows of
//     their z-extended blocks [u | ztail], hi then lo, so the y-z edges
//     ride in it;
//   - xlo / xhi (K x Ye x Ze, Ye = by + 2hy), the x neighbours' planes of
//     their y- and z-extended blocks, corners included; their y and z
//     axes in the circular order [u | hi | lo];
//   - zero outside the global grid, and beyond the block's K-deep frame
//     (a ragged last tile reaches past it; those cells are K or more
//     cells from any output and never reach one in K steps).
// A tile whose extended (Y, Z) tile lies inside the block loads a plane
// as F does, one run per row; the piece of a cell is chosen, per cell
// and plane, only in the tiles at the block's (Y, Z) edges, and the two
// kinds of tile run two copies of the step loop. (With both loads in one
// loop H-fused took 1.30 ms where F takes 0.90 at a 512^3 block and
// K = 3: PERF.md.)
// An unsharded axis (the block spans the grid along it) has no halo: its
// cells past the block lie outside the grid. The assembled form reads one
// buffer, the JAX package's circular block: x in the order [lo | u | hi],
// y and z [u | hi | lo] (parallel/temporal3d.py assembles it). Cells
// outside the global interior are copied, so H(K) is bitwise F(K) on the
// same cells and no re-pin epilogue is needed. The deferred bulk (no x
// pieces) writes only output planes [K, bx-K), whose K-step cone stays
// inside the block in x; the band kernel writes planes [0, K) and
// [bx-K, bx), from input planes [-K, 2K) and [bx-2K, bx+K), into the
// bulk's output in place. Each counts the residual of exactly the planes
// it writes, so max(bulk, band) is the monolithic kernel's residual.

#pragma once

#include "heat_temporal3d.cuh"

enum HeatHLayout { kHeatHPieces = 0, kHeatHCircular = 1 };

// The parameters of every H kernel, and their names: each entry point
// defines its own __global__ function (so a profile names it) whose body
// is heat_h_body with its layout. Regions (blockIdx.y) start at output
// planes r_begin0 and r_begin1, `rows` planes each, cut into segments
// of `seg` planes.
#define HEAT_H_PARAMS                                                       \
  const float *__restrict__ u, const float *__restrict__ zt,                \
      const float *__restrict__ yt, const float *__restrict__ xlo,          \
      const float *__restrict__ xhi, float *__restrict__ out,               \
      uint32_t *res, int64_t nx, int64_t ny, int64_t nz, int64_t bx,        \
      int64_t by, int64_t bz, int64_t ox, int64_t oy, int64_t oz, int hx,   \
      int hy, int hz, int64_t r_begin0, int64_t r_begin1, int64_t rows,     \
      int64_t seg, int64_t tiles_z, int64_t tiles_y, float a0, float cx,    \
      float cy, float cz
#define HEAT_H_ARGS                                                         \
  u, zt, yt, xlo, xhi, out, res, nx, ny, nz, bx, by, bz, ox, oy, oz, hx,    \
      hy, hz, r_begin0, r_begin1, rows, seg, tiles_z, tiles_y, a0, cx, cy,  \
      cz

typedef void (*HeatHKernel)(const float*, const float*, const float*,
                            const float*, const float*, float*, uint32_t*,
                            int64_t, int64_t, int64_t, int64_t, int64_t,
                            int64_t, int64_t, int64_t, int64_t, int, int,
                            int, int64_t, int64_t, int64_t, int64_t,
                            int64_t, int64_t, float, float, float, float);

// The compiled depths 1 .. kHMaxK (ops/hopper_params.py h_k_compiled)
// and rows per thread 1, 2, 4.
constexpr int kHMaxK = 8;

// One thread block: the (Y, Z) tile, segment and region of blockIdx;
// blockDim is (wz, by) and the extended tile wz x (by * R) cells.
template <int K, int R, int kLayout>
__device__ __forceinline__ void heat_h_body(HEAT_H_PARAMS) {
  const int wz = blockDim.x;
  const int wy = blockDim.y * R;             // extended tile rows
  const int row0 = threadIdx.y * R;          // this thread's first row
  const int64_t b = blockIdx.x;
  const int64_t tz = b % tiles_z;
  const int64_t ty = (b / tiles_z) % tiles_y;
  const int64_t region = blockIdx.y == 0 ? r_begin0 : r_begin1;
  const int64_t x0 = region + b / tiles_z / tiles_y * seg;
  const int64_t x1 = x0 + seg < region + rows ? x0 + seg : region + rows;
  // Block-local coordinates of this thread's cells (z, and row 0's y).
  const int64_t lz = tz * (wz - 2 * K) - K + threadIdx.x;
  const int64_t ly0 = ty * (wy - 2 * K) - K + row0;
  const bool z_out = threadIdx.x >= K && threadIdx.x < wz - K;
  const int64_t ye = by + 2 * hy, ze = bz + 2 * hz;
  const int64_t gz = oz + lz;
  const int64_t k2 = 2 * K;
  // Per row: inside the grid and the K-deep frame, inside the (Y, Z)
  // interior, this block's to write.
  unsigned cell_in = 0u, yz_in = 0u, out_rows = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t ly = ly0 + r;
    const int64_t gy = oy + ly;
    const bool c_in = ly >= -K && ly < by + K && lz >= -K && lz < bz + K &&
                      gy >= 0 && gy < ny && gz >= 0 && gz < nz;
    cell_in |= static_cast<unsigned>(c_in) << r;
    yz_in |= static_cast<unsigned>(gy >= 1 && gy <= ny - 2 && gz >= 1 &&
                                   gz <= nz - 2) << r;
    out_rows |= static_cast<unsigned>(c_in && z_out && row0 + r >= K &&
                                      row0 + r < wy - K && ly < by &&
                                      lz < bz) << r;
  }
  const int64_t pu = by * bz, pz = by * k2, py = k2 * ze, px = ye * ze;
  // Does the extended tile lie inside the block's (Y, Z) extent? Then a
  // plane is one run per row of u (of the assembled block), as in F, or
  // of an x slab. The two kinds of tile take two copies of the step loop,
  // so the per-cell choice of the edge tiles costs the others no
  // registers.
  const int64_t ty0 = ty * (wy - 2 * K) - K, tz0 = tz * (wz - 2 * K) - K;
  if (ty0 >= 0 && ty0 + wy <= by && tz0 >= 0 && tz0 + wz <= bz) {
    const bool circ = kLayout == kHeatHCircular;
    const float* core = circ ? u + hx * px + ly0 * ze + lz : u + ly0 * bz + lz;
    const int64_t core_plane = circ ? px : pu, core_row = circ ? ze : bz;
    const int64_t slab_col = ly0 * ze + lz;
    auto load = [&](float* dst, int64_t t) {
      const bool in_block = t >= 0 && t < bx;
      const bool x_in = ox + t >= 0 && ox + t < nx;
      const float* p = in_block || (circ && x_in) ? core + t * core_plane
                       : !x_in ? nullptr
                       : (t < 0 ? xlo + (t + K) * px : xhi + (t - bx) * px) +
                             slab_col;
      const int64_t row = in_block || circ ? core_row : ze;
#pragma unroll
      for (int r = 0; r < R; ++r)
        __pipeline_memcpy_async(dst + r * wz, p != nullptr ? p + r * row : u,
                                4, p != nullptr ? 0 : 4);
    };
    heat_t3d_stream<K, R>(load, x0, x1, ox, nx, yz_in, out_rows, out, pu,
                          ly0 * bz + lz, bz, a0, cx, cy, cz, res);
    return;
  }
  // A tile at the block's (Y, Z) edge. Per row, which x-interior piece
  // holds the cell (2 bits: u, ztail, ytail) at which offset of its
  // plane, and the cell's offset in an x-slab plane (of the assembled
  // block too). The launcher keeps a plane under 2^31 cells.
  unsigned piece = 0u;
  int32_t ioff[R], xoff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t ly = ly0 + r;
    const int64_t yc = ly < 0 ? ly + ye : ly;  // circular y
    const int64_t zc = lz < 0 ? lz + ze : lz;  // circular z
    xoff[r] = static_cast<int32_t>(yc * ze + zc);
    int64_t off;
    if (ly >= 0 && ly < by) {
      if (lz >= 0 && lz < bz) {
        off = ly * bz + lz;
      } else {
        piece |= 1u << (2 * r);
        off = ly * k2 + (lz >= bz ? lz - bz : lz + k2);
      }
    } else {
      piece |= 2u << (2 * r);
      off = (ly >= by ? ly - by : ly + k2) * ze + zc;
    }
    ioff[r] = static_cast<int32_t>(off);
  }

  // Block-local input plane t of this thread's cells; zero-filled where
  // no piece holds a cell.
  auto load = [&](float* dst, int64_t t) {
    const bool x_in = ox + t >= 0 && ox + t < nx;
    const float* slab = kLayout == kHeatHCircular ? u + (t + hx) * px
                        : t < 0                   ? xlo + (t + K) * px
                                                  : xhi + (t - bx) * px;
    const bool from_slab = kLayout == kHeatHCircular || t < 0 || t >= bx;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = x_in && ((cell_in >> r) & 1u);
      const unsigned w = (piece >> (2 * r)) & 3u;
      const float* p = !in        ? u
                       : from_slab ? slab + xoff[r]
                       : w == 0u   ? u + t * pu + ioff[r]
                       : w == 1u   ? zt + t * pz + ioff[r]
                                   : yt + t * py + ioff[r];
      __pipeline_memcpy_async(dst + r * wz, p, 4, in ? 0 : 4);
    }
  };
  heat_t3d_stream<K, R>(load, x0, x1, ox, nx, yz_in, out_rows, out, pu,
                        ly0 * bz + lz, bz, a0, cx, cy, cz, res);
}

// The instance table of one entry point: kHeatH[r_index][k - 1].
#define HEAT_H_DEPTHS(KERNEL, R)                                           \
  {KERNEL<1, R>, KERNEL<2, R>, KERNEL<3, R>, KERNEL<4, R>, KERNEL<5, R>,   \
   KERNEL<6, R>, KERNEL<7, R>, KERNEL<8, R>}
#define HEAT_H_TABLE(KERNEL)                                               \
  {HEAT_H_DEPTHS(KERNEL, 1), HEAT_H_DEPTHS(KERNEL, 2),                     \
   HEAT_H_DEPTHS(KERNEL, 4)}

// Checks the arguments, zeroes *res, and launches the table's instance
// for (k, rows) over `regions` (1 or 2) regions of `rows_x` output planes
// each, starting at planes r_begin0 and r_begin1, in segments of `seg`
// planes, with thread blocks of block_z x block_y threads of `rows` rows
// each, on `stream`. Returns a cudaError_t: 0, or the reason the launch
// was refused.
inline int heat_h_launch(const HeatHKernel (&table)[3][kHMaxK],
                         const float* u, const float* zt, const float* yt,
                         const float* xlo, const float* xhi, float* out,
                         uint32_t* res, int64_t nx, int64_t ny, int64_t nz,
                         int64_t bx, int64_t by, int64_t bz, int64_t ox,
                         int64_t oy, int64_t oz, int hx, int hy, int hz,
                         int k, int64_t r_begin0, int64_t r_begin1,
                         int64_t rows_x, int regions, int block_z,
                         int block_y, int rows, int64_t seg, float a0,
                         float cx, float cy, float cz, void* stream) {
  const int r_index = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
  const int wy = block_y * rows;
  const auto halo_ok = [k](int h) { return h == 0 || h == k; };
  if (nx < 3 || ny < 3 || nz < 3 || bx < 1 || by < 1 || bz < 1 || k < 1 ||
      k > kHMaxK || ox < 0 || oy < 0 || oz < 0 || ox + bx > nx ||
      oy + by > ny || oz + bz > nz || !halo_ok(hx) || !halo_ok(hy) ||
      !halo_ok(hz) || r_index < 0 || block_y < 1 || block_z % 32 != 0 ||
      block_z <= 2 * k || wy <= 2 * k || block_z * block_y > 512 ||
      seg < 1 || rows_x < 1 || r_begin0 < 0 || r_begin1 + rows_x > bx ||
      regions < 1 || regions > 2 ||
      (by + 2 * hy) * (bz + 2 * hz) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_z = (bz + block_z - 2 * k - 1) / (block_z - 2 * k);
  const int64_t tiles_y = (by + wy - 2 * k - 1) / (wy - 2 * k);
  const int64_t blocks = tiles_z * tiles_y * ((rows_x + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = heat_t3d_smem_bytes(k, wy, block_z);
  const HeatHKernel kernel = table[r_index][k - 1];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), regions),
           dim3(block_z, block_y), smem, s>>>(
      u, zt, yt, xlo, xhi, out, res, nx, ny, nz, bx, by, bz, ox, oy, oz, hx,
      hy, hz, r_begin0, r_begin1, rows_x, seg, tiles_z, tiles_y, a0, cx, cy,
      cz);
  return static_cast<int>(cudaGetLastError());
}
