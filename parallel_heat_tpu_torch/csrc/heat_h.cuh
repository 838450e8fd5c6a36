// The body of the sharded 3D block kernel heat_h_block_3d_fused.cu (and,
// heat_h_body_bf16 below, of its bfloat16 form,
// heat_h_block_3d_fused_bf16.cu): K 7-point Jacobi
// steps on one bx x by x bz block of an nx x ny x nz grid cut over a
// device mesh, from the block and the K-deep halo its neighbours sent
// (parallel/temporal3d.py), with the residual of the last step.
//
// Replaces one of the kernel-H family of
// parallel_heat_tpu/ops/pallas_stencil.py (_build_temporal_block_3d_fused).
// Each TPU builder keeps its own entry point; the others,
// _build_temporal_block_3d and _build_band_fix_3d, are heat_h_block_3d.cu
// and heat_h_band_fix_3d.cu, on kernel F's plane loop.
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
// as F does, one run per row, or, in the fused form where the block's
// row is a multiple of 16 bytes (bz % 4 == 0) and the block holds such a
// tile at this K (heat_h_tma_fits), by TMA: one box of the block's
// tensor map per plane (the extended tile 4 cells wider: a box starts at
// a multiple of 4 cells), issued by
// one thread (heat_t3d_stream_tma), the x slabs' planes still by
// cp.async (their rows, bz + 2hz floats, are not a multiple of 16 bytes
// as TMA needs). A tile at the block's (Y, Z) edge fixes, once for
// the run, each row's piece (u, ztail or ytail: the row's y fixes it in
// the ytail, the thread's z elsewhere) as a pointer at the piece's plane
// 0 and the piece's plane stride, and its offset in an x-slab plane, so a
// plane costs a row one 32 x 32-bit multiply-add and a 4-byte cp.async.
// The kinds of tile run separate copies of the step loop, so the edge
// tiles' pointers cost the others no registers. (With a piece chosen per
// cell and plane, in int64, an edge tile took about twice an interior
// tile's time and H-fused 1.164 ms where F takes 0.885 at a 512^3 block
// and K = 3: PERF.md.)
// An unsharded axis (the block spans the grid along it) has no halo: its
// cells past the block lie outside the grid. Cells outside the global
// interior are copied, so H-fused(K) is bitwise F(K) on the same cells
// and no re-pin epilogue is needed. The deferred bulk (no x
// pieces) writes only output planes [K, bx-K), whose K-step cone stays
// inside the block in x; the band kernel writes planes [0, K) and
// [bx-K, bx), from input planes [-K, 2K) and [bx-2K, bx+K), into the
// bulk's output in place. Each counts the residual of exactly the planes
// it writes, so max(bulk, band) is the monolithic kernel's residual.

#pragma once

#include <type_traits>

#include "heat_temporal3d.cuh"

// Plane strides, in floats, of the pieces: u (by * bz), ztail (by * 2K),
// ytail (2K * Ze) and an x slab (Ye * Ze); the launcher keeps each under
// 2^31.
struct HeatHStrides {
  int32_t u, zt, yt, slab;
};

// The parameters of every H kernel, and their names: each entry point
// defines its own __global__ function (so a profile names it) whose body
// is heat_h_body. Regions (blockIdx.y) start at output
// planes r_begin0 and r_begin1, `rows` planes each, cut into segments
// of `seg` planes. The fused form's kernel takes one more parameter,
// `umap`, the block's tensor map for the TMA load (read by its kTma
// instances only), a __grid_constant__ parameter whose address the TMA
// instruction takes. HEAT_H_PARAMS_OF(T): on blocks of T cells (float,
// or __nv_bfloat16 for the bfloat16 form, heat_h_block_3d_fused_bf16.cu).
#define HEAT_H_PARAMS_OF(T)                                                 \
  const T *__restrict__ u, const T *__restrict__ zt,                        \
      const T *__restrict__ yt, const T *__restrict__ xlo,                  \
      const T *__restrict__ xhi, T *__restrict__ out, uint32_t *res,        \
      int64_t nx, int64_t ny, int64_t nz, int64_t bx, int64_t by,           \
      int64_t bz, int64_t ox, int64_t oy, int64_t oz, int hx, int hy,       \
      int hz, int64_t r_begin0, int64_t r_begin1, int64_t rows,             \
      int64_t seg, int64_t tiles_z, int64_t tiles_y, HeatHStrides st,       \
      float a0, float cx, float cy, float cz
#define HEAT_H_PARAMS HEAT_H_PARAMS_OF(float)
#define HEAT_H_ARGS                                                         \
  u, zt, yt, xlo, xhi, out, res, nx, ny, nz, bx, by, bz, ox, oy, oz, hx,    \
      hy, hz, r_begin0, r_begin1, rows, seg, tiles_z, tiles_y, st, a0, cx,  \
      cy, cz

typedef void (*HeatHKernel)(const float*, const float*, const float*,
                            const float*, const float*, float*, uint32_t*,
                            int64_t, int64_t, int64_t, int64_t, int64_t,
                            int64_t, int64_t, int64_t, int64_t, int, int,
                            int, int64_t, int64_t, int64_t, int64_t,
                            int64_t, int64_t, HeatHStrides, float, float,
                            float, float);
template <typename T>
using HeatHFusedKernelOf = void (*)(const T*, const T*, const T*, const T*,
                                    const T*, T*, uint32_t*, int64_t,
                                    int64_t, int64_t, int64_t, int64_t,
                                    int64_t, int64_t, int64_t, int64_t, int,
                                    int, int, int64_t, int64_t, int64_t,
                                    int64_t, int64_t, int64_t, HeatHStrides,
                                    float, float, float, float,
                                    const CUtensorMap);
using HeatHFusedKernel = HeatHFusedKernelOf<float>;

// The compiled depths 1 .. kHMaxK (ops/hopper_params.py h_k_compiled)
// and rows per thread 1, 2, 4; the TMA load only at kHTmaRows rows
// (h_tma_rows, the chosen h_rows).
constexpr int kHMaxK = 8;
constexpr int kHTmaRows = 4;

// One thread block: the (Y, Z) tile, segment and region of blockIdx;
// blockDim is (wz, by) and the extended tile wz x (by * R) cells. kTma:
// the tiles inside the block load by TMA from `umap` (null elsewhere).
template <int K, int R, bool kTma = false>
__device__ __forceinline__ void heat_h_body(HEAT_H_PARAMS,
                                            const CUtensorMap* umap) {
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
  const int64_t ze = bz + 2 * hz;
  const int64_t gz = oz + lz;
  const int k2 = 2 * K;
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
  // Does the extended tile lie inside the block's (Y, Z) extent? Then a
  // plane is one run per row of u, as in F, or of an x slab; or, with
  // kTma, one box of u's tensor map.
  const int64_t ty0 = ty * (wy - 2 * K) - K, tz0 = tz * (wz - 2 * K) - K;
  if (ty0 >= 0 && ty0 + wy <= by && tz0 >= 0 && tz0 + wz <= bz) {
    const int64_t slab_col = ly0 * ze + lz;
    if constexpr (kTma) {
      // The x slabs' planes inside the grid by cp.async; u's planes, and
      // the planes outside the grid (boxes past the map's x extent, so
      // zeros), by TMA.
      auto slab = [&](float* dst, int row, int64_t t) {
        if ((t >= 0 && t < bx) || ox + t < 0 || ox + t >= nx) return false;
        const float* p =
            (t < 0 ? xlo + (t + K) * st.slab : xhi + (t - bx) * st.slab) +
            slab_col;
#pragma unroll
        for (int r = 0; r < R; ++r)
          __pipeline_memcpy_async(dst + r * row, p + r * ze, 4);
        return true;
      };
      heat_t3d_stream_tma<K, R>(umap, static_cast<int>(tz0),
                                static_cast<int>(ty0), slab, x0, x1, ox, nx,
                                yz_in, out_rows, out, by * bz, ly0 * bz + lz,
                                bz, a0, cx, cy, cz, res);
      return;
    }
    const float* core = u + ly0 * bz + lz;
    const int64_t core_plane = st.u;
    const int64_t core_row = bz;
    auto load = [&](float* dst, int64_t t) {
      const bool in_block = t >= 0 && t < bx;
      const bool x_in = ox + t >= 0 && ox + t < nx;
      const float* p = in_block ? core + t * core_plane
                       : !x_in  ? nullptr
                                : (t < 0 ? xlo + (t + K) * st.slab
                                         : xhi + (t - bx) * st.slab) +
                                      slab_col;
      const int64_t row = in_block ? core_row : ze;
#pragma unroll
      for (int r = 0; r < R; ++r)
        __pipeline_memcpy_async(dst + r * wz,
                                p != nullptr ? p + r * row : u, 4,
                                p != nullptr ? 0 : 4);
    };
    heat_t3d_stream<K, R>(load, x0, x1, ox, nx, yz_in, out_rows, out,
                          by * bz, ly0 * bz + lz, bz, a0, cx, cy, cz, res);
    return;
  }
  // A tile at the block's (Y, Z) edge. Per row, fixed for the run: where
  // its cell lies in an x-interior plane, as a pointer at plane 0 of its
  // piece (u, ztail or ytail) and that piece's plane stride, and the
  // cell's offset in an x-slab plane. A cell outside the grid or the
  // K-deep frame is zero-filled.
  const float* src[R];
  int32_t pstride[R], xoff[R];
  const int64_t ye = by + 2 * hy;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t ly = ly0 + r;
    const int64_t yc = ly < 0 ? ly + ye : ly;  // circular y
    const int64_t zc = lz < 0 ? lz + ze : lz;  // circular z
    xoff[r] = static_cast<int32_t>(yc * ze + zc);
    if (ly >= 0 && ly < by) {
      if (lz >= 0 && lz < bz) {
        src[r] = u + (ly * bz + lz);
        pstride[r] = st.u;
      } else {
        src[r] = zt + (ly * k2 + (lz >= bz ? lz - bz : lz + k2));
        pstride[r] = st.zt;
      }
    } else {
      src[r] = yt + ((ly >= by ? ly - by : ly + k2) * ze + zc);
      pstride[r] = st.yt;
    }
    if (!((cell_in >> r) & 1u)) src[r] = nullptr;
  }

  // Block-local input plane t of this thread's cells.
  auto load = [&](float* dst, int64_t t) {
    const bool x_in = ox + t >= 0 && ox + t < nx;
    if (t < 0 || t >= bx) {
      const float* slab = t < 0 ? xlo + (t + K) * st.slab
                                : xhi + (t - bx) * st.slab;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = x_in && src[r] != nullptr;
        __pipeline_memcpy_async(dst + r * wz, in ? slab + xoff[r] : u, 4,
                                in ? 0 : 4);
      }
    } else {
      const int32_t ti = static_cast<int32_t>(t);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = src[r] != nullptr;
        __pipeline_memcpy_async(
            dst + r * wz,
            in ? src[r] + static_cast<int64_t>(ti) * pstride[r] : u, 4,
            in ? 0 : 4);
      }
    }
  };
  heat_t3d_stream<K, R>(load, x0, x1, ox, nx, yz_in, out_rows, out, by * bz,
                        ly0 * bz + lz, bz, a0, cx, cy, cz, res);
}

// The bfloat16 form's cells of one thread (heat_t3d_stream_bf16's rows)
// on a tile whose extended tile lies inside the block: row r of plane t
// at core + t * plane + r * bz in u, or at slab_col + r * ze of an x slab
// inside the grid; zero past the grid. With a box (kTma), u's planes and
// those past the grid come as boxes.
struct HeatHBf16Inner {
  const uint16_t *core, *xlo, *xhi;
  int64_t plane, bz, ze, slab_col, bx, ox, nx;
  int32_t slab;  // an x slab's plane stride
  int k;

  __device__ __forceinline__ const uint16_t* cell(int r, int64_t t) const {
    if (t >= 0 && t < bx) return core + t * plane + r * bz;
    if (ox + t < 0 || ox + t >= nx) return nullptr;
    return (t < 0 ? xlo + (t + k) * slab : xhi + (t - bx) * slab) +
           slab_col + r * ze;
  }
  __device__ __forceinline__ bool box(int64_t t) const {
    return (t >= 0 && t < bx) || ox + t < 0 || ox + t >= nx;
  }
};

// The same on a tile at the block's (Y, Z) edge: per row, fixed for the
// run, its cell's piece (u, ztail or ytail) as a pointer at the piece's
// plane 0 and the piece's plane stride, and its offset in an x-slab
// plane, as heat_h_body's edge tiles keep them (src null: no data).
template <int R>
struct HeatHBf16Edge {
  const uint16_t* src[R];
  int32_t pstride[R], xoff[R];
  const uint16_t *xlo, *xhi;
  int64_t bx, ox, nx;
  int32_t slab;
  int k;

  __device__ __forceinline__ const uint16_t* cell(int r, int64_t t) const {
    if (src[r] == nullptr) return nullptr;
    if (t >= 0 && t < bx) return src[r] + t * pstride[r];
    if (ox + t < 0 || ox + t >= nx) return nullptr;
    return (t < 0 ? xlo + (t + k) * slab : xhi + (t - bx) * slab) +
           xoff[r];
  }
  __device__ __forceinline__ bool box(int64_t) const { return false; }
};

// heat_h_body on bfloat16 blocks (heat_h_block_3d_fused_bf16.cu): the
// same tiles, pieces and step phase (heat_f_levels, each level below K
// rounded to bfloat16, the copied cells narrowed exactly), its planes
// through heat_t3d_stream_bf16. kTma: the tiles inside the block take
// u's planes as boxes of `umap`, the bfloat16 block's tensor map;
// kPacked: the levels' registers packed (the same bits).
template <int K, int R, bool kTma, bool kPacked>
__device__ __forceinline__ void heat_h_body_bf16(
    HEAT_H_PARAMS_OF(__nv_bfloat16), const CUtensorMap* umap) {
  const int wz = blockDim.x;
  const int wy = blockDim.y * R;             // extended tile rows
  const int row0 = threadIdx.y * R;          // this thread's first row
  const int64_t b = blockIdx.x;
  const int64_t tz = b % tiles_z;
  const int64_t ty = (b / tiles_z) % tiles_y;
  const int64_t region = blockIdx.y == 0 ? r_begin0 : r_begin1;
  const int64_t x0 = region + b / tiles_z / tiles_y * seg;
  const int64_t x1 = x0 + seg < region + rows ? x0 + seg : region + rows;
  const int64_t lz = tz * (wz - 2 * K) - K + threadIdx.x;
  const int64_t ly0 = ty * (wy - 2 * K) - K + row0;
  const bool z_out = threadIdx.x >= K && threadIdx.x < wz - K;
  const int64_t ze = bz + 2 * hz;
  const int64_t gz = oz + lz;
  const int k2 = 2 * K;
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
  const uint16_t* xl = reinterpret_cast<const uint16_t*>(xlo);
  const uint16_t* xh = reinterpret_cast<const uint16_t*>(xhi);
  const int64_t ty0 = ty * (wy - 2 * K) - K, tz0 = tz * (wz - 2 * K) - K;
  if (ty0 >= 0 && ty0 + wy <= by && tz0 >= 0 && tz0 + wz <= bz) {
    const HeatHBf16Inner in = {
        reinterpret_cast<const uint16_t*>(u) + ly0 * bz + lz, xl, xh, st.u,
        bz, ze, ly0 * ze + lz, bx, ox, nx, st.slab, K};
    heat_t3d_stream_bf16<K, R, kTma, kPacked>(
        in, umap, static_cast<int>(tz0), static_cast<int>(ty0), x0, x1, ox,
        nx, yz_in, out_rows, out, by * bz, ly0 * bz + lz, bz, a0, cx, cy, cz,
        res);
    return;
  }
  HeatHBf16Edge<R> e;
  e.xlo = xl;
  e.xhi = xh;
  e.bx = bx;
  e.ox = ox;
  e.nx = nx;
  e.slab = st.slab;
  e.k = K;
  const uint16_t* ub = reinterpret_cast<const uint16_t*>(u);
  const uint16_t* zb = reinterpret_cast<const uint16_t*>(zt);
  const uint16_t* yb = reinterpret_cast<const uint16_t*>(yt);
  const int64_t ye = by + 2 * hy;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t ly = ly0 + r;
    const int64_t yc = ly < 0 ? ly + ye : ly;  // circular y
    const int64_t zc = lz < 0 ? lz + ze : lz;  // circular z
    e.xoff[r] = static_cast<int32_t>(yc * ze + zc);
    if (ly >= 0 && ly < by) {
      if (lz >= 0 && lz < bz) {
        e.src[r] = ub + (ly * bz + lz);
        e.pstride[r] = st.u;
      } else {
        e.src[r] = zb + (ly * k2 + (lz >= bz ? lz - bz : lz + k2));
        e.pstride[r] = st.zt;
      }
    } else {
      e.src[r] = yb + ((ly >= by ? ly - by : ly + k2) * ze + zc);
      e.pstride[r] = st.yt;
    }
    if (!((cell_in >> r) & 1u)) e.src[r] = nullptr;
  }
  heat_t3d_stream_bf16<K, R, false, kPacked>(
      e, umap, 0, 0, x0, x1, ox, nx, yz_in, out_rows, out, by * bz,
      ly0 * bz + lz, bz, a0, cx, cy, cz, res);
}

// The instance table of one entry point: kHeatH[r_index][k - 1]; the
// _OF form for a kernel with a third template argument A.
#define HEAT_H_DEPTHS(KERNEL, R)                                           \
  {KERNEL<1, R>, KERNEL<2, R>, KERNEL<3, R>, KERNEL<4, R>, KERNEL<5, R>,   \
   KERNEL<6, R>, KERNEL<7, R>, KERNEL<8, R>}
#define HEAT_H_TABLE(KERNEL)                                               \
  {HEAT_H_DEPTHS(KERNEL, 1), HEAT_H_DEPTHS(KERNEL, 2),                     \
   HEAT_H_DEPTHS(KERNEL, 4)}
#define HEAT_H_DEPTHS_OF(KERNEL, R, A)                                     \
  {KERNEL<1, R, A>, KERNEL<2, R, A>, KERNEL<3, R, A>, KERNEL<4, R, A>,     \
   KERNEL<5, R, A>, KERNEL<6, R, A>, KERNEL<7, R, A>, KERNEL<8, R, A>}
#define HEAT_H_TABLE_OF(KERNEL, A)                                         \
  {HEAT_H_DEPTHS_OF(KERNEL, 1, A), HEAT_H_DEPTHS_OF(KERNEL, 2, A),         \
   HEAT_H_DEPTHS_OF(KERNEL, 4, A)}

// The table's index of `rows` rows a thread, or -1.
inline int heat_h_rows_index(int rows) {
  return rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
}

// The instance of table (k, rows), or null where none is compiled.
template <typename Kernel>
inline Kernel heat_h_pick(const Kernel (&table)[3][kHMaxK], int k,
                          int rows) {
  const int r = heat_h_rows_index(rows);
  return r < 0 || k < 1 || k > kHMaxK ? nullptr : table[r][k - 1];
}

// Does an axis of n cells hold a tile whose extended range, w cells
// from t (w - 2k) - k, lies inside it? The first tile that starts at 0
// or past is the one to try.
inline bool heat_h_holds_tile(int64_t n, int w, int k) {
  const int64_t step = w - 2 * k;
  const int64_t first = (k + step - 1) / step;
  return first * step - k + w <= n;
}

// Does the TMA plane load run for a block of by x bz cells of `elem`
// bytes at u under thread blocks of block_z x block_y threads of `rows`
// rows at depth k? TMA needs u's rows and address to be multiples of 16
// bytes (bz % 4 == 0 in float32, bz % 8 == 0 in bfloat16), and its
// instances are compiled at kHTmaRows rows. A box is the extended tile
// 16 bytes of cells wider (at most 256), and only a tile whose extended
// tile lies inside the block takes it, so the block must hold one. The
// launcher takes TMA only when the caller asks (the wrappers ask by this
// same rule, ops/hopper_params.py h_tma_fits) and refuses it elsewhere.
inline bool heat_h_tma_fits(const void* u, int64_t by, int64_t bz,
                            int block_z, int block_y, int rows, int k,
                            int elem = 4) {
  const int cells = 16 / elem;
  return bz % cells == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
         rows == kHTmaRows && block_z + cells <= 256 &&
         bz >= block_z + cells && heat_h_holds_tile(by, block_y * rows, k) &&
         heat_h_holds_tile(bz, block_z, k);
}

// The tensor map of the bx x by x bz block u (innermost z first), boxes// The tensor map of the bx x by x bz block u (innermost z first), boxes
// of (block_z + 4) x (block_y * rows) x 1 cells (heat_t3d_stream_tma),
// zeros outside the block. Returns 0 or an error code
// (heat_tma_error_string). The bfloat16 block's is below.
inline int heat_h_encode_map(CUtensorMap* map, const float* u, int64_t bx,
                             int64_t by, int64_t bz, int block_z,
                             int block_y, int rows) {
  return heat_tma_encode_3d(map, u, bx, by, bz, block_z + 4,
                            block_y * rows);
}

// The bfloat16 block's: boxes of (block_z + 8) x (block_y * rows) x 1
// cells (heat_t3d_stream_bf16).
inline int heat_h_encode_map(CUtensorMap* map, const __nv_bfloat16* u,
                                  int64_t bx, int64_t by, int64_t bz,
                                  int block_z, int block_y, int rows) {
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(block_z + 8),
                             static_cast<cuuint32_t>(block_y * rows), 1};
  return heat_tma_encode_3d_box(map, u, bx, by, bz, box,
                                CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// Dynamic shared memory of an H launch: the step phase's planes; for the
// TMA form the larger of the TMA ring's layout (its inner tiles) and the
// cp.async ring's (its edge tiles), as ops/hopper_params.py h_k_max
// counts them.
inline int heat_h_smem_bytes(int k, int wy, int block_z, bool tma) {
  const int planes = heat_t3d_smem_bytes(k, wy, block_z);
  const int boxes = heat_t3d_tma_smem_bytes(k, wy, block_z);
  return tma && boxes > planes ? boxes : planes;
}

// Checks the arguments, zeroes *res, and launches `kernel`, the entry
// point's instance for (k, rows) on T cells (null where none is
// compiled), over
// `regions` (1 or 2) regions of `rows_x` output planes each, starting at
// planes r_begin0 and r_begin1, in segments of `seg` planes, with thread
// blocks of block_z x block_y threads of `rows` rows each, on `stream`.
// A HeatHFusedKernel also takes u's tensor map: encoded for tma (a kTma
// instance; heat_h_tma_fits must hold), zeros and unread otherwise; the
// bfloat16 form runs on the shared memory of its own loop
// (heat_h_bf16_smem_bytes).
// Returns a cudaError_t: 0, or the reason the launch was refused; or an
// encoding error (heat_tma_error_string).
template <typename T, typename Kernel>
inline int heat_h_launch(Kernel kernel, bool tma, const T* u, const T* zt,
                         const T* yt, const T* xlo, const T* xhi, T* out,
                         uint32_t* res,
                         int64_t nx, int64_t ny, int64_t nz, int64_t bx,
                         int64_t by, int64_t bz, int64_t ox, int64_t oy,
                         int64_t oz, int hx, int hy, int hz, int k,
                         int64_t r_begin0, int64_t r_begin1, int64_t rows_x,
                         int regions, int block_z, int block_y, int rows,
                         int64_t seg, float a0, float cx, float cy, float cz,
                         void* stream) {
  constexpr bool kFused = std::is_same<Kernel, HeatHFusedKernelOf<T>>::value;
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int wy = block_y * rows;
  const auto halo_ok = [k](int h) { return h == 0 || h == k; };
  const int64_t ye = by + 2 * hy, ze = bz + 2 * hz;
  if (kernel == nullptr || nx < 3 || ny < 3 || nz < 3 || bx < 1 || by < 1 ||
      bz < 1 || k < 1 || k > kHMaxK || ox < 0 || oy < 0 || oz < 0 ||
      ox + bx > nx || oy + by > ny || oz + bz > nz || !halo_ok(hx) ||
      !halo_ok(hy) || !halo_ok(hz) || block_y < 1 || block_z % 32 != 0 ||
      block_z <= 2 * k || wy <= 2 * k || block_z * block_y > 512 ||
      seg < 1 || rows_x < 1 || r_begin0 < 0 || r_begin1 + rows_x > bx ||
      regions < 1 || regions > 2 || ye * ze > 0x7fffffffLL ||
      (tma && (!kFused || !heat_h_tma_fits(u, by, bz, block_z, block_y,
                                            rows, k, sizeof(T)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_z = (bz + block_z - 2 * k - 1) / (block_z - 2 * k);
  const int64_t tiles_y = (by + wy - 2 * k - 1) / (wy - 2 * k);
  const int64_t blocks = tiles_z * tiles_y * ((rows_x + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const HeatHStrides st = {static_cast<int32_t>(by * bz),
                           static_cast<int32_t>(by * 2 * k),
                           static_cast<int32_t>(2 * k * ze),
                           static_cast<int32_t>(ye * ze)};
  CUtensorMap map = {};
  if (tma) {
    const int err = heat_h_encode_map(&map, u, bx, by, bz, block_z, block_y,
                                      rows);
    if (err != 0) return err;
  }
  const int smem = kBf16 ? heat_h_bf16_smem_bytes(k, wy, block_z)
                         : heat_h_smem_bytes(k, wy, block_z, tma);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks), regions);
  const dim3 block(block_z, block_y);
  if constexpr (kFused)
    kernel<<<grid, block, smem, s>>>(
        u, zt, yt, xlo, xhi, out, res, nx, ny, nz, bx, by, bz, ox, oy, oz,
        hx, hy, hz, r_begin0, r_begin1, rows_x, seg, tiles_z, tiles_y, st,
        a0, cx, cy, cz, map);
  else
    kernel<<<grid, block, smem, s>>>(
        u, zt, yt, xlo, xhi, out, res, nx, ny, nz, bx, by, bz, ox, oy, oz,
        hx, hy, hz, r_begin0, r_begin1, rows_x, seg, tiles_z, tiles_y, st,
        a0, cx, cy, cz);
  return static_cast<int>(cudaGetLastError());
}
