// The 3D band's thread-block body and launch (heat_h_band_fix_3d.cu has
// the design): the launch's table and arguments, a segment's load
// (HeatHBandSeg), one tile on kernel F's plane loop (heat_hb_tile) and
// heat_hb_launch, the checks, the table's chunks and the launches; on
// blocks of float32 cells (heat_h_band_fix_3d.cu) or of bfloat16 ones
// (heat_h_band_fix_3d_bf16.cu, a library of its own so that its nvcc runs
// beside the float32 band's). Each kernel's __global__ body stays written
// in its own source.

#pragma once

#include <type_traits>

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
//
// T: the pieces' cells. The table's pointers are float ones; a bfloat16
// launch's entries point at bfloat16 blocks (heat_h_band_fix_3d_bf16.cu),
// which load_bf16 reads as such.
template <int K, int R, int kLoad, typename T = float>
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
  __device__ __forceinline__ void load(T* dst, int i) const {
    if constexpr (std::is_same<T, float>::value)
      load_f32(dst, i);
    else
      load_bf16(reinterpret_cast<uint16_t*>(dst), i);
  }

  __device__ __forceinline__ void load_f32(float* dst, int i) const {
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

  // load() on bfloat16 pieces: per row, one 8-byte cp.async where the
  // lane's 4 cells are one run of one piece (all from u or the y tail or a
  // slab row, or all from the z tail), all in the K-deep frame, on 8
  // bytes (kHeatHBandVec takes a run of u, bit 8, untested); else a plain
  // 2-byte load a cell in the frame and zeros outside it (cp.async has no
  // 2-byte copy), stored before the thread arrives on the slot's barrier.
  __device__ __forceinline__ void load_bf16(uint16_t* dst, int i) const {
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
    const auto cells = [](const float* p) {
      return reinterpret_cast<const uint16_t*>(p);
    };
    // A lane's 4 cells of one run at q, `in` its cells in the frame.
    const auto run_of = [](uint16_t* d, const uint16_t* q, unsigned in) {
      if (in == 0xfu && (reinterpret_cast<uintptr_t>(q) & 7u) == 0) {
        __pipeline_memcpy_async(d, q, 8);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c] = (in >> c) & 1u ? q[c] : uint16_t{0};
      }
    };
    if (l >= 0 && l < a.bx) {
      const uint16_t* pu = cells(e.u) + l * (a.by * a.bz);
      const uint16_t* pz = cells(e.zt) + l * (a.by * k2);
      const uint16_t* py = cells(e.yt) + l * (k2 * ze);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ly = ly0 + r;
        const bool in_u = ly >= 0 && ly < a.by;
        const unsigned in = ly >= -a.hy && ly < a.by + a.hy ? zfr : 0u;
        uint16_t* d = dst + r * kFWidth;
        if (kLoad == kHeatHBandVec && in_u && (masks >> 8)) {
          __pipeline_memcpy_async(d, pu + (ly * a.bz + lz0), 8);
          continue;
        }
        const uint16_t* row =
            in_u ? pu + (ly * a.bz + lz0)
                 : py + ((ly >= a.by ? ly - a.by : ly + k2) * ze + zc0);
        const uint16_t* zrow =
            pz + (ly * k2 + (lz0 < 0 ? lz0 + k2 : lz0 - a.bz));
        const unsigned from_z = in_u ? zsel : 0u;
        if (from_z == 0u || from_z == 0xfu) {
          run_of(d, from_z ? zrow : row, in);
        } else {
          // The lane straddles the block's last z and the z tail.
#pragma unroll
          for (int c = 0; c < 4; ++c)
            d[c] = (in >> c) & 1u ? ((from_z >> c) & 1u ? zrow : row)[c]
                                  : uint16_t{0};
        }
      }
    } else {
      const bool t_in = t >= 0 && t < a.nx && l >= -K && l < a.bx + K;
      const int ye = static_cast<int>(a.by) + 2 * a.hy;
      const uint16_t* slab = (l < 0 ? cells(e.xlo) + (l + K) * (ye * ze)
                                    : cells(e.xhi) + (l - a.bx) * (ye * ze)) +
                             zc0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ly = ly0 + r;
        const unsigned in =
            t_in && ly >= -a.hy && ly < a.by + a.hy ? zfr : 0u;
        run_of(dst + r * kFWidth, slab + (ly < 0 ? ly + ye : ly) * ze, in);
      }
    }
  }

  // The segment's output state: its block's output, origin and region.
  template <class Loop>
  __device__ __forceinline__ void enter(Loop& f) const {
    const HeatHBandEntry& e = table.e[g >> 1];
    f.out = reinterpret_cast<decltype(f.out)>(e.out);
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

// The level layout of the band's bfloat16 (K, rows) instances, both
// loads (heat_temporal3d.cuh kHeatFBf16*), each held by chip_smoke.py's
// build check to no more spill than its float32 twin's: packed levels
// from K = 5 (none spill; the pairs spill more than the twin at 4 rows
// from K = 6) and at <1, 4> (the pairs spill 16-24 bytes of stores
// against the twin's 16-20), float4 pairs elsewhere (packed spill at
// <3, 4, vec> and <4, 4, vec>). Measured by compiling every instance in
// each layout (PERF.md §6).
__host__ __device__ constexpr int heat_hb_bf16_layout(int k, int rows) {
  return k >= 5 || (rows == 4 && k == 1) ? kHeatFBf16Packed
                                         : kHeatFBf16Pair;
}

// The band's plane loop on T cells.
template <int K, int R, typename T>
struct HeatHbLoop {
  using type = HeatFLoop<K, R, false, kHeatFFull, false, kHeatFBand>;
};
template <int K, int R>
struct HeatHbLoop<K, R, __nv_bfloat16> {
  using type = HeatFLoop<K, R, false, kHeatFFull, false, kHeatFBand,
                         __nv_bfloat16, __nv_bfloat16,
                         heat_hb_bf16_layout(K, R)>;
};

// One thread block's tile (extended tile's first row y0, first cell z0,
// block-local) of segment g, on T cells.
template <int K, int R, int kLoad, typename T = float>
__device__ __forceinline__ void heat_hb_tile(const HeatHBandTable& table,
                                             const HeatHBandArgs& a, int g,
                                             int y0, int z0) {
  extern __shared__ __align__(128) float smem[];
  using Loop = typename HeatHbLoop<K, R, T>::type;
  constexpr int P = Loop::kPad;
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
  const HeatHBandSeg<K, R, kLoad, T> seg{
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
  if constexpr (Loop::kF32In) {
    f.ring = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
    f.lev = f.ring + f.slots * f.slot_f;
  } else {
    // A bfloat16 ring: slot_f cells a slot, 256 bytes a row.
    f.ring = reinterpret_cast<T*>(
        smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4);
    f.lev = reinterpret_cast<float*>(f.ring + f.slots * f.slot_f);
  }
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


// Do the blocks of `elem`-byte cells take the vector load (ins: rows of
// a multiple of 16 bytes, every block 16-byte aligned;
// ops/hopper_params.py h_band_vec_fits is the geometry's half) or the
// vector store (outs: a group of 4 cells on its own size, 16 bytes of
// float32 cells, 8 of bfloat16 ones, with rows of a multiple of 4)?
inline bool heat_hb_aligned(const HeatHBandEntry* entries, int count,
                            int64_t bz, bool outs, int elem = 4) {
  if (bz % (outs ? 4 : 16 / elem) != 0) return false;
  const uintptr_t align = outs ? 4 * elem : 16;
  for (int i = 0; i < count; ++i) {
    const void* p = outs ? static_cast<const void*>(entries[i].out)
                         : static_cast<const void*>(entries[i].u);
    if (reinterpret_cast<uintptr_t>(p) % align != 0) return false;
  }
  return true;
}

// heat_h_band_fix_3d's launch (its arguments and results) through
// `kernels`, the table of a band's instances (kHeatHBand: [load][rows 2,
// 4][k - 1]) on blocks of `elem`-byte cells.
using HeatHBandKernel = void (*)(const HeatHBandTable, const HeatHBandArgs);
inline int heat_hb_launch(const HeatHBandKernel (&kernels)[2][2][kFMaxK],
                          int elem, const HeatHBandEntry* entries, int count,
                          int load, uint32_t* res, int64_t nx, int64_t ny,
                          int64_t nz, int64_t bx, int64_t by, int64_t bz,
                          int hy, int hz, int k, int block_x, int block_y,
                          int rows, int prefetch, float a0, float cx,
                          float cy, float cz, void* stream) {
  const auto halo_ok = [k](int h) { return h == 0 || h == k; };
  const int64_t ye = by + 2 * hy, ze = bz + 2 * hz;
  if (entries == nullptr || count < 1 || nx < 3 || ny < 3 || nz < 3 ||
      k < 1 || k > kFMaxK || bx < 2 * k || by < 1 || bz < 1 ||
      bx > nx || by > ny || bz > nz || !halo_ok(hy) || !halo_ok(hz) ||
      ye * ze > 0x7fffffffLL || by * bz > 0x7fffffffLL ||
      load < -1 || load > kHeatHBandVec ||
      !heat_f_takes(block_x, block_y, rows, k, elem) || rows == 1 ||
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
  const bool vec_in = heat_hb_aligned(entries, count, bz, false, elem);
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
  a.vec_out = heat_hb_aligned(entries, count, bz, true, elem);
  a.vec_in = vec_in;
  a.a0 = a0;
  a.cx = cx;
  a.cy = cy;
  a.cz = cz;
  const HeatHBandKernel kernel =
      kernels[load == kHeatHBandVec][rows == 4][k - 1];
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch, elem);
  const int wy = block_y * rows;
  a.tiles_z = (bz + kFWidth - 2 * heat_f_pad(k, elem) - 1) /
              (kFWidth - 2 * heat_f_pad(k, elem));
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

