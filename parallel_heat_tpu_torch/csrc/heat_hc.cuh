// Kernel H's thread-block body and launch (heat_h_block_3d.cu has the
// design): heat_hc_tile, one (Y, Z) tile and X segment of the circular
// block on kernel F's plane loop with the circular fetch (HeatFLoop's
// kCirc), and heat_hc_launch, the checks, the tensor map, the shared
// memory and the launch; on blocks of float32 cells (kernel H,
// heat_h_block_3d.cu) or of bfloat16 ones (its bfloat16 form,
// heat_h_block_3d_bf16.cu, a library of its own so that its nvcc runs
// beside H's). Each kernel's __global__ body stays written in its own
// source, as kernel F's does (heat_f_block.inc).

#pragma once

#include <type_traits>

#include "heat_temporal3d.cuh"

// The launch's arguments: the block's geometry in the grid, the circular
// block's (ye = by + 2hy, ze = bz + 2hz, rows of `pitch` cells), the
// tile grid and X segment, the ring's planes in flight, the load; on
// blocks of T cells. HeatHcArgs (float32) keeps its name and layout,
// which kernel H's instances are compiled against.
template <typename T>
struct HeatHcArgsOf {
  const T* ext;
  T* out;
  uint32_t* res;
  int64_t nx, ny, nz, bx, by, bz, ox, oy, oz;
  int64_t ye, ze, pitch, tiles_z, tiles_y, seg;
  int hx, hy, hz, prefetch, tma, vec_out;
  float a0, cx, cy, cz;
};
struct HeatHcArgs : HeatHcArgsOf<float> {};
struct HeatHcBf16Args : HeatHcArgsOf<__nv_bfloat16> {};

// The level layout of kernel H's bfloat16 (K, rows) instances, both
// loads (heat_temporal3d.cuh kHeatFBf16*): float4 levels rounded in pairs,
// but packed ones where the pairs spill more than the float32 twin, each
// instance held to that by chip_smoke.py's build check: kernel F's rule
// (heat_f_temporal3d_bf16.cu heat_f_bf16_layout: 4 rows from K = 5) and
// <3, 2>, whose circular offsets take the registers the pairs need (28
// bytes of spill stores against none; packed, 126 registers and none).
// Measured by compiling every instance in each layout (PERF.md §6).
__host__ __device__ constexpr int heat_h_bf16_layout(int k, int rows) {
  return (rows == 4 && k >= 5) || (rows == 2 && k == 3) ? kHeatFBf16Packed
                                                        : kHeatFBf16Pair;
}

// The plane loop of kernel H on T cells: F's loop with the circular
// block's fetch (kCirc); at bfloat16 the grid's cells in the ring and the
// level layout of heat_h_bf16_layout.
template <int K, int R, bool kTma, typename T>
struct HeatHcLoop {
  using type = HeatFLoop<K, R, kTma, kHeatFFull, true>;
};
template <int K, int R, bool kTma>
struct HeatHcLoop<K, R, kTma, __nv_bfloat16> {
  using type = HeatFLoop<K, R, kTma, kHeatFFull, true, 0, __nv_bfloat16,
                         __nv_bfloat16, heat_h_bf16_layout(K, R)>;
};

// One thread block's tile (extended tile's first row y0, first cell z0,
// block-local) and segment [x0, x0 + seg) of output planes, under the
// box load (kTma) or the per-cell one.
template <int K, int R, bool kTma, class Args>
__device__ __forceinline__ void heat_hc_tile(const Args a,
                                             const CUtensorMap* emap,
                                             int64_t x0, int64_t y0,
                                             int64_t z0) {
  extern __shared__ __align__(128) float smem[];
  using T = typename std::remove_pointer<decltype(a.out)>::type;
  using Loop = typename HeatHcLoop<K, R, kTma, T>::type;
  constexpr int P = Loop::kPad;
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
  f.box_bytes = static_cast<uint32_t>(sizeof(T) * kFWidth * wy);
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

// Kernel H's launch through `kernel`, the instance of (k, rows) on T
// cells (null where none is compiled), with heat_h_block_3d's arguments
// and results (heat_h_block_3d.cu): float32, or bfloat16
// (heat_h_block_3d_bf16.cu), whose rows of the circular block are
// `pitch` bfloat16 cells and whose TMA load needs pitch % 8 == 0.
template <typename T, typename Args>
inline int heat_hc_launch(void (*kernel)(const Args, const CUtensorMap),
                          const T* ext, T* out, uint32_t* res, int64_t nx,
                          int64_t ny, int64_t nz, int64_t bx, int64_t by,
                          int64_t bz, int64_t ox, int64_t oy, int64_t oz,
                          int hx, int hy, int hz, int64_t pitch, int k,
                          int block_x, int block_y, int rows, int64_t seg,
                          int prefetch, int tma, float a0, float cx,
                          float cy, float cz, void* stream) {
  constexpr int kElem = sizeof(T);
  const auto halo_ok = [k](int h) { return h == 0 || h == k; };
  const int64_t ye = by + 2 * hy, ze = bz + 2 * hz, ext_x = bx + 2 * hx;
  if (kernel == nullptr || ext == nullptr || out == nullptr ||
      static_cast<const void*>(ext) == static_cast<const void*>(out) ||
      nx < 3 || ny < 3 || nz < 3 || bx < 1 || by < 1 || bz < 1 || ox < 0 ||
      oy < 0 || oz < 0 || ox + bx > nx || oy + by > ny || oz + bz > nz ||
      !halo_ok(hx) || !halo_ok(hy) || !halo_ok(hz) || pitch < ze ||
      ye * pitch > 0x7fffffffLL || ext_x > 0x7fffffffLL || seg < 1 ||
      prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(block_x, block_y, rows, k, kElem) ||
      (tma && (pitch % (16 / kElem) != 0 ||
               reinterpret_cast<uintptr_t>(ext) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wy = block_y * rows;
  const int tile_z = kFWidth - 2 * heat_f_pad(k, kElem);
  Args a;
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
  // A group's store: 16 bytes of float32 cells, 8 of bfloat16 ones.
  a.vec_out =
      bz % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * kElem) == 0;
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
    const cuuint64_t strides[2] = {
        static_cast<cuuint64_t>(pitch) * kElem,
        static_cast<cuuint64_t>(ye * pitch) * kElem};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kFWidth),
                               static_cast<cuuint32_t>(wy), 1};
    const int err = heat_tma_encode(
        &map, ext, 3, dims, strides, box,
        kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != 0) return err;
  }
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch, kElem);
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

// Thread blocks of `kernel` (the (k, rows) instance on `elem`-byte cells)
// that one SM holds at once under thread blocks of 32 x block_y threads
// and `prefetch` planes in flight, into *blocks (the CUDA occupancy
// calculator, registers included). Returns a cudaError_t.
template <typename Args>
inline int heat_hc_occupancy(void (*kernel)(const Args, const CUtensorMap),
                             int elem, int k, int block_y, int rows,
                             int prefetch, int* blocks) {
  if (blocks == nullptr || prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(kFLanes, block_y, rows, k, elem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch, elem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kFLanes * block_y, smem));
}
