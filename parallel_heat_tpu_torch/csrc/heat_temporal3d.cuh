// The step phases of the 3D K-step kernels. One arithmetic for all of
// them, so a block's K steps through any of them are bitwise kernel F's K
// steps on the same cells:
//   - heat_f_levels with its plane loops heat_t3d_stream and
//     heat_t3d_stream_tma, one z cell a thread: H-fused (heat_h.cuh,
//     heat_h_block_3d_fused.cu), and heat_t3d_stream_bf16, its bfloat16
//     form's (heat_h_block_3d_fused_bf16.cu);
//   - HeatFLoop (below), the register-blocked plane loop of kernel F
//     (heat_f_temporal3d.cu), of kernel H (heat_h_block_3d.cu, on the
//     assembled circular block) and of the band (heat_h_band_fix_3d.cu,
//     on the block's pieces): a lane owns 4 z cells of R rows in
//     float4 registers, so neighbours come by shuffle and from
//     registers, and each plane's tile arrives as one TMA box.
//
// heat_f_levels. A thread block owns a (Y, Z) tile of output cells plus a
// K-deep halo on its four sides, the extended tile, and a segment of
// output planes [x0, x1). It streams the input planes [x0 - K, x1 + K)
// through shared memory, one plane per iteration (cp.async, a ring of
// kFPrefetch planes in flight), and in the iteration that brings input plane t it advances
// every level at once: level s (the grid after s steps) at plane t - s,
// for s = 1 .. K, so level K comes out K planes behind the input. This is
// kernel I's first scheme (a thread a column) with planes for rows:
//   - a thread owns R consecutive rows of one z of the extended tile and
//     keeps those cells' last three planes of levels 0 .. K-1 in
//     registers, which give their X neighbours and, inside the thread,
//     their Y neighbours;
//   - Z neighbours, and the Y neighbours past a thread's first and last
//     row, come from shared memory, where each level keeps its last two
//     planes, by the input plane's parity; each plane is padded by one
//     row above and below, so the neighbour reads need no test;
//   - one barrier per input plane orders it all: a level's plane is read
//     by its neighbours in the next iteration, from the slot that was not
//     written in this one.
// What a kernel brings is its load: the caller's `load(dst, t)` issues
// the cp.async copies of this thread's R cells of input plane t (row r's
// to dst + r * blockDim.x), zero-filling the cells it has no data for.
// Values outside the valid pyramid (levels whose planes or columns reach
// past what the input supports, or read the pad rows) are garbage that
// spreads one cell per level and never reaches the output tile; cells
// outside the global interior are copied, never computed, and every step
// rounds to float32 like a launch of heat_d_step3d.
//
// heat_t3d_stream_tma is the same loop with the input planes brought by
// the Tensor Memory Accelerator: one thread asks for a plane's whole
// extended tile, a box of the caller's tensor map, and an mbarrier per
// ring slot says when it has landed, so no other thread issues a load or
// computes an address for it (heat_h.cuh's fused kernel, on the tiles
// that lie inside its block). At K = 3 and 4 rows a thread its
// test-free step compiles to 27 instructions and 12.7 bytes of shared
// memory a cell-step, 40 and 15 with the plane's load and barrier
// (bench_kernels --sass; PERF.md), on 1.36 cells stepped per output cell
// at 64 x 32 extended tiles.

#pragma once

#include <cuda_pipeline.h>

#include <type_traits>

#include "heat_common.cuh"
#include "heat_tma.cuh"

// Input planes prefetched ahead of the one being stepped, and the input
// ring's slots: the planes in flight plus the current and the previous.
// ops/hopper_params.py's h_prefetch must equal kFPrefetch.
constexpr int kFPrefetch = 6;
constexpr int kFSlots = kFPrefetch + 2;

// Levels 1 .. K of one input plane, global plane index t: level s at
// plane t - s, for this thread's R cells (rows row0 .. row0+R-1 of the
// extended tile, one z). up, mid and down hold those cells' last three
// planes of levels 0 .. K-1; `prev0` points at the previous input plane
// at this thread's first cell (level 0's neighbours), `lev` at levels
// 1 .. K-1, two planes each by parity (`par` is t's), with `me` this
// thread's first cell and `bz` the row length of a plane of `ps` floats.
// A cell's Y neighbours inside the thread come from registers, the ones
// past its first and last row and its Z neighbours from shared memory.
// Bit r of `yz_in` says row r's cell is inside the grid's (Y, Z)
// interior, bit r of `out_rows` that it is this block's to write. With
// kPlanesIn the K planes made are all interior planes of the nx-plane
// grid and are not tested. `out_cell` is where row 0's level K goes (row
// r's at r * out_row past it), or null when plane t - K is not this
// block's to write.
// Storage precision: T is the grid's cell (float, or __nv_bfloat16 for
// H-fused's bfloat16 form). At bfloat16 the planes in shared memory and
// registers stay float32, of widened cells; a level s < K is rounded to
// bfloat16 (heat_bf16_round, as __float2bfloat16_rn) before it lands in
// the level planes and registers, the copied cells keeping their bits;
// level K's float32 update gives the residual, and its store rounds the
// updated cells and narrows the copied ones exactly (heat_store). The
// float32 expressions stay as they were under `if constexpr`.
template <int K, int R, bool kPlanesIn, typename T = float>
__device__ __forceinline__ void heat_f_levels(
    float (&up)[K][R], float (&mid)[K][R], float (&down)[K][R],
    const float* prev0, float* lev, int ps, int me, int bz, int par,
    int64_t t, int64_t nx, unsigned yz_in, unsigned out_rows,
    T* out_cell, int64_t out_row, float a0, float cx, float cy, float cz,
    uint32_t* rmax) {
  constexpr bool kF32 = std::is_same<T, float>::value;
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    // Level s-1 at plane t - s: this thread's cells in mid[s-1], the
    // neighbours' in shared memory (written in the last iteration).
    const float* nb =
        s == 1 ? prev0 : lev + ((s - 2) * 2 + (par ^ 1)) * ps + me;
    const bool x_in = kPlanesIn || (t - s >= 1 && t - s <= nx - 2);
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float cc = mid[s - 1][r];
      const float ym = r > 0 ? mid[s - 1][r - 1] : nb[-bz];
      const float yp = r + 1 < R ? mid[s - 1][r + 1] : nb[R * bz];
      const bool in = x_in && ((yz_in >> r) & 1u);
      if constexpr (kF32) {
        v[r] = in ? heat_combine3(cc, up[s - 1][r], down[s - 1][r], ym, yp,
                                  nb[r * bz - 1], nb[r * bz + 1], a0, cx, cy,
                                  cz)
                  : cc;
      } else {
        const float n = heat_combine3(cc, up[s - 1][r], down[s - 1][r], ym,
                                      yp, nb[r * bz - 1], nb[r * bz + 1], a0,
                                      cx, cy, cz);
        v[r] = in ? (s < K ? heat_bf16_round(n) : n) : cc;
      }
    }
    if (s < K) {
      float* dst = lev + ((s - 1) * 2 + par) * ps + me;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dst[r * bz] = v[r];
        up[s][r] = mid[s][r];
        mid[s][r] = down[s][r];
        down[s][r] = v[r];
      }
    } else if (out_cell != nullptr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((out_rows >> r) & 1u) {
          if constexpr (kF32)
            out_cell[r * out_row] = v[r];
          else
            heat_store(out_cell + r * out_row, v[r],
                       x_in && ((yz_in >> r) & 1u));
          if (x_in && ((yz_in >> r) & 1u))
            *rmax = max(*rmax, heat_diff_bits(v[r], mid[K - 1][r]));
        }
      }
    }
  }
}

// heat_f_levels at bfloat16 with the levels' registers packed: levels 0
// .. K-1 hold bfloat16 values (level 0 widened cells, each level below K
// rounded, copied cells keeping their bits), so rows 2i and 2i + 1 of a
// plane share one word (row 2i in the low half), half the registers of
// the float layout, widened exactly where they are read. The arithmetic,
// its order and the stores are heat_f_levels', so the bits are.
template <int K, int R, bool kPlanesIn>
__device__ __forceinline__ void heat_f_levels_packed(
    uint32_t (&up)[K][R / 2], uint32_t (&mid)[K][R / 2],
    uint32_t (&down)[K][R / 2], const float* prev0, float* lev, int ps,
    int me, int bz, int par, int64_t t, int64_t nx, unsigned yz_in,
    unsigned out_rows, __nv_bfloat16* out_cell, int64_t out_row, float a0,
    float cx, float cy, float cz, uint32_t* rmax) {
  static_assert(R % 2 == 0, "packed levels pair the rows");
  const auto cell = [](const uint32_t(&w)[R / 2], int r) {
    return __uint_as_float(r & 1 ? w[r >> 1] & 0xffff0000u
                                 : w[r >> 1] << 16);
  };
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    const float* nb =
        s == 1 ? prev0 : lev + ((s - 2) * 2 + (par ^ 1)) * ps + me;
    const bool x_in = kPlanesIn || (t - s >= 1 && t - s <= nx - 2);
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float cc = cell(mid[s - 1], r);
      const float ym = r > 0 ? cell(mid[s - 1], r - 1) : nb[-bz];
      const float yp = r + 1 < R ? cell(mid[s - 1], r + 1) : nb[R * bz];
      const bool in = x_in && ((yz_in >> r) & 1u);
      const float n = heat_combine3(cc, cell(up[s - 1], r),
                                    cell(down[s - 1], r), ym, yp,
                                    nb[r * bz - 1], nb[r * bz + 1], a0, cx,
                                    cy, cz);
      v[r] = in ? (s < K ? heat_bf16_round(n) : n) : cc;
    }
    if (s < K) {
      float* dst = lev + ((s - 1) * 2 + par) * ps + me;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * bz] = v[r];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        up[s][i] = mid[s][i];
        mid[s][i] = down[s][i];
        down[s][i] = (__float_as_uint(v[2 * i]) >> 16) |
                     (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
      }
    } else if (out_cell != nullptr) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((out_rows >> r) & 1u) {
          heat_store(out_cell + r * out_row, v[r],
                     x_in && ((yz_in >> r) & 1u));
          if (x_in && ((yz_in >> r) & 1u))
            *rmax = max(*rmax, heat_diff_bits(v[r], cell(mid[K - 1], r)));
        }
      }
    }
  }
}

// The plane loop of one thread block, blockDim = (bz, by): the extended
// tile is bz wide and by * R rows deep. Output planes [x0, x1) of the
// caller's coordinates, whose plane 0 is global plane gx of an nx-plane
// grid. Level K of plane x lands at out + x * out_plane + out_col (this
// thread's row 0; row r's r * out_row further) where out_rows says so.
// The residual of the cells written, over the global interior, is folded
// into *res when res is not null. Every thread of the block calls it.
template <int K, int R, class Load>
__device__ __forceinline__ void heat_t3d_stream(
    Load load, int64_t x0, int64_t x1, int64_t gx, int64_t nx,
    unsigned yz_in, unsigned out_rows, float* out, int64_t out_plane,
    int64_t out_col, int64_t out_row, float a0, float cx, float cy, float cz,
    uint32_t* res) {
  extern __shared__ __align__(128) float smem[];
  const int bz = blockDim.x;
  const int wy = blockDim.y * R;             // extended tile rows
  const int ps = (wy + 2) * bz;              // a plane and its two pad rows
  float* ring = smem;                        // kFSlots input planes
  float* lev = smem + kFSlots * ps;          // levels 1 .. K-1, two each
  const int me = bz + threadIdx.y * R * bz + threadIdx.x;
  const int64_t t0 = x0 - K, t1 = x1 + K;

  // Input plane t0 + i lives in ring slot i % kFSlots.
  for (int i = 0; i < kFPrefetch; ++i) {
    if (t0 + i < t1) load(ring + i * ps + me, t0 + i);
    __pipeline_commit();
  }
  float up[K][R], mid[K][R], down[K][R];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) up[s][r] = mid[s][r] = down[s][r] = 0.f;
  uint32_t rmax = 0u;
  int cur = 0;  // ring slot of plane t
  for (int64_t t = t0; t < t1; ++t) {
    // Plane t has landed, for every thread once past the barrier, which
    // also ends the last iteration's reads of the slot refilled next.
    __pipeline_wait_prior(kFPrefetch - 1);
    __syncthreads();
    const int prev = cur == 0 ? kFSlots - 1 : cur - 1;
    if (t + kFPrefetch < t1) {
      int next = cur + kFPrefetch;
      if (next >= kFSlots) next -= kFSlots;
      load(ring + next * ps + me, t + kFPrefetch);
    }
    __pipeline_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      up[0][r] = mid[0][r];
      mid[0][r] = down[0][r];
      down[0][r] = ring[cur * ps + me + r * bz];
    }
    float* out_cell = out_rows != 0u && t - K >= x0 && t - K < x1
                          ? out + (t - K) * out_plane + out_col
                          : nullptr;
    const int par = static_cast<int>(t & 1);
    const int64_t g = gx + t;
    if (g - K >= 1 && g - 1 <= nx - 2)
      heat_f_levels<K, R, true>(up, mid, down, ring + prev * ps + me, lev, ps,
                                me, bz, par, g, nx, yz_in, out_rows, out_cell,
                                out_row, a0, cx, cy, cz, &rmax);
    else
      heat_f_levels<K, R, false>(up, mid, down, ring + prev * ps + me, lev,
                                 ps, me, bz, par, g, nx, yz_in, out_rows,
                                 out_cell, out_row, a0, cx, cy, cz, &rmax);
    cur = cur + 1 == kFSlots ? 0 : cur + 1;
  }
  if (res != nullptr) heat_block_max(rmax, res);
}

// The TMA ring (heat_t3d_stream_tma): kTmaPrefetch planes in flight, one
// box each, so fewer than cp.async's kFPrefetch, and its slots' layout.
// A box starts at a z that is a multiple of 4 cells (16 bytes: TMA
// faults on a box whose innermost start is not), so it is 4 cells wider
// than the tile, and a row of a slot is row = wz + 4 floats; the tile's
// first cell lies zoff = z0 % 4 cells into its row. A slot holds a lead
// of at least one row, 128-byte aligned, so that the box lands aligned
// and row 0's upper neighbour reads stay in the slot, the wy rows and a
// bottom row for the last row's lower neighbours, rounded up to 128
// bytes.
constexpr int kTmaPrefetch = 4;
constexpr int kTmaSlots = kTmaPrefetch + 2;

struct HeatTmaPlane {
  int row, lead, ps;  // floats
};

__host__ __device__ constexpr HeatTmaPlane heat_tma_plane(int wy, int wz) {
  return {wz + 4, (wz + 4 + 31) / 32 * 32,
          ((wz + 4 + 31) / 32 * 32 + (wy + 1) * (wz + 4) + 31) / 32 * 32};
}

// heat_t3d_stream with the input planes brought by TMA. Input plane t of
// the caller's coordinates is the box of `map` at (z0 - z0 % 4, y0, t): a
// (wz + 4) x wy box (blockDim.x + 4 by blockDim.y * R) of one plane,
// zeros where it lies outside the tensor; it lands in its ring slot past
// the slot's lead. The planes that the map does not hold come as in
// heat_t3d_stream, from every thread's cp.async: `slab(dst, row, t)`
// issues this thread's copies of plane t (row r's to dst + r * row) and
// returns true, or returns false for a plane of the map. The step phase
// is heat_t3d_stream's, heat_f_levels with the slots' row length, so the
// bits are.
//
// Ordering. Slot s has one mbarrier, armed once per plane it receives:
// by the box's bytes (a TMA plane) or by a plain arrival (a cp.async
// plane, whose copies every thread waits for as before); a thread waits
// on the slot of plane t with the parity of the slot's use, the lap of
// the ring. A slot is refilled after the barrier that ends the last reads
// of its old plane, and the leader's proxy fence orders those generic
// reads (and any cp.async writes into the slot) before the async write.
template <int K, int R, class Slab>
__device__ __forceinline__ void heat_t3d_stream_tma(
    const CUtensorMap* map, int z0, int y0, Slab slab, int64_t x0,
    int64_t x1, int64_t gx, int64_t nx, unsigned yz_in, unsigned out_rows,
    float* out, int64_t out_plane, int64_t out_col, int64_t out_row,
    float a0, float cx, float cy, float cz, uint32_t* res) {
  extern __shared__ __align__(128) float smem[];
  const int wy = blockDim.y * R;             // extended tile rows
  const HeatTmaPlane pl = heat_tma_plane(wy, blockDim.x);
  const int row = pl.row, ps = pl.ps;
  // kTmaSlots input planes from the first 128-byte boundary, the levels,
  // then the slots' mbarriers (heat_t3d_tma_smem_bytes). An offset into
  // smem, not an address rounded as an integer, so that the compiler
  // still knows the ring for shared memory (LDS and STS, not generic
  // loads and stores).
  float* ring = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  float* lev = ring + kTmaSlots * ps;        // levels 1 .. K-1, two each
  uint64_t* full = reinterpret_cast<uint64_t*>(lev + 2 * (K - 1) * ps);
  const int zoff = z0 & 3;
  const int me = pl.lead + threadIdx.y * R * row + zoff + threadIdx.x;
  const int64_t t0 = x0 - K, t1 = x1 + K;
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;
  const uint32_t box_bytes = static_cast<uint32_t>(sizeof(float) * wy * row);
  if (leader) {
    for (int i = 0; i < kTmaSlots; ++i) heat_mbar_init(&full[i]);
    heat_mbar_init_fence();
  }
  __syncthreads();
  auto fetch = [&](int slot, int64_t t) {
    float* plane = ring + slot * ps;
    if (slab(plane + me, row, t)) {
      if (leader) heat_mbar_arrive(&full[slot]);
    } else if (leader) {
      heat_mbar_expect(&full[slot], box_bytes);
      heat_tma_load_3d(plane + pl.lead, map, &full[slot], z0 - zoff, y0,
                       static_cast<int>(t));
    }
  };

  // Input plane t0 + i lives in ring slot i % kTmaSlots.
  for (int i = 0; i < kTmaPrefetch; ++i) {
    if (t0 + i < t1) fetch(i, t0 + i);
    __pipeline_commit();
  }
  float up[K][R], mid[K][R], down[K][R];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) up[s][r] = mid[s][r] = down[s][r] = 0.f;
  uint32_t rmax = 0u;
  int cur = 0;          // ring slot of plane t
  uint32_t lap = 0u;    // parity of the ring's lap: of slot cur's use
  for (int64_t t = t0; t < t1; ++t) {
    // Plane t has landed, for every thread once past the barrier, which
    // also ends the last iteration's reads of the slot refilled next.
    __pipeline_wait_prior(kTmaPrefetch - 1);
    heat_mbar_wait(&full[cur], lap);
    __syncthreads();
    const int prev = cur == 0 ? kTmaSlots - 1 : cur - 1;
    if (t + kTmaPrefetch < t1) {
      int next = cur + kTmaPrefetch;
      if (next >= kTmaSlots) next -= kTmaSlots;
      if (leader) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(next, t + kTmaPrefetch);
    }
    __pipeline_commit();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      up[0][r] = mid[0][r];
      mid[0][r] = down[0][r];
      down[0][r] = ring[cur * ps + me + r * row];
    }
    float* out_cell = out_rows != 0u && t - K >= x0 && t - K < x1
                          ? out + (t - K) * out_plane + out_col
                          : nullptr;
    const int par = static_cast<int>(t & 1);
    const int64_t g = gx + t;
    if (g - K >= 1 && g - 1 <= nx - 2)
      heat_f_levels<K, R, true>(up, mid, down, ring + prev * ps + me, lev, ps,
                                me, row, par, g, nx, yz_in, out_rows,
                                out_cell, out_row, a0, cx, cy, cz, &rmax);
    else
      heat_f_levels<K, R, false>(up, mid, down, ring + prev * ps + me, lev,
                                 ps, me, row, par, g, nx, yz_in, out_rows,
                                 out_cell, out_row, a0, cx, cy, cz, &rmax);
    if (++cur == kTmaSlots) {
      cur = 0;
      lap ^= 1u;
    }
  }
  if (res != nullptr) heat_block_max(rmax, res);
}

// Dynamic shared memory of one heat_t3d_stream_tma block at depth k,
// extended tile wy x wz: the planes, 128 bytes to align them, the
// mbarriers.
inline int heat_t3d_tma_smem_bytes(int k, int wy, int wz) {
  return static_cast<int>(sizeof(float)) * (kTmaSlots + 2 * (k - 1)) *
             heat_tma_plane(wy, wz).ps +
         128 + static_cast<int>(sizeof(uint64_t)) * kTmaSlots;
}

// Dynamic shared memory of one block at depth k, extended tile wy x bz.
inline int heat_t3d_smem_bytes(int k, int wy, int bz) {
  return static_cast<int>(sizeof(float)) * (kFSlots + 2 * (k - 1)) *
         (wy + 2) * bz;
}

// --- H-fused's bfloat16 plane loop (heat_h.cuh heat_h_body_bf16) --------
//
// heat_f_levels on bfloat16 planes, with no load that a thread waits for
// before the step of its plane. A plane reaches the float32 ring, where
// the step reads it as at float32, in two halves: its copies, issued
// kHBf16Prefetch planes ahead into a staging slot, and its landing at the
// top of its own iteration, where each thread widens its cells from the
// slot into the ring before the barrier that publishes the plane. The
// caller's `rows` says which copy a plane takes:
//   - a TMA box (kTma; the tiles inside the block, `rows.box(t)`): one
//     thread asks for the plane's extended tile as one (wz + 8) x wy box
//     of the block's bfloat16 tensor map, from a z that is a multiple of 8
//     cells (16 bytes), on the slot's mbarrier; every thread widens its R
//     cells from the box;
//   - otherwise a 4-byte cp.async a cell: each thread copies the aligned
//     4-byte word that holds its cell (cp.async has no 2-byte copy) into
//     its own word of the slot, and widens the word's half that is its
//     cell as it lands. The word never leaves the cell's allocation,
//     whose base is 4-byte aligned and whose size is rounded up past it.
// Cells with no data (outside the grid or the K-deep frame) land as
// zeros. The float32 ring holds three planes: plane t lands while slower
// threads may still step plane t - 1, reading it and plane t - 2. A
// staging slot is refilled after the barrier that ends its landing (the
// leader's proxy fence orders those reads before a box's write). The
// levels, their rounding and the stores are heat_f_levels', so the bits
// are those of heat_t3d_stream on the same cells.

// Planes in flight (ops/hopper_params.py h_tma_prefetch), a staging slot
// each.
constexpr int kHBf16Prefetch = kTmaPrefetch;

// Bytes of a staging slot for an extended tile of wy x wz cells (wz a
// multiple of 32): a word a thread and row, which also holds a box,
// 2 (wz + 8) wy bytes.
__host__ __device__ constexpr int heat_h_bf16_slot_bytes(int wy, int wz) {
  return 4 * wz * wy;
}

// Dynamic shared memory of one heat_t3d_stream_bf16 block at depth k,
// extended tile wy x wz: 128 bytes to align the staging slots, the slots,
// the three ring planes and two planes for each level 1 .. k-1 (each
// padded by a row above and below), an mbarrier a slot.
inline int heat_h_bf16_smem_bytes(int k, int wy, int wz) {
  return 128 + kHBf16Prefetch * heat_h_bf16_slot_bytes(wy, wz) +
         static_cast<int>(sizeof(float)) * (3 + 2 * (k - 1)) * (wy + 2) *
             wz +
         static_cast<int>(sizeof(uint64_t)) * kHBf16Prefetch;
}

// heat_t3d_stream's plane loop for the bfloat16 block `out` (its
// arguments), the input planes brought as above. `rows` gives this
// thread's cells: rows.cell(r, t), the bfloat16 cell of row r in input
// plane t (null: no data), and rows.box(t), whether plane t comes as a
// box of `map` at (z0 - z0 % 8, y0, t) (kTma only). kPacked: the levels'
// registers packed (heat_f_levels_packed), the same bits.
template <int K, int R, bool kTma, bool kPacked, class Rows>
__device__ __forceinline__ void heat_t3d_stream_bf16(
    const Rows& rows, const CUtensorMap* map, int z0, int y0, int64_t x0,
    int64_t x1, int64_t gx, int64_t nx, unsigned yz_in, unsigned out_rows,
    __nv_bfloat16* out, int64_t out_plane, int64_t out_col, int64_t out_row,
    float a0, float cx, float cy, float cz, uint32_t* res) {
  extern __shared__ __align__(128) float smem[];
  constexpr int P = kHBf16Prefetch;
  const int wz = blockDim.x;
  const int wy = blockDim.y * R;             // extended tile rows
  const int ps = (wy + 2) * wz;              // a plane and its two pad rows
  const int slot_w = heat_h_bf16_slot_bytes(wy, wz) / 4;  // words
  // The slots from the first 128-byte boundary, the ring, the levels and
  // the mbarriers; offsets into smem, so that the compiler keeps them in
  // shared memory.
  uint32_t* slots = reinterpret_cast<uint32_t*>(
      smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4);
  float* ring = reinterpret_cast<float*>(slots + P * slot_w);
  float* lev = ring + 3 * ps;                // levels 1 .. K-1, two each
  uint64_t* full = reinterpret_cast<uint64_t*>(lev + 2 * (K - 1) * ps);
  const int row0 = threadIdx.y * R;
  const int me = wz + row0 * wz + threadIdx.x;  // row 0 is the pad row
  const int word = row0 * wz + threadIdx.x;     // its words in a slot
  const int zoff = z0 & 7;
  const int bw = wz + 8;                        // cells of a box row
  const int box_at = row0 * bw + zoff + threadIdx.x;  // its box cells
  const uint32_t box_bytes = static_cast<uint32_t>(2 * bw * wy);
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;
  const int64_t t0 = x0 - K, t1 = x1 + K;
  if constexpr (kTma) {
    if (leader) {
      for (int i = 0; i < P; ++i) heat_mbar_init(&full[i]);
      heat_mbar_init_fence();
    }
    __syncthreads();
  }

  // The box, or this thread's words, of plane t into slot s.
  auto issue = [&](int s, int64_t t) {
    if constexpr (kTma) {
      if (rows.box(t)) {
        if (leader) {
          heat_mbar_expect(&full[s], box_bytes);
          heat_tma_load_3d(reinterpret_cast<float*>(slots + s * slot_w), map,
                           &full[s], z0 - zoff, y0, static_cast<int>(t));
        }
        return;
      }
      if (leader) heat_mbar_arrive(&full[s]);
    }
    uint32_t* dst = slots + s * slot_w + word;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint16_t* p = rows.cell(r, t);
      // The word's first cell: the one before p where p is 2 mod 4.
      if (p != nullptr)
        __pipeline_memcpy_async(
            dst + r * wz, p - ((reinterpret_cast<uintptr_t>(p) >> 1) & 1u),
            4);
    }
  };
  // Plane t from slot s (its phase of parity `lap`), widened into ring
  // plane f.
  auto land = [&](int f, int s, int64_t t, uint32_t lap) {
    float* dst = ring + f * ps + me;
    if constexpr (kTma) {
      // Every plane completes a phase of its slot's barrier (a box's
      // bytes, or the leader's arrival for a plane of words).
      heat_mbar_wait(&full[s], lap);
      if (rows.box(t)) {
        const uint16_t* box =
            reinterpret_cast<const uint16_t*>(slots + s * slot_w) + box_at;
#pragma unroll
        for (int r = 0; r < R; ++r)
          dst[r * wz] = __uint_as_float(static_cast<uint32_t>(box[r * bw])
                                        << 16);
        return;
      }
    }
    const uint16_t* src =
        reinterpret_cast<const uint16_t*>(slots + s * slot_w + word);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint16_t* p = rows.cell(r, t);
      // The cell is the word's upper half at an address of 2 mod 4.
      const int half =
          static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 1) & 1;
      const uint32_t c = src[2 * r * wz + half];
      dst[r * wz] = p == nullptr ? 0.f : __uint_as_float(c << 16);
    }
  };

  // Input plane t0 + i lives in staging slot i % P and ring plane i % 3.
  for (int i = 0; i < P; ++i) {
    if (t0 + i < t1) issue(i, t0 + i);
    __pipeline_commit();
  }
  // Levels 0 .. K-1 of this thread's cells, three planes each: floats, or
  // pairs of rows packed in a word.
  constexpr int kW = kPacked ? R / 2 : R;
  using Lv = typename std::conditional<kPacked, uint32_t, float>::type;
  Lv up[K][kW], mid[K][kW], down[K][kW];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int r = 0; r < kW; ++r) up[s][r] = mid[s][r] = down[s][r] = Lv{0};
  uint32_t rmax = 0u;
  int cur = 0;           // staging slot of plane t
  uint32_t lap = 0u;     // parity of slot cur's use
  int f = 0, fprev = 2;  // ring planes of t and t - 1
  for (int64_t t = t0; t < t1; ++t) {
    // This thread's copies of plane t have landed; its cells go into the
    // ring, published by the barrier, which also ends every thread's
    // landing from slot cur and its reads of ring plane (t + 1) % 3.
    __pipeline_wait_prior(P - 1);
    land(f, cur, t, lap);
    __syncthreads();
    if (t + P < t1) {
      if (kTma && leader)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(cur, t + P);
    }
    __pipeline_commit();
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      up[0][r] = mid[0][r];
      mid[0][r] = down[0][r];
      if constexpr (kPacked)
        down[0][r] =
            (__float_as_uint(ring[f * ps + me + 2 * r * wz]) >> 16) |
            (__float_as_uint(ring[f * ps + me + (2 * r + 1) * wz]) &
             0xffff0000u);
      else
        down[0][r] = ring[f * ps + me + r * wz];
    }
    __nv_bfloat16* out_cell = out_rows != 0u && t - K >= x0 && t - K < x1
                                  ? out + (t - K) * out_plane + out_col
                                  : nullptr;
    const int par = static_cast<int>(t & 1);
    const int64_t g = gx + t;
    const float* prev0 = ring + fprev * ps + me;
    if constexpr (kPacked) {
      if (g - K >= 1 && g - 1 <= nx - 2)
        heat_f_levels_packed<K, R, true>(up, mid, down, prev0, lev, ps, me,
                                         wz, par, g, nx, yz_in, out_rows,
                                         out_cell, out_row, a0, cx, cy, cz,
                                         &rmax);
      else
        heat_f_levels_packed<K, R, false>(up, mid, down, prev0, lev, ps, me,
                                          wz, par, g, nx, yz_in, out_rows,
                                          out_cell, out_row, a0, cx, cy, cz,
                                          &rmax);
    } else {
      if (g - K >= 1 && g - 1 <= nx - 2)
        heat_f_levels<K, R, true>(up, mid, down, prev0, lev, ps, me, wz, par,
                                  g, nx, yz_in, out_rows, out_cell, out_row,
                                  a0, cx, cy, cz, &rmax);
      else
        heat_f_levels<K, R, false>(up, mid, down, prev0, lev, ps, me, wz,
                                   par, g, nx, yz_in, out_rows, out_cell,
                                   out_row, a0, cx, cy, cz, &rmax);
    }
    fprev = f;
    f = f == 2 ? 0 : f + 1;
    if (++cur == P) {
      cur = 0;
      lap ^= 1u;
    }
  }
  if (res != nullptr) heat_block_max(rmax, res);
}

// --- Kernel F's register-blocked plane loop (heat_f_temporal3d.cu) ------
//
// The 3D analog of heat_temporal.cuh's tile loop. A thread block is 32
// lanes by W warps; the extended tile is kFWidth = 128 cells along Z by
// W * R rows along Y, and its input planes stream down X with all K
// levels in flight, as in heat_t3d_stream:
//   - a lane owns a group of 4 adjacent z cells of R consecutive rows, one
//     float4 a row, so a warp spans one 128-cell row of the tile; Z
//     neighbours come from the lanes beside it (warp shuffles). Lane 0's
//     left and lane 31's right neighbour lie outside the K-step cone of
//     the outputs, and take the lane's own cell;
//   - Y neighbours inside a thread's R rows are registers; only its first
//     and last rows go to shared memory, per level and plane, for the
//     warps above and below, which read them back as float4 (the level
//     buffers hold those edge rows only, two per warp and level, by the
//     plane's parity, with a pad row at each end);
//   - X neighbours are registers: per level the planes below, at and
//     above the one being stepped, three float4 arrays that the plane
//     loop, unrolled by 3, renames instead of copying (12 K R floats a
//     thread: 72 at K = 3, R = 2, where the instance takes 122 registers
//     of the 128 its 512-thread launch bound allows; at K = 4 it spills,
//     so R = 2 and K = 3 are the defaults, and 4 rows a thread are
//     compiled for 8 warps at most, which lets them take 255);
//   - level 0's Y neighbours come from the previous input plane, which
//     stays in its ring slot; one block barrier per plane orders it all.
// Shared traffic per level and R rows: two float4 read and two written
// at the thread's edge rows, two shuffles per group: at K = 3 and R = 2
// the test-free step compiles to 15.9 instructions a cell-step, 10 of
// them the combine's rounded operations, and 6.7 bytes of shared memory;
// 18.0 and 8 with the plane's wait, barrier and refill (bench_kernels
// --sass; PERF.md).
//
// The tile's output cells are rows [K, W R - K) and cells [P, 128 - P)
// with P = heat_f_pad(K), the halo rounded up to a whole group, so that a
// tile's first cell along Z, z0 = tile * (128 - 2P) - P, is a multiple of
// 4 and a plane's tile is one TMA box of the grid (nz % 4 == 0).
//
// Why the bits hold. Every step updates whole groups and rows, so it also
// writes cells outside the K-step cone of the outputs: cells [0, s) and
// [128 - s, 128) of a row at level s (lane 0 and 31's borrowed
// neighbours), the rows [0, s) and [W R - s, W R) (the pad rows), and
// the planes the stream has not yet reached (zeros at the start). A cell
// valid at level s reads only cells valid at level s - 1, so none of
// those values reaches an output (P >= K along Z, K rows along Y, K
// planes along X). Cells outside the global interior are copied, never
// computed, and cells outside the grid load as 0, so the Dirichlet faces
// stay bit-exact and every step rounds to float32 like a launch of
// heat_d_step3d: K steps are bitwise K launches of D.
//
// The planes arrive in a ring of `prefetch` + 2 slots, each a lead row,
// the tile's rows and a tail row (the lead and tail are the first and
// last rows' level-0 neighbours, never written); slot s completes an
// mbarrier per use. By TMA (kTma) one thread asks for a plane's tile as
// one box of a 3D tensor map of the grid, zero-filled outside it; by
// cp.async every thread copies its own cells, 4 bytes each with zero fill
// outside the grid, and arrives on the slot's barrier once they have
// landed (heat_cp_async_arrive). Both wait on the barrier, then on the
// block's.

constexpr int kFLanes = 32;
constexpr int kFWidth = 4 * kFLanes;  // cells of the extended tile along Z
constexpr int kFMaxK = 8;             // ops/hopper_params.py f_k_compiled
constexpr int kFMaxPrefetch = 8;      // ops/hopper_params.py f_prefetch_max

// The halo along Z at depth k on a grid of `elem`-byte cells: k rounded
// up to 16 bytes of cells, a whole group of float32 cells or two of
// bfloat16 ones, so that a tile's box starts on 16 bytes.
__host__ __device__ constexpr int heat_f_pad(int k, int elem = 4) {
  return elem == 2 ? (k + 7) / 8 * 8 : (k + 3) / 4 * 4;
}

// Warps a thread block of `rows` rows a thread may have at depth k on a
// grid of `elem`-byte cells: 16 (512 threads, up to 128 registers), or 8
// at 4 rows, whose instances take up to 255 (their launch bound); the
// bfloat16 form's instances of 1 or 2 rows at K >= 4 are bound at 12
// (384 threads, up to 168 registers): at 128 they spilled more than
// their float32 twins (PERF.md §6).
__host__ __device__ constexpr int heat_f_max_warps(int rows, int k = 1,
                                                   int elem = 4) {
  return rows == 4 ? 8 : elem == 2 && k >= 4 ? 12 : 16;
}

// The launch shapes the loop takes on a grid of `elem`-byte cells
// (ops/hopper_params.py f_takes is the same rule): 32 lanes by W warps of
// 1, 2 or 4 rows a thread, at most heat_f_max_warps(rows, k, elem) warps,
// depth 1 .. kFMaxK, and at least one output row (2k < W R; along Z the
// tile has 128 - 2 heat_f_pad(k, elem) >= 112 output cells).
inline bool heat_f_takes(int block_x, int block_y, int rows, int k,
                         int elem = 4) {
  return block_x == kFLanes && (rows == 1 || rows == 2 || rows == 4) &&
         block_y >= 1 && block_y <= heat_f_max_warps(rows, k, elem) &&
         k >= 1 && k <= kFMaxK && 2 * k < block_y * rows;
}

// Cells of a ring slot (a lead row, wy rows, a tail row: floats, or the
// grid's bfloat16 cells) and floats of a level buffer (min(R, 2) edge
// rows a warp and two pad rows).
__host__ __device__ constexpr int heat_f_slot_floats(int wy) {
  return (wy + 2) * kFWidth;
}
__host__ __device__ constexpr int heat_f_edge_floats(int warps, int rows) {
  return ((rows < 2 ? rows : 2) * warps + 2) * kFWidth;
}

// Dynamic shared memory of one F block on a grid of `elem`-byte cells
// (ops/hopper_params.py f_smem_bytes): 128 bytes to align the ring,
// prefetch + 2 slots of the grid's cells, two float32 level buffers for
// each level 1 .. k-1, an 8-byte mbarrier a slot.
inline int heat_f_smem_bytes(int k, int warps, int rows, int prefetch,
                             int elem = 4) {
  return elem * (prefetch + 2) * heat_f_slot_floats(warps * rows) +
         4 * 2 * (k - 1) * heat_f_edge_floats(warps, rows) + 128 +
         8 * (prefetch + 2);
}

// The plane loop's compile-time variants. F runs kHeatFFull; the others
// belong to the overlap probe (heat_probe_xslab_overlap.cu,
// tools/probe_xslab_overlap.py) and compute nothing to compare:
//   - kHeatFNoStep: the stream alone. Every plane is loaded, waited for
//     and refilled as in F, and each output plane's cells are stored as F
//     stores them (the input plane's cells, from its slot), but no level
//     is stepped;
//   - kHeatFNoLoad: the compute alone. The first `prefetch` planes are
//     loaded and waited for as in F; then nothing is loaded or waited for
//     and the levels step over the ring as it lies, the barrier a plane
//     kept. No copy is left in flight: every plane loaded is waited for.
constexpr int kHeatFFull = 0;
constexpr int kHeatFNoStep = 1;
constexpr int kHeatFNoLoad = 2;
// The kernel audit's record variant: kHeatFFull, and the leader writes
// each plane's load down (heat_record_load) at record blockIdx.x * (nx +
// 2K) + (t - x0 + K) of `rec` (the residual's buffer).
constexpr int kHeatFRecord = 3;
// The loop's planes from a sharded block's pieces, one band a thread
// block (HeatFLoop's kBand; heat_h_band_fix_3d.cu).
constexpr int kHeatFBand = 1;
// The layouts of a bfloat16 loop's levels (HeatFLoop's kBf16). Both
// compute the same function, bit for bit; they differ in what ptxas makes
// of them at the register budget, and the bfloat16 kernel takes one a
// (K, rows, load) instance (heat_f_temporal3d_bf16.cu heat_f_bf16_layout).
// Measured and dropped (PERF.md §6): float4 levels rounded a cell at a
// time, packed levels widened where each is read, widened by a volatile
// asm (spill no smaller), and the cp.async load as one zero-filled copy of
// a group's prefix (slower).
constexpr int kHeatFBf16None = 0;    // the float32 loop
constexpr int kHeatFBf16Pair = 1;    // float4 levels, rounded two at once
constexpr int kHeatFBf16Packed = 2;  // packed levels, a level widened once

// One thread's state of the loop. The kernel fills the geometry; run()
// streams the planes. kProbe is the loop's variant (kHeatFFull but in the
// overlap probe). kCirc: the planes come from kernel H's assembled
// circular block (heat_h_block_3d.cu), not from the grid; kBand
// (kHeatFBand): from a sharded block's separate pieces
// (heat_h_band_fix_3d.cu), one band (run_band, band_fetch, band_step;
// the caller's Seg loads the planes) with the levels outside the
// output's cone not stepped. Only fetch() differs for
// kCirc, and levels() for kBand, under `if constexpr`, so F's instances
// keep their code.
//
// Storage precision (kernel F's bfloat16 form, heat_f_temporal3d_bf16.cu,
// and the bfloat16 forms of kernel H and the band, heat_h_block_3d_bf16.cu
// and heat_h_band_fix_3d_bf16.cu: kCirc's fetch has a bfloat16 branch,
// the band's Seg loads bfloat16 pieces, and both layouts skip the band's
// levels outside the cone).
// Tin and Tout are the grid's cells in and out, kBf16 the layout of a
// bfloat16 loop's levels (kHeatFBf16*, above), every level below K
// rounded to bfloat16 (storage mode, the only bfloat16 mode in 3D: the JAX
// kernel stores each level in the grid's dtype); the defaults are the
// float32 loop, whose expressions stay as they were under `if constexpr`.
// The ring holds Tin: a bfloat16 row is 256 bytes, and a lane widens its
// 4 cells on its one 8-byte shared load, of the current plane (level 0's
// cells) and of the previous one (level 0's Y neighbours past the
// thread's rows). The arithmetic and the level buffers stay float32, the
// levels' registers float4 (kHeatFBf16Pair) or packed bfloat16
// (kHeatFBf16Packed, levels_packed); a level s < K is rounded, two cells
// by one cvt.rn.bf16x2.f32, before the copied cells are restored (they
// keep their bits), so K levels are bitwise K launches of
// heat_d_step3d_bf16. Level K's float32 update against level K - 1 is the
// residual, before the store rounds the updated cells and narrows the
// copied ones exactly, 8 bytes a group where the rows allow it. A
// bfloat16 tile's halo along Z is 8 cells (heat_f_pad), so that its TMA
// box (128 cells, 256-byte rows) starts on 16 bytes; by cp.async a lane
// copies its 4 cells as one 8-byte copy where they lie inside the grid on
// 8 bytes, else as plain 2-byte loads and zeros (cp.async has no 2-byte
// copy), stored before the lane arrives on the slot's barrier and read by
// other threads only past a later block barrier.
template <int K, int R, bool kTma, int kProbe = kHeatFFull,
          bool kCirc = false, int kBand = 0, typename Tin = float,
          typename Tout = float, int kBf16 = kHeatFBf16None>
struct HeatFLoop {
  static constexpr int kEdgeRows = R < 2 ? R : 2;
  static constexpr bool kRecords = kProbe == kHeatFRecord;
  static constexpr bool kF32In = std::is_same<Tin, float>::value;
  static constexpr bool kF32Out = std::is_same<Tout, float>::value;
  static constexpr int kPad = heat_f_pad(K, sizeof(Tin));
  static constexpr bool kRound = kBf16 != kHeatFBf16None;
  // The packed layout keeps the levels as bfloat16 bits, 4 cells of a
  // group in a uint2 (every level below K is a bfloat16 value): half the
  // registers of the float4 levels (levels_packed).
  static constexpr bool kPacked = kBf16 == kHeatFBf16Packed;
  using In = Tin;
  using Reg = typename std::conditional<kPacked, uint2, float4>::type;
  const Tin* u;              // the grid (the cp.async load)
  const CUtensorMap* map;    // its tensor map (the TMA load)
  Tout* out;
  int64_t nx, nz, plane;     // plane: ny * nz
  int64_t x0, x1;            // output planes of this block
  int z0, y0;                // the tile's first cell (TMA coordinates)
  float a0, cx, cy, cz;
  bool vec_out, leader, has_out;
  Tin* ring;                 // slot 0, 128-byte aligned
  float* lev;                // level 1's buffer of parity 0
  uint64_t* full;            // the slots' mbarriers
  int slots, prefetch, slot_f, edge_f;  // slot_f: cells of a slot
  int own;                   // this thread's first cell in a slot
  int lev_first, lev_last;   // its first and last row in a level buffer
  int lev_up, lev_dn;        // the rows above its first and below its last
  int64_t src;               // its first cell's offset in a plane
  unsigned cin;              // bit 4r + j: cell (r, j) lies in the grid
  unsigned yin, zin;         // row r, cell j inside the global interior
  unsigned yout, zout;       // row r, cell j an output of this tile
  uint32_t box_bytes;
  uint32_t* rec;             // kRecords: where each load is written down
  // kCirc: plane t is plane t + xsh of the block's ext_x planes, xpitch
  // floats apart (u is the block); cell (r, j) of this thread lies
  // coff[r] + j floats into a plane. The TMA box is at (z0, y0, t + xsh).
  int64_t xsh, ext_x, xpitch;
  int32_t coff[R];
  int cur;                   // ring slot of the plane being stepped
  uint32_t lap;              // parity of slot cur's use
  uint32_t rmax;

  // Input plane t into ring slot `slot`: zeros outside the grid.
  __device__ __forceinline__ void fetch(int slot, int64_t t) {
    if constexpr (kTma && kCirc) {
      if (leader) {
        heat_mbar_expect(&full[slot], box_bytes);
        heat_tma_load_3d(
            reinterpret_cast<float*>(ring + slot * slot_f + kFWidth), map,
            &full[slot], z0, y0, static_cast<int>(t + xsh));
      }
    } else if constexpr (kTma && kF32In) {
      if (leader) {
        heat_mbar_expect(&full[slot], box_bytes);
        heat_tma_load_3d(ring + slot * slot_f + kFWidth, map, &full[slot],
                         z0, y0, static_cast<int>(t));
      }
    } else if constexpr (kTma) {
      if (leader) {
        heat_mbar_expect(&full[slot], box_bytes);
        heat_tma_load_3d(
            reinterpret_cast<float*>(ring + slot * slot_f + kFWidth), map,
            &full[slot], z0, y0, static_cast<int>(t));
      }
    } else if constexpr (kCirc && !kF32In) {
      // bfloat16 (kernel H's form): one 8-byte copy where the lane's 4
      // cells of a row lie in the K-deep frame on 8 bytes (they lie on one
      // side of the lo seam: a lane's first cell is a multiple of 4, and
      // its cells are all below 0 or none); else a plain 2-byte load a
      // cell in the frame and zeros outside it, as the grid fetch below.
      uint16_t* dst = reinterpret_cast<uint16_t*>(ring + slot * slot_f + own);
      const uint16_t* g = reinterpret_cast<const uint16_t*>(u);
      const int64_t e = t + xsh;
      const bool t_in = e >= 0 && e < ext_x;
      const int64_t base = t_in ? e * xpitch : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uint16_t* d = dst + r * kFWidth;
        const unsigned in = t_in ? (cin >> (4 * r)) & 0xfu : 0u;
        const int64_t at = base + coff[r];
        if (in == 0xfu && ((reinterpret_cast<uintptr_t>(g) +
                            2 * static_cast<uintptr_t>(at)) & 7u) == 0) {
          __pipeline_memcpy_async(d, g + at, 8);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j] = (in >> j) & 1u ? g[at + j] : uint16_t{0};
        }
      }
      heat_cp_async_arrive(&full[slot]);
    } else if constexpr (kCirc) {
      float* dst = ring + slot * slot_f + own;
      const int64_t e = t + xsh;
      const bool t_in = e >= 0 && e < ext_x;
      const int64_t base = t_in ? e * xpitch : 0;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = t_in && ((cin >> (4 * r + j)) & 1u);
          __pipeline_memcpy_async(dst + r * kFWidth + j,
                                  in ? u + (base + coff[r] + j) : u, 4,
                                  in ? 0 : 4);
        }
      heat_cp_async_arrive(&full[slot]);
    } else if constexpr (kF32In) {
      float* dst = ring + slot * slot_f + own;
      const bool t_in = t >= 0 && t < nx;
      const int64_t base = t * plane + src;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = t_in && ((cin >> (4 * r + j)) & 1u);
          __pipeline_memcpy_async(dst + r * kFWidth + j,
                                  in ? u + (base + r * nz + j) : u, 4,
                                  in ? 0 : 4);
        }
      heat_cp_async_arrive(&full[slot]);
    } else {
      // bfloat16: one 8-byte copy where the lane's 4 cells of a row lie
      // inside the grid on 8 bytes; else a plain 2-byte load a cell
      // inside the grid and zeros outside it.
      uint16_t* dst = reinterpret_cast<uint16_t*>(ring + slot * slot_f + own);
      const uint16_t* g = reinterpret_cast<const uint16_t*>(u);
      const bool t_in = t >= 0 && t < nx;
      const int64_t base = t * plane + src;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uint16_t* d = dst + r * kFWidth;
        const unsigned in = t_in ? (cin >> (4 * r)) & 0xfu : 0u;
        const int64_t at = base + r * nz;
        if (in == 0xfu && ((reinterpret_cast<uintptr_t>(g) +
                            2 * static_cast<uintptr_t>(at)) & 7u) == 0) {
          __pipeline_memcpy_async(d, g + at, 8);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j] = (in >> j) & 1u ? g[at + j] : uint16_t{0};
        }
      }
      heat_cp_async_arrive(&full[slot]);
    }
    if constexpr (kRecords) {
      if (leader) {
        const int64_t i = t - (x0 - K);
        const int64_t at = static_cast<int64_t>(blockIdx.x) * (nx + 2 * K);
        // A cp.async fill: each thread's R rows of four 4-byte copies.
        const uint32_t copied =
            kTma ? 0u : 16u * R * blockDim.x * blockDim.y;
        heat_record_load(rec, at + i, z0, y0, static_cast<int>(t), copied,
                         kTma ? box_bytes : 0u, slot,
                         static_cast<uint32_t>((i / slots) & 1));
      }
    }
  }

  // Levels 1 .. K of input plane t (level s at plane t - s) from the
  // planes below (U), at (M) and above (D) each level's cells; level 0's
  // D is plane t, read here from slot cur. Level s < K lands in D[s] and
  // its edge rows in the level buffer of t's parity; level K is written
  // out where plane t - K is this block's. kCheck: some cell may lie
  // outside the global interior (a tile at the grid's edge, or a plane
  // at its X faces); without it every cell is updated.
  template <bool kCheck>
  __device__ __forceinline__ void levels(Reg (&U)[K][R], Reg (&M)[K][R],
                                         Reg (&D)[K][R], int prev,
                                         int64_t t) {
    if constexpr (kPacked) {
      levels_packed<kCheck>(U, M, D, prev, t);
    } else {
      if constexpr (kF32In) {
        const float4* cur4 =
            reinterpret_cast<const float4*>(ring + cur * slot_f + own);
#pragma unroll
        for (int r = 0; r < R; ++r) D[0][r] = cur4[r * (kFWidth / 4)];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          D[0][r] = heat_widen4(ring + cur * slot_f + own + r * kFWidth);
      }
      const Tin* prev_p = ring + prev * slot_f + own;
      const int par = static_cast<int>(t & 1);
      Tout* out_p = has_out && t - K >= x0 && t - K < x1
                        ? out + ((t - K) * plane + src)
                        : nullptr;
#pragma unroll
      for (int s = 1; s <= K; ++s) {
        // kBand: a region is K output planes from 3K input planes, so the
        // output's cone holds level s only at planes [x0 - K + s, x1 + K -
        // s); the levels outside it are not stepped (their cells reach no
        // output, as the cone's garbage never does), 2K^2 - K plane-levels
        // a region of the 3K^2 the loop would step. The level below is
        // passed on in its place, so that every register of a level is
        // written each plane, as in the stepped loop. Uniform across the
        // block.
        if constexpr (kBand != 0) {
          if (t < x0 - K + 2 * s) {
            if (s < K) {
#pragma unroll
              for (int r = 0; r < R; ++r) D[s][r] = M[s - 1][r];
            }
            continue;
          }
        }
        // Level s-1 at plane t - s: M[s-1]; the neighbours of its first and
        // last rows in the warps above and below, from shared memory.
        float4 yu, yd;
        if (s == 1) {
          if constexpr (kF32In) {
            yu = *reinterpret_cast<const float4*>(prev_p - kFWidth);
            yd = *reinterpret_cast<const float4*>(prev_p + R * kFWidth);
          } else {
            yu = heat_widen4(prev_p - kFWidth);
            yd = heat_widen4(prev_p + R * kFWidth);
          }
        } else {
          const float* nb = lev + ((s - 2) * 2 + (par ^ 1)) * edge_f;
          yu = *reinterpret_cast<const float4*>(nb + lev_up);
          yd = *reinterpret_cast<const float4*>(nb + lev_dn);
        }
        const bool x_in = !kCheck || (t - s >= 1 && t - s <= nx - 2);
        float4 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 c = M[s - 1][r];
          const float4 xm = U[s - 1][r];
          const float4 xp = D[s - 1][r];
          const float4 ym = r > 0 ? M[s - 1][r - 1] : yu;
          const float4 yp = r + 1 < R ? M[s - 1][r + 1] : yd;
          const float zl = __shfl_up_sync(0xffffffffu, c.w, 1);
          const float zr = __shfl_down_sync(0xffffffffu, c.x, 1);
          float4 n;
          n.x = heat_combine3(c.x, xm.x, xp.x, ym.x, yp.x, zl, c.y, a0, cx,
                              cy, cz);
          n.y = heat_combine3(c.y, xm.y, xp.y, ym.y, yp.y, c.x, c.z, a0, cx,
                              cy, cz);
          n.z = heat_combine3(c.z, xm.z, xp.z, ym.z, yp.z, c.y, c.w, a0, cx,
                              cy, cz);
          n.w = heat_combine3(c.w, xm.w, xp.w, ym.w, yp.w, c.z, zr, a0, cx,
                              cy, cz);
          if constexpr (kRound) {
            // Before the copied cells are restored: they keep their bits.
            if (s < K)
              n = heat_widen_group(make_uint2(heat_bf16x2_rn(n.x, n.y),
                                              heat_bf16x2_rn(n.z, n.w)));
          }
          if (kCheck) {
            const bool row_in = x_in && ((yin >> r) & 1u);
            n.x = row_in && (zin & 1u) ? n.x : c.x;
            n.y = row_in && (zin & 2u) ? n.y : c.y;
            n.z = row_in && (zin & 4u) ? n.z : c.z;
            n.w = row_in && (zin & 8u) ? n.w : c.w;
          }
          v[r] = n;
        }
        if (s < K) {
          float* dst = lev + ((s - 1) * 2 + par) * edge_f;
          *reinterpret_cast<float4*>(dst + lev_first) = v[0];
          if (R > 1) *reinterpret_cast<float4*>(dst + lev_last) = v[R - 1];
#pragma unroll
          for (int r = 0; r < R; ++r) D[s][r] = v[r];
        } else if (out_p != nullptr) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (!((yout >> r) & 1u)) continue;
            const float4 c = M[K - 1][r];
            const unsigned in =
                kCheck ? (x_in && ((yin >> r) & 1u) ? zout & zin : 0u) : zout;
            if (in & 1u) rmax = max(rmax, heat_diff_bits(v[r].x, c.x));
            if (in & 2u) rmax = max(rmax, heat_diff_bits(v[r].y, c.y));
            if (in & 4u) rmax = max(rmax, heat_diff_bits(v[r].z, c.z));
            if (in & 8u) rmax = max(rmax, heat_diff_bits(v[r].w, c.w));
            Tout* q = out_p + r * nz;
            if constexpr (kF32Out) {
              if (vec_out && zout == 0xfu) {
                *reinterpret_cast<float4*>(q) = v[r];
              } else {
                if (zout & 1u) q[0] = v[r].x;
                if (zout & 2u) q[1] = v[r].y;
                if (zout & 4u) q[2] = v[r].z;
                if (zout & 8u) q[3] = v[r].w;
              }
            } else {
              // Updated cells rounded, copied ones (the faces) narrowed
              // exactly.
              const unsigned upd =
                  kCheck ? (x_in && ((yin >> r) & 1u) ? zin : 0u) : 0xfu;
              heat_bf16_store_group(
                  reinterpret_cast<uint16_t*>(q),
                  heat_bf16_keep(make_uint2(heat_bf16x2_rn(v[r].x, v[r].y),
                                            heat_bf16x2_rn(v[r].z, v[r].w)),
                                 heat_bf16x2_exact(c), upd),
                  zout, vec_out && zout == 0xfu);
            }
          }
        }
      }
    }
  }

  // The bfloat16 storage form's levels (kPacked): levels() with every
  // level below K held as bfloat16 bits, 4 cells in a uint2 (U, M, D), and
  // level 0's cells taken from the ring as they lie. Each level is
  // widened exactly where it is read and computed in float32 as levels()
  // computes it; a level s < K is rounded to bfloat16 (two cells by one
  // cvt.rn.bf16x2.f32, as __float2bfloat16_rn rounds each) and its copied
  // cells restored from the level below by their bits, so it is
  // levels()'s rounded level bit for bit; level K's float32 update gives
  // the residual, and its store rounds the updated cells and keeps the
  // copied ones' bits.
  template <bool kCheck>
  __device__ __forceinline__ void levels_packed(uint2 (&U)[K][R],
                                                uint2 (&M)[K][R],
                                                uint2 (&D)[K][R], int prev,
                                                int64_t t) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      D[0][r] = *reinterpret_cast<const uint2*>(ring + cur * slot_f + own +
                                                r * kFWidth);
    const Tin* prev_p = ring + prev * slot_f + own;
    const int par = static_cast<int>(t & 1);
    Tout* out_p = has_out && t - K >= x0 && t - K < x1
                      ? out + ((t - K) * plane + src)
                      : nullptr;
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      // kBand: the levels outside the output's cone are not stepped, as
      // in levels().
      if constexpr (kBand != 0) {
        if (t < x0 - K + 2 * s) {
          if (s < K) {
#pragma unroll
            for (int r = 0; r < R; ++r) D[s][r] = M[s - 1][r];
          }
          continue;
        }
      }
      float4 yu, yd;
      if (s == 1) {
        yu = heat_widen4(prev_p - kFWidth);
        yd = heat_widen4(prev_p + R * kFWidth);
      } else {
        const float* nb = lev + ((s - 2) * 2 + (par ^ 1)) * edge_f;
        yu = *reinterpret_cast<const float4*>(nb + lev_up);
        yd = *reinterpret_cast<const float4*>(nb + lev_dn);
      }
      const bool x_in = !kCheck || (t - s >= 1 && t - s <= nx - 2);
      // Level s-1's rows, widened once.
      float4 mid[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mid[r] = heat_widen_group(M[s - 1][r]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 c = mid[r];
        const float4 ym = r > 0 ? mid[r - 1] : yu;
        const float4 yp = r + 1 < R ? mid[r + 1] : yd;
        const float4 xm = heat_widen_group(U[s - 1][r]);
        const float4 xp = heat_widen_group(D[s - 1][r]);
        const float zl = __shfl_up_sync(0xffffffffu, c.w, 1);
        const float zr = __shfl_down_sync(0xffffffffu, c.x, 1);
        float4 n;
        n.x = heat_combine3(c.x, xm.x, xp.x, ym.x, yp.x, zl, c.y, a0, cx,
                            cy, cz);
        n.y = heat_combine3(c.y, xm.y, xp.y, ym.y, yp.y, c.x, c.z, a0, cx,
                            cy, cz);
        n.z = heat_combine3(c.z, xm.z, xp.z, ym.z, yp.z, c.y, c.w, a0, cx,
                            cy, cz);
        n.w = heat_combine3(c.w, xm.w, xp.w, ym.w, yp.w, c.z, zr, a0, cx,
                            cy, cz);
        // The cells this level updates; the others keep level s-1's bits.
        const unsigned upd =
            kCheck ? (x_in && ((yin >> r) & 1u) ? zin : 0u) : 0xfu;
        if (s < K) {
          const uint2 p =
              heat_bf16_keep(make_uint2(heat_bf16x2_rn(n.x, n.y),
                                        heat_bf16x2_rn(n.z, n.w)),
                             M[s - 1][r], upd);
          D[s][r] = p;
          if (r == 0 || r == R - 1) {
            float* dst = lev + ((s - 1) * 2 + par) * edge_f;
            *reinterpret_cast<float4*>(dst + (r == 0 ? lev_first
                                                     : lev_last)) =
                heat_widen_group(p);
          }
        } else if (out_p != nullptr && ((yout >> r) & 1u)) {
          const unsigned in = upd & zout;
          if (in & 1u) rmax = max(rmax, heat_diff_bits(n.x, c.x));
          if (in & 2u) rmax = max(rmax, heat_diff_bits(n.y, c.y));
          if (in & 4u) rmax = max(rmax, heat_diff_bits(n.z, c.z));
          if (in & 8u) rmax = max(rmax, heat_diff_bits(n.w, c.w));
          heat_bf16_store_group(
              reinterpret_cast<uint16_t*>(out_p + r * nz),
              heat_bf16_keep(make_uint2(heat_bf16x2_rn(n.x, n.y),
                                        heat_bf16x2_rn(n.z, n.w)),
                             M[s - 1][r], upd),
              zout, vec_out && zout == 0xfu);
        }
      }
    }
  }

  // kHeatFNoStep: input plane t's cells, from slot cur, stored where level
  // K of plane t - K would be, as levels() stores them.
  __device__ __forceinline__ void store_plane(int64_t t) const {
    if (!(has_out && t - K >= x0 && t - K < x1)) return;
    const float4* cur4 =
        reinterpret_cast<const float4*>(ring + cur * slot_f + own);
    float* out_p = out + ((t - K) * plane + src);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!((yout >> r) & 1u)) continue;
      const float4 v = cur4[r * (kFWidth / 4)];
      float* q = out_p + r * nz;
      if (vec_out && zout == 0xfu) {
        *reinterpret_cast<float4*>(q) = v;
      } else {
        if (zout & 1u) q[0] = v.x;
        if (zout & 2u) q[1] = v.y;
        if (zout & 4u) q[2] = v.z;
        if (zout & 8u) q[3] = v.w;
      }
    }
  }

  // One input plane t: wait for it, refill the slot freed by the last
  // plane, step. kEdge: the tile reaches past the global interior.
  template <bool kEdge>
  __device__ __forceinline__ void plane_step(Reg (&U)[K][R],
                                             Reg (&M)[K][R],
                                             Reg (&D)[K][R], int64_t t,
                                             int64_t t1) {
    // Plane t has landed, for every thread once past the barrier, which
    // also ends the last plane's reads of the slot refilled next.
    // kHeatFNoLoad waits only for the planes run() loaded, and loads no
    // more.
    if constexpr (kProbe == kHeatFNoLoad) {
      if (t < x0 - K + prefetch) heat_mbar_wait(&full[cur], lap);
    } else {
      heat_mbar_wait(&full[cur], lap);
    }
    __syncthreads();
    const int prev = cur == 0 ? slots - 1 : cur - 1;
    if constexpr (kProbe != kHeatFNoLoad) {
      if (t + prefetch < t1) {
        int next = cur + prefetch;
        if (next >= slots) next -= slots;
        if (kTma && leader)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch(next, t + prefetch);
      }
    }
    if constexpr (kProbe == kHeatFNoStep) {
      store_plane(t);
    } else {
      if (kEdge || !(t - K >= 1 && t - 1 <= nx - 2))
        levels<true>(U, M, D, prev, t);
      else
        levels<false>(U, M, D, prev, t);
    }
    if (++cur == slots) {
      cur = 0;
      lap ^= 1u;
    }
  }

  // kBand: input plane i of the band into ring slot `slot`: seg.load
  // issues this thread's copies (its R rows of 4 cells, row r's to dst +
  // r * kFWidth, zero-filled where it has no data), then the thread
  // arrives on the slot's barrier once they have landed.
  template <class Seg>
  __device__ __forceinline__ void band_fetch(int slot, int i,
                                             const Seg& seg) {
    seg.load(ring + slot * slot_f + own, i);
    heat_cp_async_arrive(&full[slot]);
  }

  // kBand: plane_step for input plane i in [0, 3K) of the band.
  template <bool kEdge, class Seg>
  __device__ __forceinline__ void band_step(Reg (&U)[K][R], Reg (&M)[K][R],
                                            Reg (&D)[K][R], int i,
                                            const Seg& seg) {
    const int64_t t = x0 - K + i;
    heat_mbar_wait(&full[cur], lap);
    __syncthreads();
    const int prev = cur == 0 ? slots - 1 : cur - 1;
    if (i + prefetch < 3 * K) {
      int next = cur + prefetch;
      if (next >= slots) next -= slots;
      band_fetch(next, i + prefetch, seg);
    }
    if (kEdge || !(t - K >= 1 && t - 1 <= nx - 2))
      levels<true>(U, M, D, prev, t);
    else
      levels<false>(U, M, D, prev, t);
    if (++cur == slots) {
      cur = 0;
      lap ^= 1u;
    }
  }

  // kBand: the band's 3K input planes, after the barriers were
  // initialised: seg.enter sets the output state (out, src, x0, x1, yin,
  // zin) to its block's and region's, then the planes stream through the
  // ring, unrolled by 3 as in run().
  template <bool kEdge, class Seg>
  __device__ __forceinline__ void run_band(const Seg& seg) {
    seg.enter(*this);
    for (int i = 0; i < prefetch; ++i)
      if (i < 3 * K) band_fetch(i, i, seg);
    Reg A[K][R], B[K][R], C[K][R];
    Reg zero;
    if constexpr (kPacked)
      zero = make_uint2(0u, 0u);  // bfloat16 zeros
    else
      zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < K; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) A[s][r] = B[s][r] = C[s][r] = zero;
    // A loop of three planes (the trip count is known, and the compiler
    // would otherwise unroll the K bodies whole).
#pragma unroll 1
    for (int i = 0; i < 3 * K; i += 3) {
      band_step<kEdge>(A, B, C, i, seg);
      band_step<kEdge>(B, C, A, i + 1, seg);
      band_step<kEdge>(C, A, B, i + 2, seg);
    }
  }

  // The block's input planes [x0 - K, x1 + K), after the barriers were
  // initialised. The plane loop is unrolled by 3, so that the three
  // planes of each level are renamed instead of copied.
  template <bool kEdge>
  __device__ __forceinline__ void run() {
    const int64_t t0 = x0 - K, t1 = x1 + K;
    // Input plane t0 + i lives in ring slot i % slots.
    for (int i = 0; i < prefetch; ++i)
      if (t0 + i < t1) fetch(i, t0 + i);
    Reg A[K][R], B[K][R], C[K][R];
    Reg zero;
    if constexpr (kPacked)
      zero = make_uint2(0u, 0u);  // bfloat16 zeros
    else
      zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < K; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) A[s][r] = B[s][r] = C[s][r] = zero;
    for (int64_t t = t0; t < t1;) {
      plane_step<kEdge>(A, B, C, t, t1);
      if (++t >= t1) break;
      plane_step<kEdge>(B, C, A, t, t1);
      if (++t >= t1) break;
      plane_step<kEdge>(C, A, B, t, t1);
      ++t;
    }
  }
};
