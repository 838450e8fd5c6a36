// The step phase of the 3D K-step kernels: heat_f_temporal3d.cu (one
// grid) and the sharded block kernels of heat_h.cuh (heat_h_block_3d.cu,
// heat_h_block_3d_fused.cu, heat_h_band_fix_3d.cu). One arithmetic for
// all of them, so a block's K steps through any of them are bitwise F's
// K steps on the same cells.
//
// A thread block owns a (Y, Z) tile of output cells plus a K-deep halo on
// its four sides, the extended tile, and a segment of output planes
// [x0, x1). It streams the input planes [x0 - K, x1 + K) through shared
// memory, one plane per iteration (cp.async, a ring of kFPrefetch planes
// in flight), and in the iteration that brings input plane t it advances
// every level at once: level s (the grid after s steps) at plane t - s,
// for s = 1 .. K, so level K comes out K planes behind the input. This is
// kernel I's scheme (heat_band.cuh) with planes for rows:
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
// that lie inside its block).

#pragma once

#include <cuda_pipeline.h>

#include "heat_common.cuh"
#include "heat_tma.cuh"

// Input planes prefetched ahead of the one being stepped, and the input
// ring's slots: the planes in flight plus the current and the previous.
// ops/hopper_params.py's f_prefetch must equal kFPrefetch.
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
template <int K, int R, bool kPlanesIn>
__device__ __forceinline__ void heat_f_levels(
    float (&up)[K][R], float (&mid)[K][R], float (&down)[K][R],
    const float* prev0, float* lev, int ps, int me, int bz, int par,
    int64_t t, int64_t nx, unsigned yz_in, unsigned out_rows,
    float* out_cell, int64_t out_row, float a0, float cx, float cy, float cz,
    uint32_t* rmax) {
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
      v[r] = in ? heat_combine3(cc, up[s - 1][r], down[s - 1][r], ym, yp,
                                nb[r * bz - 1], nb[r * bz + 1], a0, cx, cy,
                                cz)
                : cc;
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
          out_cell[r * out_row] = v[r];
          if (x_in && ((yz_in >> r) & 1u))
            *rmax = max(*rmax, heat_diff_bits(v[r], mid[K - 1][r]));
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
