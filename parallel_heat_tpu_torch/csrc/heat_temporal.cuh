// Shared device code of the 2D K-step kernels: the register-blocked tile
// loop (heat_rows, heat_tile_steps), the step phase that follows a
// block's load of its framed tile. Kernels E and E-uni
// (heat_e_temporal.cu, heat_e_uni_temporal.cu, through heat_e_steps) and
// the sharded block kernels G (heat_g.cuh) step through heat_tile_steps:
// a kernel brings its load and the wait for it; the K steps, the last
// store and the residual are this loop's, so a G block's K steps are
// bitwise E's on the same cells. Kernels A and M (heat_a.cuh) step
// through heat_rows in groups, with an exchange of the frame between
// groups.
//
// The tile loop. A warp walks a run of rows of the tile, each lane owning
// a group of 4 adjacent columns with the rows above, at and below it in
// float4 registers. Per row a lane reads the row below with one 16-byte
// load, takes the cell left of its group from the lane to its left and the
// cell right of it from the lane to its right (warp shuffles; lanes 0 and
// 31 read that one cell from shared memory) and stores its 4 results with
// one 16-byte store: 8 bytes of shared traffic and about 10 instructions a
// cell-step, 7 of them the combine's rounded operations (the column walk
// it replaced, a thread a run of rows of one column: 16 bytes and about
// 15). Shared rows are padded so that the core columns
// start on a 16-byte boundary (tile column K at a multiple of 4 floats,
// heat_row_pad and heat_row_floats) in every layout.
//
// Why the bits hold. A step updates the whole 4-column groups that cover
// its valid region (columns [s, TX+2K-s) at step s), so it also writes up
// to 3 cells on each side that lie outside the K-step cone of the outputs,
// computed from stale or never-loaded cells. That changes no output bit: a
// cell valid at step s reads only cells valid at step s-1, so no value
// from outside the cone ever reaches a cell that is written out, and the
// last step stores (and counts in the residual) exactly the output cells.
// Cells outside the global interior are copied, never recomputed, so the
// Dirichlet ring stays bit-exact even in a diverging run, and every step
// rounds to float32 like a launch of heat_b_step: K steps of the loop are
// bitwise K launches of B.
//
// Storage precision (heat_common.cuh). The shared buffers hold float32
// whatever the grid's dtype: a kernel widens a bfloat16 tile as it lands.
// The loop takes the grid's storage type as Tout, the type of the last
// step's store, and kRound: with kRound (bfloat16 storage mode) every
// intermediate level rounds its updated cells to bfloat16 before the next
// step reads them, as a launch of B on a bfloat16 grid stores them, so K
// steps of the loop are still bitwise K single steps; without it (the
// float32 carry of accumulate="f32chunk") the levels stay float32 and only
// the last store rounds. Either way the residual is the last step's
// float32 update against the float32 level it read, before any rounding,
// and the last store rounds the updated cells and narrows the copied ones
// exactly.
//
// Launch shapes (heat_loop_takes; ops/hopper_params.py loop_takes is the
// same rule): thread blocks of 32 x W threads, W <= 16, one warp per row
// of threads, so that the shuffles stay inside a row of lanes; output
// tiles TX a multiple of 4, so that every tile's core starts a group. A
// warp's run of rows is ceil((TY+2K) / W); a row wider than 32 groups is
// walked in passes of 32. The kernels are __launch_bounds__(512), so that
// they may take up to 128 registers a thread and the float4 rows never
// spill (at the 64 a 1024-thread bound allows, they did).

#pragma once

#include <cuda_pipeline.h>

#include <type_traits>

#include "heat_common.cuh"

// v clamped to [lo, hi], as an int (lo and hi are tile coordinates).
__device__ __forceinline__ int heat_clamp_local(int64_t v, int lo, int hi) {
  return static_cast<int>(v < lo ? lo : (v > hi ? hi : v));
}

// --- The register-blocked tile loop ---------------------------------------

// One row of lanes: the launch shapes' thread block is 32 x W, W at most
// kHeatMaxWarps.
constexpr int kHeatLanes = 32;
constexpr int kHeatMaxWarps = 16;
constexpr int kHeatMaxThreads = kHeatLanes * kHeatMaxWarps;
constexpr unsigned kHeatFullWarp = 0xffffffffu;

// Shared-memory layout of one buffer at depth k and tile width tile_x: the
// row stride in floats (a multiple of 4) and the pad that puts tile
// column k on a 16-byte boundary. ops/hopper_params.py row_floats is the
// same rule.
__host__ __device__ __forceinline__ int heat_row_pad(int k) {
  return (4 - k % 4) % 4;
}
__host__ __device__ __forceinline__ int heat_row_floats(int k, int tile_x) {
  return (heat_row_pad(k) + tile_x + 2 * k + 3) / 4 * 4;
}

// The launch shapes the loop takes (ops/hopper_params.py loop_takes is
// the same rule): rows of 32 lanes, at most kHeatMaxWarps of them, output
// tiles whose width is a multiple of 4.
inline bool heat_loop_takes(int tile_y, int tile_x, int block_x,
                            int block_y) {
  return tile_y >= 1 && tile_x >= 4 && tile_x % 4 == 0 &&
         block_x == kHeatLanes && block_y >= 1 && block_y <= kHeatMaxWarps;
}

// Two buffers of tile_y + 2k rows of heat_row_floats (the loop's layout;
// ops/hopper_params.py loop_smem_bytes).
inline size_t heat_loop_smem_bytes(int k, int tile_y, int tile_x) {
  return sizeof(float) * 2 * static_cast<size_t>(tile_y + 2 * k) *
         static_cast<size_t>(heat_row_floats(k, tile_x));
}

// Thread blocks of `kernel`, a kernel of this loop launched at depth k,
// tile and thread block with `extra` bytes of dynamic shared memory past
// the loop's two buffers, that one SM holds at once, into *blocks (the
// CUDA occupancy calculator, registers included). Returns a cudaError_t.
template <typename Kernel>
inline int heat_loop_occupancy(Kernel kernel, int k, int tile_y, int tile_x,
                               int block_x, int block_y, size_t extra,
                               int* blocks) {
  if (blocks == nullptr || k < 1 ||
      !heat_loop_takes(tile_y, tile_x, block_x, block_y))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = heat_loop_smem_bytes(k, tile_y, tile_x) + extra;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_x * block_y, smem));
}

// The tile loop's compile-time variants. Every kernel of the solver runs
// kHeatLoopFull. The others belong to the measurement probes
// (parallel_heat_tpu_torch/tools/): each cuts one cost out of the loop, or
// pins the Dirichlet ring another way, so that a launch's time splits by
// difference. Kernel A's anatomy probe (heat_a.cuh) takes kHeatLoopCopyStep;
// E-uni's anatomy (heat_probe_temporal.cu) the first six; E-uni's boundary
// A/B (heat_probe_ab_temporal.cu) full, kHeatLoopVCoeff and
// kHeatLoopRowCopy; the issue-rate roofline (heat_probe_vpu_roofline.cu)
// full, kHeatLoopNoShuffle and kHeatLoopNoRowLoad; the neighbour-form
// probe (heat_probe_roll_pad.cu) full, kHeatLoopPadSlice and
// kHeatLoopNbr4 on A's and E-uni's launches. kHeatLoopFull is the
// solver's function, and so are the two neighbour forms, which read the
// left and right cells from shared memory instead of by shuffle;
// kHeatLoopRowCopy is the same function on finite grids whose ring holds
// no -0.0 (its ring columns are pinned by a coefficient 1 and two
// coefficients 0, and -0.0 + 0 is +0.0).
constexpr int kHeatLoopFull = 0;
constexpr int kHeatLoopNoResidual = 1;  // the last step folds no residual
constexpr int kHeatLoopNoEdge = 2;      // every tile stepped as an interior one
constexpr int kHeatLoopCopyStep = 3;    // a copy in the combine's place
constexpr int kHeatLoopNoLoad = 4;      // (the kernel's) no load, no wait
constexpr int kHeatLoopNoStore = 5;     // the last step stores nothing
constexpr int kHeatLoopVCoeff = 6;      // the ring pinned by coefficients
constexpr int kHeatLoopRowCopy = 7;     // ring columns by coefficients, ring
                                        // rows restored by copy
constexpr int kHeatLoopNoShuffle = 8;   // left and right taken as the cell
constexpr int kHeatLoopNoRowLoad = 9;   // up and down taken as the cell too
constexpr int kHeatLoopPadSlice = 10;   // left and right by two 4-byte loads
constexpr int kHeatLoopNbr4 = 11;       // ... as the neighbour groups' float4s
constexpr int kHeatLoopRecord = 12;     // kHeatLoopFull, each load written
                                        // down (heat_record_load)

// One step of this warp's rows [r0, r1) over the 4-column groups
// [g0, g1) of the shared tile: group g holds shared floats [4g, 4g+4) of
// each row, tile columns [4g - pad, 4g - pad + 4). src and dst are
// 16-byte aligned buffers with a row stride of sx floats. Lanes take the
// groups in passes of 32; every lane of the warp runs every pass, so the
// shuffles see the whole warp, and a lane past g1 loads its own group
// (or the row's last) and stores nothing. An inner step writes dst. The
// last step (kLast) writes the grid in global memory instead, tile cell
// (r, c) at out[base + r * ld + c], for the columns below c_end only,
// 16 bytes at a time where vec_out says the address allows it, and folds
// the residual's bit pattern of exactly those cells into rmax. With
// kEdge the tile reaches past the grid's interior, rows [r_lo, r_hi] and
// columns [c_lo, c_hi] in tile coordinates, and the cells outside it are
// copied; without it every cell is updated and nothing is tested. kVar is
// the loop's variant (kHeatLoopFull but in the probes). With
// kHeatLoopVCoeff an edge tile takes per-lane coefficient vectors (a0 -> 1,
// cx and cy -> 0 on columns outside the interior) and, on rows outside it,
// the coefficients (1, 0, 0), one uniform branch a row and no test a cell;
// with kHeatLoopRowCopy the same vectors on every row, the ring rows being
// restored after the step (heat_tile_steps) and, in the last step, copied
// by a test a row. The neighbour forms take no shuffle: with
// kHeatLoopPadSlice every lane reads the float before its group and the
// float after it (4 bytes each, lanes 4 floats apart), with kHeatLoopNbr4
// the neighbour groups' float4s and keeps .w and .x (the compiler narrows
// each read to the one float used: the same cells, other addressing; a
// volatile 16-byte load instead spilled A's registers).
// They read the same cells as the shuffles but where the row's last group
// is an active lane's and not lane 31's: there the shuffle hands the lane
// its own group's first cell (the lane to its right is clamped to the
// same group) and the forms the next row's first. That cell's new value
// lies outside every step's valid region (the group ends the row's
// padding, at or past tile column sw - 1), so no output bit differs.
// A type named so that a call never deduces it: the tile loop's store type
// is given, or float32 by default, so that a null output deduces nothing.
template <typename T>
struct HeatSame {
  using type = T;
};

// The last step's store of one 4-column group at q: float32 as it is; a
// bfloat16 grid's updated cells (in) rounded, its copied ones narrowed
// exactly. 16 (float32) or 8 (bfloat16) bytes at once with `vec`.
__device__ __forceinline__ void heat_store_group(float* q, float4 v, bool in0,
                                                 bool in1, bool in2, bool in3,
                                                 bool st0, bool st1, bool st2,
                                                 bool st3, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(q) = v;
    return;
  }
  if (st0) q[0] = v.x;
  if (st1) q[1] = v.y;
  if (st2) q[2] = v.z;
  if (st3) q[3] = v.w;
}
__device__ __forceinline__ void heat_store_group(__nv_bfloat16* q, float4 v,
                                                 bool in0, bool in1, bool in2,
                                                 bool in3, bool st0, bool st1,
                                                 bool st2, bool st3,
                                                 bool vec) {
  const __nv_bfloat16 b0 =
      in0 ? __float2bfloat16_rn(v.x) : heat_bf16_exact(v.x);
  const __nv_bfloat16 b1 =
      in1 ? __float2bfloat16_rn(v.y) : heat_bf16_exact(v.y);
  const __nv_bfloat16 b2 =
      in2 ? __float2bfloat16_rn(v.z) : heat_bf16_exact(v.z);
  const __nv_bfloat16 b3 =
      in3 ? __float2bfloat16_rn(v.w) : heat_bf16_exact(v.w);
  if (vec) {
    uint2 pk;
    pk.x = static_cast<uint32_t>(__bfloat16_as_ushort(b0)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(b1)) << 16);
    pk.y = static_cast<uint32_t>(__bfloat16_as_ushort(b2)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(b3)) << 16);
    *reinterpret_cast<uint2*>(q) = pk;
    return;
  }
  if (st0) q[0] = b0;
  if (st1) q[1] = b1;
  if (st2) q[2] = b2;
  if (st3) q[3] = b3;
}

// Can the last step store whole groups at once? The row stride a multiple
// of 4 cells and the group of tile column -pad aligned to 4 cells.
template <typename Tout>
__device__ __forceinline__ bool heat_vec_out(const Tout* out, int64_t ld,
                                             int64_t base, int pad) {
  return ld % 4 == 0 &&
         (reinterpret_cast<uint64_t>(out) +
          sizeof(Tout) * static_cast<uint64_t>(base - pad)) %
                 (4 * sizeof(Tout)) ==
             0;
}

template <bool kLast, bool kEdge, int kVar = kHeatLoopFull,
          typename Tout = float, bool kRound = false>
__device__ __forceinline__ void heat_rows(
    const float* __restrict__ src, float* __restrict__ dst,
    typename HeatSame<Tout>::type* __restrict__ out, int sx, int pad,
    int64_t base, int64_t ld,
    bool vec_out, int r0, int r1, int g0, int g1, int c_end, int r_lo,
    int r_hi, int c_lo, int c_hi, float a0, float cx, float cy,
    uint32_t& rmax) {
  constexpr bool kCopy = kVar == kHeatLoopCopyStep;
  constexpr bool kFold = kLast && kVar != kHeatLoopNoResidual;
  constexpr bool kStore = kLast && kVar != kHeatLoopNoStore;
  constexpr bool kCoeff =
      kEdge && (kVar == kHeatLoopVCoeff || kVar == kHeatLoopRowCopy);
  constexpr bool kSelect = kEdge && !kCoeff;
  constexpr bool kNoShfl =
      kVar == kHeatLoopPadSlice || kVar == kHeatLoopNbr4;
  // The precision forms run the solver's function only.
  static_assert((std::is_same<Tout, float>::value && !kRound) ||
                    kVar == kHeatLoopFull,
                "bfloat16 storage and the float32 carry take kHeatLoopFull");
  if (r0 >= r1) return;  // uniform across the warp
  const int lane = static_cast<int>(threadIdx.x);
  const int sx4 = sx >> 2;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
  for (int gb = g0; gb < g1; gb += kHeatLanes) {
    const int g = gb + lane;
    const bool active = g < g1;
    const int gl = min(g, sx4 - 1);
    const int c = 4 * gl - pad;  // the group's first tile column
    // Lane 31 reads the cell right of its group from shared memory, lane
    // 0 the cell left of its own (row r's float before or after the
    // group: the row above's last or the row below's first where the
    // group ends the row; r >= 1 and r + 1 < rows always). The other lanes
    // read lane 0's cell too, a broadcast: one load for the warp, with no
    // branch around it. The neighbour forms point every lane at the float
    // before its own group.
    const int e_col = kNoShfl                  ? 4 * gl - 1
                      : lane == kHeatLanes - 1 ? 4 * gl + 4
                                               : 4 * gb - 1;
    bool ci0 = true, ci1 = true, ci2 = true, ci3 = true;
    if (kEdge) {
      ci0 = c >= c_lo && c <= c_hi;
      ci1 = c + 1 >= c_lo && c + 1 <= c_hi;
      ci2 = c + 2 >= c_lo && c + 2 <= c_hi;
      ci3 = c + 3 >= c_lo && c + 3 <= c_hi;
    }
    // kCoeff: the columns' coefficients, (1, 0, 0) outside the interior.
    float4 ka, kx, ky;
    if constexpr (kCoeff) {
      ka = make_float4(ci0 ? a0 : 1.f, ci1 ? a0 : 1.f, ci2 ? a0 : 1.f,
                       ci3 ? a0 : 1.f);
      kx = make_float4(ci0 ? cx : 0.f, ci1 ? cx : 0.f, ci2 ? cx : 0.f,
                       ci3 ? cx : 0.f);
      ky = make_float4(ci0 ? cy : 0.f, ci1 ? cy : 0.f, ci2 ? cy : 0.f,
                       ci3 ? cy : 0.f);
    }
    bool st0 = false, st1 = false, st2 = false, st3 = false;
    if (kLast) {
      st0 = active && c < c_end;
      st1 = active && c + 1 < c_end;
      st2 = active && c + 2 < c_end;
      st3 = active && c + 3 < c_end;
    }
    const float4* p = s4 + gl;
    float4 up = p[(r0 - 1) * sx4];
    float4 cc = p[r0 * sx4];
    float4 dn = p[(r0 + 1) * sx4];
    const float* pe = src + r0 * sx + e_col;
    Tout* qo = nullptr;
    float* q = nullptr;
    if constexpr (kLast)
      qo = out + (base + static_cast<int64_t>(r0) * ld + c);
    else
      q = dst + (r0 * sx + 4 * gl);
    // Row r from the rows above, at and below it in registers; the row
    // below the next is read ahead by the loop, which stops one row short
    // so that the read stays inside the rows (r1 < rows), and the last
    // row runs on its own.
    auto row = [&](int r) {
      float4 v;
      if constexpr (kVar == kHeatLoopNoShuffle ||
                    kVar == kHeatLoopNoRowLoad) {
        const float4 u4 = kVar == kHeatLoopNoRowLoad ? cc : up;
        const float4 d4 = kVar == kHeatLoopNoRowLoad ? cc : dn;
        v.x = heat_combine(cc.x, u4.x, d4.x, cc.x, cc.x, a0, cx, cy);
        v.y = heat_combine(cc.y, u4.y, d4.y, cc.y, cc.y, a0, cx, cy);
        v.z = heat_combine(cc.z, u4.z, d4.z, cc.z, cc.z, a0, cx, cy);
        v.w = heat_combine(cc.w, u4.w, d4.w, cc.w, cc.w, a0, cx, cy);
      } else {
        float lf, rt;
        if constexpr (kVar == kHeatLoopPadSlice) {
          lf = pe[0];
          rt = pe[5];
        } else if constexpr (kVar == kHeatLoopNbr4) {
          lf = p[r * sx4 - 1].w;
          rt = p[r * sx4 + 1].x;
        } else {
          const float e = *pe;
          lf = __shfl_up_sync(kHeatFullWarp, cc.w, 1);
          rt = __shfl_down_sync(kHeatFullWarp, cc.x, 1);
          if (lane == 0) lf = e;
          if (lane == kHeatLanes - 1) rt = e;
        }
        if constexpr (kCopy) {
          v = cc;
        } else if constexpr (kCoeff) {
          // Rows outside the interior take (1, 0, 0): one branch, uniform
          // across the warp, for kHeatLoopVCoeff; kHeatLoopRowCopy takes
          // the columns' coefficients on every row.
          float4 ra = ka, rx = kx, ry = ky;
          if (kVar == kHeatLoopVCoeff && !(r >= r_lo && r <= r_hi)) {
            ra = make_float4(1.f, 1.f, 1.f, 1.f);
            rx = make_float4(0.f, 0.f, 0.f, 0.f);
            ry = rx;
          }
          v.x = heat_combine(cc.x, up.x, dn.x, lf, cc.y, ra.x, rx.x, ry.x);
          v.y = heat_combine(cc.y, up.y, dn.y, cc.x, cc.z, ra.y, rx.y, ry.y);
          v.z = heat_combine(cc.z, up.z, dn.z, cc.y, cc.w, ra.z, rx.z, ry.z);
          v.w = heat_combine(cc.w, up.w, dn.w, cc.z, rt, ra.w, rx.w, ry.w);
        } else {
          v.x = heat_combine(cc.x, up.x, dn.x, lf, cc.y, a0, cx, cy);
          v.y = heat_combine(cc.y, up.y, dn.y, cc.x, cc.z, a0, cx, cy);
          v.z = heat_combine(cc.z, up.z, dn.z, cc.y, cc.w, a0, cx, cy);
          v.w = heat_combine(cc.w, up.w, dn.w, cc.z, rt, a0, cx, cy);
        }
      }
      const bool rin = !kEdge || (r >= r_lo && r <= r_hi);
      bool in0, in1, in2, in3;
      if constexpr (kCoeff) {
        // No test a cell: vcoeff folds every cell (a pinned cell's
        // difference is 0), rowcopy the interior rows'.
        const bool fold = kVar == kHeatLoopVCoeff || rin;
        in0 = in1 = in2 = in3 = fold;
        if (kVar == kHeatLoopRowCopy && kLast && !rin) v = cc;
      } else {
        in0 = rin && ci0;
        in1 = rin && ci1;
        in2 = rin && ci2;
        in3 = rin && ci3;
      }
      if constexpr (kRound && !kLast) {
        // bfloat16 storage: the level rounds before the next step reads
        // it (the copied cells are restored just below).
        v.x = heat_bf16_round(v.x);
        v.y = heat_bf16_round(v.y);
        v.z = heat_bf16_round(v.z);
        v.w = heat_bf16_round(v.w);
      }
      if (kSelect) {
        v.x = in0 ? v.x : cc.x;
        v.y = in1 ? v.y : cc.y;
        v.z = in2 ? v.z : cc.z;
        v.w = in3 ? v.w : cc.w;
      }
      if (kLast) {
        if (kFold) {
          if (st0 && in0) rmax = max(rmax, heat_diff_bits(v.x, cc.x));
          if (st1 && in1) rmax = max(rmax, heat_diff_bits(v.y, cc.y));
          if (st2 && in2) rmax = max(rmax, heat_diff_bits(v.z, cc.z));
          if (st3 && in3) rmax = max(rmax, heat_diff_bits(v.w, cc.w));
        }
        if (kStore)
          heat_store_group(qo, v, in0, in1, in2, in3, st0, st1, st2, st3,
                           vec_out && st3);
        qo += ld;
      } else {
        if (active) *reinterpret_cast<float4*>(q) = v;
        q += sx;
      }
      pe += sx;
    };
    int r = r0;
#pragma unroll 4
    for (; r < r1 - 1; ++r) {
      const float4 nx = p[(r + 2) * sx4];
      row(r);
      up = cc;
      cc = dn;
      dn = nx;
    }
    row(r);
  }
}

// heat_rows with kEdge chosen at run time (uniform per block).
template <bool kLast, int kVar = kHeatLoopFull, typename Tout = float,
          bool kRound = false>
__device__ __forceinline__ void heat_rows_any(
    bool edge, const float* __restrict__ src, float* __restrict__ dst,
    typename HeatSame<Tout>::type* __restrict__ out, int sx, int pad,
    int64_t base, int64_t ld, bool vec_out, int r0, int r1, int g0, int g1,
    int c_end, int r_lo, int r_hi, int c_lo, int c_hi, float a0, float cx,
    float cy, uint32_t& rmax) {
  if (edge)
    heat_rows<kLast, true, kVar, Tout, kRound>(
        src, dst, out, sx, pad, base, ld, vec_out, r0, r1, g0, g1, c_end,
        r_lo, r_hi, c_lo, c_hi, a0, cx, cy, rmax);
  else
    heat_rows<kLast, false, kVar, Tout, kRound>(
        src, dst, out, sx, pad, base, ld, vec_out, r0, r1, g0, g1, c_end,
        r_lo, r_hi, c_lo, c_hi, a0, cx, cy, rmax);
}

// kHeatLoopRowCopy: tile row r of dst, if it lies in this warp's rows
// [r0, r1), restored from src over the groups [g0, g1) after a step, by
// the lanes that stored those groups (so no barrier orders the two
// stores). src holds the row as loaded: the step before restored it.
__device__ __forceinline__ void heat_restore_row(const float* src,
                                                 float* dst, int sx, int r,
                                                 int r0, int r1, int g0,
                                                 int g1) {
  if (r < r0 || r >= r1) return;  // uniform across the warp
  const float4* s = reinterpret_cast<const float4*>(src + r * sx);
  float4* d = reinterpret_cast<float4*>(dst + r * sx);
  for (int g = g0 + static_cast<int>(threadIdx.x); g < g1; g += kHeatLanes)
    d[g] = s[g];
}

// The wait of a load issued with cp.async and committed: each thread's
// own copies, then the block's.
struct HeatCpAsyncWait {
  __device__ __forceinline__ void operator()() const {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
};

// Steps 1 .. K of one block, after its load of the framed tile was
// issued: buffer `src` holds sy rows of sw cells, tile cell (r, c) at
// src[r * sx + pad + c], and shared cell (0, 0) is global cell (gy0, gx0)
// of an m x n grid, whose interior decides update or copy. `wait_load()`,
// which every thread calls, returns once the load has landed for the
// whole block. Runs the K steps ping-ponging between src and dst, and
// writes the last step's tile rows [w_r0, w_r1) and columns [k, w_c1) to
// out[base + r * ld + c]; with `res` non-null it reduces the residual of
// exactly those cells into *res. Every thread of the block must call it.
// kVar is the loop's variant (heat_rows; kHeatLoopFull but in the probes);
// Tout and kRound its storage precision (above).
template <int kVar = kHeatLoopFull, typename Tout = float, bool kRound = false,
          class Wait>
__device__ __forceinline__ void heat_tile_steps(
    float* src, float* dst, int sx, int pad, int sy, int sw, int64_t gy0,
    int64_t gx0, int64_t m, int64_t n, int k, int w_r0, int w_r1, int w_c1,
    float a0, float cx, float cy,
    typename HeatSame<Tout>::type* __restrict__ out, int64_t base,
    int64_t ld, uint32_t* res, Wait wait_load) {
  // The grid's interior, rows 1 .. m-2 and columns 1 .. n-2, in tile
  // coordinates (clamped to the tile, so an empty range stays empty).
  const int r_lo = heat_clamp_local(1 - gy0, 0, sy);
  const int r_hi = heat_clamp_local(m - 2 - gy0, -1, sy - 1);
  const int c_lo = heat_clamp_local(1 - gx0, 0, sw);
  const int c_hi = heat_clamp_local(n - 2 - gx0, -1, sw - 1);
  // This warp's run of rows.
  const int run = (sy + blockDim.y - 1) / blockDim.y;
  const int t_r0 = threadIdx.y * run;
  const int t_r1 = min(t_r0 + run, sy);
  // Does the tile reach past the interior? Uniform across the block.
  // kHeatLoopNoEdge answers no for every tile, by a test that is false at
  // run time (n >= 3), so that its interior path compiles as the shipped
  // loop's does.
  const bool edge = kVar == kHeatLoopNoEdge
                        ? n < 0
                        : r_lo > 0 || r_hi < sy - 1 || c_lo > 0 ||
                              c_hi < sw - 1;
  // Can the last step store a group as one 16-byte write? Uniform too.
  const bool vec_out = heat_vec_out(out, ld, base, pad);
  wait_load();

  uint32_t rmax = 0u;
  // Steps 1 .. K-1 over the whole groups that cover the valid region.
  for (int s = 1; s < k; ++s) {
    const int r0 = max(t_r0, s), r1 = min(t_r1, sy - s);
    const int g0 = (pad + s) / 4, g1 = (pad + sw - s + 3) / 4;
    heat_rows_any<false, kVar, Tout, kRound>(
        edge, src, dst, nullptr, sx, pad, 0, 0, false, r0, r1, g0, g1, 0,
        r_lo, r_hi, c_lo, c_hi, a0, cx, cy, rmax);
    if (kVar == kHeatLoopRowCopy && edge) {
      // The grid's ring rows, where the tile holds them.
      if (r_lo > 0) heat_restore_row(src, dst, sx, r_lo - 1, r0, r1, g0, g1);
      if (r_hi < sy - 1)
        heat_restore_row(src, dst, sx, r_hi + 1, r0, r1, g0, g1);
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // Step K: the rows and columns asked for, written to global memory,
  // with the residual.
  heat_rows_any<true, kVar, Tout, kRound>(
      edge, src, nullptr, out, sx, pad, base, ld, vec_out, max(t_r0, w_r0),
      min(t_r1, w_r1), (pad + k) / 4, (pad + w_c1 + 3) / 4, w_c1, r_lo, r_hi,
      c_lo, c_hi, a0, cx, cy, rmax);
  if (kVar != kHeatLoopNoResidual && res != nullptr)
    heat_block_max(rmax, res);
}

// --- Kernels E and E-uni ------------------------------------------------

// heat_tile_steps for a tile of the grid itself: blockIdx.x is the tile,
// row-major over n_col_tiles columns of tiles; shared cell (0, 0) is
// global cell (gy0, gx0) = (row tile * TY - K, column tile * TX - K); the
// central TY x TX tile, cut at the grid's edge, lands in `out`, an m x n
// grid like the input.
template <int kVar = kHeatLoopFull, typename Tout = float, bool kRound = false,
          class Wait>
__device__ __forceinline__ void heat_e_steps(
    float* src, float* dst, int sx, int pad, int sy, int sw, int64_t gy0,
    int64_t gx0, int64_t m, int64_t n, int k, int tile_y, int tile_x,
    float a0, float cx, float cy,
    typename HeatSame<Tout>::type* __restrict__ out, uint32_t* res,
    Wait wait_load) {
  const int r_end = heat_clamp_local(m - gy0, 0, k + tile_y);
  const int c_end = heat_clamp_local(n - gx0, 0, k + tile_x);
  heat_tile_steps<kVar, Tout, kRound>(src, dst, sx, pad, sy, sw, gy0, gx0, m,
                                      n, k, k, r_end, c_end, a0, cx, cy, out,
                                      gy0 * n + gx0, n, res, wait_load);
}

// The wait of a load made with plain loads and stores (a bfloat16 tile
// widened as it lands): the block's barrier.
struct HeatSyncWait {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The precision forms of the 2D K-step kernels (E, E-uni): the grid's
// storage type in and out, and whether the levels round to bfloat16.
//   kHeatFormBf16     bfloat16 in and out, every level rounded (storage);
//   kHeatFormCarry    bfloat16 in and out, the levels float32 and the last
//                     store rounded once (accumulate="f32chunk", a chunk in
//                     one launch);
//   kHeatFormCarryOut bfloat16 in, float32 out, nothing rounded (the first
//                     launch of a chunk in two);
//   kHeatFormCarryIn  float32 in (a carried level), bfloat16 out, rounded
//                     once at the last store (the chunk's last launch).
// ops/stencil_kernels.py PRECISION_FORMS is the same table.
constexpr int kHeatFormBf16 = 0;
constexpr int kHeatFormCarry = 1;
constexpr int kHeatFormCarryOut = 2;
constexpr int kHeatFormCarryIn = 3;

template <int kForm>
struct HeatForm {
  using In = typename std::conditional<kForm == kHeatFormCarryIn, float,
                                       __nv_bfloat16>::type;
  using Out = typename std::conditional<kForm == kHeatFormCarryOut, float,
                                        __nv_bfloat16>::type;
  static constexpr bool kRound = kForm == kHeatFormBf16;
};

// The checks of an E or E-uni launch: the grid, K, the launch shape the
// loop takes, and a grid of tiles that fits one launch. Sets
// *n_col_tiles and *blocks. Returns a cudaError_t.
inline int heat_e_geometry(int64_t m, int64_t n, int k, int tile_y,
                           int tile_x, int block_x, int block_y,
                           int64_t* n_col_tiles, int64_t* blocks) {
  if (m < 3 || n < 3 || k < 1 ||
      !heat_loop_takes(tile_y, tile_x, block_x, block_y))
    return static_cast<int>(cudaErrorInvalidValue);
  *n_col_tiles = (n + tile_x - 1) / tile_x;
  *blocks = *n_col_tiles * ((m + tile_y - 1) / tile_y);
  return *blocks > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue)
                                : 0;
}
