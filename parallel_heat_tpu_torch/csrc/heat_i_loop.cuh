// Shared device code of the band-streaming temporal kernels
// (heat_i_tile_temporal.cu, heat_i_uni_tile_temporal.cu): K Jacobi steps
// per pass through global memory over column bands, each band streamed
// down its rows by one warp. The two kernels differ only in how a band's
// rows reach shared memory.
//
// A warp owns a band of 128 columns: each of its 32 lanes holds 4
// adjacent columns as a float4. The band's first P = K rounded up to a
// multiple of 4 columns on each side are margin, so that every band
// starts on a 16-byte boundary and every output group is whole: TX = 128
// - 2P output columns (120 at K <= 4, 112 at K = 5 .. 8), band b covering
// grid columns [b TX - P, b TX - P + 128). A warp also owns a segment of
// output rows [r0, r1) and streams the input rows [r0 - K, r1 + K), one
// row an iteration; in the iteration that
// brings input row t it advances every level at once, level s (the grid
// after s steps) at row t - s. Level 0 stays in the warp's ring of input
// rows in shared memory, whence level 1 reads its three rows; each level
// 1 <= s < K keeps, in registers, its lane's 4 columns of the two rows
// before the one the next level needs (U, M) and the row just made (D),
// 56 floats at K = 8. A level's step reads up, centre and down from the
// level below, and the cells left and right of its group from the
// neighbouring lanes' centre rows by shuffle. Lanes 0 and 31 take their
// own cell for the missing outer neighbour. No level row is stored to
// shared memory, and no barrier joins the warps of a block.
//
// Within an iteration level s takes level s-1's newest row, a chain of K
// combines; the warps an SM hold hide its latency. Skewing the levels by
// two rows (level s at row t - 2s) would make the K levels of an
// iteration independent, but measured slower (PERF.md §6).
//
// Rows arrive in a ring of `stages` stages of `rows` input rows of the
// band a warp, each with an mbarrier; a stage is refilled once its last
// row has been read for the last time, one row into the next stage. By
// TMA (kTma, I-uni) one lane asks for a stage as one box of a 2D tensor
// map of the grid (rows x 128 floats from grid cell (first row, b TX - P),
// zeros outside the grid), after the warp's __syncwarp, and the warp
// waits on the barrier. By cp.async (I) each lane copies its own 4 cells
// of each row: one 16-byte copy where they lie inside the grid on a
// 16-byte boundary, else a 4-byte copy a cell, zero-filled outside the
// grid; every lane arrives on the stage's barrier once its copies have
// landed, and refills only cells that it alone reads.
//
// Why the bits hold. Values outside the valid cone (the band's first and
// last s columns at level s, the first s rows of a segment's stream, and
// whatever registers a lane has not yet filled) only spread outward, one
// cell a level, and never reach an output cell: P >= K columns and K rows
// a side. Cells outside the global interior are copied, never recomputed
// (the checked step), and cells outside the grid load as 0, so the
// Dirichlet ring stays bit-exact and every step rounds to float32 like a
// launch of heat_b_step: K steps are bitwise K launches of B. The
// residual is heat_diff_bits of level K against level K - 1 over exactly
// the output cells, reduced across the warp and then one atomicMax.
//
// Cost: a cell-step is the combine's 7 rounded operations, half a
// shuffle, and a share of the row's three 16-byte shared loads, store and
// ring bookkeeping; the recompute is the column margin, 128/TX, and 2K
// rows a segment. Below K = 8 every instance stays in the kernels' 128
// registers. At K = 8 both park a few words in local memory, read once
// every 3 rows (I-uni) or 4 times (I) in the test-free loop; a build at
// 255 registers spills nothing but holds 7 blocks an SM, not 8, and ran
// 2-3% slower (PERF.md §6).
//
// Storage precision (heat_temporal.cuh kHeatForm*). The loop is
// templated on the grid's storage types in and out (Tin, Tout) and on
// kRound; the levels stay float4 in registers and the arithmetic float32
// at every form. The ring holds Tin: a bfloat16 row of the band is 256
// bytes, and a lane widens its 4 cells on its one 8-byte shared load.
// With kRound (bfloat16 storage) each level s < K rounds its updated
// cells to bfloat16 before the next level reads them, the copied ones
// kept as they are, as a launch of heat_b_step_bf16 stores them; without
// it (the f32chunk carry) the levels stay float32. Level K's float32
// update against level K - 1 is the residual, before the last store
// rounds the updated cells and narrows the copied ones exactly. So a
// bfloat16 form is bitwise E's form of the same code at the same K.
// A bfloat16 ring row holds 136 cells from 16 bytes of the grid's row:
// a box must start on 16 bytes (heat_e_uni.cuh), and a band starts on 4
// cells, so a row lands from the band's first cell rounded down to 8
// (the shift, 0 or 4) and the lanes read from the shift on. I copies a
// lane's 4 bfloat16 cells as one 8-byte cp.async where they lie inside
// the grid on an 8-byte boundary (widths a multiple of 4); cp.async has
// no 2-byte copy, so any other cells of a row inside the grid take plain
// 2-byte loads and shared stores, zeros outside it, before the lane's
// arrival on the stage's barrier (the lane alone reads them).

#pragma once

#include <cuda_pipeline.h>

#include <type_traits>

#include "heat_common.cuh"
#include "heat_temporal.cuh"
#include "heat_tma.cuh"

constexpr int kILanes = 32;
constexpr int kIWidth = 4 * kILanes;   // band columns a warp
constexpr int kIMaxK = 8;              // ops/hopper_params.py i_k_max
constexpr int kIMaxWarps = 8;          // warps a block: the launch bound
constexpr int kIMaxThreads = kILanes * kIMaxWarps;
constexpr int kIMinRows = 3;           // input rows a stage: more than
constexpr int kIMaxRows = 32;          // the level 0 rows kept behind
constexpr int kIMaxStages = 8;         // stages a warp's ring

// The margin at depth k (k rounded up to a whole group) and the output
// columns of a band (ops/hopper_params.py i_pad and i_tile_x).
__host__ __device__ constexpr int heat_i_pad(int k) { return (k + 3) / 4 * 4; }
__host__ __device__ constexpr int heat_i_tile_x(int k) {
  return kIWidth - 2 * heat_i_pad(k);
}

constexpr size_t kIMaxSmem = 232448;   // a block's shared memory at most

// Cells of a ring row for a grid of `elem`-byte cells (ops/hopper_params
// .py i_row_cells): the band's 128, or at bfloat16 136 from the band's
// first cell rounded down to 16 bytes.
__host__ __device__ constexpr int heat_i_row_cells(int elem) {
  return elem == 2 ? kIWidth + 8 : kIWidth;
}
// Bytes of a stage of `rows` rows, rounded up to 128 (a box's alignment).
__host__ __device__ constexpr uint32_t heat_i_stage_bytes(int rows,
                                                          int elem) {
  return (static_cast<uint32_t>(rows * elem * heat_i_row_cells(elem)) +
          127u) / 128u * 128u;
}

// Dynamic shared memory of one block (ops/hopper_params.py
// i_smem_bytes): 128 bytes to align the rings, `stages` stages of `rows`
// rows (of 128 floats, or 136 bfloat16) for each of `warps` warps, an
// 8-byte mbarrier a stage.
inline size_t heat_i_smem_bytes(int warps, int rows, int stages,
                                int elem = 4) {
  return static_cast<size_t>(heat_i_stage_bytes(rows, elem)) * warps *
             stages +
         128 + sizeof(uint64_t) * static_cast<size_t>(warps) * stages;
}

// The launch arguments of both kernels.
struct HeatIArgs {
  // The m x n grid (I; I-uni reads it by its map) and K steps of it,
  // typed float32 whatever their cells: a bfloat16 form casts. (Typed
  // void, the float32 I's spill at K = 8 grew by a quarter.)
  const float* u;
  float* out;
  uint32_t* res;        // the residual's bits, or null
  int64_t m, n;
  int64_t n_bands;      // bands of heat_i_tile_x(K) output columns
  int64_t seg_rows;     // output rows a segment
  int rows, stages;     // the ring: input rows a stage, stages a warp
  int vec_out;          // out's rows take whole-group stores (4 cells)
  float a0, cx, cy;
  uint32_t stage_bytes; // heat_i_stage_bytes(rows, the input's cell size)
};

// One warp's band and segment, streamed. kTma: I-uni's load (the map
// `map` of the grid, boxes of rows x 128 floats, or rows x 136
// bfloat16); else I's. Tin and Tout the grid's storage types in and out,
// kRound the rounding of the levels (storage precision, above). Rows are
// counted from the segment's first input row t0 as 32-bit iteration
// numbers i (input row t0 + i), so that the loop keeps few registers
// besides the levels' 8 (K - 1) floats.
template <int K, bool kTma, typename Tin = float, typename Tout = float,
          bool kRound = false>
struct HeatIBand {
  static constexpr int P = heat_i_pad(K);
  static constexpr int TX = heat_i_tile_x(K);
  static constexpr bool kF32In = std::is_same<Tin, float>::value;
  static constexpr int kElem = sizeof(Tin);
  static constexpr uint32_t kRowBytes = kElem * heat_i_row_cells(kElem);

  const HeatIArgs& a;
  const CUtensorMap* map;
  float* ring;          // this warp's stages
  uint64_t* bars;       // their mbarriers
  int lane;
  int gx0;              // grid column of band column 0
  int gx;               // this lane's first column
  int t0;               // the segment's first input row
  int n_iter;           // input rows it streams
  int n_stages;         // stages they fill
  int row_lo, row_hi;   // level row t0 + r is interior: r in [lo, hi]
  unsigned cin;         // bit c: column gx + c inside the interior
  unsigned sout;        // bit c: gx + c an output column of this band
  uint32_t rd0;         // shared address of the lane's cells in ring row 0
  // ... in the ring rows of input rows i, i - 1 and i - 2 (the next
  // iteration's i; all row 0 at first).
  uint32_t rd, p1, p2;
  // The ring's position: stage q in slot `slot` of lap parity `lap`, row
  // j of it next.
  int q = 0, slot = 0, j = 0;
  uint32_t lap = 0u;
  uint32_t rmax = 0u;

  // A ring row's first cell lies this many cells left of the band's: 0
  // for float32, gx0 rounded down to 8 cells (16 bytes) for bfloat16.
  __device__ __forceinline__ int shift() const {
    return kF32In ? 0 : (gx0 & 7);
  }

  __device__ __forceinline__ HeatIBand(const HeatIArgs& args,
                                       const CUtensorMap* m_, float* ring_,
                                       uint64_t* bars_, int64_t band,
                                       int64_t seg)
      : a(args), map(m_), ring(ring_), bars(bars_) {
    lane = static_cast<int>(threadIdx.x);
    gx0 = static_cast<int>(band * TX - P);
    gx = gx0 + 4 * lane;
    // Rows are 32-bit: the launcher takes m < 2^31 - 256.
    const int m = static_cast<int>(a.m);
    const int r0 = static_cast<int>(seg * a.seg_rows);
    const int r1 = r0 + a.seg_rows < m ? r0 + static_cast<int>(a.seg_rows)
                                       : m;
    t0 = r0 - K;
    // The outputs' rows and K rows a side.
    n_iter = (r1 - r0) + 2 * K;
    n_stages = (n_iter + a.rows - 1) / a.rows;
    // Relative rows reach [-K, n_iter): clamped past that, the tests keep
    // their answers.
    row_lo = 1 - t0;
    row_hi = min(m - 2 - t0, n_iter + 64);
    // (The float32 instances' expressions are kept as they were: ptxas's
    // register allocation, and so their spill at K = 8, follows them.)
    if constexpr (kF32In)
      rd0 = heat_smem_addr(ring) + 16u * static_cast<uint32_t>(lane);
    else
      rd0 = heat_smem_addr(ring) +
            static_cast<uint32_t>(kElem * (shift() + 4 * lane));
    rd = p1 = p2 = rd0;
    cin = 0u;
    sout = 0u;
    const bool out_lane = 4 * lane >= P && 4 * lane < P + TX;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (gx + c >= 1 && gx + c <= a.n - 2) cin |= 1u << c;
      if (out_lane && gx + c < a.n) sout |= 1u << c;
    }
  }

  // Issue stage qq's copies into slot `s`: input rows t0 + qq rows ..
  __device__ __forceinline__ void fill(int qq, int s) {
    float* dst = kF32In ? ring + s * a.rows * kIWidth
                        : reinterpret_cast<float*>(
                              reinterpret_cast<char*>(ring) +
                              s * a.stage_bytes);
    const int row0 = t0 + qq * a.rows;
    if constexpr (kTma) {
      if (lane == 0) {
        heat_mbar_expect(
            bars + s,
            kF32In ? static_cast<uint32_t>(sizeof(float) * a.rows * kIWidth)
                   : static_cast<uint32_t>(a.rows) * kRowBytes);
        heat_tma_load_2d(dst, map, bars + s, kF32In ? gx0 : gx0 - shift(),
                         row0);
      }
    } else if constexpr (kF32In) {
      // The lane's first cell of each row (a pointer formed only inside
      // the grid).
      const bool whole = gx >= 0 && gx + 4 <= a.n;
      for (int r = 0; r < a.rows; ++r) {
        const int t = row0 + r;
        float* d = dst + r * kIWidth + 4 * lane;
        const bool row_in = t >= 0 && t < a.m;
        const float* src =
            a.u + (row_in ? static_cast<int64_t>(t) * a.n + gx : 0);
        if (row_in && whole && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
          __pipeline_memcpy_async(d, src, 16);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool in = row_in && gx + c >= 0 && gx + c < a.n;
            __pipeline_memcpy_async(d + c, in ? src + c : a.u, 4,
                                    in ? 0 : 4);
          }
        }
      }
      heat_cp_async_arrive(bars + s);
    } else {
      // bfloat16: one 8-byte copy where the lane's 4 cells lie inside the
      // grid on 8 bytes; else a plain 2-byte load a cell inside the grid
      // and zeros outside it.
      const uint16_t* u = reinterpret_cast<const uint16_t*>(a.u);
      const bool whole = gx >= 0 && gx + 4 <= a.n;
      const bool none = gx + 4 <= 0 || gx >= a.n;
      for (int r = 0; r < a.rows; ++r) {
        const int t = row0 + r;
        uint16_t* d = reinterpret_cast<uint16_t*>(
                          reinterpret_cast<char*>(dst) + r * kRowBytes) +
                      shift() + 4 * lane;
        const bool row_in = t >= 0 && t < a.m;
        if (!row_in || none) {
          *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
          continue;
        }
        const uint16_t* src = u + (static_cast<int64_t>(t) * a.n + gx);
        if (whole && reinterpret_cast<uintptr_t>(src) % 8 == 0) {
          __pipeline_memcpy_async(d, src, 8);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            d[c] = gx + c >= 0 && gx + c < a.n ? src[c] : uint16_t{0};
        }
      }
      heat_cp_async_arrive(bars + s);
    }
  }

  // The lane's 4 cells of the ring row at shared address `at`, widened.
  __device__ __forceinline__ float4 ring_cells(uint32_t at) const {
    float4 v;
    if constexpr (kF32In) {
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "r"(at));
    } else {
      // A bfloat16 is the upper 16 bits of the float32 it widens to
      // (heat_common.cuh heat_widen).
      uint32_t lo, hi;
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(lo), "=r"(hi)
                   : "r"(at));
      v = make_float4(__uint_as_float(lo << 16),
                      __uint_as_float(lo & 0xffff0000u),
                      __uint_as_float(hi << 16),
                      __uint_as_float(hi & 0xffff0000u));
    }
    return v;
  }

  // Level 0's three rows that level 1 steps in this iteration, the
  // lane's 4 cells of each, from the ring: input rows i - 2, i - 1 and i.
  // Waits for a stage before its first row, and refills the stage before
  // once its last row has been read for the last time (one row into this
  // one).
  __device__ __forceinline__ void level0(float4& up, float4& c,
                                         float4& dn) {
    if (j == 0) heat_mbar_wait(bars + slot, lap);
    up = ring_cells(p2);
    c = ring_cells(p1);
    dn = ring_cells(rd);
    if (j == 1 && q > 0 && q - 1 + a.stages < n_stages) {
      const int prev = slot == 0 ? a.stages - 1 : slot - 1;
      if constexpr (kTma) {
        // Every lane's reads of the slot end before the box lands.
        __syncwarp();
        if (lane == 0)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      fill(q - 1 + a.stages, prev);
    }
    // The ring's rows lie one after another (512 bytes apart, 272 at
    // bfloat16), a stage's on a 128-byte boundary: back to row 0 after
    // the last stage.
    p2 = p1;
    p1 = rd;
    rd += kRowBytes;
    if (++j == a.rows) {
      j = 0;
      ++q;
      if (++slot == a.stages) {
        slot = 0;
        lap ^= 1u;
        rd = rd0;
      } else if constexpr (!kF32In) {
        rd = rd0 + slot * a.stage_bytes;
      }
    }
  }

  // Level s's new row (row t0 + r of the grid) from level s-1's rows up,
  // c (centre) and dn, with the cells left and right of the lane's group
  // by shuffle; with `rnd` (a level s < K of bfloat16 storage) rounded to
  // bfloat16. kCheck: cells outside the global interior are copied;
  // without it every cell is updated.
  template <bool kCheck>
  __device__ __forceinline__ float4 step(float4 up, float4 c, float4 dn,
                                         int r, bool rnd = false) const {
    const float lf = __shfl_up_sync(0xffffffffu, c.w, 1);
    const float rt = __shfl_down_sync(0xffffffffu, c.x, 1);
    float4 v;
    v.x = heat_combine(c.x, up.x, dn.x, lf, c.y, a.a0, a.cx, a.cy);
    v.y = heat_combine(c.y, up.y, dn.y, c.x, c.z, a.a0, a.cx, a.cy);
    v.z = heat_combine(c.z, up.z, dn.z, c.y, c.w, a.a0, a.cx, a.cy);
    v.w = heat_combine(c.w, up.w, dn.w, c.z, rt, a.a0, a.cx, a.cy);
    if (rnd) {
      // Before the copied cells are restored: they keep their bits.
      v.x = heat_bf16_round(v.x);
      v.y = heat_bf16_round(v.y);
      v.z = heat_bf16_round(v.z);
      v.w = heat_bf16_round(v.w);
    }
    if (kCheck) {
      const unsigned in = r >= row_lo && r <= row_hi ? cin : 0u;
      v.x = in & 1u ? v.x : c.x;
      v.y = in & 2u ? v.y : c.y;
      v.z = in & 4u ? v.z : c.z;
      v.w = in & 8u ? v.w : c.w;
    }
    return v;
  }

  // Level K's row t0 + r (v, from centre row c of level K-1): stored and
  // folded into the residual where it is an output row of this segment,
  // r >= K (r < K + the segment's rows in every iteration).
  // Without kCheck the band lies inside the interior, so a lane's 4
  // columns are all output columns or none (sout is 0xf or 0).
  template <bool kCheck>
  __device__ __forceinline__ void emit(float4 v, float4 c, int r) {
    if (r < K) return;  // uniform across the warp
    Tout* o = reinterpret_cast<Tout*>(a.out) +
              (static_cast<int64_t>(t0 + r) * a.n + gx);
    if (!kCheck) {
      // An output lane: lanes P/4 .. (P + TX)/4 - 1.
      if (static_cast<unsigned>(lane - P / 4) >= TX / 4u) return;
      rmax = max(rmax, max(max(heat_diff_bits(v.x, c.x),
                               heat_diff_bits(v.y, c.y)),
                           max(heat_diff_bits(v.z, c.z),
                               heat_diff_bits(v.w, c.w))));
      if constexpr (std::is_same<Tout, float>::value) {
        if (a.vec_out) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          o[0] = v.x;
          o[1] = v.y;
          o[2] = v.z;
          o[3] = v.w;
        }
      } else {
        heat_store_group(o, v, true, true, true, true, true, true, true,
                         true, a.vec_out);
      }
      return;
    }
    const unsigned in = r >= row_lo && r <= row_hi ? sout & cin : 0u;
    if (in & 1u) rmax = max(rmax, heat_diff_bits(v.x, c.x));
    if (in & 2u) rmax = max(rmax, heat_diff_bits(v.y, c.y));
    if (in & 4u) rmax = max(rmax, heat_diff_bits(v.z, c.z));
    if (in & 8u) rmax = max(rmax, heat_diff_bits(v.w, c.w));
    if constexpr (std::is_same<Tout, float>::value) {
      if (a.vec_out && sout == 0xfu) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        if (sout & 1u) o[0] = v.x;
        if (sout & 2u) o[1] = v.y;
        if (sout & 4u) o[2] = v.z;
        if (sout & 8u) o[3] = v.w;
      }
    } else {
      // Updated cells rounded, copied ones (the ring) narrowed exactly.
      const unsigned upd = r >= row_lo && r <= row_hi ? cin : 0u;
      heat_store_group(o, v, upd & 1u, upd & 2u, upd & 4u, upd & 8u,
                       sout & 1u, sout & 2u, sout & 4u, sout & 8u,
                       a.vec_out && sout == 0xfu);
    }
  }

  // Iteration i, input row t0 + i: every level one row further. Level 0
  // stays in the ring; levels 1 .. K-1 keep their last rows in U, M, D
  // (index s for level s). Levels 1 .. K in order, level s at row
  // t0 + i - s from level s-1's U, M and the D just made; level s-1 then
  // drops its oldest row.
  template <bool kCheck>
  __device__ __forceinline__ void iteration(float4 (&U)[K], float4 (&M)[K],
                                            float4 (&D)[K], int i) {
    float4 up0, c0, dn0;
    level0(up0, c0, dn0);
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const float4 up = s == 1 ? up0 : U[s - 1];
      const float4 c = s == 1 ? c0 : M[s - 1];
      const float4 dn = s == 1 ? dn0 : D[s - 1];
      const float4 v = step<kCheck>(up, c, dn, i - s, kRound && s < K);
      if (s == K) emit<kCheck>(v, c, i - K);
      if (s > 1) {
        U[s - 1] = M[s - 1];
        M[s - 1] = D[s - 1];
      }
      if (s < K) D[s] = v;
    }
  }

  __device__ __forceinline__ void run() {
    // Every iteration's levels reach only interior rows where t - K >= 1
    // and t - 1 <= m - 2 (t = t0 + i), and only interior columns in a
    // band whose 128 columns lie in [1, n - 2]: there the test-free step.
    const bool edge_band = gx0 < 1 || gx0 + kIWidth > a.n - 1;
    int i_a = n_iter, i_b = n_iter;
    if (!edge_band) {
      i_a = row_lo + K < 0 ? 0 : min(row_lo + K, n_iter);
      i_b = row_hi + 2 < i_a ? i_a : min(row_hi + 2, n_iter);
    }
    for (int s = 0; s < a.stages && s < n_stages; ++s) fill(s, s);
    float4 U[K], M[K], D[K];
#pragma unroll
    for (int s = 0; s < K; ++s)
      U[s] = M[s] = D[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
#pragma unroll 1
    for (; i < i_a; ++i) iteration<true>(U, M, D, i);
#pragma unroll 3
    for (; i < i_b; ++i) iteration<false>(U, M, D, i);
#pragma unroll 1
    for (; i < n_iter; ++i) iteration<true>(U, M, D, i);
  }
};

// One block: warps side by side on bands blockIdx.x % (column blocks) *
// warps + warp, all in segment blockIdx.x / (column blocks). A warp past
// the last band returns at once; no barrier joins the warps.
template <int K, bool kTma, typename Tin = float, typename Tout = float,
          bool kRound = false>
__device__ __forceinline__ void heat_i_block(const HeatIArgs& a,
                                             const CUtensorMap* map) {
  extern __shared__ __align__(128) float smem[];
  const int warps = static_cast<int>(blockDim.y);
  const int warp = static_cast<int>(threadIdx.y);
  const int64_t col_blocks = (a.n_bands + warps - 1) / warps;
  const int64_t band = (blockIdx.x % col_blocks) * warps + warp;
  if (band >= a.n_bands) return;  // uniform across the warp
  // The rings from the first 128-byte boundary (a box's alignment), an
  // offset into smem so that the pointers stay shared ones; then the
  // mbarriers.
  float* base = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  float* ring;
  uint64_t* bars;
  if constexpr (std::is_same<Tin, float>::value) {
    const int stage_f = a.rows * kIWidth;
    ring = base + warp * a.stages * stage_f;
    bars = reinterpret_cast<uint64_t*>(base + warps * a.stages * stage_f) +
           warp * a.stages;
  } else {
    char* b = reinterpret_cast<char*>(base);
    ring = reinterpret_cast<float*>(b + warp * a.stages * a.stage_bytes);
    bars = reinterpret_cast<uint64_t*>(b + warps * a.stages * a.stage_bytes) +
           warp * a.stages;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s)
      heat_mbar_init_count(bars + s,
                           kTma ? 1u : static_cast<uint32_t>(kILanes));
    heat_mbar_init_fence();
  }
  __syncwarp();  // the mbarriers are initialised for every lane
  HeatIBand<K, kTma, Tin, Tout, kRound> b(a, map, ring, bars, band,
                                          blockIdx.x / col_blocks);
  b.run();
  uint32_t r = heat_warp_max(b.rmax);
  if (threadIdx.x == 0 && r != 0u && a.res != nullptr) {
    const uint32_t seen = *reinterpret_cast<volatile uint32_t*>(a.res);
    if (r > seen) atomicMax(a.res, r);
  }
}

using HeatIKernel = void (*)(const HeatIArgs, const CUtensorMap);

// The checks of an I or I-uni launch: the grid, K, the warps a block and
// the ring, whose stages of `elem`-byte cells must fit a block's shared
// memory (ops/hopper_params.py i_takes is the same rule), a grid of
// blocks that fits one launch. Sets *n_bands and *blocks. Returns a
// cudaError_t.
inline int heat_i_geometry(int64_t m, int64_t n, int k, int64_t seg_rows,
                           int warps, int rows, int stages,
                           int64_t* n_bands, int64_t* blocks, int elem = 4) {
  // Rows and columns are 32-bit in the loop.
  if (m < 3 || n < 3 || m > 0x7fffff00LL || n > 0x7fffff00LL || k < 1 ||
      k > kIMaxK ||
      seg_rows < 1 || warps < 1 ||
      warps > kIMaxWarps || rows < kIMinRows || rows > kIMaxRows ||
      stages < 2 || stages > kIMaxStages ||
      heat_i_smem_bytes(warps, rows, stages, elem) > kIMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  *n_bands = (n + heat_i_tile_x(k) - 1) / heat_i_tile_x(k);
  *blocks = (*n_bands + warps - 1) / warps * ((m + seg_rows - 1) / seg_rows);
  return *blocks > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue)
                                : 0;
}

// The host side of every entry point: K steps of the m x n grid `u` of
// Tin cells into `out` of Tout cells (distinct buffers on the current
// device) over bands of
// heat_i_tile_x(k) output columns, a warp each, `warps` to a block, and
// segments of seg_rows rows, each warp's rows in a ring of `stages`
// stages of `rows` rows. kernels[k - 1] is the kernel of depth k. With
// kTma the grid is read through a tensor map of Tin cells (its rows a
// multiple of 16 bytes, `u` 16-byte aligned). With `res`
// non-null, the last step's residual bit pattern lands in *res. Launches
// on `stream` and does not synchronise. Returns a cudaError_t: 0, or the
// reason the launch was refused; or a tensor-map encoding error
// (heat_tma_error_string).
template <bool kTma, typename Tin = float, typename Tout = float>
inline int heat_i_launch(const HeatIKernel* kernels, const void* u,
                         void* out, uint32_t* res, int64_t m, int64_t n,
                         int k, int64_t seg_rows, int warps, int rows,
                         int stages, float a0, float cx, float cy,
                         void* stream) {
  constexpr int kElem = sizeof(Tin);
  int64_t n_bands = 0, blocks = 0;
  const int bad = heat_i_geometry(m, n, k, seg_rows, warps, rows, stages,
                                  &n_bands, &blocks, kElem);
  if (bad != 0) return bad;
  CUtensorMap map = {};
  if (kTma) {
    if (n % (16 / kElem) != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * kElem};
    const cuuint32_t box[2] = {
        static_cast<cuuint32_t>(heat_i_row_cells(kElem)),
        static_cast<cuuint32_t>(rows)};
    const int enc = heat_tma_encode(&map, u, 2, dims, strides, box,
                                    kElem == 2
                                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (enc != 0) return enc;
  }
  const HeatIKernel kernel = kernels[k - 1];
  const size_t smem = heat_i_smem_bytes(warps, rows, stages, kElem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  HeatIArgs args = {};
  args.u = static_cast<const float*>(u);
  args.out = static_cast<float*>(out);
  args.res = res;
  args.m = m;
  args.n = n;
  args.n_bands = n_bands;
  args.seg_rows = seg_rows;
  args.rows = rows;
  args.stages = stages;
  args.vec_out = n % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % (4 * sizeof(Tout)) == 0;
  args.a0 = a0;
  args.cx = cx;
  args.cy = cy;
  args.stage_bytes = heat_i_stage_bytes(rows, kElem);
  kernel<<<static_cast<unsigned>(blocks), dim3(kILanes, warps), smem, s>>>(
      args, map);
  return static_cast<int>(cudaGetLastError());
}

// Thread blocks of kernels[k - 1] that one SM holds at once under
// `warps` warps and a ring of `stages` stages of `rows` rows of
// `elem`-byte cells, into *blocks (the CUDA occupancy calculator,
// registers included). Returns a cudaError_t.
inline int heat_i_occupancy(const HeatIKernel* kernels, int k, int warps,
                            int rows, int stages, int* blocks,
                            int elem = 4) {
  int64_t n_bands = 0, grid = 0;
  if (blocks == nullptr ||
      heat_i_geometry(3, 3, k, 1, warps, rows, stages, &n_bands, &grid,
                      elem) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const HeatIKernel kernel = kernels[k - 1];
  const size_t smem = heat_i_smem_bytes(warps, rows, stages, elem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kILanes * warps, smem));
}

// --- The precision forms (heat_temporal.cuh kHeatForm*) -----------------
//
// A kernel's forms a table of its instances, kernels[form][k - 1]; each
// form's launch takes the form's storage types (HeatForm).

using HeatIFormKernels = HeatIKernel[4][kIMaxK];

// The launch of precision form `form` (0 .. 3) of the kernel whose
// instances are `kernels`, as heat_i_launch. Returns a cudaError_t.
template <bool kTma>
inline int heat_i_form_launch(const HeatIFormKernels& kernels, int form,
                              const void* u, void* out, uint32_t* res,
                              int64_t m, int64_t n, int k, int64_t seg_rows,
                              int warps, int rows, int stages, float a0,
                              float cx, float cy, void* stream) {
  switch (form) {
#define HEAT_I_FORM_CASE(f)                                                  \
  case f:                                                                    \
    return heat_i_launch<kTma, HeatForm<f>::In, HeatForm<f>::Out>(           \
        kernels[f], u, out, res, m, n, k, seg_rows, warps, rows, stages, a0, \
        cx, cy, stream);
    HEAT_I_FORM_CASE(kHeatFormBf16)
    HEAT_I_FORM_CASE(kHeatFormCarry)
    HEAT_I_FORM_CASE(kHeatFormCarryOut)
    HEAT_I_FORM_CASE(kHeatFormCarryIn)
#undef HEAT_I_FORM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// heat_i_occupancy of form `form`'s instance of depth k.
inline int heat_i_form_occupancy(const HeatIFormKernels& kernels, int form,
                                 int k, int warps, int rows, int stages,
                                 int* blocks) {
  if (form < kHeatFormBf16 || form > kHeatFormCarryIn)
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_i_occupancy(kernels[form], k, warps, rows, stages, blocks,
                          form == kHeatFormCarryIn ? 4 : 2);
}

// The instances of a bfloat16 kernel template `kernel<K, kForm>` for
// every form and depth, in heat_i_form_launch's order.
#define HEAT_I_DEPTHS(kernel, f)                                         \
  {kernel<1, f>, kernel<2, f>, kernel<3, f>, kernel<4, f>, kernel<5, f>, \
   kernel<6, f>, kernel<7, f>, kernel<8, f>}
#define HEAT_I_FORM_TABLE(kernel)                               \
  {HEAT_I_DEPTHS(kernel, kHeatFormBf16),                        \
   HEAT_I_DEPTHS(kernel, kHeatFormCarry),                       \
   HEAT_I_DEPTHS(kernel, kHeatFormCarryOut),                    \
   HEAT_I_DEPTHS(kernel, kHeatFormCarryIn)}
