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

#pragma once

#include <cuda_pipeline.h>

#include "heat_common.cuh"
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

// Dynamic shared memory of one block (ops/hopper_params.py
// i_smem_bytes): 128 bytes to align the rings, `stages` stages of `rows`
// rows of 128 floats for each of `warps` warps, an 8-byte mbarrier a
// stage.
inline size_t heat_i_smem_bytes(int warps, int rows, int stages) {
  return sizeof(float) * static_cast<size_t>(warps) * stages * rows *
             kIWidth +
         128 + sizeof(uint64_t) * static_cast<size_t>(warps) * stages;
}

// The launch arguments of both kernels.
struct HeatIArgs {
  const float* u;       // the m x n grid (I; I-uni reads it by its map)
  float* out;           // K steps of it
  uint32_t* res;        // the residual's bits, or null
  int64_t m, n;
  int64_t n_bands;      // bands of heat_i_tile_x(K) output columns
  int64_t seg_rows;     // output rows a segment
  int rows, stages;     // the ring: input rows a stage, stages a warp
  int vec_out;          // out's rows take 16-byte stores
  float a0, cx, cy;
};

// One warp's band and segment, streamed. kTma: I-uni's load (the map
// `map` of the grid, boxes of rows x 128 floats); else I's. Rows are
// counted from the segment's first input row t0 as 32-bit iteration
// numbers i (input row t0 + i), so that the loop keeps few registers
// besides the levels' 8 (K - 1) floats.
template <int K, bool kTma>
struct HeatIBand {
  static constexpr int P = heat_i_pad(K);
  static constexpr int TX = heat_i_tile_x(K);

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
    rd0 = heat_smem_addr(ring) + 16u * static_cast<uint32_t>(lane);
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
    float* dst = ring + s * a.rows * kIWidth;
    const int row0 = t0 + qq * a.rows;
    if constexpr (kTma) {
      if (lane == 0) {
        heat_mbar_expect(bars + s,
                         static_cast<uint32_t>(sizeof(float) * a.rows *
                                               kIWidth));
        heat_tma_load_2d(dst, map, bars + s, gx0, row0);
      }
    } else {
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
    }
  }

  // Level 0's three rows that level 1 steps in this iteration, the
  // lane's 4 cells of each, from the ring: input rows i - 2, i - 1 and i.
  // Waits for a stage before its first row, and refills the stage before
  // once its last row has been read for the last time (one row into this
  // one).
  __device__ __forceinline__ void level0(float4& up, float4& c,
                                         float4& dn) {
    if (j == 0) heat_mbar_wait(bars + slot, lap);
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(up.x), "=f"(up.y), "=f"(up.z), "=f"(up.w)
                 : "r"(p2));
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(c.x), "=f"(c.y), "=f"(c.z), "=f"(c.w)
                 : "r"(p1));
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(dn.x), "=f"(dn.y), "=f"(dn.z), "=f"(dn.w)
                 : "r"(rd));
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
    // The ring's rows lie one after another: the next row is 512 bytes
    // on, back to row 0 after the last stage.
    p2 = p1;
    p1 = rd;
    rd += sizeof(float) * kIWidth;
    if (++j == a.rows) {
      j = 0;
      ++q;
      if (++slot == a.stages) {
        slot = 0;
        lap ^= 1u;
        rd = rd0;
      }
    }
  }

  // Level s's new row (row t0 + r of the grid) from level s-1's rows up,
  // c (centre) and dn, with the cells left and right of the lane's group
  // by shuffle. kCheck: cells outside the global interior are copied;
  // without it every cell is updated.
  template <bool kCheck>
  __device__ __forceinline__ float4 step(float4 up, float4 c, float4 dn,
                                         int r) const {
    const float lf = __shfl_up_sync(0xffffffffu, c.w, 1);
    const float rt = __shfl_down_sync(0xffffffffu, c.x, 1);
    float4 v;
    v.x = heat_combine(c.x, up.x, dn.x, lf, c.y, a.a0, a.cx, a.cy);
    v.y = heat_combine(c.y, up.y, dn.y, c.x, c.z, a.a0, a.cx, a.cy);
    v.z = heat_combine(c.z, up.z, dn.z, c.y, c.w, a.a0, a.cx, a.cy);
    v.w = heat_combine(c.w, up.w, dn.w, c.z, rt, a.a0, a.cx, a.cy);
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
    float* o = a.out + (static_cast<int64_t>(t0 + r) * a.n + gx);
    if (!kCheck) {
      // An output lane: lanes P/4 .. (P + TX)/4 - 1.
      if (static_cast<unsigned>(lane - P / 4) >= TX / 4u) return;
      rmax = max(rmax, max(max(heat_diff_bits(v.x, c.x),
                               heat_diff_bits(v.y, c.y)),
                           max(heat_diff_bits(v.z, c.z),
                               heat_diff_bits(v.w, c.w))));
      if (a.vec_out) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        o[0] = v.x;
        o[1] = v.y;
        o[2] = v.z;
        o[3] = v.w;
      }
      return;
    }
    const unsigned in = r >= row_lo && r <= row_hi ? sout & cin : 0u;
    if (in & 1u) rmax = max(rmax, heat_diff_bits(v.x, c.x));
    if (in & 2u) rmax = max(rmax, heat_diff_bits(v.y, c.y));
    if (in & 4u) rmax = max(rmax, heat_diff_bits(v.z, c.z));
    if (in & 8u) rmax = max(rmax, heat_diff_bits(v.w, c.w));
    if (a.vec_out && sout == 0xfu) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      if (sout & 1u) o[0] = v.x;
      if (sout & 2u) o[1] = v.y;
      if (sout & 4u) o[2] = v.z;
      if (sout & 8u) o[3] = v.w;
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
      const float4 v = step<kCheck>(up, c, dn, i - s);
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
template <int K, bool kTma>
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
  const int stage_f = a.rows * kIWidth;
  float* ring = base + warp * a.stages * stage_f;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + warps * a.stages * stage_f) +
      warp * a.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s)
      heat_mbar_init_count(bars + s,
                           kTma ? 1u : static_cast<uint32_t>(kILanes));
    heat_mbar_init_fence();
  }
  __syncwarp();  // the mbarriers are initialised for every lane
  HeatIBand<K, kTma> b(a, map, ring, bars, band, blockIdx.x / col_blocks);
  b.run();
  uint32_t r = heat_warp_max(b.rmax);
  if (threadIdx.x == 0 && r != 0u && a.res != nullptr) {
    const uint32_t seen = *reinterpret_cast<volatile uint32_t*>(a.res);
    if (r > seen) atomicMax(a.res, r);
  }
}

using HeatIKernel = void (*)(const HeatIArgs, const CUtensorMap);

// The checks of an I or I-uni launch: the grid, K, the warps a block and
// the ring (ops/hopper_params.py i_takes is the same rule), a grid of
// blocks that fits one launch. Sets *n_bands and *blocks. Returns a
// cudaError_t.
inline int heat_i_geometry(int64_t m, int64_t n, int k, int64_t seg_rows,
                           int warps, int rows, int stages,
                           int64_t* n_bands, int64_t* blocks) {
  // Rows and columns are 32-bit in the loop.
  if (m < 3 || n < 3 || m > 0x7fffff00LL || n > 0x7fffff00LL || k < 1 ||
      k > kIMaxK ||
      seg_rows < 1 || warps < 1 ||
      warps > kIMaxWarps || rows < kIMinRows || rows > kIMaxRows ||
      stages < 2 || stages > kIMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  *n_bands = (n + heat_i_tile_x(k) - 1) / heat_i_tile_x(k);
  *blocks = (*n_bands + warps - 1) / warps * ((m + seg_rows - 1) / seg_rows);
  return *blocks > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue)
                                : 0;
}

// The host side of both entry points: K steps of the m x n float32 grid
// `u` into `out` (distinct buffers on the current device) over bands of
// heat_i_tile_x(k) output columns, a warp each, `warps` to a block, and
// segments of seg_rows rows, each warp's rows in a ring of `stages`
// stages of `rows` rows. kernels[k - 1] is the kernel of depth k. With
// kTma the grid is read through a
// tensor map (its width a multiple of 4, `u` 16-byte aligned). With `res`
// non-null, the last step's residual bit pattern lands in *res. Launches
// on `stream` and does not synchronise. Returns a cudaError_t: 0, or the
// reason the launch was refused; or a tensor-map encoding error
// (heat_tma_error_string).
template <bool kTma>
inline int heat_i_launch(const HeatIKernel* kernels, const float* u,
                         float* out, uint32_t* res, int64_t m, int64_t n,
                         int k, int64_t seg_rows, int warps, int rows,
                         int stages, float a0, float cx, float cy,
                         void* stream) {
  int64_t n_bands = 0, blocks = 0;
  const int bad = heat_i_geometry(m, n, k, seg_rows, warps, rows, stages,
                                  &n_bands, &blocks);
  if (bad != 0) return bad;
  CUtensorMap map = {};
  if (kTma) {
    if (n % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(m)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kIWidth),
                               static_cast<cuuint32_t>(rows)};
    const int enc = heat_tma_encode(&map, u, 2, dims, strides, box);
    if (enc != 0) return enc;
  }
  const HeatIKernel kernel = kernels[k - 1];
  const size_t smem = heat_i_smem_bytes(warps, rows, stages);
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
  args.u = u;
  args.out = out;
  args.res = res;
  args.m = m;
  args.n = n;
  args.n_bands = n_bands;
  args.seg_rows = seg_rows;
  args.rows = rows;
  args.stages = stages;
  args.vec_out = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  args.a0 = a0;
  args.cx = cx;
  args.cy = cy;
  kernel<<<static_cast<unsigned>(blocks), dim3(kILanes, warps), smem, s>>>(
      args, map);
  return static_cast<int>(cudaGetLastError());
}

// Thread blocks of kernels[k - 1] that one SM holds at once under
// `warps` warps and a ring of `stages` stages of `rows` rows, into
// *blocks (the CUDA occupancy calculator, registers included). Returns a
// cudaError_t.
inline int heat_i_occupancy(const HeatIKernel* kernels, int k, int warps,
                            int rows, int stages, int* blocks) {
  int64_t n_bands = 0, grid = 0;
  if (blocks == nullptr ||
      heat_i_geometry(3, 3, k, 1, warps, rows, stages, &n_bands, &grid) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const HeatIKernel kernel = kernels[k - 1];
  const size_t smem = heat_i_smem_bytes(warps, rows, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kILanes * warps, smem));
}
