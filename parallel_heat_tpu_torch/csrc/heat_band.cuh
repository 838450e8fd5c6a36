// Shared device code of the band-streaming temporal kernels
// (heat_i_tile_temporal.cu, heat_i_uni_tile_temporal.cu): K Jacobi steps
// per pass through global memory over column bands, each band streamed
// down its rows. The two kernels differ only in how they load a row.
//
// A block owns a band of TX output columns plus a K-deep halo of columns
// on each side, W = TX + 2K columns, one thread per column, and a
// segment of output rows [r0, r1). It streams the input rows
// [r0 - K, r1 + K) through shared memory one row per iteration, and in
// the iteration that brings input row t it advances every level at
// once: level s (the grid after s steps) at row t - s, for s = 1 .. K,
// so level K comes out K rows behind the input. Each level needs only
// three rows of the level below, and a thread keeps those of its own
// column in registers; its left and right neighbours come from shared
// memory, where each level keeps its last two rows. One barrier per
// input row orders it all: a level's row is read by its neighbours in
// the next iteration, from the slot that was not written in this one.
//
// What the design does about the bound: unlike heat_e_temporal, which
// recomputes a K-deep halo on all four sides of each tile, only the
// column halo is recomputed (1 + 2K/TX cells per output cell), and the
// rows are carried from one to the next, recomputed only at the start of
// a segment (2K rows per segment). A cell-step reads two neighbours from
// shared memory and writes one value there.
//
// Values outside the valid pyramid (levels whose rows or columns reach
// past what the input supports) are garbage that only ever spreads
// outward, one cell per level, and never reaches the output rows and
// columns; global boundary cells are copied, never recomputed, and every
// step rounds to float32 like a launch of heat_b_step, which makes K
// steps bitwise K launches of B.

#pragma once

#include <cuda_pipeline.h>

#include "heat_common.cuh"

// Input rows prefetched ahead of the one being stepped, and the input
// ring's slots: the rows in flight plus the current and the previous.
constexpr int kBandPrefetch = 4;
constexpr int kBandSlots = kBandPrefetch + 2;

// Issue the copy of input row t into ring slot `slot`. Outside the grid
// a cell is zero-filled. With kUniform, a row wholly inside the grid
// whose band is 16-byte aligned is copied in 16-byte pieces with no test.
template <bool kUniform>
__device__ __forceinline__ void heat_band_load_row(
    const float* __restrict__ u, float* ring, int slot, int64_t t,
    int64_t m, int64_t n, int64_t gx0, int w, bool aligned) {
  float* dst = ring + slot * w;
  const int c = threadIdx.x;
  if (kUniform && aligned && t >= 0 && t < m) {
    const float* src = u + t * n + gx0;
    if (4 * c < w) __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
    return;
  }
  const int64_t gj = gx0 + c;
  const bool in = t >= 0 && t < m && gj >= 0 && gj < n;
  __pipeline_memcpy_async(dst + c, in ? u + t * n + gj : u, 4, in ? 0 : 4);
}

// Levels 1 .. K of one input row: level s at row t - s. up, mid and down
// hold this thread's column of the last three rows of levels 0 .. K-1,
// `prev0` the input row t - 1 (level 0's neighbours), `lev` levels 1 .. K-1
// two rows each, by the row's parity; par is t's parity. With kRowsIn the
// K rows made are all interior rows of the grid and are not tested.
// `out_row` is where level K goes, or null when row t - K is not this
// block's to write.
template <int K, bool kRowsIn>
__device__ __forceinline__ void heat_band_levels(
    float (&up)[K], float (&mid)[K], float (&down)[K],
    const float* prev0, float* lev, int w, int c, int par, int64_t t,
    int64_t m, bool col_in, float* out_row, float a0, float cx, float cy,
    uint32_t* rmax) {
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    // Level s-1 at row t - s: this thread's column in mid[s-1], the
    // neighbours' in shared memory (written in the last iteration).
    const float* nb =
        s == 1 ? prev0 : lev + ((s - 2) * 2 + (par ^ (s & 1))) * w;
    const float left = c > 0 ? nb[c - 1] : 0.f;
    const float right = c + 1 < w ? nb[c + 1] : 0.f;
    const float cc = mid[s - 1];
    bool in = col_in;
    if (!kRowsIn) in = in && t - s >= 1 && t - s <= m - 2;
    const float v = in ? heat_combine(cc, up[s - 1], down[s - 1], left, right,
                                      a0, cx, cy)
                       : cc;
    if (s < K) {
      lev[((s - 1) * 2 + (par ^ (s & 1))) * w + c] = v;
      up[s] = mid[s];
      mid[s] = down[s];
      down[s] = v;
    } else if (out_row != nullptr) {
      *out_row = v;
      if (in) *rmax = max(*rmax, heat_diff_bits(v, cc));
    }
  }
}

// One block: the band of blockIdx.x % n_bands, the segment of
// blockIdx.x / n_bands. blockDim.x is the band's width, tile_x + 2K.
template <int K, bool kUniform>
__device__ __forceinline__ void heat_band_run(
    const float* __restrict__ u, float* __restrict__ out, uint32_t* res,
    int64_t m, int64_t n, int64_t n_bands, int tile_x, int seg_rows,
    float a0, float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  const int w = tile_x + 2 * K;
  float* ring = smem;                     // kBandSlots input rows
  float* lev = smem + kBandSlots * w;     // levels 1 .. K-1, two rows each
  const int c = threadIdx.x;              // this thread's band column
  const int64_t band = blockIdx.x % n_bands;
  const int64_t r0 = (blockIdx.x / n_bands) * seg_rows;
  const int64_t r1 = r0 + seg_rows < m ? r0 + seg_rows : m;
  const int64_t gx0 = band * tile_x - K;  // global column of band column 0
  const int64_t gj = gx0 + c;
  const bool aligned = gx0 >= 0 && gx0 + w <= n && gx0 % 4 == 0 &&
                       n % 4 == 0 && w % 4 == 0;
  const bool col_in = gj >= 1 && gj <= n - 2;
  const bool col_out = c >= K && c < K + tile_x && gj < n;
  const int64_t t0 = r0 - K, t1 = r1 + K;

  // Input row t0 + i lives in ring slot i % kBandSlots.
  for (int i = 0; i < kBandPrefetch; ++i) {
    if (t0 + i < t1)
      heat_band_load_row<kUniform>(u, ring, i, t0 + i, m, n, gx0, w,
                                   aligned);
    __pipeline_commit();
  }
  // This thread's column of the last three rows of levels 0 .. K-1.
  float up[K], mid[K], down[K];
#pragma unroll
  for (int s = 0; s < K; ++s) up[s] = mid[s] = down[s] = 0.f;
  uint32_t rmax = 0u;
  int cur = 0;  // ring slot of row t
  for (int64_t t = t0; t < t1; ++t) {
    // Row t has landed, for every thread once past the barrier, which
    // also ends the last iteration's reads of the slot refilled next.
    __pipeline_wait_prior(kBandPrefetch - 1);
    __syncthreads();
    const int prev = cur == 0 ? kBandSlots - 1 : cur - 1;
    if (t + kBandPrefetch < t1) {
      int next = cur + kBandPrefetch;
      if (next >= kBandSlots) next -= kBandSlots;
      heat_band_load_row<kUniform>(u, ring, next, t + kBandPrefetch, m, n,
                                   gx0, w, aligned);
    }
    __pipeline_commit();
    up[0] = mid[0];
    mid[0] = down[0];
    down[0] = ring[cur * w + c];
    float* out_row =
        col_out && t - K >= r0 && t - K < r1 ? out + (t - K) * n + gj
                                               : nullptr;
    const int par = static_cast<int>(t & 1);
    if (t - K >= 1 && t - 1 <= m - 2)
      heat_band_levels<K, true>(up, mid, down, ring + prev * w, lev, w, c,
                                par, t, m, col_in, out_row, a0, cx, cy,
                                &rmax);
    else
      heat_band_levels<K, false>(up, mid, down, ring + prev * w, lev, w, c,
                                 par, t, m, col_in, out_row, a0, cx, cy,
                                 &rmax);
    cur = cur + 1 == kBandSlots ? 0 : cur + 1;
  }
  if (res != nullptr) heat_block_max(rmax, res);
}

using HeatBandKernel = void (*)(const float*, float*, uint32_t*, int64_t,
                                int64_t, int64_t, int, int, float, float,
                                float);

// The host side of both entry points: K steps of the m x n float32 grid
// `u` into `out` (distinct buffers on the current device) over bands of
// tile_x output columns and segments of seg_rows rows, with one thread
// per band column (block_x == tile_x + 2k, at most 256, the kernels'
// launch bound). kernels[k - 1] is the
// kernel of depth k, 1 <= k <= 8. With `res` non-null, the last step's
// residual bit pattern lands in *res. Launches on `stream` and does not
// synchronise. Returns a cudaError_t: 0, or the reason the launch was
// refused.
inline int heat_band_launch(const HeatBandKernel* kernels, const float* u,
                            float* out, uint32_t* res, int64_t m, int64_t n,
                            int k, int tile_x, int seg_rows, int block_x,
                            float a0, float cx, float cy, void* stream) {
  if (m < 3 || n < 3 || k < 1 || k > 8 || tile_x < 1 || seg_rows < 1 ||
      block_x != tile_x + 2 * k || block_x % 32 != 0 || block_x > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_bands = (n + tile_x - 1) / tile_x;
  const int64_t blocks = n_bands * ((m + seg_rows - 1) / seg_rows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kBandSlots + 2 * (k - 1)) * block_x;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    cudaError_t err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernels[k - 1]<<<static_cast<unsigned>(blocks), block_x, smem, s>>>(
      u, out, res, m, n, n_bands, tile_x, seg_rows, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}
