// Shared code of the sharded 2D block kernels heat_g_block_padded.cu,
// heat_g_block_circular.cu, heat_g_block_fused.cu, heat_g_block_uniform.cu
// and heat_g_band_fix.cu: K Jacobi steps on one bx x by block of an
// m x n grid cut over a device mesh, from the block and the K-deep halo
// its neighbours sent (parallel/temporal.py), with the residual of the
// last step.
//
// Replaces the kernel-G family of parallel_heat_tpu/ops/pallas_stencil.py
// (_build_temporal_block, _build_temporal_block_circular,
// _build_temporal_block_fused, _build_temporal_block_uniform,
// _build_band_fix_2d). Each TPU builder keeps its own entry point here.
//
// Bound on the H100: a round reads the block once and writes its core
// once for K steps, plus each tile's K-deep frame, about
// 8*(1+2K/TY)*(1+2K/TX)/K bytes per cell-step (kernel E's), plus the
// tail and halo pieces, 4*(2K*bx + 2K*(by+2K)) bytes a block. Across the
// mesh a block also recomputes 2K(bx+by+2K) cells per round that its
// neighbours own, under 0.3% of a 16384 x 8192 block at K = 8; the
// design keeps that share small by taking K deep and by never assembling
// the extended block in HBM (the fused and uniform forms gather the
// pieces straight into shared memory). Below the bytes lie the step
// loop's shared-memory traffic and instruction issue: with the column
// walk (a thread a run of rows of one column, since removed) each
// cell-step read three operands from shared memory and stored one, 16
// bytes and about 14 instructions, which held the family at 4x its byte
// bound.
//
// Design. Tiles of TY x TX output cells with a K-deep frame on all four
// sides, ping-pong in shared memory, the last step written straight to
// global memory and the residual folded by atomicMax on the float's bits.
// The step loop is the register-blocked tile loop of heat_temporal.cuh
// (heat_tile_steps), kernel E's: a warp walks a run of rows of the tile,
// each lane owning 4 adjacent columns in float4 registers, neighbours by
// shuffle, 8 bytes of shared traffic and about 10 instructions a
// cell-step. Cells outside the global interior are copied, never
// recomputed, so the Dirichlet ring stays bit-exact even in a diverging
// run, and a block's K steps are bitwise kernel E's K steps on the same
// cells of the global grid (the TPU kernels pin the ring multiplicatively
// and re-pin it afterwards; this family needs neither). A block's framed
// tile is gathered in global coordinates (row_off, col_off of the
// block's cell (0, 0), int64) from
//   - u, the block, for its own cells;
//   - tail = [hi | lo] (bx x 2K): hi for global columns
//     [col_off+by, col_off+by+K), lo for [col_off-K, col_off) -- the
//     circular order of pallas_stencil.py:1648-1650;
//   - halo_n / halo_s (K x (by+2K)), the K rows above and below, corners
//     included, their columns in the same circular order [u | hi | lo];
//   - zero outside the global grid, and beyond the block's K-deep frame
//     (a ragged last tile reaches past it; those cells are K or more
//     cells from any output and never reach one in K steps).
// The assembled layouts read one buffer instead: circular (the pieces
// stacked as [halo_n ; u | hi | lo ; halo_s]) and padded ([lo | u | hi]
// between the halo rows, the JAX package's exchange_halos_deep_2d).
// The deferred bulk (halo_n = halo_s = null) writes only output rows
// [K, bx-K), whose K-step cone stays inside the block; the band kernel
// writes rows [0, K) and [bx-K, bx) from two (3K) x (TX+2K) windows into
// the bulk's output in place. Each counts the residual of exactly the
// rows it writes, so max(bulk, band) is the monolithic kernel's residual.
//
// Launch shapes: the tile loop's (heat_loop_takes; heat_g_launch refuses
// others).

#pragma once

#include "heat_temporal.cuh"

enum HeatGLayout { kHeatGFused = 0, kHeatGCircular = 1, kHeatGPadded = 2 };

// The address of block-local cell (lr, lc), -K <= lr < bx + K and
// -K <= lc < by + K, in the layout's buffers; null where the fused
// layout has no halo row (the deferred bulk), which loads as 0.
template <int kLayout, typename T>
__device__ __forceinline__ const T* heat_g_src(
    const T* u, const T* tail, const T* hn, const T* hs,
    int64_t bx, int64_t by, int k, int64_t lr, int64_t lc) {
  const int64_t w = by + 2 * k;  // a halo row, or an assembled row
  if (kLayout == kHeatGPadded) return u + (lr + k) * w + (lc + k);
  const int64_t cc = lc < 0 ? lc + w : lc;  // circular column
  if (kLayout == kHeatGCircular) return u + (lr + k) * w + cc;
  if (lr < 0) return hn != nullptr ? hn + (lr + k) * w + cc : nullptr;
  if (lr >= bx) return hs != nullptr ? hs + (lr - bx) * w + cc : nullptr;
  if (lc >= 0 && lc < by) return u + lr * by + lc;
  return tail + lr * (2 * k) + (cc - by);
}

// The parameters of every G kernel at storage type T (float32 or
// bfloat16), and their names: each entry point defines its own __global__
// function (so a profile names it) whose body is heat_g_tile with its
// layout, load and storage type.
#define HEAT_G_PARAMS_OF(T)                                                 \
  const T *__restrict__ u, const T *__restrict__ tail,                      \
      const T *__restrict__ hn, const T *__restrict__ hs,                   \
      T *__restrict__ out, uint32_t *res, int64_t m, int64_t n,             \
      int64_t bx, int64_t by, int64_t row_off, int64_t col_off, int k,      \
      int64_t r_begin0, int64_t r_begin1, int64_t rows,                     \
      int64_t n_col_tiles, int tile_y, int tile_x, float a0, float cx,      \
      float cy
#define HEAT_G_PARAMS HEAT_G_PARAMS_OF(float)
#define HEAT_G_ARGS                                                         \
  u, tail, hn, hs, out, res, m, n, bx, by, row_off, col_off, k, r_begin0,   \
      r_begin1, rows, n_col_tiles, tile_y, tile_x, a0, cx, cy

template <typename T>
using HeatGKernelOf = void (*)(const T*, const T*, const T*, const T*, T*,
                               uint32_t*, int64_t, int64_t, int64_t, int64_t,
                               int64_t, int64_t, int, int64_t, int64_t,
                               int64_t, int64_t, int, int, float, float,
                               float);
typedef HeatGKernelOf<float> HeatGKernel;

// One block of the launch: the output tile of TY x TX cells whose first
// row is block row r0 and first column c0, in region blockIdx.y (its
// first row r_begin0 or r_begin1, `rows` rows long), K steps, written to
// `out` (bx x by) and its residual folded into *res.
template <int kLayout, bool kUni>
__device__ __forceinline__ void heat_g_tile(HEAT_G_PARAMS) {
  extern __shared__ __align__(16) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  // Two buffers of sy rows of sx floats; tile column k (the core's
  // first) on a 16-byte boundary, as the step loop's groups need.
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  float* src = smem + pad;
  const int64_t region = blockIdx.y == 0 ? r_begin0 : r_begin1;
  const int64_t r0 = region + (blockIdx.x / n_col_tiles) * tile_y;
  const int64_t c0 = (blockIdx.x % n_col_tiles) * tile_x;
  // Block-local coordinates of shared cell (0, 0).
  const int64_t lr0 = r0 - k;
  const int64_t lc0 = c0 - k;

  // Does the framed tile lie inside the block? Then each of its rows is
  // one run of one buffer, whatever the layout.
  const bool inside = lr0 >= 0 && lr0 + sy <= bx && lc0 >= 0 &&
                      lc0 + sw <= by;
  if (kUni && inside) {
    // Kernel E-uni's load from u: 16-byte copies for the core columns
    // and no test per copy.
    const int vecs = tile_x / 4;
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const float* g = u + (lr0 + r) * by + lc0;
      float* s = src + r * sx;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x)
        __pipeline_memcpy_async(s + k + 4 * v, g + k + 4 * v, 16);
      for (int e = threadIdx.x; e < 2 * k; e += blockDim.x) {
        const int c = e < k ? e : tile_x + e;
        __pipeline_memcpy_async(s + c, g + c, 4);
      }
    }
  } else if (inside) {
    // Kernel E's load of an interior tile: one 4-byte copy per cell,
    // from the row's start in the layout's buffer.
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const float* g =
          heat_g_src<kLayout>(u, tail, hn, hs, bx, by, k, lr0 + r, lc0);
      for (int c = threadIdx.x; c < sw; c += blockDim.x)
        __pipeline_memcpy_async(src + r * sx + c, g + c, 4);
    }
  } else {
    // A tile at the block's edge: one checked 4-byte copy per cell from
    // the piece that holds it, zero-filled where none does.
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const int64_t lr = lr0 + r;
      const int64_t gi = row_off + lr;
      const bool row_in = gi >= 0 && gi < m && lr >= -k && lr < bx + k;
      for (int c = threadIdx.x; c < sw; c += blockDim.x) {
        const int64_t lc = lc0 + c;
        const int64_t gj = col_off + lc;
        const float* p =
            row_in && gj >= 0 && gj < n && lc >= -k && lc < by + k
                ? heat_g_src<kLayout>(u, tail, hn, hs, bx, by, k, lr, lc)
                : nullptr;
        __pipeline_memcpy_async(src + r * sx + c, p != nullptr ? p : u, 4,
                                p != nullptr ? 0 : 4);
      }
    }
  }
  __pipeline_commit();

  // The tile's output rows and columns, cut at the region's and the
  // block's end.
  const int64_t r_left = region + rows - r0;
  const int64_t c_left = by - c0;
  const int w_r1 = k + static_cast<int>(r_left < tile_y ? r_left : tile_y);
  const int w_c1 = k + static_cast<int>(c_left < tile_x ? c_left : tile_x);
  heat_tile_steps(smem, smem + sy * sx, sx, pad, sy, sw, row_off + lr0,
                  col_off + lc0, m, n, k, k, w_r1, w_c1, a0, cx, cy, out,
                  lr0 * by + lc0, by, res, HeatCpAsyncWait());
}

// Widens `rows` staged bfloat16 rows of `groups` groups of 4 cells, a row
// every `pitch` cells from `stage` (8-byte aligned), into float32 rows of
// `dst`, a row every `sx` floats (16-byte aligned): a group a thread at a
// time, exact (heat_widen4).
__device__ __forceinline__ void heat_g_widen_stage(
    const __nv_bfloat16* stage, int pitch, float* dst, int sx, int rows,
    int groups) {
  const int threads = blockDim.x * blockDim.y;
  for (int f = threadIdx.y * blockDim.x + threadIdx.x; f < rows * groups;
       f += threads) {
    const int r = f / groups;
    const int g = f - r * groups;
    *reinterpret_cast<float4*>(dst + r * sx + 4 * g) =
        heat_widen4(stage + r * pitch + 4 * g);
  }
}

// The bfloat16 form's load and steps (storage precision,
// heat_temporal.cuh): every cell widened to float32 as it lands, so the
// loop's buffers and steps are float32's; every level rounded to
// bfloat16 before the next step reads it, the last store rounded, the
// copied cells (the Dirichlet ring) narrowed exactly. cp.async cannot
// widen, so the loads are plain 2-byte loads into shared memory
// (kernel E's bfloat16 load, heat_e_load_widen), ended by the block's
// barrier. The uniform form's tiles that lie inside the block stage
// their core columns instead: 16-byte cp.async copies of the bfloat16
// rows into the second ping-pong buffer, which no step writes before
// step 1, widened into the first once they have landed (E-uni's
// bfloat16 box is staged the same way); the 2K frame columns are plain
// loads. That needs the block's width and the tile's a multiple of 8
// cells (heat_g_launch checks both) and a 16-byte aligned block.
template <int kLayout, bool kUni>
__device__ __forceinline__ void heat_g_tile_bf16(
    HEAT_G_PARAMS_OF(__nv_bfloat16)) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  float* src = smem + pad;
  T* stage = reinterpret_cast<T*>(smem + sy * sx);  // the second buffer
  const int64_t region = blockIdx.y == 0 ? r_begin0 : r_begin1;
  const int64_t r0 = region + (blockIdx.x / n_col_tiles) * tile_y;
  const int64_t c0 = (blockIdx.x % n_col_tiles) * tile_x;
  const int64_t lr0 = r0 - k;
  const int64_t lc0 = c0 - k;
  const bool inside = lr0 >= 0 && lr0 + sy <= bx && lc0 >= 0 &&
                      lc0 + sw <= by;
  const bool staged = kUni && inside;
  if (staged) {
    const int vecs = tile_x / 8;
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const T* g = u + (lr0 + r) * by + lc0;
      float* s = src + r * sx;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x)
        __pipeline_memcpy_async(stage + r * tile_x + 8 * v, g + k + 8 * v,
                                16);
      for (int e = threadIdx.x; e < 2 * k; e += blockDim.x) {
        const int c = e < k ? e : tile_x + e;
        s[c] = heat_widen(g[c]);
      }
    }
    __pipeline_commit();
  } else if (inside) {
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const T* g =
          heat_g_src<kLayout>(u, tail, hn, hs, bx, by, k, lr0 + r, lc0);
      float* s = src + r * sx;
      for (int c = threadIdx.x; c < sw; c += blockDim.x)
        s[c] = heat_widen(g[c]);
    }
  } else {
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const int64_t lr = lr0 + r;
      const int64_t gi = row_off + lr;
      const bool row_in = gi >= 0 && gi < m && lr >= -k && lr < bx + k;
      for (int c = threadIdx.x; c < sw; c += blockDim.x) {
        const int64_t lc = lc0 + c;
        const int64_t gj = col_off + lc;
        const T* p =
            row_in && gj >= 0 && gj < n && lc >= -k && lc < by + k
                ? heat_g_src<kLayout>(u, tail, hn, hs, bx, by, k, lr, lc)
                : nullptr;
        src[r * sx + c] = p != nullptr ? heat_widen(*p) : 0.f;
      }
    }
  }
  const int64_t r_left = region + rows - r0;
  const int64_t c_left = by - c0;
  const int w_r1 = k + static_cast<int>(r_left < tile_y ? r_left : tile_y);
  const int w_c1 = k + static_cast<int>(c_left < tile_x ? c_left : tile_x);
  heat_tile_steps<kHeatLoopFull, T, true>(
      smem, smem + sy * sx, sx, pad, sy, sw, row_off + lr0, col_off + lc0,
      m, n, k, k, w_r1, w_c1, a0, cx, cy, out, lr0 * by + lc0, by, res,
      [=] {
        if (staged) {  // uniform across the block
          __pipeline_wait_prior(0);
          __syncthreads();
          heat_g_widen_stage(stage, tile_x, src + k, sx, sy, tile_x / 4);
        }
        __syncthreads();
      });
}

// Checks the arguments, zeroes *res, and launches `kernel` over
// `regions` (1 or 2) row regions of `rows` rows each, starting at block
// rows r_begin0 and r_begin1, on `stream`. Returns a cudaError_t: 0, or
// the reason the launch was refused.
// `kernel` is the entry point's __global__ function, of storage type T
// (float32 or bfloat16); `uni` says whether its body loads as kernel
// E-uni does (16-byte copies from u, so the block's width a multiple of
// 4 float32 or 8 bfloat16 cells, a bfloat16 tile's too, and u 16-byte
// aligned).
template <typename T>
inline int heat_g_launch(HeatGKernelOf<T> kernel, bool uni,
                         const typename HeatSame<T>::type* u,
                         const typename HeatSame<T>::type* tail,
                         const typename HeatSame<T>::type* hn,
                         const typename HeatSame<T>::type* hs,
                         typename HeatSame<T>::type* out, uint32_t* res,
                         int64_t m, int64_t n, int64_t bx, int64_t by,
                         int64_t row_off, int64_t col_off, int k,
                         int64_t r_begin0, int64_t r_begin1, int64_t rows,
                         int regions, int tile_y, int tile_x, int block_x,
                         int block_y, float a0, float cx, float cy,
                         void* stream) {
  if (m < 3 || n < 3 || bx < 1 || by < 1 || k < 1 || k > bx || k > by ||
      row_off < 0 || col_off < 0 || row_off + bx > m || col_off + by > n ||
      rows < 1 || r_begin0 < 0 || r_begin1 + rows > bx || regions < 1 ||
      regions > 2 || !heat_loop_takes(tile_y, tile_x, block_x, block_y))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kVec = 16 / sizeof(T);  // cells of a 16-byte copy
  if (uni && (by % kVec != 0 || (kVec == 8 && tile_x % 8 != 0) ||
              reinterpret_cast<uintptr_t>(u) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_col_tiles = (by + tile_x - 1) / tile_x;
  const int64_t blocks = n_col_tiles * ((rows + tile_y - 1) / tile_y);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = heat_loop_smem_bytes(k, tile_y, tile_x);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(static_cast<unsigned>(blocks), regions),
           dim3(block_x, block_y), smem, s>>>(
      u, tail, hn, hs, out, res, m, n, bx, by, row_off, col_off, k, r_begin0,
      r_begin1, rows, n_col_tiles, tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}
