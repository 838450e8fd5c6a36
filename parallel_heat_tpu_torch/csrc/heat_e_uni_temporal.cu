// heat_e_uni_temporal — heat_e_temporal with a uniform, vectorised load:
// K Jacobi steps per pass through global memory, with the residual of
// the last step, bitwise the same outputs as heat_e_temporal.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_strip_uniform (pallas_call name
// "heat_e_uni_temporal_strip", defined at :832, call :987).
//
// Bound on the H100: heat_e_temporal's, about 8*(1+2K/TY)*(1+2K/TX)/K
// bytes per cell-step through HBM, and below that instruction issue in
// the shared-memory step loop, which this kernel shares with E
// (heat_temporal.cuh). What it changes is the load: E issues one 4-byte
// cp.async per cell, each behind a bounds test, about a tenth of a
// block's instructions at the default tile and K.
//
// Design: the TPU kernel splits kernel E's one clamped, re-shaping DMA
// window into fixed-shape streams — a core stream issued the same way
// for every strip and halo streams made conditional only at the edge
// strips — so that its steady state has no branch. Here:
//   - a block whose framed tile lies wholly inside the grid (nearly every
//     block of a large grid) loads it with no test at all: the core
//     columns [K, K + TX) of each row as 16-byte cp.async copies, and the
//     K-wide halo columns on each side as 4-byte copies;
//   - the core starts at a multiple of 4 floats in global memory when
//     the grid's width and TX are multiples of 4 (the entry point refuses
//     other grids, and the picker leaves them to E); in shared memory the
//     tile is shifted by (4 - K % 4) % 4 floats and its rows padded to a
//     multiple of 4, so the core lands on 16-byte boundaries there too;
//   - a block at the grid's edge takes E's load: one checked 4-byte copy
//     per cell, zero-filled outside the grid;
//   - the K steps, the write-back and the residual are E's, line for line.

#include "heat_temporal.cuh"

__global__ void __launch_bounds__(1024)
heat_e_uni_temporal_kernel(const float* __restrict__ u,
                           float* __restrict__ out, uint32_t* res, int64_t m,
                           int64_t n, int64_t n_col_tiles, int k, int tile_y,
                           int tile_x, float a0, float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  const int pad = (4 - k % 4) % 4;
  const int sx = (pad + sw + 3) / 4 * 4;
  float* src = smem + pad;
  float* dst = src + sy * sx;
  // Global coordinates of shared cell (0, 0).
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;

  if (gy0 >= 0 && gy0 + sy <= m && gx0 >= 0 && gx0 + sw <= n) {
    // The uniform load: no test per copy.
    const int vecs = tile_x / 4;
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const float* g = u + (gy0 + r) * n + gx0;
      float* s = src + r * sx;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x)
        __pipeline_memcpy_async(s + k + 4 * v, g + k + 4 * v, 16);
      for (int e = threadIdx.x; e < 2 * k; e += blockDim.x) {
        const int c = e < k ? e : tile_x + e;
        __pipeline_memcpy_async(s + c, g + c, 4);
      }
    }
  } else {
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const int64_t gi = gy0 + r;
      const bool row_in = gi >= 0 && gi < m;
      for (int c = threadIdx.x; c < sw; c += blockDim.x) {
        const int64_t gj = gx0 + c;
        const bool in = row_in && gj >= 0 && gj < n;
        __pipeline_memcpy_async(src + r * sx + c, in ? u + gi * n + gj : u,
                                4, in ? 0 : 4);
      }
    }
  }
  __pipeline_commit();

  heat_e_steps(src, dst, sx, sy, sw, gy0, gx0, m, n, k, tile_y, tile_x, a0,
               cx, cy, out, res);
}

// K steps of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device), as heat_e_temporal. The grid's width and
// tile_x must be multiples of 4 and `u` 16-byte aligned. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_e_uni_temporal(const float* u, float* out, uint32_t* res,
                                   int64_t m, int64_t n, int k, int tile_y,
                                   int tile_x, int block_x, int block_y,
                                   float a0, float cx, float cy,
                                   void* stream) {
  const int threads = block_x * block_y;
  if (m < 3 || n < 3 || k < 1 || tile_y < 1 || tile_x < 1 || block_x < 1 ||
      block_y < 1 || threads % 32 != 0 || threads > 1024 || n % 4 != 0 ||
      tile_x % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_col_tiles = (n + tile_x - 1) / tile_x;
  const int64_t blocks = n_col_tiles * ((m + tile_y - 1) / tile_y);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int pad = (4 - k % 4) % 4;
  const size_t sx = (pad + tile_x + 2 * k + 3) / 4 * 4;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(tile_y + 2 * k) * sx + 4);
  cudaError_t err = cudaFuncSetAttribute(
      heat_e_uni_temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  heat_e_uni_temporal_kernel<<<static_cast<unsigned>(blocks),
                               dim3(block_x, block_y), smem, s>>>(
      u, out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_e_uni_temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
