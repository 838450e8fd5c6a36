// heat_c_tiled — one Jacobi step over 2D tiles staged in shared memory,
// with the interior max-norm residual fused into the same pass.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_tiled_kernel
// (pallas_call name "heat_c_tiled", defined at :3059, call :3174), in its
// single-device form.
//
// Bound on the H100: memory, as heat_b_step's. A step reads the grid and
// writes it, 8 B per cell, plus the tiles' one-cell halos, which are
// read twice: (1 + 2/TY)(1 + 2/TX) reads per cell, 6% more than B's at
// the default 32 x 128 tile. At 3.35 TB/s a 16384^2 step needs at least
// 0.64 ms.
//
// Design: the TPU kernel fetches (T, CW) tiles with SUB-row and
// LANE-column halos into VMEM, where kernel B fetches full-width row
// strips. Here kernel B reads the grid straight from global memory, each
// thread walking a column, and finds the left and right neighbours in
// L1; this kernel instead
//   - copies each block's TY x TX tile and its one-cell ring into shared
//     memory with asynchronous copies (cp.async), zero-filled outside the
//     grid, so every global read is issued at once and each cell is read
//     from global memory once per block;
//   - computes every cell of the tile from shared memory, a warp taking
//     32 neighbouring columns of one row (free of bank conflicts), and
//     writes it straight to the output grid;
//   - copies global boundary cells instead of updating them, and reduces
//     the residual as heat_b_step does (heat_common.cuh), so its grid and
//     residual are bitwise heat_b_step's.
// Offsets are computed in int64.
//
// Storage precision: heat_c_tiled_bf16 takes a bfloat16 grid, 4 B a cell
// over HBM; its tile is widened as it lands, so the shared tile's shape
// and the step are the float32 kernel's.

#include <cuda_pipeline.h>

#include <type_traits>

#include "heat_common.cuh"

// A block's tile of the step at storage type T, and its residual into
// *res. A float32 tile lands by 4-byte cp.async copies; a bfloat16 one by
// plain 2-byte loads, widened exactly into the same float32 shared tile
// (heat_common.cuh), then the block's barrier. The step and the residual
// are float32; a bfloat16 grid's updated cells round as they are stored,
// its copied ones narrow exactly.
template <typename T>
__device__ __forceinline__ void heat_c_cells(
    const T* __restrict__ u, T* __restrict__ out, uint32_t* res, int64_t m,
    int64_t n, int64_t n_col_tiles, int tile_y, int tile_x, float a0,
    float cx, float cy) {
  extern __shared__ float smem[];
  const int sy = tile_y + 2;
  const int sx = tile_x + 2;
  // Global coordinates of shared cell (0, 0); the tile starts at (1, 1).
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - 1;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - 1;
  for (int r = threadIdx.y; r < sy; r += blockDim.y) {
    const int64_t gi = gy0 + r;
    const bool row_in = gi >= 0 && gi < m;
    for (int c = threadIdx.x; c < sx; c += blockDim.x) {
      const int64_t gj = gx0 + c;
      const bool in = row_in && gj >= 0 && gj < n;
      if constexpr (std::is_same<T, float>::value)
        __pipeline_memcpy_async(smem + r * sx + c, in ? u + gi * n + gj : u,
                                4, in ? 0 : 4);
      else
        smem[r * sx + c] = in ? heat_widen(u[gi * n + gj]) : 0.f;
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  uint32_t rmax = 0u;
  for (int r = 1 + threadIdx.y; r <= tile_y; r += blockDim.y) {
    const int64_t gi = gy0 + r;
    if (gi >= m) break;
    for (int c = 1 + threadIdx.x; c <= tile_x; c += blockDim.x) {
      const int64_t gj = gx0 + c;
      if (gj >= n) break;
      const float* p = smem + r * sx + c;
      const float cc = *p;
      float v = cc;
      const bool in = heat_is_interior(gi, gj, m, n);
      if (in) {
        v = heat_combine(cc, p[-sx], p[sx], p[-1], p[1], a0, cx, cy);
        rmax = max(rmax, heat_diff_bits(v, cc));
      }
      heat_store(out + gi * n + gj, v, in);
    }
  }
  heat_block_max(rmax, res);
}

__global__ void __launch_bounds__(1024)
heat_c_tiled_kernel(const float* __restrict__ u, float* __restrict__ out,
                    uint32_t* res, int64_t m, int64_t n, int64_t n_col_tiles,
                    int tile_y, int tile_x, float a0, float cx, float cy) {
  heat_c_cells(u, out, res, m, n, n_col_tiles, tile_y, tile_x, a0, cx, cy);
}

// Kernel C on a bfloat16 grid: a kernel of its own, so that the float32
// kernel keeps its name and machine code.
__global__ void __launch_bounds__(1024)
heat_c_tiled_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                         __nv_bfloat16* __restrict__ out, uint32_t* res,
                         int64_t m, int64_t n, int64_t n_col_tiles,
                         int tile_y, int tile_x, float a0, float cx,
                         float cy) {
  heat_c_cells(u, out, res, m, n, n_col_tiles, tile_y, tile_x, a0, cx, cy);
}

template <typename T>
static int heat_c_launch(const T* u, T* out, uint32_t* res, int64_t m,
                         int64_t n, int tile_y, int tile_x, int block_x,
                         int block_y, float a0, float cx, float cy,
                         void* stream) {
  const int threads = block_x * block_y;
  if (m < 3 || n < 3 || tile_y < 1 || tile_x < 1 || block_x < 1 ||
      block_y < 1 || threads % 32 != 0 || threads > 1024 || res == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_col_tiles = (n + tile_x - 1) / tile_x;
  const int64_t blocks = n_col_tiles * ((m + tile_y - 1) / tile_y);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(tile_y + 2) *
                      static_cast<size_t>(tile_x + 2);
  const void* kernel =
      std::is_same<T, float>::value
          ? reinterpret_cast<const void*>(heat_c_tiled_kernel)
          : reinterpret_cast<const void*>(heat_c_tiled_bf16_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks)), block(block_x, block_y);
  if constexpr (std::is_same<T, float>::value)
    heat_c_tiled_kernel<<<grid, block, smem, s>>>(
        u, out, res, m, n, n_col_tiles, tile_y, tile_x, a0, cx, cy);
  else
    heat_c_tiled_bf16_kernel<<<grid, block, smem, s>>>(
        u, out, res, m, n, n_col_tiles, tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

// One step of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device), one block per tile_y x tile_x tile, with
// the residual's bit pattern in *res. Launches on `stream` and does not
// synchronise. Returns a cudaError_t: 0, or the reason the launch was
// refused.
extern "C" int heat_c_tiled(const float* u, float* out, uint32_t* res,
                            int64_t m, int64_t n, int tile_y, int tile_x,
                            int block_x, int block_y, float a0, float cx,
                            float cy, void* stream) {
  return heat_c_launch(u, out, res, m, n, tile_y, tile_x, block_x, block_y,
                       a0, cx, cy, stream);
}

// heat_c_tiled on a bfloat16 grid `u` into the bfloat16 `out`, bitwise
// heat_b_step_bf16: the tile widened into the same float32 shared tile,
// the same rounding of updated cells and exact copy of the ring. The
// counterpart of _build_tiled_kernel at dtype bfloat16.
extern "C" int heat_c_tiled_bf16(const __nv_bfloat16* u, __nv_bfloat16* out,
                                 uint32_t* res, int64_t m, int64_t n,
                                 int tile_y, int tile_x, int block_x,
                                 int block_y, float a0, float cx, float cy,
                                 void* stream) {
  return heat_c_launch(u, out, res, m, n, tile_y, tile_x, block_x, block_y,
                       a0, cx, cy, stream);
}

extern "C" const char* heat_c_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
