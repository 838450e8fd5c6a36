// heat_b_step — one Jacobi step over the whole grid, with the interior
// max-norm residual fused into the same pass.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_strip_kernel
// (pallas_call name "heat_b_strip", defined at :294, call :407), in its
// single-device form. It is also the direct counterpart of the
// reference CUDA `heat` kernel, with the convergence reduction fused.
//
// Bound on the H100: memory. A step reads the grid once and writes it
// once, 8 B per cell, against 7 float32 operations per cell: at
// 3.35 TB/s a 16384^2 step needs at least 0.64 ms of HBM traffic and
// 0.03 ms of arithmetic.
//
// Design: the TPU kernel streams row strips through VMEM with SUB-row
// halos and carries the residual from strip to strip in SMEM, because
// its grid runs in order on one core. Here blocks run in parallel and
// in no order, so
//   - each thread walks `rows_per_thread` consecutive rows of one
//     column, keeping the rows above and below in registers: a warp
//     reads each row of its 32 columns as whole 128-byte lines, and the
//     left/right neighbours come from the same lines through L1, so HBM
//     sees each cell read about once;
//   - each block reduces its own partial residual (warp shuffle, then
//     shared memory) and merges it with one atomicMax into a 4-byte
//     scalar that the entry point zeroes (heat_common.cuh);
//   - boundary cells are copied from the input: the Dirichlet ring never
//     changes, whatever the interior does.
// Offsets are computed in int64, so grids past 2^31 bytes index safely.
//
// Storage precision: heat_b_step_bf16 steps a bfloat16 grid, 4 B a cell
// over HBM, in float32 arithmetic (heat_common.cuh): a warp reads 64-byte
// rows, one column a lane, as the float32 kernel does.

#include <type_traits>

#include "heat_common.cuh"

// A block's cells of the step, at storage type T (float32, or bfloat16:
// each load widened exactly, each updated cell rounded, each copied one
// narrowed exactly, heat_common.cuh), and its residual into *res.
template <typename T>
__device__ __forceinline__ void heat_b_cells(
    const T* __restrict__ u, T* __restrict__ out, uint32_t* res, int64_t m,
    int64_t n, int64_t n_col_tiles, int rows_per_thread, float a0, float cx,
    float cy) {
  const int64_t tile_r = blockIdx.x / n_col_tiles;
  const int64_t tile_c = blockIdx.x % n_col_tiles;
  const int64_t j = tile_c * blockDim.x + threadIdx.x;
  const int64_t i0 = (tile_r * blockDim.y + threadIdx.y) * rows_per_thread;
  uint32_t rmax = 0u;
  if (j < n && i0 < m) {
    const int64_t i_end = i0 + rows_per_thread < m ? i0 + rows_per_thread : m;
    float up = i0 >= 1 ? heat_widen(u[(i0 - 1) * n + j]) : 0.f;
    float c = heat_widen(u[i0 * n + j]);
    for (int64_t i = i0; i < i_end; ++i) {
      const int64_t idx = i * n + j;
      const float down = i + 1 < m ? heat_widen(u[idx + n]) : 0.f;
      float v = c;
      const bool in = heat_is_interior(i, j, m, n);
      if (in) {
        v = heat_combine(c, up, down, heat_widen(u[idx - 1]),
                         heat_widen(u[idx + 1]), a0, cx, cy);
        rmax = max(rmax, heat_diff_bits(v, c));
      }
      heat_store(out + idx, v, in);
      up = c;
      c = down;
    }
  }
  heat_block_max(rmax, res);
}

__global__ void __launch_bounds__(1024)
heat_b_step_kernel(const float* __restrict__ u, float* __restrict__ out,
                   uint32_t* res, int64_t m, int64_t n, int64_t n_col_tiles,
                   int rows_per_thread, float a0, float cx, float cy) {
  heat_b_cells(u, out, res, m, n, n_col_tiles, rows_per_thread, a0, cx, cy);
}

// Kernel B on a bfloat16 grid: a kernel of its own, so that the float32
// kernel keeps its name and machine code.
__global__ void __launch_bounds__(1024)
heat_b_step_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                        __nv_bfloat16* __restrict__ out, uint32_t* res,
                        int64_t m, int64_t n, int64_t n_col_tiles,
                        int rows_per_thread, float a0, float cx, float cy) {
  heat_b_cells(u, out, res, m, n, n_col_tiles, rows_per_thread, a0, cx, cy);
}

template <typename T>
static int heat_b_launch(const T* u, T* out, uint32_t* res, int64_t m,
                         int64_t n, int block_x, int block_y,
                         int rows_per_thread, float a0, float cx, float cy,
                         void* stream) {
  const int threads = block_x * block_y;
  if (m < 3 || n < 3 || block_x < 1 || block_y < 1 || rows_per_thread < 1 ||
      threads % 32 != 0 || threads > 1024 || res == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile_rows = static_cast<int64_t>(block_y) * rows_per_thread;
  const int64_t n_col_tiles = (n + block_x - 1) / block_x;
  const int64_t blocks = n_col_tiles * ((m + tile_rows - 1) / tile_rows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks)), block(block_x, block_y);
  if constexpr (std::is_same<T, float>::value)
    heat_b_step_kernel<<<grid, block, 0, s>>>(u, out, res, m, n, n_col_tiles,
                                              rows_per_thread, a0, cx, cy);
  else
    heat_b_step_bf16_kernel<<<grid, block, 0, s>>>(
        u, out, res, m, n, n_col_tiles, rows_per_thread, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

// One step of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device), with the residual's bit pattern in *res.
// Launches on `stream` and does not synchronise. Returns a cudaError_t:
// 0, or the reason the launch was refused.
extern "C" int heat_b_step(const float* u, float* out, uint32_t* res,
                           int64_t m, int64_t n, int block_x, int block_y,
                           int rows_per_thread, float a0, float cx, float cy,
                           void* stream) {
  return heat_b_launch(u, out, res, m, n, block_x, block_y, rows_per_thread,
                       a0, cx, cy, stream);
}

// heat_b_step on a bfloat16 grid `u` into the bfloat16 `out`: the step
// computes in float32, rounds its updated cells to bfloat16 and copies
// the ring bit for bit; the residual is the float32 update against the
// float32 of the cell it read, before rounding. The counterpart of
// _build_strip_kernel at dtype bfloat16.
extern "C" int heat_b_step_bf16(const __nv_bfloat16* u, __nv_bfloat16* out,
                                uint32_t* res, int64_t m, int64_t n,
                                int block_x, int block_y,
                                int rows_per_thread, float a0, float cx,
                                float cy, void* stream) {
  return heat_b_launch(u, out, res, m, n, block_x, block_y, rows_per_thread,
                       a0, cx, cy, stream);
}

extern "C" const char* heat_b_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
