// heat_e_uni_temporal — heat_e_temporal with a uniform load: K Jacobi
// steps per pass through global memory, with the residual of the last
// step, bitwise the same outputs as heat_e_temporal.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_strip_uniform (pallas_call name
// "heat_e_uni_temporal_strip", defined at :832, call :987).
//
// Bound on the H100: heat_e_temporal's, about 8*(1+2K/TY)*(1+2K/TX)/K
// bytes per cell-step through HBM, and below that instruction issue in
// the register-blocked step loop, which this kernel shares with E
// (heat_temporal.cuh heat_tile_steps). What it changes is the load: E
// issues one 4-byte cp.async per cell, and a tile's load, last store and
// launch are a fixed share of each launch that the K steps do not hide
// (PERF.md: 0.275 ms of 1.51 at 16384^2 and K = 8 by this load, 0.465 by
// 16-byte cp.async copies, the load this kernel had before).
//
// Design: the TPU kernel splits kernel E's one clamped, re-shaping DMA
// window into fixed-shape streams, so that its steady state has no
// branch. Here the grid's width is a multiple of 4 floats (the entry
// point refuses other grids, and the picker leaves them to E), so a
// framed tile, widened on the left by the pad that puts tile column K on
// a 16-byte boundary and on the right to a multiple of 4 floats, is a
// plain 2D box of the grid whose rows start on 16-byte boundaries:
//   - the tile is one box of a 2D tensor map of the grid (the Tensor
//     Memory Accelerator, heat_tma.cuh), TY+2K rows of
//     heat_row_floats(K, TX) floats from grid cell (row tile * TY - K,
//     column tile * TX - K - pad), issued by one thread onto an mbarrier
//     and landing as the shared buffer's rows; the block waits on the
//     mbarrier. No other thread issues a copy or computes an address;
//   - cells outside the grid arrive as zeros, which is E's rule for
//     them, so tiles at the edge and inside take the same load, with no
//     branch. The box must fit TMA's 256 cells a dimension
//     (heat_e_uni_tma_fits).
// The K steps, the write-back (16 bytes a group) and the residual are
// E's, line for line.

#include "heat_temporal.cuh"
#include "heat_tma.cuh"

__global__ void __launch_bounds__(kHeatMaxThreads)
heat_e_uni_temporal_kernel(float* __restrict__ out, uint32_t* res,
                           int64_t m, int64_t n, int64_t n_col_tiles, int k,
                           int tile_y, int tile_x, float a0, float cx,
                           float cy,
                           const __grid_constant__ CUtensorMap umap) {
  extern __shared__ __align__(128) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  // Global coordinates of shared cell (0, 0).
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;
  // The buffers from the first 128-byte boundary (the box's alignment),
  // then the mbarrier. An offset into smem, not an address rounded as an
  // integer, so that the pointers stay shared ones.
  float* buf = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * sy * sx);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    heat_mbar_init(bar);
    heat_mbar_init_fence();
    heat_mbar_expect(bar, static_cast<uint32_t>(sizeof(float) * sy * sx));
    heat_tma_load_2d(buf, &umap, bar, static_cast<int>(gx0 - pad),
                     static_cast<int>(gy0));
  }
  __syncthreads();  // the mbarrier is initialised for every thread
  heat_e_steps(buf, buf + sy * sx, sx, pad, sy, sw, gy0, gx0, m, n, k,
               tile_y, tile_x, a0, cx, cy, out, res,
               [bar] { heat_mbar_wait(bar, 0); });
}

// Does the TMA load take this launch? The box, TY+2K rows of
// heat_row_floats(K, TX) floats, within TMA's 256 cells a dimension, and
// the grid's coordinates within a box coordinate's int32
// (ops/hopper_params.py e_box_fits is the same rule for the box).
inline bool heat_e_uni_tma_fits(int64_t m, int64_t n, int k, int tile_y,
                                int tile_x) {
  return tile_y + 2 * k <= 256 && heat_row_floats(k, tile_x) <= 256 &&
         m <= 0x7fffffffLL && n <= 0x7fffffffLL;
}

// Dynamic shared memory of one block past the loop's two buffers: 128
// bytes to align them and the mbarrier (ops/hopper_params.py
// e_smem_bytes).
constexpr size_t kHeatEUniExtraSmem = 128 + sizeof(uint64_t);

// K steps of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device), as heat_e_temporal, each tile one TMA box.
// The grid's width must be a multiple of 4, `u` 16-byte aligned and the
// box within heat_e_uni_tma_fits. Returns a cudaError_t: 0, or the reason
// the launch was refused; or a tensor-map encoding error
// (heat_e_uni_temporal_error_string).
extern "C" int heat_e_uni_temporal(const float* u, float* out, uint32_t* res,
                                   int64_t m, int64_t n, int k, int tile_y,
                                   int tile_x, int block_x, int block_y,
                                   float a0, float cx, float cy,
                                   void* stream) {
  int64_t n_col_tiles = 0, blocks = 0;
  const int bad = heat_e_geometry(m, n, k, tile_y, tile_x, block_x, block_y,
                                  &n_col_tiles, &blocks);
  if (bad != 0) return bad;
  if (n % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      !heat_e_uni_tma_fits(m, n, k, tile_y, tile_x))
    return static_cast<int>(cudaErrorInvalidValue);
  // The tensor map of the grid (innermost dimension first), boxes of the
  // framed, padded tile.
  CUtensorMap map = {};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
  const cuuint32_t box[2] = {
      static_cast<cuuint32_t>(heat_row_floats(k, tile_x)),
      static_cast<cuuint32_t>(tile_y + 2 * k)};
  const int enc = heat_tma_encode(&map, u, 2, dims, strides, box);
  if (enc != 0) return enc;
  const size_t smem =
      heat_loop_smem_bytes(k, tile_y, tile_x) + kHeatEUniExtraSmem;
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
      out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy, map);
  return static_cast<int>(cudaGetLastError());
}

// Thread blocks of this kernel that one SM holds at once at depth k, tile
// and thread block, into *blocks. Returns a cudaError_t.
extern "C" int heat_e_uni_temporal_occupancy(int k, int tile_y, int tile_x,
                                             int block_x, int block_y,
                                             int* blocks) {
  return heat_loop_occupancy(heat_e_uni_temporal_kernel, k, tile_y, tile_x,
                             block_x, block_y, kHeatEUniExtraSmem, blocks);
}

extern "C" const char* heat_e_uni_temporal_error_string(int code) {
  return heat_tma_error_string(code);
}
