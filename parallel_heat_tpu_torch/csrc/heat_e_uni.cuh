// Kernel E-uni's tile and launch (heat_e_uni_temporal.cu has the design):
// the body of one block, templated on the tile loop's variant
// (heat_temporal.cuh kHeatLoopFull .. kHeatLoopRowCopy), and the host
// launch of any kernel built on it. heat_e_uni_temporal.cu compiles the
// shipped variant; the measurement probes compile the others
// (heat_probe_temporal.cu, E-uni's anatomy; heat_probe_ab_temporal.cu,
// its boundary forms) and launch each exactly as E-uni is launched.

#pragma once

#include "heat_temporal.cuh"
#include "heat_tma.cuh"

// One block of E-uni (variant kVar): tile blockIdx.x of the grid behind
// the tensor map `umap`, K steps, the tile's cells into `out` and their
// residual into *res. kHeatLoopNoLoad issues no box and waits for none
// (the block steps its buffer as it lies), but initialises the mbarrier
// as the load does.
template <int kVar>
__device__ __forceinline__ void heat_e_uni_tile(
    float* __restrict__ out, uint32_t* res, int64_t m, int64_t n,
    int64_t n_col_tiles, int k, int tile_y, int tile_x, float a0, float cx,
    float cy, const CUtensorMap* umap) {
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
    if (kVar != kHeatLoopNoLoad) {
      heat_mbar_expect(bar, static_cast<uint32_t>(sizeof(float) * sy * sx));
      heat_tma_load_2d(buf, umap, bar, static_cast<int>(gx0 - pad),
                       static_cast<int>(gy0));
    }
  }
  __syncthreads();  // the mbarrier is initialised for every thread
  heat_e_steps<kVar>(buf, buf + sy * sx, sx, pad, sy, sw, gy0, gx0, m, n, k,
                     tile_y, tile_x, a0, cx, cy, out, res, [bar] {
                       if (kVar != kHeatLoopNoLoad) heat_mbar_wait(bar, 0);
                     });
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

// E-uni's launch of `kernel` (heat_e_uni_temporal_kernel, or a probe's
// variant of it, with its parameters): the checks, the tensor map of the
// grid `u`, the shared memory, the residual's reset and the launch on
// `stream`. Returns a cudaError_t: 0, or the reason the launch was
// refused; or a tensor-map encoding error (heat_tma_error_string).
template <typename Kernel>
inline int heat_e_uni_launch(Kernel kernel, const float* u, float* out,
                             uint32_t* res, int64_t m, int64_t n, int k,
                             int tile_y, int tile_x, int block_x,
                             int block_y, float a0, float cx, float cy,
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
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(block_x, block_y), smem, s>>>(
      out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy, map);
  return static_cast<int>(cudaGetLastError());
}
