// heat_e_temporal — K Jacobi steps per pass through global memory
// (temporal blocking), with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_temporal_strip
// (pallas_call name "heat_e_temporal_strip", defined at :607, call :774) in
// its float32 storage form (heat_e_temporal) and its bfloat16 forms
// (heat_e_temporal_bf16, heat_temporal.cuh's kHeatForm*): bfloat16
// storage, each level rounded, and the acc_f32 form of
// accumulate="f32chunk", the levels carried in float32 and rounded once,
// in one launch or split in two across a float32 grid. With and without
// the residual.
//
// Bound on the H100: a pass reads the grid once and writes it once for
// K steps, plus the halo: about 8*(1+2K/TY)*(1+2K/TX)/K bytes per
// cell-step through HBM (1.33 B at the default 96 x 112 tile and K = 8,
// against heat_b_step's 8 B). Below that lies instruction issue: 7
// float32 operations per cell-step, which the bitwise contract keeps
// from fusing into FMAs, the step loop's shared-memory traffic, plus the
// redundant halo steps (about 14% more cells at the default tile and K)
// and each tile's load and last store. Issue, not HBM, sets the kernel's
// time (PERF.md).
//
// Design: the TPU kernel streams full-width row strips with K-deep row
// halos through VMEM. Hopper's shared memory is 227 KB per block, and one
// 16384-wide float32 row is already 64 KB, so this kernel cuts 2D tiles
// instead:
//   - each block loads a TY x TX output tile plus a K-deep halo on all
//     four sides into shared memory with asynchronous copies (cp.async),
//     so all of a thread's loads are in flight at once
//     (heat_e_load_cells): a tile whose frame lies inside the grid,
//     nearly every tile of a large grid, copies each cell with no test; a
//     tile at the grid's edge zero-fills the cells outside it. They never
//     reach the interior: the Dirichlet ring lies between, and it never
//     updates. The copies are 4 bytes wide, since
//     a row of a grid whose width is no multiple of 4 starts at any
//     float; for the same reason this kernel cannot take a TMA box (a
//     tensor map's row stride must be a multiple of 16 bytes), which
//     heat_e_uni_temporal.cu does for the other widths;
//   - the shared rows are padded so that tile column K lies on a 16-byte
//     boundary (heat_row_pad, heat_row_floats);
//   - it runs K steps with the register-blocked tile loop that it shares
//     with heat_e_uni_temporal.cu and the sharded kernels G
//     (heat_temporal.cuh heat_tile_steps: a warp a run of rows, a lane 4
//     adjacent columns in float4 registers, neighbours by shuffle),
//     ping-ponging between two shared buffers; step s updates the region
//     s cells in from the loaded edge, so the valid region shrinks by one
//     cell per side and step, and after K steps exactly the central tile
//     is valid. heat_temporal.cuh says why the cells the loop computes
//     outside that cone change no output bit;
//   - where the grid's interior lies in the tile is worked out once per
//     block; a block whose tile lies inside the interior runs a step loop
//     with no test at all, and only the blocks at the grid's edge select
//     between update and copy;
//   - global boundary cells (and cells outside the grid) are copied,
//     never recomputed, so they keep their value at every step; the
//     intermediate steps round to float32 like a launch of heat_b_step
//     does, which makes E(K) bitwise K steps of B;
//   - the last step writes only the central tile, straight to global
//     memory (16 bytes a group where the grid's width allows it, else
//     cell by cell), and reduces its residual as heat_b_step does.
//   - a bfloat16 grid is widened to float32 as its tile lands (a 2-byte
//     load a cell, no cp.async: the copies are no narrower than 4 bytes),
//     so the loop and its shared-memory layout are float32's; the last
//     store narrows (heat_temporal.cuh, storage precision). Such a launch
//     moves half the bytes of a float32 one; the step loop is the same.
// The tile shape, thread block and K come from ops/hopper_params.py: two
// ping-pong buffers of TY+2K padded rows, sized so that two blocks stay
// resident per SM. Global offsets are computed in int64.

#include "heat_temporal.cuh"

// The load of the framed tile (sy rows of sw cells from global
// cell (gy0, gx0) of the m x n grid u) into src, at a row stride of sx
// floats: one 4-byte cp.async a cell. A tile whose frame lies inside the
// grid, nearly every tile of a large grid, copies with no test; a tile at
// the grid's edge zero-fills the cells outside it (they never reach the
// interior: the Dirichlet ring lies between, and it never updates).
// Issues the copies; the caller commits them.
__device__ __forceinline__ void heat_e_load_cells(float* src, int sx, int sy,
                                                  int sw, const float* u,
                                                  int64_t m, int64_t n,
                                                  int64_t gy0, int64_t gx0) {
  if (gy0 >= 0 && gy0 + sy <= m && gx0 >= 0 && gx0 + sw <= n) {
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const float* g = u + (gy0 + r) * n + gx0;
      float* s = src + r * sx;
      for (int c = threadIdx.x; c < sw; c += blockDim.x)
        __pipeline_memcpy_async(s + c, g + c, 4);
    }
    return;
  }
  for (int r = threadIdx.y; r < sy; r += blockDim.y) {
    const int64_t gi = gy0 + r;
    const bool row_in = gi >= 0 && gi < m;
    for (int c = threadIdx.x; c < sw; c += blockDim.x) {
      const int64_t gj = gx0 + c;
      const bool in = row_in && gj >= 0 && gj < n;
      __pipeline_memcpy_async(src + r * sx + c, in ? u + gi * n + gj : u, 4,
                              in ? 0 : 4);
    }
  }
}

__global__ void __launch_bounds__(kHeatMaxThreads)
heat_e_temporal_kernel(const float* __restrict__ u, float* __restrict__ out,
                       uint32_t* res, int64_t m, int64_t n,
                       int64_t n_col_tiles, int k, int tile_y, int tile_x,
                       float a0, float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  // Global coordinates of shared cell (0, 0).
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;
  heat_e_load_cells(smem + pad, sx, sy, sw, u, m, n, gy0, gx0);
  __pipeline_commit();
  heat_e_steps(smem, smem + sy * sx, sx, pad, sy, sw, gy0, gx0, m, n, k,
               tile_y, tile_x, a0, cx, cy, out, res, HeatCpAsyncWait());
}

// K steps of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device), in tiles of tile_y x tile_x output cells
// under thread blocks of block_x x block_y threads (heat_loop_takes).
// With `res` non-null, the last step's residual bit pattern lands in
// *res; with null, no residual is reduced. Launches on `stream` and does
// not synchronise. Returns a cudaError_t: 0, or the reason the launch
// was refused.
extern "C" int heat_e_temporal(const float* u, float* out, uint32_t* res,
                               int64_t m, int64_t n, int k, int tile_y,
                               int tile_x, int block_x, int block_y,
                               float a0, float cx, float cy, void* stream) {
  int64_t n_col_tiles = 0, blocks = 0;
  const int bad = heat_e_geometry(m, n, k, tile_y, tile_x, block_x, block_y,
                                  &n_col_tiles, &blocks);
  if (bad != 0) return bad;
  const size_t smem = heat_loop_smem_bytes(k, tile_y, tile_x);
  cudaError_t err = cudaFuncSetAttribute(
      heat_e_temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  heat_e_temporal_kernel<<<static_cast<unsigned>(blocks),
                           dim3(block_x, block_y), smem, s>>>(
      u, out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

// Thread blocks of this kernel that one SM holds at once at depth k, tile
// and thread block, into *blocks. Returns a cudaError_t.
extern "C" int heat_e_temporal_occupancy(int k, int tile_y, int tile_x,
                                         int block_x, int block_y,
                                         int* blocks) {
  return heat_loop_occupancy(heat_e_temporal_kernel, k, tile_y, tile_x,
                             block_x, block_y, 0, blocks);
}

// A bfloat16 tile's load (sy rows of sw cells from global cell (gy0, gx0)
// of the m x n grid u) into src at a row stride of sx floats, widened to
// float32 as it lands, zeros outside the grid (heat_e_load_cells' rule);
// the block's barrier (HeatSyncWait) ends it.
__device__ __forceinline__ void heat_e_load_widen(
    float* src, int sx, int sy, int sw, const __nv_bfloat16* u, int64_t m,
    int64_t n, int64_t gy0, int64_t gx0) {
  if (gy0 >= 0 && gy0 + sy <= m && gx0 >= 0 && gx0 + sw <= n) {
    // A frame inside the grid, nearly every tile: no test a cell.
    for (int r = threadIdx.y; r < sy; r += blockDim.y) {
      const __nv_bfloat16* g = u + (gy0 + r) * n + gx0;
      float* s = src + r * sx;
      for (int c = threadIdx.x; c < sw; c += blockDim.x)
        s[c] = heat_widen(g[c]);
    }
    return;
  }
  for (int r = threadIdx.y; r < sy; r += blockDim.y) {
    const int64_t gi = gy0 + r;
    const bool row_in = gi >= 0 && gi < m;
    for (int c = threadIdx.x; c < sw; c += blockDim.x) {
      const int64_t gj = gx0 + c;
      src[r * sx + c] =
          row_in && gj >= 0 && gj < n ? heat_widen(u[gi * n + gj]) : 0.f;
    }
  }
}

// Kernel E under precision form kForm (heat_temporal.cuh kHeatForm*):
// the grid's storage type in and out, the rounding of the levels. A
// float32 input (kHeatFormCarryIn, a carried level) takes E's cp.async
// load; a bfloat16 one is widened as it lands.
template <int kForm>
__global__ void __launch_bounds__(kHeatMaxThreads)
heat_e_temporal_bf16_kernel(const typename HeatForm<kForm>::In* __restrict__ u,
                            typename HeatForm<kForm>::Out* __restrict__ out,
                            uint32_t* res, int64_t m, int64_t n,
                            int64_t n_col_tiles, int k, int tile_y,
                            int tile_x, float a0, float cx, float cy) {
  using F = HeatForm<kForm>;
  extern __shared__ __align__(16) float smem[];
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;
  if constexpr (std::is_same<typename F::In, float>::value) {
    heat_e_load_cells(smem + pad, sx, sy, sw, u, m, n, gy0, gx0);
    __pipeline_commit();
    heat_e_steps<kHeatLoopFull, typename F::Out, F::kRound>(
        smem, smem + sy * sx, sx, pad, sy, sw, gy0, gx0, m, n, k, tile_y,
        tile_x, a0, cx, cy, out, res, HeatCpAsyncWait());
  } else {
    heat_e_load_widen(smem + pad, sx, sy, sw, u, m, n, gy0, gx0);
    heat_e_steps<kHeatLoopFull, typename F::Out, F::kRound>(
        smem, smem + sy * sx, sx, pad, sy, sw, gy0, gx0, m, n, k, tile_y,
        tile_x, a0, cx, cy, out, res, HeatSyncWait());
  }
}

template <int kForm>
inline int heat_e_bf16_launch(const void* u, void* out, uint32_t* res,
                              int64_t m, int64_t n, int k, int tile_y,
                              int tile_x, int block_x, int block_y, float a0,
                              float cx, float cy, void* stream) {
  using F = HeatForm<kForm>;
  int64_t n_col_tiles = 0, blocks = 0;
  const int bad = heat_e_geometry(m, n, k, tile_y, tile_x, block_x, block_y,
                                  &n_col_tiles, &blocks);
  if (bad != 0) return bad;
  const size_t smem = heat_loop_smem_bytes(k, tile_y, tile_x);
  cudaError_t err = cudaFuncSetAttribute(
      heat_e_temporal_bf16_kernel<kForm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  heat_e_temporal_bf16_kernel<kForm>
      <<<static_cast<unsigned>(blocks), dim3(block_x, block_y), smem, s>>>(
          static_cast<const typename F::In*>(u),
          static_cast<typename F::Out*>(out), res, m, n, n_col_tiles, k,
          tile_y, tile_x, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

// K steps of the m x n grid `u` into `out` under precision form `form`
// (heat_temporal.cuh: 0 bfloat16 storage, 1 the float32 carry of a whole
// chunk, 2 its first launch into a float32 grid, 3 its last launch from
// one), otherwise as heat_e_temporal. Returns a cudaError_t.
extern "C" int heat_e_temporal_bf16(const void* u, void* out, uint32_t* res,
                                    int64_t m, int64_t n, int k, int tile_y,
                                    int tile_x, int block_x, int block_y,
                                    int form, float a0, float cx, float cy,
                                    void* stream) {
  switch (form) {
    case kHeatFormBf16:
      return heat_e_bf16_launch<kHeatFormBf16>(u, out, res, m, n, k, tile_y,
                                               tile_x, block_x, block_y, a0,
                                               cx, cy, stream);
    case kHeatFormCarry:
      return heat_e_bf16_launch<kHeatFormCarry>(u, out, res, m, n, k, tile_y,
                                                tile_x, block_x, block_y, a0,
                                                cx, cy, stream);
    case kHeatFormCarryOut:
      return heat_e_bf16_launch<kHeatFormCarryOut>(
          u, out, res, m, n, k, tile_y, tile_x, block_x, block_y, a0, cx, cy,
          stream);
    case kHeatFormCarryIn:
      return heat_e_bf16_launch<kHeatFormCarryIn>(
          u, out, res, m, n, k, tile_y, tile_x, block_x, block_y, a0, cx, cy,
          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* heat_e_temporal_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
