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
// E's, line for line. The kernel's body and launch live in heat_e_uni.cuh,
// where the measurement probes of E-uni (heat_probe_temporal.cu,
// heat_probe_ab_temporal.cu, heat_probe_split_copy.cu) compile them in
// variants; this kernel is the variant kHeatLoopFull with the load
// kHeatLoadWhole.

#include "heat_e_uni.cuh"

__global__ void __launch_bounds__(kHeatMaxThreads)
heat_e_uni_temporal_kernel(float* __restrict__ out, uint32_t* res,
                           int64_t m, int64_t n, int64_t n_col_tiles, int k,
                           int tile_y, int tile_x, float a0, float cx,
                           float cy,
                           const __grid_constant__ CUtensorMap umap) {
  heat_e_uni_tile<kHeatLoopFull>(out, res, m, n, n_col_tiles, k, tile_y,
                                 tile_x, a0, cx, cy, &umap);
}

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
  return heat_e_uni_launch(heat_e_uni_temporal_kernel, u, out, res, m, n, k,
                           tile_y, tile_x, block_x, block_y, a0, cx, cy,
                           stream);
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
