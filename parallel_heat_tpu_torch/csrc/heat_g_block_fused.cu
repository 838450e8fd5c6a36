// heat_g_block_fused — K Jacobi steps on one block of a sharded 2D grid,
// gathered from the block and its exchanged pieces as separate operands,
// with the residual of the last step; or, without the halo rows, the
// deferred bulk of the overlapped round.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_fused (pallas_call name "heat_g_block_fused",
// defined at :1560, call :1784), with and without defer_ns, in its
// float32 and bfloat16 storage forms (heat_g_block_fused_bf16).
//
// Bound on the H100, and the design: heat_g.cuh. This form reads u, the
// tail [hi | lo] and the halo rows straight into shared memory, one
// checked 4-byte cp.async per cell as kernel E does, so the extended
// block is never written to HBM. Its shared rows are padded as the
// uniform form's are, so the step loop's 16-byte groups line up although
// the block's rows in HBM need not; the last step writes a group with
// one 16-byte store where the block's width allows it (a multiple of 4),
// else cell by cell. With halo_n = halo_s = null it writes
// only rows [K, bx-K) and their residual (heat_g_band_fix writes the
// rest), so it reads nothing of the exchange's second phase.

#include "heat_g.cuh"

__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_block_fused_kernel(HEAT_G_PARAMS) {
  heat_g_tile<kHeatGFused, false>(HEAT_G_ARGS);
}

// K steps of the bx x by block `u` at (row_off, col_off) of the m x n
// grid into `out` (bx x by, distinct from u), from tail (bx x 2K) and
// halo_n / halo_s (K x (by+2K)); both halo pointers null: the deferred
// bulk. With `res` non-null the residual of the rows written lands in
// *res. Launches on `stream` and does not synchronise. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_g_block_fused(
    const float* u, const float* tail, const float* halo_n,
    const float* halo_s, float* out, uint32_t* res, int64_t m, int64_t n,
    int64_t bx, int64_t by, int64_t row_off, int64_t col_off, int k,
    int tile_y, int tile_x, int block_x, int block_y, float a0, float cx,
    float cy, void* stream) {
  if ((halo_n == nullptr) != (halo_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool defer = halo_n == nullptr;
  return heat_g_launch(
      heat_g_block_fused_kernel, false, u, tail, halo_n, halo_s, out, res, m, n,
      bx, by, row_off, col_off, k, defer ? k : 0, 0, defer ? bx - 2 * k : bx, 1,
      tile_y, tile_x, block_x, block_y, a0, cx, cy, stream);
}

// Thread blocks of this kernel that one SM holds at once at depth k, tile
// and thread block, into *blocks. Returns a cudaError_t.
extern "C" int heat_g_block_fused_occupancy(int k, int tile_y,
                                            int tile_x, int block_x,
                                            int block_y, int* blocks) {
  return heat_loop_occupancy(heat_g_block_fused_kernel, k, tile_y, tile_x,
                             block_x, block_y, 0, blocks);
}

// The bfloat16 form (the builder's dtype_name="bfloat16"): the pieces and
// `out` bfloat16, every level rounded, the residual float32 (heat_g.cuh
// heat_g_tile_bf16).
__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_block_fused_bf16_kernel(HEAT_G_PARAMS_OF(__nv_bfloat16)) {
  heat_g_tile_bf16<kHeatGFused, false>(HEAT_G_ARGS);
}

// heat_g_block_fused on bfloat16 pieces. Returns a cudaError_t.
extern "C" int heat_g_block_fused_bf16(
    const void* u, const void* tail, const void* halo_n, const void* halo_s,
    void* out, uint32_t* res, int64_t m, int64_t n, int64_t bx, int64_t by,
    int64_t row_off, int64_t col_off, int k, int tile_y, int tile_x,
    int block_x, int block_y, float a0, float cx, float cy, void* stream) {
  if ((halo_n == nullptr) != (halo_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = __nv_bfloat16;
  const bool defer = halo_n == nullptr;
  return heat_g_launch(
      heat_g_block_fused_bf16_kernel, false, static_cast<const T*>(u),
      static_cast<const T*>(tail), static_cast<const T*>(halo_n),
      static_cast<const T*>(halo_s), static_cast<T*>(out), res, m, n, bx, by,
      row_off, col_off, k, defer ? k : 0, 0, defer ? bx - 2 * k : bx, 1,
      tile_y, tile_x, block_x, block_y, a0, cx, cy, stream);
}

// Thread blocks of the bfloat16 form that one SM holds at once, as
// heat_g_block_fused_occupancy.
extern "C" int heat_g_block_fused_bf16_occupancy(int k, int tile_y,
                                                 int tile_x, int block_x,
                                                 int block_y, int* blocks) {
  return heat_loop_occupancy(heat_g_block_fused_bf16_kernel, k, tile_y,
                             tile_x, block_x, block_y, 0, blocks);
}

extern "C" const char* heat_g_block_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
