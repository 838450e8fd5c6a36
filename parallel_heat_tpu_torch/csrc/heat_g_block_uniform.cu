// heat_g_block_uniform — heat_g_block_fused with kernel E-uni's uniform,
// vectorised load: bitwise the same outputs.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_temporal_block_uniform (pallas_call name "heat_g_block_uniform",
// defined at :1827, call :2050), with and without defer_ns, in its
// float32 and bfloat16 storage forms (heat_g_block_uniform_bf16).
//
// Bound on the H100, and the design: heat_g.cuh. The TPU builder issues
// every strip's window the same way so that its DMA schedule has no
// branch; here a tile whose K-framed window lies inside the block (nearly
// every tile of a large block) loads its core columns from u as 16-byte
// cp.async copies and its frame columns as 4-byte ones, with no test per
// copy, as E-uni loads; tiles at the block's edge take the fused form's
// checked per-cell load of the pieces. Takes blocks whose width is a
// multiple of 4 (8 at bfloat16, whose inside tiles stage their core
// columns: heat_g.cuh heat_g_tile_bf16) and a 16-byte aligned u.

#include "heat_g.cuh"

__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_block_uniform_kernel(HEAT_G_PARAMS) {
  heat_g_tile<kHeatGFused, true>(HEAT_G_ARGS);
}

// As heat_g_block_fused; by and tile_x must be multiples of 4 and `u`
// 16-byte aligned.
extern "C" int heat_g_block_uniform(
    const float* u, const float* tail, const float* halo_n,
    const float* halo_s, float* out, uint32_t* res, int64_t m, int64_t n,
    int64_t bx, int64_t by, int64_t row_off, int64_t col_off, int k,
    int tile_y, int tile_x, int block_x, int block_y, float a0, float cx,
    float cy, void* stream) {
  if ((halo_n == nullptr) != (halo_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool defer = halo_n == nullptr;
  return heat_g_launch(
      heat_g_block_uniform_kernel, true, u, tail, halo_n, halo_s, out, res, m,
      n, bx, by, row_off, col_off, k, defer ? k : 0, 0, defer ? bx - 2 * k : bx,
      1, tile_y, tile_x, block_x, block_y, a0, cx, cy, stream);
}

// Thread blocks of this kernel that one SM holds at once at depth k, tile
// and thread block, into *blocks. Returns a cudaError_t.
extern "C" int heat_g_block_uniform_occupancy(int k, int tile_y,
                                              int tile_x, int block_x,
                                              int block_y, int* blocks) {
  return heat_loop_occupancy(heat_g_block_uniform_kernel, k, tile_y, tile_x,
                             block_x, block_y, 0, blocks);
}

// The bfloat16 form (the builder's dtype_name="bfloat16"): the pieces and
// `out` bfloat16, every level rounded, the residual float32 (heat_g.cuh
// heat_g_tile_bf16); the block's width a multiple of 8 cells.
__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_block_uniform_bf16_kernel(HEAT_G_PARAMS_OF(__nv_bfloat16)) {
  heat_g_tile_bf16<kHeatGFused, true>(HEAT_G_ARGS);
}

// heat_g_block_uniform on bfloat16 pieces. Returns a cudaError_t.
extern "C" int heat_g_block_uniform_bf16(
    const void* u, const void* tail, const void* halo_n, const void* halo_s,
    void* out, uint32_t* res, int64_t m, int64_t n, int64_t bx, int64_t by,
    int64_t row_off, int64_t col_off, int k, int tile_y, int tile_x,
    int block_x, int block_y, float a0, float cx, float cy, void* stream) {
  if ((halo_n == nullptr) != (halo_s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = __nv_bfloat16;
  const bool defer = halo_n == nullptr;
  return heat_g_launch(
      heat_g_block_uniform_bf16_kernel, true, static_cast<const T*>(u),
      static_cast<const T*>(tail), static_cast<const T*>(halo_n),
      static_cast<const T*>(halo_s), static_cast<T*>(out), res, m, n, bx, by,
      row_off, col_off, k, defer ? k : 0, 0, defer ? bx - 2 * k : bx, 1,
      tile_y, tile_x, block_x, block_y, a0, cx, cy, stream);
}

// Thread blocks of the bfloat16 form that one SM holds at once, as
// heat_g_block_uniform_occupancy.
extern "C" int heat_g_block_uniform_bf16_occupancy(int k, int tile_y,
                                                   int tile_x, int block_x,
                                                   int block_y, int* blocks) {
  return heat_loop_occupancy(heat_g_block_uniform_bf16_kernel, k, tile_y,
                             tile_x, block_x, block_y, 0, blocks);
}

extern "C" const char* heat_g_block_uniform_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
