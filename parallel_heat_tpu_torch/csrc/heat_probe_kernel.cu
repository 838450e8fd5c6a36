// heat_probe_kernel — the anatomy probe of kernel A: A's own launch,
// compiled in variants that each cut one cost out of it, so that the
// slope of a launch's time over K splits a step into the barrier, the
// exchange, the combine and the edge blocks' tests, and the intercept
// is the launch's fixed share.
//
// Replaces: tools/kernel_probe.py::build (pallas_call name
// "heat_probe_kernel", defined at :27, call :74), the TPU probe that
// cut one cost at a time (roll, mask, coefficient form) out of A's VMEM
// loop. Those costs have no counterpart here; the costs of A's launch on
// the H100 are the ones below.
//
// Bound on the H100: A's (heat_a_resident.cu): at 1000^2 a launch moves
// 8 MB through HBM, 2.4 us, whatever K. The variants are measurements,
// not functions: only the full variant computes A's grid.
//
// Design: heat_a.cuh compiles A's kernel once per variant
// (kHeatAFull .. kHeatANoEdge) and launches it exactly as
// heat_a_resident does, cooperative launch, tile, depth and thread block
// included, so a variant's time differs from A's only by the cost it
// cuts.

#include "heat_a.cuh"

// Variant `variant` (0 full, 1 no_barrier, 2 no_exchange, 3 copy_step,
// 4 no_edge) of kernel A's launch, with heat_a_resident's arguments after
// it. Returns a cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_probe_kernel(int variant, const float* u, float* out,
                                 float* xch, uint32_t* res, int64_t m,
                                 int64_t n, int k, int depth, int tile_y,
                                 int tile_x, int block_x, int block_y,
                                 float a0, float cx, float cy, void* stream) {
  switch (variant) {
    case kHeatAFull:
      return heat_a_launch<kHeatAFull>(u, out, xch, res, m, n, k, depth,
                                       tile_y, tile_x, block_x, block_y, a0,
                                       cx, cy, stream);
    case kHeatANoBarrier:
      return heat_a_launch<kHeatANoBarrier>(u, out, xch, res, m, n, k, depth,
                                            tile_y, tile_x, block_x, block_y,
                                            a0, cx, cy, stream);
    case kHeatANoExchange:
      return heat_a_launch<kHeatANoExchange>(u, out, xch, res, m, n, k,
                                             depth, tile_y, tile_x, block_x,
                                             block_y, a0, cx, cy, stream);
    case kHeatACopyStep:
      return heat_a_launch<kHeatACopyStep>(u, out, xch, res, m, n, k, depth,
                                           tile_y, tile_x, block_x, block_y,
                                           a0, cx, cy, stream);
    case kHeatANoEdge:
      return heat_a_launch<kHeatANoEdge>(u, out, xch, res, m, n, k, depth,
                                         tile_y, tile_x, block_x, block_y,
                                         a0, cx, cy, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* heat_probe_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
