// heat_probe_temporal — the anatomy probe of kernel E-uni: E-uni's own
// launch, compiled in variants that each cut one cost out of it, so that
// what a cost takes of a launch is the variant's time less the full
// one's, at the same grid and K.
//
// Replaces: tools/probe_temporal.py::build (pallas_call name
// "heat_probe_temporal", defined at :39, call :146), the TPU probe that
// took kernel E's strip pipeline apart (coefficient form, residual, row
// mask, unrolled steps). Its unrolled variant and its strip sweep have no
// counterpart: nvcc unrolls the row walk, and E-uni's tile sweep is
// bench_kernels.py --only e.
//
// Bound on the H100: E-uni's (heat_e_uni_temporal.cu): at 16384^2 a
// launch moves 2 GiB through HBM, 0.641 ms, whatever K. The variants are
// measurements, not functions: only the full variant computes E-uni's
// grid and residual.
//
// Design: heat_e_uni.cuh compiles E-uni's block once per variant of the
// tile loop (heat_temporal.cuh) and launches it exactly as
// heat_e_uni_temporal does, tensor map, tile, K and thread block
// included:
//   - kHeatLoopFull (0): E-uni as shipped;
//   - kHeatLoopNoResidual (1): the last step folds no residual and the
//     block reduces none;
//   - kHeatLoopNoEdge (2): every tile stepped as an interior tile, with
//     no test a cell;
//   - kHeatLoopCopyStep (3): a copy in the combine's place, the walk's
//     loads, shuffles and stores kept;
//   - kHeatLoopNoLoad (4): no TMA box issued and no mbarrier wait; the
//     block steps its shared memory as it lies (the mbarrier is still
//     initialised);
//   - kHeatLoopNoStore (5): the last step stores nothing to the grid,
//     its residual kept (launched with one), so the K steps stay live;
//   - kHeatLoopRecord (12): E-uni as shipped, and the issuing thread
//     writes its load down (heat_record_load) after the residual in `res`
//     (1 + 8 blocks words): the kernel audit's plans are held against it,
//     and its expect_tx against the box the launch encodes
//     (heat_probe_temporal_box).

#include "heat_e_uni.cuh"

// At least one block an SM (the second bound): without it ptxas cut a
// cheaper variant to 64 registers and spilled, to fit more blocks than the
// launch's shared memory lets run.
template <int kVar>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_temporal_kernel(float* __restrict__ out, uint32_t* res, int64_t m,
                           int64_t n, int64_t n_col_tiles, int k, int tile_y,
                           int tile_x, float a0, float cx, float cy,
                           const __grid_constant__ CUtensorMap umap) {
  heat_e_uni_tile<kVar>(out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0,
                        cx, cy, &umap);
}

// Variant `variant` (0 .. 5 or 12, above) of E-uni's launch, with
// heat_e_uni_temporal's arguments after it. Returns a cudaError_t: 0, or
// the reason the launch was refused; or a tensor-map encoding error.
extern "C" int heat_probe_temporal(int variant, const float* u, float* out,
                                   uint32_t* res, int64_t m, int64_t n,
                                   int k, int tile_y, int tile_x,
                                   int block_x, int block_y, float a0,
                                   float cx, float cy, void* stream) {
#define HEAT_PROBE_LAUNCH(V)                                                \
  heat_e_uni_launch(heat_probe_temporal_kernel<V>, u, out, res, m, n, k,   \
                    tile_y, tile_x, block_x, block_y, a0, cx, cy, stream)
  switch (variant) {
    case kHeatLoopFull:
      return HEAT_PROBE_LAUNCH(kHeatLoopFull);
    case kHeatLoopNoResidual:
      return HEAT_PROBE_LAUNCH(kHeatLoopNoResidual);
    case kHeatLoopNoEdge:
      return HEAT_PROBE_LAUNCH(kHeatLoopNoEdge);
    case kHeatLoopCopyStep:
      return HEAT_PROBE_LAUNCH(kHeatLoopCopyStep);
    case kHeatLoopNoLoad:
      return HEAT_PROBE_LAUNCH(kHeatLoopNoLoad);
    case kHeatLoopNoStore:
      return HEAT_PROBE_LAUNCH(kHeatLoopNoStore);
    case kHeatLoopRecord:
      return HEAT_PROBE_LAUNCH(kHeatLoopRecord);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HEAT_PROBE_LAUNCH
}

// The box E-uni's launch encodes in its tensor map (whole load, depth
// k, tile (tile_y, tile_x), block_y warps), innermost first, into box[0]
// and box[1]: the bytes each block's box lands, which the record
// variant's expect_tx is held against. Returns 0.
extern "C" int heat_probe_temporal_box(int k, int tile_y, int tile_x,
                                       int block_y, uint32_t* box) {
  cuuint32_t body[2], last[2];
  heat_e_uni_map_boxes(kHeatLoadWhole, k, tile_y, tile_x, block_y, body,
                       last);
  box[0] = body[0];
  box[1] = body[1];
  return 0;
}

extern "C" const char* heat_probe_temporal_error_string(int code) {
  return heat_tma_error_string(code);
}
