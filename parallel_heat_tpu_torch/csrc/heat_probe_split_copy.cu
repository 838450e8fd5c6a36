// heat_probe_split_copy — does the form of kernel E-uni's tile load cost
// its steps anything? E-uni's own launch, its tile's load cut into
// pieces on one or several mbarriers, the K steps and the store kept.
//
// Replaces: tools/probe_split_copy.py::build (pallas_call name
// "heat_probe_split_copy", defined at :50, call :184), the TPU probe that
// split kernel E's strip copy into lane slices, row halves, a wider
// destination slot or branch-issued copies, on one or several DMA
// semaphores, with the compute kept.
//
// Bound on the H100: E-uni's (heat_e_uni_temporal.cu): at 16384^2 a
// launch moves 2 GiB through HBM, 0.641 ms, whatever the load form. Every
// form computes E-uni's K steps (no residual) and is bitwise its plain
// version.
//
// Design: heat_e_uni.cuh compiles E-uni's block once per load form
// (kHeatLoad*, where each form is described) and launches it exactly as
// heat_e_uni_temporal does, tile, K and thread block included. The TPU's
// names, on Hopper:
//   - whole (kHeatLoadWhole): one box, one mbarrier; E-uni as shipped;
//   - lanes2, lanes4: 2 or 4 column slices, an mbarrier each; a box lands
//     with its own row pitch, so a slice is one box a row;
//   - lanes2-1sem: the two slices on one mbarrier;
//   - rows2: two boxes of half the rows, an mbarrier each;
//   - subwin: the shared rows 32 floats (128 bytes) wider than the box,
//     one box a row, so the slot is wider than its copy (the two buffers
//     grow by a quarter at K = 8: one block an SM, not two);
//   - branchy: whole's box issued under three branches on the tile's
//     place (first, last, any other);
//   - rows<w> (kHeatLoadRowBands): one box and one mbarrier per warp's
//     run of rows, a warp waiting only on the bands its first step reads.
// Every form but whole and branchy needs shared rows of a multiple of 32
// floats (a box lands on a 128-byte boundary): at E-uni's 96 x 112 tile,
// K = 5 .. 8.

#include "heat_e_uni.cuh"

// At least one block an SM (the second bound), as the other E-uni probes.
template <int kLoad>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_split_copy_kernel(float* __restrict__ out, uint32_t* res,
                             int64_t m, int64_t n, int64_t n_col_tiles, int k,
                             int tile_y, int tile_x, float a0, float cx,
                             float cy,
                             const __grid_constant__ HeatEUniMaps maps) {
  heat_e_uni_tile<kHeatLoopFull, kLoad>(out, res, m, n, n_col_tiles, k,
                                        tile_y, tile_x, a0, cx, cy,
                                        &maps.body, &maps.tail);
}

// Load form `variant` (kHeatLoadWhole .. kHeatLoadRowBands) of E-uni's
// launch, with heat_e_uni_temporal's arguments after it (`res` may be
// null: no residual). Returns a cudaError_t: 0, or the reason the launch
// was refused (a form whose geometry the tile does not allow:
// heat_e_uni_load_fits); or a tensor-map encoding error.
extern "C" int heat_probe_split_copy(int variant, const float* u, float* out,
                                     uint32_t* res, int64_t m, int64_t n,
                                     int k, int tile_y, int tile_x,
                                     int block_x, int block_y, float a0,
                                     float cx, float cy, void* stream) {
#define HEAT_PROBE_LAUNCH(L)                                                \
  heat_e_uni_launch<L, true>(heat_probe_split_copy_kernel<L>, u, out, res, \
                             m, n, k, tile_y, tile_x, block_x, block_y,    \
                             a0, cx, cy, stream)
  switch (variant) {
    case kHeatLoadWhole:
      return HEAT_PROBE_LAUNCH(kHeatLoadWhole);
    case kHeatLoadLanes2:
      return HEAT_PROBE_LAUNCH(kHeatLoadLanes2);
    case kHeatLoadLanes2OneBar:
      return HEAT_PROBE_LAUNCH(kHeatLoadLanes2OneBar);
    case kHeatLoadRows2:
      return HEAT_PROBE_LAUNCH(kHeatLoadRows2);
    case kHeatLoadLanes4:
      return HEAT_PROBE_LAUNCH(kHeatLoadLanes4);
    case kHeatLoadSubwin:
      return HEAT_PROBE_LAUNCH(kHeatLoadSubwin);
    case kHeatLoadBranchy:
      return HEAT_PROBE_LAUNCH(kHeatLoadBranchy);
    case kHeatLoadRowBands:
      return HEAT_PROBE_LAUNCH(kHeatLoadRowBands);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HEAT_PROBE_LAUNCH
}

extern "C" const char* heat_probe_split_copy_error_string(int code) {
  return heat_tma_error_string(code);
}
