// heat_probe_roll_pad — how the tile loop takes a cell's left and right
// neighbours: kernels A and E-uni, each launched exactly as it ships, in
// three neighbour forms that compute the same function.
//
// Replaces: tools/ab_roll_pad.py::build_padslice (pallas_call name
// "heat_probe_roll_pad", defined at :52, call :126), the TPU probe that
// raced kernel A against a form whose state lived in padded (M, N+2)
// buffers, the neighbours read as lane-offset slices instead of two lane
// rolls.
//
// Bound on the H100: the kernels' own (heat_a_resident.cu at 1000^2:
// 8 MB through HBM a launch, 2.4 us whatever K; heat_e_uni_temporal.cu).
//
// Design: the tile loop (heat_temporal.cuh heat_rows) holds a lane's 4
// columns of a row in a float4 register; the left and right cells belong
// to the lanes beside it. The forms (heat_temporal.cuh kHeatLoop*):
//   - prod (kHeatLoopFull): as shipped, two warp shuffles a row and one
//     broadcast 4-byte shared load for lanes 0 and 31;
//   - padslice (kHeatLoopPadSlice), the TPU variant's analog: no
//     shuffle, each lane reads the float before and the float after its
//     group from shared memory, two 4-byte loads a row at a stride of 4
//     floats (a 4-way bank conflict each). The rows' padding
//     (heat_row_pad) already makes both reads legal, as it does for
//     lanes 0 and 31 in prod;
//   - nbr4 (kHeatLoopNbr4): no shuffle, each lane reads the neighbour
//     groups' whole float4s and keeps .w and .x, two 16-byte loads a row.
// A is compiled per form through heat_a.cuh (heat_a_launch<kHeatAFull,
// kLoop>: prod is heat_a_resident_kernel<0> itself, the others
// heat_a_loop_kernel<kLoop>), E-uni through heat_e_uni.cuh's block
// (heat_e_uni_tile<kVar>) in a kernel of this file, as the other E-uni
// probes do. heat_temporal.cuh says why the forms agree bit for bit.

#include "heat_a.cuh"
#include "heat_e_uni.cuh"

// At least one block an SM (the second bound), as the other E-uni probes
// declare: without it ptxas may cut a variant's registers to fit more
// blocks than the launch's shared memory lets run, and spill.
template <int kVar>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_roll_pad_kernel(float* __restrict__ out, uint32_t* res, int64_t m,
                           int64_t n, int64_t n_col_tiles, int k, int tile_y,
                           int tile_x, float a0, float cx, float cy,
                           const __grid_constant__ CUtensorMap umap) {
  heat_e_uni_tile<kVar>(out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0,
                        cx, cy, &umap);
}

// Neighbour form `form` (kHeatLoopFull, kHeatLoopPadSlice or
// kHeatLoopNbr4) of kernel A's launch (kernel 0: heat_a_resident's
// arguments) or of E-uni's (kernel 1: heat_e_uni_temporal's, `xch` and
// `depth` unused). Returns a cudaError_t: 0, or the reason the launch was
// refused; or a tensor-map encoding error.
extern "C" int heat_probe_roll_pad(int kernel, int form, const float* u,
                                   float* out, float* xch, uint32_t* res,
                                   int64_t m, int64_t n, int k, int depth,
                                   int tile_y, int tile_x, int block_x,
                                   int block_y, float a0, float cx, float cy,
                                   void* stream) {
#define HEAT_PROBE_A(F)                                                     \
  heat_a_launch<kHeatAFull, F>(u, out, xch, res, m, n, k, depth, tile_y,    \
                               tile_x, block_x, block_y, a0, cx, cy, stream)
#define HEAT_PROBE_E(F)                                                     \
  heat_e_uni_launch(heat_probe_roll_pad_kernel<F>, u, out, res, m, n, k,    \
                    tile_y, tile_x, block_x, block_y, a0, cx, cy, stream)
  if (kernel == 0) {
    switch (form) {
      case kHeatLoopFull:
        return HEAT_PROBE_A(kHeatLoopFull);
      case kHeatLoopPadSlice:
        return HEAT_PROBE_A(kHeatLoopPadSlice);
      case kHeatLoopNbr4:
        return HEAT_PROBE_A(kHeatLoopNbr4);
    }
  } else if (kernel == 1) {
    switch (form) {
      case kHeatLoopFull:
        return HEAT_PROBE_E(kHeatLoopFull);
      case kHeatLoopPadSlice:
        return HEAT_PROBE_E(kHeatLoopPadSlice);
      case kHeatLoopNbr4:
        return HEAT_PROBE_E(kHeatLoopNbr4);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef HEAT_PROBE_A
#undef HEAT_PROBE_E
}

extern "C" const char* heat_probe_roll_pad_error_string(int code) {
  return heat_tma_error_string(code);
}
