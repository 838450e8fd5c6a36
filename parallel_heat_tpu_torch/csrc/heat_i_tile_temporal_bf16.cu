// heat_i_tile_temporal_bf16 — kernel I's precision forms: K Jacobi steps
// of a bfloat16 grid per pass through global memory over column bands
// streamed down the grid, with the residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_tile_temporal_2d
// (pallas_call name "heat_i_tile_temporal", defined at :3294, call :3419)
// at dtype_name "bfloat16": its storage form (every level rounded to
// bfloat16, :3403) and its acc_f32 form (the levels carried in float32 and
// rounded once), in one launch or split in two across a float32 level
// (heat_temporal.cuh kHeatForm*).
//
// Bound on the H100: as heat_i_tile_temporal's, at 2 bytes a cell a pass
// (a bfloat16 grid read once and written once for K steps); the steps'
// 7 float32 operations a cell-step are the same, so issue, not HBM, sets
// the time here even more than at float32.
//
// Design: heat_i_tile_temporal's band stream (heat_i_loop.cuh), one
// __global__ of its own for the bfloat16 forms. Its ring holds the
// input's storage type, so a stage of bfloat16 rows is half the bytes;
// each lane copies its 4 cells as one 8-byte cp.async where they lie
// inside the grid on 8 bytes (a width that is a multiple of 4), and takes
// plain 2-byte loads for the others (cp.async has no 2-byte copy), and
// widens them on its shared load. Storage mode rounds every level at the
// points a launch of heat_b_step_bf16 does, so K steps are bitwise K
// launches of it and bitwise heat_e_temporal_bf16 at the same K and
// form. Built apart from the float32 kernel so that its 32 instances
// compile beside the other sources, not after them.

#include "heat_i_loop.cuh"

template <int K, int kForm>
__global__ void __launch_bounds__(kIMaxThreads, 2)
heat_i_tile_temporal_bf16_kernel(const __grid_constant__ HeatIArgs args,
                                 const __grid_constant__ CUtensorMap map) {
  using F = HeatForm<kForm>;
  heat_i_block<K, false, typename F::In, typename F::Out, F::kRound>(args,
                                                                     &map);
}

static const HeatIFormKernels kHeatIBf16Kernels =
    HEAT_I_FORM_TABLE(heat_i_tile_temporal_bf16_kernel);

// K steps of `u` into `out` under precision form `form` (heat_temporal.cuh:
// 0 bfloat16 storage, 1 the float32 carry of a whole chunk, 2 its first
// launch into a float32 grid, 3 its last launch from one), otherwise as
// heat_i_tile_temporal. Returns a cudaError_t.
extern "C" int heat_i_tile_temporal_bf16(const void* u, void* out,
                                         uint32_t* res, int64_t m, int64_t n,
                                         int k, int64_t seg_rows, int warps,
                                         int rows, int stages, int form,
                                         float a0, float cx, float cy,
                                         void* stream) {
  return heat_i_form_launch<false>(kHeatIBf16Kernels, form, u, out, res, m,
                                   n, k, seg_rows, warps, rows, stages, a0,
                                   cx, cy, stream);
}

// Thread blocks of form `form`'s kernel of depth k that one SM holds at
// once, into *blocks (heat_i_occupancy at the form's ring). Returns a
// cudaError_t.
extern "C" int heat_i_tile_temporal_bf16_occupancy(int form, int k,
                                                   int warps, int rows,
                                                   int stages, int* blocks) {
  return heat_i_form_occupancy(kHeatIBf16Kernels, form, k, warps, rows,
                               stages, blocks);
}

extern "C" const char* heat_i_tile_temporal_bf16_error_string(int code) {
  return heat_tma_error_string(code);
}
