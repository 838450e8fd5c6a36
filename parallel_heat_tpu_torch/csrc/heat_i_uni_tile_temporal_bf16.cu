// heat_i_uni_tile_temporal_bf16 — kernel I-uni's precision forms:
// heat_i_tile_temporal_bf16 with a uniform load, bitwise the same outputs.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::
// _build_tile_temporal_2d_uniform (pallas_call name
// "heat_i_uni_tile_temporal", defined at :3456, call :3608) at dtype_name
// "bfloat16": its storage form (every level rounded, :3592) and its
// acc_f32 form (heat_temporal.cuh kHeatForm*).
//
// Bound on the H100: heat_i_tile_temporal_bf16's.
//
// Design: I-uni's band stream (heat_i_loop.cuh), each stage of a band's
// rows one TMA box of a bfloat16 tensor map of the grid. A box must start
// on 16 bytes of its row and a band starts on 4 cells, so the box starts
// at the band's first cell rounded down to 8 and is 136 cells wide (272
// bytes a row, a multiple of 16); the lanes read from the shift on. The
// grid's rows must be 16-byte multiples, a width that is a multiple of 8
// (the entry point refuses other grids). A float32 input (a carried
// level, form 3) takes I-uni's float32 box. One __global__ of its own for
// the bfloat16 forms, built apart from the float32 kernel.

#include "heat_i_loop.cuh"

template <int K, int kForm>
__global__ void __launch_bounds__(kIMaxThreads, 2)
heat_i_uni_tile_temporal_bf16_kernel(const __grid_constant__ HeatIArgs args,
                                     const __grid_constant__ CUtensorMap map) {
  using F = HeatForm<kForm>;
  heat_i_block<K, true, typename F::In, typename F::Out, F::kRound>(args,
                                                                    &map);
}

static const HeatIFormKernels kHeatIUniBf16Kernels =
    HEAT_I_FORM_TABLE(heat_i_uni_tile_temporal_bf16_kernel);

// K steps of `u` into `out` under precision form `form` (as
// heat_i_tile_temporal_bf16), each stage of rows one TMA box of `u` in its
// own dtype: a bfloat16 grid's width must be a multiple of 8 cells, a
// float32 one's of 4, and `u` 16-byte aligned. Returns a cudaError_t or a
// tensor-map encoding error.
extern "C" int heat_i_uni_tile_temporal_bf16(const void* u, void* out,
                                             uint32_t* res, int64_t m,
                                             int64_t n, int k,
                                             int64_t seg_rows, int warps,
                                             int rows, int stages, int form,
                                             float a0, float cx, float cy,
                                             void* stream) {
  return heat_i_form_launch<true>(kHeatIUniBf16Kernels, form, u, out, res,
                                  m, n, k, seg_rows, warps, rows, stages, a0,
                                  cx, cy, stream);
}

// Thread blocks of form `form`'s kernel of depth k that one SM holds at
// once, into *blocks. Returns a cudaError_t.
extern "C" int heat_i_uni_tile_temporal_bf16_occupancy(int form, int k,
                                                       int warps, int rows,
                                                       int stages,
                                                       int* blocks) {
  return heat_i_form_occupancy(kHeatIUniBf16Kernels, form, k, warps, rows,
                               stages, blocks);
}

extern "C" const char* heat_i_uni_tile_temporal_bf16_error_string(int code) {
  return heat_tma_error_string(code);
}
