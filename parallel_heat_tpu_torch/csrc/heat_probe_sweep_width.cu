// heat_probe_sweep_width — the shared-memory sweep's rate along a ladder of
// row widths: does a width cost more than its cells, and where?
//
// Replaces: tools/probe_sweep_width.py::build (pallas_call name
// "heat_probe_sweep_width", defined at :40, call :71), the TPU probe that
// timed one VMEM-resident ping-pong sweep at a ladder of row widths to
// find lane-tile-count cliffs.
//
// Bound on the H100: no HBM in the timed loop (each member is loaded once
// and stored once, and the slope over the sweeps cancels both). A sweep
// is bound by its shared bytes, each band cell read once and written
// once, over 128 bytes a clock an SM, or its 7 FP32 operations a cell over
// 128 lanes a clock an SM, whichever is larger.
//
// Design: heat_probe_sweep.cuh, one block an SM on its (R, w) member, the
// tile loop's layout (warps on runs of rows, lanes on groups of 4 columns
// in passes of 32). Widths around the tile loop's rows
// (heat_row_floats of E's and G's tiles) show what a pass of 32 groups
// costs when a row needs one more; a width no multiple of 4 runs the
// one-float-a-lane walk. heat_probe_store_align.cu compiles the same body
// for the store offsets.

#include "heat_probe_sweep.cuh"

template <int kV>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_sweep_width_kernel(const float* __restrict__ u,
                              float* __restrict__ out, int rows_total, int w,
                              int lo, int rows, int pairs) {
  heat_sweep_member<kV>(u, out, rows_total, w, lo, rows, pairs);
}

// `sweeps` sweeps (2 floor(sweeps/2)) of rows [lo, lo + rows) of every
// member of the (members, rows_total, w) float32 stack `u` into `out`,
// one block of block_x x block_y threads a member, one block an SM
// (heat_sweep_launch has the refusals). Returns a cudaError_t.
extern "C" int heat_probe_sweep_width(const float* u, float* out,
                                      int members, int rows_total, int w,
                                      int lo, int rows, int sweeps,
                                      int block_x, int block_y,
                                      void* stream) {
  return heat_sweep_launch(heat_probe_sweep_width_kernel<4>,
                           heat_probe_sweep_width_kernel<1>, u, out, members,
                           rows_total, w, lo, rows, sweeps, block_x, block_y,
                           stream);
}

extern "C" const char* heat_probe_sweep_width_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
