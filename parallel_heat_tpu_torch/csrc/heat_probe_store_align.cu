// heat_probe_store_align — what the shared-memory sweep's stores cost when
// they cannot be 16-byte vectors, and whether the band's first row moves
// anything.
//
// Replaces: tools/probe_store_align.py::build (pallas_call name
// "heat_probe_store_align", defined at :36, call :65), the TPU probe that
// timed one VMEM-resident ping-pong sweep with its band starting at rows
// 1, 8, 9 and 16, to price stores that straddle the (8, 128) tiling.
//
// Bound on the H100: as heat_probe_sweep_width.cu's, per sweep.
//
// Design: heat_probe_sweep.cuh, the same body as the width ladder, with
// the band's first row `lo` a parameter. Shared memory has no row tiling:
// a row of w floats starts on 16 bytes when w is a multiple of 4, whatever
// its index. So the offsets are run at a row pitch that is a multiple of 4
// floats (float4 loads and stores) and at one more (an odd pitch, where
// no 16-byte access is aligned: the one-float-a-lane walk).

#include "heat_probe_sweep.cuh"

template <int kV>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_store_align_kernel(const float* __restrict__ u,
                              float* __restrict__ out, int rows_total, int w,
                              int lo, int rows, int pairs) {
  heat_sweep_member<kV>(u, out, rows_total, w, lo, rows, pairs);
}

// As heat_probe_sweep_width: `sweeps` sweeps of rows [lo, lo + rows) of
// every member of the stack `u` into `out`. Returns a cudaError_t.
extern "C" int heat_probe_store_align(const float* u, float* out,
                                      int members, int rows_total, int w,
                                      int lo, int rows, int sweeps,
                                      int block_x, int block_y,
                                      void* stream) {
  return heat_sweep_launch(heat_probe_store_align_kernel<4>,
                           heat_probe_store_align_kernel<1>, u, out, members,
                           rows_total, w, lo, rows, sweeps, block_x, block_y,
                           stream);
}

extern "C" const char* heat_probe_store_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
