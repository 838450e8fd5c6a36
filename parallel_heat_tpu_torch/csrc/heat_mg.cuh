// heat_mg.cuh — the launch record the two multigrid transfer kernels
// (heat_mg_restrict.cu, heat_mg_prolong.cu) take from the host.
//
// ops/multigrid.py builds one record per (kernel, source shape, output
// shape), once, as a ctypes structure of this layout (_TransferArgs), and
// hands each launch its address with the two arrays and the stream: a
// call in the V-cycle converts four pointers, not ten integers. The
// launchers check every field on every launch (a few integer compares),
// so a record they refuse never runs.

#pragma once

#include <stdint.h>

struct HeatMgTransfer {
  int64_t batch;              // arrays in the stack (blockIdx.z)
  int64_t src_rows, src_cols;  // one source array, ring included
  int64_t dst_rows, dst_cols;  // one output array, ring included
  int32_t block_x, block_y;    // threads of a block
  int32_t cells_y, cells_x;    // output cells a thread (restrict only)
};
