// heat_mg_restrict — full-weighting restriction of a fine multigrid
// level onto the next coarser one.
//
// Replaces: parallel_heat_tpu/ops/multigrid.py::_build_restrict_kernel
// (pallas_call name "heat_mg_restrict", defined at :225, call :244).
//
// Computes, for each of `batch` full fine arrays r of (mf + 2) x (nf + 2)
// float32 (Dirichlet ring included), the full coarse array of
// (mc + 2) x (nc + 2) with a zero ring, whose interior cell (i, j) sits
// at fine full index (2i + 2, 2j + 2):
//     rows(c) = 0.25 * ((r[2i+1, c] + 2 * r[2i+2, c]) + r[2i+3, c])
//     out     = 0.25 * ((rows(2j+1) + 2 * rows(2j+2)) + rows(2j+3)),
// the 1/16 [1 2 1; 2 4 2; 1 2 1] stencil as two [1 2 1]/4 passes, rows
// first, in exactly the association of ops/multigrid.py's
// _restrict_interior. Every multiply is by a power of two; the adds are
// __fadd_rn in that order, so the kernel is bitwise its plain version.
//
// Bound on the H100: bytes. The fine array is read once and the coarse
// one, a quarter of it, written once: 5 B per fine cell over HBM against
// 14 operations per coarse cell (3.5 per fine cell). At 4098^2 -> 2050^2
// that is 84 MB, 0.025 ms; at 512^2 -> 257^2 1.3 MB, 0.0004 ms, where a
// launch's own latency sets the time.
//
// Design: the TPU kernel holds both whole arrays in VMEM. Here the
// arrays have no size limit (the finest level of a 4096^2 run is 64 MB),
// so the coarse array, ring included, is tiled over blocks of
// block_x x block_y threads, and a thread takes cells_y x cells_x
// neighbouring coarse cells (1 x 1, 1 x 2 or 2 x 2, a template
// parameter). It reads its fine window of (2 cells_y + 1) x
// (2 cells_x + 1) cells into registers once, each cell by one load (a
// 2 x 2 thread reads 25 cells for 4 outputs, where 4 threads of 1 x 1
// read 36), then makes each row pass once for the window's columns and
// the column pass from those. The window's rows and columns are clamped
// into the fine array: an interior coarse cell's window always lies
// inside it, and a ring cell, which stores 0, reads in-bounds cells it
// does not use. A warp's windows overlap on their edge columns, which
// come through L1. blockIdx.z is the member of a batched call. The
// launch parameters are hopper_params.mg_restrict_block and
// mg_restrict_cells, chosen by bench_kernels --only mg: 2 x 2 cells a
// thread on coarse levels of at least a wave of cells (132 x 2048), 1 x 1
// below, where the wave is short and a thread's latency, not the loads,
// sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "heat_mg.cuh"

__device__ __forceinline__ float heat_mg_121(float a, float b, float c) {
  return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(a, __fmul_rn(2.0f, b)), c));
}

template <int kCy, int kCx>
__global__ void __launch_bounds__(1024)
heat_mg_restrict_kernel(const float* __restrict__ fine,
                        float* __restrict__ coarse, int mf2, int nf2, int mc2,
                        int nc2) {
  constexpr int kWy = 2 * kCy + 1, kWx = 2 * kCx + 1;
  // The thread's first coarse cell (full indices, ring included).
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kCx;
  const int i0 = (blockIdx.y * blockDim.y + threadIdx.y) * kCy;
  if (i0 >= mc2 || j0 >= nc2) return;
  const int64_t member = blockIdx.z;
  const float* f = fine + member * mf2 * nf2;
  float* q = coarse + member * mc2 * nc2;
  // Coarse cell (i, j) reads fine rows 2i - 1 .. 2i + 1 and columns
  // 2j - 1 .. 2j + 1.
  int col[kWx];
#pragma unroll
  for (int b = 0; b < kWx; ++b)
    col[b] = min(max(2 * j0 - 1 + b, 0), nf2 - 1);
  float w[kWy][kWx];
#pragma unroll
  for (int a = 0; a < kWy; ++a) {
    const float* p =
        f + static_cast<int64_t>(min(max(2 * i0 - 1 + a, 0), mf2 - 1)) * nf2;
#pragma unroll
    for (int b = 0; b < kWx; ++b) w[a][b] = __ldg(p + col[b]);
  }
#pragma unroll
  for (int y = 0; y < kCy; ++y) {
    const int i = i0 + y;
    if (i >= mc2) break;
    float rows[kWx];
#pragma unroll
    for (int b = 0; b < kWx; ++b)
      rows[b] = heat_mg_121(w[2 * y][b], w[2 * y + 1][b], w[2 * y + 2][b]);
    const bool ring_row = i == 0 || i == mc2 - 1;
    float* out = q + static_cast<int64_t>(i) * nc2;
#pragma unroll
    for (int x = 0; x < kCx; ++x) {
      const int j = j0 + x;
      if (j >= nc2) break;
      const float v =
          heat_mg_121(rows[2 * x], rows[2 * x + 1], rows[2 * x + 2]);
      out[j] = (ring_row || j == 0 || j == nc2 - 1) ? 0.f : v;
    }
  }
}

template <int kCy, int kCx>
static void heat_mg_restrict_launch(const HeatMgTransfer& t, dim3 grid,
                                    const float* fine, float* coarse,
                                    cudaStream_t stream) {
  heat_mg_restrict_kernel<kCy, kCx>
      <<<grid, dim3(t.block_x, t.block_y), 0, stream>>>(
          fine, coarse, static_cast<int>(t.src_rows),
          static_cast<int>(t.src_cols), static_cast<int>(t.dst_rows),
          static_cast<int>(t.dst_cols));
}

// Restrict each of the t->batch contiguous (src_rows, src_cols) float32
// arrays of `fine` (ring included) onto the (dst_rows, dst_cols) arrays
// of `coarse`, every cell of which the launch writes. The record must
// have 2 * (dst_rows - 2) <= src_rows - 2 and likewise for columns, so
// that every interior window lies inside the fine array, and cells
// 1 x 1, 1 x 2 or 2 x 2. Launches on `stream` and does not synchronise.
// Returns a cudaError_t.
extern "C" int heat_mg_restrict(const HeatMgTransfer* t, const float* fine,
                                float* coarse, void* stream) {
  if (t == nullptr || t->batch < 1 || t->batch > 65535 || t->dst_rows < 3 ||
      t->dst_cols < 3 || 2 * (t->dst_rows - 2) > t->src_rows - 2 ||
      2 * (t->dst_cols - 2) > t->src_cols - 2 || t->src_rows > 0x3fffffffLL ||
      t->src_cols > 0x3fffffffLL || t->block_x < 1 || t->block_y < 1 ||
      t->block_x * t->block_y > 1024 || t->cells_y < 1 || t->cells_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads_x = (t->dst_cols + t->cells_x - 1) / t->cells_x;
  const int64_t threads_y = (t->dst_rows + t->cells_y - 1) / t->cells_y;
  const int64_t gx = (threads_x + t->block_x - 1) / t->block_x;
  const int64_t gy = (threads_y + t->block_y - 1) / t->block_y;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(t->batch));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t->cells_y == 1 && t->cells_x == 1)
    heat_mg_restrict_launch<1, 1>(*t, grid, fine, coarse, s);
  else if (t->cells_y == 1 && t->cells_x == 2)
    heat_mg_restrict_launch<1, 2>(*t, grid, fine, coarse, s);
  else if (t->cells_y == 2 && t->cells_x == 2)
    heat_mg_restrict_launch<2, 2>(*t, grid, fine, coarse, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_mg_restrict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
