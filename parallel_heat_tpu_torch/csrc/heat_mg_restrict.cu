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
// that is 84 MB, 0.025 ms.
//
// Design: the TPU kernel holds both whole arrays in VMEM. Here the
// arrays have no size limit (the finest level of a 4096^2 run is 64 MB),
// so the coarse array is tiled over blocks of 32 x 8 threads, one coarse
// cell a thread, ring cells included (they store 0). A thread reads its
// 3 x 3 fine window straight from global memory: neighbouring threads'
// windows overlap, and a warp's three rows of 65 consecutive floats come
// through L1 once each. blockIdx.z is the member of a batched call.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float heat_mg_121(float a, float b, float c) {
  return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(a, __fmul_rn(2.0f, b)), c));
}

__global__ void __launch_bounds__(1024)
heat_mg_restrict_kernel(const float* __restrict__ fine,
                        float* __restrict__ coarse, int mf2, int nf2, int mc2,
                        int nc2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // coarse full col
  const int i = blockIdx.y * blockDim.y + threadIdx.y;  // coarse full row
  if (i >= mc2 || j >= nc2) return;
  const int64_t member = blockIdx.z;
  float* q = coarse + member * mc2 * nc2 + static_cast<int64_t>(i) * nc2 + j;
  if (i == 0 || i == mc2 - 1 || j == 0 || j == nc2 - 1) {
    *q = 0.f;
    return;
  }
  // Interior cell (i - 1, j - 1): centre at fine full (2i, 2j).
  const float* p = fine + member * mf2 * nf2 +
                   static_cast<int64_t>(2 * i - 1) * nf2 + (2 * j - 1);
  const float* p1 = p + nf2;
  const float* p2 = p1 + nf2;
  const float left = heat_mg_121(p[0], p1[0], p2[0]);
  const float mid = heat_mg_121(p[1], p1[1], p2[1]);
  const float right = heat_mg_121(p[2], p1[2], p2[2]);
  *q = heat_mg_121(left, mid, right);
}

// Restrict each of the `batch` contiguous (mf2, nf2) float32 arrays of
// `fine` (ring included) onto the (mc2, nc2) arrays of `coarse`. The
// caller guarantees 2 * (mc2 - 2) <= mf2 - 2 and likewise for columns,
// so every window lies inside the fine array. Launches on `stream` and
// does not synchronise. Returns a cudaError_t.
extern "C" int heat_mg_restrict(const float* fine, float* coarse,
                                int64_t batch, int64_t mf2, int64_t nf2,
                                int64_t mc2, int64_t nc2, int block_x,
                                int block_y, void* stream) {
  if (batch < 1 || batch > 65535 || mc2 < 3 || nc2 < 3 ||
      2 * (mc2 - 2) > mf2 - 2 || 2 * (nc2 - 2) > nf2 - 2 ||
      mf2 > 0x3fffffffLL || nf2 > 0x3fffffffLL || block_x < 1 ||
      block_y < 1 || block_x * block_y > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (nc2 + block_x - 1) / block_x;
  const int64_t gy = (mc2 + block_y - 1) / block_y;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(batch));
  heat_mg_restrict_kernel<<<grid, dim3(block_x, block_y), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      fine, coarse, static_cast<int>(mf2), static_cast<int>(nf2),
      static_cast<int>(mc2), static_cast<int>(nc2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_mg_restrict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
