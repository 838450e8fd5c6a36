// heat_mg_prolong — bilinear prolongation of a coarse multigrid level's
// correction onto the next finer one.
//
// Replaces: parallel_heat_tpu/ops/multigrid.py::_build_prolong_kernel
// (pallas_call name "heat_mg_prolong", defined at :256, call :275).
//
// Computes, for each of `batch` full coarse arrays c of
// (mc + 2) x (nc + 2) float32 (zero ring included), the full fine array
// of (mf + 2) x (nf + 2) with a zero ring, mf in {2 mc, 2 mc + 1}. Along
// one axis (ops/multigrid.py's _prolong_axis0) fine interior line 2t is
// 0.5 * (c[t] + c[t + 1]) and line 2t + 1 is c[t + 1], in full coarse
// indices: odd lines copy their coarse line, even lines average the two
// flanking ones, the ring supplying the Dirichlet zero at both ends (and
// the extra last line when the fine interior is odd). The row pass comes
// first and the column pass averages two row-pass results, in that
// order; every multiply is by 0.5 and every add a __fadd_rn, so the
// kernel is bitwise its plain version.
//
// Bound on the H100: bytes. The coarse array is read once and the fine
// one, four times its size, written once: 5 B per fine cell over HBM
// against at most 6 operations. At 2050^2 -> 4098^2 that is 84 MB,
// 0.025 ms.
//
// Design: the TPU kernel holds both whole arrays in VMEM and interleaves
// with stack + reshape. Here the fine array, of any size, is tiled over
// blocks of 32 x 8 threads, one fine cell a thread, ring cells included
// (they store 0): a warp writes 32 consecutive floats and reads the 17
// coarse cells under them from at most two coarse rows, through L1.
// blockIdx.z is the member of a batched call.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float heat_mg_half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// The row pass at fine interior row p, coarse full column c.
__device__ __forceinline__ float heat_mg_row_pass(
    const float* __restrict__ coarse, int nc2, int p, int c) {
  const float* q = coarse + static_cast<int64_t>(p >> 1) * nc2 + c;
  return (p & 1) ? q[nc2] : heat_mg_half_sum(q[0], q[nc2]);
}

__global__ void __launch_bounds__(1024)
heat_mg_prolong_kernel(const float* __restrict__ coarse,
                       float* __restrict__ fine, int mc2, int nc2, int mf2,
                       int nf2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // fine full col
  const int i = blockIdx.y * blockDim.y + threadIdx.y;  // fine full row
  if (i >= mf2 || j >= nf2) return;
  const int64_t member = blockIdx.z;
  float* out = fine + member * mf2 * nf2 + static_cast<int64_t>(i) * nf2 + j;
  if (i == 0 || i == mf2 - 1 || j == 0 || j == nf2 - 1) {
    *out = 0.f;
    return;
  }
  const float* c = coarse + member * mc2 * nc2;
  const int p = i - 1, q = j - 1;  // fine interior indices
  const int t = q >> 1;
  *out = (q & 1) ? heat_mg_row_pass(c, nc2, p, t + 1)
                 : heat_mg_half_sum(heat_mg_row_pass(c, nc2, p, t),
                                    heat_mg_row_pass(c, nc2, p, t + 1));
}

// Prolong each of the `batch` contiguous (mc2, nc2) float32 arrays of
// `coarse` (ring included) onto the (mf2, nf2) arrays of `fine`. The
// fine interior must be twice the coarse interior or one more, per axis.
// Launches on `stream` and does not synchronise. Returns a cudaError_t.
extern "C" int heat_mg_prolong(const float* coarse, float* fine,
                               int64_t batch, int64_t mc2, int64_t nc2,
                               int64_t mf2, int64_t nf2, int block_x,
                               int block_y, void* stream) {
  const int64_t dm = (mf2 - 2) - 2 * (mc2 - 2);
  const int64_t dn = (nf2 - 2) - 2 * (nc2 - 2);
  if (batch < 1 || batch > 65535 || mc2 < 3 || nc2 < 3 || dm < 0 || dm > 1 ||
      dn < 0 || dn > 1 || mf2 > 0x3fffffffLL || nf2 > 0x3fffffffLL ||
      block_x < 1 || block_y < 1 || block_x * block_y > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t gx = (nf2 + block_x - 1) / block_x;
  const int64_t gy = (mf2 + block_y - 1) / block_y;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(batch));
  heat_mg_prolong_kernel<<<grid, dim3(block_x, block_y), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      coarse, fine, static_cast<int>(mc2), static_cast<int>(nc2),
      static_cast<int>(mf2), static_cast<int>(nf2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_mg_prolong_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
