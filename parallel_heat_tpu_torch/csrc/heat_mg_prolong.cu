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
// with stack + reshape. Here one thread takes one coarse full cell
// (t, s), ring included, and writes the 2 x 2 fine block at full fine
// rows 2t, 2t + 1 and columns 2s, 2s + 1, clipped to the fine array. In
// full indices fine row 2t is interior row 2t - 1, which is odd and
// copies coarse row t; fine row 2t + 1 is interior row 2t, which is even
// and averages coarse rows t and t + 1; columns likewise. So the four
// outputs need exactly the coarse cells (t .. t + 1, s .. s + 1), each
// loaded once, with no parity branch: a = c[t][s], b = c[t][s + 1],
// d = c[t + 1][s], e = c[t + 1][s + 1] give
//     f[2t][2s]     = a                f[2t][2s + 1]     = avg(a, b)
//     f[2t + 1][2s] = avg(a, d)        f[2t + 1][2s + 1] = avg(avg(a, d),
//                                                             avg(b, e)),
// avg(x, y) = 0.5 * (x + y), the row pass before the column pass. The
// ring (fine rows 0 and mf + 1, columns 0 and nf + 1) is selected to 0
// by the edge threads of the same launch, which also write the extra
// last line of an odd fine interior; their coarse indices past the array
// are clamped (to cells whose values they do not use). A row's pair of
// fine cells is one 8-byte store where the fine row pitch is even and
// the array 8-byte aligned (column 2s is then 8-byte aligned), else two
// 4-byte stores: a warp writes 256 contiguous bytes a row. The thread
// block is hopper_params.mg_prolong_block, chosen by
// bench_kernels --only mg. blockIdx.z is the member of a batched call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "heat_mg.cuh"

__device__ __forceinline__ float heat_mg_half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

template <bool kPair>
__global__ void __launch_bounds__(1024)
heat_mg_prolong_kernel(const float* __restrict__ coarse,
                       float* __restrict__ fine, int mc2, int nc2, int mf2,
                       int nf2) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;  // coarse full col
  const int t = blockIdx.y * blockDim.y + threadIdx.y;  // coarse full row
  const int r0 = 2 * t, c0 = 2 * s;  // the fine block's first row, column
  if (r0 >= mf2 || c0 >= nf2) return;
  const int64_t member = blockIdx.z;
  const float* c = coarse + member * mc2 * nc2;
  float* f = fine + member * mf2 * nf2;
  // t, s <= the coarse ring's index; t + 1, s + 1 may lie past it only
  // for a thread whose outputs are all ring or outside the fine array.
  const float* p0 = c + static_cast<int64_t>(t) * nc2;
  const float* p1 = c + static_cast<int64_t>(min(t + 1, mc2 - 1)) * nc2;
  const int s1 = min(s + 1, nc2 - 1);
  const float a = __ldg(p0 + s), b = __ldg(p0 + s1);
  const float d = __ldg(p1 + s), e = __ldg(p1 + s1);
  const float ad = heat_mg_half_sum(a, d);
  const bool ring_r0 = r0 == 0 || r0 == mf2 - 1;
  const bool ring_r1 = r0 + 1 == mf2 - 1;
  const bool ring_c0 = c0 == 0 || c0 == nf2 - 1;
  const bool ring_c1 = c0 + 1 == nf2 - 1;
  const float v00 = (ring_r0 || ring_c0) ? 0.f : a;
  const float v01 = (ring_r0 || ring_c1) ? 0.f : heat_mg_half_sum(a, b);
  const float v10 = (ring_r1 || ring_c0) ? 0.f : ad;
  const float v11 = (ring_r1 || ring_c1)
                        ? 0.f
                        : heat_mg_half_sum(ad, heat_mg_half_sum(b, e));
  float* q0 = f + static_cast<int64_t>(r0) * nf2 + c0;
  float* q1 = q0 + nf2;
  const bool row1 = r0 + 1 < mf2;
  if (kPair) {
    // nf2 even: c0 + 1 < nf2, and q0 lies on 8 bytes.
    *reinterpret_cast<float2*>(q0) = make_float2(v00, v01);
    if (row1) *reinterpret_cast<float2*>(q1) = make_float2(v10, v11);
  } else {
    const bool col1 = c0 + 1 < nf2;
    q0[0] = v00;
    if (col1) q0[1] = v01;
    if (row1) {
      q1[0] = v10;
      if (col1) q1[1] = v11;
    }
  }
}

// Prolong each of the t->batch contiguous (src_rows, src_cols) float32
// arrays of `coarse` (ring included) onto the (dst_rows, dst_cols) arrays
// of `fine`, every cell of which the launch writes. The fine interior
// must be twice the coarse interior or one more, per axis, and cells
// 1 x 1. Launches on `stream` and does not synchronise. Returns a
// cudaError_t.
extern "C" int heat_mg_prolong(const HeatMgTransfer* t, const float* coarse,
                               float* fine, void* stream) {
  if (t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t mc2 = t->src_rows, nc2 = t->src_cols;
  const int64_t mf2 = t->dst_rows, nf2 = t->dst_cols;
  const int64_t dm = (mf2 - 2) - 2 * (mc2 - 2);
  const int64_t dn = (nf2 - 2) - 2 * (nc2 - 2);
  if (t->batch < 1 || t->batch > 65535 || mc2 < 3 || nc2 < 3 || dm < 0 ||
      dm > 1 || dn < 0 || dn > 1 || mf2 > 0x3fffffffLL ||
      nf2 > 0x3fffffffLL || t->block_x < 1 || t->block_y < 1 ||
      t->block_x * t->block_y > 1024 || t->cells_y != 1 || t->cells_x != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // A thread a coarse cell (t, s) of the fine array's 2 x 2 blocks.
  const int64_t gx = ((nf2 + 1) / 2 + t->block_x - 1) / t->block_x;
  const int64_t gy = ((mf2 + 1) / 2 + t->block_y - 1) / t->block_y;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
                  static_cast<unsigned>(t->batch));
  const dim3 block(t->block_x, t->block_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf2 % 2 == 0 && reinterpret_cast<uintptr_t>(fine) % 8 == 0)
    heat_mg_prolong_kernel<true><<<grid, block, 0, s>>>(
        coarse, fine, static_cast<int>(mc2), static_cast<int>(nc2),
        static_cast<int>(mf2), static_cast<int>(nf2));
  else
    heat_mg_prolong_kernel<false><<<grid, block, 0, s>>>(
        coarse, fine, static_cast<int>(mc2), static_cast<int>(nc2),
        static_cast<int>(mf2), static_cast<int>(nf2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_mg_prolong_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
