// heat_f_temporal3d — K 7-point Jacobi steps per pass through global
// memory, with the residual of the last step optional.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_xslab_3d
// (pallas_call name "heat_f_xslab_3d", defined at :3932, call :4072).
//
// Bound on the H100: a pass reads the grid once and writes it once for K
// steps, 8 B per cell per pass, against 10 float32 operations per
// cell-step (and 2 for the residual of the last step): at 512^3 and
// K = 3 the bytes need 0.32 ms per pass at 3.35 TB/s and the operations
// 0.060 ms at 67 TFLOP/s, so bytes bound it. What a pass really moves
// is about 4*(1+2K/TY)(1+2K/TZ)(1+2K/L) B read and 4 B written per
// output cell for (TY, TZ) tiles and segments of L planes, whatever of
// the halo L2 does not serve: at the defaults (a 58 x 26 tile, K = 3,
// L = 86 at 512^3) at most 9.8 B per cell and pass, 3.3 B per
// cell-step, against D's 8. Below that lies instruction issue: each
// cell-step reads two or three neighbours from shared memory and writes
// one, on (1+2K/TY)(1+2K/TZ) = 1.36 cells per output cell.
//
// Design: the TPU kernel keeps whole (Y, Z) planes in VMEM and streams
// X-slabs with K halo planes per side. At 512^3 one float32 plane is
// 1 MiB, and a block here has at most 227 KB of shared memory, so the
// (Y, Z) plane is tiled too: a block owns a tile of output cells plus a
// K-deep halo on its four sides, the extended tile, and a segment of
// output planes [x0, x1), and streams the input planes [x0 - K, x1 + K)
// through shared memory with all K levels in flight: the step phase of
// heat_temporal3d.cuh, which the sharded block kernels heat_h_* share.
// One row per thread (R = 1, one thread per cell, 1024-thread blocks)
// was the first design: one block per SM meeting at every plane's
// barrier, four shared reads per cell-step, 1.4x slower at 512^3
// (PERF.md). R = 4 gives each thread four independent cells per level
// and 512-thread blocks.
// Only the central tile is written back. Cells outside the grid load as
// 0; they cannot reach the interior, since the faces between them and
// the interior never update. Values outside the valid pyramid (levels
// whose planes or columns reach past what the input supports, or read
// the pad rows) are garbage that spreads one cell per level and never
// reaches the output tile; the six Dirichlet faces are copied, never
// computed, and every step rounds to float32 like a launch of
// heat_d_step3d, which makes K steps bitwise K launches of D. Offsets
// are int64.

#include "heat_temporal3d.cuh"

// One block: the (Y, Z) tile and the X segment of blockIdx.x. blockDim
// is (bz, by): the extended tile is bz wide and by * R rows deep. The
// step phase is heat_temporal3d.cuh's; the load reads u, zero-filled
// outside the grid.
template <int K, int R>
__global__ void __launch_bounds__(512)
heat_f_temporal3d_kernel(const float* __restrict__ u, float* __restrict__ out,
                         uint32_t* res, int64_t nx, int64_t ny, int64_t nz,
                         int64_t tiles_z, int64_t tiles_y, int seg, float a0,
                         float cx, float cy, float cz) {
  const int bz = blockDim.x;
  const int wy = blockDim.y * R;             // extended tile rows
  const int row0 = threadIdx.y * R;          // this thread's first row
  const int64_t b = blockIdx.x;
  const int64_t tz = b % tiles_z;
  const int64_t ty = (b / tiles_z) % tiles_y;
  const int64_t x0 = b / tiles_z / tiles_y * seg;
  const int64_t x1 = x0 + seg < nx ? x0 + seg : nx;
  const int64_t gz = tz * (bz - 2 * K) - K + threadIdx.x;
  const int64_t gy0 = ty * (wy - 2 * K) - K + row0;
  const bool z_out = threadIdx.x >= K && threadIdx.x < bz - K;
  unsigned cell_in = 0u, yz_in = 0u, out_rows = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t gy = gy0 + r;
    const bool c_in = gy >= 0 && gy < ny && gz >= 0 && gz < nz;
    cell_in |= static_cast<unsigned>(c_in) << r;
    yz_in |= static_cast<unsigned>(gy >= 1 && gy <= ny - 2 && gz >= 1 &&
                                   gz <= nz - 2) << r;
    out_rows |= static_cast<unsigned>(c_in && z_out && row0 + r >= K &&
                                      row0 + r < wy - K) << r;
  }
  const int64_t plane = ny * nz;
  const int64_t col = gy0 * nz + gz;  // offset of row 0's cell in a plane

  // Outside the grid a cell is zero-filled.
  auto load = [&](float* dst, int64_t t) {
    const bool t_in = t >= 0 && t < nx;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = t_in && ((cell_in >> r) & 1u);
      __pipeline_memcpy_async(dst + r * bz,
                              in ? u + t * plane + col + r * nz : u, 4,
                              in ? 0 : 4);
    }
  };
  heat_t3d_stream<K, R>(load, x0, x1, 0, nx, yz_in, out_rows, out, plane, col,
                        nz, a0, cx, cy, cz, res);
}

using HeatFKernel = void (*)(const float*, float*, uint32_t*, int64_t,
                             int64_t, int64_t, int64_t, int64_t, int, float,
                             float, float, float);

// kHeatFKernels[r][k - 1]: depth k, rows per thread 1 << r.
#define HEAT_F_DEPTHS(R)                                                     \
  {heat_f_temporal3d_kernel<1, R>, heat_f_temporal3d_kernel<2, R>,           \
   heat_f_temporal3d_kernel<3, R>, heat_f_temporal3d_kernel<4, R>,           \
   heat_f_temporal3d_kernel<5, R>, heat_f_temporal3d_kernel<6, R>,           \
   heat_f_temporal3d_kernel<7, R>, heat_f_temporal3d_kernel<8, R>}
static const HeatFKernel kHeatFKernels[3][8] = {
    HEAT_F_DEPTHS(1), HEAT_F_DEPTHS(2), HEAT_F_DEPTHS(4)};
#undef HEAT_F_DEPTHS

// K steps of the nx x ny x nz float32 grid `u` (z contiguous) into `out`
// (distinct buffers on the current device), 1 <= k <= 8, with blocks of
// block_z x block_y threads (block_z a multiple of 32, at most 512
// threads), each thread `rows` (1, 2 or 4) consecutive rows of one z:
// the extended tile is block_z x (block_y * rows) cells, both above 2k,
// the output tile that less 2k per axis. Segments of `seg` X planes.
// With `res` non-null, the last step's residual bit pattern lands in
// *res. Launches on `stream` and does not synchronise. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_f_temporal3d(const float* u, float* out, uint32_t* res,
                                 int64_t nx, int64_t ny, int64_t nz, int k,
                                 int block_z, int block_y, int rows, int seg,
                                 float a0, float cx, float cy, float cz,
                                 void* stream) {
  const int r_index = rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : -1;
  const int wy = block_y * rows;
  if (nx < 3 || ny < 3 || nz < 3 || k < 1 || k > 8 || seg < 1 ||
      r_index < 0 || block_y < 1 || block_z % 32 != 0 ||
      block_z <= 2 * k || wy <= 2 * k || block_z * block_y > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_z = (nz + block_z - 2 * k - 1) / (block_z - 2 * k);
  const int64_t tiles_y = (ny + wy - 2 * k - 1) / (wy - 2 * k);
  const int64_t blocks = tiles_z * tiles_y * ((nx + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = heat_t3d_smem_bytes(k, wy, block_z);
  const HeatFKernel kernel = kHeatFKernels[r_index][k - 1];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(block_z, block_y), smem, s>>>(
      u, out, res, nx, ny, nz, tiles_z, tiles_y, seg, a0, cx, cy, cz);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_f_temporal3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
