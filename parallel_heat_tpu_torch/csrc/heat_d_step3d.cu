// heat_d_step3d — one 7-point Jacobi step over a 3D grid, with the
// interior max-norm residual fused into the same pass.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_slab_kernel_3d
// (pallas_call name "heat_d_slab_3d", defined at :3708, call :3791).
//
// Bound on the H100: memory. A step reads the grid once and writes it
// once, 8 B per cell, against 10 float32 operations per cell for the
// combine and 2 for the residual: at 3.35 TB/s a 512^3 step needs at
// least 2*512^3*4 B / 3.35 TB/s = 0.32 ms of HBM traffic and 0.024 ms of
// arithmetic at 67 TFLOP/s.
//
// Design: the TPU kernel DMAs (SX, TY, whole-Z) slabs into VMEM, takes
// its Z neighbours from lane rolls and masks the faces with a per-cell
// select, carrying the residual from slab to slab in SMEM because its
// grid runs in order on one core. Here Z is the contiguous axis, so
//   - a thread block is a (block_y, block_z) tile of (y, z) columns, a
//     warp 32 neighbouring z, and each thread walks `planes` consecutive
//     X planes of its column, keeping x-1, x and x+1 in registers: a warp
//     reads each plane's row as whole 128-byte lines, and the Y and Z
//     neighbours come from lines its block (or the one beside it) reads
//     anyway, through L1 and L2, so HBM sees each cell read about once;
//   - a thread issues the loads of kDGroup planes before it computes
//     any: with one plane at a time the SMs kept too few reads in flight
//     to cover HBM's latency (1.6 TB/s at 512^3, PERF.md);
//   - each block reduces its own partial residual and merges it with one
//     atomicMax into a 4-byte scalar the entry point zeroes
//     (heat_common.cuh);
//   - the six Dirichlet faces are copied from the input, never computed.
// Any nx, ny, nz >= 3 works (ragged tiles are masked); offsets are int64,
// so grids past 2^31 cells index safely.
//
// Storage precision: heat_d_step3d_bf16 steps a bfloat16 grid, 4 B a cell
// over HBM, in float32 arithmetic (heat_common.cuh): a warp reads 64-byte
// rows, one z cell a lane, as the float32 kernel does.

#include <type_traits>

#include "heat_common.cuh"

// Planes a thread loads before it computes any of them: their loads are
// independent, so each thread keeps kDGroup planes' reads in flight.
constexpr int kDGroup = 4;

// A block's cells of the step, at storage type T (float32, or bfloat16:
// each load widened exactly, each updated cell rounded, each copied one
// narrowed exactly, heat_common.cuh), and its residual into *res.
template <typename T>
__device__ __forceinline__ void heat_d_cells(
    const T* __restrict__ u, T* __restrict__ out, uint32_t* res, int64_t nx,
    int64_t ny, int64_t nz, int64_t tiles_z, int64_t tiles_y, int planes,
    float a0, float cx, float cy, float cz) {
  const int64_t b = blockIdx.x;
  const int64_t tz = b % tiles_z;
  const int64_t ty = (b / tiles_z) % tiles_y;
  const int64_t tx = b / tiles_z / tiles_y;
  const int64_t z = tz * blockDim.x + threadIdx.x;
  const int64_t y = ty * blockDim.y + threadIdx.y;
  const int64_t x0 = tx * planes;
  uint32_t rmax = 0u;
  if (z < nz && y < ny && x0 < nx) {
    const int64_t plane = ny * nz;
    const int64_t x_end = x0 + planes < nx ? x0 + planes : nx;
    const bool yz_in = y >= 1 && y <= ny - 2 && z >= 1 && z <= nz - 2;
    int64_t idx = (x0 * ny + y) * nz + z;
    float xm = x0 >= 1 ? heat_widen(u[idx - plane]) : 0.f;
    float c = heat_widen(u[idx]);
    for (int64_t x = x0; x < x_end; x += kDGroup, idx += kDGroup * plane) {
      float xp[kDGroup], ym[kDGroup], yp[kDGroup], zm[kDGroup], zp[kDGroup];
      bool in[kDGroup];
#pragma unroll
      for (int i = 0; i < kDGroup; ++i) {
        const int64_t at = idx + i * plane;
        in[i] = yz_in && x + i >= 1 && x + i <= nx - 2 && x + i < x_end;
        xp[i] = x + i + 1 < nx && x + i < x_end ? heat_widen(u[at + plane])
                                                : 0.f;
        ym[i] = in[i] ? heat_widen(u[at - nz]) : 0.f;
        yp[i] = in[i] ? heat_widen(u[at + nz]) : 0.f;
        zm[i] = in[i] ? heat_widen(u[at - 1]) : 0.f;
        zp[i] = in[i] ? heat_widen(u[at + 1]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kDGroup; ++i) {
        if (x + i < x_end) {
          float v = c;
          if (in[i]) {
            v = heat_combine3(c, xm, xp[i], ym[i], yp[i], zm[i], zp[i], a0,
                              cx, cy, cz);
            rmax = max(rmax, heat_diff_bits(v, c));
          }
          heat_store(out + (idx + i * plane), v, in[i]);
          xm = c;
          c = xp[i];
        }
      }
    }
  }
  heat_block_max(rmax, res);
}

__global__ void __launch_bounds__(1024)
heat_d_step3d_kernel(const float* __restrict__ u, float* __restrict__ out,
                     uint32_t* res, int64_t nx, int64_t ny, int64_t nz,
                     int64_t tiles_z, int64_t tiles_y, int planes, float a0,
                     float cx, float cy, float cz) {
  heat_d_cells(u, out, res, nx, ny, nz, tiles_z, tiles_y, planes, a0, cx, cy,
               cz);
}

// The largest thread block of kernel D's bfloat16 form: its widened loads
// take more than the 64 registers a 1024-thread bound leaves (ptxas
// spilled 16 bytes there), so it is bound at 512 threads, up to 128
// registers. The default block (hopper_params.d_block) is 128 threads.
constexpr int kDBf16MaxThreads = 512;

// Kernel D on a bfloat16 grid: a kernel of its own, so that the float32
// kernel keeps its name and machine code.
__global__ void __launch_bounds__(kDBf16MaxThreads)
heat_d_step3d_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                          __nv_bfloat16* __restrict__ out, uint32_t* res,
                          int64_t nx, int64_t ny, int64_t nz,
                          int64_t tiles_z, int64_t tiles_y, int planes,
                          float a0, float cx, float cy, float cz) {
  heat_d_cells(u, out, res, nx, ny, nz, tiles_z, tiles_y, planes, a0, cx, cy,
               cz);
}

template <typename T>
static int heat_d_launch(const T* u, T* out, uint32_t* res, int64_t nx,
                         int64_t ny, int64_t nz, int block_z, int block_y,
                         int planes, float a0, float cx, float cy, float cz,
                         void* stream) {
  const int threads = block_z * block_y;
  const int max_threads =
      std::is_same<T, float>::value ? 1024 : kDBf16MaxThreads;
  if (nx < 3 || ny < 3 || nz < 3 || block_z < 1 || block_y < 1 ||
      planes < 1 || threads % 32 != 0 || threads > max_threads ||
      res == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_z = (nz + block_z - 1) / block_z;
  const int64_t tiles_y = (ny + block_y - 1) / block_y;
  const int64_t blocks = tiles_z * tiles_y * ((nx + planes - 1) / planes);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks)), block(block_z, block_y);
  if constexpr (std::is_same<T, float>::value)
    heat_d_step3d_kernel<<<grid, block, 0, s>>>(
        u, out, res, nx, ny, nz, tiles_z, tiles_y, planes, a0, cx, cy, cz);
  else
    heat_d_step3d_bf16_kernel<<<grid, block, 0, s>>>(
        u, out, res, nx, ny, nz, tiles_z, tiles_y, planes, a0, cx, cy, cz);
  return static_cast<int>(cudaGetLastError());
}

// One step of the nx x ny x nz float32 grid `u` (z contiguous) into `out`
// (distinct buffers, both on the current device), with the residual's
// bit pattern in *res. A block is block_z x block_y threads, each
// walking `planes` X planes. Launches on `stream` and does not
// synchronise. Returns a cudaError_t: 0, or the reason the launch was
// refused.
extern "C" int heat_d_step3d(const float* u, float* out, uint32_t* res,
                             int64_t nx, int64_t ny, int64_t nz, int block_z,
                             int block_y, int planes, float a0, float cx,
                             float cy, float cz, void* stream) {
  return heat_d_launch(u, out, res, nx, ny, nz, block_z, block_y, planes, a0,
                       cx, cy, cz, stream);
}

// heat_d_step3d on a bfloat16 grid `u` into the bfloat16 `out` (blocks
// of at most kDBf16MaxThreads threads): the step computes in float32,
// rounds its updated cells to bfloat16 and copies the six faces bit for
// bit; the residual is the float32 update against the float32 of the cell
// it read, before rounding. The counterpart of _build_slab_kernel_3d at
// dtype bfloat16.
extern "C" int heat_d_step3d_bf16(const __nv_bfloat16* u, __nv_bfloat16* out,
                                  uint32_t* res, int64_t nx, int64_t ny,
                                  int64_t nz, int block_z, int block_y,
                                  int planes, float a0, float cx, float cy,
                                  float cz, void* stream) {
  return heat_d_launch(u, out, res, nx, ny, nz, block_z, block_y, planes, a0,
                       cx, cy, cz, stream);
}

extern "C" const char* heat_d_step3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
