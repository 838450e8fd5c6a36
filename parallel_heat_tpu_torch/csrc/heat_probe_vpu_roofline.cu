// heat_probe_vpu_roofline — the issue-rate roofline of the card's FP32
// pipes and shared memory, measured with no device-memory traffic in the
// timed loop: one persistent block an SM sweeps its own tile of a stack,
// resident in two shared buffers, D times, in the tile loop's layout
// (heat_temporal.cuh: rows of 4-float groups, a lane a group).
//
// Replaces: tools/vpu_roofline.py::_build (pallas_call name
// "heat_probe_vpu_roofline", defined at :49, call :95), the TPU probe that
// swept a VMEM-resident (R, N) buffer D times in 64-row strips with FMA
// chains and the 5-point mix, to pin the vector unit's sustained rate.
//
// Bound on the H100: no HBM in the timed loop (the stack is loaded once
// and stored once, and the slope over D cancels both). A pass is bound by
// the larger of its FP32 instructions over 128 lanes x SMs x the SM clock
// and its shared bytes (each cell read once and written once) over 128
// bytes x SMs x the clock.
//
// Design: a block of 32 x W threads (one warp a row of lanes, as the tile
// loop) holds member blockIdx.x of an (S, R, N) float32 stack, N a
// multiple of 4, in two R x N shared buffers, and ping-pongs between them
// with a block barrier a pass; rows 0 and R-1 are never written. The
// launch asks for the most dynamic shared memory a block may take, so that
// one block and one only runs on an SM, and refuses to run otherwise
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Variants, each a
// compile-time instance:
//   - fma (kind 0), P = 1, 2, 4, 8 or 16: a lane loads a float4 of rows
//     1 .. R-2, applies x = __fmaf_rn(a, x, b) P times to each element and
//     stores it into the other buffer; a and b are kernel arguments, so the
//     compiler can neither fold nor reassociate the chain. At P = 1 the
//     shared-memory rate, as P grows the FFMA rate;
//   - muladd (kind 1): the same chain as __fadd_rn(__fmul_rn(a, x), b),
//     the rounding the combine uses;
//   - stencil (kind 2): the tile loop's own row walk, heat_rows with the
//     edge test (kEdge), at the plate's coefficients: D Jacobi steps of
//     each member with its ring pinned (the TPU probe wrapped its columns
//     by lane roll, an artefact of its layout);
//   - no_shuffle (kind 3): the walk with left and right taken as the cell
//     (kHeatLoopNoShuffle): no shuffles, no shared read by lanes 0 and 31;
//   - no_row_load (kind 4): up and down taken as the cell too
//     (kHeatLoopNoRowLoad): the combine's arithmetic floor (the walk still
//     loads each row once, as its cells);
//   - no_edge (kind 5): the walk without the edge test (kEdge false), every
//     cell updated, the ring too: the path of the tiles of E, E-uni and G
//     that lie inside the grid's interior.
// fma, muladd and stencil compute a function (their plain versions are in
// parallel_heat_tpu_torch/tools/vpu_roofline.py); no_shuffle,
// no_row_load and no_edge are measurements.

#include "heat_temporal.cuh"

constexpr int kRoofFma = 0;
constexpr int kRoofMulAdd = 1;
constexpr int kRoofStencil = 2;
constexpr int kRoofNoShuffle = 3;
constexpr int kRoofNoRowLoad = 4;
constexpr int kRoofNoEdge = 5;

// One pass of the fma or muladd chain over rows 1 .. rows-2 of src into
// dst: the block's threads take the float4s of those rows in turn.
template <int kKind, int kP>
__device__ __forceinline__ void heat_roof_chain(const float* src, float* dst,
                                                int rows, int cols, float a,
                                                float b) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int c4 = cols / 4;
  const float4* s = reinterpret_cast<const float4*>(src) + c4;
  float4* d = reinterpret_cast<float4*>(dst) + c4;
  const int n4 = (rows - 2) * c4;
  for (int f = tid; f < n4; f += threads) {
    float4 x = s[f];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if constexpr (kKind == kRoofFma) {
        x.x = __fmaf_rn(a, x.x, b);
        x.y = __fmaf_rn(a, x.y, b);
        x.z = __fmaf_rn(a, x.z, b);
        x.w = __fmaf_rn(a, x.w, b);
      } else {
        x.x = __fadd_rn(__fmul_rn(a, x.x), b);
        x.y = __fadd_rn(__fmul_rn(a, x.y), b);
        x.z = __fadd_rn(__fmul_rn(a, x.z), b);
        x.w = __fadd_rn(__fmul_rn(a, x.w), b);
      }
    }
    d[f] = x;
  }
}

template <int kKind, int kP>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_probe_vpu_roofline_kernel(const float* __restrict__ u,
                               float* __restrict__ out, int rows, int cols,
                               int passes, float a, float b, float a0,
                               float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int cells4 = rows * cols / 4;
  float* src = smem;
  float* dst = smem + rows * cols;
  const float4* in =
      reinterpret_cast<const float4*>(u) + blockIdx.x * (int64_t)cells4;
  // The member into both buffers: the ring rows are never written.
  for (int f = tid; f < cells4; f += threads) {
    const float4 v = in[f];
    reinterpret_cast<float4*>(src)[f] = v;
    reinterpret_cast<float4*>(dst)[f] = v;
  }
  __syncthreads();
  // This warp's run of rows of the walk (the stencil variants).
  const int run = (rows + blockDim.y - 1) / blockDim.y;
  const int t_r0 = max(static_cast<int>(threadIdx.y) * run, 1);
  const int t_r1 = min(static_cast<int>(threadIdx.y + 1) * run, rows - 1);
  uint32_t rmax = 0u;
  for (int p = 0; p < passes; ++p) {
    if constexpr (kKind == kRoofFma || kKind == kRoofMulAdd) {
      heat_roof_chain<kKind, kP>(src, dst, rows, cols, a, b);
    } else if constexpr (kKind == kRoofNoEdge) {
      heat_rows<false, false>(src, dst, nullptr, cols, 0, 0, 0, false, t_r0,
                              t_r1, 0, cols / 4, 0, 1, rows - 2, 1, cols - 2,
                              a0, cx, cy, rmax);
    } else {
      constexpr int kVar = kKind == kRoofStencil     ? kHeatLoopFull
                           : kKind == kRoofNoShuffle ? kHeatLoopNoShuffle
                                                     : kHeatLoopNoRowLoad;
      heat_rows<false, true, kVar>(src, dst, nullptr, cols, 0, 0, 0, false,
                                   t_r0, t_r1, 0, cols / 4, 0, 1, rows - 2,
                                   1, cols - 2, a0, cx, cy, rmax);
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  float4* o = reinterpret_cast<float4*>(out) + blockIdx.x * (int64_t)cells4;
  for (int f = tid; f < cells4; f += threads)
    o[f] = reinterpret_cast<const float4*>(src)[f];
}

// The instance of (kind, P): fma and muladd at P in {1, 2, 4, 8, 16}, the
// walk's variants at P = 0. Null for another pair.
typedef void (*HeatRoofKernel)(const float*, float*, int, int, int, float,
                               float, float, float, float);

static HeatRoofKernel heat_roof_kernel(int kind, int p) {
#define HEAT_ROOF_CHAINS(K)                                               \
  switch (p) {                                                            \
    case 1: return heat_probe_vpu_roofline_kernel<K, 1>;                  \
    case 2: return heat_probe_vpu_roofline_kernel<K, 2>;                  \
    case 4: return heat_probe_vpu_roofline_kernel<K, 4>;                  \
    case 8: return heat_probe_vpu_roofline_kernel<K, 8>;                  \
    case 16: return heat_probe_vpu_roofline_kernel<K, 16>;                \
    default: return nullptr;                                              \
  }
  switch (kind) {
    case kRoofFma:
      HEAT_ROOF_CHAINS(kRoofFma)
    case kRoofMulAdd:
      HEAT_ROOF_CHAINS(kRoofMulAdd)
    case kRoofStencil:
      return p == 0 ? heat_probe_vpu_roofline_kernel<kRoofStencil, 0>
                    : nullptr;
    case kRoofNoShuffle:
      return p == 0 ? heat_probe_vpu_roofline_kernel<kRoofNoShuffle, 0>
                    : nullptr;
    case kRoofNoRowLoad:
      return p == 0 ? heat_probe_vpu_roofline_kernel<kRoofNoRowLoad, 0>
                    : nullptr;
    case kRoofNoEdge:
      return p == 0 ? heat_probe_vpu_roofline_kernel<kRoofNoEdge, 0>
                    : nullptr;
    default:
      return nullptr;
  }
#undef HEAT_ROOF_CHAINS
}

// The instance's shared memory: the most a block may take, so that one
// block runs an SM (two rows x cols buffers must fit in it). Sets the
// kernel's attribute and *smem; returns a cudaError_t.
static int heat_roof_smem(HeatRoofKernel kernel, int rows, int cols,
                          size_t* smem) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The block barrier's and the residual's static shared memory.
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<size_t>(most) - attr.sharedSizeBytes;
  if (2 * sizeof(float) * static_cast<size_t>(rows) * cols > *smem)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem)));
}

// Thread blocks of instance (kind, p) that one SM holds at once under
// block_x x block_y threads and the launch's shared memory, into *blocks.
// Returns a cudaError_t.
extern "C" int heat_probe_vpu_roofline_occupancy(int kind, int p, int rows,
                                                 int cols, int block_x,
                                                 int block_y, int* blocks) {
  HeatRoofKernel kernel = heat_roof_kernel(kind, p);
  if (kernel == nullptr || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const int err = heat_roof_smem(kernel, rows, cols, &smem);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_x * block_y, smem));
}

// Variant (kind, p) on the (members, rows, cols) float32 stack `u` into
// `out` (distinct buffers on the current device): one block of block_x x
// block_y threads a member, `passes` passes. The chains take a and b, the
// walk a0, cx and cy. Refuses (cudaErrorInvalidValue) a shape the loop
// does not take (rows >= 3, cols a multiple of 4 and at least 8, 32 lanes
// by 1 to 16 warps, both buffers in one block's shared memory) and an
// occupancy other than one block an SM (cudaErrorInvalidConfiguration).
// Returns a cudaError_t.
extern "C" int heat_probe_vpu_roofline(int kind, int p, const float* u,
                                       float* out, int members, int rows,
                                       int cols, int passes, int block_x,
                                       int block_y, float a, float b,
                                       float a0, float cx, float cy,
                                       void* stream) {
  HeatRoofKernel kernel = heat_roof_kernel(kind, p);
  if (kernel == nullptr || members < 1 || rows < 3 || cols < 8 ||
      cols % 4 != 0 || passes < 0 || block_x != kHeatLanes || block_y < 1 ||
      block_y > kHeatMaxWarps ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  int err = heat_roof_smem(kernel, rows, cols, &smem);
  if (err != 0) return err;
  int blocks = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, block_x * block_y, smem));
  if (err != 0) return err;
  if (blocks != 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<members, dim3(block_x, block_y), smem,
           static_cast<cudaStream_t>(stream)>>>(u, out, rows, cols, passes,
                                                a, b, a0, cx, cy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_probe_vpu_roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
