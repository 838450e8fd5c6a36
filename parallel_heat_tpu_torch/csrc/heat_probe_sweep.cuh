// The shared-memory sweep of the two sweep probes (heat_probe_sweep_width.cu,
// the width ladder; heat_probe_store_align.cu, the store offsets): one
// block an SM holds its member of a stack in two shared buffers and
// ping-pongs a band of rows between them, with no device memory in the
// timed loop.
//
// The function, on each (R, w) float32 member of an (S, R, w) stack: both
// buffers start as the member; then D / 2 pairs of sweeps (2 floor(D/2)
// sweeps: the TPU probes' fori_loop over D // 2 pairs), each of rows
// [lo, lo + rows) of one buffer into the other,
//     new = (0.6 C + 0.1 (U + D)) + 0.1 (L + R),
// every operation rounded in float32 in that order (__fmul_rn, __fadd_rn:
// no FMA is contracted), L and R periodic along the row; the first
// buffer is the result. Rows outside the band are the input, bitwise.
// (The TPU probes start only their output as the input, so their second
// sweep of a pair reads two scratch rows, lo - 1 and lo + rows, that were
// never written; here both buffers start as the input, which defines
// them.)
//
// The walk is the tile loop's layout (heat_temporal.cuh heat_rows): a
// block of 32 x W threads, each warp a run of rows of the band, each lane
// a group of kV adjacent columns of its row in registers, the rows above,
// at and below it, neighbours by shuffle, in passes of 32 groups. kV = 4
// (float4 loads and stores) where the row's width is a multiple of 4
// floats, so that every row starts on 16 bytes; kV = 1 (one float a lane)
// otherwise: no 16-byte access is aligned there. Lane 0 reads the cell
// left of its pass, and the pass's last active lane the cell right of it,
// from shared memory (both wrap at the row's ends); every lane reads both,
// two broadcasts a row.

#pragma once

#include "heat_temporal.cuh"

__device__ __forceinline__ float heat_sweep_cell(float c, float up,
                                                 float down, float left,
                                                 float right) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.6f, c),
                             __fmul_rn(0.1f, __fadd_rn(up, down))),
                   __fmul_rn(0.1f, __fadd_rn(left, right)));
}

template <int kV>
struct HeatSweepVec;
template <>
struct HeatSweepVec<4> {
  typedef float4 T;
  static __device__ __forceinline__ float first(const float4& v) {
    return v.x;
  }
  static __device__ __forceinline__ float last(const float4& v) {
    return v.w;
  }
  static __device__ __forceinline__ float4 sweep(const float4& c,
                                                 const float4& u,
                                                 const float4& d, float l,
                                                 float r) {
    return make_float4(heat_sweep_cell(c.x, u.x, d.x, l, c.y),
                       heat_sweep_cell(c.y, u.y, d.y, c.x, c.z),
                       heat_sweep_cell(c.z, u.z, d.z, c.y, c.w),
                       heat_sweep_cell(c.w, u.w, d.w, c.z, r));
  }
};
template <>
struct HeatSweepVec<1> {
  typedef float T;
  static __device__ __forceinline__ float first(float v) { return v; }
  static __device__ __forceinline__ float last(float v) { return v; }
  static __device__ __forceinline__ float sweep(float c, float u, float d,
                                                float l, float r) {
    return heat_sweep_cell(c, u, d, l, r);
  }
};

// One sweep of this warp's rows [r0, r1) of src into dst, rows of w floats
// (w a multiple of kV); r0 >= 1 and r1 < the buffer's rows.
template <int kV>
__device__ __forceinline__ void heat_sweep_rows(const float* src, float* dst,
                                                int w, int r0, int r1) {
  typedef HeatSweepVec<kV> V;
  typedef typename V::T T;
  if (r0 >= r1) return;  // uniform across the warp
  const int lane = static_cast<int>(threadIdx.x);
  const int groups = w / kV;
  for (int gb = 0; gb < groups; gb += kHeatLanes) {
    const int g = gb + lane;
    const int gl = min(g, groups - 1);
    const int last = min(kHeatLanes, groups - gb) - 1;
    const int lcol = gb == 0 ? w - 1 : kV * gb - 1;
    const int rcol = kV * (gb + last + 1) == w ? 0 : kV * (gb + last + 1);
    const T* p = reinterpret_cast<const T*>(src) + gl;
    const int row = w / kV;  // a row, in groups
    T up = p[(r0 - 1) * row];
    T cc = p[r0 * row];
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const T dn = p[(r + 1) * row];
      const float el = src[r * w + lcol];
      const float er = src[r * w + rcol];
      float lf = __shfl_up_sync(kHeatFullWarp, V::last(cc), 1);
      float rt = __shfl_down_sync(kHeatFullWarp, V::first(cc), 1);
      if (lane == 0) lf = el;
      if (lane == last) rt = er;
      const T v = V::sweep(cc, up, dn, lf, rt);
      if (g < groups) reinterpret_cast<T*>(dst)[r * row + g] = v;
      up = cc;
      cc = dn;
    }
  }
}

// Member blockIdx.x of the (S, R, w) stack `u` into `out`: both buffers
// from the member, `pairs` pairs of sweeps of rows [lo, lo + rows), the
// first buffer out. Every thread of the block must call it.
template <int kV>
__device__ __forceinline__ void heat_sweep_member(const float* __restrict__ u,
                                                  float* __restrict__ out,
                                                  int rows_total, int w,
                                                  int lo, int rows,
                                                  int pairs) {
  typedef typename HeatSweepVec<kV>::T T;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int cells = rows_total * w / kV;  // in groups
  float* a = smem;
  float* b = smem + rows_total * w;
  const T* in = reinterpret_cast<const T*>(u) + blockIdx.x * (int64_t)cells;
  for (int f = tid; f < cells; f += threads) {
    const T v = in[f];
    reinterpret_cast<T*>(a)[f] = v;
    reinterpret_cast<T*>(b)[f] = v;
  }
  __syncthreads();
  const int run = (rows + blockDim.y - 1) / blockDim.y;
  const int t_r0 = lo + static_cast<int>(threadIdx.y) * run;
  const int t_r1 = min(t_r0 + run, lo + rows);
  for (int p = 0; p < pairs; ++p) {
    heat_sweep_rows<kV>(a, b, w, t_r0, t_r1);
    __syncthreads();
    heat_sweep_rows<kV>(b, a, w, t_r0, t_r1);
    __syncthreads();
  }
  T* o = reinterpret_cast<T*>(out) + blockIdx.x * (int64_t)cells;
  for (int f = tid; f < cells; f += threads)
    o[f] = reinterpret_cast<const T*>(a)[f];
}

// The kernel of a sweep probe at vector width kV (as heat_sweep_member).
typedef void (*HeatSweepKernel)(const float*, float*, int, int, int, int,
                                int);

// Thread blocks of `kernel` that one SM holds at once under block_x x
// block_y threads and the most dynamic shared memory a block may take,
// into *blocks; that shared memory into *smem (and the kernel's
// attribute). Refuses (cudaErrorInvalidValue) a pair of rows_total x w
// buffers over it. Returns a cudaError_t.
inline int heat_sweep_occupancy(HeatSweepKernel kernel, int rows_total,
                                int w, int block_x, int block_y,
                                size_t* smem, int* blocks) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<size_t>(most) - attr.sharedSizeBytes;
  if (2 * sizeof(float) * static_cast<size_t>(rows_total) * w > *smem)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, block_x * block_y, *smem));
}

// The launch of a sweep probe's kernel, `vec4` (w % 4 == 0) or `scalar`:
// `sweeps` sweeps (2 floor(sweeps/2)) of rows [lo, lo + rows) of every
// member of the (members, rows_total, w) float32 stack `u` into `out`
// (distinct buffers on the current device), one block of block_x x
// block_y threads a member, one block an SM: the launch asks for a
// block's whole shared memory. Refuses (cudaErrorInvalidValue) a band
// that leaves no row above or below it, w < 4, a thread block other than
// 32 lanes by 1 to 16 warps, unaligned stacks and a pair over a block's
// shared memory; and (cudaErrorInvalidConfiguration) an occupancy other
// than one block an SM. Returns a cudaError_t.
inline int heat_sweep_launch(HeatSweepKernel vec4, HeatSweepKernel scalar,
                             const float* u, float* out, int members,
                             int rows_total, int w, int lo, int rows,
                             int sweeps, int block_x, int block_y,
                             void* stream) {
  if (members < 1 || w < 4 || lo < 1 || rows < 1 ||
      lo + rows > rows_total - 1 || sweeps < 0 || block_x != kHeatLanes ||
      block_y < 1 || block_y > kHeatMaxWarps ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HeatSweepKernel kernel = w % 4 == 0 ? vec4 : scalar;
  size_t smem = 0;
  int blocks = 0;
  const int err = heat_sweep_occupancy(kernel, rows_total, w, block_x,
                                       block_y, &smem, &blocks);
  if (err != 0) return err;
  if (blocks != 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<members, dim3(block_x, block_y), smem,
           static_cast<cudaStream_t>(stream)>>>(u, out, rows_total, w, lo,
                                                rows, sweeps / 2);
  return static_cast<int>(cudaGetLastError());
}
