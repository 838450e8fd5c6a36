// heat_m_ensemble — K Jacobi steps of each of B member grids in one
// launch, every member resident in shared memory while it is stepped,
// and each member's residual of the last step.
//
// Replaces: parallel_heat_tpu/ops/batched.py::_build_ensemble_vmem_multistep
// (pallas_call name "heat_m_ens_vmem_multistep", defined at :97, call
// :188).
//
// Bound on the H100: a launch reads the (B, m, n) stack once and writes
// it once for all K steps, 8 B per cell over HBM; the arithmetic is 7
// float32 operations per cell-step. For 64 members of 512^2 and K = 20
// that is 134 MB, 0.04 ms, against 2.3 G operations, 0.035 ms: neither
// holds it. What costs is what costs heat_a_resident: the instructions
// of each thread's cells per step, and the barriers.
//
// Design: the TPU kernel runs a grid over the members, one member per
// grid instance, each the whole of kernel A on a member that fits the
// core's VMEM. Here a member of a realistic size (512^2 float32 is
// 1 MB, two buffers 2 MB) does not fit one SM's 227 KB, and 64 of them
// do not fit the card's shared memory at once. So the kernel is
// heat_a_resident's step phase (heat_a.cuh: tile, frame, load, groups of
// D steps through the register-blocked tile loop of heat_temporal.cuh,
// exchange) with a member loop:
//   - a member is cut into `tiles` tiles. The blocks form groups of
//     `tiles` blocks; a group holds one member resident exactly as
//     heat_a_resident holds its grid (a tile and its D-deep frame in two
//     ping-pong shared buffers, steps in groups of D on the shrinking
//     valid region, the tile's edge bands exchanged through a global
//     plane every D steps), and walks the members g, g + G, g + 2G, ...
//     for G groups;
//   - the launch is cooperative and the barrier of an exchange is the
//     whole grid's: every member runs the same K, so every group reaches
//     the same barriers in the same order, and a group whose last round
//     has no member left only keeps the barriers' count. The exchange
//     planes are per group, two each, and alternate over the whole
//     launch, not per member: a plane is rewritten two exchanges later,
//     after every block has passed the barrier that ends its reads;
//   - a member whose framed tile fits one block (up to about 164^2)
//     needs no exchange and no grid-wide barrier: the launch is an
//     ordinary one of one block per member, with a one-cell frame (the
//     step reads a cell's four neighbours, also for the Dirichlet cells
//     it then copies), one step a group and nothing between groups, its
//     frame lying wholly outside the member. The kernel is the same,
//     compiled without the cooperative parts (kCoop = false);
//   - global boundary cells are copied, every step rounds to float32
//     with heat_combine's operation order, the last step writes straight
//     to the output and reduces the member's residual into res[b]
//     (heat_common.cuh: atomicMax on the bit pattern, NaN above +inf). So
//     a member of a launch is bitwise a launch of heat_a_resident, and of
//     K launches of heat_b_step, on that member alone, whatever the
//     tiling.
// A member is at most a few million cells, so indices inside it are
// int32; the member's base and the group's planes are int64 offsets.
//
// Storage precision: heat_m_ensemble_bf16 takes bfloat16 members, 4 B a
// cell over HBM. Each member's tile is widened as it lands (heat_a_load),
// every level rounds to bfloat16 in the tile loop, and the buffers and
// exchange planes stay float32, exactly as heat_a_resident_bf16 does it,
// so a member is bitwise that kernel on the member alone.

#include "heat_a.cuh"

// A block's work: its tile of every member its group takes, at storage
// type T (bfloat16: each level rounded, heat_a.cuh "Storage precision").
template <bool kCoop, typename T>
__device__ __forceinline__ void heat_m_block(
    const T* __restrict__ u, T* __restrict__ out, float* xch, uint32_t* res,
    int batch, int m, int n, int n_col_tiles, int tiles, int n_groups, int k,
    int depth, int tile_y, int tile_x, float a0, float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  // This block's group and its tile of every member the group takes.
  const int group = static_cast<int>(blockIdx.x) / tiles;
  const HeatATile t =
      heat_a_tile(m, n, static_cast<int>(blockIdx.x) % tiles, n_col_tiles,
                  tile_y, tile_x, depth);
  float* const buf0 = smem;
  float* const buf1 = smem + (tile_y + 2 * depth) * t.sx;
  const int64_t cells = static_cast<int64_t>(m) * n;
  float* const planes = kCoop ? xch + 2 * cells * group : nullptr;
  int exchanges = 0;  // over the whole launch: picks the plane

  for (int b0 = 0; b0 < batch; b0 += n_groups) {
    const int b = b0 + group;
    if (b < batch) {
      heat_a_load(u + cells * b, buf0, t, m, n);
      uint32_t rmax = 0u;
      heat_a_steps<kHeatAFull, kHeatLoopFull, T,
                   !std::is_same<T, float>::value>(
          buf0, buf1, t, m, n, k, out + cells * b, a0, cx, cy, rmax,
          [&](float* s, int) {
            if constexpr (kCoop) {
              float* plane = planes + (exchanges & 1) * cells;
              ++exchanges;
              heat_a_band_out(s, t, plane, n);
              cg::this_grid().sync();
              heat_a_frame_in(s, t, plane, m, n);
            }
          });
      if (res != nullptr) heat_block_max(rmax, res + b);
    } else if constexpr (kCoop) {
      // A group without a member in the last round keeps the barriers.
      for (int x = 0; x < (k - 1) / depth; ++x) {
        ++exchanges;
        cg::this_grid().sync();
      }
    }
    // The next member's load overwrites the buffers the last step read.
    __syncthreads();
  }
}

template <bool kCoop>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_m_ensemble_kernel(const float* __restrict__ u, float* __restrict__ out,
                       float* xch, uint32_t* res, int batch, int m, int n,
                       int n_col_tiles, int tiles, int n_groups, int k,
                       int depth, int tile_y, int tile_x, float a0, float cx,
                       float cy) {
  heat_m_block<kCoop, float>(u, out, xch, res, batch, m, n, n_col_tiles,
                             tiles, n_groups, k, depth, tile_y, tile_x, a0,
                             cx, cy);
}

// Kernel M on bfloat16 members: a kernel of its own, so that the float32
// kernel keeps its name and machine code.
template <bool kCoop>
__global__ void __launch_bounds__(kHeatMaxThreads, 1)
heat_m_ensemble_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                            __nv_bfloat16* __restrict__ out, float* xch,
                            uint32_t* res, int batch, int m, int n,
                            int n_col_tiles, int tiles, int n_groups, int k,
                            int depth, int tile_y, int tile_x, float a0,
                            float cx, float cy) {
  heat_m_block<kCoop, __nv_bfloat16>(u, out, xch, res, batch, m, n,
                                     n_col_tiles, tiles, n_groups, k, depth,
                                     tile_y, tile_x, a0, cx, cy);
}

template <typename T>
static int heat_m_launch(const T* u, T* out, float* xch, uint32_t* res,
                         int64_t batch, int64_t m, int64_t n, int k,
                         int depth, int tile_y, int tile_x, int n_groups,
                         int block_x, int block_y, float a0, float cx,
                         float cy, void* stream) {
  if (batch < 1 || batch > 0x7fffffffLL || m < 3 || n < 3 || k < 1 ||
      depth < 1 || n_groups < 1 || n_groups > batch ||
      !heat_a_takes(n, tile_y, tile_x, block_x, block_y) ||
      2 * m * n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_col_tiles = static_cast<int>((n + tile_x - 1) / tile_x);
  int tiles = n_col_tiles * static_cast<int>((m + tile_y - 1) / tile_y);
  const bool coop = tiles > 1;
  if (coop ? (k > depth && xch == nullptr) : n_groups != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(n_groups) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = heat_loop_smem_bytes(depth, tile_y, tile_x);
  const void* kernel;
  if constexpr (std::is_same<T, float>::value)
    kernel = coop
                 ? reinterpret_cast<const void*>(heat_m_ensemble_kernel<true>)
                 : reinterpret_cast<const void*>(
                       heat_m_ensemble_kernel<false>);
  else
    kernel = coop ? reinterpret_cast<const void*>(
                        heat_m_ensemble_bf16_kernel<true>)
                  : reinterpret_cast<const void*>(
                        heat_m_ensemble_bf16_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t) * batch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int bi = static_cast<int>(batch), mi = static_cast<int>(m),
      ni = static_cast<int>(n);
  void* args[] = {&u,     &out,      &xch, &res,   &bi,     &mi,
                  &ni,    &n_col_tiles, &tiles, &n_groups, &k, &depth,
                  &tile_y, &tile_x,  &a0,  &cx,    &cy};
  const dim3 grid(static_cast<unsigned>(n_groups * tiles));
  const dim3 block(block_x, block_y);
  if (coop)
    err = cudaLaunchCooperativeKernel(kernel, grid, block, args, smem, s);
  else
    err = cudaLaunchKernel(kernel, grid, block, args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K steps of each of the `batch` m x n float32 members of `u` into `out`
// (distinct contiguous (batch, m, n) buffers on the current device), each
// member cut into tile_y x tile_x tiles with a `depth`-deep frame.
//   - More than one tile a member: one cooperative launch of `n_groups`
//     groups of one block per tile (n_groups * tiles blocks, which must
//     all fit on the card at once), exchanging the halo every `depth`
//     steps through `xch`, scratch of n_groups * 2 * m * n floats
//     (unused, and may be null, when k <= depth).
//   - One tile a member: an ordinary launch of one block per member;
//     `n_groups` must equal `batch`, `depth` must be at least 1, and
//     `xch` is unused.
// With `res` non-null, member b's last-step residual bit pattern lands in
// res[b]. Launches on `stream` and does not synchronise. Returns a
// cudaError_t: 0, or the reason the launch was refused.
extern "C" int heat_m_ensemble(const float* u, float* out, float* xch,
                               uint32_t* res, int64_t batch, int64_t m,
                               int64_t n, int k, int depth, int tile_y,
                               int tile_x, int n_groups, int block_x,
                               int block_y, float a0, float cx, float cy,
                               void* stream) {
  return heat_m_launch(u, out, xch, res, batch, m, n, k, depth, tile_y,
                       tile_x, n_groups, block_x, block_y, a0, cx, cy,
                       stream);
}

// heat_m_ensemble on bfloat16 members `u` into the bfloat16 `out`: every
// level of every member rounded to bfloat16 as heat_a_resident_bf16
// rounds it (the same step code), so a member of a launch is bitwise a
// launch of heat_a_resident_bf16 on that member alone. The shared
// buffers and `xch` hold float32 (bfloat16 values), so the launch plan is
// the float32 one. The counterpart of _build_ensemble_vmem_multistep at
// dtype bfloat16.
extern "C" int heat_m_ensemble_bf16(const __nv_bfloat16* u,
                                    __nv_bfloat16* out, float* xch,
                                    uint32_t* res, int64_t batch, int64_t m,
                                    int64_t n, int k, int depth, int tile_y,
                                    int tile_x, int n_groups, int block_x,
                                    int block_y, float a0, float cx,
                                    float cy, void* stream) {
  return heat_m_launch(u, out, xch, res, batch, m, n, k, depth, tile_y,
                       tile_x, n_groups, block_x, block_y, a0, cx, cy,
                       stream);
}

extern "C" const char* heat_m_ensemble_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
