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
// do not fit the card's shared memory at once. So the kernel has both of
// heat_a_resident's ideas and a member loop:
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
//   - a member whose framed tile fits one block (up to about 168^2)
//     needs no exchange and no grid-wide barrier: the launch is an
//     ordinary one of one block per member, with a one-cell frame (the
//     step reads a cell's four neighbours, also for the Dirichlet cells
//     it then copies) and all K steps in one group. The kernel is the
//     same, compiled without the cooperative parts (kCoop = false);
//   - the step is the column walk of heat_temporal.cuh
//     (heat_e_tile_step), as in heat_a_resident: global boundary cells
//     are copied, every step rounds to float32 with heat_combine's
//     operation order, the last step writes straight to the output and
//     reduces the member's
//     residual into res[b] (heat_common.cuh: atomicMax on the bit
//     pattern, NaN above +inf). So a member of a launch is bitwise a
//     launch of heat_a_resident, and of K launches of heat_b_step, on
//     that member alone, whatever the tiling.
// A member is at most a few million cells, so indices inside it are
// int32; the member's base and the group's planes are int64 offsets.

#include <cooperative_groups.h>

#include "heat_temporal.cuh"

namespace cg = cooperative_groups;

template <bool kCoop>
__global__ void __launch_bounds__(1024, 1)
heat_m_ensemble_kernel(const float* __restrict__ u, float* __restrict__ out,
                       float* xch, uint32_t* res, int batch, int m, int n,
                       int n_col_tiles, int tiles, int n_groups, int k,
                       int depth, int tile_y, int tile_x, float a0, float cx,
                       float cy) {
  extern __shared__ float smem[];
  const int d = depth;
  const int sx = tile_x + 2 * d;
  float* const buf0 = smem;
  float* const buf1 = smem + (tile_y + 2 * d) * sx;
  // This block's group and its tile of every member the group takes.
  const int group = static_cast<int>(blockIdx.x) / tiles;
  const int tile = static_cast<int>(blockIdx.x) % tiles;
  const int i0 = (tile / n_col_tiles) * tile_y;
  const int j0 = (tile % n_col_tiles) * tile_x;
  const int h = min(tile_y, m - i0);
  const int w = min(tile_x, n - j0);
  const int gy0 = i0 - d, gx0 = j0 - d;
  const int sh = h + 2 * d, sw = w + 2 * d;  // the framed tile

  // As in heat_a_resident: the member's interior in tile coordinates,
  // this thread's run of rows, and whether the framed tile reaches past
  // the interior (uniform across the block).
  const int r_lo = heat_clamp_local(1 - gy0, 0, sh);
  const int r_hi = heat_clamp_local(m - 2 - gy0, -1, sh - 1);
  const int c_lo = heat_clamp_local(1 - gx0, 0, sw);
  const int c_hi = heat_clamp_local(n - 2 - gx0, -1, sw - 1);
  const int run = (sh + blockDim.y - 1) / blockDim.y;
  const int t_r0 = threadIdx.y * run;
  const int t_r1 = min(t_r0 + run, sh);
  const bool edge = r_lo > 0 || r_hi < sh - 1 || c_lo > 0 || c_hi < sw - 1;
  const int64_t base = static_cast<int64_t>(gy0) * n + gx0;
  const int64_t cells = static_cast<int64_t>(m) * n;
  float* const planes = kCoop ? xch + 2 * cells * group : nullptr;
  int exchanges = 0;  // over the whole launch: picks the plane

  for (int b0 = 0; b0 < batch; b0 += n_groups) {
    const int b = b0 + group;
    // A group without a member in the last round keeps the barriers.
    const bool active = b < batch;
    const float* ub = u + (active ? cells * b : 0);
    float* ob = out + (active ? cells * b : 0);
    float* src = buf0;
    float* dst = buf1;
    if (active) {
      // The framed tile; cells outside the member are 0, and stay 0
      // (they are copied, never updated), in both buffers.
      for (int r = threadIdx.y; r < sh; r += blockDim.y) {
        const int gi = gy0 + r;
        for (int c = threadIdx.x; c < sw; c += blockDim.x) {
          const int gj = gx0 + c;
          const bool in = gi >= 0 && gi < m && gj >= 0 && gj < n;
          src[r * sx + c] = in ? ub[gi * n + gj] : 0.f;
          dst[r * sx + c] = 0.f;
        }
      }
    }
    __syncthreads();

    uint32_t rmax = 0u;
    for (int done = 0;;) {
      // A group of j steps. With tiles to exchange, j <= d steps from a
      // frame of depth d, step s updating the region j - s cells around
      // the tile, as in heat_a_resident. With one tile a member, all the
      // steps, each on the tile alone: beyond it lie only the zero frame.
      const int j = kCoop ? min(d, k - done) : k - done;
      if (active) {
        for (int s = 1; s <= j; ++s) {
          const int e = kCoop ? d - (j - s) : d;
          if (done + s == k) {
            heat_e_tile_step_any<true>(edge, src, ob, sx, base, n,
                                       max(t_r0, d), min(t_r1, d + h), d,
                                       d + w, r_lo, r_hi, c_lo, c_hi, a0, cx,
                                       cy, &rmax);
          } else {
            heat_e_tile_step_any<false>(edge, src, dst, sx, 0, sx,
                                        max(t_r0, e), min(t_r1, sh - e), e,
                                        sw - e, r_lo, r_hi, c_lo, c_hi, a0,
                                        cx, cy, nullptr);
            __syncthreads();
            float* t = src;
            src = dst;
            dst = t;
          }
        }
      }
      done += j;
      if (done == k) break;
      if constexpr (kCoop) {
        // Exchange, as in heat_a_resident: the tile's d-deep edge band
        // goes to the plane; after the barrier the frame comes back from
        // the neighbours' bands.
        float* plane = planes + (exchanges & 1) * cells;
        ++exchanges;
        if (active) {
          for (int r = threadIdx.y; r < h; r += blockDim.y) {
            const bool whole = r < d || r >= h - d || w <= 2 * d;
            const int cnt = whole ? w : 2 * d;
            for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
              const int c = whole || e < d ? e : w - 2 * d + e;
              __stcg(plane + (i0 + r) * n + (j0 + c),
                     src[(r + d) * sx + c + d]);
            }
          }
        }
        cg::this_grid().sync();
        if (active) {
          for (int r = threadIdx.y; r < sh; r += blockDim.y) {
            const int gi = gy0 + r;
            if (gi < 0 || gi >= m) continue;
            const bool whole = r < d || r >= d + h;
            const int cnt = whole ? sw : 2 * d;
            for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
              const int c = whole || e < d ? e : w + e;
              const int gj = gx0 + c;
              if (gj >= 0 && gj < n)
                src[r * sx + c] = __ldcg(plane + gi * n + gj);
            }
          }
        }
        __syncthreads();
      }
    }
    if (active && res != nullptr) heat_block_max(rmax, res + b);
    // The next member's load overwrites the buffers the last step read.
    __syncthreads();
  }
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
  const int threads = block_x * block_y;
  if (batch < 1 || batch > 0x7fffffffLL || m < 3 || n < 3 || k < 1 ||
      depth < 1 || tile_y < 1 || tile_x < 1 || n_groups < 1 ||
      n_groups > batch || block_x < 1 || block_y < 1 || threads % 32 != 0 ||
      threads > 1024 || 2 * m * n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_col_tiles = static_cast<int>((n + tile_x - 1) / tile_x);
  int tiles = n_col_tiles * static_cast<int>((m + tile_y - 1) / tile_y);
  const bool coop = tiles > 1;
  if (coop ? (k > depth && xch == nullptr) : n_groups != batch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(n_groups) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) *
                      static_cast<size_t>(tile_y + 2 * depth) *
                      static_cast<size_t>(tile_x + 2 * depth);
  const void* kernel =
      coop ? reinterpret_cast<const void*>(heat_m_ensemble_kernel<true>)
           : reinterpret_cast<const void*>(heat_m_ensemble_kernel<false>);
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

extern "C" const char* heat_m_ensemble_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
