// heat_g_band_fix — the band pass of the overlapped sharded round: the
// K-step values of each block's first and last K rows, from the block,
// its tail and the halo rows, with the residual of exactly those rows;
// every block of a round in one launch.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_band_fix_2d
// (pallas_call name "heat_g_band_fix_2d", defined at :2093, call :2231),
// in its float32 and bfloat16 storage forms (heat_g_band_fix_bf16).
//
// Bound on the H100, and the design: heat_g.cuh. The TPU kernel fixes one
// block's bands a call; here one launch takes a table of blocks (their
// pieces, output and origin), passed by value as a __grid_constant__
// parameter, so that a round's bands cost one launch, one residual slot
// zeroed once and no per-block host call. The bands are 2K of bx rows:
// at K = 8 the 8 blocks of 32768^2 on (2, 4) move 16.8 MB, 0.005 ms at
// HBM's rate, but a thread block runs K barrier-separated steps on a
// small tile, so the launch is bound by latency: one launch a block (2 x
// 35 thread blocks) took 0.0133 ms on half the SMs. The grid is (column
// tiles, 2 regions, blocks), each thread block a tile of K x TX output
// cells whose framed (3K) x (TX+2K) window reads the halo rows, the
// block's edge rows and the tail; at the default 112 x (32 x 2) the round
// is 1184 thread blocks, 9 an SM, one wave, so the loads of all tiles
// come first and the steps after: the load was 42% of the launch
// (measured against a variant that loads nothing). Where the geometry
// allows it (heat_g_band_row_load) each window row's core columns come
// 16 bytes at a time from the one piece that holds the row; elsewhere the
// fused form's per-cell load (heat_g_tile<kHeatGFused, false>). The steps
// are the family's register-blocked step loop. The rows land in the
// deferred bulk's output buffer in place (the TPU kernel returns them and
// the caller splices them in), so no splice copy is needed.

#include <atomic>

#include "heat_g.cuh"

// One block of the launch: its pieces as heat_g.cuh lays them out, the
// bulk's output it writes the bands into, and its origin in the grid
// (56 bytes; ops/stencil_kernels_block.py _BandEntry is the same layout).
// The bfloat16 launch takes the same table, its pointers bfloat16 buffers.
struct HeatGBandEntry {
  const float* u;
  const float* tail;
  const float* hn;
  const float* hs;
  float* out;
  int64_t row_off;
  int64_t col_off;
};

// The blocks a launch takes: 64 entries keep the kernel's parameters
// under 4 KB (ops/stencil_kernels_block.py BAND_TABLE).
constexpr int kHeatGBandTable = 64;
struct HeatGBandTable {
  HeatGBandEntry e[kHeatGBandTable];
};

// One tile of K x TX output cells of entry e's band region blockIdx.y
// (rows [0, K) or [bx-K, bx)), column tile blockIdx.x, with the row load:
// each of the (3K)-row window's rows lies in one piece (halo_n, u or
// halo_s), so its core columns inside the block are copied 16 bytes at a
// time from that piece's row, zero-filled for rows outside the grid; the
// 2K frame columns (and a ragged tile's end) per cell, as heat_g_tile's
// edge load. Takes blocks whose width and halo rows are multiples of 4
// floats (by % 4 == 0, K even) with 16-byte aligned pieces
// (heat_g_band_row_load). The steps are heat_g_tile's. Without kCopy it
// issues no copy at all: the steps alone on whatever shared memory holds,
// a measurement of the load's share, never the band.
template <bool kCopy>
__device__ __forceinline__ void heat_g_band_rows(
    const HeatGBandEntry& e, uint32_t* res, int64_t m, int64_t n, int64_t bx,
    int64_t by, int k, int tile_x, float a0, float cx, float cy) {
  extern __shared__ __align__(16) float smem[];
  const int sy = 3 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  float* src = smem + pad;
  const int64_t r0 = blockIdx.y == 0 ? 0 : bx - k;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * tile_x;
  const int64_t lr0 = r0 - k;
  const int64_t lc0 = c0 - k;
  const int64_t c_left = by - c0;
  const int core = static_cast<int>(c_left < tile_x ? c_left : tile_x);
  const int vecs = core / 4;
  const int rest = sw - 4 * vecs;  // the frame columns and a ragged end
  const int64_t w = by + 2 * k;    // a halo row
  for (int r = threadIdx.y; kCopy && r < sy; r += blockDim.y) {
    const int64_t lr = lr0 + r;
    const int64_t gi = e.row_off + lr;
    const bool row_in = gi >= 0 && gi < m;
    const float* row = lr < 0     ? e.hn + (lr + k) * w
                       : lr >= bx ? e.hs + (lr - bx) * w
                                  : e.u + lr * by;
    float* s = src + r * sx;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x)
      __pipeline_memcpy_async(s + k + 4 * v, row + c0 + 4 * v, 16,
                              row_in ? 0 : 16);
    for (int i = threadIdx.x; i < rest; i += blockDim.x) {
      const int c = i < k ? i : i + 4 * vecs;
      const int64_t lc = lc0 + c;
      const int64_t gj = e.col_off + lc;
      const float* p = row_in && gj >= 0 && gj < n && lc >= -k && lc < by + k
                           ? heat_g_src<kHeatGFused>(e.u, e.tail, e.hn, e.hs,
                                                     bx, by, k, lr, lc)
                           : nullptr;
      __pipeline_memcpy_async(s + c, p != nullptr ? p : e.u, 4,
                              p != nullptr ? 0 : 4);
    }
  }
  __pipeline_commit();
  heat_tile_steps(smem, smem + sy * sx, sx, pad, sy, sw, e.row_off + lr0,
                  e.col_off + lc0, m, n, k, k, 2 * k, k + core, a0, cx, cy,
                  e.out, lr0 * by + lc0, by, res, HeatCpAsyncWait());
}

// The loads (ops/stencil_kernels_block.py BAND_LOADS): the fused form's
// per-cell load (heat_g_tile<kHeatGFused, false>) for any block, the row
// load, and none (a measurement; bench_kernels --only band).
enum HeatGBandLoad { kHeatGBandCells = 0, kHeatGBandRows = 1,
                     kHeatGBandNone = 2 };

template <int kLoad>
__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_band_fix_kernel(const __grid_constant__ HeatGBandTable table,
                           uint32_t* res, int64_t m, int64_t n, int64_t bx,
                           int64_t by, int k, int64_t n_col_tiles,
                           int tile_x, float a0, float cx, float cy) {
  const HeatGBandEntry& e = table.e[blockIdx.z];
  if (kLoad == kHeatGBandCells)
    heat_g_tile<kHeatGFused, false>(e.u, e.tail, e.hn, e.hs, e.out, res, m,
                                    n, bx, by, e.row_off, e.col_off, k, 0,
                                    bx - k, k, n_col_tiles, k, tile_x, a0, cx,
                                    cy);
  else
    heat_g_band_rows<kLoad == kHeatGBandRows>(e, res, m, n, bx, by, k,
                                              tile_x, a0, cx, cy);
}

// The bfloat16 form's row load (heat_g.cuh heat_g_tile_bf16): each
// window row's core columns inside the block staged 16 bytes (8 cells) at
// a time into the second ping-pong buffer, zero-filled for rows outside
// the grid, and widened into the first once they have landed; the frame
// columns and a ragged tile's end widened cell by cell as they load. Takes
// blocks whose width and halo rows are multiples of 8 cells (K a multiple
// of 4), 16-byte aligned pieces and a tile width that is a multiple of 8.
__device__ __forceinline__ void heat_g_band_rows_bf16(
    const HeatGBandEntry& e, uint32_t* res, int64_t m, int64_t n, int64_t bx,
    int64_t by, int k, int tile_x, float a0, float cx, float cy) {
  using T = __nv_bfloat16;
  const T* u = reinterpret_cast<const T*>(e.u);
  const T* tail = reinterpret_cast<const T*>(e.tail);
  const T* hn = reinterpret_cast<const T*>(e.hn);
  const T* hs = reinterpret_cast<const T*>(e.hs);
  extern __shared__ __align__(16) float smem[];
  const int sy = 3 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  float* src = smem + pad;
  T* stage = reinterpret_cast<T*>(smem + sy * sx);  // the second buffer
  const int64_t r0 = blockIdx.y == 0 ? 0 : bx - k;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * tile_x;
  const int64_t lr0 = r0 - k;
  const int64_t lc0 = c0 - k;
  const int64_t c_left = by - c0;
  const int core = static_cast<int>(c_left < tile_x ? c_left : tile_x);
  const int vecs = core / 8;
  const int rest = sw - 8 * vecs;  // the frame columns and a ragged end
  const int64_t w = by + 2 * k;    // a halo row
  for (int r = threadIdx.y; r < sy; r += blockDim.y) {
    const int64_t lr = lr0 + r;
    const int64_t gi = e.row_off + lr;
    const bool row_in = gi >= 0 && gi < m;
    const T* row = lr < 0     ? hn + (lr + k) * w
                   : lr >= bx ? hs + (lr - bx) * w
                              : u + lr * by;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x)
      __pipeline_memcpy_async(stage + r * tile_x + 8 * v, row + c0 + 8 * v,
                              16, row_in ? 0 : 16);
    for (int i = threadIdx.x; i < rest; i += blockDim.x) {
      const int c = i < k ? i : i + 8 * vecs;
      const int64_t lc = lc0 + c;
      const int64_t gj = e.col_off + lc;
      const T* p = row_in && gj >= 0 && gj < n && lc >= -k && lc < by + k
                       ? heat_g_src<kHeatGFused>(u, tail, hn, hs, bx, by, k,
                                                 lr, lc)
                       : nullptr;
      src[r * sx + c] = p != nullptr ? heat_widen(*p) : 0.f;
    }
  }
  __pipeline_commit();
  heat_tile_steps<kHeatLoopFull, T, true>(
      smem, smem + sy * sx, sx, pad, sy, sw, e.row_off + lr0,
      e.col_off + lc0, m, n, k, k, 2 * k, k + core, a0, cx, cy,
      reinterpret_cast<T*>(e.out), lr0 * by + lc0, by, res, [=] {
        __pipeline_wait_prior(0);
        __syncthreads();
        heat_g_widen_stage(stage, tile_x, src + k, sx, sy, 2 * vecs);
        __syncthreads();
      });
}

// The bfloat16 band (the builder's dtype_name="bfloat16"): the per-cell
// load (heat_g_tile_bf16<kHeatGFused, false>) or the row load.
template <int kLoad>
__global__ void __launch_bounds__(kHeatMaxThreads)
    heat_g_band_fix_bf16_kernel(const __grid_constant__ HeatGBandTable table,
                                uint32_t* res, int64_t m, int64_t n,
                                int64_t bx, int64_t by, int k,
                                int64_t n_col_tiles, int tile_x, float a0,
                                float cx, float cy) {
  using T = __nv_bfloat16;
  const HeatGBandEntry& e = table.e[blockIdx.z];
  if (kLoad == kHeatGBandCells)
    heat_g_tile_bf16<kHeatGFused, false>(
        reinterpret_cast<const T*>(e.u), reinterpret_cast<const T*>(e.tail),
        reinterpret_cast<const T*>(e.hn), reinterpret_cast<const T*>(e.hs),
        reinterpret_cast<T*>(e.out), res, m, n, bx, by, e.row_off,
        e.col_off, k, 0, bx - k, k, n_col_tiles, k, tile_x, a0, cx, cy);
  else
    heat_g_band_rows_bf16(e, res, m, n, bx, by, k, tile_x, a0, cx, cy);
}

// Does the row load take these blocks: widths and halo rows of a multiple
// of `vec` cells (4 float32, 8 bfloat16, whose tile width must be one
// too), every piece it copies 16 bytes at a time 16-byte aligned
// (ops/hopper_params.py g_band_row_load is the geometry's half)?
static bool heat_g_band_row_load(const HeatGBandEntry* entries, int count,
                                 int64_t by, int k, int vec = 4,
                                 int tile_x = 0) {
  if (by % vec != 0 || (by + 2 * k) % vec != 0 || tile_x % vec != 0)
    return false;
  for (int i = 0; i < count; ++i) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(entries[i].u) |
                           reinterpret_cast<uintptr_t>(entries[i].hn) |
                           reinterpret_cast<uintptr_t>(entries[i].hs);
    if (bits % 16 != 0) return false;
  }
  return true;
}

// Devices whose kernel attribute is set (one bit each): the dynamic
// shared memory cap is raised once per device and process, to all the
// card lets a block take, so that no launch sets it again.
static std::atomic<uint64_t> heat_g_band_ready{0};

typedef void (*HeatGBandKernel)(HeatGBandTable, uint32_t*, int64_t, int64_t,
                                int64_t, int64_t, int, int64_t, int, float,
                                float, float);

static cudaError_t heat_g_band_allow(HeatGBandKernel kernel, int optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - static_cast<int>(attr.sharedSizeBytes));
}

static cudaError_t heat_g_band_prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (heat_g_band_ready.load() & bit)) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const HeatGBandKernel kernels[] = {
      heat_g_band_fix_kernel<kHeatGBandCells>,
      heat_g_band_fix_kernel<kHeatGBandRows>,
      heat_g_band_fix_kernel<kHeatGBandNone>,
      heat_g_band_fix_bf16_kernel<kHeatGBandCells>,
      heat_g_band_fix_bf16_kernel<kHeatGBandRows>};
  for (HeatGBandKernel kernel : kernels)
    if (err == cudaSuccess) err = heat_g_band_allow(kernel, optin);
  if (err == cudaSuccess) heat_g_band_ready.fetch_or(bit);
  return err;
}

// The launch of heat_g_band_fix (float32) or heat_g_band_fix_bf16: the
// checks, the load, the residual's reset and the chunks of the table.
template <bool kBf16>
static int heat_g_band_launch(const HeatGBandEntry* entries, int count,
                              int load, uint32_t* res, int64_t m, int64_t n,
                              int64_t bx, int64_t by, int k, int tile_x,
                              int block_x, int block_y, float a0, float cx,
                              float cy, void* stream) {
  if (entries == nullptr || count < 1 || m < 3 || n < 3 || k < 1 ||
      bx < 2 * k || by < k || !heat_loop_takes(k, tile_x, block_x, block_y))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    const HeatGBandEntry& e = entries[i];
    if (e.u == nullptr || e.tail == nullptr || e.hn == nullptr ||
        e.hs == nullptr || e.out == nullptr || e.row_off < 0 ||
        e.col_off < 0 || e.row_off + bx > m || e.col_off + by > n)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_col_tiles = (by + tile_x - 1) / tile_x;
  if (n_col_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = heat_g_band_prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool rows_fit =
      kBf16 ? heat_g_band_row_load(entries, count, by, k, 8, tile_x)
            : heat_g_band_row_load(entries, count, by, k);
  if (load < 0) load = rows_fit ? kHeatGBandRows : kHeatGBandCells;
  if (load > (kBf16 ? kHeatGBandRows : kHeatGBandNone) ||
      (load == kHeatGBandRows && !rows_fit))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = heat_loop_smem_bytes(k, k, tile_x);
  HeatGBandTable table{};
  for (int first = 0; first < count; first += kHeatGBandTable) {
    const int blocks =
        count - first < kHeatGBandTable ? count - first : kHeatGBandTable;
    for (int i = 0; i < blocks; ++i) table.e[i] = entries[first + i];
    const dim3 grid(static_cast<unsigned>(n_col_tiles), 2, blocks);
    const dim3 threads(block_x, block_y);
    if (kBf16 && load == kHeatGBandRows)
      heat_g_band_fix_bf16_kernel<kHeatGBandRows>
          <<<grid, threads, smem, s>>>(table, res, m, n, bx, by, k,
                                       n_col_tiles, tile_x, a0, cx, cy);
    else if (kBf16)
      heat_g_band_fix_bf16_kernel<kHeatGBandCells>
          <<<grid, threads, smem, s>>>(table, res, m, n, bx, by, k,
                                       n_col_tiles, tile_x, a0, cx, cy);
    else if (load == kHeatGBandRows)
      heat_g_band_fix_kernel<kHeatGBandRows><<<grid, threads, smem, s>>>(
          table, res, m, n, bx, by, k, n_col_tiles, tile_x, a0, cx, cy);
    else if (load == kHeatGBandCells)
      heat_g_band_fix_kernel<kHeatGBandCells><<<grid, threads, smem, s>>>(
          table, res, m, n, bx, by, k, n_col_tiles, tile_x, a0, cx, cy);
    else
      heat_g_band_fix_kernel<kHeatGBandNone><<<grid, threads, smem, s>>>(
          table, res, m, n, bx, by, k, n_col_tiles, tile_x, a0, cx, cy);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Rows [0, K) and [bx-K, bx) of K steps of each of the `count` bx x by
// blocks of `entries` (a host array), written into each entry's `out` in
// place; every block lies in the m x n grid at its origin and has at least
// 2K rows. `load` is a HeatGBandLoad, or -1: the row load where
// heat_g_band_row_load takes the blocks, else the per-cell load (the row
// load where it does not is refused). Launches in chunks of
// kHeatGBandTable blocks. With `res` non-null it is zeroed and the
// residual of all the bands lands in *res. Returns a cudaError_t: 0, or
// the reason the launch was refused.
extern "C" int heat_g_band_fix(const HeatGBandEntry* entries, int count,
                               int load, uint32_t* res, int64_t m, int64_t n,
                               int64_t bx, int64_t by, int k, int tile_x,
                               int block_x, int block_y, float a0, float cx,
                               float cy, void* stream) {
  return heat_g_band_launch<false>(entries, count, load, res, m, n, bx, by,
                                   k, tile_x, block_x, block_y, a0, cx, cy,
                                   stream);
}

// heat_g_band_fix on bfloat16 blocks (the table's pointers bfloat16
// buffers; the residual float32), by the per-cell or the row load (the
// row load's bfloat16 rule: heat_g_band_row_load at 8 cells), not "none".
extern "C" int heat_g_band_fix_bf16(const HeatGBandEntry* entries, int count,
                                    int load, uint32_t* res, int64_t m,
                                    int64_t n, int64_t bx, int64_t by, int k,
                                    int tile_x, int block_x, int block_y,
                                    float a0, float cx, float cy,
                                    void* stream) {
  return heat_g_band_launch<true>(entries, count, load, res, m, n, bx, by,
                                  k, tile_x, block_x, block_y, a0, cx, cy,
                                  stream);
}

extern "C" const char* heat_g_band_fix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
