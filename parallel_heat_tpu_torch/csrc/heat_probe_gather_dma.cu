// heat_probe_gather_dma — what a tile's load costs alone, with no compute:
// a dense box against a tile gathered from two arrays, by TMA and by
// 16-byte cp.async.
//
// Replaces: tools/probe_gather_dma.py::build_probe (pallas_call name
// "heat_probe_gather_dma", defined at :40, call :86), the TPU probe that
// timed kernel E's dense strip windows against kernel G-fuse's gathered
// ones (a core from the grid, a tail from a second array, into one slot),
// double-buffered, touching one element a strip.
//
// Bound on the H100: the arrays' bytes that the windows cover, each read
// once, over HBM's 3.35 TB/s. Windows overlap by their frames, so a
// launch lands more bytes in shared memory than that; L2 may serve the
// second read of a frame.
//
// Design: the TPU's (M, cols) array is cut into windows of W = T + 2K
// rows at rows min(i T, M - W), i < M / T, as the TPU's strips are, and
// across into windows of `wa` floats at columns min(j sa, cols - wa), so
// that a window always lies inside its array and a shared slot holds it
// (E-uni's framed tile is T = 96, K = 8, wa = 128, sa = 112). A window of
// the gather carries `wb` more floats, from columns [j wb, j wb + wb) of
// the second array `b`. One block an SM walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., double-buffered: it issues tile l+1's load
// into the other slot, waits for tile l's, and thread 0 reads the slot's
// first cell (a volatile load, so that the read stays). The block that
// loads the last tile writes that cell to *elem: the function's value, the
// first cell of the last window. With `check`, each block also writes its
// last slot, W rows of wa + wb floats, to check[blockIdx.x]. Loads, each a
// compile-time instance:
//   - kGatherBox (0): one TMA box a piece, both on the slot's mbarrier, a
//     piece landing as a dense sub-slot of its own pitch (the gather's
//     two boxes: "gather-tma"; one box of `a` alone: "dense", and
//     "extdense" on the gather's pieces laid out as one array);
//   - kGatherCpAsync (1): 16-byte cp.async, every thread its share of a
//     window's chunks into one slot of pitch wa + wb, then one arrival
//     on the slot's mbarrier once its copies land ("dense-cpasync",
//     "gather").
// A slot is reused only after every thread has passed the block barrier
// at the top of the next tile, and the n-th use of a slot waits on its
// mbarrier's phase parity n mod 2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "heat_tma.cuh"

constexpr int kGatherBox = 0;
constexpr int kGatherCpAsync = 1;
constexpr int kGatherMaxThreads = 1024;

struct HeatGatherMaps {
  CUtensorMap a;
  CUtensorMap b;
};

// The launch's geometry, as the kernel reads it.
struct HeatGatherShape {
  int64_t m, ca, cb;   // rows; widths of a and b
  int wa, sa, wb;      // piece widths, a's window stride
  int w_rows;          // W = T + 2K
  int t_rows;          // T
  int n_row, n_col;    // windows down and across
};

__device__ __forceinline__ void heat_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   heat_smem_addr(dst)),
               "l"(src)
               : "memory");
}

template <int kLoad>
__global__ void __launch_bounds__(kGatherMaxThreads, 1)
heat_probe_gather_dma_kernel(const float* __restrict__ a,
                             const float* __restrict__ b, float* elem,
                             float* check, HeatGatherShape g,
                             const __grid_constant__ HeatGatherMaps maps) {
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y;
  const int width = g.wa + g.wb;
  // A slot: W rows of wa + wb floats, rounded up to 32 floats so that the
  // second slot starts on 128 bytes too; then an mbarrier a slot.
  const int slot = (g.w_rows * width + 31) / 32 * 32;
  float* base = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 2 * slot);
  const int64_t tiles = static_cast<int64_t>(g.n_row) * g.n_col;
  const int64_t mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      heat_mbar_init_count(bar + s,
                           kLoad == kGatherCpAsync ? threads : 1);
    heat_mbar_init_fence();
  }
  __syncthreads();
  // Tile l of this block into slot l % 2.
  auto issue = [&](int64_t l) {
    const int64_t t = blockIdx.x + l * gridDim.x;
    const int64_t i = t / g.n_col, j = t % g.n_col;
    const int64_t y0 = i * g.t_rows < g.m - g.w_rows ? i * g.t_rows
                                                     : g.m - g.w_rows;
    const int64_t xa = j * g.sa < g.ca - g.wa ? j * g.sa : g.ca - g.wa;
    const int64_t xb = j * g.wb;
    float* dst = base + (l & 1) * slot;
    uint64_t* sb = bar + (l & 1);
    if constexpr (kLoad == kGatherBox) {
      if (tid == 0) {
        heat_mbar_expect(sb, static_cast<uint32_t>(4 * g.w_rows * width));
        heat_tma_load_2d(dst, &maps.a, sb, static_cast<int>(xa),
                         static_cast<int>(y0));
        if (g.wb > 0)
          heat_tma_load_2d(dst + g.w_rows * g.wa, &maps.b, sb,
                           static_cast<int>(xb), static_cast<int>(y0));
      }
    } else {
      const int qa = g.wa / 4, per_row = width / 4;
      for (int c = tid; c < g.w_rows * per_row; c += threads) {
        const int r = c / per_row, q = c % per_row;
        const float* src =
            q < qa ? a + (y0 + r) * g.ca + xa + 4 * q
                   : b + (y0 + r) * g.cb + xb + 4 * (q - qa);
        heat_cp_async16(dst + r * width + 4 * q, src);
      }
      heat_cp_async_arrive(sb);
    }
  };
  float v = 0.f;
  if (mine > 0) issue(0);
  for (int64_t l = 0; l < mine; ++l) {
    __syncthreads();  // slot (l + 1) % 2 is read no more
    if (l + 1 < mine) issue(l + 1);
    heat_mbar_wait(bar + (l & 1), static_cast<uint32_t>((l >> 1) & 1));
    if (tid == 0)
      v = *reinterpret_cast<volatile float*>(base + (l & 1) * slot);
  }
  if (mine == 0) return;
  if (tid == 0 && blockIdx.x + (mine - 1) * gridDim.x == tiles - 1) *elem = v;
  if (check != nullptr) {
    // The last slot, as W rows of wa + wb floats (a box's pieces lie as
    // two dense sub-slots).
    const float* last = base + ((mine - 1) & 1) * slot;
    float* o = check + blockIdx.x * static_cast<int64_t>(g.w_rows) * width;
    for (int c = tid; c < g.w_rows * width; c += threads) {
      const int r = c / width, q = c % width;
      float x;
      if (kLoad == kGatherCpAsync)
        x = last[c];
      else
        x = q < g.wa ? last[r * g.wa + q]
                     : last[g.w_rows * g.wa + r * g.wb + (q - g.wa)];
      o[c] = x;
    }
  }
}

// The dynamic shared memory of a launch: 128 bytes of alignment, two
// slots, an mbarrier each.
static size_t heat_gather_smem(const HeatGatherShape& g) {
  const size_t slot =
      (static_cast<size_t>(g.w_rows) * (g.wa + g.wb) + 31) / 32 * 32;
  return 128 + 2 * slot * sizeof(float) + 2 * sizeof(uint64_t);
}

// Load `load` (kGatherBox or kGatherCpAsync) of the windows of the m x ca
// float32 array `a` (W = t_rows + 2k rows, wa floats at stride sa) and,
// with wb > 0, of wb floats of the m x cb array `b` each, by `blocks`
// blocks of block_x x block_y threads (one an SM). *elem gets the first
// cell of the last window; `check`, when not null, blocks x W x (wa + wb)
// floats, each block's last window. Refuses (cudaErrorInvalidValue): a
// window taller or wider than its array, widths or strides that are no
// multiple of 4 floats, an array not 16-byte aligned, a box piece over
// 256 cells, a second piece that starts off a 128-byte boundary (W wa a
// multiple of 32), too few columns in `b`, and slots over a block's
// shared memory. Returns a cudaError_t, or a tensor-map encoding error.
extern "C" int heat_probe_gather_dma(int load, const float* a, const float* b,
                                     float* elem, float* check, int64_t m,
                                     int64_t ca, int wa, int sa, int64_t cb,
                                     int wb, int t_rows, int k, int blocks,
                                     int block_x, int block_y, void* stream) {
  HeatGatherShape g = {m, ca, cb, wa, sa, wb, t_rows + 2 * k, t_rows, 0, 0};
  if ((load != kGatherBox && load != kGatherCpAsync) || t_rows < 1 ||
      k < 0 || g.w_rows > m || wa < 4 || wa > ca || wa % 4 || sa < 4 ||
      sa % 4 || ca % 4 || wb < 0 || wb % 4 || blocks < 1 || block_x < 1 ||
      block_y < 1 || block_x * block_y > kGatherMaxThreads ||
      (block_x * block_y) % 32 || reinterpret_cast<uintptr_t>(a) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  g.n_row = static_cast<int>(m / t_rows);
  g.n_col = ca > wa ? static_cast<int>((ca - wa + sa - 1) / sa) + 1 : 1;
  if (wb > 0 && (b == nullptr || cb % 4 || cb < int64_t(g.n_col) * wb ||
                 reinterpret_cast<uintptr_t>(b) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  HeatGatherMaps maps = {};
  if (load == kGatherBox) {
    if (g.w_rows > 256 || wa > 256 || wb > 256 ||
        (static_cast<int64_t>(g.w_rows) * wa) % 32)
      return static_cast<int>(cudaErrorInvalidValue);
    const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(ca),
                                  static_cast<cuuint64_t>(m)};
    const cuuint64_t stride_a[1] = {static_cast<cuuint64_t>(ca) * 4};
    const cuuint32_t box_a[2] = {static_cast<cuuint32_t>(wa),
                                 static_cast<cuuint32_t>(g.w_rows)};
    int enc = heat_tma_encode(&maps.a, a, 2, dims_a, stride_a, box_a);
    if (enc == 0 && wb > 0) {
      const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(cb),
                                    static_cast<cuuint64_t>(m)};
      const cuuint64_t stride_b[1] = {static_cast<cuuint64_t>(cb) * 4};
      const cuuint32_t box_b[2] = {static_cast<cuuint32_t>(wb),
                                   static_cast<cuuint32_t>(g.w_rows)};
      enc = heat_tma_encode(&maps.b, b, 2, dims_b, stride_b, box_b);
    }
    if (enc != 0) return enc;
  }
  const int64_t tiles = static_cast<int64_t>(g.n_row) * g.n_col;
  const unsigned grid =
      static_cast<unsigned>(tiles < blocks ? tiles : blocks);
  const size_t smem = heat_gather_smem(g);
  auto kernel = load == kGatherBox
                    ? heat_probe_gather_dma_kernel<kGatherBox>
                    : heat_probe_gather_dma_kernel<kGatherCpAsync>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, dim3(block_x, block_y), smem,
           static_cast<cudaStream_t>(stream)>>>(a, b, elem, check, g, maps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_probe_gather_dma_error_string(int code) {
  return heat_tma_error_string(code);
}
