// Kernel E-uni's tile and launch (heat_e_uni_temporal.cu has the design):
// the body of one block, templated on the tile loop's variant
// (heat_temporal.cuh kHeatLoopFull .. kHeatLoopRowCopy) and on the form
// of its load (kHeatLoadWhole .. kHeatLoadRowBands, below), and the host
// launch of any kernel built on it. heat_e_uni_temporal.cu compiles the
// shipped variant and load; the measurement probes compile the others
// (heat_probe_temporal.cu, E-uni's anatomy; heat_probe_ab_temporal.cu,
// its boundary forms; heat_probe_split_copy.cu, its load split) and
// launch each exactly as E-uni is launched.

#pragma once

#include "heat_temporal.cuh"
#include "heat_tma.cuh"

// The forms of a tile's load. E-uni takes kHeatLoadWhole: the framed tile
// as one TMA box on one mbarrier. The others belong to the split-copy
// probe (heat_probe_split_copy.cu) and land the same cells in the same
// shared rows, so that every form computes E-uni's steps:
//   - kHeatLoadLanes2, kHeatLoadLanes4: the rows cut into 2 or 4 column
//     slices, a slice on its own mbarrier. A box lands with its own row
//     pitch, so a slice is one box a row (sy boxes a slice), issued by
//     the lanes of warp 0;
//   - kHeatLoadLanes2OneBar: the two slices on one mbarrier, which
//     expects the bytes of both;
//   - kHeatLoadRows2: two boxes of half the rows, an mbarrier each;
//   - kHeatLoadSubwin: the shared rows 32 floats wider than the box (the
//     slot wider than its copy), filled by one box a row;
//   - kHeatLoadBranchy: kHeatLoadWhole's box, issued under three branches
//     on where the tile lies (first, last, any other tile);
//   - kHeatLoadRowBands: one box and one mbarrier per warp's run of rows
//     (heat_tile_steps), and a warp waits only on the bands that its
//     first step reads: its own and its neighbours'.
// A box must land on a 128-byte boundary of shared memory, so every form
// but the whole box and its branchy twin needs rows of a multiple of 32
// floats, the lane slices a multiple of 32 floats each, and kHeatLoadRows2
// an even number of rows (heat_e_uni_load_fits).
constexpr int kHeatLoadWhole = 0;
constexpr int kHeatLoadLanes2 = 1;
constexpr int kHeatLoadLanes2OneBar = 2;
constexpr int kHeatLoadRows2 = 3;
constexpr int kHeatLoadLanes4 = 4;
constexpr int kHeatLoadSubwin = 5;
constexpr int kHeatLoadBranchy = 6;
constexpr int kHeatLoadRowBands = 7;

// Column slices of a row and whether each row is its own box.
__host__ __device__ constexpr int heat_e_uni_load_slices(int load) {
  return load == kHeatLoadLanes4 ? 4
         : load == kHeatLoadLanes2 || load == kHeatLoadLanes2OneBar ? 2
                                                                    : 1;
}
__host__ __device__ constexpr bool heat_e_uni_load_per_row(int load) {
  return heat_e_uni_load_slices(load) > 1 || load == kHeatLoadSubwin;
}

// The shared row pitch in floats of a tile whose box rows are sx floats.
__host__ __device__ __forceinline__ int heat_e_uni_load_pitch(int load,
                                                              int sx) {
  return load == kHeatLoadSubwin ? sx + 32 : sx;
}

// Rows of a warp's run (heat_tile_steps) and mbarriers of a load form,
// for a framed tile of sy rows under `warps` warps.
__host__ __device__ __forceinline__ int heat_e_uni_load_run(int sy,
                                                            int warps) {
  return (sy + warps - 1) / warps;
}
__host__ __device__ __forceinline__ int heat_e_uni_load_bars(int load, int sy,
                                                             int warps) {
  if (load == kHeatLoadRowBands) {
    const int run = heat_e_uni_load_run(sy, warps);
    return (sy + run - 1) / run;
  }
  if (load == kHeatLoadLanes2 || load == kHeatLoadRows2) return 2;
  return load == kHeatLoadLanes4 ? 4 : 1;
}

// Does load form `load` take a framed tile of sy rows of sx floats?
inline bool heat_e_uni_load_fits(int load, int sy, int sx) {
  if (load < kHeatLoadWhole || load > kHeatLoadRowBands) return false;
  if (load == kHeatLoadWhole || load == kHeatLoadBranchy) return true;
  if (sx % 32 != 0 || (sx / heat_e_uni_load_slices(load)) % 32 != 0)
    return false;
  return load != kHeatLoadRows2 || sy % 2 == 0;
}

// The box of load form `load` (innermost first): of every piece, or with
// `last` of the last row band (kHeatLoadRowBands only).
inline void heat_e_uni_load_box(int load, int sy, int sx, int warps,
                                bool last, cuuint32_t box[2]) {
  int rows = sy;
  if (heat_e_uni_load_per_row(load)) rows = 1;
  if (load == kHeatLoadRows2) rows = sy / 2;
  if (load == kHeatLoadRowBands) {
    const int run = heat_e_uni_load_run(sy, warps);
    rows = last ? sy - (heat_e_uni_load_bars(load, sy, warps) - 1) * run
                : run;
  }
  box[0] = static_cast<cuuint32_t>(sx / heat_e_uni_load_slices(load));
  box[1] = static_cast<cuuint32_t>(rows);
}

// The tensor maps of a split load: the pieces' box, and the last row
// band's (kHeatLoadRowBands; the same box otherwise).
struct HeatEUniMaps {
  CUtensorMap body;
  CUtensorMap tail;
};

// One block of E-uni under a split load form (kLoad, above), for
// heat_e_uni_tile: the same tile, steps and store, the rows at pitch
// heat_e_uni_load_pitch.
template <int kVar, int kLoad>
__device__ __forceinline__ void heat_e_uni_split_tile(
    float* __restrict__ out, uint32_t* res, int64_t m, int64_t n,
    int64_t n_col_tiles, int k, int tile_y, int tile_x, float a0, float cx,
    float cy, const CUtensorMap* umap, const CUtensorMap* tail_map) {
  extern __shared__ __align__(128) float smem[];
  constexpr int kSlices = heat_e_uni_load_slices(kLoad);
  const int sy = tile_y + 2 * k;
  const int sw = tile_x + 2 * k;
  const int pad = heat_row_pad(k);
  const int sx = heat_row_floats(k, tile_x);
  const int pitch = heat_e_uni_load_pitch(kLoad, sx);
  const int run = heat_e_uni_load_run(sy, blockDim.y);
  const int nb = heat_e_uni_load_bars(kLoad, sy, blockDim.y);
  const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
  const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;
  const int x0 = static_cast<int>(gx0 - pad);
  const int y0 = static_cast<int>(gy0);
  float* buf = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * sy * pitch);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    for (int b = 0; b < nb; ++b) heat_mbar_init(bar + b);
    heat_mbar_init_fence();
    if constexpr (heat_e_uni_load_per_row(kLoad)) {
      // Each mbarrier's bytes; warp 0 issues the boxes below.
      for (int b = 0; b < nb; ++b)
        heat_mbar_expect(bar + b, static_cast<uint32_t>(4 * sy * sx / nb));
    } else if constexpr (kLoad == kHeatLoadBranchy) {
      heat_mbar_expect(bar, static_cast<uint32_t>(sizeof(float) * sy * sx));
      const int64_t last = gridDim.x - 1;
      if (blockIdx.x == 0) {
        heat_tma_load_2d(buf, umap, bar, -k - pad, -k);
      } else if (blockIdx.x == last) {
        heat_tma_load_2d(
            buf, umap, bar,
            static_cast<int>((n_col_tiles - 1) * tile_x - k - pad),
            static_cast<int>((last / n_col_tiles) * tile_y - k));
      } else {
        heat_tma_load_2d(buf, umap, bar, x0, y0);
      }
    } else {  // kHeatLoadRows2, kHeatLoadRowBands: a box a band
      const int h = kLoad == kHeatLoadRows2 ? sy / 2 : run;
      for (int b = 0; b < nb; ++b) {
        const int r0 = b * h;
        heat_mbar_expect(bar + b,
                         static_cast<uint32_t>(4 * min(h, sy - r0) * sx));
        heat_tma_load_2d(buf + r0 * sx, b == nb - 1 ? tail_map : umap,
                         bar + b, x0, y0 + r0);
      }
    }
  }
  __syncthreads();  // the mbarriers are initialised for every thread
  if constexpr (heat_e_uni_load_per_row(kLoad)) {
    if (threadIdx.y == 0) {
      const int slice = sx / kSlices;
      for (int r = threadIdx.x; r < sy; r += kHeatLanes)
        for (int j = 0; j < kSlices; ++j)
          heat_tma_load_2d(buf + r * pitch + j * slice, umap,
                           bar + (nb == 1 ? 0 : j), x0 + j * slice, y0 + r);
    }
  }
  // The mbarriers this warp waits on: all, or under kHeatLoadRowBands
  // the bands of rows [t_r0 - 1, t_r1] that its first step reads.
  int b_lo = 0, b_hi = nb - 1;
  if (kLoad == kHeatLoadRowBands) {
    const int t_r0 = threadIdx.y * run;
    b_lo = max(t_r0 - 1, 0) / run;
    b_hi = t_r0 < sy ? min(t_r0 + run, sy - 1) / run : b_lo - 1;
  }
  heat_e_steps<kVar>(buf, buf + sy * pitch, pitch, pad, sy, sw, gy0, gx0, m,
                     n, k, tile_y, tile_x, a0, cx, cy, out, res,
                     [bar, b_lo, b_hi] {
                       for (int b = b_lo; b <= b_hi; ++b)
                         heat_mbar_wait(bar + b, 0);
                     });
}

// One block of E-uni (variant kVar, load form kLoad): tile blockIdx.x of
// the grid behind the tensor map `umap`, K steps, the tile's cells into
// `out` and their residual into *res. kHeatLoopNoLoad issues no box and
// waits for none (the block steps its buffer as it lies), but initialises
// the mbarrier as the load does. A split load form takes its pieces' map
// as `umap` and its last row band's as `tail_map`
// (heat_e_uni_split_tile).
template <int kVar, int kLoad = kHeatLoadWhole>
__device__ __forceinline__ void heat_e_uni_tile(
    float* __restrict__ out, uint32_t* res, int64_t m, int64_t n,
    int64_t n_col_tiles, int k, int tile_y, int tile_x, float a0, float cx,
    float cy, const CUtensorMap* umap, const CUtensorMap* tail_map = nullptr) {
  if constexpr (kLoad != kHeatLoadWhole) {
    heat_e_uni_split_tile<kVar, kLoad>(out, res, m, n, n_col_tiles, k, tile_y,
                                       tile_x, a0, cx, cy, umap, tail_map);
  } else {
    extern __shared__ __align__(128) float smem[];
    const int sy = tile_y + 2 * k;
    const int sw = tile_x + 2 * k;
    const int pad = heat_row_pad(k);
    const int sx = heat_row_floats(k, tile_x);
    // Global coordinates of shared cell (0, 0).
    const int64_t gy0 = (blockIdx.x / n_col_tiles) * tile_y - k;
    const int64_t gx0 = (blockIdx.x % n_col_tiles) * tile_x - k;
    // The buffers from the first 128-byte boundary (the box's alignment),
    // then the mbarrier. An offset into smem, not an address rounded as an
    // integer, so that the pointers stay shared ones.
    float* buf = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
    uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * sy * sx);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      heat_mbar_init(bar);
      heat_mbar_init_fence();
      if (kVar != kHeatLoopNoLoad) {
        heat_mbar_expect(bar, static_cast<uint32_t>(sizeof(float) * sy * sx));
        heat_tma_load_2d(buf, umap, bar, static_cast<int>(gx0 - pad),
                         static_cast<int>(gy0));
      }
    }
    __syncthreads();  // the mbarrier is initialised for every thread
    heat_e_steps<kVar>(buf, buf + sy * sx, sx, pad, sy, sw, gy0, gx0, m, n, k,
                       tile_y, tile_x, a0, cx, cy, out, res, [bar] {
                         if (kVar != kHeatLoopNoLoad) heat_mbar_wait(bar, 0);
                       });
  }
}

// Does the TMA load take this launch? The box, TY+2K rows of
// heat_row_floats(K, TX) floats, within TMA's 256 cells a dimension, and
// the grid's coordinates within a box coordinate's int32
// (ops/hopper_params.py e_box_fits is the same rule for the box).
inline bool heat_e_uni_tma_fits(int64_t m, int64_t n, int k, int tile_y,
                                int tile_x) {
  return tile_y + 2 * k <= 256 && heat_row_floats(k, tile_x) <= 256 &&
         m <= 0x7fffffffLL && n <= 0x7fffffffLL;
}

// Dynamic shared memory of one block past the loop's two buffers: 128
// bytes to align them and the mbarrier (ops/hopper_params.py
// e_smem_bytes).
constexpr size_t kHeatEUniExtraSmem = 128 + sizeof(uint64_t);

// E-uni's launch of `kernel` (heat_e_uni_temporal_kernel, or a probe's
// variant of it, with its parameters) under load form kLoad: the checks,
// the tensor map of the grid `u` (boxes of the form's pieces), the shared
// memory, the residual's reset and the launch on `stream`. The kernel
// takes the map as its last argument, or with kMaps both maps of a split
// load (HeatEUniMaps). Returns a cudaError_t: 0, or the reason the launch
// was refused; or a tensor-map encoding error (heat_tma_error_string).
template <int kLoad = kHeatLoadWhole, bool kMaps = false, typename Kernel>
inline int heat_e_uni_launch(Kernel kernel, const float* u, float* out,
                             uint32_t* res, int64_t m, int64_t n, int k,
                             int tile_y, int tile_x, int block_x,
                             int block_y, float a0, float cx, float cy,
                             void* stream) {
  int64_t n_col_tiles = 0, blocks = 0;
  const int bad = heat_e_geometry(m, n, k, tile_y, tile_x, block_x, block_y,
                                  &n_col_tiles, &blocks);
  if (bad != 0) return bad;
  const int sy = tile_y + 2 * k;
  const int sx = heat_row_floats(k, tile_x);
  if (n % 4 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      !heat_e_uni_tma_fits(m, n, k, tile_y, tile_x) ||
      !heat_e_uni_load_fits(kLoad, sy, sx))
    return static_cast<int>(cudaErrorInvalidValue);
  // The tensor maps of the grid (innermost dimension first), boxes of the
  // framed, padded tile or of the load form's pieces.
  HeatEUniMaps maps = {};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
  cuuint32_t box[2], last[2];
  heat_e_uni_load_box(kLoad, sy, sx, block_y, false, box);
  heat_e_uni_load_box(kLoad, sy, sx, block_y, true, last);
  int enc = heat_tma_encode(&maps.body, u, 2, dims, strides, box);
  if (enc == 0 && kLoad == kHeatLoadRowBands)
    enc = heat_tma_encode(&maps.tail, u, 2, dims, strides, last);
  else
    maps.tail = maps.body;
  if (enc != 0) return enc;
  const size_t smem =
      sizeof(float) * 2 * sy * heat_e_uni_load_pitch(kLoad, sx) + 128 +
      sizeof(uint64_t) * heat_e_uni_load_bars(kLoad, sy, block_y);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 threads(block_x, block_y);
  if constexpr (kMaps)
    kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
        out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy, maps);
  else
    kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
        out, res, m, n, n_col_tiles, k, tile_y, tile_x, a0, cx, cy,
        maps.body);
  return static_cast<int>(cudaGetLastError());
}
