// Kernel F's launch (heat_f_temporal3d.cu has the design): heat_f_launch
// is the checks, the tensor map, the shared memory and the launch of an
// instance, whose body is heat_f_block.inc on the register-blocked plane
// loop (heat_temporal3d.cuh HeatFLoop). Kernel F (heat_f_temporal3d.cu)
// and its overlap probe (heat_probe_xslab_overlap.cu, the loop's
// variants kHeatFNoStep and kHeatFNoLoad) launch their kernels through
// it.

#pragma once

#include "heat_temporal3d.cuh"

// An instance of F's kernel on grids of T cells, or of a probe's variant
// of it.
template <typename T>
using HeatFKernelOf = void (*)(const T*, T*, uint32_t*, int64_t, int64_t,
                               int64_t, int64_t, int64_t, int, int, int,
                               float, float, float, float,
                               const CUtensorMap);
using HeatFKernel = HeatFKernelOf<float>;

// The box heat_f_launch encodes in its tensor map (innermost first): one
// plane of the extended tile, 128 cells (of either type) by block_y *
// rows rows. The
// kernel audit's record check reads it (heat_probe_xslab_overlap_box).
inline void heat_f_map_box(int block_y, int rows, cuuint32_t box[3]) {
  box[0] = static_cast<cuuint32_t>(kFWidth);
  box[1] = static_cast<cuuint32_t>(block_y * rows);
  box[2] = 1;
}

// Kernel F's launch through `kernel`, the instance of (k, rows, tma) or
// of a probe's variant of it (null where none is compiled), with
// heat_f_temporal3d's arguments and results (heat_f_temporal3d.cu), on
// grids of T cells (float32, or bfloat16: heat_f_temporal3d_bf16.cu,
// whose TMA load needs nz % 8 == 0).
template <typename T>
inline int heat_f_launch(HeatFKernelOf<T> kernel, const T* u, T* out,
                         uint32_t* res, int64_t nx, int64_t ny, int64_t nz,
                         int k, int block_x, int block_y, int rows, int seg,
                         int prefetch, int tma, float a0, float cx, float cy,
                         float cz, void* stream) {
  constexpr int kElem = sizeof(T);
  if (kernel == nullptr || nx < 3 || ny < 3 || nz < 3 || seg < 1 ||
      prefetch < 1 || prefetch > kFMaxPrefetch ||
      !heat_f_takes(block_x, block_y, rows, k, kElem) ||
      nx > 0x7fffffffLL || ny > 0x7fffffffLL || nz > 0x7fffffffLL ||
      (tma && (nz % (16 / kElem) != 0 ||
               reinterpret_cast<uintptr_t>(u) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wy = block_y * rows;
  const int tile_z = kFWidth - 2 * heat_f_pad(k, kElem);
  const int64_t tiles_z = (nz + tile_z - 1) / tile_z;
  const int64_t tiles_y = (ny + wy - 2 * k - 1) / (wy - 2 * k);
  const int64_t blocks = tiles_z * tiles_y * ((nx + seg - 1) / seg);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map = {};
  if (tma) {
    cuuint32_t box[3];
    heat_f_map_box(block_y, rows, box);
    const int err = heat_tma_encode_3d_box(
        &map, u, nx, ny, nz, box,
        kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != 0) return err;
  }
  const int smem = heat_f_smem_bytes(k, block_y, rows, prefetch, kElem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res != nullptr) {
    err = cudaMemsetAsync(res, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_out =
      nz % 4 == 0 && reinterpret_cast<uintptr_t>(out) % (4 * kElem) == 0;
  kernel<<<static_cast<unsigned>(blocks), dim3(block_x, block_y), smem, s>>>(
      u, out, res, nx, ny, nz, tiles_z, tiles_y, seg, prefetch, vec_out, a0,
      cx, cy, cz, map);
  return static_cast<int>(cudaGetLastError());
}
