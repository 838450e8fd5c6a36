// The Tensor Memory Accelerator (TMA) and mbarriers, for the kernels that
// load a tile as one box of a tensor map: heat_e_uni_temporal.cu (2D, a
// framed tile of the grid), heat_f_temporal3d.cu (a plane of a tile of
// the grid, heat_temporal3d.cuh's heat_f_stream) and the sharded 3D
// kernels of heat_h.cuh (a plane of a block's extended tile,
// heat_temporal3d.cuh's heat_t3d_stream_tma). Device side: the PTX of sm_90 for mbarriers and
// cp.async.bulk.tensor. Host side: the tensor-map encoder, fetched from
// the driver through the runtime, so that nothing links against the
// driver library.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t heat_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes a phase on one arrival (and
// the bytes that arrival expects). Initialise it in dynamic shared memory:
// ptxas 12.9 has crashed on mbarriers in static shared memory.
__device__ __forceinline__ void heat_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   heat_smem_addr(bar))
               : "memory");
}

// An mbarrier whose phase completes on `count` arrivals: kernel F's
// cp.async load, where every thread of the block arrives once its own
// copies have landed (heat_cp_async_arrive).
__device__ __forceinline__ void heat_mbar_init_count(uint64_t* bar,
                                                     uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   heat_smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before it
// has landed (noinc: the arrival counts against the barrier's count).
__device__ __forceinline__ void heat_cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(heat_smem_addr(bar))
               : "memory");
}

// Makes the initialising thread's mbarrier.init visible to the async
// proxy (the TMA unit); the block's barrier after it makes it visible to
// the other threads.
__device__ __forceinline__ void heat_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` from the async proxy.
__device__ __forceinline__ void heat_mbar_expect(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(heat_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void heat_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   heat_smem_addr(bar))
               : "memory");
}

// Until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void heat_mbar_wait(uint64_t* bar,
                                               uint32_t parity) {
  const uint32_t addr = heat_smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The box of the 2D `map` at coordinates (c0, c1), innermost first, into
// shared memory at dst (128-byte aligned); its bytes complete on `bar`.
// Cells outside the tensor arrive as zeros.
__device__ __forceinline__ void heat_tma_load_2d(float* dst,
                                                 const CUtensorMap* map,
                                                 uint64_t* bar, int c0,
                                                 int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(heat_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(heat_smem_addr(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// As heat_tma_load_2d, for a 3D map at (c0, c1, c2).
__device__ __forceinline__ void heat_tma_load_3d(float* dst,
                                                 const CUtensorMap* map,
                                                 uint64_t* bar, int c0,
                                                 int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(heat_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(heat_smem_addr(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Error codes past cudaError_t's: cuTensorMapEncodeTiled's CUresult, or
// that of fetching it from the driver, plus this base.
// The kernel audit's record of one load (analysis/kernels.py
// load_records), written by the thread that issues it in the record
// variants of E-uni's block (kHeatLoopRecord) and F's plane loop
// (kHeatFRecord): record `index` at rec[1 + 8 index ...] (rec[0] is the
// residual's): the window's first cell, innermost first; the bytes the
// block's own copies move (a cp.async fill's; 0 for a TMA box, whose
// bytes are the box the launcher encodes in the tensor map, which the
// kernel cannot read: the probes' *_box exports give it); the bytes
// expect_tx arms (0 for a cp.async fill); its ring slot; the parity of
// the phase its consumer waits on; 1.
__device__ __forceinline__ void heat_record_load(uint32_t* rec, int64_t index,
                                                 int c0, int c1, int c2,
                                                 uint32_t copied,
                                                 uint32_t expect, int slot,
                                                 uint32_t parity) {
  uint32_t* r = rec + 1 + 8 * index;
  r[0] = static_cast<uint32_t>(c0);
  r[1] = static_cast<uint32_t>(c1);
  r[2] = static_cast<uint32_t>(c2);
  r[3] = copied;
  r[4] = expect;
  r[5] = static_cast<uint32_t>(slot);
  r[6] = parity;
  r[7] = 1u;
}

constexpr int kHeatTmaEncodeError = 100000;

typedef CUresult (*HeatEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The tensor map of the float32 tensor (or, by `type`, the bfloat16 one) at
// `data` of `rank` dimensions `dims` (innermost first), strides in bytes
// `strides` (rank - 1 of them, each a multiple of 16), boxes of `box`
// cells (the innermost box row a multiple of 16 bytes), zeros outside the
// tensor. The driver's encoder is fetched through the runtime once.
// Returns 0 or an error code (heat_tma_error_string).
inline int heat_tma_encode(
    CUtensorMap* map, const void* data, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  static HeatEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return kHeatTmaEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
    encode = reinterpret_cast<HeatEncodeTiled>(fn);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(data),
      dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kHeatTmaEncodeError + static_cast<int>(r);
}

// The tensor map of the n0 x n1 x n2 float32 array `data` (or, by
// `type`, the bfloat16 one; n2 innermost and contiguous, a multiple of 4
// float32 or 8 bfloat16 cells so that its strides are multiples of 16
// bytes), boxes of box[0] x box[1] x box[2] cells (innermost first),
// zeros outside the array (heat_f.cuh's heat_f_launch). Returns 0 or an
// error code.
inline int heat_tma_encode_3d_box(
    CUtensorMap* map, const void* data, int64_t n0, int64_t n1, int64_t n2,
    const cuuint32_t box[3],
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  const cuuint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n2),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n0)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n2) * elem,
                                 static_cast<cuuint64_t>(n1 * n2) * elem};
  return heat_tma_encode(map, data, 3, dims, strides, box, type);
}

// As heat_tma_encode_3d_box, boxes of box_z x box_y x 1 cells: a plane's
// tile of a 3D block (heat_h.cuh's heat_h_encode_map).
inline int heat_tma_encode_3d(CUtensorMap* map, const float* data,
                              int64_t n0, int64_t n1, int64_t n2, int box_z,
                              int box_y) {
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_z),
                             static_cast<cuuint32_t>(box_y), 1};
  return heat_tma_encode_3d_box(map, data, n0, n1, n2, box);
}

// The message of an entry point's error code: a cudaError_t, or one of
// heat_tma_encode's.
inline const char* heat_tma_error_string(int code) {
  if (code >= kHeatTmaEncodeError)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
