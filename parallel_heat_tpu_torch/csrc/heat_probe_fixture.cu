// heat_probe_fixture: the kernel audit's fixture (the counterpart of the
// `_strip_call` pallas_call fixtures of tests/test_analysis.py).
//
// One block per output strip of `strip_rows` rows of a rows x 128 float32
// array: the block loads its window into one of two shared slots (slot
// s & 1), waits, and writes out = 2 u for its strip. One __global__
// template over a variant (the audit's seeded faults that are code):
//   - kFixClean (0): the window by 16-byte cp.async, one commit group,
//     __pipeline_wait_prior(0);
//   - kFixCleanTma (1): the window as one TMA box on an mbarrier;
//   - kFixOobWindow (2): windows of window_rows rows at s * window_rows:
//     the last reads past the array (HL401);
//   - kFixRuntimeWindow (3): every strip's window starts at a row read
//     from device memory, *off (HL401: not statically derivable);
//   - kFixWaitWithoutIssue (4): a wait on an mbarrier phase no copy
//     completes (HL403; hangs);
//   - kFixLeakedIssue (5): copies issued and committed, never waited
//     (HL403); the strip is written 0;
//   - kFixSlotReuse (6): a second window copied into slot 0 while the
//     first is in flight (HL403);
//   - kFixExpectMismatch (7): expect_tx one row short of the box's bytes
//     (HL403; the phase completes before the data lands).
// The faults that are geometry (a ragged tiling, an index out of range,
// an output never visited, a budget exceeded, a box over 256 rows) are
// seeded by the audit plan's launch, not by code. Only kFixClean,
// kFixCleanTma and kFixRuntimeWindow (at an in-range offset) are ever
// launched: heat_probe_fixture refuses the others, which are compiled
// (ptxas reports each instance) so that the seeded code is real.

#include <cuda_pipeline.h>

#include "heat_tma.cuh"

constexpr int kFixClean = 0;
constexpr int kFixCleanTma = 1;
constexpr int kFixOobWindow = 2;
constexpr int kFixRuntimeWindow = 3;
constexpr int kFixWaitWithoutIssue = 4;
constexpr int kFixLeakedIssue = 5;
constexpr int kFixSlotReuse = 6;
constexpr int kFixExpectMismatch = 7;
constexpr int kFixVariants = 8;

constexpr int kFixCols = 128;     // cells a row (analysis/plans.py)
constexpr int kFixThreads = 128;  // threads a block

__host__ __device__ constexpr bool heat_fix_tma(int var) {
  return var == kFixCleanTma || var == kFixWaitWithoutIssue ||
         var == kFixExpectMismatch;
}

template <int kVar>
__global__ void __launch_bounds__(kFixThreads)
heat_probe_fixture_kernel(const float* __restrict__ u, float* __restrict__ out,
                          const int* off, int strip_rows, int window_rows,
                          const __grid_constant__ CUtensorMap umap) {
  extern __shared__ __align__(128) float smem[];
  // Two slots from the first 128-byte boundary (a box's alignment), then
  // the mbarrier.
  float* buf = smem + ((128 - (heat_smem_addr(smem) & 127)) & 127) / 4;
  const int slot_f = window_rows * kFixCols;
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * slot_f);
  const int s = static_cast<int>(blockIdx.x);
  float* dst = buf + (s & 1) * slot_f;
  int64_t r0 = static_cast<int64_t>(s) * strip_rows;
  if (kVar == kFixOobWindow) r0 = static_cast<int64_t>(s) * window_rows;
  if (kVar == kFixRuntimeWindow) r0 = *off;
  const int tid = static_cast<int>(threadIdx.x);
  const int vecs = slot_f / 4;
  if constexpr (heat_fix_tma(kVar)) {
    if (tid == 0) {
      heat_mbar_init(bar);
      heat_mbar_init_fence();
    }
    __syncthreads();
    if (kVar != kFixWaitWithoutIssue && tid == 0) {
      const uint32_t bytes =
          static_cast<uint32_t>(sizeof(float) * slot_f) -
          (kVar == kFixExpectMismatch ? sizeof(float) * kFixCols : 0u);
      heat_mbar_expect(bar, bytes);
      heat_tma_load_2d(dst, &umap, bar, 0, static_cast<int>(r0));
    }
    heat_mbar_wait(bar, 0);
  } else if constexpr (kVar == kFixSlotReuse) {
    dst = buf;
    for (int v = tid; v < vecs; v += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * v, u + r0 * kFixCols + 4 * v, 16);
    __pipeline_commit();
    const int64_t r1 = r0 + window_rows;
    for (int v = tid; v < vecs; v += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * v, u + r1 * kFixCols + 4 * v, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int v = tid; v < vecs; v += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * v, u + r0 * kFixCols + 4 * v, 16);
    __pipeline_commit();
    if (kVar != kFixLeakedIssue) __pipeline_wait_prior(0);
  }
  __syncthreads();
  float* o = out + static_cast<int64_t>(s) * strip_rows * kFixCols;
  for (int i = tid; i < strip_rows * kFixCols; i += blockDim.x)
    o[i] = kVar == kFixLeakedIssue ? 0.f : 2.f * dst[i];
}

typedef void (*HeatFixKernel)(const float*, float*, const int*, int, int,
                              const CUtensorMap);
static const HeatFixKernel kHeatFix[kFixVariants] = {
    heat_probe_fixture_kernel<0>, heat_probe_fixture_kernel<1>,
    heat_probe_fixture_kernel<2>, heat_probe_fixture_kernel<3>,
    heat_probe_fixture_kernel<4>, heat_probe_fixture_kernel<5>,
    heat_probe_fixture_kernel<6>, heat_probe_fixture_kernel<7>};

// Dynamic shared memory of a block (analysis/plans.py
// fixture_smem_bytes): two slots, 128 bytes to align them, the mbarrier.
inline int heat_fix_smem_bytes(int window_rows) {
  return static_cast<int>(2 * sizeof(float) * window_rows * kFixCols) + 128 +
         static_cast<int>(sizeof(uint64_t));
}

// out = 2 u over a rows x 128 float32 array `u` (16-byte aligned, rows a
// multiple of strip_rows), one block a strip of strip_rows rows, under
// `variant` (kFixClean, kFixCleanTma, or kFixRuntimeWindow with `off` a
// device int: every strip then doubles rows [*off, *off + strip_rows)).
// The seeded variants are refused. Launches on `stream` and does not
// synchronise. Returns a cudaError_t, or a tensor-map encoding error
// (heat_probe_fixture_error_string).
extern "C" int heat_probe_fixture(int variant, const float* u, float* out,
                                  const int* off, int64_t rows,
                                  int strip_rows, void* stream) {
  if ((variant != kFixClean && variant != kFixCleanTma &&
       variant != kFixRuntimeWindow) ||
      rows < 1 || strip_rows < 1 || strip_rows > 256 ||
      rows % strip_rows != 0 || rows / strip_rows > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      (variant == kFixRuntimeWindow && off == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map = {};
  if (heat_fix_tma(variant)) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kFixCols),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {sizeof(float) * kFixCols};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kFixCols),
                               static_cast<cuuint32_t>(strip_rows)};
    const int enc = heat_tma_encode(&map, u, 2, dims, strides, box);
    if (enc != 0) return enc;
  }
  const HeatFixKernel kernel = kHeatFix[variant];
  const int smem = heat_fix_smem_bytes(strip_rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows / strip_rows), kFixThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(u, out, off, strip_rows,
                                                strip_rows, map);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_probe_fixture_error_string(int code) {
  return heat_tma_error_string(code);
}
