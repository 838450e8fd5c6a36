// heat_probe_xslab_overlap — does kernel F overlap its plane loads with
// its levels, or add them? F's own launch at its default shape, in three
// variants of its plane loop, under either load.
//
// Replaces: tools/ab_xslab_overlap.py::build_3buf (pallas_call name
// "heat_probe_xslab_overlap", defined at :38, call :116), the TPU probe
// that moved F's K - 1 intermediate sweeps out of the DMA slots into two
// buffers of their own, to see whether the slab's DMA then ran under the
// compute (the larger of the two) instead of after it (their sum). Here
// the levels never touch the load slots: they live in registers and in
// level buffers of their own (heat_temporal3d.cuh HeatFLoop), so that
// contrast has no second arm, and the probe asks the question by
// decomposition instead:
//   - full (kHeatFFull): F as shipped, the only variant that computes;
//   - no_step (kHeatFNoStep): the stream alone, each plane loaded, waited
//     for and refilled as in F, each output plane stored as F stores it,
//     no level stepped;
//   - no_load (kHeatFNoLoad): the compute alone, the levels stepping over
//     the ring as it lies after its first `prefetch` planes, the barrier a
//     plane kept;
//   - record (kHeatFRecord): F as shipped, and the leader writes each
//     plane's load down after the residual in `res` (1 + 8 blocks (nx +
//     2K) words): the kernel audit's plans are held against it, and
//     its expect_tx against the box the launch encodes
//     (heat_probe_xslab_overlap_box).
// full / max(no_step, no_load) near 1 says the loads overlap; near
// (no_step + no_load) / max, that they add.
//
// Bound on the H100: F's (heat_f_temporal3d.cu): at 512^3 and K = 3,
// 0.32 ms a launch by bytes.
//
// Design: the kernel is F's block (heat_f_block.inc, included as F's
// kernel includes it) with the loop's variant as a template argument,
// declaring F's launch bound so that ptxas gives each variant F's
// register budget, and the launch is F's (heat_f.cuh heat_f_launch).
// Only K = 3 at 2 rows a thread (F's default shape, ops/hopper_params.py
// f_shape(3)) is compiled: 3 variants x 2 loads, 6 instances; other
// shapes are refused.

#include "heat_f.cuh"

constexpr int kProbeK = 3;
constexpr int kProbeRows = 2;

template <int kProbe, bool kTma>
__global__ void __launch_bounds__(kFLanes * heat_f_max_warps(kProbeRows))
heat_probe_xslab_overlap_kernel(const float* __restrict__ u,
                                float* __restrict__ out, uint32_t* res,
                                int64_t nx, int64_t ny, int64_t nz,
                                int64_t tiles_z, int64_t tiles_y, int seg,
                                int prefetch, int vec_out, float a0,
                                float cx, float cy, float cz,
                                const __grid_constant__ CUtensorMap umap) {
  constexpr int K = kProbeK;
  constexpr int R = kProbeRows;
  using Loop = HeatFLoop<K, R, kTma, kProbe>;
#include "heat_f_block.inc"
}

// kHeatProbeF[tma][variant].
static const HeatFKernel kHeatProbeF[2][4] = {
    {heat_probe_xslab_overlap_kernel<kHeatFFull, false>,
     heat_probe_xslab_overlap_kernel<kHeatFNoStep, false>,
     heat_probe_xslab_overlap_kernel<kHeatFNoLoad, false>,
     heat_probe_xslab_overlap_kernel<kHeatFRecord, false>},
    {heat_probe_xslab_overlap_kernel<kHeatFFull, true>,
     heat_probe_xslab_overlap_kernel<kHeatFNoStep, true>,
     heat_probe_xslab_overlap_kernel<kHeatFNoLoad, true>,
     heat_probe_xslab_overlap_kernel<kHeatFRecord, true>}};

// Variant `variant` (kHeatFFull, kHeatFNoStep, kHeatFNoLoad or
// kHeatFRecord) of kernel F's launch, with heat_f_temporal3d's arguments
// after it; k must be 3 and rows 2. Returns a cudaError_t: 0, or the
// reason the launch was refused; or a tensor-map encoding error.
extern "C" int heat_probe_xslab_overlap(int variant, const float* u,
                                        float* out, uint32_t* res,
                                        int64_t nx, int64_t ny, int64_t nz,
                                        int k, int block_x, int block_y,
                                        int rows, int seg, int prefetch,
                                        int tma, float a0, float cx, float cy,
                                        float cz, void* stream) {
  if (variant < 0 || variant > kHeatFRecord || k != kProbeK ||
      rows != kProbeRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return heat_f_launch(kHeatProbeF[tma != 0][variant], u, out, res, nx, ny,
                       nz, k, block_x, block_y, rows, seg, prefetch, tma, a0,
                       cx, cy, cz, stream);
}

// The box F's launch encodes in its tensor map at block_y warps of
// `rows` rows, innermost first, into box[0 .. 2]: the bytes each TMA
// fill lands, which the record variant's expect_tx is held against.
// Returns 0.
extern "C" int heat_probe_xslab_overlap_box(int block_y, int rows,
                                            uint32_t* box) {
  cuuint32_t b[3];
  heat_f_map_box(block_y, rows, b);
  for (int i = 0; i < 3; ++i) box[i] = b[i];
  return 0;
}

extern "C" const char* heat_probe_xslab_overlap_error_string(int code) {
  return heat_tma_error_string(code);
}
