// heat_a_resident — K Jacobi steps in one launch, with the whole grid
// resident in shared memory across the card, and the residual of the
// last step.
//
// Replaces: parallel_heat_tpu/ops/pallas_stencil.py::_build_vmem_multistep
// (pallas_call name "heat_a_vmem_multistep", defined at :117, call :219),
// at storage dtypes float32 (heat_a_resident) and bfloat16
// (heat_a_resident_bf16: the grid widened to float32 as it lands in shared
// memory, each level rounded to bfloat16; heat_a.cuh). A bfloat16 launch
// moves 4 B per cell over HBM instead of 8; the step phase is the same.
//
// Bound on the H100: a launch reads the grid once and writes it once for
// all K steps, 8 B per cell over HBM, plus the halo exchange through L2.
// The arithmetic is 7 float32 operations per cell-step. At the sizes
// this kernel takes (a grid that fits in the card's shared memory, up to
// about 3.4 M cells) neither is what holds it: a step of 1000^2 is 7 M
// operations, about 0.1 us of the card's float32 rate. What costs is
// the issue of each thread's cells per step, the exchange between groups
// of steps and the grid-wide barrier (the anatomy probe,
// tools/kernel_probe.py, measures each; PERF.md has the split).
//
// Design: the TPU kernel keeps the whole double-buffered grid in one
// core's 128 MiB of VMEM and loops K steps with no trip to HBM. An H100
// has 227 KB of shared memory per block, but 132 SMs of it, about 30 MB
// in all, so:
//   - the launch is cooperative: one block of 32 lanes by W warps on each
//     SM it uses, all resident at once, each owning one tile of the grid
//     (ops/hopper_params.py a_tile and a_block pick the tile and W so that
//     the blocks cover the grid and fit on the card, or decline);
//   - a block keeps its tile and a D-deep frame around it in two shared
//     buffers and ping-pongs between them for K steps, so the grid is
//     read from HBM once (4-byte cp.async copies) and written once per
//     launch;
//   - the steps run in groups of D, each step through the register-
//     blocked tile loop of heat_temporal.cuh (heat_rows: a warp a run of
//     rows, a lane 4 adjacent columns in float4 registers, neighbours by
//     shuffle, no test in a block whose framed tile lies inside the
//     interior), on the frame's valid region, which shrinks by one cell a
//     side and step (heat_a.cuh heat_a_steps). After each group but the
//     last, a block writes its tile's D-deep edge band to a global
//     exchange plane, the whole grid synchronises (cooperative_groups
//     grid.sync(), which also orders the writes), and each block reads its
//     frame back from the neighbours' bands, every thread issuing its
//     loads before it stores any. So the grid-wide barrier comes once per
//     D steps, for some redundant work on the frame. The planes alternate
//     by group, so one barrier per group is enough: a plane is rewritten
//     two groups later, after every block has passed the barrier that
//     ends its reads. The plane is read and written at L2
//     (__ldcg/__stcg), never through a stale L1 line. The anatomy probe
//     put the barrier at 10-14% of a step, under the 15% that would pay
//     for each block waiting on its neighbours' flags instead, so the
//     grid barrier stays;
//   - the last step writes the tile straight to the output grid (16 bytes
//     a group where the grid's width allows it) and reduces the residual
//     as heat_b_step does (heat_common.cuh);
//   - global boundary cells are copied, never recomputed, and every
//     step rounds to float32 like a launch of heat_b_step, which makes a
//     launch of K steps bitwise K launches of B. heat_a.cuh says why the
//     cells the loop computes outside a group's cone reach no output.
// The grid is at most a few million cells, so indices are int32; the
// entry point refuses a grid whose two exchange planes pass 2^31 cells.

#include "heat_a.cuh"

// K steps of the m x n float32 grid `u` into `out` (distinct buffers,
// both on the current device) in one cooperative launch of one block per
// tile_y x tile_x tile, exchanging a `depth`-deep halo every `depth`
// steps. `xch` is scratch of 2 * m * n floats for the exchange (unused,
// and may be null, when k <= depth). With `res` non-null, the last
// step's residual bit pattern lands in *res. Launches on `stream` and
// does not synchronise. Returns a cudaError_t: 0, or the reason the
// launch was refused (cudaErrorCooperativeLaunchTooLarge when the blocks
// do not all fit on the card at once).
extern "C" int heat_a_resident(const float* u, float* out, float* xch,
                               uint32_t* res, int64_t m, int64_t n, int k,
                               int depth, int tile_y, int tile_x,
                               int block_x, int block_y, float a0, float cx,
                               float cy, void* stream) {
  return heat_a_launch<kHeatAFull>(u, out, xch, res, m, n, k, depth, tile_y,
                                   tile_x, block_x, block_y, a0, cx, cy,
                                   stream);
}

// heat_a_resident on a bfloat16 grid `u` into the bfloat16 `out`: every
// step computes in float32 and rounds its updated cells to bfloat16, as a
// launch of heat_b_step_bf16 stores them, so K steps are bitwise K
// launches of heat_b_step_bf16 (held on the card by chip_smoke.py's
// kernels_bf16 phase, and a member of heat_m_ensemble_bf16 bitwise this
// kernel on that member alone, there too); the residual is the last
// step's float32 update against the float32 of the level it read. `xch`
// is float32 scratch as above (its values are bfloat16 ones). The
// counterpart of _build_vmem_multistep at dtype bfloat16.
extern "C" int heat_a_resident_bf16(const __nv_bfloat16* u,
                                    __nv_bfloat16* out, float* xch,
                                    uint32_t* res, int64_t m, int64_t n,
                                    int k, int depth, int tile_y, int tile_x,
                                    int block_x, int block_y, float a0,
                                    float cx, float cy, void* stream) {
  return heat_a_launch<kHeatAFull, kHeatLoopFull, __nv_bfloat16>(
      u, out, xch, res, m, n, k, depth, tile_y, tile_x, block_x, block_y, a0,
      cx, cy, stream);
}

extern "C" const char* heat_a_resident_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
