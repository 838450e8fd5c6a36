"""Tile shapes, temporal depth and shared-memory budget for the H100.

Each value says where it comes from: ``data sheet`` (NVIDIA's H100 SXM
data sheet and Hopper tuning notes), ``measured`` (the fastest
bitwise-correct launch shape of the sweep ``python -m
parallel_heat_tpu_torch.bench_kernels`` on an H100 80GB HBM3 at its
700 W limit, 16384^2 float32 plate, 512^3 volume for D and F; PERF.md
has the numbers) or
``chosen`` (a budget rule, not swept). No number here comes from the
TPU tables of the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

# Kernel I's launcher limits, fixed when its kernels compile
# (csrc/heat_i_loop.cuh kIMaxWarps, kIMinRows, kIMaxRows, kIMaxStages):
# warps a block, input rows a stage, stages a warp's ring.
I_MAX_WARPS = 8
I_MIN_ROWS = 3
I_MAX_ROWS = 32
I_MAX_STAGES = 8


def elem_size(dtype) -> int:
    """Bytes of a cell of storage ``dtype`` (a name or a torch dtype) on
    the kernels' paths: 2 at bfloat16, else 4."""
    return 2 if str(dtype) in ("bfloat16", "torch.bfloat16") else 4


@dataclass(frozen=True)
class HopperParams:
    # --- the card (data sheet) ---------------------------------------------
    # Shared memory one block may use (227 KB), and one SM holds (228 KB),
    # less the 1 KB the runtime reserves per resident block.
    smem_per_block_max: int = 232_448
    smem_per_sm: int = 233_472
    smem_reserved_per_block: int = 1_024
    hbm_bytes_per_s: float = 3.35e12
    # float32 outside the tensor cores; an FMA counts as two operations.
    fp32_flops_per_s: float = 67e12

    # --- kernel A: heat_a_resident (data sheet; block and D measured; the
    # cost model chosen) ---------------------------------------------------
    # One cooperative launch holds the whole grid in shared memory: one
    # block of 32 lanes by a_block[1] warps on each SM it uses (132 SMs on
    # the H100 SXM), each block a tile and its D-deep frame in two
    # ping-pong buffers of the tile loop's padded rows (loop_smem_bytes),
    # with one grid-wide barrier and exchange per D steps. a_tile() picks
    # the tile by a_step_cost(): row visits of the busiest warp times its
    # passes of 32 lanes, each pass a_run_visits more for its start, and
    # m_sync_visits / D for a group's exchange and barrier. The sweep
    # (bench_kernels --only a, NVIDIA H100 80GB HBM3 at 700 W, 20 steps
    # with the residual) found 32 x 16 threads and D = 4 fastest at 256^2
    # (0.0196 ms) and 1000^2 (0.0365 ms, 72 x 112 tiles; D = 8 0.0383,
    # D = 2 0.0474, 32 x 8 threads 0.0444); 32 x 16 take the 128
    # registers of the 512-thread bound, so one block an SM, and two
    # blocks an SM of 32 x 8 (on half-height tiles) lost 0.0463 to
    # 0.0365. At 1859^2 D = 2 ran 0.0921 ms against D = 4's 0.1117.
    sm_count: int = 132
    a_block: tuple = (32, 16)
    a_depth: int = 4
    a_run_visits: int = 2

    # --- kernel B: heat_b_step (measured) ----------------------------------
    # 128 x 2 threads, each walking 16 consecutive rows of one column with
    # the rows above and below kept in registers: a 128-wide by 32-row
    # tile per block, so warps read whole 128-byte lines. The sweep's
    # other shapes with 16 rows per thread came within 8%; 4 rows per
    # thread cost up to 45% more.
    b_block: tuple = (128, 2)
    b_rows_per_thread: int = 16

    # --- the register-blocked tile loop of kernels E, E-uni and G
    # (csrc/heat_temporal.cuh; chosen) --------------------------------------
    # A lane owns 4 adjacent columns of its warp's run of rows in float4
    # registers; loop_takes() is the launch shapes it takes: 32 lanes by at
    # most loop_max_warps warps (the kernels' 512-thread launch bound lets
    # them hold their 90-98 registers without spilling), tiles whose width
    # is a multiple of 4. Shared rows are padded to row_floats().
    loop_max_warps: int = 16

    # --- kernels E and E-uni: heat_e_temporal, heat_e_uni_temporal
    # (measured; blocks per SM chosen) --------------------------------------
    # Output tile (rows, cols), thread block (32 lanes x warps) and depth
    # K; E-uni loads each tile as one TMA box (e_box). Per cell-step E
    # moves about 8*(1+2K/TY)*(1+2K/TX)/K bytes through HBM: at 96 x 112
    # and K = 8 that is 1.33 B against B's 8. A 112-wide tile makes the
    # shared row 128 floats at K = 8, one pass of 32 lanes of 4 columns.
    # Two ping-pong buffers of TY+2K padded rows fit twice per SM up to
    # K = 8 at this tile, which is what e_k_max() allows. The sweep
    # (bench_kernels --only e, 16384^2, NVIDIA H100 80GB HBM3 at 700 W)
    # found 96 x 112, 32 x 8 threads (14 rows a warp) and K = 8 fastest a
    # step, of 7 tiles, 3 thread blocks and K = 4 .. 16, for E, for E-uni
    # and for E-uni under its earlier load (16-byte cp.async copies,
    # removed): 1.7715, 1.5190 and 1.7875 ms; 32 x 4 threads 2.1165,
    # 1.7333 and 2.1636, 32 x 16 (one block an SM) 2.7144, 2.3249 and
    # 2.577. TMA won by the launch's fixed share: E-uni took 0.880, 1.190
    # and 1.519 ms at K = 4, 6, 8, by cp.async 1.126, 1.460 and 1.788.
    e_tile: tuple = (96, 112)
    e_block: tuple = (32, 8)
    e_k_default: int = 8
    e_min_blocks_per_sm: int = 2
    # The bfloat16 forms (csrc/heat_temporal.cuh kHeatForm*): the shared
    # buffers hold float32 at every storage dtype (a bfloat16 tile is
    # widened as it lands), so the loop's launch shapes and buffers are
    # float32's; E-uni's bfloat16 box lands in a stage over the second
    # buffer (e_smem_bytes). Under accumulate="f32chunk" a chunk is
    # F32CHUNK_DEPTH = 16 steps (ops/stencil.py), deeper than e_k_max():
    # it runs as two launches of e_k_default steps across a float32 grid
    # (stencil_kernels._carry_chunks), which beat one launch of 16 at a
    # shorter tile (PERF.md section 6).

    # --- kernels I and I-uni: heat_i_tile_temporal and
    # heat_i_uni_tile_temporal (measured) ------------------------------------
    # A warp streams one band of 128 columns (32 lanes of 4), so a band is
    # 128 - 2 i_pad(K) output columns at depth K (1 <= K <= 8, the kernels'
    # range); i_warps bands side by side make a block, and each warp's
    # rows arrive in a ring of i_stages stages of i_rows rows
    # (csrc/heat_i_loop.cuh). Rows are cut into segments so that the
    # launch is i_waves waves of i_blocks_per_sm blocks an SM (the
    # kernels' 128-register bound lets an SM hold 16 warps), but not below
    # i_seg_rows_min rows: a segment recomputes 2K rows.
    # The sweep (bench_kernels --only i, 16384^2, K = 8, NVIDIA H100 80GB
    # HBM3 at 700 W) found 2 warps, stages of 4 rows, 2 or 3 stages and
    # segments of 128 to 192 rows fastest: I-uni 1.047 ms, I 1.208 (4
    # warps 1.126 and 1.301 at 72-row segments; one wave of 1171-row
    # segments 1.385 and 1.621).
    i_warps: int = 2
    i_rows: int = 4
    i_stages: int = 3
    i_k_default: int = 8
    i_k_max: int = 8
    i_blocks_per_sm: int = 8
    i_waves: int = 8
    i_seg_rows_min: int = 64

    # --- kernel C: heat_c_tiled (chosen) -----------------------------------
    # Output tile (rows, cols) and thread block: a 32 x 128 tile plus its
    # one-cell ring, 17 KB of shared memory, so several blocks stay
    # resident per SM; each warp takes 32 neighbouring columns of a row.
    c_tile: tuple = (32, 128)
    c_block: tuple = (32, 8)
    # Static shared memory of every kernel: the 32-slot residual
    # reduction scratch of csrc/heat_common.cuh.
    static_smem_bytes: int = 128

    # --- kernel D: heat_d_step3d (measured) -------------------------------
    # Thread block (along Z, along Y): each thread walks d_planes
    # consecutive X planes of one (y, z) column, x-1, x and x+1 in
    # registers, and reads its Y and Z neighbours from global memory
    # through L1, as B does in 2D. No shared memory beyond the residual
    # scratch, so L1 keeps the SM's whole 256 KB. 32 x 4 threads and 16
    # planes were the fastest of the sweep at 512^3; every block shape
    # with 16 to 64 planes came within 7%, 4 planes cost up to 55% more.
    d_block: tuple = (32, 4)
    d_planes: int = 16

    # --- kernel F: heat_f_temporal3d (shape, rows, K, prefetch and
    # segments measured; the shape rule chosen) ---------------------------
    # The register-blocked plane loop (csrc/heat_temporal3d.cuh
    # HeatFLoop): a (Y, Z) tile streamed down X with all K levels in
    # flight; f_block = (32 lanes, warps), each lane 4 adjacent z cells of
    # f_rows consecutive rows, so the extended tile is 128 cells along Z
    # by warps * f_rows rows, and the output tile that less K rows a side
    # along Y and f_pad(K) cells a side along Z (f_tile). f_takes() is the
    # launch shapes the loop takes. Shared memory per block
    # (f_smem_bytes): f_prefetch + 2 input planes of the tile and two
    # edge-row buffers for each level 1 .. K-1. K is compiled for 1 ..
    # f_k_compiled, rows for 1, 2 and 4. X is cut into segments so that
    # the launch holds about f_waves blocks per SM, but not below
    # f_seg_planes_min planes: a segment recomputes 2K planes. Each plane
    # arrives by TMA where nz % 4 == 0 (f_load), else by cp.async.
    # The sweep (bench_kernels --only f, 512^3, NVIDIA H100 80GB HBM3 at
    # 700 W, all 106 launches bitwise) found 32 x 16 threads of 2 rows at
    # K = 3 under TMA fastest a step: 0.5574 ms a launch (0.1858 a step),
    # 0.7577 by cp.async; 32 x 12 of 2 rows 0.2101 a step, 32 x 8 of 4
    # rows 0.2299, 32 x 16 of 1 row 0.2866; K = 2 0.2305 a step, K = 4
    # 0.2647 (its instance spills). One block of 16 warps an SM (122
    # registers). Segments of 48 to 64 planes came within 1% (32: 2.7%
    # slower, 512: 22%); 3 to 6 planes in flight within 1%, 1 plane 15%
    # slower.
    # Past the default shape's deepest K (f_k_max(), 4: K = 4 is the last
    # whose planes fit, and it spills) F launches at the first of
    # f_deep_shapes that takes K (f_shape): at K = 5 to 8 in the sweep
    # 32 x 8 of 4 rows came within 5% of the best shape that takes K
    # (0.3837 against 0.3669 ms a step at K = 5), and it takes every K
    # through 8 (at K = 8 with 3 planes in flight).
    f_block: tuple = (32, 16)
    f_rows: int = 2
    f_deep_shapes: tuple = (((32, 8), 4), ((32, 16), 1))
    f_prefetch: int = 4
    f_prefetch_max: int = 8
    f_k_default: int = 3
    f_k_compiled: int = 8
    f_waves: int = 8
    f_seg_planes_min: int = 64
    f_width: int = 128

    # --- kernel M: heat_m_ensemble (cost model chosen; measured) ---------
    # A member is cut into tiles as kernel A cuts its grid, on A's step
    # phase and thread block; a group of one block per tile holds one
    # member, and sm_count // tiles groups walk the members. m_plan()
    # picks the tile and the halo depth by the modelled cost of a launch:
    # rounds of members times A's modelled step (a_step_cost, in row
    # visits of a warp), plus m_sync_visits for each grid-wide barrier and
    # exchange, a group of D steps. A member whose framed tile fits one
    # block runs one block per member with a one-cell frame and thread
    # blocks of about m_solo_rows_per_thread rows a warp. The sweep
    # (bench_kernels --only m, 64 members, 20 steps with the residuals)
    # found the model's first plan fastest at 512^2 (256 x 88 tiles at
    # D = 8, 0.479 ms; 128 x 172 at D = 8 0.499, two blocks an SM of
    # 32 x 8 on 128 x 88 tiles 0.500) and one block a member of 32 x 16
    # fastest at 128^2 (0.0454 ms; 32 x 8 0.0498, two tiles 0.0534).
    m_depths: tuple = (4, 8)
    m_sync_visits: int = 25
    m_solo_rows_per_thread: int = 8

    # --- the sharded block kernels heat_g_* (measured) -------------------
    # A block's output tile (rows, cols), thread block (32 lanes x warps)
    # and default depth K. The register-blocked tile loop
    # (csrc/heat_temporal.cuh) gives each lane 4 adjacent columns of its
    # warp's run of ceil((TY + 2K) / warps) rows (loop_takes()).
    # g_k_max() is the deepest K that keeps e_min_blocks_per_sm blocks
    # resident by shared memory (g_smem_bytes: two buffers of TY + 2K
    # rows, each padded to row_floats). The sweep (bench_kernels --only
    # g, the 16384 x 8192 block of 32768^2 on a (2, 4) mesh, NVIDIA H100
    # 80GB HBM3 at 700 W) found 96 x 112, 32 x 8 threads (14 rows a warp)
    # and K = 8 fastest: 0.930 ms for G-uni's deferred bulk and 0.953 for
    # G-fuse monolithic, the other 17 shapes at K = 8 1.02-2.35 ms (32 x
    # 16 threads hold one block an SM: 1.311); K = 4 and 6 took 0.146 and
    # 0.127 ms a step against 0.116. (E's column walk, the loop before,
    # took 1.263 ms at this shape.) Persistent blocks that walk the tiles
    # with the next tile's load in flight into a third buffer lost (1.187
    # ms at best, 56 x 112, against 0.978 here, in the sweep before the
    # loop's last row was peeled). The band kernel fixes every block's
    # K-row bands in one launch a round, in tiles of g_band_tile_x columns
    # under g_band_block. The sweep (bench_kernels --only band: the round
    # launch over the 8 blocks of 32768^2 on (2, 4), K = 8, ranked by
    # torch.profiler device time; NVIDIA H100 80GB HBM3 at 700.00 W)
    # found 112 columns under 32 x 2 threads fastest (1184 thread blocks,
    # 9 an SM by shared memory): by the per-cell load 0.0350 ms, 112 x (32
    # x 4) 0.0361, 240 x (32 x 8), the shape before, 0.0412, 496 x (32 x
    # 8) 0.0483, 48-column tiles 0.0517-0.1202; by the row load
    # (g_band_row_load) 0.0309, 240 x (32 x 4) 0.0313, 240 x (32 x 8)
    # 0.0351, 496 x (32 x 8) 0.0376, 48 x (32 x 8) 0.0879. The loads in
    # turns at 112 x (32 x 2) (the sweep's last rows): per cell 0.03536,
    # rows 0.03138, none (the steps alone) 0.02047, so the per-cell load
    # was 42% of the launch and the row load is 35%.
    g_tile: tuple = (96, 112)
    g_block: tuple = (32, 8)
    g_k_default: int = 8
    g_band_tile_x: int = 112
    g_band_block: tuple = (32, 2)

    # --- the sharded 3D block kernels heat_h_* (block, rows and K
    # measured; prefetch, waves and segments chosen) ----------------------
    # The step phase heat_f_levels on the (Y, Z) tiles of one block
    # (csrc/heat_h.cuh), one z cell a thread:
    # h_block = (along Z, along Y) threads, h_rows rows a thread, depth
    # h_k_default, X segments of about h_waves blocks per SM but not below
    # h_seg_planes_min planes. The prefetch is h_prefetch (the step
    # phase's compiled kFPrefetch) for the cp.async load, h_tma_prefetch
    # for the TMA load; K is compiled for 1 .. h_k_compiled, rows for 1,
    # 2 and 4. The sweep bench_kernels --only h (H-fused's deferred bulk
    # at the 512^3 block of 1024^3 on a (2, 2, 2) mesh, the TMA load where
    # the geometry takes it, H100 80GB HBM3 at 700 W) found 32 x 16
    # threads of 4 rows at K = 3 fastest per step, 1.0345 ms a launch
    # (0.3448 ms a step), against 1.1354 at 32 x 16 of 2 rows (cp.async;
    # 1.1745 while edge tiles chose a piece per cell); 64 x 8 of 4 rows
    # 0.3490 a step, K = 2 and 4 0.3796 and 0.3676; segments of 64 to 128
    # planes within 2%, 512 42% slower. With each edge row's piece fixed
    # for the run, the taller tile (26 x 58 output cells of 32 x 64) pays.
    h_block: tuple = (32, 16)
    h_rows: int = 4
    # The cp.async ring's planes in flight (csrc/heat_temporal3d.cuh's
    # kFPrefetch must equal it).
    h_prefetch: int = 6
    h_k_default: int = 3
    h_k_compiled: int = 8
    h_waves: int = 8
    h_seg_planes_min: int = 64
    # H-fused's TMA plane load (chosen): h_tma_prefetch boxes in flight
    # (csrc/heat_temporal3d.cuh's kTmaPrefetch must equal it), each 4
    # cells wider than the extended tile, since a box starts at a z that
    # is a multiple of 4 cells (h_tma_smem_bytes has the layout); its
    # instances are compiled at h_tma_rows rows a thread only
    # (csrc/heat_h.cuh's kHTmaRows must equal it). The bfloat16 form
    # keeps h_tma_prefetch planes in flight under both loads (its boxes 8
    # cells wider; h_bf16_smem_bytes) and is compiled at h_tma_rows only.
    h_tma_prefetch: int = 4
    h_tma_rows: int = 4

    # --- kernel H: heat_h_block_3d on F's plane loop (measured) ----------
    # The assembled circular block's tiles step through kernel F's
    # register-blocked plane loop (csrc/heat_h_block_3d.cu), F's shape
    # rule (f_takes) and shared layout (f_smem_bytes): the first of
    # hc_shapes ((32 lanes, warps), rows a thread) that takes K, with the
    # most planes in flight that fit, up to hc_prefetch (hc_shape); X
    # segments of about hc_waves blocks an SM, at least hc_seg_planes_min
    # planes. The circular block's rows are padded to a multiple of 4
    # floats (hc_pitch) so that its tiles that need no lo cell load each
    # plane as one TMA box. The sweep (bench_kernels --only h, the 512^3
    # block of 1024^3 on (2, 2, 2), block 7, TMA; NVIDIA H100 80GB HBM3
    # at 700.00 W) found 32 x 16 of 2 rows fastest at K = 1 .. 6 (K = 3
    # 0.7286 ms, 32 x 12 of 2 rows 0.8181, of 1 row 0.8885, 32 x 8 of 4
    # rows 1.2804; K = 4 0.9588 ms, the least a step; K = 5 and 6 with 3
    # and 1 planes in flight, 1.4047 and 2.2264 against 2.762 and 3.687 at
    # 32 x 8 of 4 rows) and 32 x 12 of 2 rows at K = 7 and 8 (4.5917 and
    # 29.25 ms, the <8, 2> instance spilling, against 5.097 and 39.39 at
    # 32 x 8 of 4 rows); at K = 4, 64-plane segments (32 0.9786, 128
    # 1.0396, 512 1.7694) and 4 planes in flight (1 0.9675, 3 0.9581,
    # 4 0.9563) best.
    hc_shapes: tuple = (((32, 16), 2), ((32, 12), 2))
    hc_prefetch: int = 4
    hc_waves: int = 8
    hc_seg_planes_min: int = 64

    # --- the 3D band heat_h_band_fix_3d on F's plane loop (measured) -----
    # Every block's bands of a round in one launch (a table of blocks,
    # csrc/heat_h_band_fix_3d.cu), a thread block stepping one (Y, Z)
    # tile of one region (K output planes from 3K input planes) on F's
    # register-blocked plane loop, F's tiles over the block: the first of
    # h_band_shapes ((32 lanes, warps), rows a thread; rows 2 and 4 are
    # compiled) that takes K, with the most planes in flight that fit, up
    # to h_band_prefetch (h_band_shape). Its loads: a 4-byte cp.async a
    # cell, or a 16-byte one where a lane's four cells are one aligned run
    # of the block (h_band_vec_fits). A thread block steps one tile of one
    # block's region. The sweep (bench_kernels --only hband: the round
    # launch over the 8 blocks of 1024^3 on (2, 2, 2), K = 3, ranked by
    # torch.profiler device time; NVIDIA H100 80GB HBM3 at 700.00 W) found
    # 32 x 16 threads of 2 rows, 6 planes in flight, the 16-byte load
    # fastest: 0.2008 ms (4-byte load 0.2106; 4, 3, 2 planes 0.2041,
    # 0.2085, 0.2096; 32 x 12 of 2 rows 0.2473 at best, 32 x 8 of 2 rows
    # 0.2681, 32 x 8 of 4 rows 0.3074). A thread block stepping its tile
    # over a chain of 2, 4, 8 or 16 regions in one ring was slower (0.2229,
    # 0.2463, 0.2409, 0.2582) and is gone.
    h_band_shapes: tuple = (((32, 16), 2), ((32, 12), 2))
    h_band_prefetch: int = 6

    # --- kernels heat_mg_restrict and heat_mg_prolong (measured) ----------
    # Restrict: a thread takes mg_restrict_cells() (rows, columns) of
    # coarse cells (csrc/heat_mg_restrict.cu compiles 1 x 1, 1 x 2 and
    # 2 x 2); prolong: a thread a coarse cell, the 2 x 2 fine cells it
    # spans. Thread blocks are (lanes along a row, rows). The sweep
    # (bench_kernels --only mg, NVIDIA H100 80GB HBM3 at 700 W, profiler
    # device time, two runs): restrict at 512^2 -> 257^2 (0.24 of a wave
    # of threads at 1 x 1) 1 x 1 0.00161-0.00165 ms, 1 x 2 at best
    # 0.00165, 2 x 2 at best 0.00174; at 2050^2 -> 1025^2 (3.9 waves)
    # 2 x 2 under 32 x 4 0.00608, 1 x 2 0.00673, 1 x 1 0.00745; at
    # 4098^2 -> 2050^2 2 x 2 under 32 x 4 0.02984, 1 x 2 0.02942, 1 x 1
    # 0.03063. More cells a thread pay once 1 x 1 threads fill the card's
    # thread slots (sm_count x 2048), and cost where a short wave's
    # latency sets the time. Prolong 64 x 4: 0.03174 ms at 2050^2 ->
    # 4098^2, 0.00693 at 1025^2 -> 2050^2, 0.00140 at 257^2 -> 512^2;
    # every block within 4% of the best, but 32 x 16 and 64 x 8 at 4098^2.
    mg_restrict_block: tuple = (32, 4)
    mg_prolong_block: tuple = (64, 4)

    def mg_restrict_cells(self, coarse_shape) -> tuple:
        """Coarse cells (rows, columns) a restrict thread takes on a
        coarse level of ``coarse_shape``: 2 x 2 where the level has at
        least a wave of cells (``sm_count`` x 2048, the threads the card
        holds at once), else 1 x 1."""
        rows, cols = coarse_shape
        return (2, 2) if rows * cols >= self.sm_count * 2048 else (1, 1)

    def m_smem_bytes(self, tile, depth) -> int:
        """Dynamic shared memory of one M block at ``tile``: the tile
        loop's two buffers at the halo depth (:meth:`loop_smem_bytes`)."""
        return self.loop_smem_bytes(depth, tile)

    def m_solo_plan(self, batch, shape, block=None):
        """Kernel M's launch of one block per member, or None when a
        member with its one-cell frame does not fit one block: the tile is
        the member (:meth:`a_takes`)."""
        m, n = shape
        tile = (m, n)
        budget = self.smem_per_block_max - self.static_smem_bytes
        if self.m_smem_bytes(tile, 1) > budget:
            return None
        warps = -(-(m + 2) // self.m_solo_rows_per_thread)
        return {"tile": tile, "depth": 1, "tiles": 1, "groups": batch,
                "block": block or (32, max(1, min(self.loop_max_warps,
                                                  warps)))}

    def m_tilings(self, batch, shape, depth=None, block=None):
        """Every launch of kernel M that cuts a member of ``(m, n)`` into
        two or more tiles (the last ones cut at the edge), at most
        ``sm_count`` of them, each within one block's shared memory and
        of a width :meth:`a_takes` takes, under A's thread block by
        default: a list of plans, each with its modelled ``cost``,
        ``rounds * (a_step_cost + m_sync_visits / depth)``."""
        m, n = shape
        d = self.a_depth if depth is None else depth
        block = block or self.a_block
        budget = self.smem_per_block_max - self.static_smem_bytes
        plans = []
        widths = sorted({-(-(-(-n // q)) // 4) * 4
                         for q in range(1, min(self.sm_count, n) + 1)})
        for tx in widths:
            n_col = -(-n // tx)
            tx = min(tx, n)
            for n_row in range(1, min(m, self.sm_count // n_col) + 1):
                ty = -(-m // n_row)
                tiles = n_col * n_row
                if (-(-m // ty) != n_row or tiles == 1
                        or self.m_smem_bytes((ty, tx), d) > budget):
                    continue
                groups = min(batch, self.sm_count // tiles)
                step = self.a_step_cost((ty, tx), d, block)
                plans.append({
                    "tile": (ty, tx), "depth": d, "tiles": tiles,
                    "groups": groups, "block": block,
                    "cost": -(-batch // groups)
                    * (step + self.m_sync_visits / d)})
        return plans

    @functools.lru_cache(maxsize=64)
    def m_plan(self, batch, shape):
        """Kernel M's launch for ``batch`` members of ``(m, n)``:
        ``{"tile", "depth", "tiles", "groups", "block"}``, or None when a
        member does not fit resident on the card.

        A member that fits one block takes :meth:`m_solo_plan` (``tiles
        == 1``, ``groups == batch``). Otherwise ``groups`` groups of
        ``tiles`` blocks take the members in rounds, and the plan is the
        tiling of :meth:`m_tilings`, over the depths ``m_depths``, with
        the least cost, then the fewest blocks, then the tallest tile.

        The plan is the same at both storage dtypes: a bfloat16 launch
        (``heat_m_ensemble_bf16``) widens each tile as it lands, and its
        shared buffers and exchange planes hold float32, as a float32
        launch's do."""
        solo = self.m_solo_plan(batch, tuple(shape))
        if solo is not None:
            return solo
        return min((p for d in self.m_depths
                    for p in self.m_tilings(batch, tuple(shape), d)),
                   key=lambda p: (p["cost"], p["groups"] * p["tiles"],
                                  -p["tile"][0]), default=None)

    def f_extent(self, block=None, rows=None):
        """Kernel F's extended tile ``(rows along Y, cells along Z)``."""
        _, warps = block or self.f_block
        return warps * (rows or self.f_rows), self.f_width

    @staticmethod
    def f_pad(k: int, elem: int = 4) -> int:
        """Kernel F's halo along Z at depth ``k`` on a grid of
        ``elem``-byte cells: ``k`` rounded up to 16 bytes of cells (a
        group of 4 float32 cells, 8 bfloat16 ones), so that a tile's box
        starts on 16 bytes (``csrc/heat_temporal3d.cuh`` ``heat_f_pad``).
        """
        cells = 16 // elem
        return -(-k // cells) * cells

    def f_tile(self, k: int, block=None, rows=None, elem: int = 4):
        """Kernel F's output tile ``(rows along Y, cells along Z)`` at
        depth ``k`` on a grid of ``elem``-byte cells."""
        wy, wz = self.f_extent(block, rows)
        return wy - 2 * k, wz - 2 * self.f_pad(k, elem)

    @staticmethod
    def f_max_warps(rows: int, k: int = 1, elem: int = 4) -> int:
        """Warps an F block of ``rows`` rows a thread may have at depth
        ``k`` on a grid of ``elem``-byte cells, its instances' launch
        bound (``csrc/heat_temporal3d.cuh`` ``heat_f_max_warps``): 16
        (up to 128 registers), 8 at 4 rows (up to 255), and 12 for the
        bfloat16 form's 1- and 2-row instances at K >= 4 (up to 168: at
        128 they spilled more than their float32 twins)."""
        return 8 if rows == 4 else 12 if elem == 2 and k >= 4 else 16

    def f_takes(self, block, rows, k: int, elem: int = 4) -> bool:
        """Does F's plane loop take thread blocks of ``block`` ``(lanes,
        warps)`` with ``rows`` rows a thread at depth ``k`` on a grid of
        ``elem``-byte cells? 32 lanes (a warp spans the tile's 128 cells
        along Z), 1, 2 or 4 rows, at most :meth:`f_max_warps` warps, a
        compiled depth, and an output row (2k < warps * rows).
        ``csrc/heat_temporal3d.cuh`` ``heat_f_takes`` is the same rule."""
        lanes, warps = block
        return (lanes == 32 and rows in (1, 2, 4)
                and 1 <= warps <= self.f_max_warps(rows, k, elem)
                and 1 <= k <= self.f_k_compiled and 2 * k < warps * rows)

    def f_smem_bytes(self, k: int, block=None, rows=None,
                     prefetch=None, elem: int = 4) -> int:
        """Dynamic shared memory of one F block at depth ``k`` on a grid
        of ``elem``-byte cells (``csrc/heat_temporal3d.cuh``
        ``heat_f_smem_bytes``): 128 bytes to align the ring;
        ``prefetch + 2`` input planes of the extended tile in the grid's
        cells, each with a lead and a tail row; two float32 buffers for
        each level 1 .. K-1 of ``min(rows, 2)`` edge rows a warp and two
        pad rows; an 8-byte mbarrier a plane."""
        _, warps = block or self.f_block
        rows = rows or self.f_rows
        slots = (prefetch or self.f_prefetch) + 2
        wy, wz = self.f_extent(block, rows)
        edge = (min(rows, 2) * warps + 2) * wz
        return (elem * slots * (wy + 2) * wz + 4 * 2 * (k - 1) * edge + 128
                + 8 * slots)

    @functools.lru_cache(maxsize=64)
    def f_k_max(self, block=None, rows=None, prefetch=None,
                elem: int = 4) -> int:
        """Deepest K that F's shape takes (:meth:`f_takes`, so compiled
        and leaving an output row) and whose planes fit one block's shared
        memory, on a grid of ``elem``-byte cells."""
        block, rows = block or self.f_block, rows or self.f_rows
        k = 0
        while (self.f_takes(block, rows, k + 1, elem)
               and self.f_smem_bytes(k + 1, block, rows, prefetch, elem)
               + self.static_smem_bytes <= self.smem_per_block_max):
            k += 1
        return k

    @functools.lru_cache(maxsize=16)
    def f_shape(self, k: int, elem: int = 4):
        """``(block, rows, prefetch)``: F's launch shape at depth ``k`` on
        a grid of ``elem``-byte cells, the default (``f_block``,
        ``f_rows``, ``f_prefetch``) where it takes ``k``, else the first
        of ``f_deep_shapes`` that does with the most planes in flight that
        fit, up to ``f_prefetch``; None where no shape takes ``k``. The
        default shape's depths at bfloat16 are at most the float32 grid's
        (its registers, not its shared memory, bound it: K = 4 already
        spills at 2 rows a thread), and its 16 warps take the bfloat16
        form to K = 3 (:meth:`f_max_warps`), so at K = 4 a bfloat16
        launch takes the first deep shape."""
        if 1 <= k <= min(self.f_k_max(), self.f_k_max(elem=elem)):
            return self.f_block, self.f_rows, self.f_prefetch
        for block, rows in self.f_deep_shapes:
            for prefetch in range(self.f_prefetch, 0, -1):
                if k <= self.f_k_max(block, rows, prefetch, elem):
                    return block, rows, prefetch
        return None

    def f_tma_fits(self, shape, dtype="float32") -> bool:
        """Does an ``(X, Y, Z)`` grid of ``dtype`` take F's TMA plane
        load? A tensor map's strides are multiples of 16 bytes, so
        ``nz % 4 == 0`` at float32 and ``nz % 8 == 0`` at bfloat16 (the
        box, 128 cells by the tile's rows, always fits TMA's 256 a
        dimension); the launch also needs the grid 16-byte aligned."""
        return shape[2] % (16 // elem_size(dtype)) == 0

    def f_launch(self, shape, k, block=None, rows=None, elem: int = 4):
        """Kernel F's ``(tile_y, tile_z, segment planes)`` at depth ``k``
        for an ``(X, Y, Z)`` grid of ``elem``-byte cells, at
        :meth:`f_shape`'s block and rows by default."""
        if block is None:
            block, rows, _ = self.f_shape(k, elem)
        x, y, z = shape
        tile_y, tile_z = self.f_tile(k, block, rows, elem)
        tiles = -(-y // tile_y) * -(-z // tile_z)
        segments = -(-self.sm_count * self.f_waves // tiles)
        return tile_y, tile_z, max(self.f_seg_planes_min, -(-x // segments))

    def f_tile_kinds(self, shape, k: int, block=None, rows=None,
                     elem: int = 4) -> dict:
        """The tiles of an F launch at depth ``k`` on an ``(X, Y, Z)``
        grid, counted by the branches they run: ``interior`` (the extended
        tile lies inside the grid's interior: the test-free step) and
        ``edge`` (it reaches past it: cells copied), of those ``top``,
        ``left``, ``bottom`` and ``right`` (the tile's box reaches past
        that side of the grid along Y or Z: zeros from TMA, or zero-filled
        copies), ``ragged_y`` and ``ragged_z`` (the last tile cut short)
        and ``partial_group`` (a tile whose last output group along Z has
        fewer than 4 cells: cell-by-cell stores)."""
        _, ny, nz = shape
        wy, wz = self.f_extent(block, rows)
        ty, tz = self.f_tile(k, block, rows, elem)
        pad = self.f_pad(k, elem)
        kinds = dict.fromkeys(("tiles", "interior", "edge", "top", "left",
                               "bottom", "right", "ragged_y", "ragged_z",
                               "partial_group"), 0)
        for a in range(0, ny, ty):
            for c in range(0, nz, tz):
                y0, z0 = a - k, c - pad
                kinds["tiles"] += 1
                kinds["top"] += y0 < 0
                kinds["left"] += z0 < 0
                kinds["bottom"] += y0 + wy > ny
                kinds["right"] += z0 + wz > nz
                kinds["edge" if (y0 < 1 or z0 < 1 or y0 + wy > ny - 1
                                 or z0 + wz > nz - 1) else "interior"] += 1
                kinds["ragged_y"] += ny - a < ty
                kinds["ragged_z"] += nz - c < tz
                kinds["partial_group"] += min(tz, nz - c) % 4 != 0
        return kinds

    def h_extent(self, block=None, rows=None):
        """An H kernel's extended tile ``(rows along Y, cells along Z)``:
        ``block`` = (along Z, along Y) threads, ``rows`` rows a thread."""
        bz, by = block or self.h_block
        return by * (rows or self.h_rows), bz

    def h_smem_bytes(self, k: int, block=None, rows=None) -> int:
        """Dynamic shared memory of one H block at depth ``k`` under the
        cp.async load (csrc/heat_temporal3d.cuh heat_t3d_smem_bytes):
        h_prefetch + 2 input planes and two planes for each level
        1 .. K-1, each padded by one row above and below."""
        wy, wz = self.h_extent(block, rows)
        return (self.h_prefetch + 2 + 2 * (k - 1)) * (wy + 2) * wz * 4

    @functools.lru_cache(maxsize=16)
    def h_k_max(self, block=None, rows=None) -> int:
        """Deepest K an H kernel takes at ``h_block`` and ``h_rows``: the
        compiled depths, at least one output cell per axis of the tile,
        and the planes within one block's shared memory."""
        block, rows = block or self.h_block, rows or self.h_rows
        wy, wz = self.h_extent(block, rows)
        k = 0
        while (k + 1 <= self.h_k_compiled and 2 * (k + 1) < min(wy, wz)
               and max(self.h_smem_bytes(k + 1, block, rows),
                       self.h_tma_smem_bytes(k + 1, block, rows),
                       self.h_bf16_smem_bytes(k + 1, block, rows))
               + self.static_smem_bytes <= self.smem_per_block_max):
            k += 1
        return k

    def h_bf16_smem_bytes(self, k: int, block=None, rows=None) -> int:
        """Dynamic shared memory of one block of H-fused's bfloat16 form
        at depth ``k``, under every load (csrc/heat_temporal3d.cuh
        heat_h_bf16_smem_bytes): 128 bytes of alignment, h_tma_prefetch
        staging slots of 4 bytes a thread and row (the word that holds
        its cell, or a box of the extended tile 8 cells wider), three
        float32 ring planes and two for each level 1 .. K-1, each padded
        by one row above and below, and one 8-byte mbarrier a slot."""
        wy, wz = self.h_extent(block, rows)
        slots = self.h_tma_prefetch
        return (128 + slots * 4 * wz * wy
                + 4 * (3 + 2 * (k - 1)) * (wy + 2) * wz + 8 * slots)

    def h_tma_smem_bytes(self, k: int, block=None, rows=None) -> int:
        """Dynamic shared memory of one H-fused block at depth ``k`` under
        the TMA load (csrc/heat_temporal3d.cuh heat_t3d_tma_smem_bytes):
        h_tma_prefetch + 2 input planes and two planes for each level
        1 .. K-1, each a lead of at least one row and 128-byte aligned,
        the tile's rows of wz + 4 cells and a bottom row, rounded up to
        128 bytes; 128 bytes of alignment and one 8-byte mbarrier a
        slot."""
        wy, wz = self.h_extent(block, rows)
        row = wz + 4
        lead = -(-row // 32) * 32
        plane = -(-(lead + (wy + 1) * row) // 32) * 32
        slots = self.h_tma_prefetch + 2
        return 4 * (slots + 2 * (k - 1)) * plane + 128 + 8 * slots

    def h_tma_fits(self, block_shape, k: int, block=None, rows=None,
                   elem: int = 4) -> bool:
        """Do the tiles inside a ``(bx, by, bz)`` block of ``elem``-byte
        cells take H-fused's TMA plane load at depth ``k``? TMA copies
        rows of a multiple of 16 bytes, so ``bz % 4 == 0`` (``bz % 8 ==
        0`` at bfloat16, ``elem`` 2); its instances take ``h_tma_rows``
        rows a thread; the block is at least a box wide
        (:meth:`h_tma_box`); and at least one tile must lie inside the
        block (:meth:`h_tiles`), or no tile would run it. Elsewhere the
        tiles take the cp.async load (at bfloat16 a 4-byte word a cell).
        ``csrc/heat_h.cuh`` ``heat_h_tma_fits`` is the same
        rule, with the block's address a multiple of 16 bytes."""
        _, by, bz = block_shape
        wy, wz = self.h_tma_box(block, rows, elem)
        return (bz % (16 // elem) == 0
                and (rows or self.h_rows) == self.h_tma_rows
                and bz >= wz and wz <= 256
                and self.h_tiles(block_shape, k, block, rows)[0] > 0)

    def h_tiles(self, block_shape, k: int, block=None, rows=None):
        """``(interior, edge)``: the (Y, Z) tiles of an H launch at depth
        ``k`` on a ``(bx, by, bz)`` block whose extended tile lies inside
        the block, and the others (csrc/heat_h.cuh's split). Tile ``t``
        of width ``w`` (extended) covers ``[t (w - 2k) - k, ... + w)``,
        so tile 0 never lies inside; at the defaults and K = 3 a block
        holds one from 2w - 3K cells on, 119 x 55 (Y, Z)."""
        _, by, bz = block_shape
        wy, wz = self.h_extent(block, rows)

        def inside(n, w):
            tiles = -(-n // (w - 2 * k))
            return tiles, sum(1 for t in range(1, tiles)
                              if t * (w - 2 * k) - k >= 0
                              and t * (w - 2 * k) - k + w <= n)

        (ny, iy), (nz, iz) = inside(by, wy), inside(bz, wz)
        return iy * iz, ny * nz - iy * iz

    def h_tma_box(self, block=None, rows=None, elem: int = 4):
        """The TMA load's box ``(rows along Y, cells along Z)`` on
        ``elem``-byte cells: the extended tile, 16 bytes of cells wider
        (4 float32, 8 bfloat16), since a box starts at a z that is a
        multiple of 16 bytes."""
        wy, wz = self.h_extent(block, rows)
        return wy, wz + 16 // elem

    def h_launch(self, block_shape, k, planes, block=None, rows=None) -> int:
        """The X segment of an H launch at depth ``k`` over ``planes``
        output planes of a ``(bx, by, bz)`` block: about ``h_waves``
        blocks per SM, at least ``h_seg_planes_min`` planes."""
        _, by, bz = block_shape
        wy, wz = self.h_extent(block, rows)
        tiles = -(-by // (wy - 2 * k)) * -(-bz // (wz - 2 * k))
        segments = -(-self.sm_count * self.h_waves // tiles)
        return max(self.h_seg_planes_min, -(-planes // segments))

    @staticmethod
    def hc_pitch(ze: int, elem: int = 4) -> int:
        """Kernel H's circular block row pitch for rows of ``ze`` cells of
        ``elem`` bytes: rounded up to 16 bytes (4 float32 cells, 8
        bfloat16 ones), what a tensor map's strides need."""
        cells = 16 // elem
        return -(-ze // cells) * cells

    @functools.lru_cache(maxsize=32)
    def hc_shape(self, k: int, elem: int = 4):
        """``(block, rows, prefetch)``: kernel H's launch shape at depth
        ``k`` on blocks of ``elem``-byte cells, the first of ``hc_shapes``
        that takes ``k`` (:meth:`f_takes` and one block's shared memory,
        :meth:`f_k_max`, F's rules at ``elem``) with the most planes in
        flight that fit, up to ``hc_prefetch``; None where no shape takes
        ``k``."""
        for block, rows in self.hc_shapes:
            for prefetch in range(self.hc_prefetch, 0, -1):
                if 1 <= k <= self.f_k_max(block, rows, prefetch, elem):
                    return block, rows, prefetch
        return None

    def hc_k_max(self, elem: int = 4) -> int:
        """Deepest K that kernel H takes at some shape (:meth:`hc_shape`)
        on blocks of ``elem``-byte cells."""
        return max(k for k in range(1, self.f_k_compiled + 1)
                   if self.hc_shape(k, elem) is not None)

    def hc_launch(self, block_shape, k, shape=None, elem: int = 4):
        """Kernel H's ``(block, rows, prefetch, segment planes)`` at depth
        ``k`` on a ``(bx, by, bz)`` block of ``elem``-byte cells:
        :meth:`hc_shape` unless ``shape`` ``(block, rows, prefetch)`` is
        given, and X segments of about ``hc_waves`` blocks an SM, at
        least ``hc_seg_planes_min`` planes."""
        block, rows, prefetch = shape or self.hc_shape(k, elem)
        bx, by, bz = block_shape
        ty, tz = self.f_tile(k, block, rows, elem)
        tiles = -(-by // ty) * -(-bz // tz)
        segments = -(-self.sm_count * self.hc_waves // tiles)
        return (block, rows, prefetch,
                max(self.hc_seg_planes_min, -(-bx // segments)))

    def hc_tile_kinds(self, block_shape, k: int, halos, origin,
                      grid_shape, tma=True, block=None, rows=None,
                      elem: int = 4) -> dict:
        """The (Y, Z) tiles of a kernel H launch at depth ``k`` on a
        ``(bx, by, bz)`` block at ``origin`` of ``grid_shape`` with
        ``halos`` ``(hx, hy, hz)``, counted by what they run: ``boxed``
        (with ``tma``: one TMA box a plane; the extended tile starts at
        y >= 0 and z >= 0, or below 0 only along an unsharded axis) and
        ``wrapped`` (the others: they need the lo piece, or the load is
        cp.async; per-cell copies); ``interior`` and ``edge`` (the
        extended tile inside the global interior or not), ``top``,
        ``left``, ``bottom``, ``right`` (the extended tile reaches past
        that side of the block along Y or Z), ``ragged_y``, ``ragged_z``
        and ``partial_group``, as :meth:`f_tile_kinds`, on blocks of
        ``elem``-byte cells. The tile grid is
        ``csrc/heat_h_block_3d.cu``'s."""
        _, by, bz = block_shape
        _, hy, hz = halos
        _, oy, oz = origin
        _, ny, nz = grid_shape
        if block is None:
            block, rows, _ = self.hc_shape(k, elem)
        wy, wz = self.f_extent(block, rows)
        ty, tz = self.f_tile(k, block, rows, elem)
        pad = self.f_pad(k, elem)
        kinds = dict.fromkeys(("tiles", "boxed", "wrapped", "interior",
                               "edge", "top", "left", "bottom", "right",
                               "ragged_y", "ragged_z", "partial_group"), 0)
        for a in range(0, by, ty):
            for c in range(0, bz, tz):
                y0, z0 = a - k, c - pad
                kinds["tiles"] += 1
                kinds["boxed" if tma and (y0 >= 0 or not hy)
                      and (z0 >= 0 or not hz) else "wrapped"] += 1
                kinds["top"] += y0 < 0
                kinds["left"] += z0 < 0
                kinds["bottom"] += y0 + wy > by
                kinds["right"] += z0 + wz > bz
                gy, gz = oy + y0, oz + z0
                kinds["edge" if (gy < 1 or gz < 1 or gy + wy > ny - 1
                                 or gz + wz > nz - 1) else "interior"] += 1
                kinds["ragged_y"] += by - a < ty
                kinds["ragged_z"] += bz - c < tz
                kinds["partial_group"] += min(tz, bz - c) % 4 != 0
        return kinds

    def h_band_takes(self, block, rows, k: int, elem: int = 4) -> bool:
        """Does the band's launch take thread blocks of ``block`` ``(32
        lanes, warps)`` with ``rows`` rows a thread at depth ``k`` on
        blocks of ``elem``-byte cells? F's rule (:meth:`f_takes`) at the
        compiled rows 2 and 4 (``csrc/heat_h_band_fix_3d.cu``)."""
        return rows in (2, 4) and self.f_takes(block, rows, k, elem)

    @functools.lru_cache(maxsize=32)
    def h_band_shape(self, k: int, elem: int = 4):
        """``(block, rows, prefetch)``: the band's launch shape at depth
        ``k`` on blocks of ``elem``-byte cells, the first of
        ``h_band_shapes`` that takes ``k`` (and one block's shared memory,
        :meth:`f_k_max`) with the most planes in flight that fit, up to
        ``h_band_prefetch``; None where no shape takes ``k``."""
        for block, rows in self.h_band_shapes:
            for prefetch in range(self.h_band_prefetch, 0, -1):
                if (self.h_band_takes(block, rows, k, elem)
                        and k <= self.f_k_max(block, rows, prefetch, elem)):
                    return block, rows, prefetch
        return None

    def h_band_k_max(self, elem: int = 4) -> int:
        """Deepest K the band takes at some shape (:meth:`h_band_shape`)
        on blocks of ``elem``-byte cells."""
        return max(k for k in range(1, self.f_k_compiled + 1)
                   if self.h_band_shape(k, elem) is not None)

    @staticmethod
    def h_band_vec_fits(block_shape, elem: int = 4) -> bool:
        """Do ``(bx, by, bz)`` blocks of ``elem``-byte cells take the
        band's vector load? Rows of a multiple of 16 bytes (``bz % 4 ==
        0`` at float32, ``bz % 8 == 0`` at bfloat16, whose lanes then copy
        8 aligned bytes); the launch also needs every block 16-byte
        aligned (``csrc/heat_hb.cuh`` ``heat_hb_aligned``)."""
        return block_shape[2] % (16 // elem) == 0

    def h_band_tiles(self, block_shape, k: int, shape=None, elem: int = 4):
        """``(tiles_y, tiles_z)`` of the band's launch at depth ``k`` on a
        ``(bx, by, bz)`` block of ``elem``-byte cells (F's tiles over the
        block face), at :meth:`h_band_shape`'s block and rows unless
        ``shape`` ``(block, rows, prefetch)`` is given. The grid is
        ``(tiles_y * tiles_z, 2, blocks)``."""
        block, rows, _ = shape or self.h_band_shape(k, elem)
        _, by, bz = block_shape
        ty, tz = self.f_tile(k, block, rows, elem)
        return -(-by // ty), -(-bz // tz)

    def h_band_tile_kinds(self, block_shape, k: int, halos, origin,
                          grid_shape, shape=None, elem: int = 4) -> dict:
        """The (Y, Z) tiles of a band launch at depth ``k`` on a ``(bx,
        by, bz)`` block at ``origin`` of ``grid_shape`` with ``halos``
        ``(hx, hy, hz)``, counted by what their load and steps run:
        ``lo_y`` and ``lo_z`` (the extended tile reaches below the block
        along a sharded axis: cells of the y tail's or z tail's lo piece),
        ``hi_y`` and ``hi_z`` (past its end: the hi pieces), ``inside``
        (neither: every cell of a row from the block), ``straddle`` (a
        lane's four cells span the block's last z and the z tail: bz % 4
        != 0), and :meth:`f_tile_kinds`' ``interior``, ``edge``,
        ``ragged_y``, ``ragged_z`` and ``partial_group`` in the block's
        global place. Tiles are counted once for both regions, on blocks
        of ``elem``-byte cells."""
        block, rows, _ = shape or self.h_band_shape(k, elem)
        _, by, bz = block_shape
        _, hy, hz = halos
        _, oy, oz = origin
        _, ny, nz = grid_shape
        wy, wz = self.f_extent(block, rows)
        ty, tz = self.f_tile(k, block, rows, elem)
        pad = self.f_pad(k, elem)
        kinds = dict.fromkeys(("tiles", "inside", "lo_y", "lo_z", "hi_y",
                               "hi_z", "straddle", "interior", "edge",
                               "ragged_y", "ragged_z", "partial_group"), 0)
        for a in range(0, by, ty):
            for c in range(0, bz, tz):
                y0, z0 = a - k, c - pad
                kinds["tiles"] += 1
                lo_y, lo_z = y0 < 0 and hy > 0, z0 < 0 and hz > 0
                hi_y, hi_z = y0 + wy > by and hy > 0, z0 + wz > bz and hz > 0
                kinds["lo_y"] += lo_y
                kinds["lo_z"] += lo_z
                kinds["hi_y"] += hi_y
                kinds["hi_z"] += hi_z
                kinds["inside"] += not (lo_y or lo_z or hi_y or hi_z)
                kinds["straddle"] += (hz > 0 and bz % 4 != 0
                                      and z0 < bz < z0 + wz)
                gy, gz = oy + y0, oz + z0
                kinds["edge" if (gy < 1 or gz < 1 or gy + wy > ny - 1
                                 or gz + wz > nz - 1) else "interior"] += 1
                kinds["ragged_y"] += by - a < ty
                kinds["ragged_z"] += bz - c < tz
                kinds["partial_group"] += min(tz, bz - c) % 4 != 0
        return kinds

    def loop_takes(self, tile, block) -> bool:
        """Does the register-blocked tile loop (kernels E, E-uni and G)
        take output tiles of ``tile`` ``(rows, cols)`` under thread blocks
        of ``block`` ``(lanes, warps)``? A row of threads is one warp, so
        32 lanes; at most ``loop_max_warps`` warps (the kernels' launch
        bound of 512 threads lets them take up to 128 registers a thread);
        the tile's width a multiple of 4, so that every tile's core starts
        a group of 4 columns. ``csrc/heat_temporal.cuh``
        ``heat_loop_takes`` is the same rule."""
        (ty, tx), (bx, by) = tile, block
        return ty >= 1 and tx >= 4 and tx % 4 == 0 and bx == 32 and (
            1 <= by <= self.loop_max_warps)

    @staticmethod
    def row_floats(k: int, tile_x: int) -> int:
        """Row stride in floats of the tile loop's shared buffers at depth
        ``k``: the framed row ``tile_x + 2k`` after a pad of ``(4 - k % 4)
        % 4`` that puts the core's first column on a 16-byte boundary,
        rounded up to 4 (``csrc/heat_temporal.cuh`` ``heat_row_floats``)."""
        return -(-((4 - k % 4) % 4 + tile_x + 2 * k) // 4) * 4

    def loop_smem_bytes(self, k: int, tile) -> int:
        """Dynamic shared memory of one block of the tile loop at depth
        ``k``: two buffers of ``tile_y + 2k`` padded rows."""
        ty, tx = tile
        return 2 * (ty + 2 * k) * self.row_floats(k, tx) * 4

    def e_smem_bytes(self, k: int, tile=None, tma=False, elem=4) -> int:
        """Dynamic shared memory of one E block (or with ``tma`` one E-uni
        block) at depth ``k`` on a grid of ``elem``-byte cells: the loop's
        two buffers, and for E-uni's TMA box 128 bytes to align them and
        its 8-byte mbarrier; a bfloat16 box (``elem`` 2) lands in a stage
        from the first 128-byte boundary past the first buffer, which may
        reach past the second (``csrc/heat_e_uni.cuh``
        ``heat_e_uni_form_smem``)."""
        ty, tx = tile or self.e_tile
        if not tma or elem == 4:
            return (self.loop_smem_bytes(k, (ty, tx))
                    + (128 + 8 if tma else 0))
        sy, sx = ty + 2 * k, self.row_floats(k, tx)
        stage_end = (-(-sy * sx // 32) * 32
                     + (sy * self.e_box_cols(sx, elem) + 1) // 2)
        return 128 + 4 * max(2 * sy * sx, (stage_end + 1) // 2 * 2) + 8

    @staticmethod
    def e_box_cols(sx: int, elem: int = 4) -> int:
        """Cells a row of E-uni's box holds for a row of ``sx`` floats in
        shared memory on a grid of ``elem``-byte cells: ``sx``, or for
        bfloat16 ``sx`` and the box's shift of up to 4 cells (a box starts
        on 16 bytes of its row, 8 bfloat16 cells: :meth:`e_box`) rounded
        up to 8, so that a box row is a multiple of 16 bytes
        (``csrc/heat_e_uni.cuh`` ``heat_e_uni_box_cols``)."""
        return -(-(sx + 4) // 8) * 8 if elem == 2 else sx

    def _per_block_smem(self) -> int:
        """Shared memory a block may take so that ``e_min_blocks_per_sm``
        blocks stay resident on one SM."""
        return min(self.smem_per_block_max,
                   self.smem_per_sm // self.e_min_blocks_per_sm
                   - self.smem_reserved_per_block)

    @functools.lru_cache(maxsize=8)
    def e_k_max(self, tile=None, elem=4) -> int:
        """Deepest K at which E and E-uni keep ``e_min_blocks_per_sm``
        blocks resident on one SM and E-uni's box fits a TMA load
        (:meth:`e_box_fits`), on a grid of ``elem``-byte cells."""
        k = 0
        while (self.e_smem_bytes(k + 1, tile, tma=True, elem=elem)
               + self.static_smem_bytes <= self._per_block_smem()
               and self.e_box_fits(k + 1, tile, elem)):
            k += 1
        return k

    def e_box(self, k: int, row_tile=0, col_tile=0, tile=None, elem=4):
        """E-uni's TMA box of tile ``(row_tile, col_tile)`` at depth ``k``:
        ``(y0, x0, rows, cols)``, its first grid cell and its extent. The
        framed tile, widened on the left by the pad that puts tile column
        ``k`` on a 16-byte boundary and on the right to a multiple of 4
        floats: the shared buffer's layout (:meth:`row_floats`). On a
        bfloat16 grid (``elem`` 2) the box starts on 8 cells (16 bytes, as
        TMA needs), up to 4 cells to the left, and holds those cells too
        (:meth:`e_box_cols`). Cells outside the grid come as zeros."""
        ty, tx = tile or self.e_tile
        pad = (4 - k % 4) % 4
        x0 = col_tile * tx - k - pad
        if elem == 2:
            x0 -= x0 % 8
        return (row_tile * ty - k, x0, ty + 2 * k,
                self.e_box_cols(self.row_floats(k, tx), elem))

    def e_box_fits(self, k: int, tile=None, elem=4) -> bool:
        """Does E-uni's box fit TMA's 256 cells a dimension at depth
        ``k``? (``csrc/heat_e_uni_temporal.cu`` ``heat_e_uni_tma_fits``,
        ``csrc/heat_e_uni.cuh`` ``heat_e_uni_form_launch``.)"""
        _, _, rows, cols = self.e_box(k, tile=tile, elem=elem)
        return rows <= 256 and cols <= 256

    def e_tile_kinds(self, shape, k: int, tile=None) -> dict:
        """The tiles of an E or E-uni launch at depth ``k`` on an ``(m,
        n)`` grid, counted by the branches they run: ``inside`` (the framed
        tile lies inside the grid: E's test-free cp.async load) and
        ``grid_edge`` (the others: E's checked per-cell load; E-uni's TMA
        box partly outside the grid, zero-filled), of those ``top``,
        ``left``, ``bottom`` and ``right`` (the frame reaches past that
        side of the grid: a box with a negative start, or past the far
        edge); ``ragged_rows`` and ``ragged_cols`` (the last row or column
        tile cut short); ``partial_group`` (a tile whose last output group
        has fewer than 4 columns: the cell-by-cell last store);
        ``interior`` and ``copies`` (the framed tile lies inside the
        grid's interior, or reaches past it: the step loop's copy
        branch)."""
        m, n = shape
        ty, tx = tile or self.e_tile
        sy, sw = ty + 2 * k, tx + 2 * k
        kinds = dict.fromkeys(("tiles", "inside", "grid_edge", "top", "left",
                               "bottom", "right", "ragged_rows",
                               "ragged_cols", "partial_group", "interior",
                               "copies"), 0)
        for r0 in range(0, m, ty):
            for c0 in range(0, n, tx):
                y0, x0 = r0 - k, c0 - k
                side = {"top": y0 < 0, "left": x0 < 0,
                        "bottom": y0 + sy > m, "right": x0 + sw > n}
                kinds["tiles"] += 1
                kinds["grid_edge" if any(side.values()) else "inside"] += 1
                for name, hit in side.items():
                    kinds[name] += hit
                kinds["ragged_rows"] += m - r0 < ty
                kinds["ragged_cols"] += n - c0 < tx
                kinds["partial_group"] += min(tx, n - c0) % 4 != 0
                kinds["copies" if (y0 < 1 or x0 < 1 or y0 + sy > m - 1
                                   or x0 + sw > n - 1) else "interior"] += 1
        return kinds

    def g_run(self, k: int, tile=None, block=None) -> int:
        """Rows of the framed tile that one warp walks at depth ``k``."""
        ty = (tile or self.g_tile)[0]
        return -(-(ty + 2 * k) // (block or self.g_block)[1])

    def g_smem_bytes(self, k: int, tile=None) -> int:
        """Dynamic shared memory of one G block at depth ``k``: the tile
        loop's two buffers of ``tile_y + 2k`` padded rows."""
        return self.loop_smem_bytes(k, tile or self.g_tile)

    def g_blocks_per_sm(self, k: int, tile=None, block=None) -> int:
        """Blocks of a G launch that one SM holds by shared memory and
        threads (2048 a SM); registers may hold fewer (the build phase of
        ``chip_smoke.py`` asks the card)."""
        bx, by = block or self.g_block
        by_smem = self.smem_per_sm // (self.g_smem_bytes(k, tile)
                                       + self.static_smem_bytes
                                       + self.smem_reserved_per_block)
        return min(by_smem, 2048 // (bx * by))

    def g_tile_kinds(self, block_shape, k: int, regions=None, tile=None,
                     origin=None, grid_shape=None) -> dict:
        """The tiles of a G launch at depth ``k`` on a ``(bx, by)`` block,
        counted by the branches of ``csrc/heat_g.cuh`` they run:
        ``inside`` (the framed tile lies inside the block: one run of one
        buffer a row) and ``block_edge`` (the checked per-cell load),
        ``ragged_rows`` and ``ragged_cols`` (the last row or column tile
        cut short), ``partial_group`` (a tile whose last output group has
        fewer than 4 columns: the cell-by-cell last store) and, given the
        block's ``origin`` in a grid of ``grid_shape``, ``global_edge``
        (the framed tile reaches past the grid's interior: the step loop's
        copy branch). ``regions`` lists ``(first row, rows)``: the whole
        block by default (the monolithic kernel)."""
        bx, by = block_shape
        ty, tx = tile or self.g_tile
        kinds = dict.fromkeys(("tiles", "inside", "block_edge",
                               "ragged_rows", "ragged_cols",
                               "partial_group", "global_edge"), 0)
        for begin, rows in regions or [(0, bx)]:
            for r0 in range(begin, begin + rows, ty):
                for c0 in range(0, by, tx):
                    h, w = min(ty, begin + rows - r0), min(tx, by - c0)
                    lr0, lc0 = r0 - k, c0 - k
                    inside = (lr0 >= 0 and lr0 + ty + 2 * k <= bx
                              and lc0 >= 0 and lc0 + tx + 2 * k <= by)
                    kinds["tiles"] += 1
                    kinds["inside" if inside else "block_edge"] += 1
                    kinds["ragged_rows"] += h < ty
                    kinds["ragged_cols"] += w < tx
                    kinds["partial_group"] += w % 4 != 0
                    if origin is not None:
                        gy, gx = origin[0] + lr0, origin[1] + lc0
                        kinds["global_edge"] += (
                            gy < 1 or gx < 1
                            or gy + ty + 2 * k > grid_shape[0] - 1
                            or gx + tx + 2 * k > grid_shape[1] - 1)
        return kinds

    @functools.lru_cache(maxsize=8)
    def g_k_max(self, tile=None) -> int:
        """Deepest K a G kernel takes at ``tile`` (``g_tile``): the two
        buffers of :meth:`g_smem_bytes` within one block's shared memory
        and ``e_min_blocks_per_sm`` blocks resident on one SM (E's rule)."""
        per_block = self._per_block_smem()
        k = 0
        while (self.g_smem_bytes(k + 1, tile) + self.static_smem_bytes
               <= per_block):
            k += 1
        return k

    @staticmethod
    def g_band_row_load(block_shape, k: int, elem: int = 4) -> bool:
        """Does the band kernel copy its windows' core columns 16 bytes at
        a time from the piece that holds each row (the row load of
        ``csrc/heat_g_band_fix.cu``)? Where the block's width and its halo
        rows, ``by + 2k`` cells, are multiples of the cells of 16 bytes at
        ``elem`` bytes a cell: 4 float32 (so K even), 8 bfloat16 (K a
        multiple of 4, and the band's tile width a multiple of 8); the
        launcher also needs 16-byte aligned pieces
        (``heat_g_band_row_load``). Elsewhere the per-cell load."""
        by, vec = block_shape[1], 16 // elem
        return by % vec == 0 and (by + 2 * k) % vec == 0

    def uni_fits(self, shape, dtype="float32") -> bool:
        """Do the uniform-load kernels (E-uni, I-uni) take an ``(m, n)``
        grid of storage ``dtype``? Their rows are 16-byte multiples (a TMA
        box's row stride), so the width must be a multiple of 4 float32
        cells or of 8 bfloat16 ones (E's tile width is a multiple of 4,
        by construction)."""
        return shape[1] % (8 if str(dtype) in ("bfloat16", "torch.bfloat16")
                           else 4) == 0

    @staticmethod
    def i_pad(k: int) -> int:
        """Kernel I's column margin at depth ``k``: ``k`` rounded up to a
        whole group of 4 (``heat_i_pad``)."""
        return (k + 3) // 4 * 4

    def i_tile_x(self, k: int) -> int:
        """Output columns of one of kernel I's bands at depth ``k``: the
        warp's 128 columns less a margin each side (``heat_i_tile_x``)."""
        return 128 - 2 * self.i_pad(k)

    def i_takes(self, k: int, warps: int, rows: int, stages: int,
                elem: int = 4) -> bool:
        """Does kernel I's launcher take depth ``k``, ``warps`` warps a
        block and a ring of ``stages`` stages of ``rows`` rows of
        ``elem``-byte cells, within a block's shared memory
        (``heat_i_geometry``)?"""
        return (1 <= k <= self.i_k_max and 1 <= warps <= I_MAX_WARPS
                and I_MIN_ROWS <= rows <= I_MAX_ROWS
                and 2 <= stages <= I_MAX_STAGES
                and self.i_smem_bytes(warps, rows, stages, elem)
                <= self.smem_per_block_max)

    @staticmethod
    def i_row_cells(elem: int = 4) -> int:
        """Cells of a row of kernel I's ring for a grid of ``elem``-byte
        cells (``heat_i_row_cells``): the band's 128, or at bfloat16 136,
        from the band's first cell rounded down to 16 bytes (a TMA box's
        start)."""
        return 136 if elem == 2 else 128

    @classmethod
    def i_stage_bytes(cls, rows: int, elem: int = 4) -> int:
        """Bytes of one stage of ``rows`` ring rows, rounded up to 128 (a
        box's alignment; ``heat_i_stage_bytes``)."""
        return -(-rows * elem * cls.i_row_cells(elem) // 128) * 128

    @classmethod
    def i_smem_bytes(cls, warps: int, rows: int, stages: int,
                     elem: int = 4) -> int:
        """Dynamic shared memory of one block of kernel I
        (``heat_i_smem_bytes``): 128 bytes to align the rings, ``stages``
        stages of ``rows`` rows of ``elem``-byte cells a warp
        (:meth:`i_stage_bytes`), an 8-byte mbarrier a stage."""
        return (warps * stages * cls.i_stage_bytes(rows, elem) + 128
                + 8 * warps * stages)

    def i_launch(self, shape, k, warps=None):
        """Kernel I's ``(band output columns, segment rows)`` at depth
        ``k`` for an ``(m, n)`` grid under ``warps`` warps a block
        (``i_warps``): segments enough that the launch is ``i_waves``
        waves of ``i_blocks_per_sm`` blocks on every SM, each at least
        ``i_seg_rows_min`` rows."""
        m, n = shape
        warps = warps or self.i_warps
        tile_x = self.i_tile_x(k)
        bands = -(-n // tile_x)
        col_blocks = -(-bands // warps)
        blocks = self.sm_count * self.i_blocks_per_sm * self.i_waves
        segments = max(1, blocks // col_blocks)
        return tile_x, max(self.i_seg_rows_min, -(-m // segments))

    def i_band_kinds(self, shape, k: int) -> dict:
        """How many warps of a launch of kernel I at depth ``k`` on an
        ``(m, n)`` grid (``i_launch``'s geometry) run
        each kind of band and segment: ``interior`` bands (their 128
        columns inside the grid's interior: the test-free step), ``first``
        and ``last`` bands (past the first or the last interior column),
        ``partial`` bands (fewer output columns than a band holds),
        ``unaligned`` bands (I's whole-group copy, 16 bytes at float32
        and 8 at bfloat16, refused on some row: the
        width is no multiple of 4), ``idle`` warps (past the last band),
        ``free_rows`` segments (some rows stepped test-free) and
        ``edge_rows`` segments (their rows reach the grid's first or last
        row). ``bands`` and ``segments`` count the launch."""
        m, n = shape
        warps = self.i_warps
        tile_x, seg = self.i_launch(shape, k)
        pad = self.i_pad(k)
        bands = -(-n // tile_x)
        segments = -(-m // seg)
        kinds = dict.fromkeys(("interior", "first", "last", "partial",
                               "unaligned", "idle", "free_rows",
                               "edge_rows"), 0)
        for b in range(bands):
            gx0 = b * tile_x - pad
            if gx0 >= 1 and gx0 + 128 <= n - 1:
                kinds["interior"] += 1
            if gx0 < 1:
                kinds["first"] += 1
            if gx0 + 128 > n - 1:
                kinds["last"] += 1
            if min(b * tile_x + tile_x, n) - b * tile_x < tile_x:
                kinds["partial"] += 1
            if n % 4:
                kinds["unaligned"] += 1
        kinds["idle"] = -(-bands // warps) * warps - bands
        for i in range(segments):
            r0, r1 = i * seg, min(i * seg + seg, m)
            t0, n_iter = r0 - k, (r1 - r0) + 2 * k
            i_a = min(max(k + 1 - t0, 0), n_iter)
            i_b = min(max(m - t0, i_a), n_iter)
            if i_b > i_a:
                kinds["free_rows"] += 1
            if i_a > 0 or i_b < n_iter:
                kinds["edge_rows"] += 1
        kinds.update(bands=bands, segments=segments)
        return kinds

    def a_smem_bytes(self, tile, depth=None) -> int:
        """Dynamic shared memory of one A block at ``tile``: the tile
        loop's two buffers at the halo depth (:meth:`loop_smem_bytes`)."""
        return self.loop_smem_bytes(self.a_depth if depth is None else depth,
                                    tile)

    def a_takes(self, shape, tile, block) -> bool:
        """Does the step phase of kernels A and M take tiles of ``tile`` on
        an ``(m, n)`` grid under thread blocks of ``block``? The tile
        loop's rule (:meth:`loop_takes`), but a tile as wide as the grid,
        one column of tiles, may have any width: the rule's multiple of 4
        puts every tile's first column on a group, and the only tile of a
        column starts at column 0. ``csrc/heat_a.cuh`` ``heat_a_takes`` is
        the same rule."""
        ty, tx = tile
        return (self.loop_takes((ty, -(-tx // 4) * 4), block)
                and (tx % 4 == 0 or tx >= shape[1]))

    def a_step_cost(self, tile, depth=None, block=None) -> float:
        """Kernel A's modelled cost of a step of one block at ``tile``: row
        visits of the busiest warp (its run of the framed tile's rows)
        times its passes of 32 lanes over the 4-column groups the step
        updates, each pass ``a_run_visits`` more for its start, averaged
        over a group of ``depth`` steps on the shrinking region
        (``csrc/heat_a.cuh`` heat_a_steps)."""
        ty, tx = tile
        d = self.a_depth if depth is None else depth
        warps = (block or self.a_block)[1]
        pad = (4 - d % 4) % 4
        sh, sw = ty + 2 * d, tx + 2 * d
        run = -(-sh // warps)
        cost = 0
        for s in range(1, d + 1):
            groups = (pad + sw - s + 3) // 4 - (pad + s) // 4
            cost += ((min(run, sh - 2 * s) + self.a_run_visits)
                     * -(-groups // 32))
        return cost / d

    @functools.lru_cache(maxsize=64)
    def a_tile(self, shape, depth=None, block=None):
        """Kernel A's tile ``(rows, cols)`` for an ``(m, n)`` grid, or None
        when the grid does not fit resident: at most one block of
        ``block`` threads (``a_block``) per SM, each within one block's
        shared memory, on a launch shape that A's step phase takes
        (:meth:`a_takes`).

        The widths are those of every count of tile columns, rounded up
        to a multiple of 4 (the grid's width for one column); the heights those of every count of tile rows
        the card has room for, and the least one whose framed rows fill
        whole runs of the warps. Among the tiles that fit,
        the one with the least modelled step (:meth:`a_step_cost`, and
        for two or more blocks ``m_sync_visits / depth`` for the exchange
        and barrier a group), then the fewest blocks (each one waits at
        every grid-wide barrier), then the least shared memory, then the
        widest."""
        m, n = shape
        d = self.a_depth if depth is None else depth
        block = block or self.a_block
        warps = block[1]
        budget = self.smem_per_block_max - self.static_smem_bytes
        if m * n * 8 > self.sm_count * budget:
            return None
        widths = sorted({-(-(-(-n // q)) // 4) * 4
                         for q in range(1, min(self.sm_count, n) + 1)})
        best, best_key = None, None
        for tx in widths:
            n_col = -(-n // tx)
            rows_max = self.sm_count // n_col
            if rows_max == 0:
                continue
            tx = min(tx, n)
            lo = -(-m // rows_max)
            heights = {-(-m // r) for r in range(1, min(m, rows_max) + 1)}
            heights.add(min(m, -(-(lo + 2 * d) // warps) * warps - 2 * d))
            for ty in sorted(h for h in heights if h >= lo):
                tile = (ty, tx)
                smem = self.a_smem_bytes(tile, d)
                if smem > budget or not self.a_takes(shape, tile, block):
                    continue
                blocks = n_col * -(-m // ty)
                key = (self.a_step_cost(tile, d, block)
                       + (self.m_sync_visits / d if blocks > 1 else 0),
                       blocks, smem, -tx)
                if best_key is None or key < best_key:
                    best, best_key = tile, key
        return best

    def a_tile_kinds(self, shape, depth=None, tile=None) -> dict:
        """The tiles of an A launch on an ``(m, n)`` grid, counted by the
        branches of ``csrc/heat_a.cuh`` they run: ``interior`` (the framed
        tile lies inside the grid's interior: the test-free step) and
        ``copies`` (it reaches past it: the step's copy branch), of those
        ``top``, ``left``, ``bottom`` and ``right`` (the frame reaches past
        that side of the grid: zero-filled loads, frame cells left out of
        the exchange); ``ragged_rows`` and ``ragged_cols`` (the last row or
        column of tiles cut short); ``partial_group`` (a tile whose last
        group has fewer than 4 columns: the cell-by-cell last store);
        ``whole_band_rows`` and ``whole_band_cols`` (a tile at most 2D
        tall or wide, whose band the exchange writes whole)."""
        m, n = shape
        d = self.a_depth if depth is None else depth
        ty, tx = tile or self.a_tile(tuple(shape), d)
        kinds = dict.fromkeys(("tiles", "interior", "copies", "top", "left",
                               "bottom", "right", "ragged_rows",
                               "ragged_cols", "partial_group",
                               "whole_band_rows", "whole_band_cols"), 0)
        for i0 in range(0, m, ty):
            for j0 in range(0, n, tx):
                h, w = min(ty, m - i0), min(tx, n - j0)
                y0, x0 = i0 - d, j0 - d
                y1, x1 = i0 + h + d, j0 + w + d
                kinds["tiles"] += 1
                kinds["top"] += y0 < 0
                kinds["left"] += x0 < 0
                kinds["bottom"] += y1 > m
                kinds["right"] += x1 > n
                kinds["copies" if (y0 < 1 or x0 < 1 or y1 > m - 1
                                   or x1 > n - 1) else "interior"] += 1
                kinds["ragged_rows"] += h < ty
                kinds["ragged_cols"] += w < tx
                kinds["partial_group"] += w % 4 != 0
                kinds["whole_band_rows"] += h <= 2 * d
                kinds["whole_band_cols"] += w <= 2 * d
        return kinds


_PARAMS = HopperParams()


def params() -> HopperParams:
    return _PARAMS
