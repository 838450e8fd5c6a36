#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``parallel_heat_tpu``. It
prints the card's name and power limit, then one JSON line per phase:

1. build — every kernel of the main path, and the device loop's helper
   (``csrc/heat_graph_loop.cu``), is built from ``csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together), timed, with
   ptxas's report of registers, spills and static shared memory for each
   template instance by name (``<K, R, ...>``) and the instances that
   spill; the E and E-uni instances the one-device 2D main path
   launches, F's instance the one-device 3D main path launches, the
   H-fused instance the sharded 3D main path launches, and the G-uni and
   G-fuse kernels the sharded 2D main path launches, must not spill (the
   E and G kernels' registers and blocks an SM at the main path's shape
   are printed; a second run from the cached build reads nvcc's report
   kept beside each library), nor may any instance of A, M or A's
   anatomy probe (``heat_probe_kernel``, also built here), whose
   registers and spills are printed, nor any of the other nine probes'
   (``heat_probe_vpu_roofline``, ``heat_probe_temporal``,
   ``heat_probe_ab_temporal``, ``heat_probe_split_copy``,
   ``heat_probe_gather_dma``, ``heat_probe_sweep_width``,
   ``heat_probe_store_align``, ``heat_probe_roll_pad``,
   ``heat_probe_xslab_overlap``, built here too), nor any of I's and
   I-uni's instances below K = 8 (their bfloat16 forms' too), and their
   K = 8 instances may not spill more than ``I_SPILL_K8``, the bfloat16
   forms' no more than their float32 sibling's (each source's build
   seconds are printed; the registers, spills and blocks an SM
   of the instance a forced run launches are printed, with the instances
   that spill), nor the 3D band's instance the H-defer round launches
   more than ``BAND_SPILL_3D``; and no instance of D's and F's bfloat16
   forms (``heat_d_step3d_bf16``, the 48 of ``heat_f_temporal3d_bf16``,
   its own library) may spill more, stores or loads, than its float32
   twin of the same K, rows and load; nor any of the H family's (the 24
   of ``heat_h_block_3d_bf16``, the 24 of ``heat_h_block_3d_fused_bf16``,
   whose twins are H-fused's cp.async instances, and the 32 of
   ``heat_h_band_fix_3d_bf16``, a library each), and H-fused's bfloat16
   main-path instance not at all;
2. kernels — each kernel against its plain PyTorch version on the card,
   bitwise, with cx = cy = 0.1 and, where marked, also cx=0.1, cy=0.2
   (so a swap of the axes cannot pass). The one-step kernels B
   (``heat_b_step``) and C (``heat_c_tiled``, also against B) at 4096^2,
   a ragged 1001x999 (both pairs), the converge path's 1000^2 (both)
   and the main path's 16384^2. The K-step kernels E
   (``heat_e_temporal``), E-uni (``heat_e_uni_temporal``), I
   (``heat_i_tile_temporal``) and I-uni (``heat_i_uni_tile_temporal``;
   the uniform ones on the widths that are multiples of 4) against K
   launches of B and their plain versions: K in {1, 3, K_default} on
   4096^2 and 1001x999, K in {4, K_default} with the residual on 1000^2
   (the launches of a 20-step converge window) and K_default on
   16384^2. E and E-uni also at every compiled K (1 .. ``e_k_max``),
   against each other too, on grids that run every branch of the tile
   loop and the loads
   (``hopper_params.e_tile_kinds``, asserted per grid and K: tiles
   inside the grid and at each of its four edges, ragged last row and
   column tiles, E-uni's TMA boxes with negative starts and past the far
   edges, the step loop's copy branch, last groups of 1, 2 and 3
   columns): 1001x1000, 1001x999, 333x1001, 250x1002, and 20x24 and
   21x23, smaller than one tile. A (``heat_a_resident``)
   likewise at K in {1, 4, 7, 20} on 1000^2 (20 = one converge window,
   its launch on the main path; 7 ends in a part group of steps), K in
   {1, 5, 20} on 1001x999, K = 20 on 1859^2 (the largest square grid it
   takes), K in {1, 7, 20} on 107x210, whose tiles are at most two halo
   depths tall, K in {1, 3, 4, 5, 8, 9, 20} on 20x24 (one tile) and K in
   {1, 9, 20} on 4099x7 (one column of tiles 7 wide), the grids between
   them asserted to run every tile kind of A's step phase and exchange
   (``hopper_params.a_tile_kinds``); and at K = 20 at every halo depth
   1 .. 8 on 1000^2 at the tile the picker takes for it. I and I-uni
   also at every K 1 .. 8, against K launches of B, their plain versions
   and E(K), on 1001x1000, 1001x999, 37x257, 40x50 (narrower than one
   band), 3x8, 3x300, 200x132 and the main path's 16384^2, every K's
   grids asserted to run every kind of band and segment of their stream
   (``hopper_params.i_band_kinds``: interior, first, last and partial
   bands, I's 16-byte copy refused on a row, idle warps, segments with
   test-free rows and segments at the grid's first or last row). Last a
   NaN-seeded grid, which must give a NaN residual from every kernel
   with the boundary intact;
2a. kernels_bf16 — the precision forms of A, E and E-uni (bfloat16
   storage, and E's and E-uni's acc_f32: in one launch, and the first and
   last launches of a chunk across a float32 level) bitwise their plain
   versions, which round where the kernels round: E and E-uni at every
   depth each form takes on 1001x1000, 1001x999 (E only: a width no
   multiple of 8), 21x23 and 20x24, each grid asserted to run the tile
   kinds it is there for, E-uni against E; A at K up to 20 on 1000^2,
   1001x999, 107x210, 20x24 and 1859^2; every form on a NaN-seeded grid
   (NaNs of payloads no conversion makes, on the ring too: the ring bit
   for bit, a NaN residual); and E's and E-uni's main-path launches at
   32768^2: storage at K = 8, and a 16-step chunk's two carry launches.
   Then the bfloat16 forms of B (``heat_b_step_bf16``) and C
   (``heat_c_tiled_bf16``), each bitwise its plain version and C bitwise
   B, on 1001x999, 20x24, the NaN-seeded grid and 32768^2; M
   (``heat_m_ensemble_bf16``) at K in {1, 7, 20}, with and without the
   residuals, on 3 x 107x210, 8 x 20^2 and 8 x 166^2 (one block a member)
   and 3 x 512^2 and 3 x 1000^2 (cooperative tilings), each checked
   member bitwise ``heat_a_resident_bf16`` on it alone, and on a stack
   whose middle member is the NaN-seeded grid (only its residual NaN);
   and the chains: A's bfloat16 form (K = 20 on 1000^2) and E's and
   E-uni's storage form (K = 8 on 1001x1000) bitwise K launches of
   ``heat_b_step_bf16``. Last I's and I-uni's forms
   (``heat_i_tile_temporal_bf16``, ``heat_i_uni_tile_temporal_bf16``),
   each bitwise its plain version: storage and the carry in one launch at
   every K 1 .. 8, a chunk's first launch into a float32 level at K = 1
   and 8, its last from one at every K, on the float32 phase's I grids
   but 16384^2 and on 130x250 (a width of 4k + 2) and 200x136 (I-uni's
   shifted box at K <= 4), every K's grids asserted to run every kind of
   band and segment; I-uni bitwise I; I and I-uni in storage form at
   K = 3 and 8 on 1001x1000 bitwise ``heat_e_temporal_bf16``'s storage
   form and K launches of ``heat_b_step_bf16``, in the carry form bitwise
   E's; the NaN-seeded grid in both modes; and their main-path launches
   at 32768^2 (storage at K = 8, a 16-step chunk's two carry launches).
   Last D's and F's bfloat16 forms (``heat_d_step3d_bf16``,
   ``heat_f_temporal3d_bf16``) into NaN-filled outputs, each bitwise its
   plain version: D on each grid, F at every K 1 .. 8 under each load
   its grid takes (TMA where nz % 8 == 0, and cp.async), with and
   without the residual, and bitwise K launches of D, on the main path's
   512^3, 67x130x204 (cp.async at bfloat16), 67x130x200 (TMA),
   67x130x201 (partial last groups) and 5x3x300, each grid asserted to
   run at every K the tile kinds it is there for (``f_tile_kinds`` at
   2-byte cells); and a NaN-seeded grid under both loads (faces bit for
   bit, NaN residual);
2b. kernels_3d — D (``heat_d_step3d``) against its plain version and F
   (``heat_f_temporal3d``) at every compiled K (1 .. 8; past the default
   shape's deepest K at ``hopper_params.f_shape``'s), under each plane load
   its grid takes (TMA where nz % 4 == 0, and cp.async), with and
   without the residual, against K launches of D and its plain version,
   all bitwise, on the main path's 512^3, the ragged 67x130x204 and
   67x130x201 and a 5x3x300 slab thinner than one tile (these three also
   with cx, cy, cz = 0.1, 0.15, 0.05), each grid asserted to run at
   every K the tile kinds it is there for (``hopper_params.f_tile_kinds``:
   interior tiles, tiles past each of the four (Y, Z) sides, ragged last
   tiles, last groups of 1 to 3 cells); F's launcher against
   ``hopper_params.f_takes`` on a table of legal and illegal launch
   shapes; a NaN-seeded grid under both loads (NaN residual, faces
   intact); and 1291x1299x1304 (both loads) and 1291x1299x1301, past
   2^31 cells, F(K_default) against K_default launches of D only;
3. main path — ``solve(HeatConfig(nx=16384, ny=16384, steps=200))``
   with the default pick (kernel E-uni) and again under
   ``tune.force("single_2d", ...)`` for E, I, I-uni, B and C: launch
   counts reset just before each run and read just after (the run's
   kernel > 0, the other kernels and every plain version 0), all six
   grids bitwise equal; and a 256^2 run under A (its default) and each
   other kernel, held against a float64 reference and bitwise against
   the CPU's plain versions;
3b. main_path_3d — ``solve(HeatConfig(nx=512, ny=512, nz=512,
   steps=200))`` under the default pick (kernel F) and forced D
   (``tune.force("single_3d", "D")``), counted as in phase 3, the two
   grids bitwise equal; and 64^3 under each, bitwise against the CPU's
   plain versions and within the few-ulp contract of a float64
   reference;
4. converge — 1000^2, steps=10000, check_interval=20, eps=1e-3 under the
   default pick (kernel A) and each other kernel forced: steps_run,
   converged, the residual and the grid identical; the same grid in
   fixed mode (10000 steps, one launch of A) under A and E-uni; and 20^2
   with eps=1e-3, which converges at step 1980, under each kernel
   against the CPU's plain versions. The default runs of this phase and
   of the main path are repeated once under ``torch.profiler`` for the
   card's busy time, and so its idle share;
3c. main_path_bf16 — BASELINE config 4, ``solve(HeatConfig(nx=32768,
   ny=32768, steps=200, dtype="bfloat16"))`` through the default pick
   (E-uni) and forced E, then again under ``accumulate="f32chunk"``
   (chunks of 16, in two launches of 8 across a float32 level), and in
   storage mode pinned to B and to C (``tune.force("single_2d", ...)``):
   and to I and I-uni in both modes (25 launches a run: 200 / 8 in
   storage, 12 chunks of two carry launches and a remainder's one under
   f32chunk), a pinned f32chunk ``solve_stream`` (chunks of 80) and a
   pinned converge run (the stop test every 40 steps to 200) bitwise
   their E-uni runs;
   counts set to 0 before each run and read after (the form's launches,
   nothing else), the kernels' grids bitwise equal in each mode, each run's
   Mcells*steps/s, device ms a launch and idle share, and each mode's
   error against a float64 oracle of the same 200 steps from the same
   initial grid, run on the card (and the floor: the oracle rounded to
   bfloat16); then both modes on a 4096^2 grid that moves, against the
   oracle, f32chunk held near the floor and well under storage;
3d. precision — 1000^2 bfloat16 to eps = 1e-3 on A through the window
   graphs, bitwise the eager executor (it runs to its 10000-step cap:
   the plate's bfloat16 ulps dwarf eps); a bfloat16 f32chunk
   ``solve_stream`` at 4096^2 in chunks of 40 (rounded up to 48) with
   the guard and the diagnostics, bitwise ``solve()``; the CLI at
   1024^2 with ``--dtype bfloat16 --accumulate f32chunk``, its .dat the
   solver's grid's; the float64 route (torch, no kernel) bitwise the
   CPU's;
3e. main_path_3d_bf16 — BASELINE config 5 at bfloat16,
   ``solve(HeatConfig(nx=512, ny=512, nz=512, steps=200,
   dtype="bfloat16"))`` by the default pick (``heat_f_temporal3d_bf16``,
   exactly 67 launches) and pinned to D (exactly 200 launches of
   ``heat_d_step3d_bf16``), counts set to 0 before each run and read
   after, the two grids bitwise equal, each run's Mcells*steps/s (F's
   device ms a launch and idle share); its ``solve_stream`` in chunks of
   40, bitwise ``solve()``; 64^3 to eps = 1e-3 (to its 1000-step cap)
   under each, bitwise between them and the CPU's plain versions;
   float64 at 512^3 on the torch route (no kernel launched) and at 64^3
   bitwise the CPU's; 8 x 64^3 bfloat16 members on the vmap route, each
   bitwise its solo torch-route ``solve()``; the CLI with ``--nx 64 --ny
   64 --nz 64 --dtype bfloat16``, its .npy the solver's grid's bytes;
4b. converge_3d — 10^3 with eps=1e-3, which converges at step 360 on
   the CPU, under F and D: steps_run, converged, the residual and the
   grid equal to the CPU's plain run;
5. cli — ``python -m parallel_heat_tpu_torch --nx 256 --ny 256 --steps
   500 --out <tmp>.dat``, whose file must read back to the solver's
   grid, and ``--nx 64 --ny 64 --nz 64 --steps 100 --out <tmp>.npy``,
   whose array must equal the solver's grid;
6b. timing_bf16 — the precision forms as timing does: A at 1000^2 (K =
   20, residual), E-uni, E, I-uni and I at 32768^2 (K = 8; the carry's
   first and last launches), B and C at 32768^2 (one step, residual), M at
   64 x 512^2 (K = 400), the yardstick ``conv2d`` in bfloat16 (chained K
   times; zero-padded for M), each bound from
   the bytes of the function replaced (a bfloat16 grid read and written
   once a launch in storage mode, once a 16-step chunk under f32chunk);
   D (one step, residual) and F (K = 3 under the load its grid takes,
   and under the other) at 512^3 with ``conv3d`` in bfloat16 chained K
   times, bound 2 x 512^3 x 2 B a launch, beside their float32 forms'
   times on the same plate; the G family's bfloat16 forms at the main
   path's 16384 x 8192 block of the 32768^2 plate on (2, 4), K = 8, no
   residual (G-uni's deferred bulk, G-fuse's form as the same bulk, G-fuse,
   G-circ and G monolithic, the band's launch over the 8 blocks), bound at
   2 B a cell, yardstick ``conv2d`` in bfloat16 chained K times, and whole
   bfloat16 rounds under each schedule; the H family's bfloat16 forms at
   the 512^3 block of 1024^3 on (2, 2, 2), K = 3, no residual (H-fused
   monolithic and its deferred bulk, H on the padded circular block, the
   band's launch over the 8 blocks), each in turns with its float32 twin
   on the same blocks in float32, bound at 2 B a cell, yardstick
   ``conv3d`` in bfloat16 chained K times, and whole bfloat16 rounds of
   the 8 blocks under each kind;
6. timing — each kernel, its plain version and a PyTorch yardstick
   (``conv2d`` with the 5-point weights, TF32 off; it computes the
   interior update only) with CUDA events, at the shape and depth of the
   kernel's launch on the main path: B, C, E, E-uni, I and I-uni at
   16384^2, A at 1000^2 with K = 20, D and F (K_default) at 512^3 with
   ``conv3d`` and its 7-point weights as the yardstick; F beside its
   time before the register-blocked plane loop, its device time at
   K = 1 .. 4 (a step and the launch's fixed share) and under each load
   in turns at 512^3 and 512x512x508; E and E-uni
   beside their time before the register-blocked tile loop, and E-uni's
   device time at K = 4, 6 and 8, with the line's slope (a step) and
   intercept (the fixed share of a launch). Events around
   back-to-back
   launches time the host when it is the slower side (A's 20-step launch
   at 1000^2 takes about as long on the card as its wrapper on the
   host), so each kernel's own device time is also read from
   ``torch.profiler`` (``device_ms``); that is the ``ms`` of the
   ``kernels`` line.

7. kernels_ens — M (``heat_m_ensemble``) against its plain version,
   bitwise, grids and ``(B,)`` residuals, with and without the residual,
   on random members: B in {1, 3, 64}, members of 512^2 (the main
   path's), 107x210 and 24x20 (one block per member), B = 8 of 20^2 and
   166^2 (one block per member, the largest) and of 167^2 and 256^2
   (cooperative tilings) and, for B = 3, 1000^2; K in {1, 7, 20}; also
   cx = 0.1, cy = 0.2; each checked member bitwise ``heat_a_resident``
   on that member alone; M at each halo depth of ``m_depths`` under its
   best-modelled tiling on 5 members of 512^2; the main path's one
   launch, (64, 512, 512) at K = 400 without the residual, likewise; and
   one member seeded with a NaN (only its residual is NaN, the other
   members' bits untouched);
8. kernels_mg — ``heat_mg_restrict`` and ``heat_mg_prolong`` against
   their plain versions, bitwise, on random float32 arrays: fine 4098^2,
   1001x999, 514^2, 34x34, 5x4 and 4099x4097, and every pair of
   neighbouring levels of the main path's hierarchy (512^2 <-> 257^2,
   257^2 <-> 129^2, ..., 9^2 <-> 5^2: a 512^2 grid has a 510^2 interior);
   even and odd fine interiors both, a stack of three, ring exactly
   zero, and every output cell written (each launch again into a
   NaN-filled output through ``multigrid._launch_transfer``);
9. ensemble — ``EnsembleSolver`` at full width: 64 members of 512^2 (the
   size of ``bench.py --row ensemble512``), 400 fixed steps, path M, one
   launch, every member bitwise the solo ``solve()``; aggregate
   Mcells*steps/s for B = 1, 8, 64 beside the time of B solo solves one
   after the other; and converge mode, 8 members whose initial grids are
   scaled to converge at different windows, of 20^2 (the reference's
   small case) and of 256^2 under a step cap that is no multiple of the
   check interval: grid, steps_run, converged and residual of every
   member identical to its solo run, M's launches as the dispatches
   predict, at least one compaction;
10. implicit — ``solve()`` at 512^2, ``scheme="backward_euler"``,
   cx = cy = 22.5 (the ``implicit512`` row of ``bench.py``), 20 steps,
   full coarsening, and ``crank_nicolson``: ``backend="cuda"`` (the
   transfer kernels) against ``backend="torch"`` on the card, bitwise;
   the Dirichlet ring bit-exact; one step of each scheme held to its
   linear system in float64, ``max|b - A x| <= 1.05 * mg_tol * max|b|``
   (1.05: the float32 solve's rounding on top of its own verdict);
   cycles and host syncs per step, and each transfer kernel's launches
   as the cycles predict;
10a. ensemble_bf16 — ``EnsembleSolver(HeatConfig(nx=512, ny=512,
   steps=400, dtype="bfloat16"), 64)``: path M, exactly one launch of
   ``heat_m_ensemble_bf16`` (counts set to 0 just before, read just
   after), every member bitwise its solo bfloat16 ``solve()``; 8 members
   of 256^2 bfloat16 noise to eps = 1e-2 on M (three stop at different
   windows, the others at the cap), bitwise their solo runs; 8 x 512^2
   bfloat16 under f32chunk and 4 x 512^2 float64, 400 steps, on the vmap
   route (no kernel), every member bitwise a solo ``solve()`` with
   ``backend="torch"`` on the card;
10b. implicit_precision — the implicit phase's 512^2 backward Euler and
   Crank-Nicolson at bfloat16 and float64 under ``backend="cuda"``:
   through the transfer kernels (as the cycles predict, no plain
   transfer) and the device loop's graphs, bitwise the eager executor and
   the torch backend on the card (as at float32); the ring bit for bit; a
   float64 run bitwise the float32 run, widened;
11. timing_ens_mg — ms per launch (CUDA events, and the card's own time
   from ``torch.profiler``) of M at (64, 512, 512) with K = 400 (the
   main path's one launch; the ``kernels`` line takes this row) and with
   K = 20 and the residuals (a converge window), and at K = 20 with the
   residuals on 8 members of 20^2 (one block each) and of 256^2 (a
   cooperative tiling), and of restrict and
   prolong at 4098^2 <-> 2050^2, at the main path's smallest pair, 9^2
   <-> 5^2 (a transfer launch's floor), and at its finest, 512^2 <->
   257^2 (the ``kernels`` line takes this one), each beside
   its plain version, its bound and a PyTorch yardstick (``conv2d``,
   zero-padded, chained K times for M, ``conv2d`` with the
   full-weighting weights at stride 2 for restrict, ``conv_transpose2d``
   with the bilinear weights for prolong, TF32 off); and the host's
   microseconds for each piece of one transfer call at 512^2
   (``tools/launch_cost.py``: the launch record's lookup, ``torch.empty``,
   the stream, the bare ``ctypes`` launch, the whole call, one
   ``torch.add`` for scale).

12. kernels_g — the sharded block kernels G-uni
   (``heat_g_block_uniform``), G-fuse (``heat_g_block_fused``), G-circ
   (``heat_g_block_circular``), G (``heat_g_block_padded``) and the band
   fix (``heat_g_band_fix``) against their plain versions, each other and
   kernel E's K steps of the global grid on the same cells, all bitwise
   (grids and residuals), with the exchange's pieces built by the port's
   own exchange from seeded random grids: the main path's 16384 x 8192
   blocks of 32768^2 on (2, 4) (a corner block and one with neighbours on
   three sides) at K = 8; every 500 x 252 block of 1000 x 1008 and every
   500 x 250 block of 1000^2 on (2, 4) at every compiled K (1 ..
   g_k_max); 16 x 24 blocks (exactly 2K rows) at K = 8; cx = cy = 0.1
   and cx = 0.1, cy = 0.2. Each grid's blocks must hold, at each K, tiles
   of every kind they are there for (``hopper_params.g_tile_kinds``:
   tiles inside the block and at its edge, a ragged last row and column
   tile, tiles reaching past the grid's interior, and on the 250-wide
   blocks a last group of 2 columns). The deferred bulk plus the band,
   spliced in place, must be the monolithic kernel, grid and max
   residual; the band kernel over every block of each grid in one launch
   (and over the 4 blocks of 16384^2 on (2, 2)) must be each block's plain
   version and the batched plain version; a NaN-seeded block gives NaN
   residuals with its ring intact, one launch or one a block;
13. sharded_main_path — ``solve(HeatConfig(nx=32768, ny=32768, steps=200,
   mesh_shape=(2, 4)))`` under the default resolution (K = 8, overlap:
   G-uni bulk + band: 200 bulk launches, 25 band launches, one a round
   for the 8 blocks), with ``halo_overlap="phase"``,
   and pinned to G-fuse, G-circ and G (``tune.force("block_temporal_2d",
   ...)``), counts set to 0 before each run and read after, every grid
   bitwise the one-block run; busy shares of one profiled repeat of the
   sharded and the one-block run; and 16384^2 on (2, 2), bitwise the
   16384^2 main path;
14. sharded_converge — 1000^2 on (2, 4) to eps=1e-3 (rounds of 8 + 8 + 4
   a window), 20^2 on (2, 2) (converges at step 1980; the monolithic
   round) and 256^2 on (2, 2) at halo depth 1 (G at K = 1 each step):
   steps_run, converged, residual and grid identical to one block;
15. cli_sharded — ``--nx 256 --ny 256 --steps 100 --mesh 2,2 --out
   <tmp>.dat`` writes the one-block grid's bytes;
15a. kernels_g_bf16 — the bfloat16 forms of G-uni, G-fuse, G-circ, G
   and the band (``<kernel>_bf16``) against their plain versions, each
   other and E's bfloat16 K steps of the global grid, all bitwise (grids
   and residuals), at every compiled K on 500 x 256 (G-uni's form),
   500 x 252 (G-uni's form refused) and 500 x 250 blocks on (2, 4), at
   K = 8 on the main path's 16384 x 8192 blocks and on 16 x 24 (exactly
   2K rows), cx = 0.1, cy = 0.2, every grid seeded with NaNs of payloads
   no conversion makes and each grid's blocks asserted to run every tile
   kind they are there for; the bulk plus the band the monolithic form;
   the band's one launch under the per-cell and the row load;
15b. sharded_main_path_bf16 — ``solve(HeatConfig(nx=32768, ny=32768,
   steps=200, dtype="bfloat16", mesh_shape=(2, 4)))`` by default (K = 8,
   overlap: 200 ``heat_g_block_uniform_bf16`` and 25
   ``heat_g_band_fix_bf16`` launches), under ``phase`` and pinned to
   G-fuse, G-circ and G, exactly each run's launches, every grid bitwise
   the one-block bfloat16 run (E-uni's form); the default run's busy
   share and its stream in chunks of 40 at pipeline depth 2, bitwise
   ``solve()``; 1000^2 on (2, 4) to eps (G-fuse's form) with the
   one-block run's steps_run, converged, residual and grid; float64 on
   the torch rounds at 1024^2 on (2, 4) and 64^3 on (2, 2, 2), bitwise
   one block, no kernel launched; and the CLI with ``--mesh 2,4 --dtype
   bfloat16``, the one-block grid's bytes;
16. timing_g — ms per launch (CUDA events, and the card's own time from
   ``torch.profiler``) of each G kernel at the main path's block, 16384 x
   8192 at K = 8 without the residual: the deferred bulk of G-uni (the
   ``kernels`` line's row), G-uni, G-fuse, G-circ and G monolithic and the
   band kernel's launch for the round's 8 blocks, each beside its plain
   version, its bound and ``conv2d`` chained K times on the framed block
   (the band's on its 16 windows; TF32 off), G-uni's and G-fuse's beside
   their time before the register-blocked step loop, the band's beside
   the per-block design (8 one-entry launches, device time summed, and
   their events); the exchange's own time per round (both phases, 8
   blocks), one whole round under ``overlap`` and under ``phase``, and
   the device operations the host issues a round under each.
17. kernels_h — the sharded 3D block kernels H-fused
   (``heat_h_block_3d_fused``, monolithic and as the deferred bulk, under
   the cp.async load and, where the geometry takes it, the TMA load), H
   (``heat_h_block_3d``) and the band fix (``heat_h_band_fix_3d``) against
   their plain versions, each other and kernel F's K steps of the global
   grid on the same cells, all bitwise (grids and residuals), the pieces
   built by the port's own three-phase exchange from seeded random grids:
   the main path's 512^3 blocks of 1024^3 on (2, 2, 2) at K = h_k_default;
   the corner, edge, face and interior blocks of 201 x 129 x 270 on
   (3, 3, 3) at K in {1, 3, h_k_default, h_k_max}, both coefficient sets,
   and of 201 x 210 x 276 (blocks that take TMA) at every compiled K;
   blocks of 6 x-planes, 6 x 50 x 70 and 6 x 70 x 72 (an empty bulk at
   K = 3, no deferral at K = 6); a z-free (2, 4, 1) mesh, blocks of
   40 x 33 x 97 and 40 x 66 x 96; an x-free (1, 2, 2) mesh. H (F's
   plane loop) runs on the contiguous circular block and on the padded
   one the round assembles, under both loads, at every compiled K on 67 x
   128 x 92, 6 x 128 x 72 (K <= 6), 40 x 128 x 96 and 20 x 128 x 252,
   and H(K) is F(K); every kind of H's tiles (``hc_tile_kinds``: boxed
   and wrapped, interior and edge, past each side, ragged, a partial
   group) must have run. The deferred bulk writes no band plane; bulk
   plus band, spliced in place, is the monolithic kernel; a NaN-seeded
   block gives NaN residuals with its faces intact under both loads; the
   band's one launch over every block of each mesh with an x axis to
   defer (each K, the last coefficient set), under each of its loads
   (``BAND_LOADS_3D``: the 4-byte and, where it fits, 16-byte load on F's
   plane loop) into NaN-filled
   outputs, bitwise the per-block and the batched plain versions and
   kernel F on the band planes, nothing between the bands written, and
   the round's 8 deferred bulks plus that launch bitwise the monolithic
   kernel with max(bulk, band) its residual; every kind of the band's
   tiles (``h_band_tile_kinds``) must have run;
17a. kernels_h_bf16 — the bfloat16 forms of H-fused
   (``heat_h_block_3d_fused_bf16``, its one load), H
   (``heat_h_block_3d_bf16``, contiguous and padded circular blocks, both
   loads) and the band (``heat_h_band_fix_3d_bf16``, one launch over
   every block under each load) into NaN-filled outputs, each bitwise its
   plain version, the others, F's bfloat16 K steps and K launches of
   ``heat_d_step3d_bf16`` on the global grid (grid and residual), the
   bulk plus the band bitwise the monolithic form: the main path's 512^3
   blocks at K = 3, every compiled K on 67x128x92 and 20x128x252 on
   (3, 3, 3), 6x128x72 (K <= 6) on (2, 2, 2) and 40x128x96 on (2, 4, 1),
   K = 1, 3, 6 on 6x50x70 (lanes straddling the z tail), every tile kind
   of H (``hc_tile_kinds`` at 2-byte cells) and of the band asserted run;
   NaN-seeded 40^3 and 20x128x128 blocks (payloads kept, NaN residual,
   faces bit for bit);
18. sharded_main_path_3d — ``solve(HeatConfig(nx=ny=nz=1024, steps=200,
   mesh_shape=(2, 2, 2)))`` under the default resolution (H-fused, the
   monolithic round), with ``halo_overlap="phase"``, and pinned to H and
   H-defer (``tune.force("block_temporal_3d", ...)``; its band one
   launch a round for the 8 blocks), counts set to 0
   before each run and read after, every grid bitwise the one-block F
   run, Mcells*steps/s and the ratio to it; busy shares of one profiled
   repeat of the sharded and the one-block run; then 512^3 on (2, 2, 2)
   and on (2, 4, 1) (there also with H pinned), bitwise their one-block
   run;
19. sharded_converge_3d — 64^3 on (2, 2, 2) in converge mode (2000-step
   cap, check_interval 20), 10^3 on (2, 2, 2) (blocks of 5: the auto depth
   capped by the block; converges at step 360) and 64^3 at halo depth 1
   (H-fused at K = 1): steps_run, converged, residual and grid identical
   to one block;
20. cli_sharded_3d — ``--nx 64 --ny 64 --nz 64 --steps 100 --mesh 2,2,2
   --out <tmp>.npy`` writes the one-block grid;
20a. sharded_main_path_3d_bf16 — 1024^3 bfloat16
   on (2, 2, 2), 200 steps: the default (H-fused's bfloat16 form, 536
   launches), the phase schedule, H and H-defer pinned (67 bfloat16 band
   launches), counts exact, every grid bitwise the one-block bfloat16 run
   (F's form); the default run's stream in chunks of 40 at depth 2
   bitwise solve(); 512^3 bfloat16 on (2, 4, 1), 64^3 bfloat16 on
   (2, 2, 2) to eps (steps, verdict, residual and grid of the one-block
   run) and the CLI at 64^3 (the one-block run's .npy bytes);
20b. device_loop — the loops on the card (``utils/device_loop.py``:
   converge windows, implicit V-cycles and fixed sharded rounds replayed
   as graphs, the stop test on the card) against the eager executor
   (every stop test a host read, the loop the port ran before), both in
   this process: 1000^2 to eps under A, 512^2 backward Euler and
   Crank-Nicolson (20 steps), 1000^2 on (2, 4) and 64^3 on (2, 2, 2) to
   eps, 32768^2 on (2, 4) and 1024^3 on (2, 2, 2) fixed (200 steps), and
   20^2 (converges at step 1980), 16^2 past the stability bound (NaN at
   step 140, the ring bit-exact) and 10^3 on (2, 2, 2) (converges at step
   360): steps_run, converged, residual, grid bit for bit, launch counts
   and V-cycles identical; host reads at most one a replay plus one in
   converge mode, none a step in fixed mode; each side's elapsed
   seconds, idle share, host reads, capture seconds, graph nodes and
   peak memory; then 1000^2 under A at 1, 4, 16 and 64 window copies a
   graph;
20c. stream — ``solve_stream`` and its observers on the card: 16384^2,
   200 steps (E-uni) in chunks of 40 with the guard every 40 steps and
   the diagnostics every 80, at pipeline depth 1 and 2 (every yielded
   grid, ``finite`` and ``diagnostics`` identical at both depths, the
   last grid bitwise ``solve()``; per chunk ``wall_s``, ``gap_s`` and
   ``drain_wait_s`` from the run's telemetry; the card's idle share
   over each stream by ``torch.profiler``); 1000^2 to eps in chunks of
   1000 bitwise ``solve()`` (steps, verdict, residual, grid), host reads
   and elapsed seconds beside its; 32768^2 on (2, 4) in chunks of 40 at
   depth 2 with guard and diagnostics, bitwise ``solve()``, and its peak
   memory; 64 x 512^2 (path M) with telemetry, guard and diagnostics,
   every member bitwise the plain run and one ``member_end`` a member;
   512^2 backward Euler in chunks of 5 with the diagnostics every 5
   steps (``vcycle`` events, the first with ``level_wall_share``); the
   CLI with ``--metrics``, ``--guard-interval``, ``--diag-interval``,
   ``--pipeline-depth 2`` and ``--profile`` (its metrics file read here,
   a trace file in the profile directory); then the guard's and the
   diagnostics' ms (CUDA events) against their byte bounds at 16384^2
   and on the blocks of 32768^2 on (2, 4);
21. timing_h — ms per launch (CUDA events, and the card's own time from
   ``torch.profiler``) of each H kernel at the main path's block, 512^3 at
   K = h_k_default without the residual: H-fused monolithic (the
   ``kernels`` line's row), its deferred bulk, H and the band kernel's
   launch for the round's 8 blocks, each beside its plain version, its
   bound and ``conv3d`` chained K times on the framed block (the band's
   on its 16 windows; TF32 off); the band's device time under each of
   its loads in turns and 8 one-entry launches (device time summed, and
   their events); for H-fused also its earlier design's
   time, its launch
   under each load and its interior and edge tiles launched alone (the
   µs each kind adds per tile), and the occupancy of its main-path
   instance; for H its earlier design's time, its launch under each load
   and the µs a boxed and a wrapped tile take (by difference), and its
   occupancy; the exchange's time and copies per round (three phases, 8
   blocks), one whole monolithic H-fused round, one pinned-H round (8
   assemblies into the padded buffers and 8 launches of H) and one
   H-defer round (8 deferred bulks and one band launch), in turns, and
   the device operations the host issues a round under each;
22. probe_kernel — kernel A's anatomy probe (``tools/kernel_probe.py``,
   ``heat_probe_kernel``) at 1000^2: its ``full`` variant bitwise A's
   plain version, then every variant at K = 20 and 2000 (a step by the
   slope, the launch's fixed share by the intercept, what each cut
   saves a step) and A's device time at K = 1, 2, 4, 8 and 20;
23. probe_vpu_roofline — the issue-rate roofline
   (``tools/vpu_roofline.py``, ``heat_probe_vpu_roofline``): ``fma`` at
   P = 1 and 16, ``muladd`` at P = 16 and ``stencil`` bitwise their plain
   versions at 1 and 4 passes on a 3 x 24 x 256 stack and on the
   full-width stack (one 192 x 128 member an SM, 96 KB a buffer), then
   every variant's µs a pass by the slope of its device time between 64
   and 1024 passes, its rates, the SM clock under it and its bound;
24. probe_temporal — E-uni's anatomy (``tools/probe_temporal.py``,
   ``heat_probe_temporal``): its ``full`` variant bitwise
   ``temporal_steps_uni_plain`` (grid and residual) at 16384^2, K = 8, and
   at every compiled K on 1001 x 1000 and 20 x 24 (every tile kind of
   ``e_tile_kinds`` but a part group, which E-uni's widths never have),
   then each variant's device ms at 16384^2 and 8192^2,
   K = 8, what each cut saves, and E-uni's K ladder (K = 1, 2, 4, 6, 8);
25. probe_ab_temporal — E-uni's boundary forms
   (``tools/ab_temporal.py``, ``heat_probe_ab_temporal``): ``prod`` and
   ``rowcopy`` bitwise ``temporal_steps_uni_plain`` at every compiled K
   on 1001 x 1000 and 20 x 24, then, after the same check on each plate,
   the three forms in turns (three batches) at 16384^2, 8192^2 and
   1024^2, K = 8;
26. probe_split_copy — E-uni's load split (``tools/probe_split_copy.py``,
   ``heat_probe_split_copy``): every load form bitwise
   ``temporal_steps_uni_plain`` (no residual) at every compiled K that
   its geometry allows (K = 5 .. 8 but ``whole`` and ``branchy``, 1 .. 8)
   on 1001 x 1000 and 20 x 24 and at 16384^2, K = 8, then the eight forms
   in turns (three batches) at 16384^2 and 4096^2, K = 8;
27. probe_gather_dma — loads alone (``tools/probe_gather_dma.py``,
   ``heat_probe_gather_dma``): every form's element and each block's last
   window bitwise its plain version on 1001 x 1000 and 4096^2 (tail 128),
   then each form's device time and landed GB/s at 4096^2 and 16384^2;
28. probe_sweep_width — the shared-memory sweep's width ladder
   (``tools/probe_sweep_width.py``, ``heat_probe_sweep_width``): bitwise
   its plain version on a 3-member stack at D = 1, 2 and 5 at every
   width, and on the full stack (one member an SM) at the widest, then µs
   a sweep by the slope over D = 64 and 1024 at each width;
29. probe_store_align — the same sweep at band offsets 1, 8, 9, 16 and
   row pitches 128 and 129 (``tools/probe_store_align.py``,
   ``heat_probe_store_align``): the same checks (the full stack at pitch
   129), then the slopes;
30. probe_roll_pad — A's and E-uni's neighbour forms
   (``tools/probe_roll_pad.py``, ``heat_probe_roll_pad``): ``prod``,
   ``padslice`` and ``nbr4`` bitwise their kernel's plain version (grid
   and residual) on A at every halo depth 1 .. 8 on 1000^2 and at several
   K on 1001 x 999, 21 x 23 and 20 x 24, and on E-uni at every compiled K
   on 1001 x 1000 and 20 x 24, then in turns (two batches) on A at 1000^2,
   K = 20, and 1859^2, K = 64, and on E-uni at 16384^2, K = 8;
31. probe_xslab_overlap — F's load/compute overlap
   (``tools/probe_xslab_overlap.py``, ``heat_probe_xslab_overlap``):
   ``full`` bitwise F's plain version on random grids and the 512^3
   plate under TMA and cp.async, then ``full``, ``no_step`` and
   ``no_load`` at 512^3, K = 3, under each load, the max and sum models
   and a ring ladder.

Then a ``{"phase_seconds": {...}, "total_s": t}`` line (each phase's
wall seconds, from the line before its own), a ``{"kernels": [...]}``
line (all twenty kernels, the twenty-two precision forms of A, B, C, D,
E, E-uni, F, I, I-uni, M, G-uni, G-fuse, G-circ, G, the 2D band, H-fused,
H and the 3D band with their launches in main_path_bf16,
main_path_3d_bf16, precision, ensemble_bf16, sharded_main_path_bf16 and
sharded_main_path_3d_bf16, and the ten
probes' kernels, each with its own run's launches: A's anatomy probe and
neighbour forms with A's plain version, bound and yardstick, the E-uni
probes with E-uni's, the overlap probe with F's, the roofline with its
stencil's at 64 passes, the gather probe with its dense TMA form at
16384^2 and no yardstick, the sweep probes with their own at D = 64)
and, last, the
``{"ok": true, "device": {...}}`` line. Any failure exits non-zero
before the last line; without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CX = CY = 0.1
UNEQUAL = (0.1, 0.2)
BIG = 16384              # BASELINE's "16k^2" grid: the main-path size
MAIN_STEPS = 200
CONV = 1000              # BASELINE Table 7's grid: the converge path
A_LARGEST = 1859         # the largest square grid kernel A takes
WINDOW = 20              # its check_interval: steps per launch of A
CUBE = 512               # BASELINE config 5's 512^3: the 3D main path
UNEQUAL_3D = (0.1, 0.15, 0.05)
# Past 2^31 cells (2.19e9 and 2.18e9: int64 offsets needed), one grid for
# each of F's loads: rows of a multiple of 16 bytes (TMA) and not.
PAST_2_31 = ((1291, 1299, 1304), (1291, 1299, 1301))
OPS_PER_CELL_STEP = 7       # 3 multiplies + 4 adds of combine_2d
OPS_PER_CELL_STEP_3D = 10   # 4 multiplies + 6 adds of combine_3d
OPS_PER_RESIDUAL_CELL = 2   # subtract + max (the abs is a bit clear)
ENS_B = 64               # bench.py --row ensemble512: 64 members
ENS_N = 512              # of 512^2,
ENS_STEPS = 400          # 400 fixed steps
# Converge mode: (member size, step cap, base grid). Eight members, the
# base grid times ENS_SCALES, converge at different windows: the
# residual scales with the grid. 20^2 is the plate, as in the reference's
# small case; 256^2 is uniform noise in [0, 100), whose residual falls
# fast enough that six of the eight converge under the cap.
ENS_CONV = ((20, 10000, "plate"), (256, 1990, "noise"))
M_SOLO_LARGEST = 166     # the largest square member kernel M runs a block
ENS_SCALES = (1.0, 0.5, 0.01, 2.0, 0.001, 1e-4, 3.0, 1e-5)
IMP_N = 512              # bench.py --row implicit512: 512^2,
IMP_STEPS = 20           # 20 steps at
IMP_C = 22.5             # cx = cy = 22.5, 100x the explicit stable step
# Fine shapes (ring included) the transfer kernels are checked at, beside
# every level of the main path's hierarchy but its coarsest.
MG_FINE = ((4098, 4098), (1001, 999), (514, 514), (34, 34), (5, 4),
           (4099, 4097))
# Timed: a large level, the main path's smallest pair and its finest (the
# kernels line).
MG_TIMED = ((4098, 4098), (9, 9), (IMP_N, IMP_N))
TPU = "parallel_heat_tpu/ops/pallas_stencil.py"
# Kernel -> (its tune.force choice, the TPU kernel's builder it replaces),
# at site single_2d for KERNELS_2D and single_3d for KERNELS_3D.
KERNELS_2D = {
    "heat_a_resident": ("A", TPU + ":117"),
    "heat_b_step": ("B", TPU + ":294"),
    "heat_c_tiled": ("C", TPU + ":3059"),
    "heat_e_temporal": ("E", TPU + ":607"),
    "heat_e_uni_temporal": ("E-uni", TPU + ":832"),
    "heat_i_tile_temporal": ("I", TPU + ":3294"),
    "heat_i_uni_tile_temporal": ("I-uni", TPU + ":3456"),
}
KERNELS_3D = {
    "heat_f_temporal3d": ("F", TPU + ":3932"),
    "heat_d_step3d": ("D", TPU + ":3708"),
}
KERNELS_ENS_MG = {
    "heat_m_ensemble": ("M", "parallel_heat_tpu/ops/batched.py:97"),
    "heat_mg_restrict": (None, "parallel_heat_tpu/ops/multigrid.py:225"),
    "heat_mg_prolong": (None, "parallel_heat_tpu/ops/multigrid.py:256"),
}
# The sharded 2D path: BASELINE.md's north star, 32768^2 on 8 chips, as a
# (2, 4) mesh of 16384 x 8192 blocks, here all on the one card.
SHARD_N = 32768
SHARD_MESH = (2, 4)
SHARD_CONV = (2, 4)          # the converge phase's mesh at 1000^2
# Kernel -> (its tune.force choice at site block_temporal_2d, the TPU
# kernel's builder it replaces).
KERNELS_G = {
    "heat_g_block_uniform": ("G-uni", TPU + ":1827"),
    "heat_g_block_fused": ("G-fuse", TPU + ":1560"),
    "heat_g_block_circular": ("G-circ", TPU + ":1343"),
    "heat_g_block_padded": ("G", TPU + ":1135"),
    "heat_g_band_fix": (None, TPU + ":2093"),
}
# The sharded 3D path: 1024^3 on (2, 2, 2), blocks of BASELINE config 5's
# 512^3 (4 GiB a copy, the bytes of the 2D path's 32768^2).
SHARD3_N = 1024
SHARD3_MESH = (2, 2, 2)
# Kernel -> (its tune.force choice at site block_temporal_3d, the TPU
# kernel's builder it replaces).
KERNELS_H = {
    "heat_h_block_3d_fused": ("H-fused", TPU + ":4579"),
    "heat_h_block_3d": ("H", TPU + ":4353"),
    "heat_h_band_fix_3d": ("H-defer", TPU + ":4934"),
}
KERNELS = {**KERNELS_2D, **KERNELS_3D, **KERNELS_ENS_MG, **KERNELS_G,
           **KERNELS_H}
# The sharded 3D family's bfloat16 forms, a library each: name -> (its
# source, the TPU kernel's builder it replaces at dtype bfloat16).
KERNELS_H_BF16 = {
    "heat_h_block_3d_fused_bf16": ("heat_h_block_3d_fused_bf16",
                                   TPU + ":4579"),
    "heat_h_block_3d_bf16": ("heat_h_block_3d_bf16", TPU + ":4353"),
    "heat_h_band_fix_3d_bf16": ("heat_h_band_fix_3d_bf16", TPU + ":4934"),
}
# The measurement tools' kernels: kernel A's anatomy probe, the
# issue-rate roofline, E-uni's anatomy, its boundary A/B and its load
# split, loads alone, the shared-memory sweep's widths and offsets, A's
# and E-uni's neighbour forms, and F's load/compute overlap.
PROBES = {"heat_probe_kernel": (None, "tools/kernel_probe.py:27"),
          "heat_probe_vpu_roofline": (None, "tools/vpu_roofline.py:49"),
          "heat_probe_temporal": (None, "tools/probe_temporal.py:39"),
          "heat_probe_ab_temporal": (None, "tools/ab_temporal.py:63"),
          "heat_probe_split_copy": (None, "tools/probe_split_copy.py:50"),
          "heat_probe_gather_dma": (None, "tools/probe_gather_dma.py:40"),
          "heat_probe_sweep_width": (None, "tools/probe_sweep_width.py:40"),
          "heat_probe_store_align": (None,
                                     "tools/probe_store_align.py:36"),
          "heat_probe_roll_pad": (None, "tools/ab_roll_pad.py:52"),
          "heat_probe_xslab_overlap": (None,
                                       "tools/ab_xslab_overlap.py:38"),
          "heat_probe_fixture": (None, "tests/test_analysis.py:1031")}
ROOF_PASSES = 64         # the roofline's kernels-line launch: 64 passes
# F's record variants (the kernel audit's, in the overlap probe's
# library): ptxas's instance keys. They spill (the leader's bookkeeping on
# top of F's 122 registers) and are timed nowhere; E-uni's does not.
RECORD_INSTANCES = {"heat_probe_xslab_overlap": ("3, true", "3, false")}
TEMPORAL = ("heat_e_temporal", "heat_e_uni_temporal", "heat_i_tile_temporal",
            "heat_i_uni_tile_temporal")
# I's and I-uni's check grids, each at every K (the coefficient pairs):
# widths no multiple of 4 (I only) over three bands, a grid narrower than
# one band, 3 x 8, m = 3, several segments and the main path's 16384^2;
# every K's grids together run each kind of band and segment of
# I_BAND_KINDS (hopper_params.i_band_kinds).
_EQ = {"cx": CX, "cy": CY}
_UNEQ = {"cx": UNEQUAL[0], "cy": UNEQUAL[1]}
I_PLAN = (((1001, 1000), (_EQ, _UNEQ)), ((1001, 999), (_EQ, _UNEQ)),
          ((37, 257), (_UNEQ,)), ((40, 50), (_UNEQ,)), ((3, 8), (_UNEQ,)),
          ((3, 300), (_UNEQ,)), ((200, 132), (_UNEQ,)),
          ((BIG, BIG), (_EQ,)))
I_BAND_KINDS = ("interior", "first", "last", "partial", "unaligned", "idle",
                "free_rows", "edge_rows")
# The spill of I's and I-uni's K = 8 instances at 128 registers: ptxas's
# bytes of (stores, loads), at most. PERF.md §6 (I and I-uni) has where
# the words are read and what they cost; the build phase fails if they
# grow.
I_SPILL_K8 = {"heat_i_tile_temporal": (84, 124),
              "heat_i_uni_tile_temporal": (68, 92)}
# The spill of the 3D band's instance at the main path's depth, shape and
# load (<3, 2, 1>: F's plane loop under a 128-register cap with the band's
# loader, which keeps the tile's offsets out of registers): ptxas's bytes
# of (stores, loads), at most; the build phase fails if they grow.
BAND_SPILL_3D = (0, 0)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# When each phase's line was printed, for the phase_seconds line.
_PHASE_AT = []


def emit(obj):
    if "phase" in obj:
        _PHASE_AT.append((obj["phase"], time.perf_counter()))
    print(json.dumps(obj), flush=True)


def phase_seconds(start: float) -> dict:
    """Each phase's wall seconds, from the line before its own (the
    first from ``start``), and the whole run's."""
    out, t = {}, start
    for name, at in _PHASE_AT:
        out[name] = at - t
        t = at
    return {"phase_seconds": out, "total_s": t - start}


def same_float(a, b) -> bool:
    a, b = float(a), float(b)
    return (math.isnan(a) and math.isnan(b)) or a == b


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from parallel_heat_tpu_torch.kernels import build

    t0 = time.perf_counter()
    names = tuple(build.KERNELS) + tuple(build.TOOLS) + tuple(build.HELPERS)
    paths = build.build(*names)
    seconds = time.perf_counter() - t0
    for name in names:
        build.load(name)
    # ptxas's report by template instance: <K, R, ...> -> [registers,
    # spill stores, spill loads, static shared bytes]; by the whole
    # instance name where a library holds more than one kernel template,
    # so that no instance hides another.
    # (An earlier run's build left its report beside the library.)
    def by_instance(rows):
        kernels = {r["instance"].partition("<")[0] for r in rows}
        return {(r["instance"] if len(kernels) > 1 else
                 r["instance"].partition("<")[2].rstrip(">")
                 or r["instance"]): [r.get("registers"),
                                     r.get("spill_stores"),
                                     r.get("spill_loads"),
                                     r.get("smem_bytes")]
                for r in rows}

    ptxas = {name: by_instance(build.ptxas_report(build.build_log(name)))
             for name in names}
    spilling = {name: [a for a, row in rows.items() if row[1]]
                for name, rows in ptxas.items()}
    # The instance the sharded 3D main path launches must not spill.
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    hp = params()
    tma = skb3.h_load((SHARD3_N // 2,) * 3, hp.h_k_default) == "tma"
    main = f"{hp.h_k_default}, {hp.h_rows}, {'true' if tma else 'false'}"
    fused = ptxas["heat_h_block_3d_fused"]
    check(main in fused and fused[main][1] == 0,
          f"H-fused's main-path instance <{main}> spills or is missing "
          f"from the ptxas report: {fused.get(main)}")
    # Nor may H's instance that the pinned-H round launches at the main
    # path's depth (F's plane loop, both loads in one instance).
    h_main = f"{hp.h_k_default}, {hp.hc_shape(hp.h_k_default)[1]}"
    h_row = ptxas["heat_h_block_3d"].get(h_main)
    check(h_row is not None and h_row[1] == 0,
          f"H's main-path instance <{h_main}> spills or is missing from "
          f"the ptxas report: {h_row}")
    # Nor may the 3D band's instance that the H-defer round launches at
    # the main path's depth, shape and load (F's plane loop) spill more
    # than BAND_SPILL_3D.
    band_block, band_rows, _ = hp.h_band_shape(hp.h_k_default)
    band_load = skb3.BAND_LOADS_3D.index(
        "vec" if hp.h_band_vec_fits((SHARD3_N // 2,) * 3) else "cells")
    band_main = f"{hp.h_k_default}, {band_rows}, {band_load}"
    band_row = ptxas["heat_h_band_fix_3d"].get(band_main)
    check(band_row is not None and band_row[1] <= BAND_SPILL_3D[0]
          and band_row[2] <= BAND_SPILL_3D[1],
          f"the 3D band's main-path instance <{band_main}> spills more "
          f"than {BAND_SPILL_3D} bytes (stores, loads) or is missing from "
          f"the ptxas report: {band_row}")
    # Nor may the kernels on the register-blocked tile loop that the
    # sharded 2D main path (G-uni, G-fuse) and the one-device main path (E,
    # E-uni) launch, one instance each; their registers, and the blocks an
    # SM holds at the main path's depth, tile and thread block.
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    def loop_main(names, k, tile, block):
        out = {}
        for name in names:
            row = ptxas[name].get(name + "_kernel")
            check(row is not None and row[1] == 0,
                  f"{name}'s kernel spills or is missing from the ptxas "
                  f"report: {row}")
            out[name] = {"registers": row[0], "spill_stores": row[1],
                         "k": k, "tile": list(tile), "block": list(block),
                         "blocks_per_sm": sk.loop_occupancy(name, k, tile,
                                                            block)}
        return out

    g_main = loop_main(("heat_g_block_uniform", "heat_g_block_fused"),
                       hp.g_k_default, hp.g_tile, hp.g_block)
    e_main = loop_main(("heat_e_temporal", "heat_e_uni_temporal"),
                       hp.e_k_default, hp.e_tile, hp.e_block)
    # Nor may any instance of the precision forms of A, B, C, E, E-uni
    # (one a form: heat_temporal.cuh kHeatForm*) and M (its cooperative
    # and its one-block form).
    precision = {name: {i: row for i, row in ptxas[name].items()
                        if "bf16" in i}
                 for name in ("heat_a_resident", "heat_b_step",
                              "heat_c_tiled", "heat_e_temporal",
                              "heat_e_uni_temporal", "heat_m_ensemble")}
    check(all(len(precision[n]) == 1 for n in ("heat_a_resident",
                                                "heat_b_step",
                                                "heat_c_tiled"))
          and len(precision["heat_m_ensemble"]) == 2
          and all(len(precision[n]) == 4 for n in ("heat_e_temporal",
                                                   "heat_e_uni_temporal"))
          and all(row[1] == 0 and row[2] == 0 for rows in precision.values()
                  for row in rows.values()),
          f"a precision form's instance spills or is missing: {precision}")
    # Nor may F's instance that the one-device 3D main path (512^3, TMA)
    # launches, or its stack hold the plane loop's registers.
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3

    f_load = sk3.f_load((CUBE,) * 3)
    f_inst = (f"{hp.f_k_default}, {hp.f_rows}, "
              f"{'true' if f_load == 'tma' else 'false'}")
    f_row = ptxas["heat_f_temporal3d"].get(f_inst)
    check(f_row is not None and f_row[1] == 0,
          f"F's main-path instance <{f_inst}> spills or is missing from "
          f"the ptxas report: {f_row}")
    f_stack = {r["instance"]: r.get("stack_bytes") for r in
               build.ptxas_report(build.build_log("heat_f_temporal3d"))}
    f_main = {"instance": f_inst, "registers": f_row[0],
              "spill_stores": f_row[1],
              "stack_bytes": [b for i, b in f_stack.items()
                              if i.endswith(f"<{f_inst}>")],
              "k": hp.f_k_default, "block": list(hp.f_block),
              "rows": hp.f_rows, "load": f_load,
              "smem_bytes": hp.f_smem_bytes(hp.f_k_default),
              "blocks_per_sm": sk3.f_occupancy(hp.f_k_default, f_load)}
    # Nor may any instance of A or M (nor A's in the anatomy probe); their
    # registers and spills.
    resident = {name: ptxas[name] for name in
                ("heat_a_resident", "heat_m_ensemble", "heat_probe_kernel")}
    # Nor any instance of the other probes, whose times stand for the
    # loop's; but for F's record variants (RECORD_INSTANCES).
    probes = {name: ptxas[name] for name in PROBES
              if name != "heat_probe_kernel"}
    # Nor any instance of the band kernel (its row load and its per-cell
    # load).
    band = ptxas["heat_g_band_fix"]
    check(band and all(row[1] == 0 and row[2] == 0 for row in band.values()),
          f"an instance of heat_g_band_fix spills or none is reported: "
          f"{band}")
    for name, rows in {**resident, **probes}.items():
        check(rows and all(row[1] == 0 and row[2] == 0
                           for inst, row in rows.items()
                           if inst not in RECORD_INSTANCES.get(name, ())),
              f"an instance of {name} spills or none is reported: {rows}")
    # Nor any instance of I or I-uni below K = 8. At K = 8 both park a few
    # words in local memory; their test-free loop reads one of them every
    # 3 rows (I-uni) or four (I), the checked loops more (PERF.md §6 has
    # what it costs); that spill may not grow past I_SPILL_K8.
    # Printed: their registers and spills, and the blocks an SM of the
    # instance a forced run launches.
    i_main = {}
    for name in ("heat_i_tile_temporal", "heat_i_uni_tile_temporal"):
        rows = ptxas[name]
        below = {i: row for i, row in rows.items() if int(i) < 8}
        check(len(below) == 7 and all(row[1] == 0 and row[2] == 0
                                      for row in below.values()),
              f"an instance of {name} below K = 8 spills or is missing: "
              f"{rows}")
        deep = rows.get("8")
        check(deep is not None and deep[1] <= I_SPILL_K8[name][0]
              and deep[2] <= I_SPILL_K8[name][1],
              f"{name}<8> spills more than {I_SPILL_K8[name]} bytes "
              f"(stores, loads) or is missing: {deep}")
        inst = f"{hp.i_k_default}"
        check(inst in rows, f"{name}<{inst}> missing from the ptxas report")
        i_main[name] = {"instance": inst, "registers": rows[inst][0],
                        "spill_stores": rows[inst][1],
                        "spilling": [i for i, row in rows.items() if row[1]],
                        "warps": hp.i_warps, "rows": hp.i_rows,
                        "stages": hp.i_stages,
                        "blocks_per_sm": sk.i_occupancy(name,
                                                        hp.i_k_default)}
    # I's and I-uni's precision forms, a library each (<K, form>), held to
    # their float32 siblings' gate: no spill below K = 8, at K = 8 no more
    # than I_SPILL_K8. Printed: their registers and spills, and the blocks
    # an SM of each form's instance at the pinned runs' depth.
    i_bf16 = {}
    for name in ("heat_i_tile_temporal", "heat_i_uni_tile_temporal"):
        rows = ptxas[name + "_bf16"]
        deep = I_SPILL_K8[name]
        check(len(rows) == 4 * hp.i_k_max and all(
            (row[1] == 0 and row[2] == 0) if int(inst.split(",")[0]) < 8
            else (row[1] <= deep[0] and row[2] <= deep[1])
            for inst, row in rows.items()),
              f"an instance of {name}_bf16 spills past its float32 "
              f"sibling's gate ({deep} bytes at K = 8, none below) or is "
              f"missing: {rows}")
        i_bf16[name + "_bf16"] = {
            "instances": rows,
            "spilling": [i for i, row in rows.items() if row[1]],
            "blocks_per_sm": {form: sk.i_occupancy(name, hp.i_k_default,
                                                   form=form)
                              for form in range(4)}}
    # D's and F's bfloat16 forms: no instance may spill more (stores or
    # loads) than its float32 twin of the same K, rows and load.
    d_rows = ptxas["heat_d_step3d"]
    twins = {"heat_d_step3d_bf16_kernel": (
        d_rows.get("heat_d_step3d_bf16_kernel"),
        d_rows.get("heat_d_step3d_kernel"))}
    f_bf16 = ptxas["heat_f_temporal3d_bf16"]
    for inst, row in f_bf16.items():
        twins[f"heat_f_temporal3d_bf16_kernel<{inst}>"] = (
            row, ptxas["heat_f_temporal3d"].get(inst))
    check(len(f_bf16) == 3 * 2 * hp.f_k_compiled and all(
        mine is not None and twin is not None and mine[1] <= twin[1]
        and mine[2] <= twin[2] for mine, twin in twins.values()),
          f"a bfloat16 instance of D or F spills more than its float32 twin "
          f"or is missing: {twins}")
    # The sharded 2D kernels' bfloat16 forms (one instance each, the band
    # one a load): none may spill more than its float32 twin; their
    # registers, and the main path's bulk's blocks an SM.
    g_twins = {}
    for name in ("heat_g_block_padded", "heat_g_block_circular",
                 "heat_g_block_fused", "heat_g_block_uniform"):
        rows = ptxas[name]
        g_twins[name + "_bf16_kernel"] = (rows.get(name + "_bf16_kernel"),
                                          rows.get(name + "_kernel"))
    for load in (0, 1):
        g_twins[f"heat_g_band_fix_bf16_kernel<{load}>"] = (
            band.get(f"heat_g_band_fix_bf16_kernel<{load}>"),
            band.get(f"heat_g_band_fix_kernel<{load}>"))
    check(all(mine is not None and twin is not None and mine[1] <= twin[1]
              and mine[2] <= twin[2] for mine, twin in g_twins.values()),
          f"a bfloat16 instance of the G family spills more than its "
          f"float32 twin or is missing: {g_twins}")
    # The sharded 3D kernels' bfloat16 forms (a library each, <K, rows>,
    # the band's <K, rows, load>): none may spill more than its float32
    # twin (H-fused's of the cp.async load), nor H-fused's main-path
    # instance at all; their registers, and the blocks an SM of H-fused's
    # and H's main-path instances.
    h_twins = {}
    for name, suffix in (("heat_h_block_3d", ""),
                         ("heat_h_block_3d_fused", ", false"),
                         ("heat_h_band_fix_3d", "")):
        for inst, row in ptxas[name + "_bf16"].items():
            h_twins[f"{name}_bf16_kernel<{inst}>"] = (
                row, ptxas[name].get(inst + suffix))
    h_fused_main = h_twins.get(f"heat_h_block_3d_fused_bf16_kernel<"
                               f"{hp.h_k_default}, {hp.h_rows}>",
                               (None, None))[0]
    check(len(h_twins) == (3 + 3 + 4) * hp.h_k_compiled
          and h_fused_main is not None and h_fused_main[1] == 0
          and all(mine is not None and twin is not None
                  and mine[1] <= twin[1] and mine[2] <= twin[2]
                  for mine, twin in h_twins.values()),
          f"a bfloat16 instance of the H family spills more than its "
          f"float32 twin, H-fused's main-path one spills, or one is "
          f"missing: {h_twins}")
    h_main_bf16 = {
        "heat_h_block_3d_fused_bf16": {
            "instance": f"{hp.h_k_default}, {hp.h_rows}",
            "registers": h_fused_main[0],
            "blocks_per_sm": skb3.h_fused_occupancy(
                hp.h_k_default, "plain", dtype="bfloat16")},
        "heat_h_block_3d_bf16": {
            "blocks_per_sm": skb3.h_occupancy(hp.h_k_default, "bfloat16")}}
    g_main_bf16 = {
        name: {"registers": g_twins[name + "_kernel"][0][0],
               "blocks_per_sm": sk.loop_occupancy(name, hp.g_k_default,
                                                  hp.g_tile, hp.g_block)}
        for name in ("heat_g_block_uniform_bf16", "heat_g_block_fused_bf16")}
    emit({"phase": "build", "seconds": seconds,
          "source_seconds": dict(build.BUILD_SECONDS),
          "bf16_3d_instances": {inst: {"bf16": mine, "float32": twin}
                                for inst, (mine, twin) in twins.items()},
          "bf16_g_instances": {inst: {"bf16": mine, "float32": twin}
                               for inst, (mine, twin) in g_twins.items()},
          "bf16_h_instances": {inst: {"bf16": mine, "float32": twin}
                               for inst, (mine, twin) in h_twins.items()},
          "main_path_h_bf16": h_main_bf16,
          "main_path_g_bf16": g_main_bf16,
          "a_and_m_instances": resident, "probe_instances": probes,
          "band_instances": band,
          "libraries": {n: os.path.relpath(str(p), ROOT)
                        for n, p in paths.items()},
          "main_path_e": e_main, "main_path_f": f_main,
          "main_path_h_instance": main,
          "main_path_h": {"instance": h_main, "registers": h_row[0],
                          "spill_stores": h_row[1],
                          "blocks_per_sm": skb3.h_occupancy(
                              hp.h_k_default)},
          "h_defer_band": {"instance": band_main, "registers": band_row[0],
                           "spill_stores": band_row[1],
                           "spill_loads": band_row[2],
                           "block": list(band_block), "rows": band_rows,
                           "smem_bytes": hp.f_smem_bytes(
                               hp.h_k_default,
                               *hp.h_band_shape(hp.h_k_default))},
          "main_path_g": g_main, "forced_i": i_main,
          "forced_i_bf16": i_bf16,
          "precision_instances": precision,
          "spilling_instances": spilling, "ptxas": ptxas})


def _launchers(sk):
    """Kernel -> (wrapper, plain version)."""
    return {
        "heat_a_resident": (sk.resident_steps, sk.resident_steps_plain),
        "heat_b_step": (sk.strip_step, sk.strip_step_plain),
        "heat_c_tiled": (sk.tiled_step, sk.tiled_step_plain),
        "heat_e_temporal": (sk.temporal_steps, sk.temporal_steps_plain),
        "heat_e_uni_temporal": (sk.temporal_steps_uni,
                                sk.temporal_steps_uni_plain),
        "heat_i_tile_temporal": (sk.tile_temporal_steps,
                                 sk.tile_temporal_steps_plain),
        "heat_i_uni_tile_temporal": (sk.tile_temporal_steps_uni,
                                     sk.tile_temporal_steps_uni_plain),
    }


def _b_launches(sk, u, k, kw):
    src, dst = u.clone(), u.new_empty(u.shape)
    for _ in range(k):
        rb = sk.strip_step(src, dst, **kw)
        src, dst = dst, src
    return src, rb


def _check_one_step(sk, name, u, kw, err):
    """One-step kernel ``name`` (B or C) against its plain version, and
    C against B."""
    import torch

    launch, plain = _launchers(sk)[name]
    ok, pk, bk = (torch.empty_like(u) for _ in range(3))
    rk = launch(u, ok, **kw)
    rp = plain(u, pk, **kw)
    rb = sk.strip_step(u, bk, **kw)
    torch.cuda.synchronize()
    d = max(float((ok - pk).abs().max()), float((ok - bk).abs().max()))
    err[name] = max(err[name], d)
    where = f"{name} at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}, residual "
          f"{float(rk)} vs {float(rp)}")
    check(torch.equal(ok, bk) and same_float(rk, rb),
          f"{where} != heat_b_step: max diff {d}")
    check(torch.equal(ok[0], u[0]) and torch.equal(ok[-1], u[-1])
          and torch.equal(ok[:, 0], u[:, 0])
          and torch.equal(ok[:, -1], u[:, -1]),
          f"{where} moved the Dirichlet boundary")


def _check_multi(sk, name, u, k, kw, err):
    """K-step kernel ``name`` (A, E, E-uni, I or I-uni) at depth ``k``
    against k launches of B and its plain version, with and without the
    residual."""
    import torch

    launch, plain = _launchers(sk)[name]
    ok = torch.empty_like(u)
    rk = launch(u, ok, k, True, **kw)
    nores = torch.empty_like(u)
    launch(u, nores, k, False, **kw)
    src, rb = _b_launches(sk, u, k, kw)
    pk = torch.empty_like(u)
    rp = plain(u, pk, k, True, **kw)
    torch.cuda.synchronize()
    d = max(float((ok - pk).abs().max()), float((ok - src).abs().max()))
    err[name] = max(err[name], d)
    where = f"{name}(K={k}) at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, src) and same_float(rk, rb),
          f"{where} != {k} launches of heat_b_step: max diff {d}")
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}")
    check(torch.equal(ok, nores), f"{where}: grid depends on with_residual")


def _check_e_pair(sk, u, k, kw, err):
    """E and, where the width allows it, E-uni at depth ``k``: each
    against k launches of B and its plain version, with and without the
    residual, and against each other, grid and residual."""
    import torch

    _check_multi(sk, "heat_e_temporal", u, k, kw, err)
    if u.shape[1] % 4:
        return
    _check_multi(sk, "heat_e_uni_temporal", u, k, kw, err)
    want, got = torch.empty_like(u), torch.full_like(u, float("nan"))
    rw = sk.temporal_steps(u, want, k, True, **kw)
    r = sk.temporal_steps_uni(u, got, k, True, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and same_float(r, rw),
          f"heat_e_uni_temporal(K={k}) at {tuple(u.shape)} {kw} != "
          f"heat_e_temporal")


def _check_i(sk, u, k, kw, err):
    """I and, where the width allows it, I-uni at depth ``k``: each
    against k launches of B and its plain version, with and without the
    residual, and against E(k), grid and residual."""
    import torch

    want = torch.empty_like(u)
    rw = sk.temporal_steps(u, want, k, True, **kw)
    for name, launch in (("heat_i_tile_temporal", sk.tile_temporal_steps),
                         ("heat_i_uni_tile_temporal",
                          sk.tile_temporal_steps_uni)):
        if "uni" in name and u.shape[1] % 4:
            continue
        _check_multi(sk, name, u, k, kw, err)
        got = torch.full_like(u, float("nan"))
        r = launch(u, got, k, True, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and same_float(r, rw),
              f"{name}(K={k}) at {tuple(u.shape)} {kw} != heat_e_temporal")


def phase_kernels(dev):
    """Kernels against their plain versions; returns max |diff| each."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params

    k_default = params().e_k_default
    rng = np.random.default_rng(0)
    err = {name: 0.0 for name in KERNELS_2D}
    equal = dict(cx=CX, cy=CY)
    unequal = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    e_ks = sorted({1, 3, k_default})
    every_k = list(range(1, params().e_k_max() + 1))
    # (shape, coefficient pairs, one-step?, depths of E, E-uni, I and
    # I-uni, depths of A)
    plan = [
        ((4096, 4096), [equal], True, e_ks, []),
        ((1001, 999), [equal, unequal], True, e_ks, [1, 5, WINDOW]),
        ((CONV, CONV), [equal, unequal], True, sorted({4, k_default}),
         [1, 4, 7, WINDOW]),
        ((A_LARGEST, A_LARGEST), [equal], False, [], [WINDOW]),
        ((107, 210), [equal, unequal], False, [], [1, 7, WINDOW]),
        ((20, 24), [equal, unequal], False, [], [1, 3, 4, 5, 8, 9, WINDOW]),
        ((4099, 7), [equal], False, [], [1, 9, WINDOW]),
        ((BIG, BIG), [equal], True, [k_default], []),
    ]
    report = []
    for shape, coeffs, one_step, ks, a_ks in plan:
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        temporal = [name for name in TEMPORAL
                    if "uni" not in name or params().uni_fits(shape)]
        for kw in coeffs:
            if one_step:
                for name in ("heat_b_step", "heat_c_tiled"):
                    _check_one_step(sk, name, u, kw, err)
            for k in ks:
                for name in temporal:
                    _check_multi(sk, name, u, k, kw, err)
            for k in a_ks:
                _check_multi(sk, "heat_a_resident", u, k, kw, err)
        report.append({"shape": list(shape), "coeffs": coeffs,
                       "one_step": one_step,
                       "temporal": temporal if ks else [], "k": ks,
                       "a_k": a_ks, "bitwise": True})
        del u
        torch.cuda.empty_cache()
    # A's grids run every branch of its step phase and exchange
    # (hopper_params.a_tile_kinds: tiles inside the interior and past each
    # side, ragged last rows and columns, last groups of 1 to 3 columns,
    # bands written whole); and A at every halo depth at the converge
    # path's 1000^2, at the tile the picker takes for that depth.
    a_kinds = {}
    for shape in [entry[0] for entry in plan if entry[4]]:
        for kind, count in params().a_tile_kinds(shape).items():
            a_kinds[kind] = a_kinds.get(kind, 0) + count
    check(all(a_kinds.values()),
          f"A's check grids run no tile of some kind: {a_kinds}")
    report.append({"a_tile_kinds": a_kinds})
    u = torch.from_numpy(
        (rng.standard_normal((CONV, CONV)) * 10).astype(np.float32)).to(dev)
    a_depths = {}
    for d in range(1, 9):
        tile = params().a_tile((CONV, CONV), d)
        want, got = torch.empty_like(u), torch.full_like(u, float("nan"))
        rp = sk.resident_steps_plain(u, want, WINDOW, True, **unequal)
        xch = torch.empty((2, CONV, CONV), device=dev)
        bits = torch.empty(1, dtype=torch.int32, device=dev)
        sk._launch_a(u, got, WINDOW, xch, bits, *UNEQUAL, d, tile,
                     params().a_block)
        torch.cuda.synchronize()
        check(torch.equal(got, want)
              and same_float(sk._residual_view(bits), rp),
              f"heat_a_resident(K={WINDOW}) at depth {d}, tile {tile} != its "
              f"plain version")
        a_depths[d] = list(tile)
    report.append({"a_depths": a_depths, "k": WINDOW, "bitwise": True})
    del u
    # E and E-uni at every compiled K on grids chosen for the branches of
    # the tile loop and the loads (csrc/heat_temporal.cuh,
    # heat_e_uni_temporal.cu), each grid asserted to run at every K the
    # tile kinds it is there for: (shape, coefficient pairs, kinds).
    edges = ("top", "left", "bottom", "right", "ragged_rows", "ragged_cols",
             "copies")
    whole = ("inside", "interior") + edges
    e_plan = [((1001, 1000), [equal, unequal], whole),
              ((1001, 999), [equal, unequal], whole + ("partial_group",)),
              ((333, 1001), [equal], ("inside", "partial_group")),
              ((250, 1002), [equal], ("inside", "partial_group")),
              ((20, 24), [equal, unequal], edges),
              ((21, 23), [equal, unequal], edges + ("partial_group",))]
    for shape, coeffs, need in e_plan:
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        kinds = {}
        for k in every_k:
            kinds[k] = params().e_tile_kinds(shape, k)
            check(all(kinds[k][kind] for kind in need)
                  and (kinds[k]["tiles"] == 1) == (shape[0] < 96),
                  f"{shape} at K={k} runs no tile of some kind it is there "
                  f"for ({need}): {kinds[k]}")
            for kw in coeffs:
                _check_e_pair(sk, u, k, kw, err)
        report.append({"shape": list(shape), "coeffs": coeffs,
                       "temporal": ["heat_e_temporal"] + (
                           ["heat_e_uni_temporal"]
                           if params().uni_fits(shape) else []),
                       "k": every_k, "tile_kinds": kinds, "bitwise": True})
        del u
    # I and I-uni at every K on grids chosen for the kinds of band and
    # segment of their stream (csrc/heat_i_loop.cuh), and on the main
    # path's 16384^2: each against K launches of B, its plain version and
    # E(K); every K's grids together run every kind
    # (hopper_params.i_band_kinds).
    i_kinds = {}
    for shape, coeffs in I_PLAN:
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        kinds = {}
        for k in range(1, params().i_k_max + 1):
            kinds[k] = params().i_band_kinds(shape, k)
            for kind, count in kinds[k].items():
                i_kinds.setdefault(k, {}).setdefault(kind, 0)
                i_kinds[k][kind] += count
            for kw in coeffs:
                _check_i(sk, u, k, kw, err)
        report.append({"shape": list(shape), "coeffs": coeffs,
                       "temporal": [n for n in TEMPORAL if "_i" in n
                                    and ("uni" not in n
                                         or params().uni_fits(shape))],
                       "k": list(kinds), "band_kinds": kinds,
                       "bitwise": True, "vs_e": True})
        del u
        torch.cuda.empty_cache()
    for k, kinds in i_kinds.items():
        check(all(kinds[kind] for kind in I_BAND_KINDS),
              f"I's check grids at K={k} run no band or segment of some "
              f"kind: {kinds}")
    big = params().i_band_kinds((BIG, BIG), params().i_k_default)
    check(all(big[kind] for kind in ("interior", "first", "last",
                                     "partial", "free_rows", "edge_rows")),
          f"16384^2 runs no band or segment of some kind: {big}")
    report.append({"i_band_kinds": i_kinds})
    # A diverging grid: one NaN in the interior.
    u = torch.from_numpy(
        (rng.standard_normal((515, 776)) * 10).astype(np.float32)).to(dev)
    u[200, 300] = float("nan")
    nan_res = {}
    for name, (launch, _) in _launchers(sk).items():
        o = torch.empty_like(u)
        if name in ("heat_b_step", "heat_c_tiled"):
            r = launch(u, o, **equal)
        else:
            r = launch(u, o, k_default, True, **equal)
        nan_res[name] = float(r)
        check(math.isnan(nan_res[name]),
              f"NaN-seeded grid gave {name} residual {nan_res[name]}, "
              f"not NaN")
        check(torch.equal(o[0], u[0]) and torch.equal(o[:, -1], u[:, -1]),
              f"a diverging grid moved the Dirichlet boundary ({name})")
    emit({"phase": "kernels", "ok": True, "checks": report,
          "nan_residual": nan_res, "max_abs_err": err})
    return err


def _reference_f64(nx, ny, steps):
    """Independent float64 NumPy reference of the update rule."""
    ix = np.arange(nx, dtype=np.float64)[:, None]
    iy = np.arange(ny, dtype=np.float64)[None, :]
    u = ix * (nx - ix - 1) * iy * (ny - iy - 1)
    for _ in range(steps):
        c = u[1:-1, 1:-1]
        v = u.copy()
        v[1:-1, 1:-1] = (c + CX * (u[2:, 1:-1] + u[:-2, 1:-1] - 2 * c)
                         + CY * (u[1:-1, 2:] + u[1:-1, :-2] - 2 * c))
        u = v
    return u


def _profiled(fn, pad_s=None):
    """Run ``fn()`` once under torch.profiler, recording the card only,
    with ``pad_s`` seconds (``bench_kernels.TRACE_PAD_S`` by default) of
    idle host inside the trace on each side of the call, which lets the
    records arrive. Returns the wall seconds of the call and, by event
    name (kernels, memsets, copies), the device milliseconds and the
    number of records."""
    import torch
    from parallel_heat_tpu_torch.bench_kernels import TRACE_PAD_S, card_trace

    with card_trace(TRACE_PAD_S if pad_s is None else pad_s) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.key_averages():
        ms, n = per.get(e.key, (0.0, 0))
        per[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return wall, per


def _device_ms(launch, name, made=40):
    """``{"device_ms", "profiler_records", "profiled_launches"}``: the
    mean device milliseconds of one launch of kernel ``name``, from a
    trace of ``made`` back-to-back calls of ``launch()``, over the
    records the trace holds. A trace may lose records (none kept, or a
    few, or most, now and then: ``bench_kernels.TRACE_PAD_S``), so a sum
    over the launches made would read low. A trace that kept fewer than
    70% of them is taken again with twice the launches and four times the
    wait, twice at most, and then refused: the mean of so few could read
    anything."""
    from parallel_heat_tpu_torch.bench_kernels import TRACE_PAD_S

    for attempt in range(3):
        calls = made * 2 ** attempt
        _, per = _profiled(lambda: [launch() for _ in range(calls)],
                           TRACE_PAD_S * 4 ** attempt)
        hits = [v for key, v in per.items()
                if re.search(rf"(^|\W){name}_kernel\b", key)]
        records = sum(n for _, n in hits)
        if calls * 0.7 <= records <= calls:
            return {"device_ms": sum(ms for ms, _ in hits) / records,
                    "profiler_records": records, "profiled_launches": calls}
    raise SmokeFailure(f"the profiler kept {records} records of {calls} "
                       f"launches of {name}, three times over")


def _device_busy_ms(prof):
    """The card's busy milliseconds in a trace: the summed durations of
    its device records (kernels, copies, memsets), read from the
    profiler's raw records; its event tables (``key_averages``) take
    seconds to build for a trace of 10^5 records, as an eager sharded
    converge run makes."""
    from torch._C._autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6


def _busy(solve_once, label):
    """The card's busy share of one profiled run of ``solve_once`` (a
    call of ``solve()``): the trace spans the solver's clock alone, so a
    run's warm-up and graph capture stay out of it as they stay out of
    ``elapsed_s``, which is the wall time."""
    from parallel_heat_tpu_torch import solver
    from parallel_heat_tpu_torch.bench_kernels import TRACE_PAD_S, card_trace

    traces, clock = [], solver.Timer

    class Traced(clock):
        def __enter__(self):
            self.trace = card_trace(TRACE_PAD_S)
            traces.append(self.trace.__enter__())
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            self.trace.__exit__(*exc)
            return False

    solver.Timer = Traced
    try:
        res = solve_once()
    finally:
        solver.Timer = clock
    check(len(traces) == 1, f"{label}: {len(traces)} clocks in one solve")
    busy_ms = _device_busy_ms(traces[0])
    check(busy_ms > 0, f"{label}: the profiler saw no device time")
    return {"wall_s": res.elapsed_s, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / 1e3 / res.elapsed_s}


def _run_counted(cfg, kernel, default, label):
    """solve() under ``kernel``: the default pick (which must be
    ``kernel``) or the kernel's forced choice. The counts are set to 0
    just before and read just after; the run's kernel must have launched,
    and no other kernel or plain version."""
    from parallel_heat_tpu_torch import solve, tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    site = "single_3d" if kernel in KERNELS_3D else "single_2d"
    sk.reset_counts()
    if default:
        res = solve(cfg)
    else:
        with tune.force(site, KERNELS[kernel][0]):
            res = solve(cfg)
    counts = dict(sk.counts)
    check(counts[kernel] > 0, f"{label}: {kernel} was never launched")
    for name, n in counts.items():
        check(name == kernel or n == 0,
              f"{label}: {name} ran {n} times off the path of {kernel}")
    return res, counts


def phase_main_path():
    """16384^2 under E-uni (the default pick) and every other kernel but
    A (the grid is far too large for it); returns each kernel's launches
    in its run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=BIG, ny=BIG, steps=MAIN_STEPS)
    cells = BIG * BIG * MAIN_STEPS / 1e6
    runs, out = {}, {}
    for kernel in ("heat_e_uni_temporal", "heat_e_temporal",
                   "heat_i_tile_temporal", "heat_i_uni_tile_temporal",
                   "heat_b_step", "heat_c_tiled"):
        res, counts = _run_counted(cfg, kernel,
                                   kernel == "heat_e_uni_temporal",
                                   f"16384^2 {kernel}")
        check(res.steps_run == MAIN_STEPS, f"steps_run {res.steps_run}")
        if not runs:
            check(tuple(res.grid.shape) == (BIG, BIG), "wrong grid shape")
            check(bool(torch.isfinite(res.grid).all()), "non-finite grid")
            first = res.grid
        else:
            check(torch.equal(res.grid, first),
                  f"16384^2 grids differ, {kernel} vs the default pick")
        runs[kernel] = counts[kernel]
        out[kernel] = {"elapsed_s": res.elapsed_s,
                       "mcells_steps_per_s": cells / res.elapsed_s,
                       "launches": counts[kernel]}
        del res
    del first
    torch.cuda.empty_cache()
    # A small input against an independent float64 reference (the
    # factored combine drifts ~1e-5 relative in 300 steps; the JAX
    # package holds its own kernels to rtol 1e-4 there).
    small = HeatConfig(nx=256, ny=256, steps=300)
    want = _reference_f64(256, 256, 300)
    cpu = solve(small.replace(backend="cuda"), device="cpu").to_numpy()
    small_ok = {}
    for kernel in KERNELS_2D:
        label = f"256^2 {kernel}"
        res, _ = _run_counted(small, kernel, kernel == "heat_a_resident",
                              label)
        got = res.to_numpy().astype(np.float64)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1)))
        check(np.allclose(got, want, rtol=1e-4, atol=1e-3),
              f"{label} off the float64 reference: {rel}")
        check(np.array_equal(res.to_numpy(), cpu),
              f"{label} differs from the CPU's plain versions")
        small_ok[kernel] = {"max_rel_err_vs_f64": rel,
                            "bitwise_vs_cpu_plain": True}
    busy = _busy(lambda: solve(cfg), "16384^2 profiled")
    emit({"phase": "main_path", "ok": True, "shape": [BIG, BIG],
          "steps": MAIN_STEPS, "runs": out, "bitwise_across_kernels": True,
          "profiled_default": busy, "small_256": small_ok})
    return runs


def phase_converge():
    """1000^2 to eps under A (the default pick) and the other kernels; and
    20^2, which converges, under each against the CPU's plain versions.
    Returns A's launches in the default 1000^2 run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=CONV, ny=CONV, steps=10000, converge=True,
                     check_interval=WINDOW, eps=1e-3)
    runs, out = {}, {}
    for kernel in KERNELS_2D:
        r, c = _run_counted(cfg, kernel, kernel == "heat_a_resident",
                            f"converge {kernel}")
        runs[kernel] = r
        out[kernel] = {"steps_run": r.steps_run, "converged": r.converged,
                       "residual": r.residual, "elapsed_s": r.elapsed_s,
                       "mcells_steps_per_s":
                       CONV * CONV * r.steps_run / r.elapsed_s / 1e6,
                       "launches": c[kernel]}
    r_a = runs["heat_a_resident"]
    for kernel, r in runs.items():
        check(r.steps_run == r_a.steps_run and r.converged == r_a.converged
              and same_float(r.residual, r_a.residual),
              f"converge {kernel} vs heat_a_resident disagree: {out}")
        check(torch.equal(r.grid, r_a.grid),
              f"converge grids differ, {kernel} vs heat_a_resident")
    check(math.isfinite(r_a.residual), "converge residual not finite")
    check(r_a.steps_run == 10000 and not r_a.converged,
          f"1000^2 converge ran {r_a.steps_run} steps (10000 expected)")
    busy = _busy(lambda: solve(cfg), "1000^2 converge profiled")
    # The same grid in fixed mode: A runs all 10000 steps in one launch.
    fixed = cfg.replace(converge=False)
    fixed_out = {}
    for kernel in ("heat_a_resident", "heat_e_uni_temporal"):
        r, c = _run_counted(fixed, kernel, kernel == "heat_a_resident",
                            f"1000^2 fixed {kernel}")
        check(torch.equal(r.grid, r_a.grid),
              f"1000^2 fixed {kernel} differs from the converge run")
        fixed_out[kernel] = {"elapsed_s": r.elapsed_s,
                             "mcells_steps_per_s":
                             CONV * CONV * 10000 / r.elapsed_s / 1e6,
                             "launches": c[kernel]}
    # A run that leaves the loop through res < eps.
    small = HeatConfig(nx=20, ny=20, steps=10000, converge=True,
                       check_interval=WINDOW, eps=1e-3)
    cpu = solve(small.replace(backend="cuda"), device="cpu")
    check(cpu.converged and cpu.steps_run == 1980,
          f"20^2 on the CPU: {cpu.steps_run} steps, converged "
          f"{cpu.converged} (1980, True expected)")
    small_out = {}
    for kernel in KERNELS_2D:
        r, _ = _run_counted(small, kernel, False, f"20^2 converge {kernel}")
        check((r.steps_run, r.converged) == (cpu.steps_run, cpu.converged)
              and same_float(r.residual, cpu.residual)
              and np.array_equal(r.to_numpy(), cpu.to_numpy()),
              f"20^2 converge under {kernel}: {r.steps_run} steps, "
              f"converged {r.converged}, residual {r.residual}; the CPU: "
              f"{cpu.steps_run}, {cpu.converged}, {cpu.residual}")
        small_out[kernel] = {"steps_run": r.steps_run,
                             "converged": r.converged,
                             "residual": r.residual}
    emit({"phase": "converge", "ok": True, "shape": [CONV, CONV], **out,
          "profiled_default": busy, "fixed_10000": fixed_out,
          "converges_20": small_out})
    return out["heat_a_resident"]["launches"]


# ---------------------------------------------------------------------------
# 3D: kernels D and F
# ---------------------------------------------------------------------------

def _d_launches(sk3, u, k, kw):
    src, dst = u.clone(), u.new_empty(u.shape)
    for _ in range(k):
        rd = sk3.slab_step_3d(src, dst, **kw)
        src, dst = dst, src
    return src, rd


def _faces_intact(out, u):
    import torch

    return all(torch.equal(out[sl], u[sl])
               for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                          np.s_[:, :, 0], np.s_[:, :, -1]))


def _check_d(sk3, u, kw, err):
    """Kernel D against its plain version."""
    import torch

    ok, pk = torch.empty_like(u), torch.empty_like(u)
    rk = sk3.slab_step_3d(u, ok, **kw)
    rp = sk3.slab_step_3d_plain(u, pk, **kw)
    torch.cuda.synchronize()
    d = float((ok - pk).abs().max())
    err["heat_d_step3d"] = max(err["heat_d_step3d"], d)
    where = f"heat_d_step3d at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}, residual "
          f"{float(rk)} vs {float(rp)}")
    check(_faces_intact(ok, u), f"{where} moved a Dirichlet face")


def _check_f(sk3, u, k, kw, err, load, plain=True):
    """Kernel F at depth ``k`` under ``load`` (at the launch shape
    ``hopper_params.f_shape`` gives ``k``) against k launches of D and
    (with ``plain``) its plain version, with and without the residual."""
    import torch

    from parallel_heat_tpu_torch.ops.hopper_params import params

    ok, nores = torch.empty_like(u), torch.empty_like(u)
    rk = sk3.xslab_steps_3d(u, ok, k, True, load=load, **kw)
    sk3.xslab_steps_3d(u, nores, k, False, load=load, **kw)
    src, rd = _d_launches(sk3, u, k, kw)
    torch.cuda.synchronize()
    d = float((ok - src).abs().max())
    where = (f"heat_f_temporal3d(K={k}, {load}, {params().f_shape(k)}) at "
             f"{tuple(u.shape)} {kw}")
    check(torch.equal(ok, src) and same_float(rk, rd),
          f"{where} != {k} launches of heat_d_step3d: max diff {d}, "
          f"residual {float(rk)} vs {float(rd)}")
    check(torch.equal(ok, nores), f"{where}: grid depends on with_residual")
    del nores, src
    if plain:
        pk = torch.empty_like(u)
        rp = sk3.xslab_steps_3d_plain(u, pk, k, True, **kw)
        torch.cuda.synchronize()
        d = max(d, float((ok - pk).abs().max()))
        check(torch.equal(ok, pk) and same_float(rk, rp),
              f"{where} != its plain version: max diff {d}")
    err["heat_f_temporal3d"] = max(err["heat_f_temporal3d"], d)


# F's launch shapes for the shape rule's check on the card, (lanes,
# warps), rows, K: legal and not (csrc/heat_temporal3d.cuh heat_f_takes
# against hopper_params.f_takes).
F_SHAPE_RULE = [((32, 16), 2, 3), ((32, 8), 4, 3), ((32, 16), 1, 7),
                ((32, 1), 4, 1), ((32, 16), 4, 3), ((32, 17), 2, 3),
                ((64, 8), 2, 3), ((32, 8), 3, 3), ((32, 4), 1, 2),
                ((32, 2), 2, 2), ((32, 8), 4, 9), ((32, 8), 4, 0)]


def phase_kernels_3d(dev):
    """D and F against their plain versions and F(K) against K launches
    of D, F at every compiled K under each load its grid takes, on grids
    that run every tile kind they are there for; returns max |diff|
    each."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    every_k = list(range(1, p.f_k_compiled + 1))
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {name: 0.0 for name in KERNELS_3D}
    equal = dict(cx=CX, cy=CY, cz=CX)
    unequal = dict(zip(("cx", "cy", "cz"), UNEQUAL_3D))
    sides = ("edge", "top", "left", "bottom", "right", "ragged_z")
    # (shape, coefficients, depths, tile kinds asserted at every depth)
    plan = [((CUBE, CUBE, CUBE), [equal], every_k, ("interior",) + sides),
            ((67, 130, 204), [equal, unequal], every_k, sides),
            ((67, 130, 201), [equal, unequal], every_k,
             sides + ("partial_group",)),
            ((5, 3, 300), [equal, unequal], [1, 3, p.f_k_max()], sides)]
    report = []
    for shape, coeffs, ks, need in plan:
        u = torch.randn(shape, generator=gen, device=dev) * 10
        loads = [sk3.f_load(shape, u)] + (["cp.async"] if sk3.f_load(
            shape, u) == "tma" else [])
        kinds = {}
        for k in ks:
            block, rows, _ = p.f_shape(k)
            kinds[k] = p.f_tile_kinds(shape, k, block, rows)
            check(all(kinds[k][kind] for kind in need),
                  f"{shape} at K={k} runs no tile of some kind it is there "
                  f"for ({need}): {kinds[k]}")
        for kw in coeffs:
            _check_d(sk3, u, kw, err)
            for k in ks:
                for load in loads:
                    _check_f(sk3, u, k, kw, err, load)
        report.append({"shape": list(shape), "coeffs": coeffs, "k": ks,
                       "loads": loads, "tile_kinds": kinds,
                       "shapes": {k: p.f_shape(k) for k in ks},
                       "bitwise": True})
        del u
        torch.cuda.empty_cache()
    # The launch shapes the C launcher takes are hopper_params.f_takes'.
    u = torch.randn((8, 40, 44), generator=gen, device=dev)
    o = torch.empty_like(u)
    for block, rows, k in F_SHAPE_RULE:
        try:
            sk3._launch_f(u, o, k, None, CX, CY, CX, block, rows, 8,
                          "cp.async", 2)
            taken = True
        except RuntimeError:
            taken = False
        check(taken == p.f_takes(block, rows, k),
              f"F's launcher {'took' if taken else 'refused'} {block} x "
              f"{rows} rows at K={k}; f_takes says {p.f_takes(block, rows, k)}")
    torch.cuda.synchronize()
    report.append({"shape_rule": F_SHAPE_RULE, "agrees": True})
    # A diverging grid: one NaN in the interior.
    u = torch.randn((60, 70, 92), generator=gen, device=dev) * 10
    u[30, 30, 30] = float("nan")
    nan_res = {}
    for name, launch in (
            ("heat_d_step3d", lambda o: sk3.slab_step_3d(u, o, **equal)),
            ("heat_f_temporal3d", lambda o: sk3.xslab_steps_3d(
                u, o, p.f_k_default, True, **equal)),
            ("heat_f_temporal3d cp.async", lambda o: sk3.xslab_steps_3d(
                u, o, p.f_k_default, True, load="cp.async", **equal))):
        o = torch.empty_like(u)
        nan_res[name] = float(launch(o))
        check(math.isnan(nan_res[name]),
              f"NaN-seeded grid gave {name} residual {nan_res[name]}, "
              f"not NaN")
        check(_faces_intact(o, u),
              f"a diverging grid moved a Dirichlet face ({name})")
    del u
    # Past 2^31 cells: F(K_default) against K_default launches of D under
    # each load (four grids of 8.7 GB; no plain version, for memory).
    for big in PAST_2_31:
        u = torch.randn(big, generator=gen, device=dev)
        loads = [sk3.f_load(big, u)] + (["cp.async"] if sk3.f_load(
            big, u) == "tma" else [])
        for load in loads:
            _check_f(sk3, u, p.f_k_default, equal, err, load, plain=False)
        report.append({"shape": list(big), "cells": math.prod(big),
                       "k": [p.f_k_default], "loads": loads,
                       "against": "heat_d_step3d launches", "bitwise": True})
        del u
        torch.cuda.empty_cache()
    emit({"phase": "kernels_3d", "ok": True, "checks": report,
          "nan_residual": nan_res, "max_abs_err": err})
    return err


def _reference_f64_3d(n, steps):
    """Independent float64 NumPy reference of the 7-point rule."""
    ix = np.arange(n, dtype=np.float64)
    f = ix * (n - ix - 1)
    u = f[:, None, None] * f[None, :, None] * f[None, None, :]
    for _ in range(steps):
        c = u[1:-1, 1:-1, 1:-1]
        v = u.copy()
        v[1:-1, 1:-1, 1:-1] = (
            c + CX * (u[2:, 1:-1, 1:-1] + u[:-2, 1:-1, 1:-1] - 2 * c)
            + CY * (u[1:-1, 2:, 1:-1] + u[1:-1, :-2, 1:-1] - 2 * c)
            + CX * (u[1:-1, 1:-1, 2:] + u[1:-1, 1:-1, :-2] - 2 * c))
        u = v
    return u


def phase_main_path_3d():
    """512^3 under F (the default pick) and forced D; 64^3 under each
    against the CPU and a float64 reference. Returns each kernel's
    launches in its 512^3 run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=CUBE, ny=CUBE, nz=CUBE, steps=MAIN_STEPS)
    cells = CUBE ** 3 * MAIN_STEPS / 1e6
    runs, out = {}, {}
    for kernel in KERNELS_3D:
        res, counts = _run_counted(cfg, kernel,
                                   kernel == "heat_f_temporal3d",
                                   f"512^3 {kernel}")
        check(res.steps_run == MAIN_STEPS, f"steps_run {res.steps_run}")
        if not runs:
            check(tuple(res.grid.shape) == (CUBE,) * 3, "wrong grid shape")
            check(bool(torch.isfinite(res.grid).all()), "non-finite grid")
            first = res.grid
        else:
            check(torch.equal(res.grid, first),
                  f"512^3 grids differ, {kernel} vs the default pick")
        runs[kernel] = counts[kernel]
        out[kernel] = {"elapsed_s": res.elapsed_s,
                       "mcells_steps_per_s": cells / res.elapsed_s,
                       "launches": counts[kernel]}
        del res
    del first
    torch.cuda.empty_cache()
    # 64^3 against the CPU's plain versions (bitwise) and a float64
    # reference (few-ulp: rtol 1e-4, the JAX package's own contract for
    # its 3D kernels; atol scaled to the grid, whose values reach 1e10).
    small = HeatConfig(nx=64, ny=64, nz=64, steps=100)
    want = _reference_f64_3d(64, 100)
    cpu = solve(small.replace(backend="cuda"), device="cpu").to_numpy()
    atol = 1e-6 * float(np.abs(want).max())
    small_ok = {}
    for kernel in KERNELS_3D:
        label = f"64^3 {kernel}"
        res, _ = _run_counted(small, kernel, kernel == "heat_f_temporal3d",
                              label)
        got = res.to_numpy().astype(np.float64)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1)))
        check(np.allclose(got, want, rtol=1e-4, atol=atol),
              f"{label} off the float64 reference: {rel}")
        check(np.array_equal(res.to_numpy(), cpu),
              f"{label} differs from the CPU's plain versions")
        small_ok[kernel] = {"max_rel_err_vs_f64": rel,
                            "bitwise_vs_cpu_plain": True}
    busy = _busy(lambda: solve(cfg), "512^3 profiled")
    emit({"phase": "main_path_3d", "ok": True, "shape": [CUBE] * 3,
          "steps": MAIN_STEPS, "runs": out, "bitwise_across_kernels": True,
          "profiled_default": busy, "small_64": small_ok})
    return runs


def phase_converge_3d():
    """10^3 to eps=1e-3 (converges at step 360 on the CPU) under F and D,
    each equal to the CPU's plain run."""
    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=10, ny=10, nz=10, steps=5000, converge=True,
                     check_interval=WINDOW, eps=1e-3)
    cpu = solve(cfg.replace(backend="cuda"), device="cpu")
    check(cpu.converged and cpu.steps_run == 360,
          f"10^3 on the CPU: {cpu.steps_run} steps, converged "
          f"{cpu.converged} (360, True expected)")
    out = {}
    for kernel in KERNELS_3D:
        r, c = _run_counted(cfg, kernel, kernel == "heat_f_temporal3d",
                            f"10^3 converge {kernel}")
        check((r.steps_run, r.converged) == (cpu.steps_run, cpu.converged)
              and same_float(r.residual, cpu.residual)
              and np.array_equal(r.to_numpy(), cpu.to_numpy()),
              f"10^3 converge under {kernel}: {r.steps_run} steps, "
              f"converged {r.converged}, residual {r.residual}; the CPU: "
              f"{cpu.steps_run}, {cpu.converged}, {cpu.residual}")
        out[kernel] = {"steps_run": r.steps_run, "converged": r.converged,
                       "residual": r.residual, "elapsed_s": r.elapsed_s,
                       "launches": c[kernel]}
    emit({"phase": "converge_3d", "ok": True, "shape": [10, 10, 10], **out})


def phase_cli():
    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.utils.io import read_dat, write_dat

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "final.dat")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "256",
               "--ny", "256", "--steps", "500", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        grid = solve(HeatConfig(nx=256, ny=256, steps=500)).to_numpy()
        back = read_dat(path)
        check(back.shape == grid.shape, f"read_dat shape {back.shape}")
        check(np.max(np.abs(back - grid)) <= 0.05 + 1e-6 * np.abs(grid).max(),
              "read_dat does not round-trip the solver's grid")
        ref = os.path.join(tmp, "ref.dat")
        write_dat(ref, grid)
        with open(path, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(), "CLI .dat differs from write_dat")
        path3 = os.path.join(tmp, "final3d.npy")
        cmd3 = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "64",
                "--ny", "64", "--nz", "64", "--steps", "100", "--out", path3]
        proc3 = subprocess.run(cmd3, cwd=ROOT, capture_output=True,
                               text=True, timeout=300)
        check(proc3.returncode == 0,
              f"3D CLI exited {proc3.returncode}: {proc3.stderr[-2000:]}")
        grid3 = solve(HeatConfig(nx=64, ny=64, nz=64, steps=100)).to_numpy()
        check(np.array_equal(np.load(path3), grid3),
              "the 3D CLI's .npy differs from the solver's grid")
    emit({"phase": "cli", "ok": True,
          "stdout": proc.stdout.strip().splitlines(),
          "stdout_3d": proc3.stdout.strip().splitlines()})


def _time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes, ops):
    """The least time the card could take: bytes over HBM's rate or
    float32 operations over its peak, whichever is larger (data sheet,
    ops/hopper_params.py)."""
    from parallel_heat_tpu_torch.ops.hopper_params import params

    card = params()
    t_bytes = nbytes / card.hbm_bytes_per_s * 1e3
    t_ops = ops / card.fp32_flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# The device time of E and E-uni at the main path's 16384^2, K = 8, no
# residual, before the register-blocked tile loop (the column walk, and
# E-uni's cp.async load; NVIDIA H100 80GB HBM3 at 700 W, PERF.md
# section 6).
E_EARLIER_MS = 2.759
E_UNI_EARLIER_MS = 2.522
# ... and of I and I-uni before their band stream moved onto a warp's
# lanes (the column walk, a thread a column; the same card and section).
I_EARLIER_MS = 3.292
I_UNI_EARLIER_MS = 3.183


def phase_timing(dev):
    """ms per launch of each kernel, its plain version and the conv2d
    yardstick, at the shape and depth of the kernel's main-path launch;
    for E and E-uni also their time before the tile loop, and E-uni's
    launch at K = 4, 6 and 8 (the fixed share of a launch, by the K
    ladder)."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate2D
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

    k = params().e_k_default
    kw = dict(cx=CX, cy=CY)
    a0, cx, cy = coeffs_f32(CX, CY)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.tensor([[0.0, cx, 0.0], [cy, a0, cy], [0.0, cx, 0.0]],
                     dtype=torch.float32, device=dev).view(1, 1, 3, 3)
    launchers = _launchers(sk)

    def conv_steps(x, n):
        y = x
        for _ in range(n):
            y = F.conv2d(y, w)
        return y

    rows = {}
    # B, C, E, E-uni, I and I-uni at the main path's 16384^2.
    u = HeatPlate2D(BIG, BIG).init_grid(dev)
    v = torch.empty_like(u)
    x = u.view(1, 1, BIG, BIG)
    interior = (BIG - 2) * (BIG - 2)
    library_1 = _time_ms(lambda: conv_steps(x, 1), 10, 2)
    library_k = _time_ms(lambda: conv_steps(x, k), 3)
    for name in ("heat_b_step", "heat_c_tiled"):
        launch, plain = launchers[name]
        rows[name] = {
            "shape": [BIG, BIG], "k": 1,
            "ms": _time_ms(lambda: launch(u, v, **kw), 20, 3),
            "plain_ms": _time_ms(lambda: plain(u, v, **kw), 3),
            "library_ms": library_1,
            **_bound(8 * BIG * BIG,
                     (OPS_PER_CELL_STEP + OPS_PER_RESIDUAL_CELL) * interior)}
    for name in TEMPORAL:
        launch, plain = launchers[name]
        rows[name] = {
            "shape": [BIG, BIG], "k": k,
            "ms": _time_ms(lambda: launch(u, v, k, False, **kw), 20, 3),
            "plain_ms": _time_ms(lambda: plain(u, v, k, False, **kw), 2),
            "library_ms": library_k,
            **_bound(8 * BIG * BIG, OPS_PER_CELL_STEP * k * interior)}
    del u, v, x
    torch.cuda.empty_cache()
    # A at the converge path's 1000^2, one 20-step window with the
    # residual: its launch on the main path.
    u = HeatPlate2D(CONV, CONV).init_grid(dev)
    v = torch.empty_like(u)
    x = u.view(1, 1, CONV, CONV)
    interior = (CONV - 2) * (CONV - 2)
    rows["heat_a_resident"] = {
        "shape": [CONV, CONV], "k": WINDOW,
        "ms": _time_ms(lambda: sk.resident_steps(u, v, WINDOW, True, **kw),
                       50, 5),
        "plain_ms": _time_ms(
            lambda: sk.resident_steps_plain(u, v, WINDOW, True, **kw), 5, 1),
        "library_ms": _time_ms(lambda: conv_steps(x, WINDOW), 20, 2),
        **_bound(8 * CONV * CONV,
                 (OPS_PER_CELL_STEP * WINDOW + OPS_PER_RESIDUAL_CELL)
                 * interior)}
    # Each kernel's own device time, from the profiler.
    runs = {"heat_a_resident": (CONV, lambda u, v: sk.resident_steps(
        u, v, WINDOW, True, **kw))}
    for name in ("heat_b_step", "heat_c_tiled"):
        runs[name] = (BIG, lambda u, v, f=launchers[name][0]: f(u, v, **kw))
    for name in TEMPORAL:
        runs[name] = (BIG, lambda u, v, f=launchers[name][0]: f(
            u, v, k, False, **kw))
    for name, (size, launch) in runs.items():
        u = HeatPlate2D(size, size).init_grid(dev)
        v = torch.empty_like(u)
        launch(u, v)
        rows[name].update(_device_ms(lambda: launch(u, v), name))
        del u, v
    rows["heat_e_temporal"]["earlier_design_device_ms"] = E_EARLIER_MS
    rows["heat_e_uni_temporal"]["earlier_design_device_ms"] = \
        E_UNI_EARLIER_MS
    rows["heat_i_tile_temporal"]["earlier_design_device_ms"] = I_EARLIER_MS
    rows["heat_i_uni_tile_temporal"]["earlier_design_device_ms"] = \
        I_UNI_EARLIER_MS
    # E-uni's K ladder, its device ms at K = 4, 6, 8: the slope is a step,
    # the intercept the launch's fixed share (its tiles' load and last
    # store, and the launch).
    u = HeatPlate2D(BIG, BIG).init_grid(dev)
    v = torch.empty_like(u)
    ladder = {}
    for kk in (4, 6, 8):
        def run(kk=kk):
            sk.temporal_steps_uni(u, v, kk, False, **kw)
        run()
        ladder[f"k{kk}"] = _device_ms(run, "heat_e_uni_temporal")["device_ms"]
    step, fixed = np.polyfit([4, 6, 8], [ladder[f"k{kk}"]
                                         for kk in (4, 6, 8)], 1)
    ladder.update(step_ms=float(step), fixed_ms=float(fixed))
    rows["heat_e_uni_temporal"]["k_ladder_device_ms"] = ladder
    del u, v
    emit({"phase": "timing", "kernels": rows})
    return rows


# The device time of F at the main path's 512^3, K = 3, no residual,
# before the register-blocked plane loop (NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6).
F_EARLIER_MS = 0.885


def phase_timing_3d(dev):
    """ms per launch of D and F (K_default), their plain versions and the
    conv3d yardstick at the 3D main path's 512^3; for F also its time
    before the plane loop, its device time at K = 1 .. 4 (the K ladder:
    a step, and the launch's fixed share), and under each load at 512^3
    and 512 x 512 x 508."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate3D
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

    p = params()
    k = p.f_k_default
    kw = dict(cx=CX, cy=CY, cz=CX)
    a0, cx, cy, cz = coeffs3_f32(CX, CY, CX)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.zeros((3, 3, 3), dtype=torch.float32, device=dev)
    w[1, 1, 1] = a0
    w[0, 1, 1] = w[2, 1, 1] = cx
    w[1, 0, 1] = w[1, 2, 1] = cy
    w[1, 1, 0] = w[1, 1, 2] = cz
    w = w.view(1, 1, 3, 3, 3)

    def conv_steps(x, n):
        y = x
        for _ in range(n):
            y = F.conv3d(y, w)
        return y

    u = HeatPlate3D(CUBE, CUBE, CUBE).init_grid(dev)
    v = torch.empty_like(u)
    x = u.view(1, 1, CUBE, CUBE, CUBE)
    interior = (CUBE - 2) ** 3
    launch = {
        "heat_d_step3d": (1, lambda: sk3.slab_step_3d(u, v, **kw),
                          lambda: sk3.slab_step_3d_plain(u, v, **kw),
                          (OPS_PER_CELL_STEP_3D + OPS_PER_RESIDUAL_CELL)
                          * interior),
        "heat_f_temporal3d": (k, lambda: sk3.xslab_steps_3d(
            u, v, k, False, **kw), lambda: sk3.xslab_steps_3d_plain(
                u, v, k, False, **kw), OPS_PER_CELL_STEP_3D * k * interior),
    }
    rows = {}
    for name, (steps, kernel, plain, ops) in launch.items():
        rows[name] = {
            "shape": [CUBE] * 3, "k": steps,
            "ms": _time_ms(kernel, 20, 3),
            "plain_ms": _time_ms(plain, 3),
            "library_ms": _time_ms(lambda: conv_steps(x, steps), 5, 1),
            **_bound(8 * CUBE ** 3, ops)}
        rows[name].update(_device_ms(kernel, name))
    f_row = rows["heat_f_temporal3d"]
    f_row["earlier_design_device_ms"] = F_EARLIER_MS
    f_row["load"] = sk3.f_load(u.shape, u)
    # F's K ladder, device ms at K = 1 .. 4: the slope is a step, the
    # intercept the launch's fixed share (its planes' halo and the
    # launch).
    ladder = {}
    ks = [kk for kk in (1, 2, 3, 4) if kk <= p.f_k_max()]
    for kk in ks:
        def run(kk=kk):
            sk3.xslab_steps_3d(u, v, kk, False, **kw)
        run()
        ladder[f"k{kk}"] = _device_ms(run, "heat_f_temporal3d")["device_ms"]
    step, fixed = np.polyfit(ks, [ladder[f"k{kk}"] for kk in ks], 1)
    ladder.update(step_ms=float(step), fixed_ms=float(fixed))
    f_row["k_ladder_device_ms"] = ladder
    del u, v, x
    torch.cuda.empty_cache()
    # F under each load, in turns (TMA, cp.async, cp.async, TMA), at the
    # main path's 512^3 and at 512 x 512 x 508.
    loads = {}
    for shape in ((CUBE, CUBE, CUBE), (CUBE, CUBE, CUBE - 4)):
        u = HeatPlate3D(*shape).init_grid(dev)
        v = torch.empty_like(u)
        times = {"tma": [], "cp.async": []}
        for load in ("tma", "cp.async", "cp.async", "tma"):
            def run(load=load):
                sk3.xslab_steps_3d(u, v, k, False, load=load, **kw)
            run()
            times[load].append(_device_ms(run, "heat_f_temporal3d")
                               ["device_ms"])
        loads["x".join(map(str, shape))] = times
        del u, v
        torch.cuda.empty_cache()
    f_row["loads_device_ms"] = loads
    emit({"phase": "timing_3d", "kernels": rows})
    return rows


# ---------------------------------------------------------------------------
# The ensemble (kernel M) and implicit stepping (restrict, prolong)
# ---------------------------------------------------------------------------

def _rand_on(dev, shape, seed, scale=10.0):
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _check_m(u, k, kw):
    """Kernel M at depth ``k`` on the stack ``u`` against its plain
    version, with and without the residual, and its first, middle and
    last member against kernel A on that member alone. Returns the max
    |diff| against the plain version."""
    import torch

    from parallel_heat_tpu_torch.ops import batched
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    ok, pk, nores = (torch.empty_like(u) for _ in range(3))
    rk = batched.ensemble_steps(u, ok, k, True, **kw)
    rp = batched.ensemble_steps_plain(u, pk, k, True, **kw)
    check(batched.ensemble_steps(u, nores, k, False, **kw) is None,
          "M without the residual returned one")
    torch.cuda.synchronize()
    d = float((ok - pk).abs().max())
    where = f"heat_m_ensemble(K={k}) at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, pk) and torch.equal(rk, rp),
          f"{where} != its plain version: max diff {d}, residuals "
          f"{rk.tolist()} vs {rp.tolist()}")
    check(torch.equal(ok, nores), f"{where}: grid depends on with_residual")
    for b in sorted({0, u.shape[0] // 2, u.shape[0] - 1}):
        one = torch.empty_like(u[b])
        ra = sk.resident_steps(u[b].contiguous(), one, k, True, **kw)
        check(torch.equal(one, ok[b]) and same_float(ra, rk[b]),
              f"{where}: member {b} != heat_a_resident on it alone")
    return d


def phase_kernels_ens(dev):
    """M against its plain version and against A, member by member;
    returns the max |diff|."""
    import torch

    from parallel_heat_tpu_torch.ops import batched
    from parallel_heat_tpu_torch.ops.hopper_params import params

    equal = dict(cx=CX, cy=CY)
    unequal = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    err, report = 0.0, []
    # Members of one block each (107 x 210, 24 x 20, 20^2, and 166^2, the
    # largest) and cooperative tilings (512^2, 167^2, 256^2, 1000^2).
    plan = [(b, (ENS_N, ENS_N)) for b in (1, 3, ENS_B)]
    plan += [(b, shape) for shape in ((107, 210), (24, 20))
             for b in (3, ENS_B)]
    plan += [(8, (20, 20)), (8, (M_SOLO_LARGEST, M_SOLO_LARGEST)),
             (8, (M_SOLO_LARGEST + 1, M_SOLO_LARGEST + 1)), (8, (256, 256))]
    plan.append((3, (CONV, CONV)))
    for batch, shape in plan:
        u = _rand_on(dev, (batch,) + shape, seed=batch + shape[0])
        for kw in (equal, unequal):
            for k in (1, 7, WINDOW):
                err = max(err, _check_m(u, k, kw))
        launch = params().m_plan(batch, shape)
        check((launch["tiles"] == 1) == (shape[0] <= M_SOLO_LARGEST),
              f"M's plan at {shape}: {launch}")
        report.append({"members": batch, "shape": list(shape),
                       "k": [1, 7, WINDOW], "coeffs": [equal, unequal],
                       "tile": list(launch["tile"]),
                       "tiles": launch["tiles"], "groups": launch["groups"],
                       "bitwise": True})
        del u
        torch.cuda.empty_cache()
    # M at each of its halo depths, under the tiling the model ranks
    # first there, on 5 members of 512^2, against the plain version.
    u = _rand_on(dev, (5, ENS_N, ENS_N), seed=11)
    want = torch.empty_like(u)
    rp = batched.ensemble_steps_plain(u, want, 17, True, **unequal)
    for d in params().m_depths:
        tiling = min(params().m_tilings(5, (ENS_N, ENS_N), d),
                     key=lambda t: t["cost"])
        got = torch.full_like(u, float("nan"))
        bits = torch.empty(5, dtype=torch.int32, device=dev)
        batched._launch_m(u, got, 17, batched.exchange_planes(u, 17, tiling),
                          bits, *UNEQUAL, tiling)
        torch.cuda.synchronize()
        check(torch.equal(got, want)
              and torch.equal(bits.view(torch.float32), rp),
              f"heat_m_ensemble(K=17) at depth {d} under {tiling} != its "
              f"plain version")
        report.append({"members": 5, "shape": [ENS_N, ENS_N], "k": [17],
                       "depth": d, "tile": list(tiling["tile"]),
                       "bitwise": True})
    del u, want
    # The fixed main path's one launch: the full stack at K = 400, no
    # residual.
    u = _rand_on(dev, (ENS_B, ENS_N, ENS_N), seed=ENS_STEPS)
    err = max(err, _check_m(u, ENS_STEPS, equal))
    report.append({"members": ENS_B, "shape": [ENS_N, ENS_N],
                   "k": [ENS_STEPS], "coeffs": [equal], "bitwise": True})
    del u
    torch.cuda.empty_cache()
    # One diverging member: only its residual is NaN, and the others'
    # bits are those of the clean run.
    u = _rand_on(dev, (5, ENS_N, ENS_N), seed=5)
    clean, out = torch.empty_like(u), torch.empty_like(u)
    batched.ensemble_steps(u, clean, 7, **equal)
    u[2, ENS_N // 5, ENS_N // 5] = float("nan")
    res = batched.ensemble_steps(u, out, 7, **equal)
    nan = torch.isnan(res).tolist()
    check(nan == [False, False, True, False, False],
          f"a NaN in member 2 gave NaN residuals {nan}")
    check(all(torch.equal(out[b], clean[b]) for b in (0, 1, 3, 4)),
          "a NaN in member 2 changed another member's bits")
    check(torch.equal(out[2, 0], u[2, 0])
          and torch.equal(out[2, :, -1], u[2, :, -1]),
          "a diverging member moved its Dirichlet boundary")
    emit({"phase": "kernels_ens", "ok": True, "checks": report,
          "nan_residuals": [float(r) for r in res], "max_abs_err": err})
    return {"heat_m_ensemble": err}


def _ring_is_zero(t) -> bool:
    return not bool(t[..., 0, :].any() or t[..., -1, :].any()
                    or t[..., :, 0].any() or t[..., :, -1].any())


def _coarse_of(fine):
    return ((fine[0] - 2) // 2 + 2, (fine[1] - 2) // 2 + 2)


def phase_kernels_mg(dev):
    """Restrict and prolong against their plain versions; returns the max
    |diff| each."""
    import torch

    from parallel_heat_tpu_torch.ops import multigrid as mg

    from parallel_heat_tpu_torch.config import multigrid_level_shapes

    err = {"heat_mg_restrict": 0.0, "heat_mg_prolong": 0.0}
    report = []
    path = multigrid_level_shapes((IMP_N, IMP_N))
    pairs = [(fine, _coarse_of(fine)) for fine in MG_FINE]
    on_path = list(zip(path[:-1], path[1:]))
    pairs += on_path
    for fine, coarse in pairs:
        fine, coarse = tuple(fine), tuple(coarse)
        for lead in ((), (3,)):
            if lead and fine[0] * fine[1] > 2_000_000:
                continue
            r = _rand_on(dev, lead + fine, seed=fine[0])
            got = mg.restrict(r, coarse)
            want = mg.restrict_full_weighting(r, coarse)
            c = _rand_on(dev, lead + coarse, seed=fine[1])
            c[..., 0, :] = c[..., -1, :] = 0
            c[..., :, 0] = c[..., :, -1] = 0
            back = mg.prolong(c, fine)
            back_want = mg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2))
            # Every output cell written: each launch into a NaN-filled
            # output must come out bitwise the plain version.
            nan_r = torch.full_like(want, float("nan"))
            nan_p = torch.full_like(back_want, float("nan"))
            mg._launch_transfer(mg.RESTRICT, r, nan_r)
            mg._launch_transfer(mg.PROLONG, c, nan_p)
            torch.cuda.synchronize()
            check(torch.equal(nan_r, want) and torch.equal(nan_p, back_want),
                  f"a transfer kernel left cells of a NaN-filled output "
                  f"unwritten or wrong at {lead + fine} <-> {lead + coarse}")
            err["heat_mg_restrict"] = max(err["heat_mg_restrict"],
                                          float((got - want).abs().max()))
            err["heat_mg_prolong"] = max(
                err["heat_mg_prolong"], float((back - back_want).abs().max()))
            where = f"at {lead + fine} <-> {lead + coarse}"
            check(torch.equal(got, want),
                  f"heat_mg_restrict != its plain version {where}")
            check(torch.equal(back, back_want),
                  f"heat_mg_prolong != its plain version {where}")
            check(_ring_is_zero(got) and _ring_is_zero(back),
                  f"a transfer kernel left a non-zero ring {where}")
            report.append({"fine": list(lead + fine),
                           "coarse": list(lead + coarse),
                           "on_main_path": (fine, coarse) in on_path,
                           "fine_interior_odd": [(fine[0] - 2) % 2 == 1,
                                                 (fine[1] - 2) % 2 == 1],
                           "bitwise": True, "ring_zero": True,
                           "every_cell_written": True})
            del r, c, got, want, back, back_want, nan_r, nan_p
        torch.cuda.empty_cache()
    emit({"phase": "kernels_mg", "ok": True, "checks": report,
          "max_abs_err": err})
    return err


def _only(counts, allowed, label):
    for name, n in counts.items():
        check(name in allowed or n == 0,
              f"{label}: {name} ran {n} times off the path")


def _member_inits(dev, n, scales, base="plate"):
    import torch

    from parallel_heat_tpu_torch.models import HeatPlate2D

    if base == "plate":
        grid = HeatPlate2D(n, n).init_grid(dev)
    else:
        rng = np.random.default_rng(7)
        grid = torch.from_numpy(
            (rng.random((n, n)) * 100).astype(np.float32)).to(dev)
    return torch.stack([grid * s for s in scales])


def _solo_all(cfg, inits):
    """solve() of every member, one after the other: the results and the
    sum of their elapsed times."""
    from parallel_heat_tpu_torch import solve

    runs = [solve(cfg, initial=inits[i]) for i in range(inits.shape[0])]
    return runs, sum(r.elapsed_s for r in runs)


def phase_ensemble(dev):
    """EnsembleSolver at full width, fixed and converge; returns M's
    launches in the 64 x 512^2 fixed run."""
    import torch

    from parallel_heat_tpu_torch import (EnsembleConfig, EnsembleSolver,
                                         HeatConfig)
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    cfg = HeatConfig(nx=ENS_N, ny=ENS_N, steps=ENS_STEPS)
    inits = _member_inits(dev, ENS_N,
                          [1.0 + i / ENS_B for i in range(ENS_B)])
    solo, _ = _solo_all(cfg, inits)
    fixed = {}
    for batch in (1, 8, ENS_B):
        es = EnsembleSolver(cfg, batch)
        check(es.path == "M", f"ensemble path {es.path!r}, not 'M'")
        # The first run of a stack size pays for its buffers' cudaMalloc:
        # the second is the one counted and timed.
        es.solve(initials=inits[:batch])
        sk.reset_counts()
        res = es.solve(initials=inits[:batch])
        counts = dict(sk.counts)
        check(counts["heat_m_ensemble"] == 1,
              f"{batch} x {ENS_N}^2 fixed: {counts['heat_m_ensemble']} "
              f"launches of M, 1 expected")
        _only(counts, {"heat_m_ensemble"}, f"ensemble fixed B={batch}")
        check(tuple(res.grids.shape) == (batch, ENS_N, ENS_N)
              and bool(torch.isfinite(res.grids).all()),
              "ensemble grids: wrong shape or non-finite")
        check(res.steps_run.tolist() == [ENS_STEPS] * batch,
              f"steps_run {res.steps_run.tolist()}")
        for i in range(batch):
            check(torch.equal(res.grids[i], solo[i].grid),
                  f"member {i} of {batch} != its solo solve()")
        solo_s = sum(r.elapsed_s for r in solo[:batch])
        cells = batch * ENS_N * ENS_N * ENS_STEPS / 1e6
        fixed[batch] = {"elapsed_s": res.elapsed_s,
                        "mcells_steps_per_s": cells / res.elapsed_s,
                        "solo_solves_s": solo_s,
                        "solo_mcells_steps_per_s": cells / solo_s,
                        "launches": counts["heat_m_ensemble"]}
        if batch == ENS_B:
            launches = counts["heat_m_ensemble"]
        del res
    del inits, solo
    torch.cuda.empty_cache()
    # Converge mode: per-member verdicts, freeze and compaction.
    ens = EnsembleConfig(members=len(ENS_SCALES))
    conv = {}
    for n, cap, base in ENS_CONV:
        ccfg = HeatConfig(nx=n, ny=n, steps=cap, converge=True,
                          check_interval=WINDOW, eps=1e-3)
        inits = _member_inits(dev, n, ENS_SCALES, base)
        solo, solo_s = _solo_all(ccfg, inits)
        es = EnsembleSolver(ccfg, ens)
        check(es.path == "M", f"ensemble path {es.path!r}, not 'M'")
        # The first run loads PyTorch's own small kernels (where, all,
        # cat, ...), some milliseconds each: the second is the one
        # counted and timed. Each dispatch launches M once per window it
        # holds.
        es.solve(initials=inits)
        steps_seen = [0]
        sk.reset_counts()
        res = es.solve(initials=inits,
                       on_boundary=lambda b: steps_seen.append(b.step))
        counts = dict(sk.counts)
        full = cap // WINDOW * WINDOW
        expect = sum(min(ens.window_rounds, (full - k) // WINDOW)
                     for k in steps_seen[:-1])
        tail = bool(cap % WINDOW) and not bool(res.converged.all())
        check(counts["heat_m_ensemble"] == expect + tail,
              f"{n}^2 converge: {counts['heat_m_ensemble']} launches of M, "
              f"{expect + tail} predicted from the dispatches")
        _only(counts, {"heat_m_ensemble"}, f"ensemble converge {n}^2")
        for i, s in enumerate(solo):
            check(torch.equal(res.grids[i], s.grid)
                  and int(res.steps_run[i]) == s.steps_run
                  and bool(res.converged[i]) == s.converged
                  and same_float(res.residual[i], s.residual),
                  f"{n}^2 converge member {i}: {int(res.steps_run[i])} "
                  f"steps, converged {bool(res.converged[i])}, residual "
                  f"{float(res.residual[i])}; solo: {s.steps_run}, "
                  f"{s.converged}, {s.residual}")
        check(len(res.compactions) >= 1, f"{n}^2 converge never compacted")
        check(len(set(res.steps_run.tolist())) > 2,
              f"{n}^2 members all stopped together")
        conv[f"{n}^2"] = {
            "steps_run": res.steps_run.tolist(),
            "converged": res.converged.tolist(),
            "residual": res.residual.tolist(),
            "compactions": [list(c) for c in res.compactions],
            "dispatches": len(steps_seen) - 1,
            "launches": counts["heat_m_ensemble"],
            "elapsed_s": res.elapsed_s, "solo_solves_s": solo_s}
    emit({"phase": "ensemble", "ok": True, "path": "M",
          "members": ENS_B, "shape": [ENS_N, ENS_N], "steps": ENS_STEPS,
          "fixed": fixed, "converge": conv,
          "members_bitwise_solo": True})
    return {"heat_m_ensemble": launches}


def _linear_system_gap(scheme, u0, new, c):
    """``max|b - A x| / max|b|`` of one implicit step from ``u0`` to
    ``new`` in float64: ``A = I - theta L``; backward Euler has b = u0,
    x = u'; Crank-Nicolson b = 2 u0, x = u' + u0."""
    u0, new = u0.double(), new.double()
    theta, b, x = ((1.0, u0, new) if scheme == "backward_euler"
                   else (0.5, 2.0 * u0, new + u0))
    ci = x[1:-1, 1:-1]
    lap = (c * (x[2:, 1:-1] + x[:-2, 1:-1] - 2 * ci)
           + c * (x[1:-1, 2:] + x[1:-1, :-2] - 2 * ci))
    gap = (b[1:-1, 1:-1] - (ci - theta * lap)).abs().max()
    return float(gap / b[1:-1, 1:-1].abs().max())


def phase_implicit(dev):
    """Implicit solve() at 512^2; returns each transfer kernel's launches
    in the backward-Euler run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.config import multigrid_level_shapes
    from parallel_heat_tpu_torch.ops import multigrid as mg
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    levels = len(multigrid_level_shapes((IMP_N, IMP_N)))
    # Positive random values, the ring included: a moved Dirichlet cell
    # would show.
    u0 = _rand_on(dev, (IMP_N, IMP_N), seed=11).abs() + 1.0
    transfers = {"heat_mg_restrict", "heat_mg_prolong"}
    out, launches = {}, None
    for scheme in ("backward_euler", "crank_nicolson"):
        cfg = HeatConfig(nx=IMP_N, ny=IMP_N, cx=IMP_C, cy=IMP_C,
                         steps=IMP_STEPS, scheme=scheme)
        sk.reset_counts()
        mg.reset_stats()
        res = solve(cfg.replace(backend="cuda"), initial=u0)
        counts, stats = dict(sk.counts), dict(mg.stats)
        label = f"implicit {scheme}"
        check(stats["steps"] == IMP_STEPS == res.steps_run,
              f"{label}: {stats['steps']} steps counted")
        per_cycle = levels - 1
        for name in transfers:
            check(counts[name] == stats["cycles"] * per_cycle > 0,
                  f"{label}: {counts[name]} launches of {name}, "
                  f"{stats['cycles']} cycles x {per_cycle} predicted")
        _only(counts, transfers, label)
        check(tuple(res.grid.shape) == (IMP_N, IMP_N)
              and bool(torch.isfinite(res.grid).all()),
              f"{label}: wrong shape or non-finite grid")
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
            check(torch.equal(res.grid[sl], u0[sl]),
                  f"{label} moved the Dirichlet ring")
        sk.reset_counts()
        plain = solve(cfg.replace(backend="torch"), initial=u0)
        check(sk.counts["heat_mg_restrict"] == 0
              and sk.counts["restrict_full_weighting"] > 0,
              f"{label}: backend torch did not take the plain transfers")
        check(torch.equal(res.grid, plain.grid),
              f"{label}: backend cuda != backend torch on the card")
        one = solve(cfg.replace(backend="cuda", steps=1), initial=u0)
        gap = _linear_system_gap(scheme, u0, one.grid, IMP_C)
        check(gap <= 1.05 * cfg.mg_tol,
              f"{label}: one step leaves max|b - A x| = {gap} max|b|, "
              f"over 1.05 * mg_tol = {1.05 * cfg.mg_tol}")
        out[scheme] = {
            "elapsed_s": res.elapsed_s, "torch_backend_elapsed_s":
            plain.elapsed_s, "cycles_per_step": stats["cycles"] / IMP_STEPS,
            "host_syncs_per_step": stats["host_syncs"] / IMP_STEPS,
            "launches": {name: counts[name] for name in sorted(transfers)},
            "linear_system_gap_f64": gap, "bitwise_cuda_vs_torch": True,
            "ring_bit_exact": True}
        if launches is None:
            launches = {name: counts[name] for name in transfers}
            busy = _busy(lambda: solve(cfg.replace(backend="cuda"),
                                       initial=u0),
                         "implicit profiled")
    emit({"phase": "implicit", "ok": True, "shape": [IMP_N, IMP_N],
          "steps": IMP_STEPS, "cx": IMP_C, "cy": IMP_C, "levels": levels,
          "mg_tol": cfg.mg_tol, **out, "profiled_backward_euler": busy})
    return launches


def phase_timing_ens_mg(dev):
    """ms per launch of M, restrict and prolong, their plain versions and
    their conv yardsticks, each beside its bound."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.ops import batched
    from parallel_heat_tpu_torch.ops import multigrid as mg
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(cx=CX, cy=CY)
    a0, cx, cy = coeffs_f32(CX, CY)
    w5 = torch.tensor([[0.0, cx, 0.0], [cy, a0, cy], [0.0, cx, 0.0]],
                      dtype=torch.float32, device=dev).view(1, 1, 3, 3)
    rows = {}
    # M at the ensemble main path's stack: the fixed run's one launch
    # (K = 400, no residual: the row of the kernels line) and one 20-step
    # window with the residuals (a converge window).
    u = _member_inits(dev, ENS_N, [1.0 + i / ENS_B for i in range(ENS_B)])
    v = torch.empty_like(u)
    x = u.view(ENS_B, 1, ENS_N, ENS_N)

    def conv_steps(n):
        # Zero-padded, so that 400 steps keep the shape: a yardstick for
        # the arithmetic, not the Dirichlet update.
        y = x
        for _ in range(n):
            y = F.conv2d(y, w5, padding=1)
        return y

    interior = ENS_B * (ENS_N - 2) * (ENS_N - 2)
    m_rows = {}
    for k, residual, reps in ((ENS_STEPS, False, 5), (WINDOW, True, 20)):
        def launch_m():
            return batched.ensemble_steps(u, v, k, residual, **kw)

        m_rows[k] = {
            "shape": [ENS_B, ENS_N, ENS_N], "k": k, "residual": residual,
            "ms": _time_ms(launch_m, reps, 2),
            "plain_ms": _time_ms(lambda: batched.ensemble_steps_plain(
                u, v, k, residual, **kw), 2),
            "library_ms": _time_ms(lambda: conv_steps(k), 3, 1),
            **_bound(8 * ENS_B * ENS_N * ENS_N,
                     (OPS_PER_CELL_STEP * k
                      + OPS_PER_RESIDUAL_CELL * residual) * interior)}
        m_rows[k].update(_device_ms(launch_m, "heat_m_ensemble"))
    rows["heat_m_ensemble"] = m_rows[ENS_STEPS]
    del u, v, x
    torch.cuda.empty_cache()
    # M on 8 small members, one converge window: 20^2 one block a member,
    # 256^2 a cooperative tiling.
    small = {}
    for members, size in ((8, 20), (8, 256)):
        u = _rand_on(dev, (members, size, size), seed=size)
        v = torch.empty_like(u)

        def launch_small():
            return batched.ensemble_steps(u, v, WINDOW, True, **kw)

        plan = params().m_plan(members, (size, size))
        small[f"heat_m_ensemble@{members}x{size}^2"] = {
            "shape": [members, size, size], "k": WINDOW, "residual": True,
            "tiles": plan["tiles"], "tile": list(plan["tile"]),
            "ms": _time_ms(launch_small, 20, 2),
            **_device_ms(launch_small, "heat_m_ensemble")}
        del u, v
    # Restrict and prolong. Restrict: 2 multiplies and 2 adds for each of
    # 4 [1 2 1]/4 passes a coarse cell; prolong: 0, 2, 2 or 6 operations
    # a fine cell by the parity of its row and column, 2.5 on average.
    w_fw = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]],
                        dtype=torch.float32, device=dev).view(1, 1, 3, 3)
    w_bl = w_fw / 4.0
    w_fw = w_fw / 16.0
    by_size = {}
    for fine in MG_TIMED:
        coarse = _coarse_of(fine)
        r = _rand_on(dev, fine, seed=1)
        c = _rand_on(dev, coarse, seed=2)
        c[0] = c[-1] = 0
        c[:, 0] = c[:, -1] = 0
        nbytes = 4 * (fine[0] * fine[1] + coarse[0] * coarse[1])
        cells_c = (coarse[0] - 2) * (coarse[1] - 2)
        cells_f = (fine[0] - 2) * (fine[1] - 2)
        rx = r[1:, 1:].contiguous().view(1, 1, fine[0] - 1, fine[1] - 1)
        cx_ = c[1:-1, 1:-1].contiguous().view(1, 1, coarse[0] - 2,
                                              coarse[1] - 2)
        timed = {
            "heat_mg_restrict": (
                lambda: mg.restrict(r, coarse),
                lambda: mg.restrict_full_weighting(r, coarse),
                lambda: F.conv2d(rx, w_fw, stride=2), 16 * cells_c),
            "heat_mg_prolong": (
                lambda: mg.prolong(c, fine),
                lambda: mg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2)),
                lambda: F.conv_transpose2d(cx_, w_bl, stride=2),
                2.5 * cells_f),
        }
        size = {}
        for name, (kernel, plain, library, ops) in timed.items():
            size[name] = {
                "fine": list(fine), "coarse": list(coarse),
                "ms": _time_ms(kernel, 50, 5),
                "plain_ms": _time_ms(plain, 5, 1),
                "library_ms": _time_ms(library, 10, 2),
                **_bound(nbytes, ops)}
            size[name].update(_device_ms(kernel, name))
        by_size["x".join(map(str, fine))] = size
        del r, c, rx, cx_
    torch.cuda.empty_cache()
    # The kernels line takes the main path's shape, the last of MG_TIMED.
    rows.update(size)
    # The host's share of one transfer call at that shape, piece by piece
    # (tools/launch_cost.py).
    from parallel_heat_tpu_torch.tools import launch_cost

    host = launch_cost.breakdown(dev, calls=10000, size=IMP_N)
    emit({"phase": "timing_ens_mg", "transfer_call_host_us": {
        name: host[name]["host_us"] for name in (mg.RESTRICT, mg.PROLONG)},
        "transfer_call_events_ms": {
        name: host[name]["events_ms"] for name in (mg.RESTRICT, mg.PROLONG)},
        "kernels": {
        **{f"heat_m_ensemble@k{k}": row for k, row in m_rows.items()},
        **small, **{
            f"{name}@{key}": row for key, size in by_size.items()
            for name, row in size.items()}}})
    return rows


def phase_probe_kernel(dev):
    """The anatomy probe of kernel A (``tools/kernel_probe.py``,
    ``heat_probe_kernel``) at the converge path's 1000^2: its ``full``
    variant against A's plain version, bitwise, then every variant at
    K = 20 and 2000 and A's K ladder; returns the probe's launches, its
    ``full`` variant's device ms at K = 20 and its max |diff|."""
    import torch

    from parallel_heat_tpu_torch.models import HeatPlate2D
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.tools import kernel_probe as kp

    kw = dict(cx=CX, cy=CY)
    u = HeatPlate2D(CONV, CONV).init_grid(dev)
    got, want = torch.full_like(u, float("nan")), torch.empty_like(u)
    rk = kp.probe_steps("full", u, got, WINDOW, True, **kw)
    rp = sk.resident_steps_plain(u, want, WINDOW, True, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want) and same_float(rk, rp),
          f"heat_probe_kernel's full variant != A's plain version: max diff "
          f"{err}")
    kp.counts["heat_probe_kernel"] = 0
    rows = list(kp.anatomy(CONV, (WINDOW, 2000), (1, 2, 4, 8, WINDOW)))
    launches = kp.counts["heat_probe_kernel"]
    check(launches > 0 and {r.get("probe") for r in rows} >= set(
        kp.VARIANTS), f"the probe ran {launches} launches: {rows}")
    emit({"phase": "probe_kernel", "launches": launches, "rows": rows})
    return {"launches": launches, "max_abs_err": err,
            "device_ms": rows[0]["device_ms"][f"k{WINDOW}"]}


def phase_probe_vpu_roofline(dev):
    """The issue-rate roofline (``tools/vpu_roofline.py``,
    ``heat_probe_vpu_roofline``): its functions bitwise their plain
    versions on a small stack and on the full-width stack, then every
    variant by the slope over 64 and 1024 passes; returns the probe's
    launches in that run and its stencil's numbers at ``ROOF_PASSES``
    passes (device ms, plain ms, bound, ``conv2d`` chained as often, max
    |diff|)."""
    import torch

    from parallel_heat_tpu_torch.tools import vpu_roofline as vr

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(7)
    err = 0.0
    checked = []
    for shape in ((3, 24, 256), (sms, vr.ROWS, vr.COLS)):
        u = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        want = torch.empty_like(u)
        for kind, p in vr.CHECKED:
            for passes in (1, 4):
                got = torch.full_like(u, float("nan"))
                vr.sweep(kind, u, got, passes, p)
                vr.sweep_plain(kind, u, want, passes, p)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                err = max(err, diff)
                check(torch.equal(got, want),
                      f"roofline {vr.variant_name(kind, p)} at {shape}, "
                      f"{passes} passes != its plain version: "
                      f"{int((got != want).sum())} cells differ, max diff "
                      f"{diff}")
        checked.append(list(shape))
    vr.counts["heat_probe_vpu_roofline"] = 0
    rows = list(vr.roofline(device=dev))
    launches = vr.counts["heat_probe_vpu_roofline"]
    names = {vr.variant_name(kind, p) for kind, p in vr.VARIANTS}
    check(launches > 0 and {r.get("roofline") for r in rows} >= names,
          f"the roofline ran {launches} launches: {rows}")
    emit({"phase": "probe_vpu_roofline", "checked": checked,
          "variants_bitwise": [vr.variant_name(k, p) for k, p in vr.CHECKED],
          "launches": launches, "rows": rows})
    # The kernels line: the stencil at ROOF_PASSES passes over the
    # full-width stack, against its plain version, its bound (the stack
    # read and written once; the combine's operations) and conv2d chained
    # as often.
    stencil = next(r for r in rows if r.get("roofline") == "stencil")
    library = rows[-1]["conv2d_ms"] * ROOF_PASSES
    plain_ms = _time_ms(lambda: vr.sweep_plain("stencil", u, want,
                                               ROOF_PASSES), 1, 0)
    interior = sms * (vr.ROWS - 2) * (vr.COLS - 2)
    return {"launches": launches, "max_abs_err": err,
            "device_ms": stencil["device_ms"][f"d{ROOF_PASSES}"],
            "plain_ms": plain_ms, "library_ms": library,
            **_bound(8 * u.numel(),
                     OPS_PER_CELL_STEP * ROOF_PASSES * interior)}


def phase_probe_temporal(dev):
    """E-uni's anatomy probe (``tools/probe_temporal.py``,
    ``heat_probe_temporal``): its ``full`` variant bitwise E-uni's plain
    version at 16384^2, K = 8, and at every compiled K on grids that run
    every tile kind, then the anatomy at 16384^2 and 8192^2 and E-uni's K
    ladder; returns the probe's launches in that run, ``full``'s device
    ms at 16384^2 and its max |diff|."""
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import probe_temporal as pt

    k = params().e_k_default
    err = _check_e_probe(dev, pt.probe_steps, ("full",), "heat_probe_temporal",
                         k)
    pt.counts["heat_probe_temporal"] = 0
    rows = list(pt.anatomy((BIG, BIG // 2), k, device=dev))
    launches = pt.counts["heat_probe_temporal"]
    check(launches > 0 and {r.get("probe") for r in rows} >= set(
        pt.VARIANTS) and any("ladder" in r for r in rows),
          f"the probe ran {launches} launches: {rows}")
    emit({"phase": "probe_temporal", "launches": launches, "rows": rows})
    full = next(r for r in rows if r.get("probe") == "full"
                and r["size"] == BIG)
    return {"launches": launches, "max_abs_err": err,
            "device_ms": full["device_ms"][f"k{k}"]}


def _check_e_probe(dev, steps, variants, name, k_main):
    """The variants ``variants`` of an E-uni probe (``steps(variant, u,
    out, k, with_residual, cx=, cy=)``) bitwise ``temporal_steps_uni_plain``,
    grid and residual: on a random 16384^2 grid at ``k_main``, and at
    every compiled K on 1001 x 1000 and 20 x 24, which between them run
    every tile kind that a width E-uni takes allows (``e_tile_kinds``,
    asserted). Returns the max |diff|."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params

    rng = np.random.default_rng(11)
    err = 0.0
    kinds = {}
    plan = [((BIG, BIG), [k_main], [dict(cx=CX, cy=CY)]),
            ((1001, 1000), range(1, params().e_k_max() + 1),
             [dict(cx=CX, cy=CY), dict(cx=UNEQUAL[0], cy=UNEQUAL[1])]),
            ((20, 24), range(1, params().e_k_max() + 1),
             [dict(cx=CX, cy=CY)])]
    for shape, ks, coeffs in plan:
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        want = torch.empty_like(u)
        for k in ks:
            for kind, count in params().e_tile_kinds(shape, k).items():
                kinds[kind] = kinds.get(kind, 0) + count
            for kw in coeffs:
                rp = sk.temporal_steps_uni_plain(u, want, k, True, **kw)
                for variant in variants:
                    got = torch.full_like(u, float("nan"))
                    r = steps(variant, u, got, k, True, **kw)
                    torch.cuda.synchronize()
                    diff = float((got - want).abs().max())
                    err = max(err, diff)
                    check(torch.equal(got, want) and same_float(r, rp),
                          f"{name} {variant!r} (K={k}) at {shape} {kw} != "
                          f"E-uni's plain version: max diff {diff}, "
                          f"residual {float(r)} against {float(rp)}")
        del u, want
        torch.cuda.empty_cache()
    # Every kind but a part group, which needs a width no multiple of 4.
    check(all(n for kind, n in kinds.items() if kind != "partial_group"),
          f"{name}'s check grids run no tile of some kind: {kinds}")
    return err


def phase_probe_ab_temporal(dev):
    """E-uni's boundary A/B (``tools/ab_temporal.py``,
    ``heat_probe_ab_temporal``): ``prod`` and ``rowcopy`` bitwise E-uni's
    plain version at every compiled K on grids that run every tile kind,
    then the forms in turns at 16384^2, 8192^2 and 1024^2 (each plate
    checked first); returns the probe's launches in that run, ``prod``'s
    device ms at 16384^2 (its first batch) and the max |diff|."""
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import ab_temporal as ab

    k = params().e_k_default
    err = _check_e_probe(dev, ab.ab_steps, ab.FUNCTIONS,
                         "heat_probe_ab_temporal", k)
    ab.counts["heat_probe_ab_temporal"] = 0
    rows = list(ab.turns((BIG, BIG // 2, 1024), k, batches=3, tries=2,
                         device=dev))
    launches = ab.counts["heat_probe_ab_temporal"]
    check(launches > 0 and [r["size"] for r in rows] == [BIG, BIG // 2, 1024]
          and all(set(r["device_ms"]) == set(ab.VARIANTS) for r in rows),
          f"the A/B ran {launches} launches: {rows}")
    emit({"phase": "probe_ab_temporal", "launches": launches, "rows": rows})
    return {"launches": launches, "max_abs_err": err,
            "device_ms": rows[0]["device_ms"]["prod"][0]}


def phase_probe_split_copy(dev):
    """E-uni's load split (``tools/probe_split_copy.py``,
    ``heat_probe_split_copy``): every load form bitwise E-uni's plain
    version (no residual) at every compiled K its geometry allows on grids
    that run every tile kind, and at 16384^2, K = 8; then the forms in
    turns at 16384^2 and 4096^2. Returns the probe's launches in that run,
    ``whole``'s device ms at 16384^2 (its first batch) and the max
    |diff|."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import probe_split_copy as sc

    t0 = time.perf_counter()
    k_main = params().e_k_default
    rng = np.random.default_rng(13)
    err = 0.0
    checked = {}
    kinds = {}
    plan = [((BIG, BIG), [k_main]),
            ((1001, 1000), range(1, params().e_k_max() + 1)),
            ((20, 24), range(1, params().e_k_max() + 1))]
    kw = dict(cx=CX, cy=CY)
    for shape, ks in plan:
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        want = torch.empty_like(u)
        for k in ks:
            for kind, count in params().e_tile_kinds(shape, k).items():
                kinds[kind] = kinds.get(kind, 0) + count
            sk.temporal_steps_uni_plain(u, want, k, False, **kw)
            for form in sc.variants():
                if sc.refusal(form, k) is not None:
                    continue
                got = torch.full_like(u, float("nan"))
                sc.split_steps(form, u, got, k, **kw)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                err = max(err, diff)
                check(torch.equal(got, want),
                      f"heat_probe_split_copy {form!r} (K={k}) at {shape} "
                      f"!= E-uni's plain version: max diff {diff}")
                checked[form] = checked.get(form, 0) + 1
        del u, want
        torch.cuda.empty_cache()
    check(set(checked) == set(sc.variants()) and all(
        n for kind, n in kinds.items() if kind != "partial_group"),
          f"the split check ran {checked} on tile kinds {kinds}")
    sc.counts["heat_probe_split_copy"] = 0
    rows = list(sc.turns((BIG, 4096), k_main, batches=3, tries=1,
                         device=dev))
    launches = sc.counts["heat_probe_split_copy"]
    check(launches > 0 and [r["size"] for r in rows] == [BIG, 4096]
          and all(set(r["device_ms"]) == set(sc.variants()) for r in rows),
          f"the split turns ran {launches} launches: {rows}")
    emit({"phase": "probe_split_copy", "seconds": time.perf_counter() - t0,
          "checked": checked, "launches": launches, "rows": rows})
    return {"launches": launches, "max_abs_err": err,
            "device_ms": rows[0]["device_ms"]["whole"][0]}


def phase_probe_gather_dma(dev):
    """Loads alone (``tools/probe_gather_dma.py``,
    ``heat_probe_gather_dma``): every form's element and each block's last
    window bitwise its plain version on 1001 x 1000 and 4096^2 (tail 128
    floats), then each form's device time and landed GB/s at 4096^2 and
    16384^2 (each array checked again first). Returns the probe's launches
    in that run and the dense TMA form's numbers at 16384^2: device ms,
    its plain version's ms, its bound (the grid's bytes that the windows
    cover, each read once, over HBM's rate) and no yardstick: no PyTorch
    call loads windows into shared memory."""
    import torch

    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import probe_gather_dma as gd

    t0 = time.perf_counter()
    p = params()
    k, (ty, tx) = p.e_k_default, p.e_tile
    geo = dict(rows=ty, k=k, cols=p.row_floats(k, tx), stride=tx)
    rng = np.random.default_rng(17)
    checked = []
    for shape in ((1001, 1000), (4096, 4096)):
        u = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        for form in gd.VARIANTS:
            a, t, cols, stride = gd.arrays(form, u, gd.TAIL, **geo)
            kw = dict(rows=ty, k=k, cols=cols, stride=stride)
            got, win = gd.gather_dma(form, a, t, check=True, **kw)
            want, wwin = gd.gather_dma_plain(form, a, t, check=True,
                                             blocks=win.shape[0], **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(win, wwin),
                  f"heat_probe_gather_dma {form!r} at {shape} loaded other "
                  f"cells than its plain version's windows: "
                  f"{int((win != wwin).sum())} differ")
            checked.append([form, list(shape), int(win.shape[0])])
        del u
    torch.cuda.empty_cache()
    gd.counts["heat_probe_gather_dma"] = 0
    rows = list(gd.timings((4096, BIG), gd.TAIL, device=dev))
    launches = gd.counts["heat_probe_gather_dma"]
    check(launches > 0 and len(rows) == 2 * len(gd.VARIANTS),
          f"the gather probe ran {launches} launches: {rows}")
    emit({"phase": "probe_gather_dma", "seconds": time.perf_counter() - t0,
          "checked": checked, "launches": launches, "rows": rows})
    dense = next(r for r in rows if r["gather_dma"] == "dense"
                 and r["size"] == BIG)
    u = torch.empty((BIG, BIG), dtype=torch.float32, device=dev)
    plain_ms = _time_ms(lambda: gd.gather_dma_plain("dense", u, **geo), 3)
    del u
    torch.cuda.empty_cache()
    t_bytes = dense["read_bytes"] / p.hbm_bytes_per_s * 1e3
    return {"launches": launches, "max_abs_err": 0.0,
            "device_ms": dense["device_ms"]["x1"], "plain_ms": plain_ms,
            "bound_ms": t_bytes, "bound_by": "bytes", "library_ms": None}


def _sweep_phase(dev, name, module, run, plain, shapes, full, rows_fn,
                 label):
    """The sweep probes' phase: ``run(u, out, d, lo)`` bitwise
    ``plain(u, out, d, lo)`` on a 3-member stack at D = 1, 2 and 5 for each
    ``(w, lo)`` of ``shapes`` and on the full stack (one member an SM) at
    ``full``; then the slopes (``rows_fn()``). Returns the probe's
    launches in that run and its numbers at D = 64 on the full stack at
    ``full``: device ms, plain ms, bound (the stack read and written once
    through HBM; the sweeps' operations) and ``conv2d`` with circular
    padding chained as often."""
    import torch

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(19)
    checked = []
    for (r, w, lo), members, depths in (
            [(sh, 3, (1, 2, 5)) for sh in shapes] + [(full, sms, (4,))]):
        u = torch.from_numpy(rng.standard_normal(
            (members, r, w)).astype(np.float32)).to(dev)
        for d in depths:
            got = torch.full_like(u, float("nan"))
            want = torch.empty_like(u)
            run(u, got, d, lo)
            plain(u, want, d, lo)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{name} at {(members, r, w)}, lo = {lo}, D = {d} != its "
                  f"plain version: {int((got != want).sum())} cells differ")
            checked.append([members, r, w, lo, d])
    module.counts[name] = 0
    rows = list(rows_fn())
    launches = module.counts[name]
    check(launches > 0 and len(rows) > 0,
          f"{name} ran {launches} launches: {rows}")
    emit({"phase": label, "seconds": time.perf_counter() - t0,
          "checked": checked, "launches": launches, "rows": rows})
    r, w, lo = full
    row = next(x for x in rows if x["width"] == w
               and x.get("store_align", lo) == lo)
    u = torch.from_numpy(rng.standard_normal((sms, r, w)).astype(
        np.float32)).to(dev)
    want = torch.empty_like(u)
    plain_ms = _time_ms(lambda: plain(u, want, 64, lo), 1, 0)
    cells = sms * 64 * w
    return {"launches": launches, "max_abs_err": 0.0,
            "device_ms": row["device_ms"]["d64"], "plain_ms": plain_ms,
            "library_ms": row["conv2d_circular_us_per_sweep"] * 64 / 1e3,
            **_bound(8 * u.numel(), OPS_PER_CELL_STEP * 64 * cells)}


def phase_probe_sweep_width(dev):
    """The shared-memory sweep's width ladder
    (``tools/probe_sweep_width.py``, ``heat_probe_sweep_width``): bitwise
    its plain version at every width, then the ladder; returns its
    launches and numbers at the widest width (:func:`_sweep_phase`)."""
    from parallel_heat_tpu_torch.tools import probe_sweep_width as psw

    def run(u, out, d, lo):
        psw.sweep(u, out, d, lo=lo)

    def plain(u, out, d, lo):
        psw.sweep_plain(u, out, d, lo=lo)

    return _sweep_phase(
        dev, "heat_probe_sweep_width", psw, run, plain,
        [(psw.R, w, psw.LO) for w in psw.WIDTHS],
        (psw.R, max(psw.WIDTHS), psw.LO),
        lambda: psw.ladder(device=dev), "probe_sweep_width")


def phase_probe_store_align(dev):
    """The same sweep at the band offsets and two row pitches
    (``tools/probe_store_align.py``, ``heat_probe_store_align``): bitwise
    its plain version at each, then the slopes; returns its launches and
    numbers at lo = 8 and the odd pitch (:func:`_sweep_phase`)."""
    from parallel_heat_tpu_torch.tools import probe_store_align as psa
    from parallel_heat_tpu_torch.tools import probe_sweep_width as psw

    def run(u, out, d, lo):
        psa.align_sweep(u, out, d, lo=lo)

    def plain(u, out, d, lo):
        psw.sweep_plain(u, out, d, lo=lo, rows=psa.ROWS)

    return _sweep_phase(
        dev, "heat_probe_store_align", psa, run, plain,
        [(psa.R, w, lo) for w in psa.WIDTHS for lo in psa.OFFSETS],
        (psa.R, psa.WIDTHS[1], 8),
        lambda: psa.offsets(device=dev), "probe_store_align")


def phase_probe_roll_pad(dev):
    """Kernel A's and E-uni's neighbour forms (``tools/probe_roll_pad.py``,
    ``heat_probe_roll_pad``): every form bitwise its kernel's plain version
    (grid and residual) where the forms' reads differ from the shuffles'
    (A at every halo depth 1 .. 8 on 1000^2 and at several K on
    1001 x 999, 21 x 23 and 20 x 24; E-uni at every compiled K on
    1001 x 1000 and 20 x 24), then the forms in turns (two batches) on A
    at 1000^2, K = 20, and 1859^2, K = 64, and on E-uni at 16384^2, K = 8,
    each plate checked first. Returns the probe's launches in that run,
    ``padslice``'s device ms on A at 1000^2 (its first batch) and the max
    |diff|."""
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import probe_roll_pad as rp

    t0 = time.perf_counter()
    checked = rp.check(dev)
    rp.counts["heat_probe_roll_pad"] = 0
    plates = (("A", CONV, WINDOW), ("A", A_LARGEST, 64),
              ("E-uni", BIG, params().e_k_default))
    rows = list(rp.turns(plates, batches=2, tries=1, device=dev))
    launches = rp.counts["heat_probe_roll_pad"]
    check(launches > 0 and [r["size"] for r in rows] == [p[1] for p in plates]
          and all(set(r["device_ms"]) == set(rp.FORMS) for r in rows),
          f"the neighbour forms ran {launches} launches: {rows}")
    emit({"phase": "probe_roll_pad", "seconds": time.perf_counter() - t0,
          "checked": {kernel: len(checked[kernel]) for kernel in rp.KERNELS},
          "max_abs_err": checked["max_abs_err"], "launches": launches,
          "rows": rows})
    return {"launches": launches,
            "max_abs_err": max(e for forms in checked["max_abs_err"].values()
                               for e in forms.values()),
            "device_ms": rows[0]["device_ms"]["padslice"][0]}


def phase_probe_xslab_overlap(dev):
    """Kernel F's load/compute overlap (``tools/probe_xslab_overlap.py``,
    ``heat_probe_xslab_overlap``): ``full`` bitwise F's plain version (grid
    and residual) on random 67 x 130 x 204 under both loads and
    67 x 130 x 201 by cp.async, then at 512^3, K = 3, under each load
    (the plate checked first) ``full``, ``no_step`` and ``no_load``, the
    max and sum models, and ``full`` and ``no_step`` at 1, 2, 4 and the
    most planes in flight. Returns the probe's launches in that run,
    ``full``'s device ms at 512^3 by TMA and the max |diff|."""
    import torch

    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import probe_xslab_overlap as xo

    t0 = time.perf_counter()
    k = params().f_k_default
    rng = np.random.default_rng(31)
    err = 0.0
    checked = []
    for shape, loads in (((67, 130, 204), ("tma", "cp.async")),
                         ((67, 130, 201), ("cp.async",))):
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        for load in loads:
            err = max(err, xo.check(u, k, load))
            checked.append([list(shape), load])
    xo.counts["heat_probe_xslab_overlap"] = 0
    rows = list(xo.overlap((CUBE,), k, ("tma", "cp.async"), tries=1,
                           ladder=(1, 2, 4, xo.prefetch_max(k)),
                           device=dev))
    launches = xo.counts["heat_probe_xslab_overlap"]
    check(launches > 0 and [r["load"] for r in rows] == ["tma", "cp.async"]
          and all(set(r["device_ms"]) == set(xo.VARIANTS) for r in rows),
          f"the overlap probe ran {launches} launches: {rows}")
    emit({"phase": "probe_xslab_overlap", "seconds": time.perf_counter() - t0,
          "checked": checked, "launches": launches, "rows": rows})
    return {"launches": launches,
            "max_abs_err": max([err] + [r["max_abs_err"] for r in rows]),
            "device_ms": rows[0]["device_ms"]["full"]}


# ---------------------------------------------------------------------------
# The sharded 2D path (kernels G-uni, G-fuse, G-circ, G and the band fix)
# ---------------------------------------------------------------------------

def _g_plain(skb, kind):
    return {"G-uni": skb.block_uniform_plain, "G-fuse": skb.block_fused_plain,
            "G-circ": skb.block_circular_plain,
            "G": skb.block_padded_plain}[kind]


def _check_g_block(dev, xch, b, us, k, kw, e_out, err):
    """Every G kind at depth ``k`` on block ``b`` (the exchange ``xch``
    has run both phases), in the blocks' dtype (its bfloat16 forms for
    bfloat16 blocks), against its plain version (grid with and without
    the residual, residual), the others, and ``heat_e_temporal``'s K
    steps of the global grid on the same cells, all bit for bit; G-uni
    refusing a width its 16-byte load does not take; and the deferred
    bulk plus the band, spliced in place, against the monolithic kernel,
    grid and max residual. Returns the residual."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb

    bx, by = us[b].shape
    bf16 = us[b].dtype == torch.bfloat16
    o = xch.mesh.origin(b, (bx, by))
    g_kw = dict(origin=o, **kw)
    want = e_out[o[0]:o[0] + bx, o[1]:o[1] + by].contiguous()
    band = skb.entry(skb.BAND, us[b].dtype)
    exts = {}
    for kind, how in (("G-circ", xch.assemble_circular),
                      ("G", xch.assemble_padded)):
        exts[kind] = us[b].new_empty((bx + 2 * k, by + 2 * k))
        how(b, us[b], exts[kind])
    first = None
    for kind, name in (skb.KERNEL_OF_BF16 if bf16 else skb.KERNEL_OF).items():
        if kind == "G-uni" and by % (8 if bf16 else 4):
            try:
                skb.block_uniform(us[b], *xch.pieces(b), torch.empty_like(
                    us[b]), k, **g_kw)
            except ValueError:
                continue
            raise SmokeFailure(f"{name} took blocks {bx} x {by}, whose "
                               f"width its 16-byte load does not take")
        args = (exts[kind],) if kind in exts else (us[b], *xch.pieces(b))
        got, ref, nores = (torch.full_like(us[b], float("nan"))
                           for _ in range(3))
        r = skb.LAUNCH[kind](*args, got, k, True, **g_kw)
        skb.LAUNCH[kind](*args, nores, k, False, **g_kw)
        rp = _g_plain(skb, kind)(*args, ref, k, True, **g_kw)
        torch.cuda.synchronize()
        d = max(float((got.float() - ref.float()).abs().nan_to_num(0).max()),
                float((got.float() - want.float()).abs().nan_to_num(0)
                      .max()))
        err[name] = max(err[name], d)
        where = f"{name}(K={k}) on block {o} of {kw['grid_shape']} {kw}"
        check(_bits_equal(got, ref) and same_float(r, rp),
              f"{where} != its plain version: max diff {d}, residual "
              f"{float(r)} vs {float(rp)}")
        check(_bits_equal(got, want),
              f"{where} != heat_e_temporal(K={k}) on the global grid")
        check(r.dtype == torch.float32 and _bits_equal(got, nores),
              f"{where}: grid depends on with_residual")
        if first is None:
            first = r
        check(same_float(r, first), f"{where}: residual {float(r)} differs "
              f"from the other kinds' {float(first)}")
        if kind in ("G-uni", "G-fuse") and bx >= 2 * k:
            split, plain = (torch.full_like(us[b], float("nan"))
                            for _ in range(2))
            tail = xch.tail[b]
            rb = skb.LAUNCH[kind](us[b], tail, None, None, split, k, True,
                                  **g_kw)
            rf = skb.band_fix(us[b], *xch.pieces(b), split, k, True, **g_kw)
            rpb = _g_plain(skb, kind)(us[b], tail, None, None, plain, k,
                                      True, **g_kw)
            rpf = skb.band_fix_plain(us[b], *xch.pieces(b), plain, k, True,
                                     **g_kw)
            torch.cuda.synchronize()
            err[band] = max(err[band], float(
                (split.float() - plain.float()).abs().nan_to_num(0).max()))
            check(_bits_equal(split, plain) and same_float(rb, rpb)
                  and same_float(rf, rpf),
                  f"{where}: deferred bulk or band != its plain version")
            check(_bits_equal(split, got)
                  and same_float(torch.maximum(rb, rf), r),
                  f"{where}: deferred bulk + band != the monolithic kernel "
                  f"(residuals {float(rb)}, {float(rf)} vs {float(r)})")
    return first


def _check_band_blocks(dev, mesh, us, xch, k, kw, err):
    """The band kernel over every block of ``mesh`` in one launch (the
    exchange ``xch`` has run both phases; its bfloat16 form for bfloat16
    blocks), under each load the blocks take (the per-cell load always,
    the row load where it fits), bit for bit each block's plain version
    and the batched plain version, NaN between the bands in all; returns
    the residual and outputs of the load the launch picks, and adds the
    loads run to ``err["band loads"]``."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb

    bs = tuple(us[0].shape)
    band = skb.entry(skb.BAND, us[0].dtype)
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    one, plain = ([torch.full_like(u, float("nan")) for u in us]
                  for _ in range(2))
    rs = [skb.band_fix_plain(us[b], *xch.pieces(b), one[b], k, True,
                             origin=origins[b], **kw)
          for b in range(mesh.size)]
    rp = skb.band_fix_blocks_plain(us, xch.tail, xch.halo_n, xch.halo_s,
                                   plain, k, True, origins=origins, **kw)
    picked = skb.BandLaunch(us, xch.tail, xch.halo_n, xch.halo_s, one, k,
                            origins=origins, **kw).load
    out = None
    for load in sorted({"cells", picked}):
        got = [torch.full_like(u, float("nan")) for u in us]
        launch = skb.BandLaunch(us, xch.tail, xch.halo_n, xch.halo_s, got, k,
                                origins=origins, load=load, **kw)
        check(launch.name == band, f"{us[0].dtype} blocks launch "
                                   f"{launch.name}")
        r = launch(True)
        torch.cuda.synchronize()
        err["band loads"].add(load)
        where = (f"{band} ({load} load) over the {mesh.size} blocks {bs} of "
                 f"{kw['grid_shape']} at K={k} {kw}")
        for a, b_, c in zip(got, one, plain):
            err[band] = max(err[band], float(
                (a.float() - b_.float()).abs().nan_to_num(0).max()))
            check(_bits_equal(a, b_) and _bits_equal(a, c),
                  f"{where} != the per-block plain versions")
            check(bool(a[k:bs[0] - k].isnan().all()),
                  f"{where} wrote rows between the bands")
        check(same_float(r, torch.stack(rs).amax()) and same_float(r, rp),
              f"{where}: residual {float(r)} != the plain versions' "
              f"{float(torch.stack(rs).amax())}, {float(rp)}")
        if load == picked:
            out = (r, got)
    return out


def phase_kernels_g(dev):
    """The five G kernels against their plain versions, each other and
    kernel E, on blocks cut from seeded random global grids with the
    exchange pieces built by the port's own exchange; returns max |diff|
    each."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    err = {name: 0.0 for name in KERNELS_G}
    err["band loads"] = set()
    equal = dict(cx=CX, cy=CY)
    unequal = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    gen = torch.Generator(device=dev).manual_seed(4)
    p = params()
    every_k = list(range(1, p.g_k_max() + 1))
    # (grid, mesh, depths, block indices, the tile kinds each depth must
    # run; csrc/heat_g.cuh's branches, counted by hopper_params
    # g_tile_kinds over the monolithic, deferred-bulk and band launches):
    # the main path's 16384 x 8192 blocks (corner (0, 0) and (1, 2), which
    # has neighbours on three sides) at its K; every 500 x 252 block of
    # 1000 x 1008 on (2, 4) (every kind, G-uni included) and every 500 x
    # 250 block of 1000^2 on (2, 4) (a width that is no multiple of 4: a
    # last tile of 26 columns ends in a part group) at every compiled K;
    # and 16 x 24 blocks at K = 8, exactly 2K rows.
    common = ("inside", "block_edge", "ragged_rows", "ragged_cols",
              "global_edge")
    plan = [((SHARD_N, SHARD_N), SHARD_MESH, [p.g_k_default], [0, 6],
             common),
            ((CONV, 1008), SHARD_CONV, every_k, list(range(8)), common),
            ((CONV, CONV), SHARD_CONV, every_k, list(range(8)),
             common + ("partial_group",)),
            ((32, 48), (2, 2), [8], list(range(4)),
             ("block_edge", "global_edge"))]
    report = []
    for grid, mesh_shape, ks, blocks, need in plan:
        g = torch.randn(grid, generator=gen, device=dev) * 10
        mesh = HeatMesh(mesh_shape, dev)
        us = mesh.split(g)
        bx, by = mesh.block_shape(grid)
        tiles = {}
        for k in ks:
            kinds = dict.fromkeys(need, 0)
            for b in blocks:
                o = mesh.origin(b, (bx, by))
                launches = [p.g_tile_kinds((bx, by), k, origin=o,
                                           grid_shape=grid)]
                if bx >= 2 * k:
                    launches += [
                        p.g_tile_kinds((bx, by), k, [(k, bx - 2 * k)],
                                       origin=o, grid_shape=grid),
                        p.g_tile_kinds((bx, by), k, [(0, k), (bx - k, k)],
                                       (k, p.g_band_tile_x), o, grid)]
                for counted in launches:
                    for kind in need:
                        kinds[kind] += counted[kind]
            check(all(kinds.values()), f"the check blocks of {grid} on "
                  f"{mesh_shape} at K={k} run no tile of some kind they are "
                  f"there for: {kinds}")
            tiles[k] = kinds
            xch = temporal.DeepExchange2D(mesh, (bx, by), k, dev)
            xch.phase1(us)
            xch.phase2(us)
            for coeffs in (equal, unequal):
                e_out = torch.empty_like(g)
                sk.temporal_steps(g, e_out, k, **coeffs)
                for b in blocks:
                    _check_g_block(dev, xch, b, us, k,
                                   dict(grid_shape=grid, **coeffs), e_out,
                                   err)
                del e_out
                if bx >= 2 * k:
                    _check_band_blocks(dev, mesh, us, xch, k,
                                       dict(grid_shape=grid, **coeffs), err)
            del xch
        report.append({"grid": list(grid), "mesh": list(mesh_shape),
                       "block": [bx, by], "k": ks, "blocks": blocks,
                       "coeffs": [equal, unequal], "tile_kinds": tiles,
                       "bitwise_plain_each_other_and_e": True,
                       "deferred_plus_band_is_monolithic": True,
                       "band_blocks_bitwise_per_block_plain": bx >= 2 * ks[0]})
        del g, us
        torch.cuda.empty_cache()
    # The band kernel over the 4 blocks of 16384^2 on (2, 2) in one launch.
    big = (BIG, BIG)
    g = torch.randn(big, generator=gen, device=dev) * 10
    mesh = HeatMesh((2, 2), dev)
    us = mesh.split(g)
    del g
    k = p.g_k_default
    xch = temporal.DeepExchange2D(mesh, mesh.block_shape(big), k, dev)
    xch.phase1(us)
    xch.phase2(us)
    _check_band_blocks(dev, mesh, us, xch, k, dict(grid_shape=big, **equal),
                       err)
    report.append({"grid": list(big), "mesh": [2, 2], "k": [k],
                   "band_blocks_bitwise_per_block_plain": True})
    del us, xch
    torch.cuda.empty_cache()
    # A diverging block: one NaN next to the ring of corner block (0, 0),
    # blocks 252 wide so that every kind takes them.
    nan_grid = (CONV, 1008)
    g = torch.randn(nan_grid, generator=gen, device=dev) * 10
    g[2, 3] = float("nan")
    mesh = HeatMesh(SHARD_CONV, dev)
    us = mesh.split(g)
    xch = temporal.DeepExchange2D(mesh, mesh.block_shape(g.shape), 8, dev)
    xch.phase1(us)
    xch.phase2(us)
    kw = dict(origin=(0, 0), grid_shape=nan_grid, **equal)
    nan_res = {}
    for kind, name in skb.KERNEL_OF.items():
        out = torch.empty_like(us[0])
        if kind in ("G-circ", "G"):
            ext = torch.empty((us[0].shape[0] + 16, us[0].shape[1] + 16),
                              device=dev)
            (xch.assemble_circular if kind == "G-circ"
             else xch.assemble_padded)(0, us[0], ext)
            r = skb.LAUNCH[kind](ext, out, 8, True, **kw)
        else:
            r = skb.LAUNCH[kind](us[0], *xch.pieces(0), out, 8, True, **kw)
        nan_res[name] = float(r)
        check(math.isnan(nan_res[name]), f"NaN-seeded block gave {name} "
              f"residual {nan_res[name]}, not NaN")
        check(torch.equal(out[0], us[0][0])
              and torch.equal(out[:, 0], us[0][:, 0]),
              f"a diverging block moved the Dirichlet ring ({name})")
    out = torch.empty_like(us[0])
    nan_res["heat_g_band_fix"] = float(skb.band_fix(us[0], *xch.pieces(0),
                                                    out, 8, True, **kw))
    check(math.isnan(nan_res["heat_g_band_fix"]),
          "NaN-seeded block gave a band residual that is not NaN")
    check(torch.equal(out[0], us[0][0]), "the band kernel moved the ring")
    r, outs = _check_band_blocks(dev, mesh, us, xch, 8,
                                 dict(grid_shape=nan_grid, **equal), err)
    nan_res["heat_g_band_fix@blocks"] = float(r)
    check(math.isnan(float(r)), "NaN-seeded block gave the band kernel over "
          "the blocks a residual that is not NaN")
    check(torch.equal(outs[0][0], us[0][0])
          and torch.equal(outs[0][:8, 0], us[0][:8, 0]),
          "the band kernel over the blocks moved the ring")
    del g, us, xch
    torch.cuda.empty_cache()
    loads = sorted(err.pop("band loads"))
    check(loads == ["cells", "rows"], f"the band launches checked took the "
          f"loads {loads}, not both the row load and the per-cell load")
    emit({"phase": "kernels_g", "ok": True, "checks": report,
          "nan_residual": nan_res, "max_abs_err": err, "band_loads": loads})
    return err


def _sharded_run(cfg, expect, label, force=None):
    """solve(cfg) with the counts set to 0 just before and read just
    after; the launches must be exactly ``expect`` and every other kernel
    and plain version must not have run."""
    from parallel_heat_tpu_torch import solve, tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    sk.reset_counts()
    if force is None:
        res = solve(cfg)
    else:
        with tune.force("block_temporal_2d", force):
            res = solve(cfg)
    counts = dict(sk.counts)
    for name, n in counts.items():
        check(n == expect.get(name, 0),
              f"{label}: {name} ran {n} times, {expect.get(name, 0)} "
              f"expected")
    return res, counts


def phase_sharded_main_path():
    """32768^2 on a (2, 4) mesh, 200 steps: the default resolution (K = 8,
    overlap, G-uni bulk + band), the phase schedule and each other G kind
    pinned, every grid bitwise the one-block run; and 16384^2 on (2, 2)
    bitwise the 16384^2 main path. Returns each G kernel's launches."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, explain, solve
    from parallel_heat_tpu_torch.ops.hopper_params import params

    k = params().g_k_default
    one_cfg = HeatConfig(nx=SHARD_N, ny=SHARD_N, steps=MAIN_STEPS)
    cfg = one_cfg.replace(mesh_shape=SHARD_MESH)
    resolved = explain(cfg)
    check(resolved["halo_depth"] == f"{k} (auto)"
          and resolved["halo_overlap"] == "overlap (auto)"
          and resolved["decided_by"]["block_temporal_2d"]["choice"]
          == "G-uni", f"32768^2 on (2, 4) resolved to {resolved}")
    one = solve(one_cfg)
    check(bool(torch.isfinite(one.grid).all()), "non-finite grid")
    cells = SHARD_N * SHARD_N * MAIN_STEPS / 1e6
    n = (MAIN_STEPS // k) * math.prod(SHARD_MESH)
    rounds = MAIN_STEPS // k   # one band launch a round, every block's
    runs = [("default", cfg, None, {"heat_g_block_uniform": n,
                                     "heat_g_band_fix": rounds}),
            ("phase", cfg.replace(halo_overlap="phase"), None,
             {"heat_g_block_uniform": n}),
            ("G-fuse", cfg, "G-fuse", {"heat_g_block_fused": n,
                                       "heat_g_band_fix": rounds}),
            ("G-circ", cfg, "G-circ", {"heat_g_block_circular": n}),
            ("G", cfg, "G", {"heat_g_block_padded": n})]
    out, launches = {}, {}
    for label, c, force, expect in runs:
        res, counts = _sharded_run(c, expect, f"32768^2 (2, 4) {label}",
                                   force)
        check(res.steps_run == MAIN_STEPS
              and tuple(res.grid.shape) == (SHARD_N, SHARD_N),
              f"32768^2 (2, 4) {label}: {res.steps_run} steps, shape "
              f"{tuple(res.grid.shape)}")
        check(torch.equal(res.grid, one.grid),
              f"32768^2 (2, 4) {label} differs from the one-block run")
        out[label] = {"elapsed_s": res.elapsed_s,
                      "mcells_steps_per_s": cells / res.elapsed_s,
                      "launches": {name: counts[name] for name in expect}}
        if label in ("default", "G-fuse", "G-circ", "G"):
            for name in expect:
                launches.setdefault(name, counts[name])
        del res
        torch.cuda.empty_cache()
    busy = _busy(lambda: solve(cfg), "32768^2 (2, 4) profiled")
    busy_one = _busy(lambda: solve(one_cfg), "32768^2 one block profiled")
    one_s = one.elapsed_s
    del one
    torch.cuda.empty_cache()
    # 16384^2 on (2, 2): the existing main path's grid, bitwise.
    big = HeatConfig(nx=BIG, ny=BIG, steps=MAIN_STEPS)
    n4 = (MAIN_STEPS // k) * 4
    res, _ = _sharded_run(big.replace(mesh_shape=(2, 2)),
                          {"heat_g_block_uniform": n4,
                           "heat_g_band_fix": rounds}, "16384^2 (2, 2)")
    check(torch.equal(res.grid, solve(big).grid),
          "16384^2 on (2, 2) differs from the 16384^2 main path's grid")
    emit({"phase": "sharded_main_path", "ok": True,
          "shape": [SHARD_N, SHARD_N], "mesh": list(SHARD_MESH),
          "block": [SHARD_N // SHARD_MESH[0], SHARD_N // SHARD_MESH[1]],
          "steps": MAIN_STEPS, "resolved": resolved["path"],
          "one_block": {"elapsed_s": one_s,
                        "mcells_steps_per_s": cells / one_s},
          "runs": out, "bitwise_one_block": True,
          "profiled_default": busy, "profiled_one_block": busy_one,
          "bitwise_16384_2x2": True,
          "elapsed_s_16384_2x2": res.elapsed_s})
    return launches


def phase_sharded_converge():
    """Converge mode on a mesh: 1000^2 on (2, 4) (rounds of 8 + 8 + 4 a
    window, G-fuse + band), 20^2 on (2, 2) (blocks of 10 rows: the
    monolithic round) and 256^2 on (2, 2) at halo depth 1 (G at K = 1),
    each identical to its one-block run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    base = dict(steps=10000, converge=True, check_interval=WINDOW, eps=1e-3)
    windows = 10000 // WINDOW
    rounds = len([8, 8, 4])
    per_window = rounds * math.prod(SHARD_CONV)
    # One band launch a round for every block's bands.
    cases = [
        ("1000^2 (2, 4)", HeatConfig(nx=CONV, ny=CONV, mesh_shape=SHARD_CONV,
                                     **base),
         {"heat_g_block_fused": windows * per_window,
          "heat_g_band_fix": windows * rounds}),
        # Blocks of 10 rows: the K = 8 rounds run the monolithic kernel,
        # the depth-4 remainder round (10 >= 2 * 4) bulk and band.
        ("20^2 (2, 2)", HeatConfig(nx=20, ny=20, mesh_shape=(2, 2), **base),
         {"heat_g_block_fused": 99 * 3 * 4, "heat_g_band_fix": 99}),
        ("256^2 (2, 2) depth 1", HeatConfig(nx=256, ny=256, steps=MAIN_STEPS,
                                            mesh_shape=(2, 2), halo_depth=1),
         {"heat_g_block_uniform": MAIN_STEPS * 4,
          "heat_g_band_fix": MAIN_STEPS})]
    out = {}
    for label, cfg, expect in cases:
        one = solve(cfg.replace(mesh_shape=None, halo_depth=None))
        res, _ = _sharded_run(cfg, expect, label)
        check((res.steps_run, res.converged) == (one.steps_run, one.converged)
              and same_float(res.residual if res.residual is not None
                             else 0.0,
                             one.residual if one.residual is not None
                             else 0.0)
              and torch.equal(res.grid, one.grid),
              f"{label}: {res.steps_run} steps, converged {res.converged}, "
              f"residual {res.residual}; one block: {one.steps_run}, "
              f"{one.converged}, {one.residual}")
        out[label] = {"steps_run": res.steps_run,
                      "converged": res.converged, "residual": res.residual,
                      "elapsed_s": res.elapsed_s,
                      "one_block_elapsed_s": one.elapsed_s,
                      "launches": expect}
    check(out["20^2 (2, 2)"]["steps_run"] == 1980
          and out["20^2 (2, 2)"]["converged"],
          f"20^2 on (2, 2) did not converge at step 1980: {out}")
    check(out["1000^2 (2, 4)"]["steps_run"] == 10000,
          f"1000^2 on (2, 4) ran {out['1000^2 (2, 4)']['steps_run']} steps")
    emit({"phase": "sharded_converge", "ok": True, **out,
          "identical_to_one_block": True})


def phase_cli_sharded():
    """The CLI on a (2, 2) mesh writes the one-block grid."""
    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.utils.io import read_dat, write_dat

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.dat")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "256",
               "--ny", "256", "--steps", "100", "--mesh", "2,2", "--out",
               path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"sharded CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        grid = solve(HeatConfig(nx=256, ny=256, steps=100)).to_numpy()
        ref = os.path.join(tmp, "ref.dat")
        write_dat(ref, grid)
        with open(path, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(),
                  "the sharded CLI's .dat differs from the one-block grid")
        check(read_dat(path).shape == (256, 256), "read_dat shape")
    emit({"phase": "cli_sharded", "ok": True,
          "stdout": proc.stdout.strip().splitlines()})


def _interior_cells(origin, shape, grid):
    """Cells of the block ``shape`` at ``origin`` in the grid's interior."""
    rows = (min(origin[0] + shape[0], grid[0] - 1) - max(origin[0], 1))
    cols = (min(origin[1] + shape[1], grid[1] - 1) - max(origin[1], 1))
    return max(rows, 0) * max(cols, 0)


# The device time of G-uni's deferred bulk and of G-fuse monolithic at the
# main path's block before the register-blocked step loop (E's column
# walk; NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6).
G_UNI_EARLIER_MS = 1.263
G_FUSE_EARLIER_MS = 1.335


def _g_timing_rows(dev, dtype):
    """ms a launch of each G kernel at the main path's block (16384 x 8192
    of the 32768^2 plate on (2, 4), K = 8, no residual, as the rounds
    between check windows launch them) at storage ``dtype`` (its bfloat16
    forms for bfloat16), by CUDA events and the profiler's device time,
    its plain version, its bound (each input read once and each output
    written once, at the dtype's bytes a cell) and a yardstick (``conv2d``
    in the dtype, chained K times, TF32 off): G-uni's deferred bulk (the
    main path's launch), G-fuse's form as the same bulk, G-uni, G-fuse,
    G-circ and G monolithic, the band's launch over the 8 blocks. Returns
    the rows and the blocks, spares, exchange and origins they ran on."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate2D
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs_f32
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k = params().g_k_default
    grid = (SHARD_N, SHARD_N)
    mesh = HeatMesh(SHARD_MESH, dev)
    bx, by = mesh.block_shape(grid)
    plate = HeatPlate2D(*grid)
    us = [plate.init_block(dev, mesh.origin(b, (bx, by)), (bx, by), dtype)
          for b in range(mesh.size)]
    xch = temporal.DeepExchange2D(mesh, (bx, by), k, dev, dtype)
    xch.phase1(us)
    xch.phase2(us)
    b = mesh.index((1, 1))
    o = mesh.origin(b, (bx, by))
    kw = dict(origin=o, grid_shape=grid, cx=CX, cy=CY)
    tail, hn, hs = xch.pieces(b)
    ext_c = us[b].new_empty((bx + 2 * k, by + 2 * k))
    ext_p = torch.empty_like(ext_c)
    xch.assemble_circular(b, us[b], ext_c)
    xch.assemble_padded(b, us[b], ext_p)
    v = torch.empty_like(us[b])
    a0, cx, cy = coeffs_f32(CX, CY)
    w = torch.tensor([[0.0, cx, 0.0], [cy, a0, cy], [0.0, cx, 0.0]],
                     dtype=dtype, device=dev).view(1, 1, 3, 3)

    def conv_steps(x):
        for _ in range(k):
            x = F.conv2d(x, w)
        return x

    frame = ext_p.view(1, 1, bx + 2 * k, by + 2 * k)
    lead = ext_p[k:k + bx].contiguous().view(1, 1, bx, by + 2 * k)
    # Every block's two band windows, (3K) x (by + 2K) of its padded
    # frame, for the band launch's yardstick.
    origins = [mesh.origin(i, (bx, by)) for i in range(mesh.size)]
    bands = ext_p.new_empty((2 * mesh.size, 1, 3 * k, by + 2 * k))
    padded = torch.empty_like(ext_p)
    for i in range(mesh.size):
        xch.assemble_padded(i, us[i], padded)
        bands[2 * i, 0] = padded[:3 * k]
        bands[2 * i + 1, 0] = padded[bx - k:]
    del padded
    vs = [torch.empty_like(u) for u in us]
    band_launch = skb.BandLaunch(us, xch.tail, xch.halo_n, xch.halo_s, vs,
                                 k, origins=origins, grid_shape=grid, cx=CX,
                                 cy=CY)
    band = skb.entry(skb.BAND, dtype)
    check(band_launch.name == band and band_launch.load == "rows",
          f"the main path's band launch is {band_launch.name}, "
          f"{band_launch.load} load, not {band}'s row load")
    e = us[b].element_size()  # bytes a cell
    piece_bytes = e * (bx * 2 * k + 2 * k * (by + 2 * k))
    ops = OPS_PER_CELL_STEP * k
    inner = _interior_cells(o, (bx, by), grid)
    bulk_inner = _interior_cells((o[0] + k, o[1]), (bx - 2 * k, by), grid)
    band_inner = sum(
        _interior_cells(oi, (bx, by), grid)
        - _interior_cells((oi[0] + k, oi[1]), (bx - 2 * k, by), grid)
        for oi in origins)
    bulk = (e * (bx * by + bx * 2 * k + (bx - 2 * k) * by), ops * bulk_inner)
    mono = (e * 2 * bx * by + piece_bytes, ops * inner)
    assembled = (e * ((bx + 2 * k) * (by + 2 * k) + bx * by), ops * inner)
    name = {kind: skb.entry(n, dtype) for kind, n in skb.KERNEL_OF.items()}
    timed = {
        # The main path's launch of G-uni: the deferred bulk.
        name["G-uni"]: (
            lambda: skb.block_uniform(us[b], tail, None, None, v, k, False,
                                      **kw),
            lambda: skb.block_uniform_plain(us[b], tail, None, None, v, k,
                                            False, **kw),
            lambda: conv_steps(lead), bulk),
        name["G-uni"] + "@monolithic": (
            lambda: skb.block_uniform(us[b], tail, hn, hs, v, k, False, **kw),
            lambda: skb.block_uniform_plain(us[b], tail, hn, hs, v, k, False,
                                            **kw),
            lambda: conv_steps(frame), mono),
        # G-fuse's form as the same bulk: its per-cell loads against
        # G-uni's 16-byte copies.
        name["G-fuse"] + "@bulk": (
            lambda: skb.block_fused(us[b], tail, None, None, v, k, False,
                                    **kw),
            lambda: skb.block_fused_plain(us[b], tail, None, None, v, k,
                                          False, **kw),
            lambda: conv_steps(lead), bulk),
        name["G-fuse"]: (
            lambda: skb.block_fused(us[b], tail, hn, hs, v, k, False, **kw),
            lambda: skb.block_fused_plain(us[b], tail, hn, hs, v, k, False,
                                          **kw),
            lambda: conv_steps(frame), mono),
        name["G-circ"]: (
            lambda: skb.block_circular(ext_c, v, k, False, **kw),
            lambda: skb.block_circular_plain(ext_c, v, k, False, **kw),
            lambda: conv_steps(frame), assembled),
        name["G"]: (
            lambda: skb.block_padded(ext_p, v, k, False, **kw),
            lambda: skb.block_padded_plain(ext_p, v, k, False, **kw),
            lambda: conv_steps(frame), assembled),
        # The round's band launch: every block's bands at once.
        band: (
            lambda: band_launch(False),
            lambda: skb.band_fix_blocks_plain(
                us, xch.tail, xch.halo_n, xch.halo_s, vs, k, False,
                origins=origins, grid_shape=grid, cx=CX, cy=CY),
            lambda: conv_steps(bands),
            (mesh.size * e * (2 * 2 * k * by + 2 * 2 * k * 2 * k
                              + 2 * k * (by + 2 * k) + 2 * k * by),
             ops * band_inner)),
    }
    rows = {}
    for key, (kernel, plain, library, (nbytes, nops)) in timed.items():
        rows[key] = {"block": [bx, by], "k": k, "dtype": str(dtype),
                     "ms": _time_ms(kernel, 20, 3),
                     "plain_ms": _time_ms(plain, 2, 1),
                     "library_ms": _time_ms(library, 5, 1),
                     **_bound(nbytes, nops)}
        rows[key].update(_device_ms(kernel, key.split("@")[0]))
    rows[band].update(blocks=mesh.size, load=band_launch.load)
    return rows, (mesh, us, vs, xch, origins, grid, k, ext_c)


def _round_ms(xch, us, vs, grid):
    """ms of one whole round of the blocks by CUDA events under each
    schedule: overlap (phase 1, the bulks, phase 2, one band launch) and
    phase (both phases, the monolithic launches)."""
    from parallel_heat_tpu_torch.parallel import temporal

    out = {}
    for mode in ("overlap", "phase"):
        round_fn = temporal._cuda_round_2d(xch, "G-uni", mode,
                                           grid_shape=grid, cx=CX, cy=CY)
        out[mode] = _time_ms(lambda: round_fn(us, vs, False), 10, 2)
    return out


def phase_timing_g(dev):
    """The G kernels' rows at the main path's block (:func:`_g_timing_rows`
    in float32), beside their earlier designs' device times; the band's
    per-block design (one launch a block); the exchange's and an
    assembly's own times; whole rounds of the 8 blocks under each
    schedule and the device operations the host issues a round."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel import temporal

    rows, (mesh, us, vs, xch, origins, grid, k, ext_c) = _g_timing_rows(
        dev, torch.float32)

    def exchange():
        xch.phase1(us)
        xch.phase2(us)

    exchange_ms = _time_ms(exchange, 20, 2)
    b = mesh.index((1, 1))
    assemble_ms = _time_ms(lambda: xch.assemble_circular(b, us[b], ext_c),
                           10, 2)
    rows["heat_g_block_uniform"]["earlier_design_device_ms"] = \
        G_UNI_EARLIER_MS
    rows["heat_g_block_fused"]["earlier_design_device_ms"] = \
        G_FUSE_EARLIER_MS
    # The per-block design, one launch a block (a one-entry table): its
    # device time summed over the 8 blocks and its events for the 8.
    band = rows["heat_g_band_fix"]
    band["earlier_design_device_ms"] = sum(
        _device_ms(lambda i=i: skb.band_fix(
            us[i], *xch.pieces(i), vs[i], k, False, origin=origins[i],
            grid_shape=grid, cx=CX, cy=CY), "heat_g_band_fix")["device_ms"]
        for i in range(mesh.size))
    band["earlier_design_ms"] = _time_ms(lambda: [skb.band_fix(
        us[i], *xch.pieces(i), vs[i], k, False, origin=origins[i],
        grid_shape=grid, cx=CX, cy=CY) for i in range(mesh.size)], 20, 3)
    # Whole rounds by events, and the device operations (kernels, copies,
    # memsets) the host issues a round, by the profiler.
    round_ms = _round_ms(xch, us, vs, grid)
    host_ops = {}
    for mode in ("overlap", "phase"):
        round_fn = temporal._cuda_round_2d(xch, "G-uni", mode,
                                           grid_shape=grid, cx=CX, cy=CY)
        _, per = _profiled(lambda: [round_fn(us, vs, False)
                                    for _ in range(5)])
        host_ops[mode] = sum(n for _, n in per.values()) / 5
    bx, by = us[0].shape
    del us, vs, xch, ext_c
    torch.cuda.empty_cache()
    emit({"phase": "timing_g", "kernels": rows,
          "exchange_ms_per_round": exchange_ms,
          "assemble_ms_per_block": assemble_ms,
          "round_ms": round_ms,
          "host_launches_per_round": host_ops,
          "redundant_cell_share": 2 * k * (bx + by + 2 * k) / (bx * by),
          "band_share_of_cells": 2 * k / bx})
    return {name: row for name, row in rows.items() if "@" not in name}


# ---------------------------------------------------------------------------
# The sharded 2D path at bfloat16 (the G family's bfloat16 forms)
# ---------------------------------------------------------------------------

# The sharded 2D kernels' bfloat16 forms (ops/stencil_kernels_block.py
# KERNEL_OF_BF16, BAND_BF16), each with its library's source and the TPU
# builder it replaces (its dtype_name="bfloat16" form).
KERNELS_G_BF16 = {
    "heat_g_block_uniform_bf16": ("heat_g_block_uniform", TPU + ":1827"),
    "heat_g_block_fused_bf16": ("heat_g_block_fused", TPU + ":1560"),
    "heat_g_block_circular_bf16": ("heat_g_block_circular", TPU + ":1343"),
    "heat_g_block_padded_bf16": ("heat_g_block_padded", TPU + ":1135"),
    "heat_g_band_fix_bf16": ("heat_g_band_fix", TPU + ":2093"),
}
# The tile kinds of csrc/heat_g.cuh every check grid's blocks run
# (hopper_params.g_tile_kinds, as phase_kernels_g counts them).
G_TILE_KINDS = ("inside", "block_edge", "ragged_rows", "ragged_cols",
                "global_edge")


def phase_kernels_g_bf16(dev):
    """The bfloat16 forms of G-uni, G-fuse, G-circ, G and the band on the
    card, each bit for bit its plain version on the same inputs, the other
    forms and E's bfloat16 K steps of the global grid, at every compiled K
    (1 .. g_k_max) on 500 x 256 blocks (G-uni's form), 500 x 252 (a width
    of 4k but not 8k: G-uni's form refused, G-fuse's taken) and 500 x 250
    (a last group cut short), at K = 8 on the main path's 16384 x 8192
    blocks and on 16 x 24 blocks (exactly 2K rows: the bulk empty); each
    grid's blocks running every tile kind they are there for; the bulk
    plus the band bit for bit the monolithic form; the band's one launch
    under each load the blocks take; every grid seeded with NaNs of
    payloads no conversion makes, on the ring and inside. Returns max
    |diff| each (0.0)."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    err = {name: 0.0 for name in KERNELS_G_BF16}
    err["band loads"] = set()
    p = params()
    every_k = list(range(1, p.g_k_max() + 1))
    kw = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    plan = [((SHARD_N, SHARD_N), SHARD_MESH, [p.g_k_default], [0, 6],
             G_TILE_KINDS),
            ((CONV, 1024), SHARD_CONV, every_k, list(range(8)),
             G_TILE_KINDS),
            ((CONV, 1008), SHARD_CONV, every_k, list(range(8)),
             G_TILE_KINDS),
            ((CONV, CONV), SHARD_CONV, every_k, list(range(8)),
             G_TILE_KINDS + ("partial_group",)),
            ((32, 48), (2, 2), [8], list(range(4)),
             ("block_edge", "global_edge"))]
    report, nan_res = [], {}
    for seed, (grid, mesh_shape, ks, blocks, need) in enumerate(plan):
        g = _rand_bf16(dev, grid, 40 + seed, nan=True)
        mesh = HeatMesh(mesh_shape, dev)
        us = mesh.split(g)
        bx, by = mesh.block_shape(grid)
        tiles = {}
        for k in ks:
            kinds = dict.fromkeys(need, 0)
            for b in blocks:
                o = mesh.origin(b, (bx, by))
                counted = [p.g_tile_kinds((bx, by), k, origin=o,
                                          grid_shape=grid)]
                if bx >= 2 * k:
                    counted += [
                        p.g_tile_kinds((bx, by), k, [(k, bx - 2 * k)],
                                       origin=o, grid_shape=grid),
                        p.g_tile_kinds((bx, by), k, [(0, k), (bx - k, k)],
                                       (k, p.g_band_tile_x), o, grid)]
                for c in counted:
                    for kind in need:
                        kinds[kind] += c[kind]
            check(all(kinds.values()), f"the bfloat16 check blocks of "
                  f"{grid} on {mesh_shape} at K={k} run no tile of some "
                  f"kind they are there for: {kinds}")
            tiles[k] = kinds
            xch = temporal.DeepExchange2D(mesh, (bx, by), k, dev,
                                          torch.bfloat16)
            xch.phase1(us)
            xch.phase2(us)
            e_out = torch.empty_like(g)
            sk.temporal_steps(g, e_out, k, False, **kw)
            res = [_check_g_block(dev, xch, b, us, k,
                                  dict(grid_shape=grid, **kw), e_out, err)
                   for b in blocks]
            nan_res[f"{grid} K={k}"] = float(torch.stack(res).amax())
            del e_out
            if bx >= 2 * k:
                _check_band_blocks(dev, mesh, us, xch, k,
                                   dict(grid_shape=grid, **kw), err)
            del xch
        report.append({"grid": list(grid), "mesh": list(mesh_shape),
                       "block": [bx, by], "k": ks, "blocks": blocks,
                       "tile_kinds": tiles})
        del g, us
        torch.cuda.empty_cache()
    loads = sorted(err.pop("band loads"))
    check(loads == ["cells", "rows"], f"the bfloat16 band launches checked "
          f"took the loads {loads}, not both")
    emit({"phase": "kernels_g_bf16", "ok": True, "coeffs": kw,
          "checks": report, "residual_max": nan_res, "max_abs_err": err,
          "band_loads": loads, "nan_seeded": True,
          "bitwise_plain_each_other_and_e": True,
          "deferred_plus_band_is_monolithic": True})
    return err


def phase_sharded_main_path_bf16():
    """BASELINE's north star at config 4's dtype: 32768^2 bfloat16 on a
    (2, 4) mesh, 200 steps, by the default resolution (K = 8, overlap:
    G-uni's bfloat16 bulk and the bfloat16 band), the phase schedule and
    G-fuse, G-circ and G pinned; the counts set to 0 before each run and
    read after, exactly each run's launches; every grid bit for bit the
    one-block bfloat16 run (E-uni's form). Then 1000^2 on (2, 4) to eps
    (blocks 250 wide: G-fuse's form) with the one-block run's steps_run,
    converged, residual and grid; the 32768^2 mesh run's stream in chunks
    of 40 at pipeline depth 2, bit for bit solve(); float64 on the torch
    rounds at 1024^2 on (2, 4) and 64^3 on (2, 2, 2), bit for bit their
    one-block runs, no kernel launched; the CLI with --mesh 2,4 --dtype
    bfloat16, the one-block run's .dat bytes. Returns each kernel's
    launches."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, explain, solve
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.solver import solve_stream
    from parallel_heat_tpu_torch.utils.io import write_dat

    k = params().g_k_default
    one_cfg = HeatConfig(nx=SHARD_N, ny=SHARD_N, steps=MAIN_STEPS,
                         dtype="bfloat16")
    cfg = one_cfg.replace(mesh_shape=SHARD_MESH)
    resolved = explain(cfg)
    check(resolved["halo_depth"] == f"{k} (auto)"
          and resolved["halo_overlap"] == "overlap (auto)"
          and resolved["decided_by"]["block_temporal_2d"]["choice"]
          == "G-uni" and "heat_g_block_uniform_bf16" in resolved["path"],
          f"32768^2 bf16 on (2, 4) resolved to {resolved}")
    one = solve(one_cfg)
    check(one.grid.dtype == torch.bfloat16
          and bool(torch.isfinite(one.grid).all()),
          "the one-block 32768^2 bf16 grid is not finite bfloat16")
    cells = SHARD_N * SHARD_N * MAIN_STEPS / 1e6
    n = (MAIN_STEPS // k) * math.prod(SHARD_MESH)
    rounds = MAIN_STEPS // k
    runs = [("default", cfg, None, {"heat_g_block_uniform_bf16": n,
                                     "heat_g_band_fix_bf16": rounds}),
            ("phase", cfg.replace(halo_overlap="phase"), None,
             {"heat_g_block_uniform_bf16": n}),
            ("G-fuse", cfg, "G-fuse", {"heat_g_block_fused_bf16": n,
                                       "heat_g_band_fix_bf16": rounds}),
            ("G-circ", cfg, "G-circ", {"heat_g_block_circular_bf16": n}),
            ("G", cfg, "G", {"heat_g_block_padded_bf16": n})]
    out, launches = {}, {}
    for label, c, force, expect in runs:
        res, counts = _sharded_run(c, expect, f"32768^2 bf16 (2, 4) {label}",
                                   force)
        check(res.steps_run == MAIN_STEPS and res.grid.dtype == torch.bfloat16
              and _bits_equal(res.grid, one.grid),
              f"32768^2 bf16 (2, 4) {label} differs from the one-block run")
        out[label] = {"elapsed_s": res.elapsed_s,
                      "mcells_steps_per_s": cells / res.elapsed_s,
                      "launches": {name: counts[name] for name in expect}}
        if label != "phase":
            for name in expect:
                launches.setdefault(name, counts[name])
        del res
        torch.cuda.empty_cache()
    busy = _busy(lambda: solve(cfg), "32768^2 bf16 (2, 4) profiled")
    # The stream of the default run, chunks of 40 at pipeline depth 2.
    seen = []
    for r in solve_stream(cfg, chunk_steps=40, pipeline_depth=2):
        seen.append(r.steps_run)
        last = r.grid
    check(seen == list(range(40, MAIN_STEPS + 1, 40))
          and _bits_equal(last, one.grid),
          f"32768^2 bf16 (2, 4) stream yields {seen}, bitwise "
          f"{_bits_equal(last, one.grid)}")
    one_s = one.elapsed_s
    del one, last
    torch.cuda.empty_cache()
    # 1000^2 on (2, 4) to eps from values in [0, 1): blocks of 500 x 250,
    # G-fuse's bfloat16 form, rounds of 8 + 8 + 4 a window of 20.
    init = torch.from_numpy(np.random.default_rng(31).uniform(
        0, 1, (CONV, CONV)).astype(np.float32)).to(torch.bfloat16)
    ccfg = HeatConfig(nx=CONV, ny=CONV, steps=2000, converge=True, eps=0.01,
                      check_interval=WINDOW, dtype="bfloat16")
    cone = solve(ccfg, initial=init)
    windows = cone.steps_run // WINDOW
    sk.reset_counts()
    cmesh = solve(ccfg.replace(mesh_shape=SHARD_CONV), initial=init)
    counts = {name: c for name, c in sk.counts.items() if c}
    check(counts == {"heat_g_block_fused_bf16": windows * 3 * 8,
                     "heat_g_band_fix_bf16": windows * 3},
          f"1000^2 bf16 (2, 4) converge: counts {counts} for {windows} "
          f"windows")
    check((cmesh.steps_run, cmesh.converged) == (cone.steps_run,
                                                  cone.converged)
          and same_float(cmesh.residual, cone.residual)
          and _bits_equal(cmesh.grid, cone.grid),
          f"1000^2 bf16 (2, 4) converge: {cmesh.steps_run} steps, "
          f"{cmesh.converged}, {cmesh.residual}; one block: "
          f"{cone.steps_run}, {cone.converged}, {cone.residual}")
    converge = {"steps_run": cmesh.steps_run, "converged": cmesh.converged,
                "residual": cmesh.residual, "elapsed_s": cmesh.elapsed_s,
                "one_block_elapsed_s": cone.elapsed_s, "launches": counts}
    # float64 on the torch rounds: no kernel, bit for bit one block.
    f64 = {}
    for label, c in (("1024^2 (2, 4)", HeatConfig(
            nx=1024, ny=1024, steps=MAIN_STEPS, dtype="float64",
            mesh_shape=SHARD_MESH)),
                     ("64^3 (2, 2, 2)", HeatConfig(
                         nx=64, ny=64, nz=64, steps=MAIN_STEPS,
                         dtype="float64", mesh_shape=(2, 2, 2)))):
        ref = solve(c.replace(mesh_shape=None))
        sk.reset_counts()
        res = solve(c)
        ran = {name: n for name, n in sk.counts.items() if n}
        check(not ran and res.grid.dtype == torch.float64
              and _bits_equal(res.grid, ref.grid),
              f"{label} float64: counts {ran}, bitwise "
              f"{_bits_equal(res.grid, ref.grid)}")
        f64[label] = {"elapsed_s": res.elapsed_s,
                      "one_block_elapsed_s": ref.elapsed_s,
                      "explain": explain(c)["path"]}
    # The CLI on a (2, 4) mesh at bfloat16: the one-block run's bytes.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.dat")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx",
               "1024", "--ny", "1024", "--steps", "100", "--mesh", "2,4",
               "--dtype", "bfloat16", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"bf16 sharded CLI exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "ref.dat")
        write_dat(ref, solve(HeatConfig(nx=1024, ny=1024, steps=100,
                                        dtype="bfloat16")).grid.cpu())
        with open(path, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(), "the bf16 sharded CLI's .dat "
                                        "differs from the one-block grid")
    emit({"phase": "sharded_main_path_bf16", "ok": True,
          "shape": [SHARD_N, SHARD_N], "mesh": list(SHARD_MESH),
          "dtype": "bfloat16", "steps": MAIN_STEPS,
          "resolved": resolved["path"],
          "one_block": {"elapsed_s": one_s,
                        "mcells_steps_per_s": cells / one_s},
          "runs": out, "bitwise_one_block": True,
          "profiled_default": busy,
          "stream": {"chunk_steps": 40, "pipeline_depth": 2, "yields": seen,
                     "bitwise_solve": True},
          "converge_1000_2x4": converge, "float64_torch_rounds": f64,
          "cli": proc.stdout.strip().splitlines()})
    return launches


def _timing_g_bf16(dev):
    """The bfloat16 forms' rows at the main path's block
    (:func:`_g_timing_rows` at bfloat16: bounds at 2 B a cell, the
    yardstick ``conv2d`` in bfloat16), and whole bfloat16 rounds of the 8
    blocks under each schedule."""
    import torch

    rows, (_, us, vs, xch, _, grid, _, _) = _g_timing_rows(dev,
                                                           torch.bfloat16)
    rows["heat_g_block_uniform_bf16"]["round_ms"] = _round_ms(xch, us, vs,
                                                              grid)
    del us, vs, xch
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The sharded 3D path (kernels H-fused, H and the 3D band fix)
# ---------------------------------------------------------------------------

def _check_h_block(dev, xch, b, us, k, kw, f_out, err):
    """Every H form at depth ``k`` on block ``b`` (the exchange ``xch`` has
    run all three phases) against its plain version, the others and
    ``heat_f_temporal3d``'s K steps of the global grid on the same cells;
    and, where x is sharded and the block has 2K x-planes, the deferred
    bulk plus the band, spliced in place, against the monolithic kernel,
    grid and max residual."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    bs = tuple(us[b].shape)
    o = xch.mesh.origin(b, bs)
    h_kw = dict(origin=o, **kw)
    want = f_out[tuple(slice(a, a + n) for a, n in zip(o, bs))]
    # H on a contiguous circular block (rows of bz + 2hz floats: the
    # cp.async load where that is no multiple of 4) and on the padded one
    # the round assembles (new_circular: both loads).
    ext = torch.empty(xch.circular_shape, device=dev)
    xch.assemble_circular(b, us[b], ext)
    padded = xch.new_circular()
    xch.assemble_circular(b, us[b], padded)
    pieces = xch.pieces(b)
    where = f"(K={k}) on block {o} of {kw['grid_shape']} {kw}"
    # H-fused under each plane load its geometry takes: cp.async always,
    # TMA where skb3.h_load chooses it.
    loads = ["cp.async"] + (["tma"] if skb3.h_load(bs, k, us[b]) == "tma"
                            else [])
    if "tma" in loads:   # the rule holds a tile inside the block
        check(params().h_tiles(bs, k)[0] > 0,
              f"the TMA load at K={k} on a {bs} block runs in no tile")
    runs = {
        **{("heat_h_block_3d_fused", load): (
            lambda out, r, load=load: skb3.h_block_fused(
                us[b], *pieces, out, k, r, load=load, **h_kw),
            lambda out: skb3.h_block_fused_plain(us[b], *pieces, out, k,
                                                 **h_kw))
           for load in loads},
        **{("heat_h_block_3d", f"{load} {what}"): (
            lambda out, r, e=e, load=load: skb3.h_block(e, out, k, r,
                                                        load=load, **h_kw),
            lambda out: skb3.h_block_plain(ext, out, k, **h_kw))
           for what, e, load in (("contiguous", ext, skb3.h_block_load(ext)),
                                 ("padded", padded, "cp.async"),
                                 ("padded", padded, "tma"))}}
    first = None
    for (name, load), (launch, plain) in runs.items():
        where = (f"(K={k}, {load} load) on block {o} of {kw['grid_shape']} "
                 f"{kw}" if load else f"(K={k}) on block {o} of "
                 f"{kw['grid_shape']} {kw}")
        got, ref, nores = (torch.empty(bs, device=dev) for _ in range(3))
        r = launch(got, True)
        launch(nores, False)
        rp = plain(ref)
        torch.cuda.synchronize()
        d = max(float((got - ref).abs().max()),
                float((got - want).abs().max()))
        err[name] = max(err[name], d)
        check(torch.equal(got, ref) and same_float(r, rp),
              f"{name}{where} != its plain version: max diff {d}, "
              f"residual {float(r)} vs {float(rp)}")
        check(torch.equal(got, want),
              f"{name}{where} != heat_f_temporal3d(K={k}) on the global grid")
        check(torch.equal(got, nores),
              f"{name}{where}: grid depends on with_residual")
        if first is None:
            first = (got, r)
        check(same_float(r, first[1]), f"{name}{where}: residual {float(r)} "
              f"differs from H-fused's {float(first[1])}")
    where = f"(K={k}) on block {o} of {kw['grid_shape']} {kw}"
    if xch.halos[0] and bs[0] >= 2 * k:
        zt, yt, _, _ = pieces
        plain = torch.full(bs, float("nan"), device=dev)
        rpb = skb3.h_block_fused_plain(us[b], zt, yt, None, None, plain, k,
                                       defer_x=True, **h_kw)
        rpf = skb3.h_band_fix_plain(us[b], *pieces, plain, k, **h_kw)
        for load in loads:
            split = torch.full(bs, float("nan"), device=dev)
            rb = skb3.h_block_fused(us[b], zt, yt, None, None, split, k,
                                    True, defer_x=True, load=load, **h_kw)
            check(bool(torch.isnan(split[:k]).all()
                       and torch.isnan(split[bs[0] - k:]).all()),
                  f"the deferred bulk ({load} load){where} wrote a band "
                  f"plane")
            rf = skb3.h_band_fix(us[b], *pieces, split, k, True, **h_kw)
            torch.cuda.synchronize()
            err["heat_h_band_fix_3d"] = max(err["heat_h_band_fix_3d"], float(
                (split - plain).nan_to_num(float("inf")).abs().max()))
            check(torch.equal(split, plain) and same_float(rb, rpb)
                  and same_float(rf, rpf),
                  f"deferred bulk ({load} load) or band{where} != its plain "
                  f"version")
            check(torch.equal(split, first[0])
                  and same_float(torch.maximum(rb, rf), first[1]),
                  f"deferred bulk ({load} load) + band{where} != the "
                  f"monolithic kernel (residuals {float(rb)}, {float(rf)} "
                  f"vs {float(first[1])})")
    return loads


def _check_h_band_blocks(dev, xch, us, k, kw, f_out, err):
    """The band kernel over every block of ``xch``'s mesh in one launch
    (the exchange has run all three phases), under each load the blocks
    take (the 4-byte one always, the 16-byte one where it fits), into
    NaN-filled outputs: against each
    block's plain version, the batched plain version and kernel F's K
    steps of the global grid on the band planes, nothing written between
    the bands; and the round's deferred bulks plus that one launch against
    the monolithic kernel, grids and max residual. Returns the loads
    run."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3

    mesh = xch.mesh
    bs = tuple(us[0].shape)
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
    nan = float("nan")
    one = [torch.full(bs, nan, device=dev) for _ in us]
    rs = [skb3.h_band_fix_plain(us[b], *xch.pieces(b), one[b], k,
                                origin=origins[b], **kw)
          for b in range(mesh.size)]
    plain = [torch.full(bs, nan, device=dev) for _ in us]
    rp = skb3.band_fix_blocks_3d_plain(us, *pieces, plain, k, True,
                                       origins=origins, **kw)
    check(same_float(rp, torch.stack(rs).amax())
          and all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                  for a, b in zip(plain, one)),
          f"the batched plain band != the per-block plain versions on "
          f"{mesh.size} blocks {bs} (K={k})")
    del one
    picked = skb3.BandLaunch3D(us, *pieces, plain, k, origins=origins,
                               **kw).load
    loads = sorted({"cells", picked})
    for load in loads:
        got = [torch.full(bs, nan, device=dev) for _ in us]
        r = skb3.BandLaunch3D(us, *pieces, got, k, origins=origins,
                              load=load, **kw)(True)
        torch.cuda.synchronize()
        where = (f"the band kernel ({load} load) over the {mesh.size} "
                 f"blocks {bs} of {kw['grid_shape']} at K={k} {kw}")
        for b, (a, c) in enumerate(zip(got, plain)):
            a7 = a.nan_to_num(7.0)
            err["heat_h_band_fix_3d"] = max(err["heat_h_band_fix_3d"], float(
                (a7 - c.nan_to_num(7.0)).abs().max()))
            check(torch.equal(a7, c.nan_to_num(7.0)),
                  f"{where} != the plain versions on block {b}")
            want = f_out[tuple(slice(o, o + n)
                               for o, n in zip(origins[b], bs))]
            check(torch.equal(a[:k], want[:k])
                  and torch.equal(a[bs[0] - k:], want[bs[0] - k:]),
                  f"{where} != heat_f_temporal3d(K={k}) on block {b}'s "
                  f"band planes")
            check(bool(a[k:bs[0] - k].isnan().all()),
                  f"{where} wrote planes between the bands of block {b}")
        check(same_float(r, rp), f"{where}: residual {float(r)} != the "
              f"plain versions' {float(rp)}")
        del got
    # A round of deferred bulks plus the one band launch, against the
    # monolithic kernel on every block.
    split = [torch.full(bs, nan, device=dev) for _ in us]
    mono = torch.empty(bs, device=dev)
    rb, rm = [], []
    for b in range(mesh.size):
        zt, yt, _, _ = xch.pieces(b)
        rb.append(skb3.h_block_fused(us[b], zt, yt, None, None, split[b], k,
                                     True, defer_x=True, origin=origins[b],
                                     **kw))
    rb.append(skb3.BandLaunch3D(us, *pieces, split, k, origins=origins,
                                **kw)(True))
    for b in range(mesh.size):
        rm.append(skb3.h_block_fused(us[b], *xch.pieces(b), mono, k, True,
                                     origin=origins[b], **kw))
        check(torch.equal(split[b], mono),
              f"deferred bulk + the band launch != the monolithic kernel "
              f"on block {b} of {mesh.size} blocks {bs} (K={k})")
    check(same_float(torch.stack(rb).amax(), torch.stack(rm).amax()),
          f"max(bulks, band) {float(torch.stack(rb).amax())} != the "
          f"monolithic residual {float(torch.stack(rm).amax())} on "
          f"{mesh.size} blocks {bs} (K={k})")
    del split, mono, plain
    return loads


def phase_kernels_h(dev):
    """The three H kernels against their plain versions, each other and
    kernel F, on blocks cut from seeded random global grids with the
    exchange pieces built by the port's own exchange; returns max |diff|
    each."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    ks = sorted({1, 3, p.h_k_default, p.h_k_max()})
    every_k = list(range(1, p.h_k_max() + 1))
    err = {name: 0.0 for name in KERNELS_H}
    equal = dict(cx=CX, cy=CY, cz=CX)
    unequal = dict(zip(("cx", "cy", "cz"), UNEQUAL_3D))
    gen = torch.Generator(device=dev).manual_seed(5)
    # (mesh, block, depths, blocks, coefficient sets, does H-fused take
    # the TMA load): the main path's 512^3 blocks of 1024^3 (two
    # corners); a ragged (3, 3, 3) mesh, its corner, edge, face and
    # interior blocks: 67 x 43 x 90 (the cp.async load only: bz % 4 != 0
    # and no tile inside the block) and 67 x 128 x 92 (both loads, every
    # compiled K: the TMA load runs in the tiles inside a block, and a
    # block holds one where it has 2w - 3K cells along each axis, w the
    # extended tile's 64 x 32); blocks of 6 x-planes (2K at K = 3: an
    # empty bulk; under 2K beyond), 6 x 50 x 70 and 6 x 128 x 72; a
    # z-free (2, 4, 1) mesh, 40 x 33 x 97 and 40 x 128 x 96; and an
    # x-free (1, 2, 2) mesh whose blocks hold no inner tile (cp.async
    # only).
    # H (F's plane loop) runs at every compiled K on 67 x 128 x 92,
    # 6 x 128 x 72 (K <= 6, its x extent), 40 x 128 x 96 and 20 x 128 x
    # 252, whose tiles past the first row and column of each block take
    # the box load (bz > 120 - 2 pad, or z unsharded), under both loads.
    h_every = list(range(1, p.hc_k_max() + 1))
    plan = [(SHARD3_MESH, (SHARD3_N // 2,) * 3, [p.h_k_default], [0, 7],
             [equal], True),
            ((3, 3, 3), (67, 43, 90), ks, [0, 9, 12, 13], [equal, unequal],
             False),
            ((3, 3, 3), (67, 128, 92), every_k, [0, 9, 12, 13], [unequal],
             True),
            ((3, 3, 3), (20, 128, 252), h_every, [0, 13, 26], [unequal],
             True),
            ((2, 2, 2), (6, 50, 70), [1, 3, 6], list(range(8)), [unequal],
             False),
            ((2, 2, 2), (6, 128, 72), [k for k in h_every if k <= 6],
             list(range(8)), [unequal], True),
            ((2, 4, 1), (40, 33, 97), ks, [0, 5], [unequal], False),
            ((2, 4, 1), (40, 128, 96), h_every, [0, 5], [unequal], True),
            ((1, 2, 2), (50, 30, 40), [2, 5], [0, 3], [unequal], False)]
    h_kinds = {}
    band_kinds = {}
    band_loads, band_runs = set(), 0
    report = []
    for mesh_shape, block, depths, blocks, coeff_sets, tma in plan:
        grid = tuple(m * b for m, b in zip(mesh_shape, block))
        g = torch.randn(grid, generator=gen, device=dev) * 10
        mesh = HeatMesh(mesh_shape, dev)
        us = mesh.split(g)
        loads_by_k = {}
        for k in depths:
            xch = temporal3d.DeepExchange3D(mesh, block, k, dev)
            xch.lead(us)
            xch.last(us)
            for coeffs in coeff_sets:
                f_out = torch.empty_like(g)
                sk3.xslab_steps_3d(g, f_out, k, **coeffs)
                if (xch.halos[0] and block[0] >= 2 * k
                        and coeffs is coeff_sets[-1]):
                    band_loads.update(_check_h_band_blocks(
                        dev, xch, us, k, dict(grid_shape=grid, **coeffs),
                        f_out, err))
                    band_runs += 1
                for b in blocks:
                    loads = _check_h_block(dev, xch, b, us, k,
                                           dict(grid_shape=grid, **coeffs),
                                           f_out, err)
                    check(("tma" in loads) == tma,
                          f"H-fused's loads {loads} at K={k} on a {block} "
                          f"block: the TMA load expected {tma}")
                    loads_by_k[str(k)] = loads
                    for kind, n in p.hc_tile_kinds(
                            block, k, xch.halos, mesh.origin(b, block),
                            grid).items():
                        h_kinds[kind] = h_kinds.get(kind, 0) + n
                    if xch.halos[0] and block[0] >= 2 * k:
                        for kind, n in p.h_band_tile_kinds(
                                block, k, xch.halos, mesh.origin(b, block),
                                grid).items():
                            band_kinds[kind] = band_kinds.get(kind, 0) + n
                del f_out
            del xch
        report.append({"grid": list(grid), "mesh": list(mesh_shape),
                       "block": list(block), "k": depths, "blocks": blocks,
                       "coeffs": coeff_sets, "fused_loads": loads_by_k,
                       "bitwise_plain_each_other_and_f": True,
                       "deferred_plus_band_is_monolithic": True})
        del g, us
        torch.cuda.empty_cache()
    # Every kind of H's tiles ran: boxed (the TMA load) and wrapped (the
    # lo pieces by cp.async), at the grid's edge and inside it, past each
    # side of a block, ragged and with a partial last group.
    missing = sorted(kind for kind, n in h_kinds.items() if n == 0)
    check(not missing, f"kernels_h: no H tile of the kinds {missing} ran "
                       f"({h_kinds})")
    # And every kind of the band's tiles, under each of its loads.
    missing = sorted(kind for kind, n in band_kinds.items() if n == 0)
    check(not missing and band_loads == set(skb3.BAND_LOADS_3D),
          f"kernels_h: no band tile of the kinds {missing} ran "
          f"({band_kinds}), or the loads {sorted(band_loads)} ran")
    # Diverging blocks: one NaN next to the faces of corner block 0 of
    # 80^3 (40^3 blocks: the cp.async load), and of 40 x 256 x 256, whose
    # 20 x 128 x 128 blocks hold tiles inside them (the TMA load), with a
    # second NaN in such a tile (output rows [58, 116) and columns
    # [26, 52) at K = 3).
    k = p.h_k_default
    nan_res = {}
    for grid, nans, load in (((80, 80, 80), [(2, 3, 1)], "cp.async"),
                             ((40, 256, 256), [(2, 3, 1), (2, 70, 40)],
                              "tma")):
        g = torch.randn(grid, generator=gen, device=dev) * 10
        for c in nans:
            g[c] = float("nan")
        mesh = HeatMesh(SHARD3_MESH, dev)
        us = mesh.split(g)
        bs = tuple(us[0].shape)
        xch = temporal3d.DeepExchange3D(mesh, bs, k, dev)
        xch.lead(us)
        xch.last(us)
        kw = dict(origin=(0, 0, 0), grid_shape=grid, **equal)
        ext = torch.empty(xch.circular_shape, device=dev)
        xch.assemble_circular(0, us[0], ext)
        padded = xch.new_circular()
        xch.assemble_circular(0, us[0], padded)
        check(skb3.h_load(bs, k, us[0]) == load
              and (p.h_tiles(bs, k)[0] > 0) == (load == "tma"),
              f"the NaN-seeded {bs} block should take the {load} load")
        plain = torch.empty_like(us[0])
        skb3.h_block_fused_plain(us[0], *xch.pieces(0), plain, k, **kw)
        for name, launch in (
                ("heat_h_block_3d_fused", lambda o: skb3.h_block_fused(
                    us[0], *xch.pieces(0), o, k, True, **kw)),
                ("heat_h_block_3d_fused@cp.async",
                 lambda o: skb3.h_block_fused(us[0], *xch.pieces(0), o, k,
                                              True, load="cp.async", **kw)),
                ("heat_h_block_3d", lambda o: skb3.h_block(ext, o, k, True,
                                                           **kw)),
                ("heat_h_block_3d@tma", lambda o: skb3.h_block(
                    padded, o, k, True, load="tma", **kw)),
                ("heat_h_band_fix_3d", lambda o: skb3.h_band_fix(
                    us[0], *xch.pieces(0), o, k, True, **kw))):
            out = torch.empty_like(us[0])
            key = f"{name}@{'x'.join(map(str, bs))}"
            nan_res[key] = float(launch(out))
            check(math.isnan(nan_res[key]), f"NaN-seeded block gave {key} "
                  f"residual {nan_res[key]}, not NaN")
            check(torch.equal(out[0], us[0][0])
                  and torch.equal(out[:k, 0], us[0][:k, 0])
                  and torch.equal(out[:k, :, 0], us[0][:k, :, 0]),
                  f"a diverging block moved a Dirichlet face ({key})")
            if name != "heat_h_band_fix_3d":   # the band writes 2K planes
                check(torch.equal(out.nan_to_num(7.0),
                                  plain.nan_to_num(7.0)),
                      f"a diverging block: {key} != its plain version")
        del g, us, xch, ext, padded, plain
        torch.cuda.empty_cache()
    emit({"phase": "kernels_h", "ok": True, "checks": report,
          "h_tile_kinds": h_kinds, "band_tile_kinds": band_kinds,
          "band_launches_checked": band_runs,
          "band_loads": sorted(band_loads), "nan_residual": nan_res,
          "max_abs_err": err})
    return err


# ---------------------------------------------------------------------------
# The sharded 3D family's bfloat16 forms (H-fused, H and the 3D band)
# ---------------------------------------------------------------------------

def _d_chain_bf16(sk3, g, k, kw):
    """K launches of heat_d_step3d_bf16 on the global grid ``g``: the grid
    (the last level) and the last step's residual."""
    import torch

    u, r = g, None
    for _ in range(k):
        out = torch.empty_like(u)
        r = sk3.slab_step_3d(u, out, **kw)
        u = out
    return u, r


def _check_h_block_bf16(dev, xch, b, us, k, kw, want, want_res, err):
    """Every bfloat16 H form at depth ``k`` on block ``b`` (the bfloat16
    exchange ``xch`` has run all three phases), into NaN-filled outputs:
    H-fused (its one load), H on the contiguous circular block and on the
    padded one under both loads; each bitwise its plain version, the
    others and ``want``, the K launches of heat_d_step3d_bf16 (and F's
    bfloat16 K steps) on the same cells; its grid independent of
    with_residual; and where x is sharded and the block has 2K x-planes,
    the deferred bulk plus the band, spliced in place, bitwise the
    monolithic form, grid and max residual. Returns the block's
    residual."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3

    bs = tuple(us[b].shape)
    o = xch.mesh.origin(b, bs)
    h_kw = dict(origin=o, **kw)
    cell = want[tuple(slice(a, a + n) for a, n in zip(o, bs))]
    contiguous = torch.empty(xch.circular_shape, dtype=torch.bfloat16,
                             device=dev)
    xch.assemble_circular(b, us[b], contiguous)
    padded = xch.new_circular()
    xch.assemble_circular(b, us[b], padded)
    check(skb3.h_block_load(padded) == "tma",
          f"the padded bfloat16 circular block {tuple(padded.stride())} "
          f"takes no TMA load")
    pieces = xch.pieces(b)
    nan = float("nan")
    runs = {
        ("heat_h_block_3d_fused_bf16", "plain"): (
            lambda out, r: skb3.h_block_fused(us[b], *pieces, out, k, r,
                                              **h_kw),
            lambda out: skb3.h_block_fused_plain(us[b], *pieces, out, k,
                                                 **h_kw)),
        **{("heat_h_block_3d_bf16", f"{load} {what}"): (
            lambda out, r, e=e, load=load: skb3.h_block(e, out, k, r,
                                                        load=load, **h_kw),
            lambda out, e=e: skb3.h_block_plain(e, out, k, **h_kw))
           for what, e, load in (
               ("contiguous", contiguous, skb3.h_block_load(contiguous)),
               ("padded", padded, "cp.async"), ("padded", padded, "tma"))}}
    first = None
    for (name, load), (launch, plain) in runs.items():
        where = (f"{name} (K={k}, {load}) on block {o} of "
                 f"{kw['grid_shape']} {kw}")
        got, ref, nores = (torch.full(bs, nan, dtype=torch.bfloat16,
                                      device=dev) for _ in range(3))
        r = launch(got, True)
        launch(nores, False)
        rp = plain(ref)
        torch.cuda.synchronize()
        d = float((got.float() - ref.float()).abs().nan_to_num(0).max())
        err[name] = max(err[name], d)
        check(_bits_equal(got, ref) and same_float(r, rp),
              f"{where} != its plain version: max diff {d}, residual "
              f"{float(r)} vs {float(rp)}")
        check(_bits_equal(got, cell), f"{where} != {k} launches of "
              f"heat_d_step3d_bf16 on the global grid")
        check(_bits_equal(got, nores),
              f"{where}: grid depends on with_residual")
        first = r if first is None else first
        check(same_float(r, first), f"{where}: residual {float(r)} differs "
              f"from H-fused's {float(first)}")
    if xch.halos[0] and bs[0] >= 2 * k:
        zt, yt, _, _ = pieces
        split = torch.full(bs, nan, dtype=torch.bfloat16, device=dev)
        rb = skb3.h_block_fused(us[b], zt, yt, None, None, split, k, True,
                                defer_x=True, **h_kw)
        torch.cuda.synchronize()
        check(bool(split[:k].isnan().all()
                   and split[bs[0] - k:].isnan().all()),
              f"the bfloat16 deferred bulk (K={k}) on block {o} wrote a "
              f"band plane")
        rf = skb3.h_band_fix(us[b], *pieces, split, k, True, **h_kw)
        torch.cuda.synchronize()
        err["heat_h_band_fix_3d_bf16"] = max(
            err["heat_h_band_fix_3d_bf16"],
            float((split.float() - cell.float()).abs().nan_to_num(0).max()))
        check(_bits_equal(split, cell)
              and same_float(torch.maximum(rb, rf), first),
              f"the bfloat16 deferred bulk + band (K={k}) on block {o} != "
              f"the monolithic form (residuals {float(rb)}, {float(rf)} vs "
              f"{float(first)})")
    del contiguous, padded
    return first


def _check_h_band_blocks_bf16(dev, xch, us, k, kw, want, err):
    """The bfloat16 band over every block of ``xch``'s mesh in one launch,
    under each load the blocks take (``cells`` always, ``vec`` where
    bz % 8 == 0), into NaN-filled outputs: bitwise the batched plain
    version and ``want`` on the band planes, nothing written between the
    bands. Returns the loads run."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3

    mesh = xch.mesh
    bs = tuple(us[0].shape)
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
    nan = float("nan")

    def fresh():
        return [torch.full(bs, nan, dtype=torch.bfloat16, device=dev)
                for _ in us]

    plain = fresh()
    rp = skb3.band_fix_blocks_3d_plain(us, *pieces, plain, k, True,
                                       origins=origins, **kw)
    picked = skb3.BandLaunch3D(us, *pieces, plain, k, origins=origins,
                               **kw).load
    loads = sorted({"cells", picked})
    for load in loads:
        got = fresh()
        launch = skb3.BandLaunch3D(us, *pieces, got, k, origins=origins,
                                   load=load, **kw)
        check(launch.name == "heat_h_band_fix_3d_bf16",
              f"a bfloat16 band launches {launch.name}")
        r = launch(True)
        torch.cuda.synchronize()
        where = (f"the bfloat16 band ({load} load) over the {mesh.size} "
                 f"blocks {bs} of {kw['grid_shape']} at K={k}")
        for b, (a, c) in enumerate(zip(got, plain)):
            cell = want[tuple(slice(o, o + n)
                              for o, n in zip(origins[b], bs))]
            err["heat_h_band_fix_3d_bf16"] = max(
                err["heat_h_band_fix_3d_bf16"],
                float((a.float() - c.float()).abs().nan_to_num(0).max()))
            check(_bits_equal(a, c), f"{where} != the plain version on "
                                     f"block {b}")
            check(_bits_equal(a[:k], cell[:k])
                  and _bits_equal(a[bs[0] - k:], cell[bs[0] - k:]),
                  f"{where} != heat_d_step3d_bf16's K steps on block {b}'s "
                  f"band planes")
            check(bool(a[k:bs[0] - k].isnan().all()),
                  f"{where} wrote planes between the bands of block {b}")
        check(same_float(r, rp), f"{where}: residual {float(r)} != the "
              f"plain version's {float(rp)}")
        del got
    del plain
    return loads


def phase_kernels_h_bf16(dev):
    """The bfloat16 forms of H-fused, H and the 3D band on the card, each
    bit for bit its plain version, the other forms, F's bfloat16 K steps
    and K launches of ``heat_d_step3d_bf16`` on the same cells of the
    global grid: at the main path's 512^3 blocks of 1024^3 (K = 3); at
    every compiled K on 67 x 128 x 92 ((3, 3, 3)), 20 x 128 x 252
    ((3, 3, 3)), 6 x 128 x 72 ((2, 2, 2), K <= 6) and 40 x 128 x 96
    ((2, 4, 1)); at K = 1, 3, 6 on 6 x 50 x 70 ((2, 2, 2): lanes that
    straddle the z tail); on contiguous and padded circular blocks; every
    tile kind of H (``hc_tile_kinds`` at 2-byte cells) and of the band
    (``h_band_tile_kinds``) asserted run; the bulk plus the band bit for
    bit the monolithic form; the band's one launch under both loads; and
    NaN-seeded 80^3 and 40 x 256 x 256 on (2, 2, 2) (40^3 and 20 x 128 x
    128 blocks: payloads kept, NaN residuals, faces bit for bit). Returns
    max |diff| each (0.0)."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    err = {name: 0.0 for name in KERNELS_H_BF16}
    every_k = list(range(1, p.h_k_max() + 1))
    h_every = list(range(1, p.hc_k_max(2) + 1))
    kw3 = dict(zip(("cx", "cy", "cz"), UNEQUAL_3D))
    plan = [(SHARD3_MESH, (SHARD3_N // 2,) * 3, [p.h_k_default], [0, 7],
             False),
            ((3, 3, 3), (67, 128, 92), every_k, [0, 9, 12, 13], False),
            ((3, 3, 3), (20, 128, 252), h_every, [0, 13, 26], False),
            ((2, 2, 2), (6, 128, 72), [k for k in h_every if k <= 6],
             list(range(8)), False),
            ((2, 4, 1), (40, 128, 96), h_every, [0, 5], False),
            ((2, 2, 2), (6, 50, 70), [1, 3, 6], list(range(8)), False),
            (SHARD3_MESH, (40, 40, 40), [p.h_k_default], list(range(8)),
             True),
            (SHARD3_MESH, (20, 128, 128), [p.h_k_default], list(range(8)),
             True)]
    h_kinds, band_kinds = {}, {}
    band_loads, report, nan_res = set(), [], {}
    for seed, (mesh_shape, block, depths, blocks, nan) in enumerate(plan):
        grid = tuple(m * n for m, n in zip(mesh_shape, block))
        g = _rand_bf16_3d(dev, grid, 60 + seed, nan=nan)
        mesh = HeatMesh(mesh_shape, dev)
        us = mesh.split(g)
        kw = dict(grid_shape=grid, **kw3)
        for k in depths:
            want, want_res = _d_chain_bf16(sk3, g, k, kw3)
            f_out = torch.empty_like(g)
            rf = sk3.xslab_steps_3d(g, f_out, k, True, **kw3)
            check(_bits_equal(f_out, want) and same_float(rf, want_res),
                  f"heat_f_temporal3d_bf16(K={k}) on {grid} != {k} launches "
                  f"of heat_d_step3d_bf16")
            del f_out
            xch = temporal3d.DeepExchange3D(mesh, block, k, dev,
                                            torch.bfloat16)
            xch.lead(us)
            xch.last(us)
            res = [_check_h_block_bf16(dev, xch, b, us, k, kw, want,
                                       want_res, err) for b in blocks]
            if len(blocks) == mesh.size:
                check(same_float(torch.stack(res).amax(), want_res),
                      f"the bfloat16 blocks' residual on {grid} at K={k} != "
                      f"the D chain's {float(want_res)}")
            if nan:
                key = f"{'x'.join(map(str, block))} K={k}"
                nan_res[key] = float(torch.stack(res).amax())
                check(math.isnan(nan_res[key]) and _faces_kept(want, g),
                      f"the NaN-seeded {block} blocks gave a residual "
                      f"{nan_res[key]}, or a face moved")
            if xch.halos[0] and block[0] >= 2 * k:
                band_loads.update(_check_h_band_blocks_bf16(
                    dev, xch, us, k, kw, want, err))
            for b in blocks:
                o = mesh.origin(b, block)
                for kind, n in p.hc_tile_kinds(block, k, xch.halos, o, grid,
                                               elem=2).items():
                    h_kinds[kind] = h_kinds.get(kind, 0) + n
                if xch.halos[0] and block[0] >= 2 * k:
                    for kind, n in p.h_band_tile_kinds(
                            block, k, xch.halos, o, grid, elem=2).items():
                        band_kinds[kind] = band_kinds.get(kind, 0) + n
            del want, xch
        report.append({"grid": list(grid), "mesh": list(mesh_shape),
                       "block": list(block), "k": depths, "blocks": blocks,
                       "nan_seeded": nan})
        del g, us
        torch.cuda.empty_cache()
    missing = sorted(kind for kind, n in h_kinds.items() if n == 0)
    check(not missing, f"kernels_h_bf16: no H tile of the kinds {missing} "
                       f"ran ({h_kinds})")
    missing = sorted(kind for kind, n in band_kinds.items() if n == 0)
    check(not missing and band_loads == set(skb3.BAND_LOADS_3D),
          f"kernels_h_bf16: no band tile of the kinds {missing} ran "
          f"({band_kinds}), or the loads {sorted(band_loads)} ran")
    emit({"phase": "kernels_h_bf16", "ok": True, "coeffs": kw3,
          "checks": report, "h_tile_kinds": h_kinds,
          "band_tile_kinds": band_kinds, "band_loads": sorted(band_loads),
          "nan_residual": nan_res, "max_abs_err": err,
          "bitwise_plain_each_other_f_and_d_chain": True,
          "deferred_plus_band_is_monolithic": True})
    return err


def _sharded_run_3d(cfg, expect, label, force=None):
    """solve(cfg) with the counts set to 0 just before and read just
    after, pinned at site block_temporal_3d when ``force`` is given; the
    launches must be exactly ``expect``."""
    from parallel_heat_tpu_torch import solve, tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    sk.reset_counts()
    if force is None:
        res = solve(cfg)
    else:
        with tune.force("block_temporal_3d", force):
            res = solve(cfg)
    counts = dict(sk.counts)
    for name, n in counts.items():
        check(n == expect.get(name, 0),
              f"{label}: {name} ran {n} times, {expect.get(name, 0)} "
              f"expected")
    return res, counts


def phase_sharded_main_path_3d():
    """1024^3 on (2, 2, 2), 200 steps: the default resolution (H-fused,
    monolithic), the phase schedule, pinned H and H-defer, every grid
    bitwise the one-block F run; then 512^3 on (2, 2, 2) and on (2, 4, 1)
    (there also with H pinned), bitwise their one-block runs. Returns each
    H kernel's launches."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, explain, solve
    from parallel_heat_tpu_torch.ops.hopper_params import params

    k = params().h_k_default
    n = SHARD3_N
    one_cfg = HeatConfig(nx=n, ny=n, nz=n, steps=MAIN_STEPS)
    cfg = one_cfg.replace(mesh_shape=SHARD3_MESH)
    resolved = explain(cfg)
    check(resolved["halo_depth"] == f"{k} (auto)"
          and resolved["decided_by"]["block_temporal_3d"]["choice"]
          == "H-fused", f"{n}^3 on {SHARD3_MESH} resolved to {resolved}")
    one = solve(one_cfg)
    check(bool(torch.isfinite(one.grid).all()), "non-finite 3D grid")
    cells = n ** 3 * MAIN_STEPS / 1e6
    blocks = math.prod(SHARD3_MESH)
    rounds = -(-MAIN_STEPS // k)
    per = rounds * blocks
    runs = [("default", cfg, None, {"heat_h_block_3d_fused": per}),
            ("phase", cfg.replace(halo_overlap="phase"), None,
             {"heat_h_block_3d_fused": per}),
            ("H", cfg, "H", {"heat_h_block_3d": per}),
            ("H-defer", cfg, "H-defer", {"heat_h_block_3d_fused": per,
                                         "heat_h_band_fix_3d": rounds})]
    out, launches = {}, {}
    one_s = one.elapsed_s
    for label, c, force, expect in runs:
        res, counts = _sharded_run_3d(c, expect, f"{n}^3 {label}", force)
        check(res.steps_run == MAIN_STEPS
              and tuple(res.grid.shape) == (n,) * 3,
              f"{n}^3 {label}: {res.steps_run} steps, shape "
              f"{tuple(res.grid.shape)}")
        check(torch.equal(res.grid, one.grid),
              f"{n}^3 on {SHARD3_MESH} {label} differs from the one-block "
              f"run")
        out[label] = {"elapsed_s": res.elapsed_s,
                      "mcells_steps_per_s": cells / res.elapsed_s,
                      "ratio_to_one_block": res.elapsed_s / one_s,
                      "launches": {name: counts[name] for name in expect}}
        if label != "phase":
            for name in expect:
                launches.setdefault(name, counts[name])
        del res
        torch.cuda.empty_cache()
    del one
    torch.cuda.empty_cache()
    busy = _busy(lambda: solve(cfg), f"{n}^3 on {SHARD3_MESH} profiled")
    busy_one = _busy(lambda: solve(one_cfg), f"{n}^3 one block profiled")
    # 512^3 on (2, 2, 2) (256^3 blocks, the JAX package's flagship block)
    # and on the z-free (2, 4, 1), there also with H pinned.
    small = {}
    cube = HeatConfig(nx=CUBE, ny=CUBE, nz=CUBE, steps=MAIN_STEPS)
    ref = solve(cube)
    for mesh_shape, force in (((2, 2, 2), None), ((2, 4, 1), None),
                              ((2, 4, 1), "H")):
        label = f"{CUBE}^3 on {mesh_shape}" + (f", {force} pinned"
                                               if force else "")
        kernel = "heat_h_block_3d" if force else "heat_h_block_3d_fused"
        res, counts = _sharded_run_3d(
            cube.replace(mesh_shape=mesh_shape),
            {kernel: rounds * math.prod(mesh_shape)}, label, force)
        check(torch.equal(res.grid, ref.grid),
              f"{label} differs from the one-block run")
        small[label] = {"elapsed_s": res.elapsed_s,
                        "mcells_steps_per_s":
                            CUBE ** 3 * MAIN_STEPS / 1e6 / res.elapsed_s,
                        "ratio_to_one_block": res.elapsed_s / ref.elapsed_s,
                        "one_block_elapsed_s": ref.elapsed_s}
        del res
    del ref
    torch.cuda.empty_cache()
    emit({"phase": "sharded_main_path_3d", "ok": True,
          "shape": [n] * 3, "mesh": list(SHARD3_MESH),
          "block": [n // d for d in SHARD3_MESH], "steps": MAIN_STEPS,
          "k": k, "resolved": resolved["path"],
          "one_block": {"elapsed_s": one_s,
                        "mcells_steps_per_s": cells / one_s},
          "runs": out, "bitwise_one_block": True,
          "profiled_default": busy, "profiled_one_block": busy_one,
          "cube_512": small})
    return launches


def phase_sharded_converge_3d():
    """Converge mode and depth 1 on a 3D mesh, each identical to its
    one-block run: 64^3 on (2, 2, 2) (rounds of 3 + ... + 2 a window), 10^3
    on (2, 2, 2) (blocks of 5: the auto depth is capped at the block;
    converges at step 360) and 64^3 at halo depth 1 (H at K = 1)."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.ops.hopper_params import params

    k = params().h_k_default
    base = dict(converge=True, check_interval=WINDOW, eps=1e-3,
                mesh_shape=SHARD3_MESH)
    per_window = -(-WINDOW // k) * 8
    cases = [
        ("64^3 (2, 2, 2)", HeatConfig(nx=64, ny=64, nz=64, steps=2000,
                                      **base),
         {"heat_h_block_3d_fused": 2000 // WINDOW * per_window}),
        ("10^3 (2, 2, 2)", HeatConfig(nx=10, ny=10, nz=10, steps=5000,
                                      **base),
         {"heat_h_block_3d_fused": 360 // WINDOW * per_window}),
        ("64^3 (2, 2, 2) depth 1", HeatConfig(nx=64, ny=64, nz=64,
                                              steps=MAIN_STEPS,
                                              mesh_shape=SHARD3_MESH,
                                              halo_depth=1),
         {"heat_h_block_3d_fused": MAIN_STEPS * 8})]
    out = {}
    for label, cfg, expect in cases:
        one = solve(cfg.replace(mesh_shape=None, halo_depth=None))
        res, _ = _sharded_run_3d(cfg, expect, label)
        check((res.steps_run, res.converged) == (one.steps_run, one.converged)
              and same_float(res.residual if res.residual is not None
                             else 0.0,
                             one.residual if one.residual is not None
                             else 0.0)
              and torch.equal(res.grid, one.grid),
              f"{label}: {res.steps_run} steps, converged {res.converged}, "
              f"residual {res.residual}; one block: {one.steps_run}, "
              f"{one.converged}, {one.residual}")
        out[label] = {"steps_run": res.steps_run,
                      "converged": res.converged, "residual": res.residual,
                      "elapsed_s": res.elapsed_s,
                      "one_block_elapsed_s": one.elapsed_s,
                      "launches": expect}
    check(out["10^3 (2, 2, 2)"]["steps_run"] == 360
          and out["10^3 (2, 2, 2)"]["converged"],
          f"10^3 on (2, 2, 2) did not converge at step 360: {out}")
    emit({"phase": "sharded_converge_3d", "ok": True, **out,
          "identical_to_one_block": True})


def phase_cli_sharded_3d():
    """The CLI on a (2, 2, 2) mesh writes the one-block grid."""
    from parallel_heat_tpu_torch import HeatConfig, solve

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh3d.npy")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "64",
               "--ny", "64", "--nz", "64", "--steps", "100", "--mesh",
               "2,2,2", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"3D sharded CLI exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        grid = solve(HeatConfig(nx=64, ny=64, nz=64, steps=100)).to_numpy()
        check(np.array_equal(np.load(path), grid),
              "the 3D sharded CLI's .npy differs from the one-block grid")
    emit({"phase": "cli_sharded_3d", "ok": True,
          "stdout": proc.stdout.strip().splitlines()})


def phase_sharded_main_path_3d_bf16():
    """1024^3 bfloat16 on (2, 2, 2), 200 steps: the default resolution
    (K = 3, H-fused's bfloat16 form, monolithic), the phase schedule, H
    and H-defer pinned (the bfloat16 band once a round), the counts set to
    0 before each run and read after, exactly each run's launches; every
    grid bit for bit the one-block bfloat16 run (kernel F's bfloat16
    form); the default run's stream in chunks of 40 at pipeline depth 2,
    bit for bit solve(). Then 512^3 bfloat16 on (2, 4, 1) bit for bit its
    one-block run; 64^3 bfloat16 on (2, 2, 2) to eps with the one-block
    run's steps_run, converged, residual and grid; and the CLI with
    --mesh 2,2,2 --dtype bfloat16 at 64^3, the one-block run's .npy
    bytes. Returns each bfloat16 H kernel's launches."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, explain, solve
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.solver import solve_stream
    from parallel_heat_tpu_torch.utils.io import save_npy

    k = params().h_k_default
    n = SHARD3_N
    one_cfg = HeatConfig(nx=n, ny=n, nz=n, steps=MAIN_STEPS,
                         dtype="bfloat16")
    cfg = one_cfg.replace(mesh_shape=SHARD3_MESH)
    resolved = explain(cfg)
    check(resolved["halo_depth"] == f"{k} (auto)"
          and resolved["decided_by"]["block_temporal_3d"]["choice"]
          == "H-fused" and "heat_h_block_3d_fused_bf16" in resolved["path"],
          f"{n}^3 bf16 on {SHARD3_MESH} resolved to {resolved}")
    one = solve(one_cfg)
    check(one.grid.dtype == torch.bfloat16
          and bool(torch.isfinite(one.grid).all()),
          f"the one-block {n}^3 bf16 grid is not finite bfloat16")
    cells = n ** 3 * MAIN_STEPS / 1e6
    blocks = math.prod(SHARD3_MESH)
    rounds = -(-MAIN_STEPS // k)
    per = rounds * blocks
    fused, band = "heat_h_block_3d_fused_bf16", "heat_h_band_fix_3d_bf16"
    runs = [("default", cfg, None, {fused: per}),
            ("phase", cfg.replace(halo_overlap="phase"), None, {fused: per}),
            ("H", cfg, "H", {"heat_h_block_3d_bf16": per}),
            ("H-defer", cfg.replace(halo_overlap="overlap"), "H-defer",
             {fused: per, band: rounds})]
    out, launches = {}, {}
    one_s = one.elapsed_s
    for label, c, force, expect in runs:
        res, counts = _sharded_run_3d(c, expect, f"{n}^3 bf16 {label}",
                                      force)
        check(res.steps_run == MAIN_STEPS and res.grid.dtype == torch.bfloat16
              and _bits_equal(res.grid, one.grid),
              f"{n}^3 bf16 on {SHARD3_MESH} {label} differs from the "
              f"one-block run")
        out[label] = {"elapsed_s": res.elapsed_s,
                      "mcells_steps_per_s": cells / res.elapsed_s,
                      "ratio_to_one_block": res.elapsed_s / one_s,
                      "launches": {name: counts[name] for name in expect}}
        if label != "phase":
            for name in expect:
                launches.setdefault(name, counts[name])
        del res
        torch.cuda.empty_cache()
    busy = _busy(lambda: solve(cfg), f"{n}^3 bf16 on {SHARD3_MESH} profiled")
    seen = []
    for r in solve_stream(cfg, chunk_steps=40, pipeline_depth=2):
        seen.append(r.steps_run)
        last = r.grid
    check(seen == list(range(40, MAIN_STEPS + 1, 40))
          and _bits_equal(last, one.grid),
          f"{n}^3 bf16 on {SHARD3_MESH} stream yields {seen}, bitwise "
          f"{_bits_equal(last, one.grid)}")
    del one, last
    torch.cuda.empty_cache()
    # 512^3 on the z-free (2, 4, 1).
    cube = HeatConfig(nx=CUBE, ny=CUBE, nz=CUBE, steps=MAIN_STEPS,
                      dtype="bfloat16")
    ref = solve(cube)
    res, _ = _sharded_run_3d(cube.replace(mesh_shape=(2, 4, 1)),
                             {fused: rounds * 8}, f"{CUBE}^3 bf16 (2, 4, 1)")
    check(_bits_equal(res.grid, ref.grid),
          f"{CUBE}^3 bf16 on (2, 4, 1) differs from the one-block run")
    small = {"elapsed_s": res.elapsed_s,
             "one_block_elapsed_s": ref.elapsed_s,
             "ratio_to_one_block": res.elapsed_s / ref.elapsed_s}
    del res, ref
    torch.cuda.empty_cache()
    # 64^3 on (2, 2, 2) to eps from values in [0, 1): rounds of 3 + ... +
    # 2 a window of 20; at bfloat16 the residual stops at 2^-9 (an ulp at
    # 0.5), which eps = 2e-3 is just above.
    init = torch.from_numpy(np.random.default_rng(32).uniform(
        0, 1, (64, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    ccfg = HeatConfig(nx=64, ny=64, nz=64, steps=2000, converge=True,
                      eps=2e-3, check_interval=WINDOW, dtype="bfloat16")
    cone = solve(ccfg, initial=init)
    windows = cone.steps_run // WINDOW
    sk.reset_counts()
    cmesh = solve(ccfg.replace(mesh_shape=SHARD3_MESH), initial=init)
    counts = {name: c for name, c in sk.counts.items() if c}
    check(cone.converged and counts == {fused: windows * -(-WINDOW // k) * 8},
          f"64^3 bf16 (2, 2, 2) converge: counts {counts} for {windows} "
          f"windows, converged {cone.converged}")
    check((cmesh.steps_run, cmesh.converged) == (cone.steps_run,
                                                  cone.converged)
          and same_float(cmesh.residual, cone.residual)
          and _bits_equal(cmesh.grid, cone.grid),
          f"64^3 bf16 (2, 2, 2) converge: {cmesh.steps_run} steps, "
          f"{cmesh.converged}, {cmesh.residual}; one block: "
          f"{cone.steps_run}, {cone.converged}, {cone.residual}")
    converge = {"steps_run": cmesh.steps_run, "converged": cmesh.converged,
                "residual": cmesh.residual, "elapsed_s": cmesh.elapsed_s,
                "one_block_elapsed_s": cone.elapsed_s, "launches": counts}
    # The CLI on (2, 2, 2) at bfloat16: the one-block run's .npy bytes.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh3d.npy")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "64",
               "--ny", "64", "--nz", "64", "--steps", "100", "--mesh",
               "2,2,2", "--dtype", "bfloat16", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"bf16 3D sharded CLI exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "ref.npy")
        save_npy(ref, solve(HeatConfig(nx=64, ny=64, nz=64, steps=100,
                                       dtype="bfloat16")).grid.cpu())
        with open(path, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(), "the bf16 3D sharded CLI's .npy "
                                        "differs from the one-block grid")
    emit({"phase": "sharded_main_path_3d_bf16", "ok": True,
          "shape": [n] * 3, "mesh": list(SHARD3_MESH), "dtype": "bfloat16",
          "block": [n // d for d in SHARD3_MESH], "steps": MAIN_STEPS,
          "k": k, "resolved": resolved["path"],
          "one_block": {"elapsed_s": one_s,
                        "mcells_steps_per_s": cells / one_s},
          "runs": out, "bitwise_one_block": True, "profiled_default": busy,
          "stream": {"chunk_steps": 40, "pipeline_depth": 2, "yields": seen,
                     "bitwise_solve": True},
          "cube_512_2x4x1": small, "converge_64_2x2x2": converge,
          "cli": proc.stdout.strip().splitlines()})
    return launches


# ---------------------------------------------------------------------------
# The device loop: converge windows, implicit V-cycles and sharded rounds
# replayed as graphs, the stop test on the card
# ---------------------------------------------------------------------------

# The runs the device loop is measured on: the converge path's 1000^2
# under A, the implicit path's 512^2 (both schemes, IMP_STEPS), 1000^2 on
# (2, 4) to eps, 64^3 on (2, 2, 2) to eps, and the sharded main paths
# (MAIN_STEPS fixed steps); then the cases that stop the loop each way:
# 20^2 (converges at step 1980), 16^2 past the stability bound (NaN at
# step 140) and 10^3 on (2, 2, 2) (converges at step 360).
LOOP_COPIES = (1, 4, 16, 64)     # the window copies measured at 1000^2


def _loop_runs():
    conv = dict(converge=True, check_interval=WINDOW, eps=1e-3)
    imp = dict(nx=IMP_N, ny=IMP_N, cx=IMP_C, cy=IMP_C, steps=IMP_STEPS)
    return [
        ("1000^2 converge A", dict(nx=CONV, ny=CONV, steps=10000, **conv),
         True),
        ("512^2 backward Euler", dict(scheme="backward_euler", **imp), True),
        ("512^2 Crank-Nicolson", dict(scheme="crank_nicolson", **imp),
         True),
        ("1000^2 (2, 4) converge", dict(nx=CONV, ny=CONV, steps=10000,
                                        mesh_shape=SHARD_CONV, **conv),
         True),
        ("64^3 (2, 2, 2) converge", dict(nx=64, ny=64, nz=64, steps=2000,
                                         mesh_shape=SHARD3_MESH, **conv),
         True),
        ("32768^2 (2, 4) fixed", dict(nx=SHARD_N, ny=SHARD_N,
                                      steps=MAIN_STEPS,
                                      mesh_shape=SHARD_MESH), True),
        ("1024^3 (2, 2, 2) fixed", dict(nx=SHARD3_N, ny=SHARD3_N,
                                        nz=SHARD3_N, steps=MAIN_STEPS,
                                        mesh_shape=SHARD3_MESH), True),
        ("20^2 converge", dict(nx=20, ny=20, steps=10000, **conv), False),
        ("16^2 NaN", dict(nx=16, ny=16, cx=0.4, cy=0.4, steps=200, **conv),
         False),
        ("10^3 (2, 2, 2) converge", dict(nx=10, ny=10, nz=10, steps=5000,
                                         mesh_shape=SHARD3_MESH, **conv),
         False)]


def _loop_run(cfg, eager, profile):
    """solve(cfg) through the graphs, or with the eager executor (the
    loop the port ran before: every stop test a host read); the counts,
    stats and peak memory of that run, and with ``profile`` the card's
    idle share of a second, profiled run."""
    import contextlib
    import gc

    import torch

    from parallel_heat_tpu_torch import solve
    from parallel_heat_tpu_torch.ops import multigrid as mg
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.utils import device_loop as dl

    def mode():
        return dl.eager() if eager else contextlib.nullcontext()

    gc.collect()    # an earlier run's buffers, held in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sk.reset_counts()
    mg.reset_stats()
    dl.reset_stats()
    with mode():
        res = solve(cfg)
    out = {"res": res, "counts": {k: n for k, n in sk.counts.items() if n},
           "mg": dict(mg.stats), "dl": dict(dl.stats),
           "peak_mib": (torch.cuda.max_memory_allocated() - held) / 2 ** 20,
           "held_before_mib": held / 2 ** 20}
    if profile:
        with mode():
            out["busy"] = _busy(lambda: solve(cfg), f"{cfg} profiled")
    return out


def _same_bits(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_device_loop():
    """Every run of :func:`_loop_runs` through the graphs and with the
    eager executor, in that order, in this process: steps_run,
    converged, residual, grid (bit for bit, NaN cells included), launch
    counts and V-cycles identical; the graph path's host reads at most
    one a replay of its window copies plus one, none a step in fixed
    mode; each side's elapsed seconds, idle share (profiled), host reads,
    capture seconds, graph nodes and peak memory. Then 1000^2 under A at
    each of LOOP_COPIES window copies a graph."""
    import math

    import torch

    from parallel_heat_tpu_torch import HeatConfig, make_initial_grid
    from parallel_heat_tpu_torch.utils import device_loop as dl

    out = {}
    for label, kw, profile in _loop_runs():
        t0 = time.perf_counter()
        cfg = HeatConfig(**kw)
        g = _loop_run(cfg, False, profile)
        e = _loop_run(cfg, True, profile)
        rg, re_ = g.pop("res"), e.pop("res")
        same = ((rg.steps_run, rg.converged) == (re_.steps_run, re_.converged)
                and (rg.residual == re_.residual
                     or (rg.residual is not None and re_.residual is not None
                         and math.isnan(rg.residual)
                         and math.isnan(re_.residual)))
                and _same_bits(rg.grid, re_.grid))
        check(same, f"device loop {label}: graphs {rg.steps_run} steps, "
                    f"converged {rg.converged}, residual {rg.residual}; "
                    f"eager {re_.steps_run}, {re_.converged}, "
                    f"{re_.residual}, grids equal "
                    f"{_same_bits(rg.grid, re_.grid)}")
        check(g["counts"] == e["counts"]
              and g["mg"]["cycles"] == e["mg"]["cycles"]
              and g["mg"]["steps"] == e["mg"]["steps"],
              f"device loop {label}: counts {g['counts']} {g['mg']} under "
              f"the graphs, {e['counts']} {e['mg']} eager")
        check(g["dl"]["graphs"] >= 1 and g["mg"]["host_syncs"] == 0,
              f"device loop {label}: no graph, or host syncs in the "
              f"V-cycles: {g['dl']} {g['mg']}")
        reads = g["dl"]["reads"]
        if cfg.converge:
            ci = cfg.check_interval
            windows = min(rg.steps_run, cfg.steps // ci * ci) // ci
            copies = (dl.WINDOW_COPIES if cfg.scheme == "explicit" else 2)
            check(reads <= -(-windows // copies) + 1,
                  f"device loop {label}: {reads} host reads for {windows} "
                  f"windows")
        else:
            check(reads <= 1, f"device loop {label}: {reads} host reads "
                              f"in fixed mode")
        if label == "16^2 NaN":
            check(rg.steps_run == 140 and math.isnan(rg.residual),
                  f"16^2 NaN: {rg.steps_run} steps, residual {rg.residual}")
            u0 = make_initial_grid(cfg)
            for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
                check(torch.equal(rg.grid[sl], u0[sl]),
                      "16^2 NaN: a Dirichlet cell moved")
        if label == "20^2 converge":
            check((rg.steps_run, rg.converged) == (1980, True),
                  f"20^2: {rg.steps_run} steps, converged {rg.converged}")
        if label == "10^3 (2, 2, 2) converge":
            check((rg.steps_run, rg.converged) == (360, True),
                  f"10^3 (2, 2, 2): {rg.steps_run} steps, converged "
                  f"{rg.converged}")
        row = {"steps_run": rg.steps_run, "converged": rg.converged,
               "residual": rg.residual, "bitwise": True,
               "launches": g["counts"], "cycles": g["mg"]["cycles"]}
        for side, r, d in (("graph", rg, g), ("eager", re_, e)):
            row[side] = {"elapsed_s": r.elapsed_s,
                         "host_reads": d["dl"]["reads"],
                         "host_reads_per_step": d["dl"]["reads"]
                         / max(r.steps_run, 1),
                         "capture_s": r.capture_s,
                         "graphs": d["dl"]["graphs"],
                         "graph_launches": d["dl"]["launches"],
                         "nodes": d["dl"]["nodes"],
                         "guards": d["dl"]["guards"],
                         "peak_mib": d["peak_mib"],
                         "held_before_mib": d["held_before_mib"]}
            if "busy" in d:
                row[side]["idle_share"] = d["busy"]["idle_share"]
                row[side]["device_busy_ms"] = d["busy"]["device_busy_ms"]
                row[side]["profiled_wall_s"] = d["busy"]["wall_s"]
        if cfg.is_sharded() and not cfg.converge:
            from parallel_heat_tpu_torch import solver

            depth = solver._resolved(cfg, "cuda").halo_depth
            rounds = -(-cfg.steps // depth)
            row["graph"]["ms_a_round"] = rg.elapsed_s * 1e3 / rounds
            row["eager"]["ms_a_round"] = re_.elapsed_s * 1e3 / rounds
        row["phase_s"] = time.perf_counter() - t0
        out[label] = row
        del rg, re_
        torch.cuda.empty_cache()
    # The window copies a graph, measured: 1000^2 under A.
    cfg = HeatConfig(**_loop_runs()[0][1])
    copies = {}
    default = dl.WINDOW_COPIES
    try:
        for n in LOOP_COPIES:
            dl.WINDOW_COPIES = n
            g = _loop_run(cfg, False, False)
            copies[n] = {"elapsed_s": g["res"].elapsed_s,
                         "host_reads": g["dl"]["reads"],
                         "capture_s": g["res"].capture_s,
                         "nodes": g["dl"]["nodes"]}
    finally:
        dl.WINDOW_COPIES = default
    emit({"phase": "device_loop", "ok": True, "route": (
        "torch segment captures chained by csrc/heat_graph_loop.cu: IF "
        "nodes a window copy, a WHILE node a V-cycle loop"),
          "window_copies": default, "runs": out,
          "copies_1000_converge": copies})


# ---------------------------------------------------------------------------
# The stream and its observers
# ---------------------------------------------------------------------------

STREAM_CHUNK = 40        # the main path's stream: chunks of 40 steps,
STREAM_GUARD = 40        # the guard every 40 steps,
STREAM_DIAG = 80         # the diagnostics every 80
OBSERVER_REPS = 20       # launches a CUDA-event timing of an observer


def _stream_idle(prof, kernel):
    """The card's idle share over a stream in a trace: from the start of
    the first launch of ``kernel`` (the stream's first chunk; the setup
    before it is left out) to the end of the last device record, one
    minus the busy time of the records in that span over the span."""
    from torch._C._autograd import DeviceType

    recs = [(e.start_ns(), e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    starts = [t for t, _, name in recs if kernel in name]
    check(starts, f"the trace holds no launch of {kernel}")
    t0 = min(starts)
    t1 = max(t + d for t, d, _ in recs)
    busy = sum(d for t, d, _ in recs if t >= t0)
    return {"idle_share": 1 - busy / (t1 - t0),
            "device_busy_ms": busy / 1e6, "span_ms": (t1 - t0) / 1e6}


def _stream_rows(cfg, chunk, depth, keep_all=True):
    """A stream of ``cfg``: each yield's steps, verdict, residual, guard
    verdict, sample, elapsed and capture seconds, and a copy of its grid
    made before the generator advances (``keep_all``: every one; else
    only the last yield keeps its copy)."""
    from parallel_heat_tpu_torch import solve_stream

    rows = []
    for r in solve_stream(cfg, chunk_steps=chunk, pipeline_depth=depth):
        if rows and not keep_all:
            rows[-1]["grid"] = None
        rows.append({"steps": r.steps_run, "converged": r.converged,
                     "residual": r.residual, "finite": r.finite,
                     "diagnostics": r.diagnostics, "grid": r.grid.clone(),
                     "elapsed_s": r.elapsed_s, "capture_s": r.capture_s})
    return rows


def _stream_timed(cfg, chunk, depth):
    """A stream of ``cfg`` with a telemetry sink and nothing else between
    its yields: its events, and the chunk events' timing fields."""
    from parallel_heat_tpu_torch import solve_stream
    from parallel_heat_tpu_torch.utils.telemetry import Telemetry

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.jsonl")
        with Telemetry(path) as sink:
            for _ in solve_stream(cfg, chunk_steps=chunk, telemetry=sink,
                                  pipeline_depth=depth):
                pass
        with open(path) as f:
            events = [json.loads(line) for line in f]
    chunks = [{k: e.get(k) for k in ("step", "steps", "wall_s", "gap_s",
                                     "dispatch_s", "drain_wait_s",
                                     "observe_s")}
              for e in events if e["event"] == "chunk"]
    return events, chunks


def _stream_profiled(cfg, chunk, depth, kernel):
    """The card's idle share over a stream of ``cfg`` under the
    profiler (``_stream_idle``)."""
    from parallel_heat_tpu_torch import solve_stream
    from parallel_heat_tpu_torch.bench_kernels import TRACE_PAD_S, card_trace

    with card_trace(TRACE_PAD_S) as prof:
        for _ in solve_stream(cfg, chunk_steps=chunk, pipeline_depth=depth):
            pass
    return _stream_idle(prof, kernel)


def _observer_ms(state, prev, origins, cells):
    """The guard's and the diagnostics' device ms on ``state`` (a grid
    or a mesh's blocks) by CUDA events, each beside its byte bound: the
    grid read once (with ``prev``, both grids read once)."""
    from parallel_heat_tpu_torch import solver

    def guard():
        solver._finite_dev(state)

    def stats():
        solver._stats_dev(solver._pairs(state, None, origins))

    def stats_prev():
        solver._stats_dev(solver._pairs(state, prev, origins))

    out = {}
    for name, fn, nbytes in (("guard", guard, 4 * cells),
                             ("grid_stats", stats, 4 * cells),
                             ("grid_stats_prev", stats_prev, 8 * cells)):
        ms = _time_ms(fn, OBSERVER_REPS)
        bound = _bound(nbytes, 0)
        out[name] = {"ms": ms, **bound,
                     "over_bound": ms / bound["bound_ms"]}
    return out


def phase_stream():
    """The stream (``solver.solve_stream``) and its observers on the card
    (see the module docstring, 20c)."""
    import gc

    import torch

    from parallel_heat_tpu_torch import (EnsembleSolver, HeatConfig, HeatMesh,
                                         solve)
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.utils import device_loop as dl
    from parallel_heat_tpu_torch.utils.telemetry import Telemetry

    def same_rows(a, b):
        keys = ("steps", "converged", "residual", "finite", "diagnostics")
        return ([r[k] for k in keys] == [q[k] for k in keys]
                and _same_bits(r["grid"], q["grid"]) for r, q in zip(a, b))

    out = {}
    obs = dict(guard_interval=STREAM_GUARD, diag_interval=STREAM_DIAG)
    # 16384^2 under E-uni at depths 1 and 2.
    t0 = time.perf_counter()
    cfg = HeatConfig(nx=BIG, ny=BIG, steps=MAIN_STEPS, **obs)
    ref = solve(cfg)
    one = _stream_rows(cfg, STREAM_CHUNK, 1)
    two = _stream_rows(cfg, STREAM_CHUNK, 2)
    check(len(one) == len(two) == MAIN_STEPS // STREAM_CHUNK
          and all(same_rows(one, two)),
          f"stream 16384^2: depth 1 {[r['finite'] for r in one]} "
          f"{[r['diagnostics'] for r in one]}, depth 2 "
          f"{[r['finite'] for r in two]} {[r['diagnostics'] for r in two]}, "
          f"grids equal {[_same_bits(a['grid'], b['grid']) for a, b in zip(one, two)]}")
    check(_same_bits(one[-1]["grid"], ref.grid) and ref.finite is True,
          "stream 16384^2: the last grid is not solve()'s")
    check([r["finite"] for r in one] == [True] * len(one)
          and [r["diagnostics"] is not None for r in one]
          == [False, True, False, True, True],
          f"stream 16384^2: guard {[r['finite'] for r in one]}, samples "
          f"{[r['diagnostics'] is not None for r in one]}")
    row = {"bitwise": True, "solve_elapsed_s": ref.elapsed_s,
           "diagnostics": [r["diagnostics"] for r in one]}
    del one, two
    for depth in (1, 2):
        sk.reset_counts()
        events, chunks = _stream_timed(cfg, STREAM_CHUNK, depth)
        launches = {k: n for k, n in sk.counts.items() if n}
        check(launches == {"heat_e_uni_temporal": MAIN_STEPS // 8},
              f"stream 16384^2 depth {depth}: launches {launches}")
        row[f"depth {depth}"] = {
            "elapsed_s": sum(c["wall_s"] for c in chunks), "chunks": chunks,
            **_stream_profiled(cfg, STREAM_CHUNK, depth,
                               "heat_e_uni_temporal")}
    out["16384^2 E-uni"] = row
    # The observers at 16384^2, on the run's grid.
    grid = ref.grid
    out["observers 16384^2"] = _observer_ms(grid, grid.clone(), None,
                                            BIG * BIG)
    row["phase_s"] = time.perf_counter() - t0
    del ref, grid
    # 1000^2 to eps in chunks of 1000 (BASELINE Table 7).
    t0 = time.perf_counter()
    cfg = HeatConfig(nx=CONV, ny=CONV, steps=10000, converge=True,
                     check_interval=WINDOW, eps=1e-3)
    dl.reset_stats()
    ref = solve(cfg)
    ref_reads = dl.stats["reads"]
    dl.reset_stats()
    rows = _stream_rows(cfg, 1000, 1, keep_all=False)
    last = rows[-1]
    check((last["steps"], last["converged"], last["residual"])
          == (ref.steps_run, ref.converged, ref.residual)
          and _same_bits(last["grid"], ref.grid),
          f"stream 1000^2 converge: {last['steps']}, {last['converged']}, "
          f"{last['residual']}; solve() {ref.steps_run}, {ref.converged}, "
          f"{ref.residual}")
    out["1000^2 converge"] = {
        "steps_run": last["steps"], "converged": last["converged"],
        "residual": last["residual"], "bitwise": True, "chunks": len(rows),
        "elapsed_s": last["elapsed_s"], "host_reads": dl.stats["reads"],
        "capture_s": last["capture_s"], "solve_elapsed_s": ref.elapsed_s,
        "solve_host_reads": ref_reads, "solve_capture_s": ref.capture_s,
        "phase_s": time.perf_counter() - t0}
    del rows, last, ref
    # 32768^2 on (2, 4) at depth 2, the guard and the diagnostics.
    t0 = time.perf_counter()
    cfg = HeatConfig(nx=SHARD_N, ny=SHARD_N, steps=MAIN_STEPS,
                     mesh_shape=SHARD_MESH, **obs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rows = _stream_rows(cfg, STREAM_CHUNK, 2, keep_all=False)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    last = rows[-1]
    ref = solve(cfg.replace(guard_interval=None, diag_interval=None))
    check(_same_bits(last["grid"], ref.grid) and last["finite"] is True
          and [r["diagnostics"] is not None for r in rows]
          == [False, True, False, True, True],
          f"stream 32768^2 (2, 4): grids equal "
          f"{_same_bits(last['grid'], ref.grid)}, finite {last['finite']}")
    row = {"bitwise": True, "peak_mib": peak,
           "held_before_mib": held / 2 ** 20,
           "elapsed_s": last["elapsed_s"], "capture_s": last["capture_s"],
           "solve_elapsed_s": ref.elapsed_s,
           "diagnostics": last["diagnostics"]}
    del rows, last
    row["chunks"] = _stream_timed(cfg, STREAM_CHUNK, 2)[1]
    row["phase_s"] = time.perf_counter() - t0
    out["32768^2 (2, 4) depth 2"] = row
    # The observers on the blocks of 32768^2 on (2, 4), against the
    # assembled grid as the baseline (the pipelined stream's).
    mesh = HeatMesh(SHARD_MESH, ref.grid.device)
    blocks = mesh.split(ref.grid)
    bs = cfg.block_shape()
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    out["observers 32768^2 (2, 4)"] = _observer_ms(blocks, ref.grid, origins,
                                                   SHARD_N * SHARD_N)
    del blocks, ref
    gc.collect()
    torch.cuda.empty_cache()
    # 64 x 512^2 (path M) with telemetry, guard and diagnostics.
    t0 = time.perf_counter()
    cfg = HeatConfig(nx=ENS_N, ny=ENS_N, steps=ENS_STEPS, **obs)
    plain = EnsembleSolver(cfg.replace(guard_interval=None,
                                       diag_interval=None), ENS_B).solve()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "e.jsonl")
        with Telemetry(path) as sink:
            ens = EnsembleSolver(cfg, ENS_B).solve(telemetry=sink)
        with open(path) as f:
            events = [json.loads(line) for line in f]
    ends = [e["member"] for e in events if e["event"] == "member_end"]
    check(_same_bits(ens.grids, plain.grids) and ends == list(range(ENS_B))
          and bool(ens.finite.all()) and len(ens.diagnostics) == ENS_B,
          f"stream ensemble: members bitwise "
          f"{_same_bits(ens.grids, plain.grids)}, member_end {ends}")
    out["64 x 512^2 ensemble"] = {
        "bitwise": True, "member_end": len(ends),
        "events": sorted({e["event"] for e in events}),
        "elapsed_s": ens.elapsed_s, "plain_elapsed_s": plain.elapsed_s,
        "phase_s": time.perf_counter() - t0}
    del ens, plain
    # 512^2 backward Euler in chunks of 5, a sample every 5 steps.
    t0 = time.perf_counter()
    cfg = HeatConfig(nx=IMP_N, ny=IMP_N, cx=IMP_C, cy=IMP_C,
                     steps=IMP_STEPS, scheme="backward_euler",
                     diag_interval=5)
    rows = _stream_rows(cfg, 5, 1, keep_all=False)
    ref = solve(cfg.replace(diag_interval=None))
    events, chunks = _stream_timed(cfg, 5, 1)
    vc = [e for e in events if e["event"] == "vcycle"]
    check(len(vc) == IMP_STEPS // 5 and "level_wall_share" in vc[0]
          and all("level_wall_share" not in e for e in vc[1:])
          and _same_bits(rows[-1]["grid"], ref.grid),
          f"stream 512^2 backward Euler: {len(vc)} vcycle events, grids "
          f"equal {_same_bits(rows[-1]['grid'], ref.grid)}")
    out["512^2 backward Euler"] = {
        "bitwise": True, "vcycle_events": len(vc),
        "cycles": [e["cycles"] for e in vc],
        "level_wall_share": vc[0]["level_wall_share"], "chunks": chunks,
        "elapsed_s": rows[-1]["elapsed_s"], "solve_elapsed_s": ref.elapsed_s,
        "phase_s": time.perf_counter() - t0}
    del rows, ref
    # The CLI with the observer flags; its metrics file read here.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "runs", "m.jsonl")
        prof_dir = os.path.join(tmp, "prof")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx",
               "1024", "--ny", "1024", "--steps", str(MAIN_STEPS),
               "--metrics", metrics, "--guard-interval",
               str(STREAM_GUARD), "--diag-interval", str(STREAM_DIAG),
               "--pipeline-depth", "2", "--profile", prof_dir]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"stream CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(metrics) as f:
            events = [json.loads(line) for line in f]
        traces = os.listdir(prof_dir)
    names = [e["event"] for e in events]
    head = events[0]
    check(names == ["run_header", "chunk", "diagnostics", "run_end"]
          and head["platform"] == "gpu" and head["pipeline_depth"] == 2
          and events[1]["finite"] is True
          and events[1]["steps"] == MAIN_STEPS
          and any(t.endswith(".json") for t in traces),
          f"stream CLI: events {names}, traces {traces}")
    out["cli"] = {"events": names, "device_kind": head["device_kind"],
                  "chunk": {k: events[1].get(k) for k in
                            ("wall_s", "gap_s", "dispatch_s",
                             "drain_wait_s", "mcells_steps_per_s")},
                  "traces": traces, "phase_s": time.perf_counter() - t0}
    emit({"phase": "stream", "ok": True, "chunk_steps": STREAM_CHUNK,
          "guard_interval": STREAM_GUARD, "diag_interval": STREAM_DIAG,
          "runs": out})


def _interior_cells_3d(origin, shape, grid):
    """Cells of the block ``shape`` at ``origin`` in the grid's interior."""
    return math.prod(max(min(o + s, n - 1) - max(o, 1), 0)
                     for o, s, n in zip(origin, shape, grid))


# H-fused's device time at the main path's block before the TMA load and
# the edge tiles' fixed pointers (a piece chosen per cell and plane, 32 x
# 16 threads of 2 rows; NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6).
H_FUSED_EARLIER_MS = 1.164


def _h_fused_loads_and_tiles(u, pieces, v, k, kw):
    """H-fused's monolithic launch at the main block under each load, and
    the time of each kind of (Y, Z) tile by difference: a second block of
    the same X extent and as many tiles, all at its edge (one tile along
    Y, by = wy - 2K, so the same segments and waves), gives an edge
    tile's time; the main block's launch less its edge tiles' share, an
    interior tile's. By CUDA events in turns; with the earlier design's
    time and the occupancy of the instance the main path launches."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    bx, by, bz = u.shape
    load = skb3.h_load(u.shape, k, u)
    interior, edge = p.h_tiles(u.shape, k)
    wy, wz = p.h_extent()
    e_shape = (bx, wy - 2 * k, (interior + edge) * (wz - 2 * k))
    check(p.h_tiles(e_shape, k) == (0, interior + edge)
          and p.h_launch(e_shape, k, bx) == p.h_launch(u.shape, k, bx),
          f"the edge-tile block {e_shape} does not match the main block's "
          f"tiles and segments")
    gen = torch.Generator(device=u.device).manual_seed(9)
    e_grid = tuple(2 * n for n in e_shape)
    ebx, eby, ebz = e_shape

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=u.device)

    e_u, e_v = rand(*e_shape), torch.empty(e_shape, device=u.device)
    e_pieces = (rand(ebx, eby, 2 * k), rand(ebx, 2 * k, ebz + 2 * k),
                rand(k, eby + 2 * k, ebz + 2 * k),
                rand(k, eby + 2 * k, ebz + 2 * k))
    e_kw = dict(kw, origin=e_shape, grid_shape=e_grid)
    runs = {f"{ld}@main": (lambda ld=ld: skb3.h_block_fused(
                u, *pieces, v, k, False, load=ld, **kw))
            for ld in dict.fromkeys((load, "cp.async"))}
    runs["cp.async@edge_block"] = lambda: skb3.h_block_fused(
        e_u, *e_pieces, e_v, k, False, **e_kw)
    ms = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            ms[key].append(_time_ms(runs[key], 20, 3))
    ms = {key: sum(t) / len(t) for key, t in ms.items()}
    segments = -(-bx // p.h_launch(u.shape, k, bx))
    edge_us = ms["cp.async@edge_block"] * 1e3 / ((interior + edge)
                                                 * segments)
    out = {"load": load, "earlier_design_device_ms": H_FUSED_EARLIER_MS,
           "tiles_interior": interior, "tiles_edge": edge,
           "segments": segments, "edge_block": list(e_shape),
           "ms_by_run": ms,
           "occupancy_blocks_per_sm": {
               ld: skb3.h_fused_occupancy(k, ld)
               for ld in dict.fromkeys((load, "cp.async"))},
           "us_per_tile_segment_edge": edge_us}
    for ld in dict.fromkeys((load, "cp.async")):
        inner_us = ((ms[f"{ld}@main"] * 1e3 - edge * segments * edge_us)
                    / (interior * segments)) if interior else None
        out[f"us_per_tile_segment_interior_{ld}"] = inner_us
        out[f"edge_over_interior_{ld}"] = (edge_us / inner_us
                                           if inner_us else None)
    del e_u, e_v, e_pieces
    return out


# H's device time at the main path's block before F's plane loop (one z
# cell a thread on heat_f_levels, every cell by cp.async; NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md section 6).
H_EARLIER_MS = 1.103


def _h_loads_and_tiles(ext, v, k, kw, xch):
    """H's launch at the main block under each load, by CUDA events in
    turns, and the time of each kind of tile by difference: under the
    cp.async load every tile copies its cells (a wrapped tile's load),
    so that launch over the tile segments gives a wrapped tile's µs; the
    TMA launch less its wrapped tiles' share, a boxed tile's. With the
    earlier design's time, the tile counts and the occupancy of the
    instance the main path launches."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    bs = tuple(v.shape)
    kinds = p.hc_tile_kinds(bs, k, xch.halos, kw["origin"],
                            kw["grid_shape"])
    _, _, _, seg = p.hc_launch(bs, k)
    segments = -(-bs[0] // seg)
    runs = {ld: (lambda ld=ld: skb3.h_block(ext, v, k, False, load=ld,
                                            **kw))
            for ld in ("tma", "cp.async")}
    ms = {ld: [] for ld in runs}
    for order in (list(runs), list(runs)[::-1]):
        for ld in order:
            ms[ld].append(_time_ms(runs[ld], 20, 3))
    ms = {ld: sum(t) / len(t) for ld, t in ms.items()}
    wrapped_us = ms["cp.async"] * 1e3 / (kinds["tiles"] * segments)
    boxed_us = ((ms["tma"] * 1e3 - kinds["wrapped"] * segments * wrapped_us)
                / (kinds["boxed"] * segments))
    return {"load": skb3.h_block_load(ext),
            "earlier_design_device_ms": H_EARLIER_MS,
            "tile_kinds": kinds, "segments": segments, "ms_by_load": ms,
            "us_per_tile_segment_boxed": boxed_us,
            "us_per_tile_segment_wrapped": wrapped_us,
            "wrapped_over_boxed": wrapped_us / boxed_us,
            "occupancy_blocks_per_sm": skb3.h_occupancy(k)}


def phase_timing_h(dev):
    """ms per launch of each H kernel at the main path's block (512^3 of
    1024^3 on (2, 2, 2), K = h_k_default, no residual, as the rounds
    between check windows launch them), its plain version, its bound and
    a conv3d yardstick; the exchange's own time per round and one whole
    monolithic round of the 8 blocks."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate3D
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k = params().h_k_default
    grid = (SHARD3_N,) * 3
    mesh = HeatMesh(SHARD3_MESH, dev)
    bs = mesh.block_shape(grid)
    bx, by, bz = bs
    plate = HeatPlate3D(*grid)
    us = [plate.init_block(dev, mesh.origin(b, bs), bs)
          for b in range(mesh.size)]
    xch = temporal3d.DeepExchange3D(mesh, bs, k, dev)

    def exchange():
        xch.lead(us)
        xch.last(us)

    exchange_ms = _time_ms(exchange, 20, 2)
    b = mesh.size - 1
    o = mesh.origin(b, bs)
    kw = dict(origin=o, grid_shape=grid, cx=CX, cy=CY, cz=CX)
    zt, yt, xlo, xhi = xch.pieces(b)
    # The circular block as the pinned-H round assembles it (rows padded
    # to a multiple of 4 floats: the TMA load).
    ext = xch.new_circular()
    xch.assemble_circular(b, us[b], ext)
    assemble_ms = _time_ms(lambda: xch.assemble_circular(b, us[b], ext), 10,
                           2)
    frame = torch.zeros(tuple(n + 2 * k for n in bs), device=dev)
    xch.assemble_padded(b, us[b], frame)
    v = torch.empty(bs, device=dev)
    a0, cx, cy, cz = coeffs3_f32(CX, CY, CX)
    w = torch.zeros((3, 3, 3), dtype=torch.float32, device=dev)
    w[1, 1, 1] = a0
    w[0, 1, 1] = w[2, 1, 1] = cx
    w[1, 0, 1] = w[1, 2, 1] = cy
    w[1, 1, 0] = w[1, 1, 2] = cz
    w = w.view(1, 1, 3, 3, 3)

    def conv_steps(x):
        for _ in range(k):
            x = F.conv3d(x, w)
        return x

    framed = frame.view(1, 1, *frame.shape)
    lead = frame[k:k + bx].contiguous().view(1, 1, bx, by + 2 * k,
                                             bz + 2 * k)
    # Every block's two band windows, 3K planes of its padded frame, for
    # the band launch's yardstick.
    origins = [mesh.origin(i, bs) for i in range(mesh.size)]
    bands = torch.empty((2 * mesh.size, 1, 3 * k, by + 2 * k, bz + 2 * k),
                        device=dev)
    padded = torch.zeros_like(frame)
    for i in range(mesh.size):
        xch.assemble_padded(i, us[i], padded)
        bands[2 * i, 0] = padded[:3 * k]
        bands[2 * i + 1, 0] = padded[bx - k:]
    del padded
    vs = [torch.empty_like(u) for u in us]
    pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
    band_launch = skb3.BandLaunch3D(us, *pieces, vs, k, origins=origins,
                                    grid_shape=grid, cx=CX, cy=CY, cz=CX)
    f = 4  # bytes a float32
    ops = OPS_PER_CELL_STEP_3D * k
    inner = _interior_cells_3d(o, bs, grid)
    bulk_inner = _interior_cells_3d((o[0] + k,) + o[1:], (bx - 2 * k, by, bz),
                                    grid)
    plane = by * bz
    tails = bx * by * 2 * k + bx * 2 * k * (bz + 2 * k)
    slabs = 2 * k * (by + 2 * k) * (bz + 2 * k)
    timed = {
        # The main path's launch: the monolithic fused round.
        "heat_h_block_3d_fused": (
            lambda: skb3.h_block_fused(us[b], zt, yt, xlo, xhi, v, k, False,
                                       **kw),
            lambda: skb3.h_block_fused_plain(us[b], zt, yt, xlo, xhi, v, k,
                                             False, **kw),
            lambda: conv_steps(framed),
            (f * (2 * bx * plane + tails + slabs), ops * inner)),
        "heat_h_block_3d_fused@bulk": (
            lambda: skb3.h_block_fused(us[b], zt, yt, None, None, v, k,
                                       False, defer_x=True, **kw),
            lambda: skb3.h_block_fused_plain(us[b], zt, yt, None, None, v,
                                             k, False, defer_x=True, **kw),
            lambda: conv_steps(lead),
            (f * ((2 * bx - 2 * k) * plane + tails), ops * bulk_inner)),
        "heat_h_block_3d": (
            lambda: skb3.h_block(ext, v, k, False, **kw),
            lambda: skb3.h_block_plain(ext, v, k, False, **kw),
            lambda: conv_steps(framed),
            (f * (math.prod(xch.circular_shape) + bx * plane),
             ops * inner)),
        # The H-defer round's band launch: every block's bands at once;
        # its bound and yardstick are the 8 blocks'.
        "heat_h_band_fix_3d": (
            lambda: band_launch(False),
            lambda: skb3.band_fix_blocks_3d_plain(
                us, *pieces, vs, k, False, origins=origins, grid_shape=grid,
                cx=CX, cy=CY, cz=CX),
            lambda: conv_steps(bands),
            (mesh.size * f * (4 * k * plane + tails * 4 * k // bx + slabs
                              + 2 * k * plane),
             ops * sum(_interior_cells_3d(oi, bs, grid)
                       - _interior_cells_3d((oi[0] + k,) + oi[1:],
                                            (bx - 2 * k, by, bz), grid)
                       for oi in origins))),
    }
    rows = {}
    for key, (kernel, plain, library, (nbytes, nops)) in timed.items():
        name = key.split("@")[0]
        rows[key] = {"block": list(bs), "k": k,
                     "ms": _time_ms(kernel, 20, 3),
                     "plain_ms": _time_ms(plain, 2, 1),
                     "library_ms": _time_ms(library, 5, 1),
                     **_bound(nbytes, nops)}
        rows[key].update(_device_ms(kernel, name))
    rows["heat_h_block_3d_fused"].update(_h_fused_loads_and_tiles(
        us[b], (zt, yt, xlo, xhi), v, k, kw))
    rows["heat_h_block_3d"].update(_h_loads_and_tiles(ext, v, k, kw, xch))
    # The band launch under each of its loads in turns (device time a
    # launch), and 8 one-entry launches: device time summed, and events
    # for the 8.
    band = rows["heat_h_band_fix_3d"]
    band["blocks"] = mesh.size
    band["load"] = band_launch.load
    band["shape"] = list(band_launch.shape)
    by_load = {ld: skb3.BandLaunch3D(us, *pieces, vs, k, origins=origins,
                                     grid_shape=grid, cx=CX, cy=CY, cz=CX,
                                     load=ld)
               for ld in sorted({"cells", band_launch.load})}
    band["device_ms_by_load"] = {ld: [] for ld in by_load}
    for order in (list(by_load), list(by_load)[::-1]):
        for ld in order:
            band["device_ms_by_load"][ld].append(_device_ms(
                lambda fn=by_load[ld]: fn(False),
                "heat_h_band_fix_3d")["device_ms"])
    band["one_entry_device_ms_summed"] = sum(
        _device_ms(lambda i=i: skb3.h_band_fix(
            us[i], *xch.pieces(i), vs[i], k, False, origin=origins[i],
            grid_shape=grid, cx=CX, cy=CY, cz=CX),
            "heat_h_band_fix_3d")["device_ms"] for i in range(mesh.size))
    band["one_entry_ms"] = _time_ms(lambda: [skb3.h_band_fix(
        us[i], *xch.pieces(i), vs[i], k, False, origin=origins[i],
        grid_shape=grid, cx=CX, cy=CY, cz=CX) for i in range(mesh.size)],
        20, 3)
    del by_load
    # One whole monolithic round of the 8 blocks (the three phases and 8
    # launches of H-fused), and the pinned-H round (the phases, 8
    # assemblies and 8 launches of H), by events in turns.
    # And the H-defer round (the phases, 8 deferred bulks and one band
    # launch); the device operations (kernels, copies, memsets) the host
    # issues a round under each, by the profiler.
    from parallel_heat_tpu_torch import tune

    with tune.force("block_temporal_3d", "H-defer"):
        round_fns = {kind: temporal3d.cuda_round_3d(
            xch, kind, "overlap", grid_shape=grid, cx=CX, cy=CY, cz=CX)
            for kind in ("H-fused", "H", "H-defer")}
    round_runs = {kind: [] for kind in round_fns}
    for order in (list(round_fns), list(round_fns)[::-1]):
        for kind in order:
            round_runs[kind].append(_time_ms(
                lambda fn=round_fns[kind]: fn(us, vs, False), 10, 2))
    round_ms = sum(round_runs["H-fused"]) / 2
    host_ops = {}
    for kind, fn in round_fns.items():
        _, per = _profiled(lambda fn=fn: [fn(us, vs, False)
                                          for _ in range(5)])
        host_ops[kind] = sum(n for _, n in per.values()) / 5
    copies = xch.copies
    del us, vs, xch, ext, v, frame, framed, lead, bands, band_launch
    torch.cuda.empty_cache()
    emit({"phase": "timing_h", "kernels": rows,
          "exchange_ms_per_round": exchange_ms,
          "exchange_copies_per_round": copies,
          "host_launches_per_round": mesh.size + copies,
          "device_ops_per_round": host_ops,
          "assemble_ms_per_block": assemble_ms,
          "round_ms": round_ms,
          "round_ms_pinned_h": sum(round_runs["H"]) / 2,
          "round_ms_h_defer": sum(round_runs["H-defer"]) / 2,
          "round_ms_runs": round_runs,
          "redundant_cell_share": (math.prod(n + 2 * k for n in bs)
                                   - math.prod(bs)) / math.prod(bs),
          "band_share_of_cells": 2 * k / bx})
    return {name: row for name, row in rows.items() if "@" not in name}


# ---------------------------------------------------------------------------
# The static-analysis path (parallel_heat_tpu_torch/analysis/, heatlint)
# ---------------------------------------------------------------------------

FIX_BIG = 262144         # the fixture's timed shape: 262144 x 128 floats


def _audit_layers():
    """The port's ast and kernels layers, baseline applied: ``({layer:
    seconds}, active findings, stale entries)``."""
    from parallel_heat_tpu_torch.analysis import (LAYERS, apply_baseline,
                                                  load_baseline)

    seconds, found = {}, []
    for layer, (_, run) in LAYERS.items():
        t0 = time.perf_counter()
        found.extend(run())
        seconds[layer] = time.perf_counter() - t0
    active, stale = apply_baseline(found, load_baseline())
    return seconds, active, stale


def _record_blocks(counts):
    """Corner, edge and interior indices along axes of ``counts``."""
    picks = set()
    for pick in ((0,) * len(counts), tuple(c - 1 for c in counts),
                 tuple(c // 2 for c in counts),
                 (0,) + tuple(c // 2 for c in counts[1:]),
                 tuple(c // 2 for c in counts[:-1]) + (0,)):
        picks.add(pick)
    return sorted(picks)


def _records_of(rec, first, n, box):
    """Records ``first`` .. ``first + n`` of a record variant's buffer,
    those written, as :func:`load_records` gives a plan's: the bytes a
    load lands are the launch's encoded ``box``'s (a TMA fill), or the
    block's own copies' (``box`` None: a cp.async fill). So a record
    differs from the plan's where the kernel's ``expect_tx`` differs from
    the box its launch encodes."""
    words = rec[1 + 8 * first:1 + 8 * (first + n)].view(n, 8).tolist()
    landed = None if box is None else 4 * math.prod(box)
    got = [tuple(w[:3]) + (w[3] if landed is None else landed,) +
           tuple(w[4:7]) for w in words if w[7] == 1]
    return got, len(got)


def phase_audit(dev):
    """The static-analysis path on the card's machine: the port's ast and
    kernels layers (zero findings, and their seconds); the audit's fixture
    kernel ``heat_probe_fixture`` (``clean`` and ``clean_tma`` bitwise
    ``2 u`` at 16 x 128 and 262144 x 128, ``runtime_window`` at an
    in-range offset; the seeded variants in ptxas's report and refused by
    the launcher); every instance's static shared memory within
    ``static_smem_bytes``; each plan's blocks an SM against the
    occupancy exports of E, E-uni, F, G-uni, G-fuse, H-fused, H, I and
    I-uni at their
    main-path geometries (registers from ptxas); and the record variants
    of E-uni (16384^2, K = 8) and F (512^3, K = 3, both loads): each
    audited block's loads equal the plan's, the grid bitwise the
    production kernel's. Returns the fixture's launches on its path
    (``clean_tma`` at 262144 x 128, device-timed), its ms, plain ms,
    bound, ``torch.mul`` ms and max |diff|."""
    import torch

    from parallel_heat_tpu_torch.analysis import kernels as ak
    from parallel_heat_tpu_torch.analysis import plans as ap
    from parallel_heat_tpu_torch.kernels import build
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.tools import analysis_fixture as af

    t0 = time.perf_counter()
    hp = params()
    seconds, active, stale = _audit_layers()
    check(not active and not stale,
          f"heatlint on the card's machine: {len(active)} finding(s), "
          f"{len(stale)} stale: "
          f"{[(f.rule, f.symbol, f.message) for f in active[:5]]}")

    # The fixture: its path first (counted), then its checks.
    rng = np.random.default_rng(41)
    big = torch.from_numpy((rng.standard_normal((FIX_BIG, 128)) * 10)
                           .astype(np.float32)).to(dev)
    af.counts["heat_probe_fixture"] = 0
    timed = _device_ms(lambda: af.strip_double(big, "clean_tma"),
                       "heat_probe_fixture", made=40)
    launches = af.counts["heat_probe_fixture"]
    check(launches >= 40, f"the fixture's path ran {launches} launches")
    err = 0.0
    checked = []
    for rows in (16, FIX_BIG):
        u = big[:rows].clone()
        for variant, off in (("clean", None), ("clean_tma", None),
                             ("runtime_window", 5)):
            got = af.strip_double(u, variant, off=off)
            want = af.strip_double_plain(u.cpu(), variant, off=off).to(dev)
            d = float((got - want).abs().max())
            check(torch.equal(got, want),
                  f"fixture {variant} at {rows} x 128 differs from 2u by {d}")
            err = max(err, d)
            checked.append([variant, rows])
    lib = build.load("heat_probe_fixture")
    out = torch.empty_like(big[:16])
    seeded = [v for v in ap.FIXTURE_VARIANTS if v not in af.LAUNCHED]
    refused = {v: lib.heat_probe_fixture(
        ap.FIXTURE_VARIANTS.index(v), big.data_ptr(), out.data_ptr(), None,
        16, 8, torch.cuda.current_stream().cuda_stream) for v in seeded}
    check(all(code != 0 for code in refused.values()),
          f"the launcher took a seeded variant: {refused}")
    fix_rows = build.ptxas_report(build.build_log("heat_probe_fixture"))
    instances = {r["instance"] for r in fix_rows}
    want_inst = {f"heat_probe_fixture_kernel<{i}>"
                 for i in range(len(ap.FIXTURE_VARIANTS))}
    check(want_inst <= instances,
          f"fixture instances missing from ptxas's report: "
          f"{sorted(want_inst - instances)}")

    # Static shared memory of every instance of every library.
    static = {}
    for name in tuple(build.KERNELS) + tuple(build.TOOLS):
        for r in build.ptxas_report(build.build_log(name)):
            static[r["instance"]] = r.get("smem_bytes", 0)
    over = {i: b for i, b in static.items() if b > hp.static_smem_bytes}
    check(static and not over,
          f"instances past static_smem_bytes ({hp.static_smem_bytes}): "
          f"{over}")

    # Blocks an SM: the plan's (registers from ptxas) against the
    # occupancy exports.
    def regs(name, inst):
        for r in build.ptxas_report(build.build_log(name)):
            if r["instance"] == inst:
                return r["registers"]
        raise SmokeFailure(f"{inst} missing from {name}'s ptxas report")

    f_load = sk3.f_load((CUBE,) * 3)
    f_tma = "true" if f_load == "tma" else "false"
    h_block = (SHARD3_N // 2,) * 3
    h_load = skb3.h_load(h_block, hp.h_k_default)
    g_block = (SHARD_N // SHARD_MESH[0], SHARD_N // SHARD_MESH[1])
    i_inst = f"{hp.i_k_default}"
    occ = {}
    for label, plan, name, inst, export in (
            ("E", ap.plan_e((BIG, BIG), hp.e_k_default), "heat_e_temporal",
             "heat_e_temporal_kernel", lambda: sk.loop_occupancy(
                 "heat_e_temporal", hp.e_k_default, hp.e_tile, hp.e_block)),
            ("E-uni", ap.plan_e((BIG, BIG), hp.e_k_default, uni=True),
             "heat_e_uni_temporal", "heat_e_uni_temporal_kernel",
             lambda: sk.loop_occupancy("heat_e_uni_temporal",
                                       hp.e_k_default, hp.e_tile,
                                       hp.e_block)),
            ("G-uni", ap.plan_g("G-uni", g_block, hp.g_k_default,
                                grid_shape=(SHARD_N, SHARD_N), defer=True),
             "heat_g_block_uniform", "heat_g_block_uniform_kernel",
             lambda: sk.loop_occupancy("heat_g_block_uniform",
                                       hp.g_k_default, hp.g_tile,
                                       hp.g_block)),
            ("G-fuse", ap.plan_g("G-fuse", g_block, hp.g_k_default,
                                 grid_shape=(SHARD_N, SHARD_N)),
             "heat_g_block_fused", "heat_g_block_fused_kernel",
             lambda: sk.loop_occupancy("heat_g_block_fused",
                                       hp.g_k_default, hp.g_tile,
                                       hp.g_block)),
            ("F", ap.plan_f((CUBE,) * 3, hp.f_k_default, f_load),
             "heat_f_temporal3d",
             f"heat_f_temporal3d_kernel<{hp.f_k_default}, {hp.f_rows}, "
             f"{f_tma}>", lambda: sk3.f_occupancy(hp.f_k_default, f_load)),
            ("H-fused", ap.plan_h("H-fuse", h_block, hp.h_k_default,
                                  grid_shape=(SHARD3_N,) * 3, load=h_load),
             "heat_h_block_3d_fused",
             f"heat_h_block_3d_fused_kernel<{hp.h_k_default}, {hp.h_rows}, "
             f"{'true' if h_load == 'tma' else 'false'}>",
             lambda: skb3.h_fused_occupancy(hp.h_k_default, h_load)),
            ("H", ap.plan_hc(h_block, hp.h_k_default,
                             grid_shape=(SHARD3_N,) * 3),
             "heat_h_block_3d",
             f"heat_h_block_3d_kernel<{hp.h_k_default}, "
             f"{hp.hc_shape(hp.h_k_default)[1]}>",
             lambda: skb3.h_occupancy(hp.h_k_default)),
            ("I", ap.plan_i((BIG, BIG), hp.i_k_default),
             "heat_i_tile_temporal", f"heat_i_tile_temporal_kernel<{i_inst}>",
             lambda: sk.i_occupancy("heat_i_tile_temporal", hp.i_k_default)),
            ("I-uni", ap.plan_i((BIG, BIG), hp.i_k_default, uni=True),
             "heat_i_uni_tile_temporal",
             f"heat_i_uni_tile_temporal_kernel<{i_inst}>",
             lambda: sk.i_occupancy("heat_i_uni_tile_temporal",
                                    hp.i_k_default))):
        r = regs(name, inst)
        mine, theirs = ak.blocks_per_sm(plan, r), export()
        occ[label] = {"registers": r, "plan": mine, "export": theirs}
        check(mine == theirs, f"{label}: the plan holds {mine} block(s) an "
                              f"SM, the occupancy export {theirs} "
                              f"({r} registers)")

    # The record variants against the plans.
    records = {}
    g = torch.Generator(device=dev).manual_seed(43)
    u = torch.rand((BIG, BIG), device=dev, generator=g) * 10
    k = hp.e_k_default
    out, rec, box = af.record_e_uni(u, k, cx=CX, cy=CY)
    want = torch.empty_like(u)
    res = sk.temporal_steps_uni(u, want, k, True, cx=CX, cy=CY)
    check(torch.equal(out, want) and same_float(
        rec[:1].view(torch.float32)[0], res),
          "E-uni's record variant is not bitwise E-uni")
    plan = ap.plan_e((BIG, BIG), k, uni=True)
    counts = [a.count for a in plan.axes]
    compared = 0
    for idx in _record_blocks(counts):
        b = idx[0] * counts[1] + idx[1]
        got, _ = _records_of(rec, b, 1, box)
        expect = ak.load_records(plan, idx)
        check(got == expect,
              f"E-uni block {idx}: the card recorded {got}, the plan "
              f"{expect}")
        compared += 1
    records["E-uni"] = {"shape": [BIG, BIG], "k": k, "blocks": compared,
                        "box": list(box)}
    del u, out, want
    g3 = torch.Generator(device=dev).manual_seed(47)
    u3 = torch.rand((CUBE,) * 3, device=dev, generator=g3) * 10
    k3 = hp.f_k_default
    for load in ("tma", "cp.async"):
        out, rec, box = af.record_f(u3, k3, load, cx=CX, cy=CY, cz=CY)
        want = torch.empty_like(u3)
        res = sk3.xslab_steps_3d(u3, want, k3, True, cx=CX, cy=CY, cz=CY,
                                 load=load)
        check(torch.equal(out, want) and same_float(
            rec[:1].view(torch.float32)[0], res),
              f"F's record variant under {load} is not bitwise F")
        plan = ap.plan_f((CUBE,) * 3, k3, load)
        counts = [a.count for a in plan.axes]
        compared = 0
        for idx in _record_blocks(counts):
            b = (idx[0] * counts[1] + idx[1]) * counts[2] + idx[2]
            expect = ak.load_records(plan, idx)
            got, n = _records_of(rec, b * (CUBE + 2 * k3), CUBE + 2 * k3,
                                 box)
            first = next(((a, e) for a, e in zip(got, expect) if a != e),
                         None)
            check(got == expect,
                  f"F ({load}) block {idx}: the card recorded {n} loads, "
                  f"the plan {len(expect)}; first differing: {first}")
            compared += 1
        records[f"F {load}"] = {"shape": [CUBE] * 3, "k": k3,
                                "blocks": compared,
                                "box": None if box is None else list(box)}
    del u3, out, want

    # The fixture's plain version and yardstick at the timed shape.
    plain_ms = _time_ms(lambda: af.strip_double_plain(big), 20)
    lib_ms = _time_ms(lambda: torch.mul(big, 2), 20)
    bound = _bound(2 * 4 * big.numel(), big.numel())
    emit({"phase": "audit", "seconds": time.perf_counter() - t0,
          "heatlint_seconds": seconds, "findings": 0,
          "fixture_checked": checked, "fixture_launches": launches,
          "seeded_refused": refused,
          "fixture_instances": sorted(instances),
          "static_smem_max": max(static.values()),
          "blocks_per_sm": occ, "records": records})
    return {"launches": launches, "max_abs_err": err,
            "device_ms": timed["device_ms"], "plain_ms": plain_ms,
            "library_ms": lib_ms, **bound}



# ---------------------------------------------------------------------------
# Precision: the bfloat16 forms of A, E and E-uni, f32chunk, float64
# ---------------------------------------------------------------------------

# BASELINE config 4: "32768x32768 grid, bf16 mixed-precision stencil".
BF16_N = 32768
# The precision forms' counts (ops/stencil_kernels.py counts), each with
# its library's source and the TPU kernel's builder it replaces.
KERNELS_BF16 = {
    "heat_a_resident_bf16": ("heat_a_resident", TPU + ":117"),
    "heat_e_uni_temporal_bf16": ("heat_e_uni_temporal", TPU + ":832"),
    "heat_e_temporal_bf16": ("heat_e_temporal", TPU + ":607"),
    "heat_e_uni_temporal_bf16_acc": ("heat_e_uni_temporal", TPU + ":832"),
    "heat_e_temporal_bf16_acc": ("heat_e_temporal", TPU + ":607"),
    "heat_b_step_bf16": ("heat_b_step", TPU + ":294"),
    "heat_c_tiled_bf16": ("heat_c_tiled", TPU + ":3059"),
    "heat_m_ensemble_bf16": ("heat_m_ensemble",
                             "parallel_heat_tpu/ops/batched.py:97"),
    "heat_i_uni_tile_temporal_bf16": ("heat_i_uni_tile_temporal_bf16",
                                      TPU + ":3456"),
    "heat_i_tile_temporal_bf16": ("heat_i_tile_temporal_bf16",
                                  TPU + ":3294"),
    "heat_i_uni_tile_temporal_bf16_acc": ("heat_i_uni_tile_temporal_bf16",
                                          TPU + ":3456"),
    "heat_i_tile_temporal_bf16_acc": ("heat_i_tile_temporal_bf16",
                                      TPU + ":3294"),
    "heat_d_step3d_bf16": ("heat_d_step3d", TPU + ":3708"),
    "heat_f_temporal3d_bf16": ("heat_f_temporal3d_bf16", TPU + ":3932"),
    **KERNELS_G_BF16,
    **KERNELS_H_BF16,
}
# F's bfloat16 launch shapes for the shape rule's check on the card:
# (lanes, warps), rows, K, legal and not (heat_f_takes at 2-byte cells
# against hopper_params.f_takes(..., elem=2)).
F_SHAPE_RULE_BF16 = [((32, 16), 2, 3), ((32, 16), 2, 4), ((32, 12), 2, 4),
                     ((32, 16), 1, 4), ((32, 12), 1, 7), ((32, 8), 4, 8),
                     ((32, 16), 4, 3), ((32, 12), 2, 9)]
# D's and F's bfloat16 check grids beside the main path's 512^3: rows of
# 8k + 4 cells (F's cp.async load at bfloat16, TMA at float32), of 8k
# (TMA), of 8k + 1 (partial last groups) and a slab thinner than a tile.
RAGGED_3D_BF16 = ((67, 130, 204), (67, 130, 200), (67, 130, 201),
                  (5, 3, 300))
# I's and I-uni's bfloat16 check grids: the float32 phase's I grids but
# the main path's 16384^2, a width of 4k + 2 (I's 8-byte copy on every
# other row, its 2-byte loads on the rest) and 200 x 136 (I-uni's box
# shifted 4 cells left at K <= 4, over two bands).
I_PLAN_BF16 = I_PLAN[:-1] + (((130, 250), (_UNEQ,)),
                             ((200, 136), (_UNEQ,)))
BF16_NAN_PAYLOADS = (0x7FC1, -64, 0x7F81)   # -64 is 0xFFC0


def _bits_equal(a, b) -> bool:
    """Bit for bit, NaN payloads included, at any element size."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def _rand_bf16(dev, shape, seed, nan=False):
    """A random bfloat16 grid (either sign, magnitudes to about 40); with
    ``nan`` NaNs of payloads no conversion makes, inside and on the
    ring."""
    import torch

    u = _rand_on(dev, shape, seed).to(torch.bfloat16)
    if nan:
        bits = u.view(torch.int16)
        m, n = shape
        for (i, j), b in zip(((m // 2, n // 3), (0, n // 2), (m - 1, 1),
                              (m // 3, n - 1)),
                             BF16_NAN_PAYLOADS + (0x7FC1,)):
            bits[i, j] = b
    return u


def _ring_kept(out, u) -> bool:
    return all(_bits_equal(a.contiguous(), b.contiguous()) for a, b in (
        (out[0], u[0]), (out[-1], u[-1]), (out[:, 0], u[:, 0]),
        (out[:, -1], u[:, -1])))


def _check_bf16(launch, plain, u, out_dtype, k, kw, label, err, name):
    """One launch of a bfloat16 form against its plain version, with and
    without the residual: grid bit for bit, residual equal."""
    import torch

    got = torch.full(u.shape, float("nan"), dtype=out_dtype, device=u.device)
    want = torch.full_like(got, float("nan"))
    nores = torch.empty_like(got)
    r = launch(u, got, k, True, **kw)
    rp = plain(u, want, k, True, **kw)
    launch(u, nores, k, False, **kw)
    torch.cuda.synchronize()
    d = float((got.float() - want.float()).abs().nan_to_num(0).max())
    err[name] = max(err[name], d)
    check(_bits_equal(got, want) and same_float(r, rp),
          f"{label} != its plain version: max diff {d}, residual "
          f"{float(r)} vs {float(rp)}")
    check(_bits_equal(got, nores), f"{label}: grid depends on with_residual")
    return got, r


def _check_carry(launch, plain, u, kw, label, err, name, k=None):
    """A 16-step carry chunk as the main path launches it
    (stencil_kernels._carry_chunks): its first launch (bfloat16 in, the
    float32 level out, ``k`` steps: e_k_default where None) and its last
    (the level in, bfloat16 out), each bit for bit its plain version on
    the same input. Returns the last launch's grid and residual."""
    import torch

    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH

    k = k or params().e_k_default
    kw = dict(kw, acc_f32=True)
    level, _ = _check_bf16(launch, plain, u, torch.float32, k, kw,
                           f"{label}, first launch (K={k})", err, name)
    out = _check_bf16(launch, plain, level, torch.bfloat16,
                      F32CHUNK_DEPTH - k, kw, f"{label}, last launch "
                      f"(K={F32CHUNK_DEPTH - k})", err, name)
    del level
    return out


def _one_step(fn):
    """A one-step wrapper (B or C, or its plain version) called as the
    K-step ones are."""
    def run(u, out, k, with_residual, **kw):
        return fn(u, out, **kw)
    return run


def _check_bc_bf16(sk, u, kw, where, err):
    """B's and C's bfloat16 forms on ``u``, each bitwise its plain
    version, and C bitwise B; returns B's grid and residual."""
    got = []
    for name, launch, plain in (
            ("heat_b_step_bf16", sk.strip_step, sk.strip_step_plain),
            ("heat_c_tiled_bf16", sk.tiled_step, sk.tiled_step_plain)):
        got.append(_check_bf16(_one_step(launch), _one_step(plain), u,
                               u.dtype, 1, kw, f"{name} {where}", err,
                               name))
    check(_bits_equal(got[0][0], got[1][0])
          and same_float(got[0][1], got[1][1]),
          f"heat_c_tiled_bf16 {where} != heat_b_step_bf16")
    return got[0]


def _check_m_bf16(u, k, kw, err, out=False):
    """M's bfloat16 form at depth ``k`` on the stack ``u`` against its
    plain version, with and without the residual, and its first, middle
    and last member against A's bfloat16 form on that member alone; with
    ``out`` returns its grid and residuals."""
    import torch

    from parallel_heat_tpu_torch.ops import batched
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    got = torch.full_like(u, float("nan"))
    want = torch.full_like(u, float("nan"))
    nores = torch.empty_like(u)
    r = batched.ensemble_steps(u, got, k, True, **kw)
    rp = batched.ensemble_steps_plain(u, want, k, True, **kw)
    batched.ensemble_steps(u, nores, k, False, **kw)
    torch.cuda.synchronize()
    d = float((got.float() - want.float()).abs().nan_to_num(0).max())
    err["heat_m_ensemble_bf16"] = max(err["heat_m_ensemble_bf16"], d)
    where = f"heat_m_ensemble_bf16(K={k}) at {tuple(u.shape)} {kw}"
    check(_bits_equal(got, want) and all(
        same_float(a, b) for a, b in zip(r.tolist(), rp.tolist())),
          f"{where} != its plain version: max diff {d}")
    check(_bits_equal(got, nores), f"{where}: grid depends on with_residual")
    for b in sorted({0, u.shape[0] // 2, u.shape[0] - 1}):
        one = torch.empty_like(u[b])
        ra = sk.resident_steps(u[b].contiguous(), one, k, True, **kw)
        check(_bits_equal(one, got[b]) and same_float(ra, r[b]),
              f"{where}: member {b} != heat_a_resident_bf16 on it alone")
    return (got, r) if out else None


def phase_kernels_bf16(dev):
    """The bfloat16 forms of A, E and E-uni bitwise their plain versions
    (which round at the kernels' points): E and E-uni at every depth
    each form takes (storage and acc_f32 in one launch 1 .. e_k_max, a
    chunk's first launch into a float32 level at 1 and e_k_default, its
    last from one at 1 .. e_k_max), each grid asserted to run the tile
    kinds it is there for, E on widths that are no multiple of 8, E
    against E-uni; A at K in {1, 4, 7, 20} on the grids of the float32
    phase; every form on a NaN-seeded grid (ring bit for bit, NaN
    residual), the carry as a 16-step chunk across a float32 level; and
    the main path's own launches on its 32768^2: storage at e_k_default,
    and a 16-step chunk's two carry launches. B, C and M likewise: B and
    C on the ragged grids and the main path's 32768^2, C bitwise B; M at
    K in {1, 7, 20} from one block a member to the main path's 64 x 512^2
    (and there at its K = 400), its members bitwise A's bfloat16 form
    alone; the chains of A, E and E-uni to K launches of B. Returns max
    |diff| each (NaN cells excluded: they are held bit for bit)."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    bf16, f32 = torch.bfloat16, torch.float32
    err = {name: 0.0 for name in KERNELS_BF16}
    equal = dict(cx=CX, cy=CY)
    unequal = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    e_pairs = (("heat_e_temporal", sk.temporal_steps,
                sk.temporal_steps_plain),
               ("heat_e_uni_temporal", sk.temporal_steps_uni,
                sk.temporal_steps_uni_plain))
    # (form, input dtype, output dtype, acc_f32, depths)
    depths = range(1, p.e_k_max() + 1)
    forms = ((0, bf16, bf16, False, depths), (1, bf16, bf16, True, depths),
             (2, bf16, f32, True, (1, p.e_k_default)),
             (3, f32, bf16, True, depths))
    edges = ("top", "left", "bottom", "right", "ragged_rows", "ragged_cols",
             "copies")
    plan = [((1001, 1000), [equal, unequal],
             ("inside", "interior") + edges),
            ((1001, 999), [unequal], ("inside", "interior", "partial_group")
             + edges),
            ((21, 23), [unequal], edges + ("partial_group",)),
            ((20, 24), [equal], edges)]
    report = []
    for shape, coeffs, need in plan:
        base = _rand_bf16(dev, shape, shape[1])
        kinds = {}
        for form, dt_in, dt_out, acc, ks in forms:
            u = base if dt_in == bf16 else base.float()
            for k in ks:
                got = p.e_tile_kinds(shape, k, p.e_tile)
                kinds[f"{form}/{k}"] = got
                check(all(got[kind] for kind in need),
                      f"{shape} form {form} K={k} runs no tile of some kind "
                      f"it is there for ({need}): {got}")
                for kw in coeffs:
                    grids = []
                    for name, launch, plain in e_pairs:
                        uni = name != "heat_e_temporal"
                        if uni and not p.uni_fits(shape, bf16):
                            continue
                        count = name + ("_bf16" if form == 0
                                        else "_bf16_acc")
                        grids.append(_check_bf16(
                            launch, plain, u, dt_out, k,
                            dict(kw, acc_f32=acc),
                            f"{count} form {form} (K={k}) at {shape} {kw}",
                            err, count))
                    if len(grids) == 2:
                        check(_bits_equal(grids[0][0], grids[1][0])
                              and same_float(grids[0][1], grids[1][1]),
                              f"E-uni form {form} (K={k}) at {shape} {kw} "
                              f"!= E")
        report.append({"shape": list(shape), "coeffs": coeffs,
                       "forms": {f: list(ks) for f, _, _, _, ks in forms},
                       "uni": p.uni_fits(shape, bf16), "tile_kinds": kinds,
                       "bitwise": True})
        torch.cuda.empty_cache()
    # A's bfloat16 form on the float32 phase's grids.
    a_plan = (((CONV, CONV), (1, 4, 7, WINDOW)), ((1001, 999), (1, 5, WINDOW)),
              ((107, 210), (1, 7, WINDOW)), ((20, 24), (1, 3, 9, WINDOW)),
              ((A_LARGEST, A_LARGEST), (WINDOW,)))
    for shape, ks in a_plan:
        u = _rand_bf16(dev, shape, 3)
        for k in ks:
            for kw in (equal, unequal):
                _check_bf16(sk.resident_steps, sk.resident_steps_plain, u,
                            bf16, k, kw, f"heat_a_resident_bf16(K={k}) at "
                            f"{shape} {kw}", err, "heat_a_resident_bf16")
        report.append({"a_shape": list(shape), "k": list(ks),
                       "bitwise": True})
    # B and C: each bitwise its plain version, and C bitwise B.
    for shape in ((1001, 999), (20, 24)):
        u = _rand_bf16(dev, shape, 9)
        for kw in (equal, unequal):
            _check_bc_bf16(sk, u, kw, f"at {shape} {kw}", err)
        report.append({"bc_shape": list(shape), "bitwise": True,
                       "c_is_b": True})
    # M: bitwise its plain version, each checked member bitwise A's
    # bfloat16 form on it alone; one block a member (107 x 210, 20^2,
    # 166^2, the largest) and cooperative tilings (512^2, 1000^2), the
    # main path's 64 members of 512^2 among them (fewer groups than
    # members: the stack is walked in rounds).
    for batch, shape in ((3, (107, 210)), (8, (20, 20)),
                         (8, (M_SOLO_LARGEST, M_SOLO_LARGEST)),
                         (3, (ENS_N, ENS_N)), (ENS_B, (ENS_N, ENS_N)),
                         (3, (CONV, CONV))):
        u = torch.stack([_rand_bf16(dev, shape, b) for b in range(batch)])
        for k in (1, 7, WINDOW):
            for kw in (equal, unequal):
                _check_m_bf16(u, k, kw, err)
        plan = p.m_plan(batch, shape)
        report.append({"m_members": batch, "m_shape": list(shape),
                       "k": [1, 7, WINDOW], "tiles": plan["tiles"],
                       "groups": plan["groups"], "bitwise": True,
                       "member_is_a_bf16": True})
        if batch == ENS_B:
            # The fixed main path's one launch: the full stack at K = 400.
            _check_m_bf16(u, ENS_STEPS, equal, err)
            report.append({"m_members": batch, "m_shape": list(shape),
                           "k": [ENS_STEPS], "coeffs": [equal],
                           "groups": plan["groups"], "bitwise": True,
                           "member_is_a_bf16": True})
        del u
    torch.cuda.empty_cache()
    # The chains on the card: A (K = 20 on 1000^2) and E's and E-uni's
    # storage form (K = e_k_default on 1001 x 1000) are K launches of B,
    # bit for bit (C is B, above; a member of M is A, above).
    chains = {}
    for name, launch, shape, k, kw in (
            ("heat_a_resident_bf16", sk.resident_steps, (CONV, CONV),
             WINDOW, {}),
            ("heat_e_temporal_bf16", sk.temporal_steps, (1001, 1000),
             p.e_k_default, {"acc_f32": False}),
            ("heat_e_uni_temporal_bf16", sk.temporal_steps_uni,
             (1001, 1000), p.e_k_default, {"acc_f32": False})):
        u = _rand_bf16(dev, shape, 13)
        got = torch.empty_like(u)
        r = launch(u, got, k, True, **unequal, **kw)
        src, dst = u.clone(), torch.empty_like(u)
        for _ in range(k):
            rb = sk.strip_step(src, dst, **unequal)
            src, dst = dst, src
        torch.cuda.synchronize()
        check(_bits_equal(got, src) and same_float(r, rb),
              f"{name} (K={k}) at {shape} != {k} launches of "
              f"heat_b_step_bf16")
        chains[name] = {"shape": list(shape), "k": k,
                        "equals_k_launches_of": "heat_b_step_bf16"}
    # NaN-seeded grids: the ring keeps its bits, NaN payloads included;
    # the residual is NaN; the grid is its plain version's, bit for bit.
    nan_res = {}
    u = _rand_bf16(dev, (515, 776), 5, nan=True)
    runs = [("heat_a_resident_bf16", sk.resident_steps,
             sk.resident_steps_plain, WINDOW, {})]
    for name, launch, plain in e_pairs:
        runs += [(name + "_bf16", launch, plain, p.e_k_default,
                  {"acc_f32": False}),
                 (name + "_bf16_acc", launch, plain, None, {})]
    for name, launch, plain, k, kw in runs:
        label = f"{name} on a NaN-seeded grid"
        got, r = (_check_carry(launch, plain, u, equal, label, err, name)
                  if k is None else
                  _check_bf16(launch, plain, u, bf16, k, dict(equal, **kw),
                              label, err, name))
        nan_res[name] = float(r)
        check(math.isnan(float(r)), f"NaN-seeded grid gave {name} residual "
                                    f"{float(r)}, not NaN")
        check(_ring_kept(got, u), f"{name} moved a bit of the ring")
    got = _check_bc_bf16(sk, u, equal, "on a NaN-seeded grid", err)
    nan_res["heat_b_step_bf16"] = nan_res["heat_c_tiled_bf16"] = float(
        got[1])
    check(math.isnan(float(got[1])) and _ring_kept(got[0], u),
          f"B and C on a NaN-seeded grid: residual {float(got[1])}, ring "
          f"kept {_ring_kept(got[0], u)}")
    # M on a stack whose middle member is the NaN-seeded grid: only its
    # residual is NaN, its ring keeps its bits.
    stack = torch.stack([_rand_bf16(dev, (515, 776), 6), u,
                         _rand_bf16(dev, (515, 776), 7)])
    out, r = _check_m_bf16(stack, WINDOW, equal, err, out=True)
    nan_res["heat_m_ensemble_bf16"] = [float(x) for x in r]
    check([math.isnan(float(x)) for x in r] == [False, True, False]
          and _ring_kept(out[1], u),
          f"M on a stack with a NaN-seeded member: residuals {r.tolist()}")
    del stack, out
    # The main path's launches on its 32768^2: storage at e_k_default, and
    # f32chunk's 16-step chunk as two carry launches across a float32
    # level (its remainder of 8 is form 1 at e_k_default, checked above);
    # B's and C's pinned step.
    big = _plate_grid(dev, BF16_N)
    main = {}
    _check_bc_bf16(sk, big, equal, "at 32768^2", err)
    main["heat_b_step"] = main["heat_c_tiled"] = {"bitwise": True,
                                                  "c_is_b": True}
    torch.cuda.empty_cache()
    for name, launch, plain in e_pairs:
        _check_bf16(launch, plain, big, bf16, p.e_k_default,
                    dict(equal, acc_f32=False), f"{name}_bf16 at 32768^2",
                    err, name + "_bf16")
        torch.cuda.empty_cache()
        _check_carry(launch, plain, big, equal, f"{name}_bf16_acc at "
                     f"32768^2", err, name + "_bf16_acc")
        main[name] = {"storage_k": p.e_k_default,
                      "carry_launches_k": [p.e_k_default,
                                           16 - p.e_k_default],
                      "bitwise": True}
        torch.cuda.empty_cache()
    del big
    torch.cuda.empty_cache()
    i_report = _kernels_i_bf16(dev, err, nan_res)
    report_3d = _kernels_3d_bf16(dev, err, nan_res)
    emit({"phase": "kernels_bf16", "ok": True, "checks": report,
          "chains": chains, "nan_residual": nan_res,
          "main_path_32768": main, "i_forms": i_report,
          "d_and_f_forms": report_3d, "max_abs_err": err})
    return err


def _kernels_i_bf16(dev, err, nan_res):
    """I's and I-uni's precision forms, each bitwise its plain version
    (``_check_bf16``): storage and the carry in one launch at every K,
    a chunk's first launch into a float32 level at K = 1 and
    i_k_default, its last from one at every K, on the grids of
    I_PLAN_BF16 (I-uni where its rows are 16-byte multiples), every K's
    grids asserted to run every kind of band and segment; I-uni bitwise
    I; the chains (storage at K = 3 and i_k_default on 1001 x 1000
    bitwise E's storage form and K launches of heat_b_step_bf16, the
    carry bitwise E's); the NaN-seeded grid (the ring bit for bit, a NaN
    residual) in both modes; the main path's launches at 32768^2."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    bf16, f32 = torch.bfloat16, torch.float32
    equal = dict(cx=CX, cy=CY)
    pairs = (("heat_i_tile_temporal", sk.tile_temporal_steps,
              sk.tile_temporal_steps_plain),
             ("heat_i_uni_tile_temporal", sk.tile_temporal_steps_uni,
              sk.tile_temporal_steps_uni_plain))
    depths = range(1, p.i_k_max + 1)
    forms = ((0, bf16, bf16, False, depths), (1, bf16, bf16, True, depths),
             (2, bf16, f32, True, (1, p.i_k_default)),
             (3, f32, bf16, True, depths))
    report, kinds_at = [], {}
    for shape, coeffs in I_PLAN_BF16:
        base = _rand_bf16(dev, shape, shape[1] + 7)
        for k in depths:
            for kind, count in p.i_band_kinds(shape, k).items():
                kinds_at.setdefault(k, {}).setdefault(kind, 0)
                kinds_at[k][kind] += count
        for form, dt_in, dt_out, acc, ks in forms:
            u = base if dt_in == bf16 else base.float()
            for k in ks:
                for kw in coeffs:
                    grids = []
                    for name, launch, plain in pairs:
                        if "uni" in name and not p.uni_fits(shape, dt_in):
                            continue
                        count = name + ("_bf16" if form == 0
                                        else "_bf16_acc")
                        grids.append(_check_bf16(
                            launch, plain, u, dt_out, k,
                            dict(kw, acc_f32=acc),
                            f"{count} form {form} (K={k}) at {shape} {kw}",
                            err, count))
                    if len(grids) == 2:
                        check(_bits_equal(grids[0][0], grids[1][0])
                              and same_float(grids[0][1], grids[1][1]),
                              f"I-uni form {form} (K={k}) at {shape} {kw} "
                              f"!= I")
        report.append({"shape": list(shape), "coeffs": list(coeffs),
                       "forms": {f: list(ks) for f, _, _, _, ks in forms},
                       "uni": p.uni_fits(shape, bf16), "bitwise": True})
        del base
    torch.cuda.empty_cache()
    for k, kinds in kinds_at.items():
        check(all(kinds[kind] for kind in I_BAND_KINDS),
              f"I's bfloat16 check grids at K={k} run no band or segment "
              f"of some kind: {kinds}")
    # The chains: storage bitwise E's storage form and K launches of B,
    # the carry in one launch bitwise E's carry.
    chains = {}
    u = _rand_bf16(dev, (1001, 1000), 17)
    unequal = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    for k in (3, p.i_k_default):
        src, dst = u.clone(), torch.empty_like(u)
        for _ in range(k):
            rb = sk.strip_step(src, dst, **unequal)
            src, dst = dst, src
        for acc in (False, True):
            e_out = torch.empty_like(u)
            re_ = sk.temporal_steps(u, e_out, k, True, acc_f32=acc,
                                    **unequal)
            for name, launch, _ in pairs:
                got = torch.full_like(u, float("nan"))
                r = launch(u, got, k, True, acc_f32=acc, **unequal)
                torch.cuda.synchronize()
                label = f"{name}_bf16{'_acc' if acc else ''} (K={k})"
                check(_bits_equal(got, e_out) and same_float(r, re_),
                      f"{label} at 1001x1000 != heat_e_temporal_bf16's "
                      f"form {int(acc)}")
                if not acc:
                    check(_bits_equal(got, src) and same_float(r, rb),
                          f"{label} at 1001x1000 != {k} launches of "
                          f"heat_b_step_bf16")
                chains.setdefault(name, []).append(
                    {"k": k, "form": int(acc),
                     "equals": ["heat_e_temporal_bf16"]
                     + ([] if acc else [f"{k} x heat_b_step_bf16"])})
    del u, src, dst, e_out, got
    # NaN-seeded grid: the ring keeps its bits, the residual is NaN.
    u = _rand_bf16(dev, (515, 776), 5, nan=True)
    for name, launch, plain in pairs:
        for count, acc in ((name + "_bf16", False),
                           (name + "_bf16_acc", True)):
            label = f"{count} on a NaN-seeded grid"
            got, r = (_check_carry(launch, plain, u, equal, label, err,
                                   count, p.i_k_default) if acc else
                      _check_bf16(launch, plain, u, bf16, p.i_k_default,
                                  dict(equal, acc_f32=False), label, err,
                                  count))
            nan_res[count] = float(r)
            check(math.isnan(float(r)), f"NaN-seeded grid gave {count} "
                                        f"residual {float(r)}, not NaN")
            check(_ring_kept(got, u), f"{count} moved a bit of the ring")
    del u, got
    torch.cuda.empty_cache()
    # The main path's launches on its 32768^2.
    big = _plate_grid(dev, BF16_N)
    main = {}
    for name, launch, plain in pairs:
        _check_bf16(launch, plain, big, bf16, p.i_k_default,
                    dict(equal, acc_f32=False), f"{name}_bf16 at 32768^2",
                    err, name + "_bf16")
        torch.cuda.empty_cache()
        _check_carry(launch, plain, big, equal, f"{name}_bf16_acc at "
                     f"32768^2", err, name + "_bf16_acc", p.i_k_default)
        main[name] = {"storage_k": p.i_k_default,
                      "carry_launches_k": [p.i_k_default,
                                           16 - p.i_k_default],
                      "bitwise": True}
        torch.cuda.empty_cache()
    del big
    torch.cuda.empty_cache()
    return {"checks": report, "band_kinds": kinds_at, "chains": chains,
            "main_path_32768": main}


def _rand_bf16_3d(dev, shape, seed, nan=False):
    """A random bfloat16 grid of ``shape`` (either sign, magnitudes to
    about 40); with ``nan`` NaNs of payloads no conversion makes, inside
    and on the faces."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    u = (torch.randn(shape, generator=gen, device=dev) * 10).to(
        torch.bfloat16)
    if nan:
        bits = u.view(torch.int16)
        nx, ny, nz = shape
        for at, b in zip(((nx // 2, ny // 2, nz // 3), (0, ny // 2, nz // 2),
                          (nx // 2, ny - 1, 1), (nx // 3, 1, nz - 1)),
                         BF16_NAN_PAYLOADS + (0x7FC1,)):
            bits[at] = b
    return u


def _faces_kept(out, u) -> bool:
    return all(_bits_equal(out[sl].contiguous(), u[sl].contiguous())
               for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                          np.s_[:, :, 0], np.s_[:, :, -1]))


def _check_f_bf16(sk3, u, k, kw, load, err, label):
    """F's bfloat16 form at depth ``k`` under ``load`` against its plain
    version and K launches of D's bfloat16 form (each bitwise, grid and
    residual), with and without the residual, into NaN-filled outputs.
    Returns the grid and residual."""
    import torch

    got = torch.full_like(u, float("nan"))
    want = torch.full_like(u, float("nan"))
    nores = torch.full_like(u, float("nan"))
    r = sk3.xslab_steps_3d(u, got, k, True, load=load, **kw)
    rp = sk3.xslab_steps_3d_plain(u, want, k, True, **kw)
    sk3.xslab_steps_3d(u, nores, k, False, load=load, **kw)
    chain, rd = _d_launches(sk3, u, k, kw)
    torch.cuda.synchronize()
    d = float((got.float() - want.float()).abs().nan_to_num(0).max())
    err["heat_f_temporal3d_bf16"] = max(err["heat_f_temporal3d_bf16"], d)
    where = (f"{label}: heat_f_temporal3d_bf16(K={k}, {load}) at "
             f"{tuple(u.shape)} {kw}")
    check(_bits_equal(got, want) and same_float(r, rp),
          f"{where} != its plain version: max diff {d}, residual "
          f"{float(r)} vs {float(rp)}")
    check(_bits_equal(got, chain) and same_float(r, rd),
          f"{where} != {k} launches of heat_d_step3d_bf16")
    check(_bits_equal(got, nores), f"{where}: grid depends on with_residual")
    del want, nores, chain
    return got, r


def _check_d_bf16(sk3, u, kw, err, label):
    """D's bfloat16 form against its plain version, bitwise, into
    NaN-filled outputs; returns the grid and residual."""
    import torch

    got = torch.full_like(u, float("nan"))
    want = torch.full_like(u, float("nan"))
    r = sk3.slab_step_3d(u, got, **kw)
    rp = sk3.slab_step_3d_plain(u, want, **kw)
    torch.cuda.synchronize()
    d = float((got.float() - want.float()).abs().nan_to_num(0).max())
    err["heat_d_step3d_bf16"] = max(err["heat_d_step3d_bf16"], d)
    check(_bits_equal(got, want) and same_float(r, rp),
          f"{label}: heat_d_step3d_bf16 at {tuple(u.shape)} {kw} != its "
          f"plain version: max diff {d}, residual {float(r)} vs "
          f"{float(rp)}")
    return got, r


def _kernels_3d_bf16(dev, err, nan_res):
    """D's and F's bfloat16 forms (``heat_d_step3d_bf16``,
    ``heat_f_temporal3d_bf16``), each bitwise its plain version: D on
    each grid, F at every K 1 .. 8 (at ``hopper_params.f_shape``'s launch
    shape for bfloat16) under each load the grid takes, F(K) bitwise K
    launches of D, on the main path's 512^3 and RAGGED_3D_BF16, each
    grid asserted to run at every K the tile kinds it is there for
    (``f_tile_kinds`` at 2-byte cells); a NaN-seeded grid under both
    loads (faces bit for bit, NaN residual)."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    every_k = list(range(1, p.f_k_compiled + 1))
    equal = dict(cx=CX, cy=CY, cz=CX)
    unequal = dict(zip(("cx", "cy", "cz"), UNEQUAL_3D))
    sides = ("edge", "top", "left", "bottom", "right", "ragged_z")
    need = {(CUBE,) * 3: ("interior",) + sides,
            (67, 130, 201): sides + ("partial_group",)}
    report = []
    for shape in ((CUBE,) * 3,) + RAGGED_3D_BF16:
        coeffs = [equal] if shape[0] == CUBE else [equal, unequal]
        u = _rand_bf16_3d(dev, shape, sum(shape))
        loads = ["cp.async"] + (["tma"] if sk3.f_load(shape, u) == "tma"
                                else [])
        kinds = {}
        for k in every_k:
            block, rows, _ = p.f_shape(k, 2)
            kinds[k] = p.f_tile_kinds(shape, k, block, rows, elem=2)
            want = need.get(shape, sides)
            check(all(kinds[k][kind] for kind in want),
                  f"{shape} bf16 at K={k} runs no tile of some kind it is "
                  f"there for ({want}): {kinds[k]}")
        for kw in coeffs:
            _check_d_bf16(sk3, u, kw, err, "kernels_bf16")
            for k in every_k:
                for load in loads:
                    _check_f_bf16(sk3, u, k, kw, load, err, "kernels_bf16")
        report.append({"shape": list(shape), "coeffs": coeffs,
                       "k": every_k, "loads": loads, "tile_kinds": kinds,
                       "shapes": {k: p.f_shape(k, 2) for k in every_k},
                       "bitwise": True, "f_is_k_launches_of_d": True})
        del u
        torch.cuda.empty_cache()
    # The bfloat16 form's launcher takes hopper_params.f_takes' shapes at
    # 2-byte cells (12 warps at most for 1 or 2 rows at K >= 4).
    u = _rand_bf16_3d(dev, (8, 40, 48), 4)
    o = torch.empty_like(u)
    for block, rows, k in F_SHAPE_RULE_BF16:
        try:
            sk3._launch_f(u, o, k, None, CX, CY, CX, block, rows, 8,
                          "cp.async", 2)
            taken = True
        except RuntimeError:
            taken = False
        check(taken == p.f_takes(block, rows, k, elem=2),
              f"F bf16's launcher {'took' if taken else 'refused'} {block} "
              f"x {rows} rows at K={k}; f_takes says "
              f"{p.f_takes(block, rows, k, elem=2)}")
    torch.cuda.synchronize()
    report.append({"shape_rule_bf16": F_SHAPE_RULE_BF16, "agrees": True})
    # A NaN-seeded grid: NaN residual, the faces bit for bit.
    u = _rand_bf16_3d(dev, (60, 70, 96), 5, nan=True)
    got, r = _check_d_bf16(sk3, u, equal, err, "NaN-seeded grid")
    nan_res["heat_d_step3d_bf16"] = float(r)
    check(math.isnan(float(r)) and _faces_kept(got, u),
          f"D bf16 on a NaN-seeded grid: residual {float(r)}, faces kept "
          f"{_faces_kept(got, u)}")
    for load in ("tma", "cp.async"):
        got, r = _check_f_bf16(sk3, u, p.f_k_default, equal, load, err,
                               "NaN-seeded grid")
        nan_res[f"heat_f_temporal3d_bf16 {load}"] = float(r)
        check(math.isnan(float(r)) and _faces_kept(got, u),
              f"F bf16 ({load}) on a NaN-seeded grid: residual {float(r)}, "
              f"faces kept {_faces_kept(got, u)}")
    del u, got
    torch.cuda.empty_cache()
    return report


def _plate_grid(dev, n, dtype="bfloat16"):
    from parallel_heat_tpu_torch.models import HeatPlate2D

    return HeatPlate2D(n, n).init_grid(dev, dtype)


def _step_f64(u, v, tmp, a0, cx, cy):
    """One float64 step of ``u`` into ``v`` (whose ring holds u's), with
    interior-shaped scratch ``tmp``: the oracle, on the card."""
    import torch

    inner = v[1:-1, 1:-1]
    torch.add(u[2:, 1:-1], u[:-2, 1:-1], out=tmp)
    torch.add(u[1:-1, 2:], u[1:-1, :-2], out=inner)
    inner.mul_(cy).add_(tmp, alpha=cx).add_(u[1:-1, 1:-1], alpha=a0)


def _oracle_err(start, grids, steps):
    """The error of each grid of ``grids`` against a float64 oracle run
    from ``start`` (the runs' initial bfloat16 grid, widened) for
    ``steps`` steps on the card: ``max |got - ref| / max |ref|``, and the
    largest and the mean per-cell relative error over the cells above
    1e-3 of the grid's peak; and the same of the oracle rounded to
    bfloat16, the floor no bfloat16 grid can go below."""
    import torch

    u = start.double()
    v = u.clone()
    tmp = torch.empty_like(u[1:-1, 1:-1])
    a0 = 1.0 - 2.0 * CX - 2.0 * CY
    for _ in range(steps):
        _step_f64(u, v, tmp, a0, CX, CY)
        u, v = v, u
    del v, tmp
    peak = float(u.abs().max())
    out = {}
    for label, g in dict(grids, oracle_rounded=None).items():
        worst_abs = worst_rel = total = 0.0
        count = 0
        for r in range(0, u.shape[0], 2048):      # slabs: 0.5 GiB each
            ref = u[r:r + 2048]
            got = (ref.to(torch.bfloat16) if g is None
                   else g[r:r + 2048]).double()
            d = (got - ref).abs()
            worst_abs = max(worst_abs, float(d.max()))
            big = ref.abs() >= 1e-3 * peak
            rel = d[big] / ref.abs()[big]
            worst_rel = max(worst_rel, float(rel.max()))
            total += float(rel.sum())
            count += int(rel.numel())
        out[label] = {"max_abs_over_peak": worst_abs / peak,
                      "max_rel_above_1e-3_peak": worst_rel,
                      "mean_rel_above_1e-3_peak": total / count}
    return out


def _bf16_run(cfg, kernel, force=None, profile=False, site="single_2d"):
    """solve(cfg) by the default pick, or with ``force`` pinned at
    ``site``, its counts set to 0 just before and read just after:
    ``kernel`` launched, no other kernel or plain version; with
    ``profile`` a second run under the profiler for the card's busy share
    and the kernel's device ms a launch."""
    import contextlib

    from parallel_heat_tpu_torch import solve, tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    pin = (tune.force(site, force) if force
           else contextlib.nullcontext())
    with pin:
        sk.reset_counts()
        res = solve(cfg)
        counts = {k: n for k, n in sk.counts.items() if n}
        check(counts.get(kernel, 0) > 0 and set(counts) == {kernel},
              f"{cfg.shape} {cfg.dtype}/{cfg.accumulate} "
              f"{force or 'default'}: counts {counts}, {kernel} expected")
        out = {"res": res, "launches": counts[kernel]}
        if profile:
            out["busy"] = _busy(lambda: solve(cfg), f"{kernel} profiled")
            _, per = _profiled(lambda: solve(cfg))
            fn = kernel.removesuffix("_acc")     # its __global__'s prefix
            hits = [v for key, v in per.items()
                    if re.search(rf"(^|\W){fn}_kernel\b", key)]
            records = sum(n for _, n in hits)
            out["device_ms_per_launch"] = (
                sum(ms for ms, _ in hits) / records if records else None)
            out["profiler_records"] = records
    return out


def _moving_grid_err(n=4096, steps=MAIN_STEPS):
    """Storage and f32chunk told apart by the float64 oracle: an n x n
    grid of values uniform in [0, 40), made from a seed, moves at every
    cell, so per-step rounding (storage) drifts from the oracle and a
    chunk's one rounding (f32chunk) stays near the floor of the oracle
    rounded to bfloat16. Each mode's run by the default pick, through
    solve(); f32chunk held under 8e-3 of the peak (its reading 3.6e-3,
    storage's 0.10, on an H100, PERF.md section 5) and its mean relative
    error under a fifth of storage's (readings 1.6e-3 and 4.4e-2), so
    that a carry that rounded every level fails."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    u0 = torch.from_numpy(np.random.default_rng(23).uniform(
        0.0, 40.0, (n, n)).astype(np.float32)).to("cuda").to(torch.bfloat16)
    grids = {}
    for mode in ("storage", "f32chunk"):
        cfg = HeatConfig(nx=n, ny=n, steps=steps, dtype="bfloat16",
                         accumulate=mode, cx=CX, cy=CY)
        grids[mode] = solve(cfg, initial=u0).grid
    out = _oracle_err(u0, grids, steps)
    carry, stored = out["f32chunk"], out["storage"]
    check(carry["max_abs_over_peak"] < 8e-3
          and carry["mean_rel_above_1e-3_peak"]
          < stored["mean_rel_above_1e-3_peak"] / 5,
          f"{n}^2 moving bf16 grid against the float64 oracle: {out}")
    return {"shape": [n, n], "steps": steps, **out}


def _launches_bf16(kind, mode, steps):
    """The launches a 32768^2 bfloat16 run of ``steps`` makes under
    ``kind`` (B and C one a step; E, E-uni, I and I-uni a launch of their
    default depth in storage mode, a carry chunk of F32CHUNK_DEPTH in two
    launches and a remainder in one or two under f32chunk)."""
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH

    if kind in ("B", "C"):
        return steps
    p = params()
    k = p.i_k_default if kind in ("I", "I-uni") else p.e_k_default
    if mode == "storage":
        return -(-steps // k)
    chunks, rem = divmod(steps, F32CHUNK_DEPTH)
    return chunks * -(-F32CHUNK_DEPTH // k) + -(-rem // k)


def phase_main_path_bf16():
    """BASELINE config 4 at full width: 32768^2 bfloat16, 200 fixed steps,
    through the default pick (E-uni) and forced E, I and I-uni, in
    storage mode and under f32chunk, and forced B and C in storage mode;
    the counts set to 0 before each run and read after, each run's
    launches exactly its form's count (:func:`_launches_bf16`); a pinned
    f32chunk solve_stream (I-uni, chunks of 80) and a pinned f32chunk
    converge run (I, the stop test every 40 steps) bitwise their E-uni
    runs; the kernels' grids bitwise equal in each mode; each run's
    Mcells*steps/s and device ms a launch, the default runs' idle share;
    and each mode's error against a float64 oracle of the same 200 steps
    from the same initial grid, run on the card; then the two modes held
    apart on a grid that moves (:func:`_moving_grid_err`). Returns each
    form's launches in its run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig

    n, steps = BF16_N, MAIN_STEPS
    cells = n * n * steps / 1e6
    runs, out, keep = {}, {}, {}
    for mode in ("storage", "f32chunk"):
        cfg = HeatConfig(nx=n, ny=n, steps=steps, dtype="bfloat16",
                         accumulate=mode)
        suffix = "_bf16" if mode == "storage" else "_bf16_acc"
        first = None
        # B and C (pinned) round every step: storage mode only.
        pins = ((("E-uni", None), ("E", "E"), ("I", "I"), ("I-uni", "I-uni"))
                + ((("B", "B"), ("C", "C")) if mode == "storage" else ()))
        for kind, force in pins:
            name = {"E-uni": "heat_e_uni_temporal", "E": "heat_e_temporal",
                    "I": "heat_i_tile_temporal",
                    "I-uni": "heat_i_uni_tile_temporal",
                    "B": "heat_b_step", "C": "heat_c_tiled"}[kind] + suffix
            r = _bf16_run(cfg, name, force, profile=True)
            res = r["res"]
            check(res.steps_run == steps and res.grid.dtype == torch.bfloat16
                  and tuple(res.grid.shape) == (n, n),
                  f"{name}: {res.steps_run} steps, {res.grid.dtype}")
            want = _launches_bf16(kind, mode, steps)
            check(r["launches"] == want, f"{name}: {r['launches']} "
                                         f"launches in a run, not {want}")
            check(bool(torch.isfinite(res.grid).all()),
                  f"{name}: non-finite grid")
            if first is None:
                first = res.grid
                keep[mode] = res.grid
            else:
                check(_bits_equal(res.grid, first),
                      f"32768^2 {mode}: {name} differs from E-uni")
            runs[name] = r["launches"]
            out[f"{mode} {kind}"] = {
                "kernel": name, "launches": r["launches"],
                "elapsed_s": res.elapsed_s,
                "mcells_steps_per_s": cells / res.elapsed_s,
                "device_ms_per_launch": r["device_ms_per_launch"],
                "profiler_records": r["profiler_records"],
                "idle_share": r["busy"]["idle_share"], "busy": r["busy"]}
            del res
        torch.cuda.empty_cache()
    out["f32chunk pinned stream and converge"] = _pinned_i_runs(
        keep["f32chunk"])
    # The plate barely moves in 200 steps: both modes sit on the floor of
    # the oracle rounded to bfloat16, so this is printed, not held.
    start = _plate_grid(torch.device("cuda", 0), n)
    out["error_vs_f64_oracle"] = _oracle_err(start, keep, steps)
    del keep, start
    torch.cuda.empty_cache()
    out["moving_grid_vs_f64_oracle"] = _moving_grid_err()
    emit({"phase": "main_path_bf16", "ok": True, "shape": [n, n],
          "steps": steps, "dtype": "bfloat16", "runs": out,
          "bitwise_across_kernels": True})
    return runs


def phase_main_path_3d_bf16():
    """BASELINE config 5 at bfloat16: ``solve(HeatConfig(nx=512, ny=512,
    nz=512, steps=200, dtype="bfloat16"))`` by the default pick (F's
    bfloat16 form, exactly ceil(200 / K) launches) and pinned to D
    (exactly 200), counts set to 0 before each run and read after, the two
    grids bitwise equal; a 64^3 converge run under each, bitwise between
    them and the CPU's plain versions; a bfloat16 ``solve_stream`` of the
    512^3 run in chunks of 40, bitwise ``solve()``; float64 on the torch
    route (no kernel launched) at 512^3, and at 64^3 bitwise the CPU's;
    an 8 x 64^3 bfloat16 ensemble on the vmap route, every member bitwise
    its solo torch-route ``solve()``; the CLI with ``--nz 64 --dtype
    bfloat16``, its .npy the solver's grid's bytes. Returns the two
    kernels' launches in the 512^3 runs."""
    import torch

    from parallel_heat_tpu_torch import EnsembleSolver, HeatConfig, solve
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.solver import explain, solve_stream

    p = params()
    bf16 = torch.bfloat16
    out, launches = {}, {}
    cfg = HeatConfig(nx=CUBE, ny=CUBE, nz=CUBE, steps=MAIN_STEPS,
                     dtype="bfloat16")
    cells = CUBE ** 3 * MAIN_STEPS / 1e6
    f = _bf16_run(cfg, "heat_f_temporal3d_bf16", profile=True)
    d = _bf16_run(cfg, "heat_d_step3d_bf16", force="D", site="single_3d")
    fr, dr = f["res"], d["res"]
    check(f["launches"] == -(-MAIN_STEPS // p.f_k_default)
          and d["launches"] == MAIN_STEPS,
          f"512^3 bf16 launches: F {f['launches']}, D {d['launches']}")
    check(fr.grid.dtype == bf16 and tuple(fr.grid.shape) == (CUBE,) * 3
          and fr.steps_run == dr.steps_run == MAIN_STEPS
          and bool(torch.isfinite(fr.grid).all()),
          f"512^3 bf16: {fr.grid.dtype}, {tuple(fr.grid.shape)}, steps "
          f"{fr.steps_run}")
    check(_bits_equal(fr.grid, dr.grid), "512^3 bf16: F's grid != D's")
    for name, run in (("heat_f_temporal3d_bf16", f),
                      ("heat_d_step3d_bf16", d)):
        launches[name] = run["launches"]
        out[f"512^3 {name}"] = {
            "launches": run["launches"], "elapsed_s": run["res"].elapsed_s,
            "mcells_steps_per_s": cells / run["res"].elapsed_s,
            **({"idle_share": run["busy"]["idle_share"],
                "device_ms_per_launch": run["device_ms_per_launch"],
                "profiler_records": run["profiler_records"]}
               if "busy" in run else {})}
    out["bitwise_f_d"] = True
    # The stream of the same run, in chunks of 40.
    seen = []
    for r in solve_stream(cfg, chunk_steps=40):
        seen.append(r.steps_run)
        last = r.grid
    check(seen == list(range(40, MAIN_STEPS + 1, 40))
          and _bits_equal(last, fr.grid),
          f"512^3 bf16 stream yields {seen}, bitwise "
          f"{_bits_equal(last, fr.grid)}")
    out["512^3 stream"] = {"chunk_steps": 40, "yields": seen,
                           "bitwise_solve": True}
    del f, d, fr, dr, last
    torch.cuda.empty_cache()
    # Converge at 64^3 under each kernel, bitwise between them and the
    # CPU's plain versions.
    ccfg = HeatConfig(nx=64, ny=64, nz=64, steps=1000, converge=True,
                      check_interval=WINDOW, eps=1e-3, dtype="bfloat16")
    cpu = solve(ccfg.replace(backend="cuda"), device="cpu")
    conv = {}
    for name, force in (("heat_f_temporal3d_bf16", None),
                        ("heat_d_step3d_bf16", "D")):
        run = _bf16_run(ccfg, name, force=force, site="single_3d")
        r = run["res"]
        check((r.steps_run, r.converged) == (cpu.steps_run, cpu.converged)
              and same_float(r.residual, cpu.residual)
              and _bits_equal(r.grid.cpu(), cpu.grid),
              f"64^3 bf16 converge under {name}: {r.steps_run} steps, "
              f"{r.converged}, {r.residual}; the CPU: {cpu.steps_run}, "
              f"{cpu.converged}, {cpu.residual}")
        conv[name] = {"steps_run": r.steps_run, "converged": r.converged,
                      "residual": r.residual, "launches": run["launches"],
                      "elapsed_s": r.elapsed_s}
    out["64^3 converge"] = {**conv, "bitwise_cpu": True}
    # float64: the torch route on the card, no kernel.
    f64 = HeatConfig(nx=CUBE, ny=CUBE, nz=CUBE, steps=MAIN_STEPS,
                     dtype="float64")
    sk.reset_counts()
    res = solve(f64)
    launched = {k: n for k, n in sk.counts.items() if n}
    check(not launched and res.grid.dtype == torch.float64
          and bool(torch.isfinite(res.grid).all())
          and explain(f64)["backend"] == "torch",
          f"512^3 float64: counts {launched}, {res.grid.dtype}")
    out["512^3 float64"] = {"route": explain(f64)["path"],
                            "elapsed_s": res.elapsed_s,
                            "mcells_steps_per_s": cells / res.elapsed_s,
                            "launched": launched}
    del res
    torch.cuda.empty_cache()
    small = f64.replace(nx=64, ny=64, nz=64)
    gpu, host = solve(small), solve(small, device="cpu")
    check(_bits_equal(gpu.grid.cpu(), host.grid),
          "64^3 float64 on the card != the CPU's")
    out["64^3 float64"] = {"bitwise_cpu": True}
    # A bfloat16 ensemble on the vmap route: every member bitwise its
    # solo torch-route solve().
    ecfg = HeatConfig(nx=64, ny=64, nz=64, steps=MAIN_STEPS,
                      dtype="bfloat16")
    batch = 8
    inits = torch.stack([_rand_bf16_3d("cuda", (64,) * 3, b).abs()
                         for b in range(batch)])
    es = EnsembleSolver(ecfg, batch)
    check(es.path == "vmap", f"3D bf16 ensemble path {es.path!r}")
    sk.reset_counts()
    ens = es.solve(initials=inits)
    launched = {k: n for k, n in sk.counts.items()
                if n and k.startswith("heat_")}
    check(not launched and ens.grids.dtype == bf16
          and ens.steps_run.tolist() == [MAIN_STEPS] * batch,
          f"3D bf16 ensemble: launched {launched}, {ens.grids.dtype}, "
          f"steps {ens.steps_run.tolist()}")
    for i in range(batch):
        one = solve(ecfg.replace(backend="torch"), initial=inits[i])
        check(_bits_equal(ens.grids[i], one.grid),
              f"3D bf16 member {i} != its solo torch-route solve()")
    out[f"{batch}x64^3 bf16 vmap"] = {"elapsed_s": ens.elapsed_s,
                                      "members_bitwise_solo_torch": True}
    # The CLI: its .npy the solver's grid's bytes ('<V2' cells).
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v.npy")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "64",
               "--ny", "64", "--nz", "64", "--steps", str(MAIN_STEPS),
               "--dtype", "bfloat16", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"3D bf16 CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        want = solve(ecfg).grid.cpu().contiguous()
        with open(path, "rb") as fp:
            np.lib.format.read_magic(fp)
            header = np.lib.format.read_array_header_1_0(fp)
            body = fp.read()
        check(header[0] == (64, 64, 64) and header[2] == np.dtype("V2")
              and body == want.view(torch.int16).numpy().tobytes(),
              f"the 3D bf16 CLI's .npy ({header}) differs from the solver's "
              f"grid")
    out["cli"] = {"argv": cmd[3:-2], "stdout":
                  proc.stdout.strip().splitlines()}
    emit({"phase": "main_path_3d_bf16", "ok": True, "shape": [CUBE] * 3,
          "steps": MAIN_STEPS, **out})
    return launches


def _pinned_i_runs(whole):
    """32768^2 bfloat16 under f32chunk, 200 steps: solve_stream pinned to
    I-uni in chunks of 80, its last grid bitwise ``whole`` (the default
    E-uni solve()); a converge run (eps far below the plate's ulps, the
    stop test every 40 steps: it runs to its cap) pinned to I, bitwise
    the default's converge run, its steps, stop and residual equal. The
    counts are set to 0 just before each run and read just after."""
    from parallel_heat_tpu_torch import HeatConfig, solve, tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.solver import solve_stream

    n, steps = BF16_N, MAIN_STEPS
    cfg = HeatConfig(nx=n, ny=n, steps=steps, dtype="bfloat16",
                     accumulate="f32chunk")
    out = {}
    with tune.force("single_2d", "I-uni"):
        sk.reset_counts()
        seen, last = [], None
        for r in solve_stream(cfg, chunk_steps=80):
            seen.append(r.steps_run)
            last = r.grid
        counts = {k: c for k, c in sk.counts.items() if c}
    kernel = "heat_i_uni_tile_temporal_bf16_acc"
    check(seen == [80, 160, 200] and set(counts) == {kernel}
          and _bits_equal(last, whole),
          f"32768^2 f32chunk stream pinned to I-uni: yields {seen}, counts "
          f"{counts}, bitwise E-uni's solve() {_bits_equal(last, whole)}")
    out["stream I-uni"] = {"chunk_steps": 80, "yields": seen,
                           "launches": counts[kernel], "bitwise_solve": True}
    del last
    conv = cfg.replace(converge=True, eps=1e-30, check_interval=40)
    ref = solve(conv)
    with tune.force("single_2d", "I"):
        sk.reset_counts()
        got = solve(conv)
        counts = {k: c for k, c in sk.counts.items() if c}
    kernel = "heat_i_tile_temporal_bf16_acc"
    check(set(counts) == {kernel} and _bits_equal(got.grid, ref.grid)
          and (got.steps_run, got.converged) == (ref.steps_run,
                                                 ref.converged) == (steps,
                                                                    False)
          and same_float(got.residual, ref.residual),
          f"32768^2 f32chunk converge pinned to I: {got.steps_run} "
          f"{got.converged} {got.residual}, counts {counts}; E-uni's "
          f"{ref.steps_run} {ref.converged} {ref.residual}")
    out["converge I"] = {"check_interval": 40, "steps_run": got.steps_run,
                         "converged": got.converged,
                         "residual": got.residual,
                         "launches": counts[kernel], "bitwise_e_uni": True}
    return out


def phase_precision():
    """The rest of the precision path on the card: 1000^2 bfloat16 to
    eps = 1e-3 on A through the window graphs, bitwise the eager
    executor (it runs to its cap: the plate's bfloat16 ulps dwarf eps);
    a bfloat16 f32chunk solve_stream in chunks of 40 steps (rounded up to
    48) bitwise solve(); the CLI at 1024^2 with --dtype bfloat16
    --accumulate f32chunk, its .dat the solver's grid's; and the float64
    route (torch, no kernel launched) bitwise the CPU's. Returns A's
    bfloat16 launches in the converge run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.solver import explain, solve_stream
    from parallel_heat_tpu_torch.utils.io import write_dat

    out = {}
    cfg = HeatConfig(nx=CONV, ny=CONV, steps=10000, converge=True,
                     check_interval=WINDOW, eps=1e-3, dtype="bfloat16")
    graph = _loop_run(cfg, False, True)
    eager = _loop_run(cfg, True, False)
    g, e = graph["res"], eager["res"]
    check(set(graph["counts"]) == {"heat_a_resident_bf16"}
          and graph["counts"] == eager["counts"],
          f"1000^2 bf16 converge counts {graph['counts']} vs "
          f"{eager['counts']}")
    check((g.steps_run, g.converged) == (e.steps_run, e.converged)
          and same_float(g.residual, e.residual)
          and _bits_equal(g.grid, e.grid),
          f"1000^2 bf16 converge: graphs {g.steps_run} {g.converged} "
          f"{g.residual}, eager {e.steps_run} {e.converged} {e.residual}")
    check(g.steps_run == 10000 and not g.converged,
          f"1000^2 bf16 converge ran {g.steps_run} steps")
    a_launches = graph["counts"]["heat_a_resident_bf16"]
    out["1000^2 bf16 converge A"] = {
        "steps_run": g.steps_run, "converged": g.converged,
        "residual": g.residual, "elapsed_s": g.elapsed_s,
        "eager_elapsed_s": e.elapsed_s, "launches": a_launches,
        "graph_reads": graph["dl"].get("reads"),
        "idle_share": graph["busy"]["idle_share"], "bitwise_eager": True}
    del graph, eager, g, e
    # A stream whose chunk is no multiple of the chunk depth: rounded up;
    # the observers on a bfloat16 grid (the guard; the diagnostics, their
    # sums in float32).
    cfg = HeatConfig(nx=4096, ny=4096, steps=MAIN_STEPS, dtype="bfloat16",
                     accumulate="f32chunk")
    whole = solve(cfg).grid
    seen, samples = [], []
    for r in solve_stream(cfg.replace(guard_interval=48, diag_interval=96),
                          chunk_steps=40):
        seen.append(r.steps_run)
        check(r.finite in (None, True), f"bf16 stream guard: {r.finite}")
        if r.diagnostics is not None:
            samples.append(r.diagnostics)
        last = r.grid.clone()
    check(seen == list(range(48, MAIN_STEPS, 48)) + [MAIN_STEPS]
          and _bits_equal(last, whole) and samples
          and all(math.isfinite(d["heat"]) for d in samples),
          f"bf16 f32chunk stream yields {seen}, bitwise "
          f"{_bits_equal(last, whole)}, samples {samples}")
    out["4096^2 f32chunk stream"] = {"chunk_steps": 40, "yields": seen,
                                     "bitwise_solve": True,
                                     "diagnostics": samples}
    del whole, last
    # The CLI.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bf16.dat")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx",
               "1024", "--ny", "1024", "--steps", str(MAIN_STEPS), "--dtype",
               "bfloat16", "--accumulate", "f32chunk", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"bf16 CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "ref.dat")
        cli_cfg = HeatConfig(nx=1024, ny=1024, steps=MAIN_STEPS,
                             dtype="bfloat16", accumulate="f32chunk")
        write_dat(ref, solve(cli_cfg).grid)
        with open(path, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(), "the bf16 CLI's .dat differs from "
                                        "write_dat of the solver's grid")
    out["cli"] = {"argv": cmd[3:-2], "stdout":
                  proc.stdout.strip().splitlines()}
    # The float64 route: the torch route on the card, no kernel.
    cfg = HeatConfig(nx=1024, ny=1024, steps=MAIN_STEPS, dtype="float64")
    sk.reset_counts()
    gpu = solve(cfg)
    launched = {k: n for k, n in sk.counts.items() if n}
    cpu = solve(cfg, device="cpu")
    check(not launched and gpu.grid.dtype == torch.float64
          and _bits_equal(gpu.grid.cpu(), cpu.grid)
          and explain(cfg)["backend"] == "torch",
          f"float64 route: counts {launched}, bitwise the CPU "
          f"{_bits_equal(gpu.grid.cpu(), cpu.grid)}")
    out["float64 1024^2"] = {"route": explain(cfg)["path"],
                             "elapsed_s": gpu.elapsed_s,
                             "bitwise_cpu": True}
    emit({"phase": "precision", "ok": True, **out})
    return a_launches


# The bfloat16 converge ensemble: eight members of 256^2 noise in [0, 100)
# times these scales, to eps = 1e-2: the three smallest stop at steps 20,
# 40 and 80, the others run to the cap on the bfloat16 floor (their
# residual's floor is an ulp of their values times the coefficients).
ENS_BF16_SCALES = (1.0, 0.5, 0.2, 0.1, 0.05, 0.02, 0.01, 2.0)


def phase_ensemble_bf16(dev):
    """Ensembles at bfloat16, f32chunk and float64 on the card: 64 x 512^2
    bfloat16, 400 fixed steps, path M in one launch of
    ``heat_m_ensemble_bf16``, every member bitwise its solo bfloat16
    ``solve()`` (A's bfloat16 form); 8 x 256^2 bfloat16 noise to eps on M,
    bitwise each solo converge run; 8 x 512^2 bfloat16 under f32chunk, 400
    steps, on the vmap route (no kernel), every member bitwise a solo
    ``solve()`` with ``backend="torch"`` on the card; and 4 x 512^2
    float64 on the vmap route, likewise. Counts set to 0 just before each
    run and read just after. Returns M's bfloat16 launches in the 64 x
    512^2 run."""
    import torch

    from parallel_heat_tpu_torch import EnsembleSolver, HeatConfig, solve
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    bf16 = torch.bfloat16
    out = {}
    cfg = HeatConfig(nx=ENS_N, ny=ENS_N, steps=ENS_STEPS, dtype="bfloat16")
    inits = _member_inits(dev, ENS_N, [1.0 + i / ENS_B
                                       for i in range(ENS_B)]).to(bf16)
    es = EnsembleSolver(cfg, ENS_B)
    check(es.path == "M", f"bf16 ensemble path {es.path!r}, not 'M'")
    es.solve(initials=inits)     # the stack's buffers' first cudaMalloc
    sk.reset_counts()
    res = es.solve(initials=inits)
    counts = {k: n for k, n in sk.counts.items() if n}
    check(counts == {"heat_m_ensemble_bf16": 1},
          f"{ENS_B} x {ENS_N}^2 bf16 fixed: counts {counts}, one launch of "
          f"heat_m_ensemble_bf16 expected")
    launches = counts["heat_m_ensemble_bf16"]
    check(res.grids.dtype == bf16
          and tuple(res.grids.shape) == (ENS_B, ENS_N, ENS_N)
          and bool(torch.isfinite(res.grids).all())
          and res.steps_run.tolist() == [ENS_STEPS] * ENS_B,
          f"bf16 ensemble: {res.grids.dtype}, {tuple(res.grids.shape)}, "
          f"steps {res.steps_run.tolist()}")
    solo_s = 0.0
    for i in range(ENS_B):
        one = solve(cfg, initial=inits[i])
        solo_s += one.elapsed_s
        check(_bits_equal(res.grids[i], one.grid),
              f"bf16 member {i} != its solo solve()")
    cells = ENS_B * ENS_N * ENS_N * ENS_STEPS / 1e6
    out[f"{ENS_B}x{ENS_N}^2 M"] = {
        "launches": launches, "elapsed_s": res.elapsed_s,
        "mcells_steps_per_s": cells / res.elapsed_s,
        "solo_solves_s": solo_s, "members_bitwise_solo": True}
    del res, inits
    torch.cuda.empty_cache()
    # Converge on M: per-member verdicts, bitwise each solo run.
    n, cap = 256, 1990
    ccfg = HeatConfig(nx=n, ny=n, steps=cap, converge=True,
                      check_interval=WINDOW, eps=1e-2, dtype="bfloat16")
    inits = _member_inits(dev, n, ENS_BF16_SCALES, "noise").to(bf16)
    es = EnsembleSolver(ccfg, len(ENS_BF16_SCALES))
    check(es.path == "M", f"bf16 converge ensemble path {es.path!r}")
    sk.reset_counts()
    res = es.solve(initials=inits)
    counts = {k: n for k, n in sk.counts.items() if n}
    check(set(counts) == {"heat_m_ensemble_bf16"},
          f"bf16 converge ensemble counts {counts}")
    for i in range(len(ENS_BF16_SCALES)):
        one = solve(ccfg, initial=inits[i])
        check(_bits_equal(res.grids[i], one.grid)
              and int(res.steps_run[i]) == one.steps_run
              and bool(res.converged[i]) == one.converged
              and same_float(res.residual[i], one.residual),
              f"bf16 converge member {i}: {int(res.steps_run[i])} steps, "
              f"{float(res.residual[i])}; solo {one.steps_run}, "
              f"{one.residual}")
    check(len(set(res.steps_run.tolist())) > 2,
          f"bf16 converge members stopped together: "
          f"{res.steps_run.tolist()}")
    out[f"{len(ENS_BF16_SCALES)}x{n}^2 M converge"] = {
        "eps": 1e-2, "steps_run": res.steps_run.tolist(),
        "converged": res.converged.tolist(),
        "residual": res.residual.tolist(), "launches":
        counts["heat_m_ensemble_bf16"], "elapsed_s": res.elapsed_s,
        "members_bitwise_solo": True}
    del res, inits
    # f32chunk and float64: the vmap route, every member bitwise the solo
    # torch route on the card.
    for label, batch, kw in (("f32chunk", 8, dict(dtype="bfloat16",
                                                  accumulate="f32chunk")),
                             ("float64", 4, dict(dtype="float64"))):
        vcfg = HeatConfig(nx=ENS_N, ny=ENS_N, steps=ENS_STEPS, **kw)
        inits = _member_inits(dev, ENS_N, [1.0 + i for i in range(batch)]
                              ).to(torch.bfloat16 if label == "f32chunk"
                                   else torch.float64)
        es = EnsembleSolver(vcfg, batch)
        check(es.path == "vmap", f"{label} ensemble path {es.path!r}")
        sk.reset_counts()
        res = es.solve(initials=inits)
        launched = {k: n for k, n in sk.counts.items()
                    if n and k.startswith("heat_")}
        check(not launched, f"{label} ensemble launched {launched}")
        for i in range(batch):
            one = solve(vcfg.replace(backend="torch"), initial=inits[i])
            check(_bits_equal(res.grids[i], one.grid),
                  f"{label} member {i} != its solo torch-route solve()")
        check(res.grids.dtype == inits.dtype
              and bool(torch.isfinite(res.grids).all()),
              f"{label} ensemble grids {res.grids.dtype}")
        out[f"{batch}x{ENS_N}^2 {label} vmap"] = {
            "elapsed_s": res.elapsed_s, "members_bitwise_solo_torch": True}
        del res, inits
        torch.cuda.empty_cache()
    emit({"phase": "ensemble_bf16", "ok": True, **out})
    return {"heat_m_ensemble_bf16": launches}


def phase_implicit_precision(dev):
    """512^2 backward Euler and Crank-Nicolson, cx = cy = 22.5, 20 steps,
    at bfloat16 and float64 under ``backend="cuda"``: through the transfer
    kernels (counted: restrict and prolong, (levels - 1) a cycle, and no
    plain transfer) and the device loop's graphs, bitwise the eager
    executor; bitwise the torch backend on the card, as the float32
    implicit phase is (the transfers are float32 and bitwise their plain
    versions); the ring bit for bit; a float64 run bitwise the float32
    run, widened (every stored level is a float32 value)."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.config import multigrid_level_shapes
    from parallel_heat_tpu_torch.ops import multigrid as mg
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.utils import device_loop as dl

    levels = len(multigrid_level_shapes((IMP_N, IMP_N)))
    u32 = _rand_on(dev, (IMP_N, IMP_N), seed=11).abs() + 1.0
    transfers = {"heat_mg_restrict", "heat_mg_prolong"}
    out = {}
    for scheme in ("backward_euler", "crank_nicolson"):
        f32 = None
        for dtype in ("bfloat16", "float64", "float32"):
            cfg = HeatConfig(nx=IMP_N, ny=IMP_N, cx=IMP_C, cy=IMP_C,
                             steps=IMP_STEPS, scheme=scheme, dtype=dtype,
                             backend="cuda")
            if dtype == "float32":
                # The float32 run from the same grid, for comparison.
                mg.reset_stats()
                f32 = solve(cfg, initial=u32)
                out[f"implicit {scheme} float32"] = {
                    "elapsed_s": f32.elapsed_s,
                    "cycles_per_step": mg.stats["cycles"] / IMP_STEPS}
                continue
            u0 = u32.to(torch.bfloat16 if dtype == "bfloat16"
                        else torch.float64)
            label = f"implicit {scheme} {dtype}"
            sk.reset_counts()
            mg.reset_stats()
            dl.reset_stats()
            res = solve(cfg, initial=u0)
            counts = {k: n for k, n in sk.counts.items() if n}
            stats, dls = dict(mg.stats), dict(dl.stats)
            check(set(counts) == transfers and all(
                counts[t] == stats["cycles"] * (levels - 1) > 0
                for t in transfers),
                f"{label}: counts {counts}, {stats['cycles']} cycles")
            check(dls["graphs"] > 0 and dls["launches"] > 0,
                  f"{label}: no graph ran: {dls}")
            with dl.eager():
                ee = solve(cfg, initial=u0)
            check(_bits_equal(res.grid, ee.grid),
                  f"{label}: graphs != the eager executor")
            plain = solve(cfg.replace(backend="torch"), initial=u0)
            check(_bits_equal(res.grid, plain.grid),
                  f"{label}: backend cuda != backend torch on the card")
            check(res.grid.dtype == u0.dtype and _ring_kept(res.grid, u0)
                  and bool(torch.isfinite(res.grid).all()),
                  f"{label}: dtype {res.grid.dtype}, ring or finiteness")
            out[label] = {
                "elapsed_s": res.elapsed_s, "eager_elapsed_s": ee.elapsed_s,
                "cycles_per_step": stats["cycles"] / IMP_STEPS,
                "launches": {t: counts[t] for t in sorted(transfers)},
                "device_loop": dls, "bitwise_eager": True,
                "bitwise_torch_backend": True}
            if dtype == "float64":
                out[label]["float64_is_float32_run"] = None
                keep = res.grid
            del res, ee, plain
        check(_bits_equal(keep, f32.grid.double()),
              f"implicit {scheme} float64 != the float32 run, widened")
        out[f"implicit {scheme} float64"]["float64_is_float32_run"] = True
    emit({"phase": "implicit_precision", "ok": True,
          "shape": [IMP_N, IMP_N], "steps": IMP_STEPS, "cx": IMP_C,
          "cy": IMP_C, **out})


def phase_timing_bf16(dev):
    """ms a launch of each bfloat16 form (CUDA events and the profiler's
    device time), its plain version and the yardstick (``conv2d`` in
    bfloat16 chained K times), at its main-path launch: A at 1000^2, a
    20-step window with the residual; E-uni, E, I-uni and I at 32768^2,
    K = 8, in
    storage mode and in the carry's launches of a 16-step chunk (its
    first and last, across a float32 level; ms a launch the mean of the
    two); B and C pinned at 32768^2, one step with the residual; M at
    64 x 512^2, K = 400, without it. Each bound counts the bytes of the function replaced, a
    bfloat16 grid read once and written once: 4 B a cell a launch in
    storage mode, 4 B a cell a chunk under f32chunk, so 2 B to each of
    its two launches; the float32 level's traffic (a carry launch moves
    6 B a cell) is reported beside the bound, not in it."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.ops import batched
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

    p = params()
    a0, cx, cy = coeffs_f32(CX, CY)
    kw = dict(cx=CX, cy=CY)
    bf16 = torch.bfloat16
    w = torch.tensor([[0.0, cx, 0.0], [cy, a0, cy], [0.0, cx, 0.0]],
                     dtype=bf16, device=dev).view(1, 1, 3, 3)

    def conv_steps(x, n):
        y = x
        for _ in range(n):
            y = F.conv2d(y, w)
        return y

    rows = {}
    n = BF16_N
    u = _plate_grid(dev, n)
    v = torch.empty_like(u)
    x = u.view(1, 1, n, n)
    interior = (n - 2) * (n - 2)
    check(p.i_k_default == p.e_k_default,
          "I's and E's launch depths differ: one yardstick for both")
    k = p.e_k_default
    library_k = _time_ms(lambda: conv_steps(x, k), 2)
    library_1 = _time_ms(lambda: conv_steps(x, 1), 10, 2)
    del x
    for name, launch, plain in (
            ("heat_e_uni_temporal", sk.temporal_steps_uni,
             sk.temporal_steps_uni_plain),
            ("heat_e_temporal", sk.temporal_steps, sk.temporal_steps_plain),
            ("heat_i_uni_tile_temporal", sk.tile_temporal_steps_uni,
             sk.tile_temporal_steps_uni_plain),
            ("heat_i_tile_temporal", sk.tile_temporal_steps,
             sk.tile_temporal_steps_plain)):
        rows[name + "_bf16"] = {
            "shape": [n, n], "k": k,
            "ms": _time_ms(lambda: launch(u, v, k, False, **kw), 10, 2),
            "plain_ms": _time_ms(lambda: plain(u, v, k, False, **kw), 1),
            "library_ms": library_k,
            **_bound(4 * n * n, OPS_PER_CELL_STEP * k * interior)}
        rows[name + "_bf16"].update(_device_ms(
            lambda: launch(u, v, k, False, **kw), name + "_bf16"))
        # The main path's carry launches: a 16-step chunk's first
        # (bfloat16 in, float32 level out) and last (the level in,
        # bfloat16 out).
        mid = torch.empty(u.shape, dtype=torch.float32, device=dev)
        first = lambda: launch(u, mid, k, False, acc_f32=True, **kw)  # noqa
        last = lambda: launch(mid, v, k, False, acc_f32=True, **kw)  # noqa
        halves = [_device_ms(f, name + "_bf16") for f in (first, last)]
        rows[name + "_bf16_acc"] = {
            "shape": [n, n], "k": k,
            "ms": (_time_ms(first, 10, 2) + _time_ms(last, 10, 2)) / 2,
            "plain_ms": (_time_ms(lambda: plain(u, mid, k, False,
                                                acc_f32=True, **kw), 1)
                         + _time_ms(lambda: plain(mid, v, k, False,
                                                  acc_f32=True, **kw), 1))
            / 2, "library_ms": library_k,
            "device_ms": sum(h["device_ms"] for h in halves) / 2,
            "device_ms_first_last": [h["device_ms"] for h in halves],
            "profiler_records": sum(h["profiler_records"] for h in halves),
            "bytes_per_cell_bound": 2, "bytes_per_cell_moved": 6,
            **_bound(2 * n * n, OPS_PER_CELL_STEP * k * interior)}
        del mid
        torch.cuda.empty_cache()
    # B and C, pinned on the main path: one step with the residual.
    for name, launch, plain in (
            ("heat_b_step", sk.strip_step, sk.strip_step_plain),
            ("heat_c_tiled", sk.tiled_step, sk.tiled_step_plain)):
        rows[name + "_bf16"] = {
            "shape": [n, n], "k": 1,
            "ms": _time_ms(lambda: launch(u, v, **kw), 20, 3),
            "plain_ms": _time_ms(lambda: plain(u, v, **kw), 1),
            "library_ms": library_1,
            **_bound(4 * n * n,
                     (OPS_PER_CELL_STEP + OPS_PER_RESIDUAL_CELL) * interior)}
        rows[name + "_bf16"].update(_device_ms(lambda: launch(u, v, **kw),
                                               name + "_bf16"))
        torch.cuda.empty_cache()
    del u, v
    torch.cuda.empty_cache()
    # M at the ensemble main path's stack: the fixed run's one launch
    # (K = 400, no residual); the yardstick zero-padded, as for float32.
    u = _member_inits(dev, ENS_N, [1.0 + i / ENS_B
                                   for i in range(ENS_B)]).to(bf16)
    v = torch.empty_like(u)
    x = u.view(ENS_B, 1, ENS_N, ENS_N)

    def conv_members(steps):
        y = x
        for _ in range(steps):
            y = F.conv2d(y, w, padding=1)
        return y

    def launch_m():
        return batched.ensemble_steps(u, v, ENS_STEPS, False, **kw)

    interior = ENS_B * (ENS_N - 2) * (ENS_N - 2)
    rows["heat_m_ensemble_bf16"] = {
        "shape": [ENS_B, ENS_N, ENS_N], "k": ENS_STEPS, "residual": False,
        "ms": _time_ms(launch_m, 5, 2),
        "plain_ms": _time_ms(lambda: batched.ensemble_steps_plain(
            u, v, ENS_STEPS, False, **kw), 1),
        "library_ms": _time_ms(lambda: conv_members(ENS_STEPS), 3, 1),
        **_bound(4 * ENS_B * ENS_N * ENS_N,
                 OPS_PER_CELL_STEP * ENS_STEPS * interior)}
    rows["heat_m_ensemble_bf16"].update(_device_ms(launch_m,
                                                   "heat_m_ensemble_bf16"))
    del u, v, x
    torch.cuda.empty_cache()
    u = _plate_grid(dev, CONV)
    v = torch.empty_like(u)
    x = u.view(1, 1, CONV, CONV)
    interior = (CONV - 2) * (CONV - 2)
    run = lambda: sk.resident_steps(u, v, WINDOW, True, **kw)  # noqa: E731
    rows["heat_a_resident_bf16"] = {
        "shape": [CONV, CONV], "k": WINDOW, "ms": _time_ms(run, 50, 5),
        "plain_ms": _time_ms(
            lambda: sk.resident_steps_plain(u, v, WINDOW, True, **kw), 5, 1),
        "library_ms": _time_ms(lambda: conv_steps(x, WINDOW), 20, 2),
        **_bound(4 * CONV * CONV,
                 (OPS_PER_CELL_STEP * WINDOW + OPS_PER_RESIDUAL_CELL)
                 * interior)}
    rows["heat_a_resident_bf16"].update(_device_ms(run,
                                                   "heat_a_resident_bf16"))
    del u, v, x
    torch.cuda.empty_cache()
    rows.update(_timing_3d_bf16(dev))
    rows.update(_timing_g_bf16(dev))
    rows.update(_timing_h_bf16(dev))
    emit({"phase": "timing_bf16", "kernels": rows})
    return rows


def _timing_3d_bf16(dev):
    """D's and F's bfloat16 forms at the 3D main path's 512^3 plate: F at
    K_default without the residual under the load ``f_load`` picks (and
    under the other), D one step with it; each with CUDA events and the
    profiler's device time, its plain version, the yardstick ``conv3d``
    in bfloat16 chained K times, the bound of a bfloat16 grid read and
    written once a launch (2 x 512^3 x 2 B), and its float32 form's times
    on the same plate in float32, measured here too."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate3D
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

    k = params().f_k_default
    kw = dict(cx=CX, cy=CY, cz=CX)
    a0, cx, cy, cz = coeffs3_f32(CX, CY, CX)
    w = torch.zeros((3, 3, 3), dtype=torch.bfloat16, device=dev)
    w[1, 1, 1] = a0
    w[0, 1, 1] = w[2, 1, 1] = cx
    w[1, 0, 1] = w[1, 2, 1] = cy
    w[1, 1, 0] = w[1, 1, 2] = cz
    w = w.view(1, 1, 3, 3, 3)

    def conv_steps(x, n):
        y = x
        for _ in range(n):
            y = F.conv3d(y, w)
        return y

    u = HeatPlate3D(CUBE, CUBE, CUBE).init_grid(dev, "bfloat16")
    v = torch.empty_like(u)
    u32 = u.float()
    v32 = torch.empty_like(u32)
    x = u.view(1, 1, CUBE, CUBE, CUBE)
    interior = (CUBE - 2) ** 3
    load = sk3.f_load(u.shape, u)
    other = "cp.async" if load == "tma" else "tma"
    rows = {}
    for name, steps, kernel, plain, twin, ops in (
            ("heat_d_step3d_bf16", 1,
             lambda: sk3.slab_step_3d(u, v, **kw),
             lambda: sk3.slab_step_3d_plain(u, v, **kw),
             lambda: sk3.slab_step_3d(u32, v32, **kw),
             (OPS_PER_CELL_STEP_3D + OPS_PER_RESIDUAL_CELL) * interior),
            ("heat_f_temporal3d_bf16", k,
             lambda: sk3.xslab_steps_3d(u, v, k, False, **kw),
             lambda: sk3.xslab_steps_3d_plain(u, v, k, False, **kw),
             lambda: sk3.xslab_steps_3d(u32, v32, k, False, **kw),
             OPS_PER_CELL_STEP_3D * k * interior)):
        f32 = name.removesuffix("_bf16")
        rows[name] = {
            "shape": [CUBE] * 3, "k": steps, "ms": _time_ms(kernel, 20, 3),
            "plain_ms": _time_ms(plain, 3),
            "library_ms": _time_ms(lambda: conv_steps(x, steps), 5, 1),
            **_bound(4 * CUBE ** 3, ops),
            "float32_ms": _time_ms(twin, 20, 3),
            "float32_device_ms": _device_ms(twin, f32)["device_ms"]}
        rows[name].update(_device_ms(kernel, name))
    f_row = rows["heat_f_temporal3d_bf16"]
    f_row["load"] = load
    f_row["other_load"] = {other: _device_ms(
        lambda: sk3.xslab_steps_3d(u, v, k, False, load=other, **kw),
        "heat_f_temporal3d_bf16")["device_ms"]}
    del u, v, u32, v32, x
    torch.cuda.empty_cache()
    return rows


def _timing_h_bf16(dev):
    """The bfloat16 H family at the sharded 3D main path's block (512^3
    of 1024^3 on (2, 2, 2), K = h_k_default, no residual), beside its
    float32 twins on the same blocks in float32, timed here in turns:
    H-fused's bfloat16 form (the monolithic round's launch), its deferred
    bulk, H's on the padded circular block (TMA) and the bfloat16 band's
    launch over the round's 8 blocks; each with CUDA events and the
    profiler's device time, its plain version, ``conv3d`` in bfloat16
    chained K times on the framed block (the band's on its 16 windows)
    and its bound at 2 B a cell (half the float32 bytes); and whole
    bfloat16 rounds of the 8 blocks under each kind."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch import tune
    from parallel_heat_tpu_torch.models import HeatPlate3D
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    k = params().h_k_default
    grid = (SHARD3_N,) * 3
    mesh = HeatMesh(SHARD3_MESH, dev)
    bs = mesh.block_shape(grid)
    bx, by, bz = bs
    plate = HeatPlate3D(*grid)
    origins = [mesh.origin(i, bs) for i in range(mesh.size)]
    b = mesh.size - 1
    o = origins[b]
    kw = dict(origin=o, grid_shape=grid, cx=CX, cy=CY, cz=CX)
    a0, cx, cy, cz = coeffs3_f32(CX, CY, CX)
    w = torch.zeros((3, 3, 3), dtype=torch.bfloat16, device=dev)
    w[1, 1, 1] = a0
    w[0, 1, 1] = w[2, 1, 1] = cx
    w[1, 0, 1] = w[1, 2, 1] = cy
    w[1, 1, 0] = w[1, 1, 2] = cz
    w = w.view(1, 1, 3, 3, 3)

    def conv_steps(x):
        for _ in range(k):
            x = F.conv3d(x, w)
        return x

    # Both dtypes' blocks, exchanges and buffers, so that each bfloat16
    # launch is timed beside its float32 twin.
    state = {}
    for dtype in (torch.bfloat16, torch.float32):
        us = [plate.init_block(dev, oi, bs, str(dtype).split(".")[1])
              for oi in origins]
        xch = temporal3d.DeepExchange3D(mesh, bs, k, dev, dtype)
        xch.lead(us)
        xch.last(us)
        ext = xch.new_circular()
        xch.assemble_circular(b, us[b], ext)
        vs = [torch.empty_like(u) for u in us]
        pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
        state[dtype] = (us, xch, ext, vs, pieces, skb3.BandLaunch3D(
            us, *pieces, vs, k, origins=origins, grid_shape=grid, cx=CX,
            cy=CY, cz=CX))
    us, xch, ext, vs, pieces, band_launch = state[torch.bfloat16]
    zt, yt, xlo, xhi = xch.pieces(b)
    v = vs[b]
    frame = torch.zeros(tuple(n + 2 * k for n in bs), dtype=torch.bfloat16,
                        device=dev)
    xch.assemble_padded(b, us[b], frame)
    framed = frame.view(1, 1, *frame.shape)
    lead = frame[k:k + bx].contiguous().view(1, 1, bx, by + 2 * k,
                                             bz + 2 * k)
    bands = torch.empty((2 * mesh.size, 1, 3 * k, by + 2 * k, bz + 2 * k),
                        dtype=torch.bfloat16, device=dev)
    padded = torch.zeros_like(frame)
    for i in range(mesh.size):
        xch.assemble_padded(i, us[i], padded)
        bands[2 * i, 0] = padded[:3 * k]
        bands[2 * i + 1, 0] = padded[bx - k:]
    del padded
    f = 2  # bytes a bfloat16 cell
    ops = OPS_PER_CELL_STEP_3D * k
    inner = _interior_cells_3d(o, bs, grid)
    bulk_inner = _interior_cells_3d((o[0] + k,) + o[1:], (bx - 2 * k, by, bz),
                                    grid)
    plane = by * bz
    tails = bx * by * 2 * k + bx * 2 * k * (bz + 2 * k)
    slabs = 2 * k * (by + 2 * k) * (bz + 2 * k)

    def twin(dtype, key):
        us_, xch_, ext_, vs_, _, band_ = state[dtype]
        zt_, yt_, xlo_, xhi_ = xch_.pieces(b)
        return {"heat_h_block_3d_fused": lambda: skb3.h_block_fused(
                    us_[b], zt_, yt_, xlo_, xhi_, vs_[b], k, False, **kw),
                "heat_h_block_3d_fused@bulk": lambda: skb3.h_block_fused(
                    us_[b], zt_, yt_, None, None, vs_[b], k, False,
                    defer_x=True, **kw),
                "heat_h_block_3d": lambda: skb3.h_block(ext_, vs_[b], k,
                                                        False, **kw),
                "heat_h_band_fix_3d": lambda: band_(False)}[key]

    timed = {
        "heat_h_block_3d_fused": (
            lambda: skb3.h_block_fused_plain(us[b], zt, yt, xlo, xhi, v, k,
                                             False, **kw),
            lambda: conv_steps(framed),
            (f * (2 * bx * plane + tails + slabs), ops * inner)),
        "heat_h_block_3d_fused@bulk": (
            lambda: skb3.h_block_fused_plain(us[b], zt, yt, None, None, v,
                                             k, False, defer_x=True, **kw),
            lambda: conv_steps(lead),
            (f * ((2 * bx - 2 * k) * plane + tails), ops * bulk_inner)),
        "heat_h_block_3d": (
            lambda: skb3.h_block_plain(ext, v, k, False, **kw),
            lambda: conv_steps(framed),
            (f * (math.prod(xch.circular_shape) + bx * plane), ops * inner)),
        "heat_h_band_fix_3d": (
            lambda: skb3.band_fix_blocks_3d_plain(
                us, *pieces, vs, k, False, origins=origins, grid_shape=grid,
                cx=CX, cy=CY, cz=CX),
            lambda: conv_steps(bands),
            (mesh.size * f * (4 * k * plane + tails * 4 * k // bx + slabs
                              + 2 * k * plane),
             ops * sum(_interior_cells_3d(oi, bs, grid)
                       - _interior_cells_3d((oi[0] + k,) + oi[1:],
                                            (bx - 2 * k, by, bz), grid)
                       for oi in origins))),
    }
    rows = {}
    for key, (plain, library, (nbytes, nops)) in timed.items():
        f32, _, part = key.partition("@")
        name = f32 + "_bf16"
        kernel, twin32 = twin(torch.bfloat16, key), twin(torch.float32, key)
        # The two dtypes in turns, twice.
        ms, ms32 = [], []
        for order in ((kernel, ms), (twin32, ms32)), ((twin32, ms32),
                                                      (kernel, ms)):
            for fn, acc in order:
                acc.append(_time_ms(fn, 20, 3))
        row = {"block": list(bs), "k": k, "ms": sum(ms) / 2, "ms_runs": ms,
               "plain_ms": _time_ms(plain, 2, 1),
               "library_ms": _time_ms(library, 5, 1),
               **_bound(nbytes, nops),
               "float32_ms": sum(ms32) / 2, "float32_ms_runs": ms32,
               "float32_device_ms": _device_ms(twin32, f32)["device_ms"]}
        row.update(_device_ms(kernel, name))
        rows[name + ("@" + part if part else "")] = row
    rows["heat_h_block_3d_fused_bf16"]["load"] = skb3.h_load(bs, k, us[b])
    rows["heat_h_block_3d_bf16"]["load"] = skb3.h_block_load(ext)
    rows["heat_h_band_fix_3d_bf16"].update(blocks=mesh.size,
                                           load=band_launch.load,
                                           shape=list(band_launch.shape))
    rows["heat_h_block_3d_fused_bf16"]["blocks_per_sm"] = (
        skb3.h_fused_occupancy(k, "plain", dtype="bfloat16"))
    rows["heat_h_block_3d_bf16"]["blocks_per_sm"] = skb3.h_occupancy(
        k, "bfloat16")
    # Whole bfloat16 rounds of the 8 blocks under each kind, in turns.
    with tune.force("block_temporal_3d", "H-defer"):
        round_fns = {kind: temporal3d.cuda_round_3d(
            xch, kind, "overlap", grid_shape=grid, cx=CX, cy=CY, cz=CX)
            for kind in ("H-fused", "H", "H-defer")}
    round_runs = {kind: [] for kind in round_fns}
    for order in (list(round_fns), list(round_fns)[::-1]):
        for kind in order:
            round_runs[kind].append(_time_ms(
                lambda fn=round_fns[kind]: fn(us, vs, False), 10, 2))
    rows["heat_h_block_3d_fused_bf16"]["round_ms_runs"] = round_runs
    del state, us, vs, xch, ext, v, frame, framed, lead, bands, band_launch
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import parallel_heat_tpu_torch  # noqa: F401 — fails outside the repo

    start = time.perf_counter()
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        phase_build()
        err = phase_kernels(dev)
        err.update(phase_kernels_bf16(dev))
        err.update(phase_kernels_3d(dev))
        launches = phase_main_path()
        launches["heat_a_resident"] = phase_converge()
        launches.update(phase_main_path_bf16())
        launches["heat_a_resident_bf16"] = phase_precision()
        launches.update(phase_main_path_3d())
        launches.update(phase_main_path_3d_bf16())
        phase_converge_3d()
        phase_cli()
        err.update(phase_kernels_ens(dev))
        err.update(phase_kernels_mg(dev))
        launches.update(phase_ensemble(dev))
        launches.update(phase_implicit(dev))
        launches.update(phase_ensemble_bf16(dev))
        phase_implicit_precision(dev)
        err.update(phase_kernels_g(dev))
        err.update(phase_kernels_g_bf16(dev))
        launches.update(phase_sharded_main_path())
        phase_sharded_converge()
        phase_cli_sharded()
        launches.update(phase_sharded_main_path_bf16())
        err.update(phase_kernels_h(dev))
        err.update(phase_kernels_h_bf16(dev))
        launches.update(phase_sharded_main_path_3d())
        phase_sharded_converge_3d()
        phase_cli_sharded_3d()
        launches.update(phase_sharded_main_path_3d_bf16())
        phase_device_loop()
        phase_stream()
        t = phase_timing(dev)
        t.update(phase_timing_bf16(dev))
        t.update(phase_timing_3d(dev))
        t.update(phase_timing_ens_mg(dev))
        t.update(phase_timing_g(dev))
        t.update(phase_timing_h(dev))
        probe = phase_probe_kernel(dev)
        roof = phase_probe_vpu_roofline(dev)
        anatomy = phase_probe_temporal(dev)
        boundary = phase_probe_ab_temporal(dev)
        split = phase_probe_split_copy(dev)
        gather = phase_probe_gather_dma(dev)
        width = phase_probe_sweep_width(dev)
        align = phase_probe_store_align(dev)
        roll = phase_probe_roll_pad(dev)
        overlap = phase_probe_xslab_overlap(dev)
        audit = phase_audit(dev)
    except Exception as e:  # report, then fail: no phase passes on error
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    # The probes' lines: each its own run's launches and time; A's probes
    # with A's plain version, bound and yardstick, the E-uni probes with
    # E-uni's and the overlap probe with F's (the same function at the same
    # shape), the roofline, the gather probe and the sweep probes with
    # their own.
    for name, run, like in (("heat_probe_kernel", probe, "heat_a_resident"),
                            ("heat_probe_temporal", anatomy,
                             "heat_e_uni_temporal"),
                            ("heat_probe_ab_temporal", boundary,
                             "heat_e_uni_temporal"),
                            ("heat_probe_vpu_roofline", roof, None),
                            ("heat_probe_split_copy", split,
                             "heat_e_uni_temporal"),
                            ("heat_probe_gather_dma", gather, None),
                            ("heat_probe_sweep_width", width, None),
                            ("heat_probe_store_align", align, None),
                            ("heat_probe_roll_pad", roll, "heat_a_resident"),
                            ("heat_probe_xslab_overlap", overlap,
                             "heat_f_temporal3d")):
        launches[name] = run["launches"]
        err[name] = run["max_abs_err"]
        t[name] = {**(t[like] if like else run),
                   "device_ms": run["device_ms"]}
    # The static-analysis path's fixture: its own run, plain version,
    # bound and yardstick (torch.mul).
    launches["heat_probe_fixture"] = audit["launches"]
    err["heat_probe_fixture"] = audit["max_abs_err"]
    t["heat_probe_fixture"] = audit
    emit(phase_seconds(start))
    src = "parallel_heat_tpu_torch/csrc/"
    sources = {name: owner for name, (owner, _) in KERNELS_BF16.items()}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": src + sources.get(name, name) + ".cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": err[name], "ms": t[name]["device_ms"],
         "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
         "bound_by": t[name]["bound_by"],
         "library_ms": t[name]["library_ms"]}
        for name, (_, replaces) in {**KERNELS, **KERNELS_BF16,
                                    **PROBES}.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
