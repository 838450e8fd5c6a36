"""Time kernels A, B, E, I, D, F, M, the multigrid transfer kernels and
the sharded block kernels G and H on the card over their launch shapes.

    python -m parallel_heat_tpu_torch.bench_kernels [--size 16384]
        [--a-sizes 256,1000,1859] [--size-3d 512]
        [--only a,b,e,i,d,f,m,mg,g,band,h,hband,hfused] [--reps 10]
        [--out FILE]
        [--sass DIR]

Needs a CUDA device and nvcc. Prints the card's name and power limit
(as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them), then one JSON line per launch shape: B over thread blocks
and rows per thread; E and E-uni over output tiles, thread blocks (32
lanes by 4, 8 or 16 warps, with the blocks an SM the card holds,
``occupancy``) and K up to ``e_k_max``.
Each shape is first checked bitwise against the kernel's plain version,
grid and residual, on a ragged 1001 x 999 grid (E-uni: 1001 x 1000),
then timed with CUDA events over ``--reps`` launches on the model's
``size`` x ``size`` plate (far larger than the 50 MB L2, so every launch
reads device memory). A, whose grid must fit
in shared memory, runs over its halo depth D and thread block (32 lanes
by 4, 8 or 16 warps), at the tile ``hopper_params.a_tile`` picks for
them, on each of the
``--a-sizes`` plates: a 20-step launch with the residual (one converge
window of the default check interval), checked bitwise against its
plain version on the same plate first and timed by ``torch.profiler``. The 3D kernels run on the
``--size-3d`` cube, after the same check on a ragged 67 x 130 x 201
grid with cx, cy, cz = 0.1, 0.15, 0.05: D over thread blocks and planes
per thread; F over thread blocks (32 lanes by 4 to 16 warps), rows per
thread (its extended tile is 128 cells along Z by warps x rows), K and
both plane loads (TMA and cp.async, each shape checked on a 67 x 130 x
204 grid and, for cp.async, a 67 x 130 x 201 one), with the blocks an
SM the card holds (``occupancy``), then over X segments and prefetch
depths at the fastest TMA shape a step. ``ms_per_step`` is
the time per launch over the steps it advances. ``--only i`` sweeps
kernels I and I-uni (a warp a band of 128 columns, its rows in a ring of
stages) on the ``size`` plate: warps a block by rows a stage at K = 8,
then segment rows, the ring's stages and every K at the fastest shape,
each launch
first checked bitwise on a ragged 1001 x 999 grid (I-uni: 1001 x 1000).
``--only m`` sweeps
kernel M on stacks of 64 members of 512^2 and of 128^2 (20 steps with
the residuals, one converge window): the tilings of a member that
``hopper_params.m_tilings`` models as cheapest at halo depths 4 and 8
under each of A's thread blocks, a spread of tile counts, and, where a
member fits one block, the one-block-per-member launch over thread
blocks. ``--only mg`` sweeps the
thread block of ``heat_mg_restrict`` (with the coarse cells a thread
takes, 1 x 1, 1 x 2, 2 x 2) and of ``heat_mg_prolong`` at 4098^2 <->
2050^2 and 512^2 <-> 257^2 (the finest pair of a 512^2 implicit run),
each launch into a NaN-filled output checked bitwise against the plain
version, then timed by ``torch.profiler`` (the card's own time) and CUDA
events. Both check every launch shape bitwise
against the plain version first. ``--only g`` sweeps the sharded path's
G kernels at the main path's block, 16384 x 8192 of 32768^2 on a (2, 4)
mesh: the deferred bulk of G-uni (the launch the default overlapped
round makes) over output tiles, thread blocks (32 lanes by 4, 8 or 16
warps, so rows a warp and warps an SM; ``occupancy`` is the blocks an SM
the card holds with the kernel's registers) and K, G-fuse monolithic over
the same shapes at the default K, each launch shape first checked
bitwise against the plain version on a 500 x 252 block of 1000 x 1008 on
(2, 4). ``--only band`` sweeps the band kernel's round launch (all 8
blocks' bands at once) over tile widths and thread blocks at K = 8, each
shape checked bitwise against the per-block plain versions on the 8
blocks of 1000 x 1008 on (2, 4), ranked by ``torch.profiler`` device
time; then, at the default shape, its loads in turns (the row load, the
per-cell load, and none: the steps alone, the load's share).
``--only h`` sweeps kernel H (F's plane loop on the assembled circular
block) at the sharded 3D main path's block, 512^3 of 1024^3 on a (2, 2,
2) mesh: F's launch shapes at every K under the TMA load (and the
cp.async load at the chosen shape), then X segments and planes in flight
at the fastest shape a step; and, at the defaults, the monolithic
H-fused, H (both loads) and the band kernel, and kernel F on a 512^3
grid, the yardstick of the plane loop; each shape first checked bitwise
against the plain version on 20 x 128 x 252 blocks of a (3, 3, 3) mesh
(``hopper_params``' ``hc_*`` entries). ``--only hband`` sweeps the 3D
band's round launch (every block's bands at once, F's plane loop) over
the 8 blocks of that mesh at K = 3: F's shapes at rows 2 and 4 and the
planes in flight under the 16-byte load, then the fastest under the
4-byte load, each checked bitwise against the batched plain version
(the ``h_band_*`` entries). ``--only hfused`` sweeps
H-fused's deferred bulk over thread blocks, rows per thread, K and X
segments, each checked bitwise on the interior block of a (3, 3, 3) mesh
of 21 x 128 x 256 blocks (the ``h_*`` entries). The values in
``ops/hopper_params.py`` marked "measured" come from these sweeps.
``--sass DIR`` also writes each kernel library's machine code
(``cuobjdump -sass``) to ``DIR/<kernel>.sass`` and prints the number of
instructions in each loop body, found by its backward branch, and for
kernel F's instances at the default K the instructions, shuffles and
shared-memory bytes per cell-step of its plane loop (``sass_f``), for
kernel H's the same of each of its four plane loops (``sass_h``), for
kernel A the same of each loop that steps cells and of its test-free
inner step (``sass_a``), for kernels I and I-uni at the default K the
same of each loop that steps cells (``sass_i``);
``--turns TREE`` times the default paths' kernels (F under both
loads, D, H-fused, H, E-uni, I and I-uni at K = 8 (events, and ``I
device``, ``I-uni device`` by the profiler), G-uni's bulk, A at 1000^2, M at 64 x
512^2, the transfer calls and kernels at 4098^2, 512^2 and 9^2, the
512^2 implicit runs) in another checkout at TREE
and in this one, in turns (TREE, this, this, TREE), each in its own
process, and prints the sharded 3D picks of both (``--turns-only``
names the rows to time; only those are set up and built).
``--sass-same TREE`` builds every kernel in TREE and here and compares
their machine code function by function.
``--i-regcap DIR`` times I and I-uni in turns against a copy of this
tree at DIR whose only change is their launch bound, one block an SM
instead of two (255 registers a thread instead of 128), and prints the
K = 8 instance's registers, spills and blocks an SM in both: what that
instance's spill costs.
``--sass-of LIB`` reads one kernel's machine code from another tree's
library instead (``python -m parallel_heat_tpu_torch.bench_kernels
--sass DIR --sass-of
OTHER/parallel_heat_tpu_torch/build/libheat_a_resident-*.so``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.models import HeatPlate2D, HeatPlate3D
from parallel_heat_tpu_torch.ops import batched
from parallel_heat_tpu_torch.ops import multigrid as mg
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params

CX = CY = CZ = 0.1
B_BLOCKS = [(32, 4), (32, 8), (32, 16), (64, 4), (128, 2)]
B_ROWS = [4, 8, 16]
E_TILES = [(32, 112), (64, 112), (96, 112), (128, 112), (64, 128),
           (128, 128), (64, 240)]
E_BLOCKS = [(32, 4), (32, 8), (32, 16)]
E_KS = [4, 6, 8, 10, 12, 16]
I_WARPS = [2, 4, 8]        # kernel I's warps a block (a band each)
I_ROWS = [3, 4, 8]         # and input rows a ring stage
I_STAGES = [2, 3, 4, 6]
I_SEGMENTS = [48, 64, 72, 96, 128, 192, 288, 576, 1171]
A_DEPTHS = [2, 4, 8]
A_STEPS = 20
A_BLOCKS = [(32, 16), (32, 8), (32, 4)]    # A's and M's, 32 lanes x warps
D_BLOCKS = [(32, 4), (32, 8), (32, 16), (64, 4), (64, 8), (128, 2), (128, 4)]
D_PLANES = [4, 8, 16, 32, 64]
# F's launch shapes, (32 lanes x warps, rows a thread): extended tiles of
# 128 cells along Z by 16 to 32 rows along Y.
F_SHAPES = [((32, 16), 1), ((32, 8), 2), ((32, 12), 2), ((32, 16), 2),
            ((32, 4), 4), ((32, 6), 4), ((32, 8), 4)]
F_KS = [1, 2, 3, 4, 5, 6]
F_SEGMENTS = [32, 48, 64, 86, 128, 171, 256, 512]
F_PREFETCH = [1, 2, 3, 4, 6, 8]
COEFFS_3D = (0.1, 0.15, 0.05)
M_BATCH = 64
M_SIZES = [512, 128]
M_DEPTHS = [4, 8]
M_BEST = 3                      # modelled-cheapest tilings per depth
M_TILES = [4, 8, 12, 16, 24, 44]   # and these tile counts
M_SOLO_BLOCKS = [(32, 4), (32, 8), (32, 16)]
MG_BLOCKS = [(32, 4), (32, 8), (32, 16), (64, 4), (64, 8), (128, 2),
             (128, 4), (256, 1)]
MG_RESTRICT_CELLS = [(1, 1), (1, 2), (2, 2)]   # the compiled instances
MG_FINE = [(4098, 4098), (2050, 2050), (1026, 1026), (512, 512)]
# --turns: the transfers at a large pair, the 512^2 main path's finest and
# its smallest, and the 512^2 implicit run (bench.py --row implicit512).
MG_TURN_SIZES = [4098, 512, 9]
G_GRID, G_MESH = (32768, 32768), (2, 4)    # the sharded main path
# G's output tiles: 112 columns make a K = 8 framed row 128 floats, one
# pass of 32 lanes of 4 columns, 240 two passes; the rows span 1 to 4
# blocks an SM by shared memory at K = 8.
G_TILES = [(32, 112), (56, 112), (96, 112), (200, 112), (40, 240),
           (96, 240)]
G_BLOCKS = [(32, 4), (32, 8), (32, 16)]
G_KS = [4, 6, 8]
# The band launch's tile widths and thread blocks: at K = 8 a tile is 24
# rows, so 2 to 16 warps take 12 to 2 rows each.
G_BAND_TILES = [48, 112, 240, 496]
G_BAND_BLOCKS = [(32, 2), (32, 4), (32, 8), (32, 16)]
H_GRID, H_MESH = (1024, 1024, 1024), (2, 2, 2)   # the sharded 3D main path
# The 3D band's launch shapes (F's, at the compiled rows 2 and 4): a 512^2
# face takes 100 to 260 tiles a region.
H_BAND_SHAPES = [((32, 16), 2), ((32, 12), 2), ((32, 8), 2), ((32, 8), 4)]
H_BAND_PREFETCH = [2, 3, 4, 6]
H_SEGMENTS = [32, 64, 86, 128, 171, 256, 512]
TURN_CUBE, TURN_PLATE = 512, 16384   # --turns: F and D, E-uni
# H's launch shapes, (along Z, along Y) threads and rows a thread: at most
# 512 threads, extended tiles of 32 x 16 to 128 x 16 cells (Z x Y).
H_SHAPES = [((32, 16), 1), ((32, 8), 2), ((32, 4), 4), ((32, 12), 2),
            ((32, 6), 4), ((32, 16), 2), ((32, 8), 4), ((32, 12), 4),
            ((32, 16), 4), ((64, 8), 2), ((64, 4), 4), ((64, 8), 4),
            ((64, 8), 1), ((96, 4), 4), ((128, 4), 4)]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    # heatlint: begin dispatch-region
    for _ in range(reps):
        fn()
    end.record()
    # heatlint: end dispatch-region
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bits(dev):
    return torch.empty(1, dtype=torch.int32, device=dev)


def _check_b(small, block, rows) -> bool:
    out, want = torch.empty_like(small), torch.empty_like(small)
    bits = _bits(small.device)
    sk._launch_b(small, out, bits, CX, CY, block, rows)
    res = sk.strip_step_plain(small, want, cx=CX, cy=CY)
    return bool(torch.equal(out, want)
                and torch.equal(sk._residual_view(bits), res))


def _check_e(small, want, res, k, tile, block, name) -> bool:
    """Kernel ``name`` (E or E-uni) at depth ``k``, tile and thread block
    on ``small`` against its plain version's grid ``want`` and residual
    ``res``."""
    out = torch.full_like(small, float("nan"))
    bits = _bits(small.device)
    sk._launch_e(small, out, k, bits, CX, CY, tile, block, name)
    return bool(torch.equal(out, want)
                and torch.equal(sk._residual_view(bits), res))


# A torch.profiler trace loses kernel records now and then: on an H100 a
# trace of a burst of launches kept none or only some of them about once
# in a hundred traces, and in one run of chip_smoke.py kept 8 of 40 three
# traces running. Idle host time inside the trace on each side of the
# burst lets the records arrive; each retry of device_ms waits four times
# longer (tools/profiler_records.py counts the traces that lose records
# with and without the wait).
TRACE_PAD_S = 0.02


@contextlib.contextmanager
def card_trace(pad_s: float = TRACE_PAD_S):
    """A ``torch.profiler`` trace of the card alone: ``with card_trace()
    as prof:`` runs the block with the card synchronized before and after
    it and ``pad_s`` seconds of idle host inside the trace on each side;
    read ``prof`` after the block."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad_s)


def device_ms(fn, instance: str, made: int = 40) -> float:
    """Mean device milliseconds of one launch of the kernel whose name
    holds ``instance`` (``heat_a_resident_kernel<0>``), from a
    ``torch.profiler`` trace of ``made`` calls of ``fn()``, over the
    records the trace kept. A trace may lose some: one that kept fewer
    than 70% is taken again with twice the calls and four times the wait,
    twice at most, then refused. For kernels of a few microseconds, whose
    launches the host cannot issue as fast as the card runs them, so that
    CUDA events would time the host."""
    fn()
    for attempt in range(3):
        calls = made * 2 ** attempt
        with card_trace(TRACE_PAD_S * 4 ** attempt) as prof:
            # heatlint: begin dispatch-region
            for _ in range(calls):
                fn()
            # heatlint: end dispatch-region
        hits = [e for e in prof.key_averages()
                if re.search(re.escape(instance), e.key)]
        records = sum(e.count for e in hits)
        if calls * 0.7 <= records <= calls:
            return sum(e.self_device_time_total for e in hits) / 1e3 / records
    raise RuntimeError(f"the profiler kept {records} records of {calls} "
                       f"launches of {instance}, three times over")


def device_ms_per_call(fn, instance: str, calls: int = 20) -> float:
    """Device milliseconds of the launches of the kernel whose name holds
    ``instance`` that one ``fn()`` makes, however many (``torch.profiler``
    over ``calls`` calls: the records' device time over the calls; a
    trace that loses records reads low by as much)."""
    fn()
    with card_trace() as prof:
        # heatlint: begin dispatch-region
        for _ in range(calls):
            fn()
        # heatlint: end dispatch-region
    return sum(e.self_device_time_total for e in prof.key_averages()
               if re.search(re.escape(instance), e.key)) / 1e3 / calls


def sweep_a(sizes, reps: int):
    """Yield one dict per (plate size, halo depth, thread block) of kernel
    A: the tile ``hopper_params.a_tile`` picks for them, a 20-step launch
    with the residual checked bitwise against the plain version, then its
    device time (``torch.profiler``)."""
    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    for size in sizes:
        u = HeatPlate2D(size, size).init_grid(dev)
        v, want = torch.empty_like(u), torch.empty_like(u)
        rp = sk.resident_steps_plain(u, want, A_STEPS, cx=CX, cy=CY)
        xch = torch.empty((2, size, size), device=dev)
        bits = _bits(dev)
        for d in A_DEPTHS:
            for block in A_BLOCKS:
                tile = p.a_tile((size, size), d, block)
                if tile is None:
                    continue

                def launch():
                    sk._launch_a(u, v, A_STEPS, xch, bits, CX, CY, d, tile,
                                 block)

                v.fill_(float("nan"))
                launch()
                ok = bool(torch.equal(v, want)
                          and torch.equal(sk._residual_view(bits), rp))
                ms = device_ms(launch, "heat_a_resident_kernel<0>")
                blocks = -(-size // tile[0]) * -(-size // tile[1])
                yield {"kernel": "heat_a_resident", "size": size,
                       "depth": d, "tile": list(tile), "block": list(block),
                       "blocks": blocks, "k": A_STEPS,
                       "model_step": p.a_step_cost(tile, d, block),
                       "smem_bytes": p.a_smem_bytes(tile, d), "bitwise": ok,
                       "ms": ms, "ms_per_step": ms / A_STEPS,
                       "default": (d, tuple(block)) == (p.a_depth,
                                                        p.a_block)}


def sweep(size: int, reps: int):
    """Yield one dict per launch shape of B, E and E-uni."""
    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    small = torch.from_numpy(
        (rng.standard_normal((1001, 999)) * 10).astype(np.float32)).to(dev)
    # E-uni's check grid: a width that is a multiple of 4.
    small_uni = torch.from_numpy(
        (rng.standard_normal((1001, 1000)) * 10).astype(np.float32)).to(dev)
    u = HeatPlate2D(size, size).init_grid(dev)
    v = torch.empty_like(u)
    bits = _bits(dev)
    for block in B_BLOCKS:
        for rows in B_ROWS:
            ok = _check_b(small, block, rows)
            ms = time_ms(lambda: sk._launch_b(u, v, bits, CX, CY, block,
                                              rows), reps)
            yield {"kernel": "heat_b_step", "block": list(block),
                   "rows_per_thread": rows, "k": 1, "bitwise": ok,
                   "ms": ms, "ms_per_step": ms,
                   "default": (block == p.b_block
                               and rows == p.b_rows_per_thread)}
    wants = {}
    for tile in E_TILES:
        for k in (k for k in E_KS if k <= p.e_k_max(tile)):
            for grid in (small, small_uni):
                if (id(grid), k) not in wants:
                    want = torch.empty_like(grid)
                    res = sk.temporal_steps_plain(grid, want, k, cx=CX,
                                                  cy=CY)
                    wants[id(grid), k] = (want, res)
            for block in E_BLOCKS:
                for name, grid in (("heat_e_temporal", small),
                                   ("heat_e_uni_temporal", small_uni)):
                    ok = _check_e(grid, *wants[id(grid), k], k, tile, block,
                                  name)
                    ms = time_ms(lambda: sk._launch_e(
                        u, v, k, None, CX, CY, tile, block, name), reps)
                    yield {"kernel": name, "tile": list(tile),
                           "block": list(block), "k": k,
                           "smem_bytes": p.e_smem_bytes(
                               k, tile, tma=name == "heat_e_uni_temporal"),
                           "occupancy": sk.loop_occupancy(name, k, tile,
                                                          block),
                           "bitwise": ok, "ms": ms, "ms_per_step": ms / k,
                           "default": (tile == p.e_tile
                                       and block == p.e_block
                                       and k == p.e_k_default)}


def sweep_i(size: int, reps: int):
    """Yield one dict per launch of kernels I and I-uni on the ``size`` x
    ``size`` plate: warps a block by rows a stage (I_WARPS, I_ROWS) under
    both level schedules at K = 8 and the default segments, then at each
    schedule's fastest shape the segment rows (I_SEGMENTS) and the
    stages of the ring (I_STAGES) at K = 8, and every K 1 .. 8 at the
    fastest of those. Each launch is first checked bitwise, grid and
    residual, against the plain version on a ragged 1001 x 999 grid
    (I-uni: 1001 x 1000) at its K; then timed with CUDA events (``ms``),
    with the blocks an SM the card holds (``occupancy``)."""
    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    small = {n: torch.from_numpy((rng.standard_normal((1001, w)) * 10)
                                 .astype(np.float32)).to(dev)
             for n, w in (("heat_i_tile_temporal", 999),
                          ("heat_i_uni_tile_temporal", 1000))}
    u = HeatPlate2D(size, size).init_grid(dev)
    v = torch.empty_like(u)
    bits = _bits(dev)
    wants = {}

    def one(name, k, warps, rows, stages, seg=None):
        g = small[name]
        if (name, k) not in wants:
            want = torch.empty_like(g)
            res = sk.tile_temporal_steps_plain(g, want, k, cx=CX, cy=CY)
            wants[name, k] = (want, res)
        want, res = wants[name, k]
        out = torch.full_like(g, float("nan"))
        launch = dict(warps=warps, rows=rows, stages=stages, name=name)
        sk._launch_i(g, out, k, bits, CX, CY,
                     seg or p.i_launch(tuple(g.shape), k, warps)[1],
                     **launch)
        ok = bool(torch.equal(out, want)
                  and torch.equal(sk._residual_view(bits), res))
        seg = seg or p.i_launch((size, size), k, warps)[1]
        ms = time_ms(lambda: sk._launch_i(u, v, k, None, CX, CY, seg,
                                          **launch), reps)
        return {"kernel": name, "k": k, "warps": warps, "rows": rows,
                "stages": stages, "segment": seg,
                "smem_bytes": p.i_smem_bytes(warps, rows, stages),
                "occupancy": sk.i_occupancy(name, k, warps, rows, stages),
                "bitwise": ok, "ms": ms, "ms_per_step": ms / k,
                "default": (k, warps, rows, stages, seg)
                == (p.i_k_default, p.i_warps, p.i_rows, p.i_stages,
                    p.i_launch((size, size), k)[1])}

    def fastest(rows):
        return min((r for r in rows if r["bitwise"]), key=lambda r: r["ms"],
                   default=rows[0])

    for name in small:
        found = []
        for warps in I_WARPS:
            for rows in I_ROWS:
                found.append(one(name, 8, warps, rows, p.i_stages))
                yield found[-1]
        best = fastest(found)
        w, r = best["warps"], best["rows"]
        for seg in I_SEGMENTS:
            found.append(one(name, 8, w, r, p.i_stages, seg))
            yield found[-1]
        seg = fastest(found)["segment"]
        for stages in I_STAGES:
            if stages != p.i_stages:
                found.append(one(name, 8, w, r, stages, seg))
                yield found[-1]
        st = fastest(found)["stages"]
        for k in range(1, p.i_k_max):
            yield one(name, k, w, r, st, seg)


def sweep_3d(size: int, reps: int, only=("d", "f")):
    """Yield one dict per launch shape of D and F (those in ``only``) on a
    ``size``^3 cube."""
    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    small = torch.from_numpy((rng.standard_normal((67, 130, 201)) * 10)
                             .astype(np.float32)).to(dev)
    kw = dict(zip(("cx", "cy", "cz"), COEFFS_3D))
    u = HeatPlate3D(size, size, size).init_grid(dev)
    v = torch.empty_like(u)
    bits = _bits(dev)
    want = torch.empty_like(small)
    rp = sk3.slab_step_3d_plain(small, want, **kw)
    for block in D_BLOCKS if "d" in only else []:
        for planes in D_PLANES:
            out = torch.empty_like(small)
            sk3._launch_d(small, out, bits, *COEFFS_3D, block, planes)
            ok = bool(torch.equal(out, want)
                      and torch.equal(sk._residual_view(bits), rp))
            ms = time_ms(lambda: sk3._launch_d(u, v, bits, CX, CY, CZ, block,
                                               planes), reps)
            yield {"kernel": "heat_d_step3d", "block": list(block),
                   "planes": planes, "k": 1, "bitwise": ok, "ms": ms,
                   "ms_per_step": ms,
                   "default": block == p.d_block and planes == p.d_planes}
    if "f" in only:
        yield from _sweep_f(u, v, kw, reps)


def _sweep_f(u, v, kw, reps: int):
    """Kernel F over launch shapes, K and both loads on the cube ``u``,
    then over segments and prefetch depths at the fastest shape a step;
    each launch shape first checked bitwise against the plain version on
    a 67 x 130 x 204 grid (both loads) and a 67 x 130 x 201 one
    (cp.async)."""
    p = params()
    dev = u.device
    rng = np.random.default_rng(1)
    checks = {nz: torch.from_numpy((rng.standard_normal((67, 130, nz)) * 10)
                                   .astype(np.float32)).to(dev)
              for nz in (204, 201)}
    bits = _bits(dev)
    wants = {}

    def checked(k, block, rows, load, seg=None, prefetch=None):
        ok = True
        for nz, small in checks.items():
            if load == "tma" and nz % 4:
                continue
            if (nz, k) not in wants:
                want = torch.empty_like(small)
                res = sk3.xslab_steps_3d_plain(small, want, k, **kw)
                wants[nz, k] = (want, res)
            want, res = wants[nz, k]
            out = torch.full_like(small, float("nan"))
            _, _, s_seg = p.f_launch(tuple(small.shape), k, block, rows)
            sk3._launch_f(small, out, k, bits, *COEFFS_3D, block, rows,
                          seg or s_seg, load, prefetch)
            ok = ok and bool(torch.equal(out, want) and torch.equal(
                sk._residual_view(bits), res))
        return ok

    def row(k, block, rows, load, mode, seg=None, prefetch=None):
        ok = checked(k, block, rows, load, seg, prefetch)
        seg = seg or p.f_launch(tuple(u.shape), k, block, rows)[2]
        prefetch = prefetch or p.f_prefetch
        ms = time_ms(lambda: sk3._launch_f(u, v, k, None, CX, CY, CZ, block,
                                           rows, seg, load, prefetch), reps)
        return {"kernel": "heat_f_temporal3d", "mode": mode,
                "block": list(block), "rows": rows, "k": k, "load": load,
                "segment": seg, "prefetch": prefetch,
                "smem_bytes": p.f_smem_bytes(k, block, rows, prefetch),
                "occupancy": sk3.f_occupancy(k, load, block, rows, prefetch),
                "bitwise": ok, "ms": ms, "ms_per_step": ms / k,
                "default": (block == p.f_block and rows == p.f_rows
                            and k == p.f_k_default
                            and seg == p.f_launch(tuple(u.shape), k)[2]
                            and prefetch == p.f_prefetch)}

    best = None
    for block, rows in F_SHAPES:
        for k in (k for k in F_KS if k <= p.f_k_max(block, rows)):
            for load in sk3.LOADS:
                r = row(k, block, rows, load, load)
                if r["bitwise"] and load == "tma" and (
                        best is None or r["ms_per_step"]
                        < best["ms_per_step"]):
                    best = r
                yield r
    if best is None:
        return
    block, rows, k = tuple(best["block"]), best["rows"], best["k"]
    for seg in F_SEGMENTS:
        for load in sk3.LOADS:
            yield row(k, block, rows, load, f"{load} segments", seg=seg)
    for prefetch in F_PREFETCH:
        if k > p.f_k_max(block, rows, prefetch):
            continue
        for load in sk3.LOADS:
            yield row(k, block, rows, load, f"{load} prefetch",
                      prefetch=prefetch)


def sweep_m(reps: int):
    """Yield one dict per (member size, launch plan) of kernel M."""
    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    for size in M_SIZES:
        shape = (size, size)
        u = torch.from_numpy((rng.standard_normal((M_BATCH,) + shape) * 10)
                             .astype(np.float32)).to(dev)
        v, want = torch.empty_like(u), torch.empty_like(u)
        rp = batched.ensemble_steps_plain(u, want, A_STEPS, cx=CX, cy=CY)
        default = p.m_plan(M_BATCH, shape)
        plans = [p.m_solo_plan(M_BATCH, shape, block)
                 for block in M_SOLO_BLOCKS]
        for d in M_DEPTHS:
            for block in A_BLOCKS:
                tilings = sorted(p.m_tilings(M_BATCH, shape, d, block),
                                 key=lambda t: t["cost"])
                plans += tilings[:M_BEST]
                for tiles in M_TILES:
                    plans += [t for t in tilings[M_BEST:]
                              if t["tiles"] == tiles][:1]
        bits = torch.empty(M_BATCH, dtype=torch.int32, device=dev)
        for plan in plans:
            if plan is None:
                continue
            xch = batched.exchange_planes(u, A_STEPS, plan)

            def launch():
                batched._launch_m(u, v, A_STEPS, xch, bits, CX, CY, plan)

            v.fill_(float("nan"))
            launch()
            ok = bool(torch.equal(v, want)
                      and torch.equal(bits.view(torch.float32), rp))
            ms = time_ms(launch, reps)
            same = all(plan[key] == default[key]
                       for key in ("tile", "depth", "block", "groups"))
            yield {"kernel": "heat_m_ensemble", "size": size,
                   "members": M_BATCH, "tile": list(plan["tile"]),
                   "depth": plan["depth"], "tiles": plan["tiles"],
                   "groups": plan["groups"], "block": list(plan["block"]),
                   "model_cost": plan.get("cost"), "k": A_STEPS,
                   "smem_bytes": p.m_smem_bytes(plan["tile"], plan["depth"]),
                   "bitwise": ok, "ms": ms, "ms_per_step": ms / A_STEPS,
                   "default": same}
        del u, v, want


def sweep_mg(reps: int):
    """Yield one dict per (kernel, fine shape, launch shape) of the
    multigrid transfer kernels: restrict over thread blocks and the
    coarse cells a thread takes (``MG_RESTRICT_CELLS``), prolong over
    thread blocks. Each launch first writes a NaN-filled output, which
    must come out bitwise the plain version's (so every cell written),
    then is timed by ``torch.profiler`` (``ms``, the card's own time:
    at 512^2 a launch is shorter than the host's time to issue one) and
    by CUDA events (``events_ms``)."""
    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    for fine in MG_FINE:
        coarse = ((fine[0] - 2) // 2 + 2, (fine[1] - 2) // 2 + 2)
        r = torch.from_numpy((rng.standard_normal(fine) * 10)
                             .astype(np.float32)).to(dev)
        c = torch.from_numpy((rng.standard_normal(coarse) * 10)
                             .astype(np.float32)).to(dev)
        c[0] = c[-1] = 0
        c[:, 0] = c[:, -1] = 0
        cases = {
            mg.RESTRICT: (r, torch.empty(coarse, device=dev),
                          mg.restrict_full_weighting(r, coarse),
                          [(b, cells) for cells in MG_RESTRICT_CELLS
                           for b in MG_BLOCKS],
                          (tuple(p.mg_restrict_block),
                           p.mg_restrict_cells(coarse))),
            mg.PROLONG: (c, torch.empty(fine, device=dev),
                         mg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2)),
                         [(b, (1, 1)) for b in MG_BLOCKS],
                         (tuple(p.mg_prolong_block), (1, 1))),
        }
        for name, (src, dst, want, shapes, default) in cases.items():
            for geometry in shapes:
                dst.fill_(float("nan"))
                mg._launch_transfer(name, src, dst, geometry)
                ok = bool(torch.equal(dst, want))

                def launch(geometry=geometry):
                    mg._launch_transfer(name, src, dst, geometry)

                ms = device_ms(launch, name + "_kernel")
                yield {"kernel": name, "size": fine[0], "fine": list(fine),
                       "coarse": list(coarse), "block": list(geometry[0]),
                       "cells": list(geometry[1]), "k": 1, "bitwise": ok,
                       "ms": ms, "events_ms": time_ms(launch, reps * 5),
                       "ms_per_step": ms, "default": geometry == default}
        del r, c


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"BRA(?:\.[A-Z.]+)? (?:!?U?P\d, )?(0x[0-9a-f]+)")


def _g_setup(dev, grid, mesh_shape, k, blocks=None):
    """The blocks of the plate ``grid`` on ``mesh_shape`` (or the given
    ``blocks``), and the K-deep exchange after both phases."""
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    mesh = HeatMesh(mesh_shape, dev)
    bs = mesh.block_shape(grid)
    if blocks is None:
        plate = HeatPlate2D(*grid)
        blocks = [plate.init_block(dev, mesh.origin(b, bs), bs)
                  for b in range(mesh.size)]
    xch = temporal.DeepExchange2D(mesh, bs, k, dev)
    xch.phase1(blocks)
    xch.phase2(blocks)
    return mesh, blocks, xch


def sweep_g(reps: int):
    """Yield one dict per launch shape of G-uni's deferred bulk and of
    G-fuse monolithic at the sharded main path's block:
    output tile, thread block (so rows a warp: more warps an SM, or more
    rows a warp) and K, with the blocks an SM the card holds."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    small_grid = (1000, 1008)
    small = torch.from_numpy((rng.standard_normal(small_grid) * 10)
                             .astype(np.float32)).to(dev)
    s_mesh = HeatMesh(G_MESH, dev)
    s_blocks = s_mesh.split(small)
    big_mesh, big_blocks, _ = _g_setup(dev, G_GRID, G_MESH, 1)
    b = big_mesh.index((1, 1))
    sb = s_mesh.index((1, 1))
    size = "x".join(map(str, big_mesh.block_shape(G_GRID)))
    for k in G_KS:
        _, _, s_xch = _g_setup(dev, small_grid, G_MESH, k, s_blocks)
        _, _, xch = _g_setup(dev, G_GRID, G_MESH, k, big_blocks)
        s_kw = dict(origin=s_mesh.origin(sb, s_blocks[sb].shape),
                    grid_shape=small_grid, cx=CX, cy=CY)
        kw = dict(origin=big_mesh.origin(b, big_blocks[b].shape),
                  grid_shape=G_GRID, cx=CX, cy=CY)
        s_pieces, pieces = s_xch.pieces(sb), xch.pieces(b)
        wants = {}
        for mode, halos in (("bulk", (None, None)),
                            ("monolithic", s_pieces[1:])):
            want = torch.full_like(s_blocks[sb], float("nan"))
            r = skb.block_fused_plain(s_blocks[sb], s_pieces[0], *halos,
                                      want, k, **s_kw)
            wants[mode] = (want, r)
        out = torch.full_like(big_blocks[b], float("nan"))
        runs = [("heat_g_block_uniform", "bulk")]
        if k == p.g_k_default:
            runs.append(("heat_g_block_fused", "monolithic"))
        for name, mode in runs:
            halos = (None, None) if mode == "bulk" else pieces[1:]
            s_halos = (None, None) if mode == "bulk" else s_pieces[1:]
            want, rp = wants[mode]
            rows = slice(k, -k) if mode == "bulk" else slice(None)
            for tile in G_TILES:
                smem = p.g_smem_bytes(k, tile)
                if smem + p.static_smem_bytes > p.smem_per_block_max:
                    continue
                for block in G_BLOCKS:
                    geo = tile + block
                    got = torch.full_like(want, float("nan"))
                    r = skb._launch(name, (s_blocks[sb], s_pieces[0],
                                           *s_halos), got, k, True,
                                    geometry=geo, **s_kw)
                    ok = bool(torch.equal(got[rows], want[rows])
                              and torch.equal(r, rp))
                    ms = time_ms(lambda: skb._launch(
                        name, (big_blocks[b], pieces[0], *halos), out, k,
                        False, geometry=geo, **kw), reps)
                    yield {"kernel": name, "mode": mode, "size": size,
                           "tile": list(tile), "block": list(block), "k": k,
                           "rows_per_warp": p.g_run(k, tile, block),
                           "smem_bytes": smem,
                           "blocks_per_sm_by_smem_threads":
                               p.g_blocks_per_sm(k, tile, block),
                           "occupancy": sk.loop_occupancy(name, k, tile,
                                                          block),
                           "bitwise": ok, "ms": ms, "ms_per_step": ms / k,
                           "default": (tile == p.g_tile
                                       and block == p.g_block
                                       and k == p.g_k_default)}


def sweep_band(reps: int):
    """Yield one dict per launch shape of the band kernel's round launch
    (every block's bands at once) over the 8 blocks of the sharded main
    path, 16384 x 8192 of 32768^2 on (2, 4), at the default K: tile width
    and thread block (32 lanes by 2 to 16 warps), each first checked
    bitwise, grids and residual, against the per-block plain versions on
    the 8 blocks of 1000 x 1008 on (2, 4), then timed by CUDA events and
    by ``torch.profiler`` (``device_ms``, which ranks: ``ms_per_step`` is
    it over K)."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    k = p.g_k_default
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    small_grid = (1000, 1008)
    small = torch.from_numpy((rng.standard_normal(small_grid) * 10)
                             .astype(np.float32)).to(dev)
    s_mesh = HeatMesh(G_MESH, dev)
    s_blocks = s_mesh.split(small)
    _, _, s_xch = _g_setup(dev, small_grid, G_MESH, k, s_blocks)
    big_mesh, big_blocks, xch = _g_setup(dev, G_GRID, G_MESH, k)
    s_bs, bs = s_blocks[0].shape, big_blocks[0].shape
    s_kw = dict(origins=[s_mesh.origin(i, s_bs) for i in range(8)],
                grid_shape=small_grid, cx=CX, cy=CY)
    kw = dict(origins=[big_mesh.origin(i, bs) for i in range(8)],
              grid_shape=G_GRID, cx=CX, cy=CY)
    s_pieces = (s_xch.tail, s_xch.halo_n, s_xch.halo_s)
    pieces = (xch.tail, xch.halo_n, xch.halo_s)
    wants = [torch.full_like(b, float("nan")) for b in s_blocks]
    rps = [skb.band_fix_plain(s_blocks[i], *s_xch.pieces(i), wants[i], k,
                              origin=s_kw["origins"][i], grid_shape=small_grid,
                              cx=CX, cy=CY) for i in range(8)]
    rp = torch.stack(rps).amax()
    outs = [torch.empty_like(b) for b in big_blocks]
    size = "x".join(map(str, bs))
    for tile_x in G_BAND_TILES:
        for block in G_BAND_BLOCKS:
            geo = (tile_x,) + block
            if not p.loop_takes((k, tile_x), block):
                continue
            got = [torch.full_like(b, float("nan")) for b in s_blocks]
            r = skb.BandLaunch(s_blocks, *s_pieces, got, k, geometry=geo,
                               **s_kw)(True)
            ok = bool(all(torch.equal(a.nan_to_num(7.0), w.nan_to_num(7.0))
                          for a, w in zip(got, wants))
                      and torch.equal(r, rp))
            launch = skb.BandLaunch(big_blocks, *pieces, outs, k,
                                    geometry=geo, **kw)
            ms = time_ms(lambda: launch(False), reps)
            dms = device_ms(lambda: launch(False), "heat_g_band_fix_kernel")
            yield {"kernel": "heat_g_band_fix", "size": size, "blocks": 8,
                   "tile_x": tile_x, "block": list(block), "k": k,
                   "load": launch.load,
                   "thread_blocks": 8 * 2 * -(-bs[1] // tile_x),
                   "smem_bytes": p.g_smem_bytes(k, (k, tile_x)),
                   "blocks_per_sm_by_smem_threads":
                       p.g_blocks_per_sm(k, (k, tile_x), block),
                   "bitwise": ok, "ms": ms, "device_ms": dms,
                   "ms_per_step": dms / k,
                   "default": (tile_x == p.g_band_tile_x
                               and block == p.g_band_block)}
    # The load's share at the default shape: each load in turns (cells,
    # rows, none, none, rows, cells), three times; "none" loads nothing
    # (the steps alone: its output is not the band, so it is not
    # compared).
    launches = {load: skb.BandLaunch(big_blocks, *pieces, outs, k, load=load,
                                     **kw) for load in skb.BAND_LOADS}
    times = {load: [] for load in launches}
    for _ in range(3):
        for load in ("cells", "rows", "none", "none", "rows", "cells"):
            times[load].append(device_ms(lambda: launches[load](False),
                                         "heat_g_band_fix_kernel"))
    for load, ms in times.items():
        ok = None
        if load != "none":
            got = [torch.full_like(b, float("nan")) for b in s_blocks]
            r = skb.BandLaunch(s_blocks, *s_pieces, got, k, load=load,
                               **s_kw)(True)
            ok = bool(all(torch.equal(a.nan_to_num(7.0), w.nan_to_num(7.0))
                          for a, w in zip(got, wants)) and torch.equal(r, rp))
        yield {"kernel": "heat_g_band_fix", "size": size, "mode": "load",
               "load": load, "k": k, "tile_x": p.g_band_tile_x,
               "block": list(p.g_band_block), "bitwise": ok,
               "device_ms_turns": ms, "ms_per_step": float(np.mean(ms)) / k}


def _h_setup(dev, grid, mesh_shape, k, blocks):
    """The K-deep 3D exchange of ``blocks`` after all three phases."""
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    mesh = HeatMesh(mesh_shape, dev)
    xch = temporal3d.DeepExchange3D(mesh, mesh.block_shape(grid), k, dev)
    xch.lead(blocks)
    xch.last(blocks)
    return mesh, xch


def sweep_h(reps: int):
    """Yield one dict per launch of kernel H (F's plane loop on the
    assembled circular block, rows padded) at the sharded 3D main path's
    block, 512^3 of 1024^3 on (2, 2, 2), block 7: each of
    :data:`F_SHAPES` at every K it takes (the segment of
    ``hopper_params.hc_launch``, ``hc_prefetch`` planes in flight, or
    fewer where the shared memory holds fewer) under the TMA load, and
    the cp.async load at ``hc_shape``'s; then, at the fastest shape a
    step, segments and prefetch depths; then the defaults' monolithic
    H-fused, H and band launches and kernel F on 512^3. Each launch shape
    is first checked bitwise (grid and residual) against the plain
    version on blocks 0 and 13 of 20 x 128 x 252 blocks on (3, 3, 3),
    whose tiles run both kinds."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    s_mesh_shape, s_block = (3, 3, 3), (20, 128, 252)
    s_grid = tuple(m * b for m, b in zip(s_mesh_shape, s_block))
    s_us = HeatMesh(s_mesh_shape, dev).split(torch.from_numpy(
        (rng.standard_normal(s_grid) * 10).astype(np.float32)).to(dev))
    mesh = HeatMesh(H_MESH, dev)
    bs = mesh.block_shape(H_GRID)
    plate = HeatPlate3D(*H_GRID)
    us = [plate.init_block(dev, mesh.origin(b, bs), bs)
          for b in range(mesh.size)]
    b = mesh.size - 1
    size = "x".join(map(str, bs))
    kw3 = dict(zip(("cx", "cy", "cz"), COEFFS_3D))
    big_kw = dict(origin=mesh.origin(b, bs), grid_shape=H_GRID, cx=CX,
                  cy=CY, cz=CZ)
    out = torch.empty(bs, device=dev)
    cache = {}

    def setup(k):
        if k not in cache:
            cache.clear()
            s_mesh, s_xch = _h_setup(dev, s_grid, s_mesh_shape, k, s_us)
            checks = []
            for sb in (0, 13):
                ext = s_xch.new_circular()
                s_xch.assemble_circular(sb, s_us[sb], ext)
                skw = dict(origin=s_mesh.origin(sb, s_block),
                           grid_shape=s_grid, **kw3)
                want = torch.empty(s_block, device=dev)
                res = skb3.h_block_plain(ext, want, k, **skw)
                checks.append((ext, want, res, skw))
            _, xch = _h_setup(dev, H_GRID, H_MESH, k, us)
            ext = xch.new_circular()
            xch.assemble_circular(b, us[b], ext)
            cache[k] = (checks, ext)
        return cache[k]

    def row(k, shape, load, mode, seg=None):
        block, rows, prefetch = shape
        checks, ext = setup(k)
        ok = True
        for c_ext, want, res, skw in checks:
            got = torch.full_like(want, float("nan"))
            r = skb3._launch_h(c_ext, got, k, True, load, p.hc_launch(
                s_block, k, shape), **skw)
            ok = ok and bool(torch.equal(got, want) and torch.equal(r, res))
        launch = p.hc_launch(bs, k, shape)
        if seg is not None:
            launch = launch[:3] + (seg,)
        ms = time_ms(lambda: skb3._launch_h(ext, out, k, False, load, launch,
                                            **big_kw), reps)
        return {"kernel": "heat_h_block_3d", "mode": mode, "size": size,
                "block": list(block), "rows": rows, "k": k, "load": load,
                "segment": launch[3], "prefetch": prefetch,
                "smem_bytes": p.f_smem_bytes(k, block, rows, prefetch),
                "bitwise": ok, "ms": ms, "ms_per_step": ms / k,
                "default": (shape == p.hc_shape(k) and seg is None
                            and k == p.h_k_default)}

    best = None
    for k in range(1, p.f_k_compiled + 1):
        for block, rows in F_SHAPES:
            prefetch = next((n for n in range(p.hc_prefetch, 0, -1)
                             if p.f_takes(block, rows, k)
                             and k <= p.f_k_max(block, rows, n)), None)
            if prefetch is None:
                continue
            r = row(k, (block, rows, prefetch), "tma", "tma")
            if r["bitwise"] and (best is None or r["ms_per_step"]
                                 < best["ms_per_step"]):
                best = r
            yield r
        yield row(k, p.hc_shape(k), "cp.async", "cp.async")
    shape = (tuple(best["block"]), best["rows"], best["prefetch"])
    k = best["k"]
    for seg in H_SEGMENTS:
        yield row(k, shape, "tma", "tma segments", seg=seg)
    for prefetch in F_PREFETCH:
        if k <= p.f_k_max(shape[0], shape[1], prefetch):
            yield row(k, shape[:2] + (prefetch,), "tma", "tma prefetch")
    # The defaults' monolithic, assembled and band launches, and F.
    k = p.h_k_default
    _, xch = _h_setup(dev, H_GRID, H_MESH, k, us)
    pieces = xch.pieces(b)
    ext = xch.new_circular()
    xch.assemble_circular(b, us[b], ext)
    cube = HeatPlate3D(*bs).init_grid(dev)
    cube_out = torch.empty_like(cube)
    kw = dict(cx=CX, cy=CY, cz=CZ)
    for name, mode, fn in (
            ("heat_h_block_3d_fused", "monolithic",
             lambda: skb3.h_block_fused(us[b], *pieces, out, k, False,
                                        **big_kw)),
            ("heat_h_block_3d", "monolithic",
             lambda: skb3.h_block(ext, out, k, False, **big_kw)),
            ("heat_h_block_3d", "monolithic cp.async",
             lambda: skb3.h_block(ext, out, k, False, load="cp.async",
                                  **big_kw)),
            ("heat_h_band_fix_3d", "band",
             lambda: skb3.h_band_fix(us[b], *pieces, out, k, False,
                                     **big_kw)),
            ("heat_f_temporal3d", "one grid",
             lambda: sk3.xslab_steps_3d(cube, cube_out, k, False, **kw))):
        ms = time_ms(fn, reps)
        yield {"kernel": name, "mode": mode, "size": size, "k": k,
               "bitwise": True, "ms": ms, "ms_per_step": ms / k,
               "default": True}


def sweep_hband(reps: int):
    """Yield one dict per launch of the 3D band's round launch (every
    block's bands at once, F's plane loop) over the 8 blocks of the
    sharded 3D main path, 512^3 of 1024^3 on (2, 2, 2), at K =
    ``h_k_default``: each of :data:`H_BAND_SHAPES` with every prefetch
    depth of :data:`H_BAND_PREFETCH` that fits under the 16-byte load;
    then the fastest of those under the 4-byte load; each first checked
    bitwise (grids
    and residual) against the batched plain version on the 8 blocks of
    40 x 128 x 252 and 67 x 43 x 90 on (2, 2, 2) into NaN-filled outputs,
    then timed by ``torch.profiler`` (``device_ms``, which ranks) and
    CUDA events."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    k = p.h_k_default
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    kw3 = dict(zip(("cx", "cy", "cz"), COEFFS_3D))
    checks = []
    for block in ((40, 128, 252), (67, 43, 90)):
        grid = tuple(2 * b for b in block)
        g = torch.from_numpy((rng.standard_normal(grid) * 10)
                             .astype(np.float32)).to(dev)
        mesh = HeatMesh(H_MESH, dev)
        s_us = mesh.split(g)
        _, s_xch = _h_setup(dev, grid, H_MESH, k, s_us)
        origins = [mesh.origin(i, block) for i in range(mesh.size)]
        pieces = (s_xch.ztail, s_xch.ytail, s_xch.xlo, s_xch.xhi)
        want = [torch.full(block, float("nan"), device=dev) for _ in s_us]
        res = skb3.band_fix_blocks_3d_plain(s_us, *pieces, want, k,
                                            origins=origins,
                                            grid_shape=grid, **kw3)
        checks.append((s_us, pieces, want, res,
                       dict(origins=origins, grid_shape=grid, **kw3)))
    mesh = HeatMesh(H_MESH, dev)
    bs = mesh.block_shape(H_GRID)
    plate = HeatPlate3D(*H_GRID)
    us = [plate.init_block(dev, mesh.origin(b, bs), bs)
          for b in range(mesh.size)]
    _, xch = _h_setup(dev, H_GRID, H_MESH, k, us)
    pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
    outs = [torch.empty_like(u) for u in us]
    kw = dict(origins=[mesh.origin(i, bs) for i in range(mesh.size)],
              grid_shape=H_GRID, cx=CX, cy=CY, cz=CZ)
    size = "x".join(map(str, bs))
    default = p.h_band_shape(k)

    def row(shape, load):
        ok = True
        for s_us, s_pieces, want, res, s_kw in checks:
            ld = load if load != "vec" or s_us[0].shape[2] % 4 == 0 \
                else "cells"
            got = [torch.full_like(w, float("nan")) for w in want]
            r = skb3.BandLaunch3D(s_us, *s_pieces, got, k, shape=shape,
                                  load=ld, **s_kw)(True)
            ok = ok and bool(torch.equal(r, res) and all(
                torch.equal(a.nan_to_num(7.0), w.nan_to_num(7.0))
                for a, w in zip(got, want)))
        launch = skb3.BandLaunch3D(us, *pieces, outs, k, shape=shape,
                                   load=load, **kw)
        dms = device_ms(lambda: launch(False), "heat_h_band_fix_3d_kernel")
        ms = time_ms(lambda: launch(False), reps)
        (_, warps), rows, prefetch = shape
        ty, tz = p.h_band_tiles(bs, k, shape)
        return {"kernel": "heat_h_band_fix_3d", "size": size, "blocks": 8,
                "block": list(shape[0]), "rows": rows,
                "prefetch": prefetch, "k": k, "load": load,
                "thread_blocks": 8 * 2 * ty * tz,
                "smem_bytes": p.f_smem_bytes(k, shape[0], rows, prefetch),
                "bitwise": ok, "ms": ms, "device_ms": dms,
                "ms_per_step": dms / k,
                "default": shape == default and load == launch.load}

    best = None
    for block, rows in H_BAND_SHAPES:
        for prefetch in H_BAND_PREFETCH:
            shape = (block, rows, prefetch)
            if not (p.h_band_takes(block, rows, k)
                    and k <= p.f_k_max(block, rows, prefetch)):
                continue
            r = row(shape, "vec")
            if r["bitwise"] and (best is None
                                 or r["device_ms"] < best["device_ms"]):
                best = r
            yield r
    shape = (tuple(best["block"]), best["rows"], best["prefetch"])
    yield row(shape, "cells")
    yield row(default, "vec")
    yield row(default, "cells")


def sweep_hfused(reps: int):
    """Yield one dict per launch shape of H-fused's deferred bulk at the
    sharded 3D main path's block (the sweep of ``hopper_params``' ``h_*``
    entries)."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    # The check block holds a tile inside it at every shape of
    # h_tma_rows rows (2w - 3K cells along each axis for an extended tile
    # w wide), so that the TMA load is checked wherever the main block
    # takes it.
    s_mesh_shape, s_block = (3, 3, 3), (21, 128, 256)
    s_grid = tuple(m * b for m, b in zip(s_mesh_shape, s_block))
    s_us = HeatMesh(s_mesh_shape, dev).split(torch.from_numpy(
        (rng.standard_normal(s_grid) * 10).astype(np.float32)).to(dev))
    sb = 13                                     # the interior block
    mesh = HeatMesh(H_MESH, dev)
    bs = mesh.block_shape(H_GRID)
    plate = HeatPlate3D(*H_GRID)
    us = [plate.init_block(dev, mesh.origin(b, bs), bs)
          for b in range(mesh.size)]
    b = mesh.size - 1
    size = "x".join(map(str, bs))
    kw3 = dict(zip(("cx", "cy", "cz"), COEFFS_3D))
    kw = dict(cx=CX, cy=CY, cz=CZ)
    out = torch.empty(bs, device=dev)
    best = None
    for k in range(1, p.h_k_compiled + 1):
        s_mesh, s_xch = _h_setup(dev, s_grid, s_mesh_shape, k, s_us)
        _, xch = _h_setup(dev, H_GRID, H_MESH, k, us)
        s_kw = dict(origin=s_mesh.origin(sb, s_block), grid_shape=s_grid,
                    **kw3)
        big_kw = dict(origin=mesh.origin(b, bs), grid_shape=H_GRID, **kw)
        zt, yt, _, _ = s_xch.pieces(sb)
        want = torch.full(s_block, float("nan"), device=dev)
        rp = skb3.h_block_fused_plain(s_us[sb], zt, yt, None, None, want, k,
                                      defer_x=True, **s_kw)
        bzt, byt, _, _ = xch.pieces(b)
        for block, rows in H_SHAPES:
            if k > p.h_k_max(block, rows):
                continue
            seg = p.h_launch(bs, k, bs[0] - 2 * k, block, rows)
            geo = (block[0], block[1], rows)
            tma = int(p.h_tma_fits(bs, k, block, rows)
                      and p.h_tma_fits(s_block, k, block, rows))
            mid = (k, k, k, 1, tma)
            got = torch.full_like(want, float("nan"))
            r = skb3._launch("heat_h_block_3d_fused", (s_us[sb], zt, yt, None,
                                                       None), got, k, True,
                             mid=mid, geometry=geo + (
                                 p.h_launch(s_block, k, s_block[0] - 2 * k,
                                            block, rows),), **s_kw)
            ok = bool(torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
                      and torch.equal(r, rp))
            ms = time_ms(lambda: skb3._launch(
                "heat_h_block_3d_fused", (us[b], bzt, byt, None, None), out,
                k, False, mid=mid, geometry=geo + (seg,), **big_kw), reps)
            row = {"kernel": "heat_h_block_3d_fused", "mode": "bulk",
                   "size": size, "block": list(block), "rows": rows, "k": k,
                   "load": "tma" if tma else "cp.async", "segment": seg,
                   "smem_bytes": (p.h_tma_smem_bytes(k, block, rows) if tma
                                  else p.h_smem_bytes(k, block, rows)),
                   "bitwise": ok, "ms": ms, "ms_per_step": ms / k,
                   "default": (block == p.h_block and rows == p.h_rows
                               and k == p.h_k_default)}
            if ok and (best is None or row["ms_per_step"]
                       < best["ms_per_step"]):
                best = row
            yield row
        del s_xch, xch
    # The X segment at the fastest shape per step.
    k, block, rows = best["k"], tuple(best["block"]), best["rows"]
    _, xch = _h_setup(dev, H_GRID, H_MESH, k, us)
    bzt, byt, xlo, xhi = xch.pieces(b)
    big_kw = dict(origin=mesh.origin(b, bs), grid_shape=H_GRID, **kw)
    mid = (k, k, k, 1, int(best["load"] == "tma"))
    for seg in H_SEGMENTS:
        ms = time_ms(lambda: skb3._launch(
            "heat_h_block_3d_fused", (us[b], bzt, byt, None, None), out, k,
            False, mid=mid, geometry=(block[0], block[1], rows, seg),
            **big_kw), reps)
        yield {"kernel": "heat_h_block_3d_fused", "mode": "bulk-segment",
               "size": size, "block": list(block), "rows": rows, "k": k,
               "load": best["load"], "segment": seg,
               "bitwise": best["bitwise"], "ms": ms,
               "ms_per_step": ms / k, "default": False}


def sass_loops(sass: str):
    """``[(start, end, instructions)]`` of each backward branch's loop body
    in a ``cuobjdump -sass`` listing."""
    instrs = [(int(a, 16), text) for a, text in _SASS_LINE.findall(sass)]
    loops = []
    for addr, text in instrs:
        m = _BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            body = [t for a, t in instrs if start <= a <= addr]
            loops.append((hex(start), hex(addr), len(body)))
    return loops


_FUNCTION = re.compile(r"Function : (\S+)")
_F_INSTANCE = re.compile(
    r"heat_f_temporal3d_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?")
_SHARED = re.compile(r"^(LDS|STS)(?:\.U)?(?:\.(32|64|128))?\b")


def _sass_op(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def _sass_counts(instrs, lo: int, hi: int) -> dict:
    """Instructions, FMUL, FFMA, FADD, SHFL, LDS, bytes of shared memory
    read or written, and local loads and stores (LDL, STL: spilled
    registers) in addresses ``[lo, hi)`` of ``[(address, text)]``."""
    ops = [_sass_op(t) for a, t in instrs if lo <= a < hi]
    shared = sum(int(m.group(2) or 32) // 8 for m in map(_SHARED.match, ops)
                 if m)
    return {"instructions": len(ops),
            "fmul": sum(op.startswith("FMUL") for op in ops),
            "ffma": sum(op.startswith("FFMA") for op in ops),
            "fadd": sum(op.startswith("FADD") for op in ops),
            "shfl": sum(op.startswith("SHFL") for op in ops),
            "lds": sum(op.startswith("LDS") for op in ops),
            "shared_bytes": shared,
            "ldl": sum(op.startswith("LDL") for op in ops),
            "stl": sum(op.startswith("STL") for op in ops)}


def sass_f_report(sass: str, k: int):
    """Per instance of kernel F at depth ``k`` in a ``cuobjdump -sass``
    listing: its size, its plane loop (the largest loop), and the step of
    one plane on the test-free path, a cell-step being 4 FMUL of the
    combine. A plane's levels are compiled twice, test-free and checked
    (cells past the interior copied), as the two sides of a branch: a
    conditional branch to one body, which the other body skips with an
    unconditional branch, both with the same FMUL. ``inner`` is the
    smaller of the first such pair in the plane loop (the last level's
    stores and residual included, both sides of their branches), and
    ``plane`` adds what the loop runs for a plane before that branch
    (the wait for the plane, the barrier, the next plane's load, the
    ring's slot): per cell-step, instructions, shuffles and bytes of
    shared memory."""
    out = []
    for chunk in re.split(r"(?=\n\s*Function : )", sass):
        name = _FUNCTION.search(chunk)
        inst = name and _F_INSTANCE.search(name.group(1))
        if not inst or int(inst.group(1)) != k:
            continue
        instrs = [(int(a, 16), t) for a, t in _SASS_LINE.findall(chunk)]
        loops = sorted(sass_loops(chunk), key=lambda lp: -lp[2])
        row = {"instance": name.group(1), "k": k,
               "rows": int(inst.group(2)),
               "tma": inst.group(3) == "1" if inst.group(3) else None,
               "instructions": len(instrs), "loops": loops[:4]}
        if loops:
            row.update(_plane_step(instrs, loops[0]))
        out.append(row)
    return out


def _plane_step(instrs, loop, fmul_per_cell: int = 4) -> dict:
    """The plane loop ``loop`` (``(start, end, n)`` of :func:`sass_loops`)
    of a kernel on F's plane loop: its counts, and the step of one plane
    on the test-free path as :func:`sass_f_report` finds it (a cell-step
    ``fmul_per_cell`` FMUL: 4 in 3D, 3 in 2D)."""
    lo, hi = int(loop[0], 16), int(loop[1], 16)
    row = {"plane_loop": _sass_counts(instrs, lo, hi + 1)}
    for a, t in instrs:
        m = _BRANCH.search(t)
        if not (lo <= a <= hi and t.startswith("@") and m):
            continue
        x = int(m.group(1), 16)
        skip = [(b, _BRANCH.search(u)) for b, u in instrs
                if a < b < x and not u.startswith("@")
                and _BRANCH.search(u)]
        if x <= a or not skip:
            continue
        b, mb = skip[-1]
        y = int(mb.group(1), 16)
        first = _sass_counts(instrs, a + 1, x)
        second = _sass_counts(instrs, x, y)
        if y <= x or not first["fmul"] or first["fmul"] != second["fmul"]:
            continue
        body = min(first, second, key=lambda c: c["instructions"])
        pre = _sass_counts(instrs, lo, a + 1)
        cells = body["fmul"] / fmul_per_cell
        row["inner"] = body
        row["plane_overhead"] = pre
        row["inner_per_cell_step"] = {
            key: body[key] / cells
            for key in ("instructions", "shfl", "shared_bytes")}
        row["plane_per_cell_step"] = {
            key: (body[key] + pre[key]) / cells
            for key in ("instructions", "shfl", "shared_bytes")}
        break
    return row


_H_INSTANCE = re.compile(r"heat_h_block_3d_kernelILi(\d+)ELi(\d+)EE")


def sass_h_report(sass: str, k: int):
    """Per instance of kernel H at depth ``k`` in a ``cuobjdump -sass``
    listing: its size and, for each of its four plane loops (the box and
    the per-cell load, each with tiles inside the global interior and at
    its edge: the four largest loops), the step of one plane as
    :func:`sass_f_report` finds it in F's."""
    out = []
    for chunk in re.split(r"(?=\n\s*Function : )", sass):
        name = _FUNCTION.search(chunk)
        inst = name and _H_INSTANCE.search(name.group(1))
        if not inst or int(inst.group(1)) != k:
            continue
        instrs = [(int(a, 16), t) for a, t in _SASS_LINE.findall(chunk)]
        loops = sorted(sass_loops(chunk), key=lambda lp: -lp[2])[:4]
        out.append({"instance": name.group(1), "k": k,
                    "rows": int(inst.group(2)), "instructions": len(instrs),
                    "plane_loops": [dict(_plane_step(instrs, lp), at=lp[0])
                                    for lp in loops]})
    return out


_I_INSTANCE = re.compile(r"heat_i(?:_uni)?_tile_temporal_kernelILi(\d+)E")


def sass_i_report(sass: str, k: int):
    """Per instance of kernel I or I-uni at depth ``k`` in a ``cuobjdump
    -sass`` listing: its size; each loop that steps cells (3 FMUL a
    cell-step), with its instructions, shuffles, shared loads and bytes a
    cell-step over the whole loop body (its waits and refills counted
    once, as they lie in the body), and its local loads and stores
    (spilled registers) in the body; ``step_per_cell_step``, those of the
    loop with the fewest instructions a cell-step; and, where a loop
    compiles its levels twice as the two sides of a branch (test-free
    and checked), the test-free side as :func:`sass_f_report` finds it
    (``branch_step``)."""
    out = []
    for chunk in re.split(r"(?=\n\s*Function : )", sass):
        name = _FUNCTION.search(chunk)
        inst = name and _I_INSTANCE.search(name.group(1))
        if not inst or int(inst.group(1)) != k:
            continue
        instrs = [(int(a, 16), t) for a, t in _SASS_LINE.findall(chunk)]
        loops = []
        for lp in sass_loops(chunk):
            lo, hi = int(lp[0], 16), int(lp[1], 16)
            c = _sass_counts(instrs, lo, hi + 1)
            if not c["fmul"]:
                continue
            cells = c["fmul"] / 3
            loops.append({"at": lp[0], "instructions": c["instructions"],
                          "cells": cells, "ldl": c["ldl"], "stl": c["stl"],
                          "per_cell_step": {key: c[key] / cells for key in
                                            ("instructions", "shfl", "lds",
                                             "shared_bytes")},
                          "branch_step": _plane_step(instrs, lp, 3)})
        out.append({"instance": build.demangle(name.group(1)), "k": k,
                    "instructions": len(instrs), "loops": loops,
                    "step_per_cell_step": min(
                        (lp["per_cell_step"] for lp in loops),
                        key=lambda c: c["instructions"], default=None)})
    return out


_A_INSTANCE = re.compile(r"heat_a_resident_kernel(?:ILi0EE|P)")


def sass_a_report(sass: str):
    """Per instance of kernel A that computes A's function (``<0>``, or
    the untemplated kernel of an earlier tree) in a ``cuobjdump -sass``
    listing: :func:`sass_step_report`."""
    return sass_step_report(sass, _A_INSTANCE)


def sass_step_report(sass: str, instance=re.compile(".")):
    """Per function whose name ``instance`` matches in a ``cuobjdump
    -sass`` listing of a 2D kernel: each loop that steps cells (3 FMUL a
    cell-step: the combine's three multiplies), with its instructions,
    shuffles, shared loads and shared-memory bytes a cell-step and
    whether it stores to global memory (the last step's loop); and
    ``step_per_cell_step``, those of the cheapest loop that does not (the
    test-free inner step)."""
    out = []
    for chunk in re.split(r"(?=\n\s*Function : )", sass):
        name = _FUNCTION.search(chunk)
        if not name or not instance.search(name.group(1)):
            continue
        instrs = [(int(a, 16), t) for a, t in _SASS_LINE.findall(chunk)]
        loops = []
        for lo, hi, _ in sass_loops(chunk):
            lo, hi = int(lo, 16), int(hi, 16)
            c = _sass_counts(instrs, lo, hi + 1)
            if not c["fmul"]:
                continue
            cells = c["fmul"] / 3
            loops.append({
                "at": hex(lo), "instructions": c["instructions"],
                "cells": cells,
                "global_store": any(_sass_op(t).startswith("STG")
                                    for a, t in instrs if lo <= a <= hi),
                "per_cell_step": {key: c[key] / cells for key in
                                  ("instructions", "shfl", "lds",
                                   "shared_bytes")}})
        inner = [lp for lp in loops if not lp["global_store"]]
        out.append({"instance": name.group(1), "instructions": len(instrs),
                    "loops": loops,
                    "step_per_cell_step": min(
                        (lp["per_cell_step"] for lp in inner),
                        key=lambda c: c["instructions"], default=None)})
    return out


def dump_sass(out_dir: str, libraries=None):
    """Write each kernel library's SASS to ``out_dir`` and print its
    loops; for kernel F also :func:`sass_f_report` at the default K.
    ``libraries`` (name -> path) defaults to this tree's builds."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for name, path in (libraries or build.build()).items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as fp:
            fp.write(sass)
        print(json.dumps({"sass": name, "loops": sass_loops(sass)}),
              flush=True)
        if name == "heat_f_temporal3d":
            for row in sass_f_report(sass, params().f_k_default):
                print(json.dumps({"sass_f": row}), flush=True)
        if name == "heat_h_block_3d":
            for row in sass_h_report(sass, params().h_k_default):
                print(json.dumps({"sass_h": row}), flush=True)
        if name == "heat_a_resident":
            for row in sass_a_report(sass):
                print(json.dumps({"sass_a": row}), flush=True)
        if name in ("heat_i_tile_temporal", "heat_i_uni_tile_temporal"):
            for row in sass_i_report(sass, params().i_k_default):
                print(json.dumps({"sass_i": row}), flush=True)


# The kernels on the register-blocked tile loop (csrc/heat_temporal.cuh),
# A's anatomy probe, F on its plane loop (csrc/heat_temporal3d.cuh) and
# the two probes that compile those loops' variants: what a change to the
# loops' compile-time hooks must leave instruction for instruction as it
# was.
LOOP_KERNELS = ("heat_e_temporal", "heat_e_uni_temporal",
                "heat_g_block_uniform", "heat_g_block_fused",
                "heat_g_block_circular", "heat_g_block_padded",
                "heat_g_band_fix", "heat_a_resident", "heat_m_ensemble",
                "heat_probe_kernel", "heat_f_temporal3d",
                "heat_probe_roll_pad", "heat_probe_xslab_overlap")
# Of those, the 3D ones: their cell-step is not the 2D loop's
# (sass_step_report counts 3 FMUL a cell-step).
_LOOP_3D = ("heat_f_temporal3d", "heat_probe_xslab_overlap")


def _sass_functions(path):
    """``(function name -> its instructions, addresses and encodings
    dropped; the listing)`` of a library's ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for chunk in re.split(r"(?=\n\s*Function : )", sass):
        name = _FUNCTION.search(chunk)
        if name:
            out[name.group(1)] = [" ".join(t.split())
                                  for _, t in _SASS_LINE.findall(chunk)]
    return out, sass


def sass_same(other: str, names=None):
    """Build kernels ``names`` (every kernel of ``build.KERNELS`` and
    ``build.TOOLS`` by default) in the tree at ``other`` (in its own
    process, beside this tree's build of them) and yield, per kernel, how
    many of its functions have the same instructions in both trees'
    libraries, the instruction counts of those that differ, and, for the
    2D loop kernels (:data:`LOOP_KERNELS`), this tree's instructions,
    shuffles and shared bytes a cell-step of each function's test-free
    inner step (:func:`sass_step_report`). A kernel the other tree does
    not have is built here alone and reported with ``"in_other_tree":
    False``."""
    names = names or tuple(build.KERNELS) + tuple(build.TOOLS)
    other = os.path.abspath(other)
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import json, sys\n"
         "from parallel_heat_tpu_torch.kernels import build\n"
         "names = [n for n in sys.argv[1:]\n"
         "         if n in build.KERNELS or n in build.TOOLS]\n"
         "print(json.dumps({k: str(v) for k, v in "
         "build.build(*names).items()}))", *names],
        cwd=other, env=dict(os.environ, PYTHONPATH=other),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    mine = build.build(*names)
    out, err = proc.communicate(timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"build in {other} failed:\n{err[-3000:]}")
    theirs = json.loads(out.strip().splitlines()[-1])
    for name in names:
        b, sass = _sass_functions(mine[name])
        a = _sass_functions(theirs[name])[0] if name in theirs else {}
        same = [f for f in a if a[f] == b.get(f)]
        yield {"sass_same": name, "in_other_tree": name in theirs,
               "functions": len(a), "identical": len(same),
               "only_this_tree": sorted(set(b) - set(a)),
               "differ": {build.demangle(f): [len(a[f]), len(b.get(f, []))]
                          for f in a if f not in same},
               "step_per_cell_step": None if (
                   name in _LOOP_3D or name not in LOOP_KERNELS) else {
                   build.demangle(r["instance"]): r["step_per_cell_step"]
                   for r in sass_step_report(sass)}}


def turn_times(reps: int, only=None) -> dict:
    """Device ms (CUDA events over ``reps`` launches, three times) of the
    default paths' kernels in whatever tree ``parallel_heat_tpu_torch``
    is imported from: F at 512^3, K = 3 (and its cp.async load where the
    tree has one), D at 512^3, H-fused monolithic and H at the 512^3
    block of 1024^3 on (2, 2, 2), E-uni and E at 16384^2, K = 8, G-uni's
    deferred bulk at the 16384 x 8192 block of 32768^2 on (2, 4), A at
    1000^2 (K = 20, residual) and M at 64 x 512^2 (K = 400), these two by
    ``torch.profiler``; the multigrid transfers' calls (events) and
    kernels (``device``, the profiler) at each of ``MG_TURN_SIZES``^2 <->
    its coarse level, and the 512^2 implicit runs' and the pinned H-defer
    1024^3 run's ``elapsed_s`` (host clock); and the sharded 3D picks. With ``only`` (names), those
    kernels alone, so that no other is built or set up."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal, temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    def wanted(*names):
        return only is None or any(n in only for n in names)

    p = params()
    dev = torch.device("cuda", torch.cuda.current_device())
    kw3 = dict(cx=CX, cy=CY, cz=CZ)
    kw2 = dict(cx=CX, cy=CY)
    runs, per_call, wall, by_device = {}, {}, {}, {}
    if wanted("F", "F cp.async", "D"):
        cube = HeatPlate3D(*(TURN_CUBE,) * 3).init_grid(dev)
        cube_out = torch.empty_like(cube)
        runs["F"] = lambda: sk3.xslab_steps_3d(cube, cube_out, 3, False,
                                               **kw3)
        if hasattr(sk3, "f_load"):
            runs["F cp.async"] = lambda: sk3.xslab_steps_3d(
                cube, cube_out, 3, False, load="cp.async", **kw3)
        runs["D"] = lambda: sk3.slab_step_3d(cube, cube_out, **kw3)
    mesh = HeatMesh(H_MESH, dev)
    bs = mesh.block_shape(H_GRID)
    if wanted("H-fused", "H", "H band round", "H band round device",
              "H round defer"):
        plate = HeatPlate3D(*H_GRID)
        us = [plate.init_block(dev, mesh.origin(b, bs), bs)
              for b in range(mesh.size)]
        b = mesh.size - 1
        _, xch = _h_setup(dev, H_GRID, H_MESH, 3, us)
        pieces = xch.pieces(b)
        # The padded circular block where the tree's exchange makes one
        # (the tree this file times may predate it).
        ext = (xch.new_circular() if hasattr(xch, "new_circular")
               else torch.empty(xch.circular_shape, device=dev))
        xch.assemble_circular(b, us[b], ext)
        out = torch.empty(bs, device=dev)
        hkw = dict(origin=mesh.origin(b, bs), grid_shape=H_GRID, **kw3)
        runs["H-fused"] = lambda: skb3.h_block_fused(us[b], *pieces, out, 3,
                                                     False, **hkw)
        runs["H"] = lambda: skb3.h_block(ext, out, 3, False, **hkw)
        # The H-defer round at those blocks: its band pass (one launch for
        # the 8 blocks where the tree has BandLaunch3D, else one a block),
        # its device time a call by the profiler, and the whole round.
        h_vs = [torch.empty_like(u) for u in us]
        h_origins = [mesh.origin(i, bs) for i in range(mesh.size)]
        if hasattr(skb3, "BandLaunch3D"):
            h_bands = skb3.BandLaunch3D(us, xch.ztail, xch.ytail, xch.xlo,
                                        xch.xhi, h_vs, 3, origins=h_origins,
                                        grid_shape=H_GRID, **kw3)
            runs["H band round"] = lambda: h_bands(False)
        else:
            runs["H band round"] = lambda: [skb3.h_band_fix(
                us[i], *xch.pieces(i), h_vs[i], 3, False,
                origin=h_origins[i], grid_shape=H_GRID, **kw3)
                for i in range(mesh.size)]
        per_call["H band round device"] = (runs["H band round"],
                                           "heat_h_band_fix_3d_kernel")
        h_round = temporal3d.cuda_round_3d(xch, "H-defer", "overlap",
                                           grid_shape=H_GRID, **kw3)
        runs["H round defer"] = lambda: h_round(us, h_vs, False)
    if wanted("E-uni", "E", "I", "I-uni", "I device", "I-uni device"):
        grid = HeatPlate2D(TURN_PLATE, TURN_PLATE).init_grid(dev)
        grid_out = torch.empty_like(grid)
        runs["E-uni"] = lambda: sk.temporal_steps_uni(grid, grid_out, 8,
                                                      False, **kw2)
        runs["E"] = lambda: sk.temporal_steps(grid, grid_out, 8, False,
                                              **kw2)
        # I and I-uni (pinned only) at K = 8: events, and the kernel's own
        # time by the profiler.
        runs["I"] = lambda: sk.tile_temporal_steps(grid, grid_out, 8, False,
                                                   **kw2)
        runs["I-uni"] = lambda: sk.tile_temporal_steps_uni(
            grid, grid_out, 8, False, **kw2)
        by_device["I device"] = (runs["I"], "heat_i_tile_temporal_kernel")
        by_device["I-uni device"] = (runs["I-uni"],
                                     "heat_i_uni_tile_temporal_kernel")
    if wanted("G-uni bulk", "G band round", "G band round device",
              "G round overlap", "G round phase"):
        g_mesh = HeatMesh(G_MESH, dev)
        g_bs = g_mesh.block_shape(G_GRID)
        g_plate = HeatPlate2D(*G_GRID)
        gb = g_mesh.index((1, 1))
        g_us = [g_plate.init_block(dev, g_mesh.origin(i, g_bs), g_bs)
                for i in range(g_mesh.size)]
        g_xch = temporal.DeepExchange2D(g_mesh, g_bs, 8, dev)
        g_xch.phase1(g_us)
        g_xch.phase2(g_us)
        tail, _, _ = g_xch.pieces(gb)
        g_out = torch.empty(g_bs, device=dev)
        gkw = dict(origin=g_mesh.origin(gb, g_bs), grid_shape=G_GRID, **kw2)
        runs["G-uni bulk"] = lambda: skb.block_uniform(
            g_us[gb], tail, None, None, g_out, 8, False, **gkw)
        # The sharded 2D round at those blocks: its band pass (one launch
        # for the 8 blocks where the tree has BandLaunch, else one a
        # block) and a whole round under each schedule; the band pass's
        # device time a call by the profiler (``per_call``).
        g_vs = [torch.empty_like(u) for u in g_us]
        g_origins = [g_mesh.origin(i, g_bs) for i in range(g_mesh.size)]
        if hasattr(skb, "BandLaunch"):
            bands = skb.BandLaunch(g_us, g_xch.tail, g_xch.halo_n,
                                   g_xch.halo_s, g_vs, 8, origins=g_origins,
                                   grid_shape=G_GRID, **kw2)
            runs["G band round"] = lambda: bands(False)
        else:
            runs["G band round"] = lambda: [skb.band_fix(
                g_us[i], *g_xch.pieces(i), g_vs[i], 8, False,
                origin=g_origins[i], grid_shape=G_GRID, **kw2)
                for i in range(g_mesh.size)]
        per_call["G band round device"] = (runs["G band round"],
                                           "heat_g_band_fix_kernel")
        for mode in ("overlap", "phase"):
            round_fn = temporal._cuda_round_2d(g_xch, "G-uni", mode,
                                               grid_shape=G_GRID, **kw2)
            runs[f"G round {mode}"] = (
                lambda fn=round_fn: fn(g_us, g_vs, False))
    from parallel_heat_tpu_torch import HeatConfig, solve, tune

    # The host-bound sharded converge run, 1000^2 on (2, 4), and the 512^2
    # implicit runs: their elapsed_s (the host's clock around the step
    # loop).
    conv_cfg = HeatConfig(nx=1000, ny=1000, steps=10000, converge=True,
                          check_interval=20, eps=1e-3, mesh_shape=(2, 4))
    wall["converge 1000^2 2x4 s"] = lambda: solve(conv_cfg).elapsed_s
    # The pinned H-defer run of the sharded 3D main path (1024^3 on
    # (2, 2, 2), 200 steps): its elapsed_s.
    hd_cfg = HeatConfig(nx=1024, ny=1024, nz=1024, steps=200,
                        mesh_shape=(2, 2, 2))

    def h_defer_s():
        with tune.force("block_temporal_3d", "H-defer"):
            return solve(hd_cfg).elapsed_s

    wall["H-defer 1024^3 s"] = h_defer_s
    for scheme in ("backward_euler", "crank_nicolson"):
        imp_cfg = HeatConfig(nx=512, ny=512, cx=22.5, cy=22.5, steps=20,
                             scheme=scheme)
        wall[f"implicit 512^2 {scheme} s"] = (
            lambda cfg=imp_cfg: solve(cfg).elapsed_s)
    # The transfers: a call (events; host issue where the kernel is
    # shorter) and the kernel alone (the profiler's device time).
    rng = np.random.default_rng(0)
    for size in MG_TURN_SIZES:
        names = [f"{k} {size}^2{d}" for k in ("restrict", "prolong")
                 for d in ("", " device")]
        if not wanted(*names):
            continue
        fine = (size, size)
        coarse = ((size - 2) // 2 + 2,) * 2
        r = torch.from_numpy((rng.standard_normal(fine) * 10)
                             .astype(np.float32)).to(dev)
        c = torch.from_numpy((rng.standard_normal(coarse) * 10)
                             .astype(np.float32)).to(dev)
        c[0] = c[-1] = 0
        c[:, 0] = c[:, -1] = 0
        for what, fn in (
                ("restrict", lambda r=r, s=coarse: mg.restrict(r, s)),
                ("prolong", lambda c=c, s=fine: mg.prolong(c, s))):
            runs[f"{what} {size}^2"] = fn
            by_device[f"{what} {size}^2 device"] = (fn, f"heat_mg_{what}")
    # A at the converge path's 1000^2 (one 20-step window, residual) and
    # M at the ensemble path's 64 x 512^2 (K = 400): device time, since
    # A's launch is shorter than the host's time to issue one.
    if wanted("A"):
        a_grid = HeatPlate2D(1000, 1000).init_grid(dev)
        a_out = torch.empty_like(a_grid)
        by_device["A"] = (lambda: sk.resident_steps(a_grid, a_out, 20, True,
                                                    **kw2),
                          "heat_a_resident_kernel")
    if wanted("M"):
        stack = torch.from_numpy((np.random.default_rng(0).standard_normal(
            (64, 512, 512)) * 10).astype(np.float32)).to(dev)
        stack_out = torch.empty_like(stack)
        by_device["M"] = (lambda: batched.ensemble_steps(
            stack, stack_out, 400, False, **kw2), "heat_m_ensemble_kernel")
    if only:
        runs = {n: f for n, f in runs.items() if n in only}
        by_device = {n: f for n, f in by_device.items() if n in only}
        per_call = {n: f for n, f in per_call.items() if n in only}
        wall = {n: f for n, f in wall.items() if n in only}
    times = {name: [] for name in (list(runs) + list(by_device)
                                   + list(per_call) + list(wall))}
    for _ in range(3):
        for name, fn in runs.items():
            times[name].append(time_ms(fn, reps))
        for name, (fn, kernel) in by_device.items():
            times[name].append(device_ms(fn, kernel))
        for name, (fn, kernel) in per_call.items():
            times[name].append(device_ms_per_call(fn, kernel))
        for name, fn in wall.items():
            times[name].append(fn())
    return {"ms": times,
            "picks": {"h_k_max": p.h_k_max(), "h_load": skb3.h_load(bs, 3),
                      "h_launch": p.h_launch(bs, 3, bs[0]),
                      "block_temporal_3d": repr(
                          skb3.pick_block_temporal_3d(bs, 3))}}


def turns(other: str, reps: int, only=None):
    """:func:`turn_times` in the tree at ``other`` and in this one, in
    turns (other, this, this, other), each in its own process (of the
    kernels named in ``only``, or all); yields one dict per kernel with
    the four runs' mean times."""
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [os.path.abspath(other), this, this, os.path.abspath(other)]
    runs = []
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=tree + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn-of",
             str(reps)] + (["--turns-only", ",".join(only)] if only else []),
            cwd=tree, env=env, capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"turn in {tree} failed:\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name in runs[1]["ms"]:
        ms = [float(np.mean(r["ms"][name])) if name in r["ms"] else None
              for r in runs]
        row = {"turns": name, "order": ["other", "this", "this", "other"],
               "ms": ms}
        if None not in ms:
            row["this_over_other"] = (ms[1] + ms[2]) / (ms[0] + ms[3])
        yield row
    yield {"picks": [r["picks"] for r in runs]}


# Kernels I and I-uni compile under a launch bound of two blocks of
# kIMaxThreads an SM (128 registers a thread); --i-regcap rebuilds them
# under one block (255), so that the depth that spills at 128 registers
# does not.
I_BOUND = "__launch_bounds__(kIMaxThreads, 2)"
I_BOUND_RELAXED = "__launch_bounds__(kIMaxThreads, 1)"


def i_regcap_tree(dst: str) -> str:
    """Copy this tree's port package to ``dst`` (emptied first) with
    kernels I's and I-uni's launch bound relaxed to :data:`I_BOUND_RELAXED`,
    nothing else changed; returns ``dst``."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(dst, os.path.basename(here))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(here, pkg, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    for name in ("heat_i_tile_temporal.cu", "heat_i_uni_tile_temporal.cu"):
        path = os.path.join(pkg, "csrc", name)
        with open(path) as fp:
            src = fp.read()
        if src.count(I_BOUND) != 1:
            raise RuntimeError(f"{name}: expected one {I_BOUND}")
        with open(path, "w") as fp:
            fp.write(src.replace(I_BOUND, I_BOUND_RELAXED))
    return dst


def i_regcap(dst: str, reps: int):
    """What the spill of I's and I-uni's deepest instance costs: both
    kernels at 16384^2, K = 8, timed in turns (:func:`turns`, events and
    the profiler's device time) against a copy of this tree whose only
    change is the relaxed launch bound (:func:`i_regcap_tree`); then each
    tree's registers, spill bytes and blocks an SM of the K = 8 instance
    (ptxas; the blocks by ``analysis.kernels.blocks_per_sm`` of the
    launch's plan)."""
    from parallel_heat_tpu_torch.analysis import kernels as ak
    from parallel_heat_tpu_torch.analysis import plans as ap

    i_regcap_tree(dst)
    yield from turns(dst, reps, ["I", "I-uni", "I device", "I-uni device"])
    k = params().i_k_default
    relaxed = os.path.join(dst, "parallel_heat_tpu_torch", "build")
    for tree in ("this", "relaxed"):
        for name, uni in (("heat_i_tile_temporal", False),
                          ("heat_i_uni_tile_temporal", True)):
            if tree == "this":
                log = build.build_log(name)
            else:
                # The copy's one build of the kernel, by its turns.
                log = "".join(open(os.path.join(relaxed, f)).read()
                              for f in os.listdir(relaxed)
                              if f.startswith(f"lib{name}-")
                              and f.endswith(".log"))
            row = next(r for r in build.ptxas_report(log)
                       if r["instance"].endswith(f"<{k}>"))
            yield {"i_regcap": name, "tree": tree, "k": k,
                   "registers": row["registers"],
                   "spill_stores": row["spill_stores"],
                   "spill_loads": row["spill_loads"],
                   "blocks_per_sm": ak.blocks_per_sm(
                       ap.plan_i((TURN_PLATE, TURN_PLATE), k, uni),
                       row["registers"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=16384)
    ap.add_argument("--a-sizes", default="256,1000,1859",
                    help="comma-separated plate sizes for kernel A")
    ap.add_argument("--size-3d", type=int, default=512,
                    help="cube edge for kernels D and F")
    ap.add_argument("--only", default="a,b,e,d,f",
                    help="comma-separated kernels to sweep (a, b, e, i, d, "
                         "f, m, mg, g, band, h, hband, hfused)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--sass", default=None, metavar="DIR",
                    help="write each kernel's machine code to DIR")
    ap.add_argument("--turns", default=None, metavar="TREE",
                    help="time the default paths' kernels in TREE (another "
                         "checkout's root) and in this tree, in turns")
    ap.add_argument("--turns-only", default=None, metavar="NAMES",
                    help="with --turns: only these kernels (comma-separated "
                         "names of the turn table: F, F cp.async, D, "
                         "H-fused, H, H band round, H band round device, "
                         "H round defer, H-defer 1024^3 s, E-uni, E, I, "
                         "I-uni, I device, "
                         "I-uni device, G-uni bulk, G band round, "
                         "G band round device, G round overlap, G round "
                         "phase, converge 1000^2 2x4 s, A, M, restrict "
                         "N^2, prolong N^2 and their ' device' rows for N "
                         "in 4098, 512, 9, implicit 512^2 backward_euler "
                         "s, implicit 512^2 crank_nicolson s)")
    ap.add_argument("--i-regcap", default=None, metavar="DIR",
                    help="time I and I-uni in turns against a copy of this "
                         "tree at DIR built under a launch bound of one "
                         "block an SM (255 registers)")
    ap.add_argument("--turn-of", default=None, type=int,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sass-same", default=None, metavar="TREE",
                    help="build every kernel in TREE too and compare their "
                         "machine code with this tree's, function by "
                         "function")
    ap.add_argument("--sass-of", default=None, metavar="LIB",
                    help="with --sass: read only this library (another "
                         "tree's build, lib<kernel>-<digest>.so) instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    turns_only = args.turns_only and args.turns_only.split(",")
    if args.turn_of:
        print(json.dumps(turn_times(args.turn_of, turns_only)), flush=True)
        return 0
    print(card_line(), flush=True)
    if args.turns:
        for row in turns(args.turns, args.reps * 2, turns_only):
            print(json.dumps(row), flush=True)
    if args.i_regcap:
        for row in i_regcap(args.i_regcap, args.reps * 2):
            print(json.dumps(row), flush=True)
    if args.sass_same:
        for row in sass_same(args.sass_same):
            print(json.dumps(row), flush=True)
    if args.sass:
        dump_sass(args.sass, args.sass_of and {
            re.match(r"lib(heat_\w+?)-[0-9a-f]{16}\.so$",
                     os.path.basename(args.sass_of)).group(1): args.sass_of})
    only = set(args.only.split(","))
    rows = []
    if only & {"b", "e"}:
        for row in sweep(args.size, args.reps):
            if {"heat_b_step": "b", "heat_e_temporal": "e",
                    "heat_e_uni_temporal": "e"}[row["kernel"]] not in only:
                continue
            row["size"] = args.size
            rows.append(row)
            print(json.dumps(row), flush=True)
    if "a" in only:
        sizes = [int(x) for x in args.a_sizes.split(",")]
        for row in sweep_a(sizes, args.reps):
            rows.append(row)
            print(json.dumps(row), flush=True)
    if "i" in only:
        for row in sweep_i(args.size, args.reps):
            row["size"] = args.size
            rows.append(row)
            print(json.dumps(row), flush=True)
    if only & {"d", "f"}:
        for row in sweep_3d(args.size_3d, args.reps, only):
            row["size"] = args.size_3d
            rows.append(row)
            print(json.dumps(row), flush=True)
    for key, run in (("m", sweep_m), ("mg", sweep_mg), ("g", sweep_g),
                     ("band", sweep_band), ("h", sweep_h),
                     ("hband", sweep_hband), ("hfused", sweep_hfused)):
        for row in run(args.reps) if key in only else []:
            rows.append(row)
            print(json.dumps(row), flush=True)
    # A row whose "bitwise" is None compares nothing (the band's no-load
    # measurement).
    bad = [r for r in rows if r["bitwise"] is False]
    for key in sorted({(r["kernel"], r["size"], r.get("mode", ""))
                       for r in rows}):
        best = min((r for r in rows
                    if (r["kernel"], r["size"], r.get("mode", "")) == key
                    and r["bitwise"]), key=lambda r: r["ms_per_step"],
                   default=None)
        print(json.dumps({"best": best}), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    if bad:
        print(f"bench_kernels: {len(bad)} launch shapes disagree with the "
              f"plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
