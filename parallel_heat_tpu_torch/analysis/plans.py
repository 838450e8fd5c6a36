"""Launch plans: what each kernel of the port does at one geometry, as
the kernel audit (:mod:`.kernels`) reads it.

The counterpart of ``KernelTarget`` and ``default_kernel_targets`` in
``parallel_heat_tpu/analysis/kernels.py``. JAX traces a ``pallas_call``
to a jaxpr; a CUDA kernel cannot be traced on a machine without a card or
``nvcc``, so each kernel's launch is written down here as a **plan**: one
launch of one ``__global__`` function at one geometry.

A plan holds the grid and thread block, the dynamic and static shared
memory, whether the launch is cooperative, the arrays with their
extents, and, per grid axis, each block's share of the work (an
:class:`Span`): the output cells it writes along that axis and, for each
load, the window it reads (start, extent, and the guard the kernel tests
before a copy; cells outside the guard are zero-filled or skipped). A
block is one span of every axis. For a block that issues asynchronous
copies the plan also gives its **async schedule**: the ordered events of
the C++ loop,

- ``("mbar_init", bar, count)``, ``("expect_tx", bar, bytes)`` (an
  arrival that also expects ``bytes``), ``("arrive", bar)``,
  ``("cp_async_arrive_noinc", bar, n)`` (``n`` threads' arrivals once
  their earlier copies land, counted against the ``init`` count);
- ``("tma", slot, bar, bytes, coords, part)`` (a box: its **whole**
  bytes, zero-filled cells included, complete ``bar``'s transaction;
  ``part`` > 0 is a further piece of the same fill),
  ``("cp_async", slot, bytes)``, ``("commit",)``, ``("wait_prior", n)``;
- ``("wait", bar, parity)`` and ``("read", slot)``.

The geometry comes from the code the wrappers launch with: the picker
and budget functions of ``ops/hopper_params.py`` and the launchers'
helpers (``stencil_kernels_3d.f_geometry``, ``stencil_kernels.a_launch``,
``stencil_kernels_block._block_geometry``,
``stencil_kernels_block_3d._geometry``). Grid dimensions and offsets
that only the C launchers compute are written here in the launchers'
own terms, each beside the source line it mirrors; ``chip_smoke.py``'s
``audit`` phase holds these plans against the card (blocks an SM
against the occupancy exports, and E-uni's and F's loads against a
record variant of the kernels that writes each load down).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# A coordinate the kernel reads at run time (from device memory): no plan
# can say where its window lies.
RUNTIME = "runtime"


@dataclass(frozen=True)
class Array:
    """A global array of float32 (or int32) cells, or with ``elem`` 2 of
    bfloat16 ones: its extent per dimension, outermost first, and the
    alignment of its base address in bytes (PyTorch's allocator gives
    256; a piece cut from a larger tensor may give less)."""

    shape: tuple
    align: int = 256
    elem: int = 4


@dataclass(frozen=True)
class Load:
    """One load of a block, from ``array`` into the shared buffer
    ``slot`` (None for loads into registers, ``kind`` "ld").

    ``kind``: ``"tma"`` (one box a fill), ``"cp16"`` / ``"cp4"``
    (cp.async of 16 or 4 bytes a copy) or ``"ld"`` (plain loads).
    ``dst`` is the float offset of the window's first cell in the slot
    and ``pitch`` the floats between its consecutive cells along each
    outer dimension (the innermost is contiguous). ``streamed`` outer
    dimensions arrive a cell at a time, each into a slot of its own (a
    ring of planes or rows): the slot holds only the inner dimensions.
    ``cell_bytes``: the bytes a cell takes in its slot (2 where a
    bfloat16 box lands as it is; a bfloat16 cell widened as it lands
    takes 4), ``dst`` and ``pitch`` counting such cells.
    ``box`` is a TMA load's box extent per dimension. A ``cp16`` load's
    guarded spans take the kernel's 4-byte branch (zero-filled copies);
    its unguarded ones copy 16 bytes at a time. ``tiled``: the load's
    windows must tile the array as a grid of equal blocks (a BlockSpec's
    input tiling)."""

    kind: str
    array: str
    slot: Optional[str] = None
    dst: int = 0
    pitch: tuple = ()
    streamed: int = 0
    box: tuple = ()
    tiled: bool = False
    cell_bytes: int = 4


@dataclass(frozen=True)
class Span:
    """A block's share of one grid axis (one array dimension): ``write``
    the output cells ``[lo, hi)`` it writes along it (None: none),
    ``reads`` ``{load: (start, extent, guard)}`` with ``guard`` the
    ``(lo, hi)`` the kernel tests before each copy (None: no test, the
    window must lie inside the array; a read of None: the branch that
    issues the load needs this span to lie inside, and it does not), and
    ``kind`` the class the span belongs to (its edge and raggedness)."""

    write: Optional[tuple]
    reads: dict
    kind: tuple = ()


@dataclass
class Axis:
    """One array dimension of the launch's work: ``count`` spans, span
    ``i`` given by ``span(i)``. ``ragged_ok``: the kernel takes a last
    tile cut short along this dimension."""

    name: str
    count: int
    span: Callable[[int], Span]
    ragged_ok: bool = True


@dataclass
class Plan:
    """One launch of one ``__global__`` function at one geometry."""

    kernel: str                 # the __global__ function
    entry: str                  # its entry in kernels.build KERNELS/TOOLS
    label: str                  # what launch this is
    grid: int                   # thread blocks of the launch
    threads: int                # threads a block
    max_threads: int            # the kernel's __launch_bounds__
    dyn_smem: int               # bytes, as the launcher asks
    static_smem: int            # bytes (ptxas)
    arrays: Dict[str, Array]
    output: str
    axes: List[Axis]
    loads: Dict[str, Load] = field(default_factory=dict)
    # name -> (offset, bytes) in the dynamic shared memory after the
    # kernel's own alignment of its buffers (align_slack bytes at most),
    # or (offset, bytes, slack) for a layout aligned otherwise.
    slots: Dict[str, tuple] = field(default_factory=dict)
    align_slack: int = 0
    cooperative: bool = False
    min_blocks_per_sm: int = 1  # what the picker promised
    cover: List[tuple] = field(default_factory=list)
    leave: List[tuple] = field(default_factory=list)
    schedule: Optional[Callable] = None   # (spans) -> [event]
    int32: List[tuple] = field(default_factory=list)  # (what, max value)
    kinds: Optional[dict] = None  # the picker's tile kinds (soundness)
    kinds_of: Optional[Callable] = None   # (spans) -> set of kind names
    limit_bytes: Optional[int] = None     # an injected shared-memory limit
    # Launches whose writes together cover one output once (a round's
    # deferred bulk and its band) share a group.
    group: Optional[str] = None
    # A launch over several blocks' outputs (the batched band kernel):
    # its share of each block, as a plan of that block alone, so that each
    # joins its block's group.
    parts: List["Plan"] = field(default_factory=list)


def _p():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    return params()


def _full(shape):
    return [tuple((0, n) for n in shape)]


def _ceil(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# Schedules (the C++ loops' async events)
# ---------------------------------------------------------------------------

def _sched_cp_once(loads, slot="src"):
    """A load issued by cp.async and committed, waited by
    ``__pipeline_wait_prior(0)`` (``HeatCpAsyncWait``), then read."""
    ev = [("cp_async", slot, b) for b in loads]
    return ev + [("commit",), ("wait_prior", 0), ("read", slot)]


def _sched_tma_once(box_bytes, expect, coords, slot="src", bar="bar"):
    """E-uni's load: one box on one mbarrier (``heat_e_uni.cuh``
    :219-232)."""
    return [("mbar_init", bar, 1), ("expect_tx", bar, expect),
            ("tma", slot, bar, box_bytes, coords, 0), ("wait", bar, 0),
            ("read", slot)]


def _sched_ring_groups(t0, t1, prefetch, slots, fill):
    """A ring of ``slots`` fed ``prefetch`` rows or planes ahead by
    cp.async commit groups, one group an iteration (``heat_temporal3d.cuh``
    heat_t3d_stream). ``fill(slot, t)``
    gives the copies of input ``t``."""
    ev = []
    for i in range(prefetch):
        if t0 + i < t1:
            ev += fill(f"ring{i}", t0 + i)
        ev.append(("commit",))
    cur = 0
    for t in range(t0, t1):
        ev.append(("wait_prior", prefetch - 1))
        prev = slots - 1 if cur == 0 else cur - 1
        if t + prefetch < t1:
            nxt = (cur + prefetch) % slots
            ev += fill(f"ring{nxt}", t + prefetch)
        ev.append(("commit",))
        ev.append(("read", f"ring{cur}"))
        if t > t0:  # at t0 the row before is the garbage cone's
            ev.append(("read", f"ring{prev}"))
        cur = 0 if cur + 1 == slots else cur + 1
    return ev


def _sched_ring_mbar(t0, t1, prefetch, slots, fill, count, groups=False):
    """A ring of ``slots`` with an mbarrier a slot, ``prefetch`` planes
    ahead (``heat_temporal3d.cuh`` HeatFLoop run/plane_step and
    heat_t3d_stream_tma). ``fill(slot, bar, t)`` gives the events of
    input ``t``; with ``groups`` each fill closes a cp.async commit group
    that the loop waits on first (H-fused's x slabs)."""
    ev = [("mbar_init", f"full{i}", count) for i in range(slots)]
    for i in range(prefetch):
        if t0 + i < t1:
            ev += fill(f"ring{i}", f"full{i}", t0 + i)
        if groups:
            ev.append(("commit",))
    cur, lap = 0, 0
    for t in range(t0, t1):
        if groups:
            ev.append(("wait_prior", prefetch - 1))
        ev.append(("wait", f"full{cur}", lap))
        prev = slots - 1 if cur == 0 else cur - 1
        if t + prefetch < t1:
            nxt = (cur + prefetch) % slots
            ev += fill(f"ring{nxt}", f"full{nxt}", t + prefetch)
        if groups:
            ev.append(("commit",))
        ev.append(("read", f"ring{cur}"))
        if t > t0:
            ev.append(("read", f"ring{prev}"))
        cur += 1
        if cur == slots:
            cur, lap = 0, lap ^ 1
    return ev


# ---------------------------------------------------------------------------
# The 2D tile loop: E, E-uni, A, M and the G family
# ---------------------------------------------------------------------------

def _edge_kind(lo, hi, n, write, tile):
    """A span's class along one axis: past the grid's first cell, inside
    the interior's first, past the last, past the interior's last; cut
    short; a last group of fewer than 4 cells."""
    w = 0 if write is None else write[1] - write[0]
    return (lo < 0, lo < 1, hi > n, hi > n - 1, w < tile, w % 4 != 0)


def _loop_kinds(spans):
    """The tile-kind names (``hopper_params.e_tile_kinds`` and
    ``a_tile_kinds``) a block of the tile loop belongs to."""
    (a0, a1, a2, a3, rag_r, _), (b0, b1, b2, b3, rag_c, part) = (
        spans[-2].kind, spans[-1].kind)
    side = {"top": a0, "left": b0, "bottom": a2, "right": b2}
    names = {"tiles"} | {n for n, hit in side.items() if hit}
    names.add("grid_edge" if any(side.values()) else "inside")
    names.add("copies" if (a1 or b1 or a3 or b3) else "interior")
    if rag_r:
        names.add("ragged_rows")
    if rag_c:
        names.add("ragged_cols")
    if part:
        names.add("partial_group")
    return names


# The bytes of a cell in and out of each precision form of E and E-uni
# (stencil_kernels.PRECISION_FORMS, csrc/heat_temporal.cuh kHeatForm*).
_FORM_ELEMS = {0: (2, 2), 1: (2, 2), 2: (2, 4), 3: (4, 2)}


def plan_e(shape, k, uni=False, form=None) -> Plan:
    """Kernel E (``heat_e_temporal``) or E-uni (``heat_e_uni_temporal``)
    at depth ``k`` on an ``(m, n)`` grid, at the tile and thread block
    ``stencil_kernels._temporal`` launches with (``e_tile``,
    ``e_block``); with ``form`` their bfloat16 entry point under that
    precision form (a bfloat16 grid widened as it lands: E by plain
    loads, E-uni by a bfloat16 box into a stage over the second buffer,
    ``csrc/heat_e_uni.cuh`` heat_e_uni_form_tile)."""
    p = _p()
    m, n = shape
    ty, tx = p.e_tile
    block = p.e_block
    e_in, e_out = _FORM_ELEMS.get(form, (4, 4))
    sy, sw = ty + 2 * k, tx + 2 * k
    pad = (4 - k % 4) % 4
    sx = p.row_floats(k, tx)
    # heat_e_geometry (heat_temporal.cuh:483): tiles of the grid.
    n_row, n_col = _ceil(m, ty), _ceil(n, tx)
    load = "box" if uni else "cells"

    def axis(count, t, dim, first):
        def span(i):
            lo = i * t - k                      # gy0 / gx0
            start = lo - (0 if first else pad) if uni else lo
            if uni and e_in == 2 and not first:
                start -= start % 8              # the bfloat16 box's shift
            ext = sy if first else (p.e_box_cols(sx, e_in) if uni else sw)
            write = (i * t, min(i * t + t, dim))
            inside = lo >= 0 and lo + (sy if first else sw) <= dim
            guard = None if (uni or inside) else (0, dim)
            return Span(write, {load: (start, ext, guard)},
                        _edge_kind(lo, lo + (sy if first else sw), dim,
                                   write, t))
        return Axis("rows" if first else "cols", count, span)

    axes = [axis(n_row, ty, m, True), axis(n_col, tx, n, False)]
    buf = sy * sx * 4
    if uni and e_in == 2:
        # heat_e_uni.cuh heat_e_uni_stage_at, heat_e_uni_bar_at.
        sxb = p.e_box_cols(sx, 2)
        stage = -(-sy * sx // 32) * 32 * 4
        bar = p.e_smem_bytes(k, (ty, tx), tma=True, elem=2) - 128 - 8
        loads = {load: Load("tma", "u", "stage", 0, (sxb,), box=(sy, sxb),
                            cell_bytes=2)}
        slots = {"src": (0, buf), "dst": (buf, buf),
                 "stage": (stage, 2 * sy * sxb), "bar": (bar, 8)}
        dyn = p.e_smem_bytes(k, (ty, tx), tma=True, elem=2)

        def schedule(spans):
            (y0, _, _), (x0, _, _) = spans[0].reads[load], \
                spans[1].reads[load]
            return _sched_tma_once(2 * sy * sxb, 2 * sy * sxb, (x0, y0),
                                   slot="stage")
    elif uni:
        loads = {load: Load("tma", "u", "src", 0, (sx,), box=(sy, sx))}
        slots = {"src": (0, buf), "dst": (buf, buf), "bar": (2 * buf, 8)}
        dyn = p.e_smem_bytes(k, (ty, tx), tma=True)

        def schedule(spans):
            (y0, _, _), (x0, _, _) = spans[0].reads[load], \
                spans[1].reads[load]
            return _sched_tma_once(4 * sy * sx, 4 * sy * sx, (x0, y0))
    elif e_in == 2:
        # heat_e_temporal.cu heat_e_load_widen: a plain load a cell, then
        # the block's barrier.
        loads = {load: Load("ld", "u", "src", pad, (sx,))}
        slots = {"src": (0, buf), "dst": (buf, buf)}
        dyn = p.e_smem_bytes(k, (ty, tx))

        def schedule(spans):
            return [("read", "src")]
    else:
        loads = {load: Load("cp4", "u", "src", pad, (sx,))}
        slots = {"src": (0, buf), "dst": (buf, buf)}
        dyn = p.e_smem_bytes(k, (ty, tx))

        def schedule(spans):
            return _sched_cp_once([4 * sy * sw])
    name = "heat_e_uni_temporal" if uni else "heat_e_temporal"
    if form is not None:
        name += "_bf16"
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"{'E-uni' if uni else 'E'} {m}x{n} K={k}"
              + ("" if form is None else f" form {form}"),
        grid=n_row * n_col, threads=block[0] * block[1], max_threads=512,
        dyn_smem=dyn, static_smem=p.static_smem_bytes,
        arrays={"u": Array((m, n), elem=e_in),
                "out": Array((m, n), elem=e_out)}, output="out",
        axes=axes, loads=loads, slots=slots, align_slack=128 if uni else 0,
        min_blocks_per_sm=p.e_min_blocks_per_sm, cover=_full(shape),
        schedule=schedule,
        int32=[("TMA box coordinate", max(m, n))] if uni else [],
        kinds=p.e_tile_kinds(shape, k, (ty, tx)), kinds_of=_loop_kinds)


def _a_axes(m, n, tile, d, batch=None):
    """The tile axes of A's and M's launch (``heat_a.cuh`` heat_a_tile):
    tile ``(i0, j0)`` cut at the grid's edge, its d-deep frame loaded
    cell by cell with zero fill outside the grid."""
    ty, tx = tile

    def axis(count, t, dim, name):
        def span(i):
            lo, hi = i * t, min(i * t + t, dim)
            return Span((lo, hi), {"cells": (lo - d, hi - lo + 2 * d,
                                             (0, dim))},
                        _edge_kind(lo - d, hi + d, dim, (lo, hi), t))
        return Axis(name, count, span)

    axes = [axis(_ceil(m, ty), ty, m, "rows"), axis(_ceil(n, tx), tx, n,
                                                    "cols")]
    if batch is not None:
        axes.insert(0, Axis("members", batch, lambda b: Span(
            (b, b + 1), {"cells": (b, 1, None)})))
    return axes


def _a_kinds(spans):
    names = _loop_kinds(spans)
    (lo_r, hi_r), (lo_c, hi_c) = spans[-2].write, spans[-1].write
    d = spans[-2].reads["cells"][1] - (hi_r - lo_r)
    names.discard("grid_edge")
    names.discard("inside")
    if hi_r - lo_r <= d:
        names.add("whole_band_rows")
    if hi_c - lo_c <= d:
        names.add("whole_band_cols")
    return names


def plan_a(shape, k=20, bf16=False) -> Plan:
    """Kernel A (``heat_a_resident``, or with ``bf16``
    ``heat_a_resident_bf16``, its tile widened as it lands by plain
    loads): one cooperative launch of ``k`` steps at the tile and halo
    depth ``stencil_kernels.a_launch`` gives (the same at both dtypes:
    the shared buffers hold float32)."""
    from parallel_heat_tpu_torch.ops.stencil_kernels import a_launch

    p = _p()
    m, n = shape
    launch = a_launch(shape)
    tile, d, block = launch["tile"], launch["depth"], launch["block"]
    sx = p.row_floats(d, tile[1])
    buf = (tile[0] + 2 * d) * sx * 4
    axes = _a_axes(m, n, tile, d)
    sh = tile[0] + 2 * d
    elem = 2 if bf16 else 4
    return Plan(
        kernel="heat_a_resident_bf16_kernel" if bf16 else
        "heat_a_resident_kernel",
        entry="heat_a_resident_bf16" if bf16 else "heat_a_resident",
        label=f"A {m}x{n} K={k}" + (" bf16" if bf16 else ""),
        grid=axes[0].count * axes[1].count,
        threads=block[0] * block[1], max_threads=512,
        dyn_smem=p.a_smem_bytes(tile, d), static_smem=p.static_smem_bytes,
        arrays={"u": Array((m, n), elem=elem),
                "out": Array((m, n), elem=elem)}, output="out",
        axes=axes, loads={"cells": Load("ld" if bf16 else "cp4", "u", "src",
                                        (4 - d % 4) % 4, (sx,))},
        slots={"src": (0, buf), "dst": (buf, buf)}, cooperative=True,
        cover=_full(shape),
        schedule=(lambda spans: [("read", "src")]) if bf16 else (
            lambda spans: _sched_cp_once([4 * sh * (tile[1] + 2 * d)])),
        # heat_a_launch refuses 2 m n past int32: the exchange planes are
        # indexed (group & 1) * (m * n) + i * n + j in int.
        int32=[("exchange plane index", 2 * m * n - 1)],
        kinds=p.a_tile_kinds(shape, d, tile), kinds_of=_a_kinds)


def plan_m(batch, shape, k, bf16=False) -> Plan:
    """Kernel M (``heat_m_ensemble``, or with ``bf16``
    ``heat_m_ensemble_bf16``, each member's tile widened as it lands by
    plain loads, as A's bfloat16 form does): ``batch`` members of ``(m,
    n)`` under ``hopper_params.m_plan`` (the plan
    ``batched.ensemble_steps`` launches, the same at both dtypes). A group
    of ``tiles`` blocks takes a member a round."""
    p = _p()
    m, n = shape
    mp = p.m_plan(batch, tuple(shape))
    tile, d, block = mp["tile"], mp["depth"], mp["block"]
    groups, tiles = mp["groups"], mp["tiles"]
    sx = p.row_floats(d, tile[1])
    buf = (tile[0] + 2 * d) * sx * 4
    rounds = _ceil(batch, groups)
    sh = tile[0] + 2 * d

    def schedule(spans):
        ev = []
        for _ in range(rounds):
            ev += [("read", "src")] if bf16 else _sched_cp_once(
                [4 * sh * (tile[1] + 2 * d)])
        return ev

    elem = 2 if bf16 else 4
    return Plan(
        kernel="heat_m_ensemble_bf16_kernel" if bf16 else
        "heat_m_ensemble_kernel",
        entry="heat_m_ensemble_bf16" if bf16 else "heat_m_ensemble",
        label=f"M {batch}x{m}x{n} K={k}" + (" bf16" if bf16 else ""),
        grid=groups * tiles,
        threads=block[0] * block[1], max_threads=512,
        dyn_smem=p.m_smem_bytes(tile, d), static_smem=p.static_smem_bytes,
        arrays={"u": Array((batch, m, n), elem=elem),
                "out": Array((batch, m, n), elem=elem)},
        output="out", axes=_a_axes(m, n, tile, d, batch),
        loads={"cells": Load("ld" if bf16 else "cp4", "u", "src",
                             (4 - d % 4) % 4, (m * n, sx))},
        slots={"src": (0, buf), "dst": (buf, buf)},
        cooperative=tiles > 1, cover=_full((batch, m, n)),
        schedule=schedule,
        int32=[("exchange plane index", 2 * m * n - 1)])


# ---------------------------------------------------------------------------
# One-step kernels: B, C, D; the transfer kernels
# ---------------------------------------------------------------------------

def plan_b(shape, bf16=False) -> Plan:
    """Kernel B (``heat_b_step``, or with ``bf16`` ``heat_b_step_bf16``):
    one step, a thread a column of ``b_rows_per_thread`` rows, neighbours
    read from global memory under the kernel's tests (``heat_b_step.cu``
    heat_b_cells)."""
    p = _p()
    m, n = shape
    bx, by = p.b_block
    tr = by * p.b_rows_per_thread

    def axis(count, t, dim, name):
        def span(i):
            lo, hi = i * t, min(i * t + t, dim)
            return Span((lo, hi), {"nbrs": (lo - 1, hi - lo + 2,
                                            (0, dim))})
        return Axis(name, count, span)

    elem = 2 if bf16 else 4
    return Plan(
        kernel="heat_b_step_bf16_kernel" if bf16 else "heat_b_step_kernel",
        entry="heat_b_step_bf16" if bf16 else "heat_b_step",
        label=f"B {m}x{n}" + (" bf16" if bf16 else ""),
        grid=_ceil(m, tr) * _ceil(n, bx),
        threads=bx * by, max_threads=1024, dyn_smem=0,
        static_smem=p.static_smem_bytes,
        arrays={"u": Array((m, n), elem=elem),
                "out": Array((m, n), elem=elem)}, output="out",
        axes=[axis(_ceil(m, tr), tr, m, "rows"),
              axis(_ceil(n, bx), bx, n, "cols")],
        loads={"nbrs": Load("ld", "u")}, cover=_full(shape))


def plan_c(shape, bf16=False) -> Plan:
    """Kernel C (``heat_c_tiled``): one step through tiles staged in
    shared memory with their one-cell ring, cp.async cell by cell with
    zero fill; with ``bf16`` (``heat_c_tiled_bf16``) by plain loads, each
    cell widened as it lands into the same float32 tile, then the block's
    barrier (``heat_c_tiled.cu`` heat_c_cells)."""
    p = _p()
    m, n = shape
    ty, tx = p.c_tile
    bx, by = p.c_block

    def axis(count, t, dim, name):
        def span(i):
            lo, hi = i * t, min(i * t + t, dim)
            return Span((lo, hi), {"cells": (lo - 1, t + 2, (0, dim))})
        return Axis(name, count, span)

    buf = (ty + 2) * (tx + 2) * 4
    elem = 2 if bf16 else 4
    return Plan(
        kernel="heat_c_tiled_bf16_kernel" if bf16 else "heat_c_tiled_kernel",
        entry="heat_c_tiled_bf16" if bf16 else "heat_c_tiled",
        label=f"C {m}x{n}" + (" bf16" if bf16 else ""),
        grid=_ceil(m, ty) * _ceil(n, tx),
        threads=bx * by, max_threads=1024, dyn_smem=buf,
        static_smem=p.static_smem_bytes,
        arrays={"u": Array((m, n), elem=elem),
                "out": Array((m, n), elem=elem)}, output="out",
        axes=[axis(_ceil(m, ty), ty, m, "rows"),
              axis(_ceil(n, tx), tx, n, "cols")],
        loads={"cells": Load("ld" if bf16 else "cp4", "u", "src", 0,
                             (tx + 2,))},
        slots={"src": (0, buf)}, cover=_full(shape),
        schedule=(lambda spans: [("read", "src")]) if bf16 else (
            lambda spans: _sched_cp_once([buf])))


def plan_d(shape, bf16=False) -> Plan:
    """Kernel D (``heat_d_step3d``, or with ``bf16``
    ``heat_d_step3d_bf16``, each cell widened as it is loaded): one
    7-point step, a thread a run of ``d_planes`` X planes of one (y, z)
    column (``heat_d_step3d.cu`` heat_d_cells)."""
    p = _p()
    elem = 2 if bf16 else 4
    nx, ny, nz = shape
    bz, by = p.d_block
    planes = p.d_planes

    def axis(count, t, dim, name):
        def span(i):
            lo, hi = i * t, min(i * t + t, dim)
            return Span((lo, hi), {"nbrs": (lo - 1, hi - lo + 2,
                                            (0, dim))})
        return Axis(name, count, span)

    axes = [axis(_ceil(nx, planes), planes, nx, "x"),
            axis(_ceil(ny, by), by, ny, "y"), axis(_ceil(nz, bz), bz, nz,
                                                   "z")]
    name = "heat_d_step3d_bf16" if bf16 else "heat_d_step3d"
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"D {nx}x{ny}x{nz}" + (" bf16" if bf16 else ""),
        grid=axes[0].count * axes[1].count * axes[2].count,
        threads=bz * by, max_threads=512 if bf16 else 1024, dyn_smem=0,
        static_smem=p.static_smem_bytes,
        arrays={"u": Array(shape, elem=elem),
                "out": Array(shape, elem=elem)}, output="out",
        axes=axes, loads={"nbrs": Load("ld", "u")}, cover=_full(shape))


def _mg_axes(lead, out_shape, block, span, reads_of):
    """The members axis and, per array dimension d (rows, columns), the
    thread blocks along it: block i takes ``block`` threads of ``span``
    output cells each from cell ``i * block * span``, clipped to the
    output; ``reads_of(d, lo, hi)`` is its window of the source."""
    def axis(d, name):
        t = block[1 - d] * span[d]

        def one(i):
            lo, hi = i * t, min(i * t + t, out_shape[d])
            return Span((lo, hi), {"src": reads_of(d, lo, hi)})
        return Axis(name, _ceil(out_shape[d], t), one)

    return [Axis("members", lead, lambda b: Span((b, b + 1),
                                                 {"src": (b, 1, None)})),
            axis(0, "rows"), axis(1, "cols")]


def plan_restrict(fine, coarse, batch=1) -> Plan:
    """``heat_mg_restrict``: a thread ``mg_restrict_cells(coarse)`` (cy,
    cx) coarse cells of a ``mg_restrict_block`` block; coarse cell (i, j)
    reads the 3 x 3 fine cells around fine (2i, 2j), so a thread its
    (2 cy + 1) x (2 cx + 1) window from fine (2 i0 - 1, 2 j0 - 1), its
    rows and columns clamped into the fine array (the guard below); the
    ring is written 0 (``heat_mg_restrict.cu`` :52-98, launcher
    :118-143)."""
    p = _p()
    block, cells = tuple(p.mg_restrict_block), p.mg_restrict_cells(coarse)

    def reads(d, lo, hi):
        return (2 * lo - 1, 2 * (hi - lo) + 1, (0, fine[d]))

    axes = _mg_axes(batch, coarse, block, cells, reads)
    return Plan(
        kernel="heat_mg_restrict_kernel", entry="heat_mg_restrict",
        label=f"restrict {fine[0]}x{fine[1]} -> {coarse[0]}x{coarse[1]}"
              + (f" x{batch}" if batch > 1 else ""),
        grid=batch * axes[1].count * axes[2].count,
        threads=block[0] * block[1], max_threads=1024,
        dyn_smem=0, static_smem=0,
        arrays={"src": Array((batch,) + tuple(fine)),
                "out": Array((batch,) + tuple(coarse))},
        output="out", axes=axes, loads={"src": Load("ld", "src")},
        cover=_full((batch,) + tuple(coarse)),
        int32=[("thread's first coarse row i0", axes[1].count * block[1]
                * cells[0]),
               ("thread's first coarse column j0", axes[2].count * block[0]
                * cells[1]),
               ("fine row 2 i0 + 2 cy - 1", 2 * (coarse[0] - 1)
                + 2 * cells[0] - 1),
               ("fine column 2 j0 + 2 cx - 1", 2 * (coarse[1] - 1)
                + 2 * cells[1] - 1)])


def plan_prolong(coarse, fine, batch=1) -> Plan:
    """``heat_mg_prolong``: a thread a coarse full cell (t, s) of a
    ``mg_prolong_block`` block, writing fine rows 2t, 2t + 1 and columns
    2s, 2s + 1 clipped to the fine array; it reads coarse rows t, t + 1
    and columns s, s + 1, the second clamped to the coarse ring (the
    guard below) (``heat_mg_prolong.cu`` :57-103, launcher
    :111-140)."""
    p = _p()
    block = tuple(p.mg_prolong_block)

    def reads(d, lo, hi):
        # Fine cells [lo, hi) come from the threads t = lo / 2 ..
        # (hi - 1) / 2, which read coarse lines t .. t + 1.
        return (lo // 2, (hi - 1) // 2 - lo // 2 + 2, (0, coarse[d]))

    axes = _mg_axes(batch, fine, block, (2, 2), reads)
    return Plan(
        kernel="heat_mg_prolong_kernel", entry="heat_mg_prolong",
        label=f"prolong {coarse[0]}x{coarse[1]} -> {fine[0]}x{fine[1]}"
              + (f" x{batch}" if batch > 1 else ""),
        grid=batch * axes[1].count * axes[2].count,
        threads=block[0] * block[1], max_threads=1024,
        dyn_smem=0, static_smem=0,
        arrays={"src": Array((batch,) + tuple(coarse)),
                "out": Array((batch,) + tuple(fine))},
        output="out", axes=axes, loads={"src": Load("ld", "src")},
        cover=_full((batch,) + tuple(fine)),
        int32=[("fine row 2t + 1", 2 * axes[1].count * block[1] - 1),
               ("fine column 2s + 1", 2 * axes[2].count * block[0] - 1)])


# ---------------------------------------------------------------------------
# I and I-uni: column bands streamed down the grid
# ---------------------------------------------------------------------------

def _sched_stages(n_stages, stages, fill, count):
    """A warp's ring of ``stages`` stages, an mbarrier each, filled ahead;
    a stage is refilled a few rows into the next one, once its last row
    has been read for the last time (``heat_i_loop.cuh`` HeatIBand::run
    and level0). ``fill(slot, bar, q)`` gives the events of stage ``q``."""
    ev = [("mbar_init", f"full{i}", count) for i in range(stages)]
    for q in range(min(stages, n_stages)):
        ev += fill(f"ring{q}", f"full{q}", q)
    for q in range(n_stages):
        slot = q % stages
        ev.append(("wait", f"full{slot}", (q // stages) & 1))
        ev.append(("read", f"ring{slot}"))
        if q > 0 and q - 1 + stages < n_stages:
            prev = (q - 1) % stages
            ev += fill(f"ring{prev}", f"full{prev}", q - 1 + stages)
    return ev


def plan_i(shape, k, uni=False, form=None) -> Plan:
    """Kernel I (``heat_i_tile_temporal``) or I-uni at depth ``k`` on an
    ``(m, n)`` grid, at ``i_launch``'s segments and the ``i_*`` defaults
    (``heat_i_loop.cuh``). A warp streams one band of 128 columns, so a
    span along the columns is one warp's band; a block holds ``i_warps``
    of them side by side, each warp on its own ring of ``i_stages``
    stages of ``i_rows`` rows with an mbarrier a stage (the slots here
    are the block's last warp's, the highest offsets). I-uni fills a
    stage with one TMA box of rows x 128 floats from a 2D map of the
    grid (``expect_tx`` by one lane); I with each lane's own copies,
    every copy tested against the grid (a 16-byte copy where the lane's
    cells lie inside on a 16-byte boundary, a run-time choice; else 4
    bytes a cell, zero-filled), and every lane's
    ``cp.async.mbarrier.arrive.noinc``. With ``form`` their bfloat16
    entry point under that precision form: a bfloat16 input's ring holds
    2-byte cells, rows of 136 from the band's first cell rounded down to
    8 (``i_row_cells``, stages on 128 bytes), filled by I-uni's bfloat16
    box of rows x 136 from that cell, by I's 8-byte copies where a lane's
    cells lie inside on 8 bytes and its plain 2-byte loads elsewhere
    (every load tested against the grid); form 3's float32 level takes
    the float32 ring."""
    p = _p()
    m, n = shape
    tile_x, seg = p.i_launch(tuple(shape), k)
    pad = p.i_pad(k)
    warps, rows, stages = p.i_warps, p.i_rows, p.i_stages
    e_in, e_out = _FORM_ELEMS.get(form, (4, 4))
    cols = p.i_row_cells(e_in)
    n_bands, n_seg = _ceil(n, tile_x), _ceil(m, seg)
    stage_bytes = p.i_stage_bytes(rows, e_in)
    box_bytes = rows * cols * e_in

    def n_stages(r0, r1):
        return _ceil((r1 - r0) + 2 * k, rows)

    def segs(i):
        r0, r1 = i * seg, min(i * seg + seg, m)
        ext = n_stages(r0, r1) * rows
        return Span((r0, r1), {"row": (r0 - k, ext, None if uni
                                       else (0, m))},
                    (r1 - r0, r0 - k < 1, r0 + ext - k > m - 1))

    # heat_i_loop.cuh shift(): a bfloat16 ring row starts at the band's
    # first cell rounded down to 16 bytes, 0 or 4 cells left of it (-pad
    # modulo 8, the same for every band: tile_x is a multiple of 8). The
    # box reads the whole row from there; I's lanes read their band's
    # 128 cells into it from the shift on.
    shift = -pad % 8 if e_in == 2 else 0

    def bands(b):
        gx0 = b * tile_x - pad
        write = (b * tile_x, min(b * tile_x + tile_x, n))
        read = (gx0 - shift, cols, None) if uni else (gx0, 128, (0, n))
        return Span(write, {"row": read},
                    (gx0 < 1, gx0 + 128 > n - 1,
                     write[1] - write[0] < tile_x))

    def schedule(spans):
        r0, r1 = spans[0].write
        x0 = spans[1].reads["row"][0]
        if uni:
            def fill(slot, bar, q):
                return [("expect_tx", bar, box_bytes),
                        ("tma", slot, bar, box_bytes,
                         (x0, r0 - k + q * rows), 0)]
            count = 1
        else:
            def fill(slot, bar, q):
                return [("cp_async", slot, box_bytes,
                         (x0, r0 - k + q * rows)),
                        ("cp_async_arrive_noinc", bar, 32)]
            count = 32
        return _sched_stages(n_stages(r0, r1), stages, fill, count)

    last = (warps - 1) * stages * stage_bytes
    slot_map = {f"ring{i}": (last + i * stage_bytes, stage_bytes)
                for i in range(stages)}
    slot_map["bars"] = (warps * stages * stage_bytes + 8 * (warps - 1)
                        * stages, 8 * stages)
    name = "heat_i_uni_tile_temporal" if uni else "heat_i_tile_temporal"
    if form is not None:
        name += "_bf16"
    if uni:
        kind = "tma"
    else:
        kind = "ld" if e_in == 2 else "cp4"
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"{'I-uni' if uni else 'I'} {m}x{n} K={k}"
              + ("" if form is None else f" form {form}"),
        grid=_ceil(n_bands, warps) * n_seg, threads=32 * warps,
        max_threads=256,
        dyn_smem=p.i_smem_bytes(warps, rows, stages, e_in),
        static_smem=0,
        arrays={"u": Array((m, n), elem=e_in),
                "out": Array((m, n), elem=e_out)}, output="out",
        axes=[Axis("segments", n_seg, segs), Axis("bands", n_bands, bands)],
        loads={"row": Load(kind, "u", "ring", 0 if uni else shift, (cols,),
                           streamed=0 if uni else 1,
                           box=(rows, cols) if uni else (),
                           cell_bytes=e_in)},
        slots=slot_map, align_slack=128,
        min_blocks_per_sm=p.i_blocks_per_sm, cover=_full(shape),
        schedule=schedule,
        int32=[("row or column in the loop (and I-uni's box coordinate)",
                max(m, n) + 256)])


# ---------------------------------------------------------------------------
# F: the 3D plane loop
# ---------------------------------------------------------------------------

def _f_kinds(spans):
    _, sy, sz = spans
    a = sy.kind
    b = sz.kind
    names = {"tiles", "edge" if (a[1] or a[3] or b[1] or b[3])
             else "interior"}
    for name, hit in (("top", a[0]), ("left", b[0]), ("bottom", a[2]),
                      ("right", b[2]), ("ragged_y", a[4]),
                      ("ragged_z", b[4]), ("partial_group", b[5])):
        if hit:
            names.add(name)
    return names


def plan_f(shape, k, load="tma", bf16=False) -> Plan:
    """Kernel F (``heat_f_temporal3d``, or with ``bf16``
    ``heat_f_temporal3d_bf16``) at depth ``k`` on an ``(X, Y, Z)`` grid
    under ``load`` ("tma" or "cp.async"), at the launch
    ``stencil_kernels_3d.f_geometry`` gives (``heat_f_block.inc``,
    ``heat_temporal3d.cuh`` HeatFLoop). A bfloat16 ring holds 2-byte
    cells, its tile's halo along Z is 8 cells (``f_pad``), and it fills by
    a bfloat16 box or by each lane's 8-byte copies where its cells lie
    inside on 8 bytes, plain 2-byte loads elsewhere (every load tested
    against the grid); the level buffers stay float32."""
    from parallel_heat_tpu_torch.ops.stencil_kernels_3d import f_geometry

    p = _p()
    nx, ny, nz = shape
    elem = 2 if bf16 else 4
    block, rows, prefetch, seg = f_geometry(shape, k,
                                            "bfloat16" if bf16 else
                                            "float32")
    warps = block[1]
    wy, wz = p.f_extent(block, rows)
    P = p.f_pad(k, elem)
    ty_out, tz_out = wy - 2 * k, wz - 2 * P
    tiles_y, tiles_z = _ceil(ny, ty_out), _ceil(nz, tz_out)
    n_seg = _ceil(nx, seg)
    slots = prefetch + 2
    slot_f = (wy + 2) * wz
    box_bytes = elem * wz * wy
    threads = 32 * warps
    tma = load == "tma"

    def xs(i):
        x0, x1 = i * seg, min(i * seg + seg, nx)
        return Span((x0, x1), {"plane": (x0 - k, x1 - x0 + 2 * k, (0, nx))},
                    (x1 - x0,))

    def ys(i):
        y0 = i * ty_out - k
        write = (y0 + k, min(y0 + wy - k, ny))
        return Span(write, {"plane": (y0, wy, None if tma else (0, ny))},
                    _edge_kind(y0, y0 + wy, ny, write, ty_out))

    def zs(i):
        z0 = i * tz_out - P
        write = (z0 + P, min(z0 + wz - P, nz))
        return Span(write, {"plane": (z0, wz, None if tma else (0, nz))},
                    _edge_kind(z0, z0 + wz, nz, write, tz_out))

    def schedule(spans):
        x0, x1 = spans[0].write
        y0 = spans[1].reads["plane"][0]
        z0 = spans[2].reads["plane"][0]
        if tma:
            def fill(slot, bar, t):
                return [("expect_tx", bar, box_bytes),
                        ("tma", slot, bar, box_bytes, (z0, y0, t), 0)]
            count = 1
        else:
            def fill(slot, bar, t):
                return [("cp_async", slot, box_bytes, (z0, y0, t)),
                        ("cp_async_arrive_noinc", bar, threads)]
            count = threads
        return _sched_ring_mbar(x0 - k, x1 + k, prefetch, slots, fill,
                                count)

    edge = (min(rows, 2) * warps + 2) * wz
    slot_map = {f"ring{i}": (elem * i * slot_f, elem * slot_f)
                for i in range(slots)}
    slot_map["levels"] = (elem * slots * slot_f, 4 * 2 * (k - 1) * edge)
    slot_map["bars"] = (elem * slots * slot_f + 4 * 2 * (k - 1) * edge,
                        8 * slots)
    name = "heat_f_temporal3d_bf16" if bf16 else "heat_f_temporal3d"
    kind = "tma" if tma else "ld" if bf16 else "cp4"
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"F {nx}x{ny}x{nz} K={k} {load}" + (" bf16" if bf16 else ""),
        grid=n_seg * tiles_y * tiles_z, threads=threads,
        max_threads=32 * p.f_max_warps(rows, k, elem),
        dyn_smem=p.f_smem_bytes(k, block, rows, prefetch, elem),
        static_smem=p.static_smem_bytes,
        arrays={"u": Array(shape, elem=elem),
                "out": Array(shape, elem=elem)}, output="out",
        axes=[Axis("x", n_seg, xs), Axis("y", tiles_y, ys),
              Axis("z", tiles_z, zs)],
        loads={"plane": Load(kind, "u", "ring", wz, (0, wz), streamed=1,
                             box=(1, wy, wz), cell_bytes=elem)},
        slots=slot_map, align_slack=128, cover=_full(shape),
        schedule=schedule,
        int32=[("TMA box coordinate", max(nx, ny, nz))],
        kinds=p.f_tile_kinds(shape, k, block, rows, elem),
        kinds_of=_f_kinds)


# ---------------------------------------------------------------------------
# The sharded 2D block kernels (heat_g.cuh)
# ---------------------------------------------------------------------------

G_KERNELS = {"G": "heat_g_block_padded", "G-circ": "heat_g_block_circular",
             "G-fuse": "heat_g_block_fused", "G-uni": "heat_g_block_uniform",
             "band": "heat_g_band_fix"}


def plan_g(kind, block_shape, k, origin=(0, 0), grid_shape=None,
           defer=False, bf16=False) -> Plan:
    """A G kernel (``kind`` of :data:`G_KERNELS`) on a ``(bx, by)`` block
    at ``origin`` of a grid: monolithic, the deferred bulk (``defer``,
    rows ``[k, bx - k)``), or the band kernel on this block alone (rows
    ``[0, k)`` and ``[bx - k, bx)``; :func:`plan_g_band` with one entry).
    Loads are in frame coordinates, the block's cells shifted by ``k``
    (the layout of the pieces, ``heat_g_src``, maps the frame onto them);
    a tile inside the block under G-uni copies its core columns 16 bytes
    at a time from ``u``. With ``bf16`` the bfloat16 form
    (``<kernel>_bf16``, heat_g.cuh heat_g_tile_bf16): the frame by plain
    loads, each cell widened as it lands; G-uni's core columns (and the
    band's row load) 16 bytes at a time into a stage over the second
    buffer, widened after their wait."""
    if kind == "band":
        return plan_g_band(block_shape, k, [origin], grid_shape, bf16)
    return _plan_g_block(kind, block_shape, k, origin, grid_shape, defer,
                         bf16=bf16)


def _guards(block_shape, k, origin, grid_shape):
    """The row and column guards (frame coordinates) of a block's loads:
    the cells that lie in the grid."""
    (bx, by), (gm, gn) = block_shape, grid_shape
    return ((max(0, k - origin[0]), min(bx + 2 * k, gm - origin[0] + k)),
            (max(0, k - origin[1]), min(by + 2 * k, gn - origin[1] + k)))


def plan_g_band(block_shape, k, origins, grid_shape=None,
                bf16=False) -> Plan:
    """The band kernel's launch over a round's blocks of ``block_shape``
    at ``origins`` (``heat_g_band_fix.cu``: one table entry a block, the
    grid (column tiles, 2 regions, blocks)): a ``blocks`` axis over the
    entries ahead of each block's rows and columns, every entry's two
    regions at its origin. One plan of the launch holds the guards of all
    its entries (along each axis the loosest: a window must lie in its
    array wherever the kernel copies); its :attr:`~Plan.parts` are each
    entry's share as a plan of that block, so that each joins its
    block's deferred bulk in the coverage check. ``bf16``: the bfloat16
    launch (``heat_g_band_fix_bf16``), as :func:`plan_g`."""
    bx, by = block_shape
    grid_shape = grid_shape or block_shape
    n = len(origins)
    guards = [_guards(block_shape, k, o, grid_shape) for o in origins]
    loose = tuple((min(g[d][0] for g in guards), max(g[d][1] for g in guards))
                  for d in range(2))
    base = _plan_g_block("band", block_shape, k, origins[0], grid_shape,
                         guards=loose, bf16=bf16)
    parts = [_plan_g_block("band", block_shape, k, o, grid_shape, bf16=bf16)
             for o in origins]

    def entry(i):
        return Span((i, i + 1), {name: (i, 1, None) for name in base.loads},
                    ())

    return dataclasses.replace(
        base, label=f"band {bx}x{by} x{n} blocks at {tuple(origins[0])}.. "
                    f"K={k}" + (" bf16" if bf16 else ""),
        grid=n * base.grid,
        arrays={name: Array((n,) + a.shape) for name, a in
                base.arrays.items()},
        axes=[Axis("blocks", n, entry)] + base.axes,
        loads={name: dataclasses.replace(load, pitch=(0,) + load.pitch)
               for name, load in base.loads.items()},
        cover=[((0, n),) + rect for rect in base.cover],
        leave=[((0, n),) + rect for rect in base.leave],
        schedule=lambda spans: base.schedule(spans[1:]),
        group=None, parts=parts)


def _plan_g_block(kind, block_shape, k, origin=(0, 0), grid_shape=None,
                  defer=False, guards=None, bf16=False) -> Plan:
    """:func:`plan_g` on one block; ``guards`` overrides the loads' row
    and column guards (:func:`_guards` of ``origin``)."""
    from parallel_heat_tpu_torch.ops.stencil_kernels_block import (
        _block_geometry)

    p = _p()
    bx, by = block_shape
    gm, gn = grid_shape or block_shape
    band = kind == "band"
    if band:
        ty, tx = k, p.g_band_tile_x
        block = p.g_band_block
        regions = [(0, k), (bx - k, k)]      # heat_g_band_fix.cu
    else:
        ty, tx, *block = _block_geometry()
        regions = [(k, bx - 2 * k)] if defer else [(0, bx)]
    sy, sw = ty + 2 * k, tx + 2 * k
    pad = (4 - k % 4) % 4
    sx = p.row_floats(k, tx)
    uni = kind == "G-uni"
    # The band's row load (heat_g_band_rows): each window row's core
    # columns inside the block, 16 bytes at a time, from the piece that
    # holds the row ("pieces": frame rows by the halos' row of by + 2k
    # floats, the core at column 0 of each piece's row).
    elem = 2 if bf16 else 4
    rowload = (band and p.g_band_row_load(block_shape, k, elem)
               and tx % (16 // elem) == 0)
    n_col = _ceil(by, tx)
    rtiles = [(begin + i * ty, begin + rows)
              for begin, rows in regions for i in range(_ceil(rows, ty))]
    row_guard, col_guard = guards or _guards(block_shape, k, origin,
                                             (gm, gn))

    def inside_r(r0):
        return r0 - k >= 0 and r0 - k + sy <= bx

    def inside_c(c0):
        return c0 - k >= 0 and c0 - k + sw <= by

    def rows_span(i):
        r0, end = rtiles[i]
        write = (r0, min(r0 + ty, end))
        reads = {"frame": (r0, sy, None if inside_r(r0) else row_guard),
                 "core": (r0 - k, sy, None) if inside_r(r0) else None}
        if rowload:
            reads["rows"] = (r0, sy, None)
        return Span(write, reads, (inside_r(r0), write[1] - write[0] < ty))

    def cols_span(j):
        c0 = j * tx
        write = (c0, min(c0 + tx, by))
        reads = {"frame": (c0, sw, None if inside_c(c0) else col_guard),
                 "core": (c0, tx, None) if inside_c(c0) else None}
        if rowload:
            reads["rows"] = (c0, write[1] - write[0], None)
        return Span(write, reads,
                    (inside_c(c0), (write[1] - write[0]) % 4 != 0))

    def schedule(spans):
        inside = spans[0].kind[0] and spans[1].kind[0]
        core = spans[1].write[1] - spans[1].write[0]
        if bf16:
            # Plain widening loads into src; the staged 16-byte copies
            # into the stage, waited and widened into src.
            staged = (2 * sy * tx if uni and inside
                      else 2 * sy * (core - core % 8) if rowload else 0)
            if not staged:
                return [("read", "src")]
            return _sched_cp_once([staged], slot="stage") + [("read", "src")]
        if uni and inside:
            return _sched_cp_once([4 * sy * tx, 4 * sy * 2 * k])
        if rowload:
            return _sched_cp_once([4 * sy * core, 4 * sy * (sw - core)])
        return _sched_cp_once([4 * sy * sw])

    buf = sy * sx * 4
    arrays = {"frame": Array((bx + 2 * k, by + 2 * k), elem=elem),
              "u": Array((bx, by), elem=elem),
              "out": Array((bx, by), elem=elem)}
    slots = {"src": (0, buf), "dst": (buf, buf)}
    if bf16:
        loads = {"frame": Load("ld", "frame", "src", pad, (sx,))}
        if uni or rowload:
            # heat_g_tile_bf16 / heat_g_band_rows_bf16: rows of tx cells
            # from the second buffer's start.
            slots["stage"] = (buf, 2 * sy * tx)
        if uni:
            loads["core"] = Load("cp16", "u", "stage", 0, (tx,),
                                 cell_bytes=2)
        if rowload:
            loads["rows"] = Load("cp16", "pieces", "stage", 0, (tx,),
                                 cell_bytes=2)
    else:
        loads = {"frame": Load("cp4", "frame", "src", pad, (sx,))}
        if uni:
            loads["core"] = Load("cp16", "u", "src", pad + k, (sx,))
        if rowload:
            loads["rows"] = Load("cp16", "pieces", "src", pad + k, (sx,))
    if rowload:
        arrays["pieces"] = Array((bx + 2 * k, by + 2 * k), elem=elem)
    if band:
        cover = [((0, k), (0, by)), ((bx - k, bx), (0, by))]
        leave = [((k, bx - k), (0, by))]
    elif defer:
        cover, leave = [((k, bx - k), (0, by))], [((0, k), (0, by)),
                                                   ((bx - k, bx), (0, by))]
    else:
        cover, leave = _full(block_shape), []
    name = G_KERNELS[kind] + ("_bf16" if bf16 else "")
    what = "band" if band else (kind + (" deferred bulk" if defer else ""))
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"{what} {bx}x{by} at {tuple(origin)} K={k}"
              + (" bf16" if bf16 else ""),
        grid=len(rtiles) * n_col, threads=block[0] * block[1],
        max_threads=512, dyn_smem=p.g_smem_bytes(k, (ty, tx)),
        static_smem=p.static_smem_bytes,
        arrays=arrays, output="out",
        axes=[Axis("rows", len(rtiles), rows_span),
              Axis("cols", n_col, cols_span)],
        loads=loads, slots=slots,
        min_blocks_per_sm=p.e_min_blocks_per_sm, cover=cover, leave=leave,
        schedule=schedule,
        group=(f"G {bx}x{by} at {tuple(origin)} K={k}"
               + (" bf16" if bf16 else "") if band or defer else None))


# ---------------------------------------------------------------------------
# The sharded 3D block kernels (heat_h.cuh)
# ---------------------------------------------------------------------------

H_KERNELS = {"H-fuse": "heat_h_block_3d_fused"}


def _hc_kinds(spans):
    _, sy, sz = spans
    a, b = sy.kind, sz.kind
    names = {"tiles", "edge" if (a[1] or a[3] or b[1] or b[3])
             else "interior", "boxed" if a[6] and b[6] else "wrapped"}
    for name, hit in (("top", a[0]), ("left", b[0]), ("bottom", a[2]),
                      ("right", b[2]), ("ragged_y", a[4]),
                      ("ragged_z", b[4]), ("partial_group", b[5])):
        if hit:
            names.add(name)
    return names


def plan_hc(block_shape, k, origin=(0, 0, 0), grid_shape=None,
            load="tma", bf16=False) -> Plan:
    """Kernel H (``heat_h_block_3d``, F's plane loop on the assembled
    circular block) on a ``(bx, by, bz)`` block at ``origin`` under
    ``load``: with "tma" the block's rows padded to a multiple of 4
    floats (``DeepExchange3D.new_circular``) and the tiles that need no
    lo cell taking one box a plane of the circular block's tensor map
    (coordinates in the block, plane t + hx); the others, and every tile
    under "cp.async", a 4-byte cp.async a cell, written here in frame
    coordinates (the circular block's cells in the padded ``[lo | u |
    hi]`` order, guarded by the K-deep frame), as ``hc_launch`` launches
    it (``csrc/heat_h_block_3d.cu``). With ``bf16`` the bfloat16 form
    (``heat_h_block_3d_bf16``): a ring of 2-byte cells, a halo of 8 cells
    along Z, rows padded to 8 cells, bfloat16 boxes, and the wrapped
    tiles' 8-byte copies or plain 2-byte loads (each tested against the
    frame), as F's bfloat16 form."""
    p = _p()
    elem = 2 if bf16 else 4
    bx, by, bz = block_shape
    grid_shape = grid_shape or block_shape
    halos = tuple(k if b < n else 0 for b, n in zip(block_shape, grid_shape))
    hx, hy, hz = halos
    block, rows, prefetch, seg = p.hc_launch(block_shape, k, elem=elem)
    warps = block[1]
    wy, wz = p.f_extent(block, rows)
    P = p.f_pad(k, elem)
    ty_out, tz_out = wy - 2 * k, wz - 2 * P
    tiles_y, tiles_z = _ceil(by, ty_out), _ceil(bz, tz_out)
    n_seg = _ceil(bx, seg)
    ext_x, ye, ze = bx + 2 * hx, by + 2 * hy, bz + 2 * hz
    pitch = p.hc_pitch(ze, elem) if load == "tma" else ze
    slots = prefetch + 2
    slot_f = (wy + 2) * wz
    box_bytes = elem * wz * wy
    threads = 32 * warps
    tma = load == "tma"
    oy, oz = origin[1], origin[2]
    ny, nz = grid_shape[1], grid_shape[2]

    def xs(i):
        x0, x1 = i * seg, min(i * seg + seg, bx)
        win = (x0 - k + hx, x1 - x0 + 2 * k)
        return Span((x0, x1), {"box": win + (None,),
                               "plane": win + ((0, ext_x),)}, (x1 - x0,))

    def ys(i):
        y0 = i * ty_out - k
        write = (y0 + k, min(y0 + wy - k, by))
        kind = _edge_kind(oy + y0, oy + y0 + wy, ny, (oy + write[0],
                          oy + write[1]), ty_out)
        kind = (y0 < 0, kind[1], y0 + wy > by, kind[3],
                write[1] - write[0] < ty_out,
                (write[1] - write[0]) % 4 != 0, y0 >= 0 or not hy)
        return Span(write, {"box": (y0, wy, None),
                            "plane": (y0 + hy, wy, (0, ye))}, kind)

    def zs(i):
        z0 = i * tz_out - P
        write = (z0 + P, min(z0 + wz - P, bz))
        kind = _edge_kind(oz + z0, oz + z0 + wz, nz, (oz + write[0],
                          oz + write[1]), tz_out)
        kind = (z0 < 0, kind[1], z0 + wz > bz, kind[3],
                write[1] - write[0] < tz_out,
                (write[1] - write[0]) % 4 != 0, z0 >= 0 or not hz)
        return Span(write, {"box": (z0, wz, None),
                            "plane": (z0 + hz, wz, (0, ze))}, kind)

    def schedule(spans):
        x0, x1 = spans[0].write
        y0 = spans[1].reads["box"][0]
        z0 = spans[2].reads["box"][0]
        if tma and spans[1].kind[6] and spans[2].kind[6]:
            def fill(slot, bar, t):
                return [("expect_tx", bar, box_bytes),
                        ("tma", slot, bar, box_bytes, (z0, y0, t + hx), 0)]
            count = 1
        else:
            def fill(slot, bar, t):
                return [("cp_async", slot, box_bytes, (z0, y0, t + hx)),
                        ("cp_async_arrive_noinc", bar, threads)]
            count = threads
        return _sched_ring_mbar(x0 - k, x1 + k, prefetch, slots, fill,
                                count)

    edge = (min(rows, 2) * warps + 2) * wz
    slot_map = {f"ring{i}": (elem * i * slot_f, elem * slot_f)
                for i in range(slots)}
    slot_map["levels"] = (elem * slots * slot_f, 4 * 2 * (k - 1) * edge)
    slot_map["bars"] = (elem * slots * slot_f + 4 * 2 * (k - 1) * edge,
                        8 * slots)
    loads = {"plane": Load("ld" if bf16 else "cp4", "frame", "ring", wz,
                           (0, wz), streamed=1, cell_bytes=elem)}
    if tma:
        loads["box"] = Load("tma", "ext", "ring", wz, (0, wz), streamed=1,
                            box=(1, wy, wz), cell_bytes=elem)
    name = "heat_h_block_3d_bf16" if bf16 else "heat_h_block_3d"
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"H {bx}x{by}x{bz} at {tuple(origin)} K={k} {load}"
              + (" bf16" if bf16 else ""),
        grid=n_seg * tiles_y * tiles_z, threads=threads,
        max_threads=32 * p.f_max_warps(rows, k, elem),
        dyn_smem=p.f_smem_bytes(k, block, rows, prefetch, elem),
        static_smem=p.static_smem_bytes,
        arrays={"ext": Array((ext_x, ye, pitch), elem=elem),
                "frame": Array((ext_x, ye, ze), elem=elem),
                "out": Array(block_shape, elem=elem)},
        output="out",
        axes=[Axis("x", n_seg, xs), Axis("y", tiles_y, ys),
              Axis("z", tiles_z, zs)],
        loads=loads, slots=slot_map, align_slack=128,
        cover=_full(block_shape), schedule=schedule,
        # The TMA coordinates and each row's offset are int32
        # (heat_h_block_3d.cu); the launcher refuses ye * pitch past it.
        int32=[("TMA box coordinate", max(ext_x, ye, ze)),
               ("row offset yc * pitch + zc", ye * pitch)],
        kinds=p.hc_tile_kinds(block_shape, k, halos, origin, grid_shape,
                              tma, block, rows, elem),
        kinds_of=_hc_kinds)


def plan_h(kind, block_shape, k, origin=(0, 0, 0), grid_shape=None,
           defer=False, load="cp.async", bf16=False) -> Plan:
    """An H-fused-family kernel (``kind`` of :data:`H_KERNELS`) on a
    ``(bx, by, bz)`` block at ``origin``: monolithic or H-fused's deferred
    bulk (``defer``, planes ``[k, bx - k)``), at the launch
    ``stencil_kernels_block_3d._geometry`` gives. Tiles inside the block
    load each plane as a TMA box under ``load="tma"`` (H-fused only), the
    x slabs' planes by cp.async; elsewhere the per-cell cp.async ring
    (``heat_t3d_stream``). Loads are in frame coordinates, the block's
    cells shifted by ``k``. With ``bf16`` the bfloat16 form
    (``heat_h_block_3d_fused_bf16``, ``load="plain"``): every tile by
    plain 2-byte loads widened into the float32 ring, no copy in
    flight."""
    from parallel_heat_tpu_torch.ops.stencil_kernels_block_3d import (
        _geometry)

    p = _p()
    bx, by, bz = block_shape
    grid_shape = grid_shape or block_shape
    tma = load == "tma"
    elem = 2 if bf16 else 4
    planes = bx - 2 * k if defer else bx
    bzt, byt, rows, seg = _geometry(block_shape, k, planes)
    regions = [(k, bx - 2 * k)] if defer else [(0, bx)]
    wy, wz = byt * rows, bzt
    ty_out, tz_out = wy - 2 * k, wz - 2 * k
    tiles_y, tiles_z = _ceil(by, ty_out), _ceil(bz, tz_out)
    xsegs = [(begin + i * seg, min(begin + i * seg + seg, begin + n))
             for begin, n in regions for i in range(_ceil(n, seg))]
    g = [(max(0, k - o), min(b + 2 * k, n - o + k))
         for o, b, n in zip(origin, block_shape, grid_shape)]

    def inside(lo, w, b):
        return lo >= 0 and lo + w <= b

    def xs(i):
        x0, x1 = xsegs[i]
        return Span((x0, x1), {"plane": (x0, x1 - x0 + 2 * k, g[0])},
                    (x1 - x0,))

    def ys(i):
        lo = i * ty_out - k
        write = (lo + k, min(lo + wy - k, by))
        return Span(write, {"plane": (lo + k, wy, g[1])},
                    (inside(lo, wy, by),))

    def zs(i):
        lo = i * tz_out - k
        write = (lo + k, min(lo + wz - k, bz))
        return Span(write, {"plane": (lo + k, wz, g[2])},
                    (inside(lo, wz, bz),))

    tma_ps = _tma_plane(wy, wz)
    box_bytes = 4 * wy * (wz + 4)

    def schedule(spans):
        x0, x1 = spans[0].write
        t0, t1 = x0 - k, x1 + k
        if tma and spans[1].kind[0] and spans[2].kind[0]:
            ty0 = spans[1].reads["plane"][0] - k
            tz0 = spans[2].reads["plane"][0] - k

            def fill(slot, bar, t):
                slab = not (0 <= t < bx) and 0 <= origin[0] + t < grid_shape[0]
                if slab:
                    return [("cp_async", slot, 4 * wy * wz),
                            ("arrive", bar)]
                return [("expect_tx", bar, box_bytes),
                        ("tma", slot, bar, box_bytes,
                         (tz0 - (tz0 & 3), ty0, t), 0)]
            return _sched_ring_mbar(t0, t1, p.h_tma_prefetch,
                                    p.h_tma_prefetch + 2, fill, 1,
                                    groups=True)
        return _sched_ring_groups(
            t0, t1, p.h_prefetch, p.h_prefetch + 2,
            lambda slot, t: [] if bf16 else [("cp_async", slot,
                                               4 * wy * wz)])

    plane_b = 4 * (wy + 2) * wz
    # The cp.async ring starts at the buffer itself (heat_t3d_stream),
    # the TMA ring at its first 128-byte boundary.
    slots = {f"ring{i}": (i * plane_b, plane_b, 0)
             for i in range(p.h_prefetch + 2)}
    loads = {"plane": Load("ld" if bf16 else "cp4", "frame", "ring", wz,
                           (0, wz), streamed=1)}
    dyn = p.h_smem_bytes(k, (bzt, byt), rows)
    slack = 0
    if tma:
        loads["box"] = Load("tma", "u", "box", tma_ps[1], (0, tma_ps[0]),
                            streamed=1, box=(1, wy, wz + 4))
        for i in range(p.h_tma_prefetch + 2):
            slots[f"box{i}"] = (4 * i * tma_ps[2], 4 * tma_ps[2])
        dyn = max(dyn, p.h_tma_smem_bytes(k, (bzt, byt), rows))
        slack = 128
    if defer:
        cover = [((k, bx - k), (0, by), (0, bz))]
        leave = [((0, k), (0, by), (0, bz)), ((bx - k, bx), (0, by), (0, bz))]
    else:
        cover, leave = _full(block_shape), []
    ye, ze = by + 2 * k, bz + 2 * k
    name = H_KERNELS[kind] + ("_bf16" if bf16 else "")
    what = kind + (" deferred bulk" if defer else "")
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"{what} {bx}x{by}x{bz} at {tuple(origin)} K={k} {load}",
        grid=len(xsegs) * tiles_y * tiles_z, threads=bzt * byt,
        max_threads=512, dyn_smem=dyn, static_smem=p.static_smem_bytes,
        arrays={"frame": Array((bx + 2 * k, ye, ze), elem=elem),
                "u": Array(block_shape, elem=elem),
                "out": Array(block_shape, elem=elem)},
        output="out",
        axes=[Axis("x", len(xsegs), xs), Axis("y", tiles_y, ys),
              Axis("z", tiles_z, zs)],
        loads=loads, slots=slots, align_slack=slack, cover=cover,
        leave=leave, schedule=schedule,
        group=(f"H {bx}x{by}x{bz} at {tuple(origin)} K={k}"
               + (" bf16" if bf16 else "") if defer else None),
        # HeatHStrides and the per-row offsets are int32 (heat_h.cuh:80,
        # :243); heat_h_launch refuses ye * ze past it.
        int32=[("plane stride by * bz", by * bz),
               ("slab stride ye * ze", ye * ze),
               ("row offset yc * ze + zc", ye * ze - 1)])


def plan_h_band(block_shape, k, origins, grid_shape=None, load=None,
                grouped=True, bf16=False) -> Plan:
    """The 3D band kernel's launch over a round's blocks of
    ``block_shape`` at ``origins`` (``heat_h_band_fix_3d.cu``: one table
    entry a block, the grid (tiles, 2 regions a block), each tile on F's
    plane loop at :meth:`~.hopper_params.HopperParams.h_band_shape`):
    a ``blocks`` axis over the entries ahead of each block's x, y and z,
    every entry's two regions at its origin. ``load`` is "cells" (a
    4-byte cp.async a cell) or "vec" (16 bytes a lane where its four
    cells are one aligned run of the block), by default what
    ``BandLaunch3D`` takes. One plan of the launch holds the guards of
    all its entries (along each axis the loosest); its
    :attr:`~Plan.parts` are each entry's share as a plan of that block,
    so that each joins its block's deferred bulk in the coverage check
    (not ``grouped``: a load the round does not take, whose coverage is
    checked alone). ``bf16``: the bfloat16 launch
    (``heat_h_band_fix_3d_bf16``), as :func:`plan_hc`'s."""
    p = _p()
    grid_shape = grid_shape or block_shape
    if load is None:
        load = ("vec" if p.h_band_vec_fits(block_shape, 2 if bf16 else 4)
                else "cells")
    n = len(origins)
    guards = [_guards_3d(block_shape, k, o, grid_shape) for o in origins]
    loose = tuple((min(g[d][0] for g in guards), max(g[d][1] for g in guards))
                  for d in range(3))
    base = _plan_h_band_block(block_shape, k, origins[0], grid_shape, load,
                              guards=loose, bf16=bf16)
    parts = [_plan_h_band_block(block_shape, k, o, grid_shape, load,
                                bf16=bf16) for o in origins]
    if not grouped:
        parts = [dataclasses.replace(part, group=None) for part in parts]
    bx, by, bz = block_shape

    def entry(i):
        return Span((i, i + 1), {name: (i, 1, None) for name in base.loads},
                    ())

    tiles = base.grid // 2
    return dataclasses.replace(
        base, label=f"band {bx}x{by}x{bz} x{n} blocks at "
                    f"{tuple(origins[0])}.. K={k} {load}"
                    + (" bf16" if bf16 else ""),
        # heat_h_band_fix_3d: (tiles, 2 regions a block) a chunk of
        # BAND_TABLE_3D, so 2 n tiles in all.
        grid=2 * n * tiles,
        arrays={name: Array((n,) + a.shape) for name, a in
                base.arrays.items()},
        axes=[Axis("blocks", n, entry)] + base.axes,
        loads={name: dataclasses.replace(ld, pitch=(0,) + ld.pitch,
                                         streamed=ld.streamed + 1)
               for name, ld in base.loads.items()},
        cover=[((0, n),) + rect for rect in base.cover],
        leave=[((0, n),) + rect for rect in base.leave],
        schedule=lambda spans: base.schedule(spans[1:]),
        group=None, parts=parts)


def _guards_3d(block_shape, k, origin, grid_shape):
    """The guards (frame coordinates) of a 3D block's per-cell loads: the
    cells that lie in the K-deep frame and in the grid."""
    return tuple((max(0, k - o), min(b + 2 * k, n - o + k))
                 for o, b, n in zip(origin, block_shape, grid_shape))


def _plan_h_band_block(block_shape, k, origin, grid_shape, load,
                       guards=None, bf16=False) -> Plan:
    """:func:`plan_h_band` on one block; ``guards`` overrides the loads'
    guards (:func:`_guards_3d` of ``origin``). The per-cell load is
    written in frame coordinates (the block's cells shifted by ``k``;
    the pieces' layout, fixed per row in the kernel, maps the frame onto
    them); the 16-byte load's windows in the block's own, the part of
    each tile's window that lies inside it. ``bf16``: a ring of 2-byte
    cells, a halo of 8 cells along Z, 8-byte copies or plain 2-byte loads
    (the vector load's runs of u untested)."""
    p = _p()
    elem = 2 if bf16 else 4
    bx, by, bz = block_shape
    block, rows, prefetch = p.h_band_shape(k, elem)
    warps = block[1]
    wy, wz = p.f_extent(block, rows)
    P = p.f_pad(k, elem)
    ty_out, tz_out = wy - 2 * k, wz - 2 * P
    tiles_y, tiles_z = p.h_band_tiles(block_shape, k, elem=elem)
    g = guards or _guards_3d(block_shape, k, origin, grid_shape)
    vec = load == "vec"
    slots = prefetch + 2
    slot_f = (wy + 2) * wz
    box_bytes = elem * wz * wy
    threads = 32 * warps
    regions = [0, bx - k]            # heat_h_band_fix_3d_kernel

    def inside(lo, hi, n):
        a, b = max(lo, 0), min(hi, n)
        return (a, b - a, None)

    def xs(i):
        x0 = regions[i]
        reads = {"plane": (x0, 3 * k, g[0])}
        if vec:
            reads["core"] = inside(x0 - k, x0 + 2 * k, bx)
        return Span((x0, x0 + k), reads, (i,))

    def ys(i):
        y0 = i * ty_out - k
        write = (y0 + k, min(y0 + wy - k, by))
        reads = {"plane": (y0 + k, wy, g[1])}
        if vec:
            reads["core"] = inside(y0, y0 + wy, by)
        return Span(write, reads, (y0 < 0, y0 + wy > by,
                                   write[1] - write[0] < ty_out))

    def zs(i):
        z0 = i * tz_out - P
        write = (z0 + P, min(z0 + wz - P, bz))
        reads = {"plane": (z0 + k, wz, g[2])}
        if vec:
            reads["core"] = inside(z0, z0 + wz, bz)
        return Span(write, reads, (z0 < 0, z0 + wz > bz,
                                   (write[1] - write[0]) % 4 != 0))

    def schedule(spans):
        # A thread block streams its tile's 3k planes through the ring
        # (HeatFLoop::run_band).
        y0 = spans[1].reads["plane"][0] - k
        z0 = spans[2].reads["plane"][0] - k

        def fill(slot, bar, v):
            return [("cp_async", slot, box_bytes, (z0, y0, v)),
                    ("cp_async_arrive_noinc", bar, threads)]
        return _sched_ring_mbar(0, 3 * k, prefetch, slots, fill,
                                threads)

    edge = (min(rows, 2) * warps + 2) * wz
    slot_map = {f"ring{i}": (elem * i * slot_f, elem * slot_f)
                for i in range(slots)}
    slot_map["levels"] = (elem * slots * slot_f, 4 * 2 * (k - 1) * edge)
    slot_map["bars"] = (elem * slots * slot_f + 4 * 2 * (k - 1) * edge,
                        8 * slots)
    loads = {"plane": Load("ld" if bf16 else "cp4", "frame", "ring", wz,
                           (0, wz), streamed=1, cell_bytes=elem)}
    if vec:
        loads["core"] = Load("ld" if bf16 else "cp16", "u", "ring", wz,
                             (0, wz), streamed=1, cell_bytes=elem)
    ye, ze = by + 2 * k, bz + 2 * k
    name = "heat_h_band_fix_3d" + ("_bf16" if bf16 else "")
    return Plan(
        kernel=name + "_kernel", entry=name,
        label=f"band {bx}x{by}x{bz} at {tuple(origin)} K={k} {load}"
              + (" bf16" if bf16 else ""),
        grid=2 * tiles_y * tiles_z, threads=threads,
        max_threads=32 * p.f_max_warps(rows, k, elem),
        dyn_smem=p.f_smem_bytes(k, block, rows, prefetch, elem),
        static_smem=p.static_smem_bytes,
        arrays={"frame": Array((bx + 2 * k, ye, ze), elem=elem),
                "u": Array(block_shape, elem=elem),
                "out": Array(block_shape, elem=elem)},
        output="out",
        axes=[Axis("x", 2, xs), Axis("y", tiles_y, ys),
              Axis("z", tiles_z, zs)],
        loads=loads, slots=slot_map, align_slack=128,
        cover=[((0, k), (0, by), (0, bz)), ((bx - k, bx), (0, by), (0, bz))],
        leave=[((k, bx - k), (0, by), (0, bz))], schedule=schedule,
        group=f"H {bx}x{by}x{bz} at {tuple(origin)} K={k}"
              + (" bf16" if bf16 else ""),
        # The pieces' plane strides and each row's offsets are int32
        # (HeatFLoop's pst, moff, zoff, coff); the launcher refuses
        # ye * ze and by * bz past it.
        int32=[("plane stride by * bz", by * bz),
               ("slab stride ye * ze", ye * ze),
               ("row offset yc * ze + zc", ye * ze - 1)])


def _tma_plane(wy, wz):
    """``(row, lead, ps)`` floats of H-fused's TMA ring
    (``heat_temporal3d.cuh`` heat_tma_plane)."""
    row = wz + 4
    lead = -(-row // 32) * 32
    return row, lead, -(-(lead + (wy + 1) * row) // 32) * 32


# ---------------------------------------------------------------------------
# The analysis fixture kernel (csrc/heat_probe_fixture.cu)
# ---------------------------------------------------------------------------

FIXTURE_VARIANTS = ("clean", "clean_tma", "oob_window", "runtime_window",
                    "wait_without_issue", "leaked_issue", "slot_reuse",
                    "expect_mismatch")
FIXTURE_COLS = 128
FIXTURE_THREADS = 128


def plan_fixture(variant="clean", rows=16, n_strips=2, window_rows=None,
                 in_rows=None, in_shift=0, grid=None, cooperative=False,
                 limit_bytes=None) -> Plan:
    """``heat_probe_fixture``: one block per output strip of ``rows //
    n_strips`` rows loads its window into one of two shared slots, waits,
    and writes ``out = 2 u``. ``variant`` is the kernel's code (a
    :data:`FIXTURE_VARIANTS` entry); the geometry's faults are seeded
    here: ``in_rows`` and ``in_shift`` tile the input in blocks of that
    many rows, block ``s + in_shift`` for strip ``s`` (a ragged or
    out-of-range tiling); ``grid`` launches fewer blocks than strips;
    ``window_rows`` loads taller windows (a box over 256 rows);
    ``cooperative`` asks for a cooperative launch; ``limit_bytes``
    audits the shared memory against an injected limit."""
    if variant not in FIXTURE_VARIANTS:
        raise ValueError(f"unknown fixture variant {variant!r}")
    cols = FIXTURE_COLS
    strip = rows // n_strips
    if window_rows is None:
        window_rows = 16 if variant == "oob_window" else strip
    tma = variant in ("clean_tma", "expect_mismatch", "wait_without_issue")
    grid = n_strips if grid is None else grid
    slot_b = 4 * window_rows * cols
    in_rows = in_rows or strip

    def rows_span(s):
        if variant == "runtime_window":
            start = RUNTIME
        elif variant == "oob_window":
            start = s * window_rows
        else:
            start = (s + in_shift) * in_rows
        return Span((s * strip, s * strip + strip),
                    {"window": (start, in_rows if in_rows != strip
                                else window_rows, None)},
                    (s % 2, s == 0))

    def cols_span(j):
        return Span((0, cols), {"window": (0, cols, None)})

    def schedule(spans):
        s = spans[0].kind[0]
        slot = f"slot{s % 2}"
        start = spans[0].reads["window"][0]
        if variant in ("clean", "oob_window", "runtime_window"):
            return _sched_cp_once([slot_b], slot)
        if variant == "leaked_issue":
            return [("cp_async", slot, slot_b), ("commit",)]
        if variant == "slot_reuse":
            return [("cp_async", "slot0", slot_b), ("commit",),
                    ("cp_async", "slot0", slot_b), ("commit",),
                    ("wait_prior", 0), ("read", "slot0")]
        if variant == "wait_without_issue":
            return [("mbar_init", "bar", 1), ("wait", "bar", 0),
                    ("read", slot)]
        expect = slot_b - (4 * cols if variant == "expect_mismatch" else 0)
        return _sched_tma_once(slot_b, expect, (0, start), slot)

    axes = [Axis("strips", grid, rows_span, ragged_ok=False),
            Axis("cols", 1, cols_span, ragged_ok=False)]
    tiled = in_rows != strip or in_shift != 0
    load = Load("tma" if tma else "cp16", "u", "slot", 0, (cols,),
                box=(window_rows, cols) if tma else (), tiled=tiled)
    return Plan(
        kernel="heat_probe_fixture_kernel", entry="heat_probe_fixture",
        label=f"fixture {variant} {rows}x{cols}", grid=grid,
        threads=FIXTURE_THREADS, max_threads=FIXTURE_THREADS,
        dyn_smem=fixture_smem_bytes(window_rows), static_smem=0,
        arrays={"u": Array((rows, cols)), "out": Array((rows, cols))},
        output="out", axes=axes,
        loads={"window": load},
        slots={"slot0": (0, slot_b), "slot1": (slot_b, slot_b),
               "bar": (2 * slot_b, 8)},
        align_slack=128, cooperative=cooperative,
        cover=_full((rows, cols)), schedule=schedule,
        limit_bytes=limit_bytes)


def fixture_smem_bytes(window_rows: int) -> int:
    """Dynamic shared memory of a fixture block: two slots of
    ``window_rows`` rows of 128 floats, 128 bytes to align them, an
    8-byte mbarrier (``csrc/heat_probe_fixture.cu``)."""
    return 2 * 4 * window_rows * FIXTURE_COLS + 128 + 8


# ---------------------------------------------------------------------------
# The audit matrix
# ---------------------------------------------------------------------------

# The main paths' geometries (PERF.md section 4) and the ragged shapes
# chip_smoke.py checks.
MAIN_2D = (16384, 16384)
# BASELINE config 4: the bfloat16 main path.
MAIN_BF16 = (32768, 32768)
A_SHAPE = (1000, 1000)
F_SHAPE = (512, 512, 512)
G_GRID, G_MESH = (32768, 32768), (2, 4)
H_GRID, H_MESH = (1024, 1024, 1024), (2, 2, 2)
M_STACK = (64, (512, 512))
MG_PATH = ((512, 512), (257, 257), (129, 129), (65, 65), (33, 33),
           (17, 17), (9, 9), (5, 5))
RAGGED_2D = ((1001, 999), (21, 23), (20, 24), (1001, 1000))
RAGGED_3D = ((24, 20, 28), (67, 130, 201))
# The bfloat16 forms' ragged grids: rows of 8k + 4 cells (cp.async at
# bfloat16, TMA at float32), of 8k (TMA) and a thin odd one.
RAGGED_3D_BF16 = ((67, 130, 204), (67, 130, 200), (5, 3, 300),
                  (24, 20, 28))


def _mesh_origins(grid_shape, mesh):
    """Block shape and the origins of the corner, an edge and an interior
    block (where the mesh has one) of an even cut of ``grid_shape``."""
    block = tuple(n // d for n, d in zip(grid_shape, mesh))
    picks = set()
    for idx in ([0] * len(mesh), [d - 1 for d in mesh],
                [min(1, d - 1) for d in mesh]):
        picks.add(tuple(i * b for i, b in zip(idx, block)))
    return block, sorted(picks)


def mesh_block_origins(grid_shape, mesh):
    """The origins of every block of an even cut of ``grid_shape`` over
    ``mesh``, in the mesh's row-major order (``parallel/mesh.py``)."""
    import itertools

    block = [n // d for n, d in zip(grid_shape, mesh)]
    return [tuple(i * b for i, b in zip(idx, block))
            for idx in itertools.product(*(range(d) for d in mesh))]


def default_plans() -> List[Plan]:
    """Every kernel of :data:`kernels.build.KERNELS` at its main path's
    geometry, at the ragged shapes ``chip_smoke.py`` checks, and at every
    K the pickers admit (``e_k_max``, ``g_k_max``, ``f_k_max`` and F's
    deep shapes); plus the fixture's clean variants."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3

    p = _p()
    out: List[Plan] = []
    out.append(plan_e(MAIN_2D, p.e_k_default))
    out.append(plan_e(MAIN_2D, p.e_k_default, uni=True))
    for shape in RAGGED_2D:
        for k in range(1, p.e_k_max() + 1):
            out.append(plan_e(shape, k))
            if p.uni_fits(shape):
                out.append(plan_e(shape, k, uni=True))
    # The bfloat16 forms: BASELINE config 4's 32768^2 at the depth its
    # runs launch (storage; a carry chunk of 16 in two launches across the
    # float32 level, a remainder of 8 in one), and every depth each form
    # takes on the ragged grids.
    for uni in (False, True):
        for form in (0, 1, 2, 3):
            out.append(plan_e(MAIN_BF16, p.e_k_default, uni, form=form))
    for shape in RAGGED_2D:
        for form, ks in ((0, range(1, p.e_k_max() + 1)),
                         (1, range(1, p.e_k_max() + 1)),
                         (2, (1, p.e_k_default)),
                         (3, range(1, p.e_k_max() + 1))):
            for k in ks:
                out.append(plan_e(shape, k, form=form))
                if p.uni_fits(shape, "bfloat16"):
                    out.append(plan_e(shape, k, uni=True, form=form))
    for shape in (A_SHAPE, (1001, 999), (20, 24), (107, 210)):
        out.append(plan_a(shape))
        out.append(plan_a(shape, bf16=True))
    out.append(plan_m(M_STACK[0], M_STACK[1], 400))
    out.append(plan_m(8, (20, 20), 20))
    out.append(plan_b(MAIN_2D))
    out.append(plan_c(MAIN_2D))
    out.append(plan_b((21, 23)))
    out.append(plan_c((21, 23)))
    # The bfloat16 forms of M (the ensemble main path's stack and the
    # one-block members chip_smoke.py checks), B and C (BASELINE config
    # 4's 32768^2, pinned, and the ragged grids).
    out.append(plan_m(M_STACK[0], M_STACK[1], 400, bf16=True))
    for batch, shape in ((3, (107, 210)), (3, (24, 20)), (8, (20, 20)),
                         (8, (166, 166))):
        out.append(plan_m(batch, shape, 20, bf16=True))
    for shape in (MAIN_BF16,) + RAGGED_2D:
        out.append(plan_b(shape, bf16=True))
        out.append(plan_c(shape, bf16=True))
    for uni in (False, True):
        out.append(plan_i(MAIN_2D, p.i_k_default, uni))
        out.append(plan_i((20, 24), 3, uni))
    out.append(plan_i((1001, 999), 5))
    # I's and I-uni's bfloat16 forms: BASELINE config 4's 32768^2 at the
    # depth its pinned runs launch (storage; a carry chunk's two launches
    # and a remainder's one), every depth on grids where the box shifts
    # (K <= 4) and where it does not, and I on an odd width and one of
    # 4k + 2 (its 2-byte loads).
    for uni in (False, True):
        for form in (0, 1, 2, 3):
            out.append(plan_i(MAIN_BF16, p.i_k_default, uni, form=form))
            for k in range(1, p.i_k_max + 1):
                out.append(plan_i((200, 136), k, uni, form=form))
    for shape in ((1001, 999), (130, 250), (37, 257)):
        for form in (0, 1, 2, 3):
            out.append(plan_i(shape, 3, form=form))
            out.append(plan_i(shape, p.i_k_default, form=form))
    out.append(plan_d(F_SHAPE))
    out.append(plan_d((24, 20, 28)))
    for load in ("tma", "cp.async"):
        out.append(plan_f(F_SHAPE, p.f_k_default, load))
    for shape in RAGGED_3D:
        loads = ("tma", "cp.async") if p.f_tma_fits(shape) else ("cp.async",)
        for k in range(1, p.f_k_compiled + 1):
            if p.f_shape(k) is None:
                continue
            for load in loads:
                out.append(plan_f(shape, k, load))
    # D's and F's bfloat16 forms: BASELINE config 5's 512^3 (F at its
    # default depth under both loads), and every depth the picker admits
    # on the ragged grids under each load the grid takes.
    out.append(plan_d(F_SHAPE, bf16=True))
    for load in ("tma", "cp.async"):
        out.append(plan_f(F_SHAPE, p.f_k_default, load, bf16=True))
    for shape in RAGGED_3D_BF16:
        out.append(plan_d(shape, bf16=True))
        loads = (("tma", "cp.async") if p.f_tma_fits(shape, "bfloat16")
                 else ("cp.async",))
        for k in range(1, p.f_k_compiled + 1):
            if p.f_shape(k, 2) is None:
                continue
            for load in loads:
                out.append(plan_f(shape, k, load, bf16=True))
    # The transfers: every pair of the implicit main path's hierarchy
    # (512 -> 257 -> ... -> 5), and a ragged stack of three.
    for fine, coarse in zip(MG_PATH[:-1], MG_PATH[1:]):
        out.append(plan_restrict(fine, coarse))
        out.append(plan_prolong(coarse, fine))
    out.append(plan_restrict((21, 23), (11, 12), batch=3))
    out.append(plan_prolong((11, 12), (21, 23), batch=3))
    # Sharded 2D: the default round (G-uni deferred bulk + the band kernel
    # over every block) on the main path's mesh, every pinned kind there;
    # every K on ragged blocks.
    block, origins = _mesh_origins(G_GRID, G_MESH)
    for o in origins:
        out.append(plan_g("G-uni", block, p.g_k_default, o, G_GRID,
                          defer=True))
    out.append(plan_g_band(block, p.g_k_default,
                           mesh_block_origins(G_GRID, G_MESH), G_GRID))
    for kind in ("G", "G-circ", "G-fuse", "G-uni"):
        out.append(plan_g(kind, block, p.g_k_default, origins[0], G_GRID))
    for bshape in ((500, 252), (500, 250)):
        grid = (bshape[0] * 2, bshape[1] * 4)
        for k in range(1, p.g_k_max() + 1):
            for kind in ("G-fuse", "G", "G-circ") + (
                    ("G-uni",) if bshape[1] % 4 == 0 else ()):
                out.append(plan_g(kind, bshape, k, (bshape[0], 0), grid))
            out.append(plan_g("G-fuse", bshape, k, (0, 0), grid, defer=True))
            out.append(plan_g_band(bshape, k,
                                   mesh_block_origins(grid, (2, 4)), grid))
    # The bfloat16 forms: the default round on the main path's mesh, every
    # pinned kind there, every K on ragged blocks (widths of 8k, 4k but
    # not 8k, and neither).
    for o in origins:
        out.append(plan_g("G-uni", block, p.g_k_default, o, G_GRID,
                          defer=True, bf16=True))
    out.append(plan_g_band(block, p.g_k_default,
                           mesh_block_origins(G_GRID, G_MESH), G_GRID,
                           bf16=True))
    for kind in ("G", "G-circ", "G-fuse", "G-uni"):
        out.append(plan_g(kind, block, p.g_k_default, origins[0], G_GRID,
                          bf16=True))
    for bshape in ((500, 256), (500, 252), (500, 250)):
        grid = (bshape[0] * 2, bshape[1] * 4)
        for k in range(1, p.g_k_max() + 1):
            for kind in ("G-fuse", "G", "G-circ") + (
                    ("G-uni",) if bshape[1] % 8 == 0 else ()):
                out.append(plan_g(kind, bshape, k, (bshape[0], 0), grid,
                                  bf16=True))
            out.append(plan_g("G-fuse", bshape, k, (0, 0), grid, defer=True,
                              bf16=True))
            out.append(plan_g_band(bshape, k,
                                   mesh_block_origins(grid, (2, 4)), grid,
                                   bf16=True))
    # Sharded 3D: H-fused on the main path's mesh (its load as h_load
    # picks it), H-defer's bulk and band, H pinned.
    block3, origins3 = _mesh_origins(H_GRID, H_MESH)
    k3 = p.h_k_default
    for o in origins3:
        out.append(plan_h("H-fuse", block3, k3, o, H_GRID,
                          load=skb3.h_load(block3, k3)))
        out.append(plan_h("H-fuse", block3, k3, o, H_GRID, load="cp.async"))
        out.append(plan_h("H-fuse", block3, k3, o, H_GRID, defer=True,
                          load=skb3.h_load(block3, k3)))
    every3 = mesh_block_origins(H_GRID, H_MESH)
    out.append(plan_h_band(block3, k3, every3, H_GRID))
    out.append(plan_h_band(block3, k3, every3, H_GRID, "cells", False))
    for o in (origins3[0], origins3[-1]):
        for load in ("tma", "cp.async"):
            out.append(plan_hc(block3, k3, o, H_GRID, load))
    for bshape, ks in (((67, 128, 92), range(1, p.h_k_max() + 1)),
                       ((40, 128, 96), (1, 3, 8))):
        grid = tuple(2 * b for b in bshape)
        for k in ks:
            if k > p.h_k_max():
                continue
            out.append(plan_h("H-fuse", bshape, k, (0, 0, 0), grid,
                              load=skb3.h_load(bshape, k)))
            if bshape[0] >= 2 * k:
                out.append(plan_h_band(
                    bshape, k, mesh_block_origins(grid, (2, 2, 2)), grid))
        for k in range(1, p.hc_k_max() + 1):
            for o in ((0, 0, 0), bshape):
                out.append(plan_hc(bshape, k, o, grid, "tma"))
            out.append(plan_hc(bshape, k, (0, 0, 0), grid, "cp.async"))
    # The bfloat16 forms: the default round (H-fused's one load) on the
    # main path's mesh, H-defer's bulk and band and H pinned there; every K
    # the pickers admit on the ragged blocks (bz a multiple of 8, of 4 but
    # not 8, and neither).
    for o in origins3:
        out.append(plan_h("H-fuse", block3, k3, o, H_GRID, load="plain",
                          bf16=True))
        out.append(plan_h("H-fuse", block3, k3, o, H_GRID, defer=True,
                          load="plain", bf16=True))
    out.append(plan_h_band(block3, k3, every3, H_GRID, bf16=True))
    out.append(plan_h_band(block3, k3, every3, H_GRID, "cells", False,
                           bf16=True))
    for o in (origins3[0], origins3[-1]):
        for load in ("tma", "cp.async"):
            out.append(plan_hc(block3, k3, o, H_GRID, load, bf16=True))
    for bshape in ((67, 128, 92), (40, 128, 96), (20, 128, 250)):
        grid = tuple(2 * b for b in bshape)
        for k in range(1, p.h_k_max() + 1):
            out.append(plan_h("H-fuse", bshape, k, (0, 0, 0), grid,
                              load="plain", bf16=True))
        for k in range(1, p.h_band_k_max(2) + 1):
            if bshape[0] >= 2 * k:
                out.append(plan_h_band(
                    bshape, k, mesh_block_origins(grid, (2, 2, 2)), grid,
                    bf16=True))
        for k in range(1, p.hc_k_max(2) + 1):
            for o in ((0, 0, 0), bshape):
                out.append(plan_hc(bshape, k, o, grid, "tma", bf16=True))
            out.append(plan_hc(bshape, k, (0, 0, 0), grid, "cp.async",
                               bf16=True))
    out.append(plan_fixture("clean", 16))
    out.append(plan_fixture("clean_tma", 16))
    out.append(plan_fixture("clean_tma", 262144, n_strips=32768))
    return out


def coverage_groups(plans) -> List[Tuple[str, List[Plan]]]:
    """The plans that share a :attr:`Plan.group`, by group: launches
    whose writes together must cover their output once."""
    groups: Dict[str, List[Plan]] = {}
    for pl in plans:
        for part in pl.parts or [pl]:
            if part.group is not None:
                groups.setdefault(part.group, []).append(part)
    return [(name, g) for name, g in groups.items() if len(g) >= 2]
