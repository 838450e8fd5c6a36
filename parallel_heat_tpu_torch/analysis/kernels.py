"""Layer 4: Hopper kernel-safety audits (``HL4xx``) over launch plans.

The counterpart of ``parallel_heat_tpu/analysis/kernels.py``. The port's
kernels manage TMA boxes, mbarrier phases whose ``expect_tx`` byte count
must equal the bytes that land, cp.async commit groups, dynamic shared
memory up to the 227 KB opt-in and cooperative launches that must fit on
the card at once. The audits prove that discipline statically, on the
CPU, with no card and no ``nvcc``, over the launch plans of
:mod:`.plans` (one per kernel and geometry of the audit matrix):

- **HL401 window-in-bounds** — every cp.async and plain-load window lies
  inside its source array where the kernel does not zero-fill it, with
  the copy's alignment (16-byte copies: source and destination on 16
  bytes); every TMA box has each dimension at most 256 cells, an inner
  extent of a multiple of 16 bytes, global strides of multiples of 16
  bytes, a 128-byte aligned shared destination and its own row pitch;
  every window and box lands inside its shared buffer, and the buffers
  inside the dynamic shared memory the launch asks for; every 32-bit
  index the kernel computes stays below 2^31. A coordinate the plan
  marks as a run-time value is reported as not statically derivable.
- **HL402 smem-budget** — dynamic plus static shared memory within
  ``smem_per_block_max`` (or an injected limit); the thread block within
  the kernel's launch bound; the blocks an SM holds (by shared memory
  with the runtime's 1 KB reserve, and by threads) at least what the
  picker promised; a cooperative grid that fits the card at once.
- **HL403 async-discipline** — each block's async schedule simulated
  over mbarriers (arrival counts, phases and transaction bytes: an
  ``expect_tx`` is itself an arrival, a box completes its **whole**
  bytes, a ``cp.async.mbarrier.arrive.noinc`` counts against the
  ``init`` count) and cp.async commit groups: a wait on a phase nothing
  can complete, a copy still in flight at the kernel's end, a copy into
  a slot in flight or not yet read, an ``expect_tx`` that differs from
  the bytes issued on its phase, and a read before its copy landed.
- **HL404 output-coverage** — across all blocks of a launch every cell
  the kernel must write is written exactly once, and no cell it must
  leave (a Dirichlet ring, the band of a deferred bulk) is written; for
  the sharded kernels the deferred bulk and its band together; a ragged
  last tile is a fault only where the plan says the kernel takes none;
  an input tiled as a grid of blocks is tiled exactly.

Blocks are enumerated by class: along each axis every span is checked
(windows, coverage), and the schedules and tile kinds are proved on one
block of each combination of span classes. A picker tile kind
(``hopper_params.*_tile_kinds``) no audited block belongs to is a
soundness finding, never silence. The coverage cross-check holds every
``__global__`` function under ``csrc/`` to a plan or a justified baseline
entry, so that a new kernel cannot land unaudited.
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Dict, List, Optional

from parallel_heat_tpu_torch.analysis.findings import Finding
from parallel_heat_tpu_torch.analysis.plans import RUNTIME

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

# Refuse to "prove" anything past this many representative blocks of one
# launch: a blow-up here means the span classes regressed.
_MAX_INSTANCES = 4096

INT32_MAX = 0x7FFFFFFF
TMA_BOX_MAX = 256


def _source_of(entry: str) -> str:
    from parallel_heat_tpu_torch.kernels.build import KERNELS, TOOLS, owner

    entry = owner(entry)
    table = KERNELS if entry in KERNELS else TOOLS
    return f"parallel_heat_tpu_torch/csrc/{table[entry][0]}"


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _spans(plan):
    return [[a.span(i) for i in range(a.count)] for a in plan.axes]


def _representatives(spans):
    """Per axis, the first index of each span class."""
    reps = []
    for axis in spans:
        seen = {}
        for i, s in enumerate(axis):
            seen.setdefault(s.kind, i)
        reps.append(sorted(seen.values()))
    return reps


def blocks_per_sm(plan, registers: Optional[int] = None) -> int:
    """Blocks of ``plan`` one SM holds at once by shared memory (the
    launch's dynamic and static bytes in 128-byte units, plus the
    runtime's 1 KB reserve a block), by threads (2048 an SM, 32 blocks)
    and, given ``registers`` a thread (ptxas), by registers (65536 an SM,
    allocated 256 a warp)."""
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    smem = -(-(plan.dyn_smem + plan.static_smem) // 128) * 128
    by_smem = p.smem_per_sm // (smem + p.smem_reserved_per_block)
    warps = -(-plan.threads // 32)
    n = min(by_smem, 2048 // (32 * warps), 32)
    if registers:
        per_warp = -(-registers * 32 // 256) * 256
        n = min(n, 65536 // (per_warp * warps))
    return n


# ---------------------------------------------------------------------------
# HL401
# ---------------------------------------------------------------------------

def _slots_of(plan, name):
    return {s: v for s, v in plan.slots.items()
            if s == name or (s.startswith(name) and s[len(name):].isdigit())}


def _audit_windows(plan, spans, report):
    ndim = len(plan.axes)
    for lname, load in plan.loads.items():
        arr = plan.arrays[load.array]
        shape = arr.shape
        max_ext = [0] * ndim
        for d, axis in enumerate(spans):
            for i, s in enumerate(axis):
                r = s.reads.get(lname)
                if r is None:
                    continue
                start, ext, guard = r
                if start == RUNTIME:
                    report("HL401",
                           f"{lname} window start on axis {d} is not "
                           f"statically derivable from the launch's "
                           f"geometry (a run-time value) — in-bounds is "
                           f"unprovable (array shape {shape})",
                           soundness=True)
                    continue
                max_ext[d] = max(max_ext[d], ext)
                if load.kind == "tma":
                    if abs(start) > INT32_MAX:
                        report("HL401", f"{lname} box coordinate {start} "
                                        f"on axis {d} overflows int32")
                    if d == ndim - 1 and start * arr.elem % 16:
                        report("HL401",
                               f"{lname} box starts at cell {start} of its "
                               f"rows, {start * arr.elem} bytes: not on 16 "
                               f"bytes (the copy faults as an illegal "
                               f"instruction on the card)")
                    continue
                lo, hi = start, start + ext
                if guard is not None:
                    lo, hi = max(lo, guard[0]), min(hi, guard[1])
                if lo < hi and (lo < 0 or hi > shape[d]):
                    report("HL401",
                           f"{load.kind} window {lname} out of bounds: "
                           f"axis {d} reads [{lo}, {hi}) of a "
                           f"{shape[d]}-extent array (shape {shape}) at "
                           f"span {i} — on the card this copy reads "
                           f"past the allocation silently")
                vec = 16 // arr.elem       # cells of a 16-byte copy
                if (load.kind == "cp16" and guard is None
                        and d == ndim - 1 and (start % vec or ext % vec)):
                    report("HL401",
                           f"16-byte cp.async window {lname} starts at "
                           f"column {start} over {ext} columns: not on "
                           f"16 bytes")
        if load.kind == "cp16":
            if shape[-1] % (16 // arr.elem) or arr.align % 16:
                report("HL401", f"16-byte cp.async from {load.array}: "
                                f"rows of {shape[-1]} cells of "
                                f"{arr.elem} bytes or a base aligned to "
                                f"{arr.align} bytes break the copy's "
                                f"16-byte alignment")
            cb = load.cell_bytes
            if (load.dst * cb) % 16 or any(q * cb % 16 for q in load.pitch):
                report("HL401", f"16-byte cp.async {lname} lands at cell "
                                f"{load.dst}, pitch {load.pitch} ({cb} "
                                f"bytes a cell): not on 16 bytes")
        if load.kind == "tma":
            _audit_box(plan, lname, load, arr, report)
            extents = list(load.box)
        else:
            extents = max_ext
        if load.slot is None:
            continue
        # The window's footprint in its slot (streamed dims one cell).
        foot = load.dst
        for d in range(ndim - 1):
            e = 1 if d < load.streamed else extents[d]
            foot += (max(e, 1) - 1) * (load.pitch[d] if d < len(load.pitch)
                                       else 0)
        foot += extents[-1]
        for sname, (off, size, *_) in _slots_of(plan, load.slot).items():
            if load.cell_bytes * foot > size:
                report("HL401",
                       f"{lname} lands {load.cell_bytes * foot} bytes into "
                       f"slot {sname} "
                       f"of {size} bytes — past its shared buffer")
    for sname, (off, size, *slack) in plan.slots.items():
        slack = slack[0] if slack else plan.align_slack
        if off + size + slack > plan.dyn_smem:
            report("HL401",
                   f"shared buffer {sname} ends at byte {off + size} "
                   f"(+{slack} of alignment) past the {plan.dyn_smem} "
                   f"bytes of dynamic shared memory the launch asks for")
    for what, value in plan.int32:
        if value > INT32_MAX:
            report("HL401", f"32-bit index {what} reaches {value}, past "
                            f"2^31 - 1 at this geometry")


def _audit_box(plan, lname, load, arr, report):
    box = load.box
    if any(b > TMA_BOX_MAX or b < 1 for b in box):
        report("HL401", f"TMA box {lname} of {box} cells: a dimension "
                        f"exceeds {TMA_BOX_MAX} cells (cuTensorMapEncodeTiled "
                        f"refuses the map)")
    if box[-1] * arr.elem % 16:
        report("HL401", f"TMA box {lname}: inner extent {box[-1]} cells of "
                        f"{arr.elem} bytes is not a multiple of 16 bytes")
    stride = arr.elem
    for n in reversed(arr.shape[1:]):
        stride *= n
        if stride % 16:
            report("HL401", f"TMA map of {load.array} {arr.shape}: a "
                            f"global stride of {stride} bytes is not a "
                            f"multiple of 16")
            break
    if arr.align % 16:
        report("HL401", f"TMA map of {load.array}: base aligned to "
                        f"{arr.align} bytes, not 16")
    if load.pitch and load.pitch[-1] != box[-1]:
        report("HL401", f"TMA box {lname} lands with its own row pitch "
                        f"({box[-1]} floats) but the slot's rows are "
                        f"{load.pitch[-1]} floats apart")
    for sname, (off, *_) in _slots_of(plan, load.slot).items():
        if (off + load.cell_bytes * load.dst) % 128:
            report("HL401", f"TMA box {lname} lands at byte "
                            f"{off + load.cell_bytes * load.dst} of the "
                            f"aligned buffers "
                            f"(slot {sname}): not 128-byte aligned")


# ---------------------------------------------------------------------------
# HL402
# ---------------------------------------------------------------------------

def _audit_smem(plan, report, limit_bytes):
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    limit = plan.limit_bytes or limit_bytes or p.smem_per_block_max
    total = plan.dyn_smem + plan.static_smem
    if total > limit:
        report("HL402",
               f"shared memory {total} bytes ({plan.dyn_smem} dynamic + "
               f"{plan.static_smem} static) exceeds the {limit}-byte limit "
               f"a block may have — a geometry the picker admits would be "
               f"refused at launch")
    if plan.threads > min(plan.max_threads, 1024):
        report("HL402", f"thread block of {plan.threads} threads exceeds "
                        f"the kernel's launch bound of {plan.max_threads}")
    n = blocks_per_sm(plan)
    if n < plan.min_blocks_per_sm:
        report("HL402", f"one SM holds {n} block(s) by shared memory and "
                        f"threads, fewer than the {plan.min_blocks_per_sm} "
                        f"the picker promised")
    if plan.cooperative and plan.grid > p.sm_count * n:
        report("HL402", f"cooperative grid of {plan.grid} blocks does not "
                        f"fit the card at once ({p.sm_count} SMs x {n} "
                        f"block(s) an SM): the launch is refused "
                        f"(cudaErrorCooperativeLaunchTooLarge)")


# ---------------------------------------------------------------------------
# HL403: the schedule simulator
# ---------------------------------------------------------------------------

class _Copy:
    __slots__ = ("slot", "landed", "group", "bar", "bytes")

    def __init__(self, slot, nbytes):
        self.slot, self.bytes = slot, nbytes
        self.landed = False
        self.group = None   # commit group index, or "open"
        self.bar = None     # mbarrier whose phase lands it


def simulate(events, report):
    """Run one block's async schedule; report each violation once."""
    bars: Dict[str, dict] = {}
    copies: List[_Copy] = []
    groups: List[List[_Copy]] = []
    open_group: List[_Copy] = []
    slot_read: Dict[str, bool] = {}

    def slot_copies(slot):
        return [c for c in copies if c.slot == slot]

    def issue(slot, nbytes, same_fill):
        pending = [c for c in slot_copies(slot) if not c.landed]
        if pending and not same_fill:
            report("HL403",
                   f"async copy into slot {slot} while an earlier copy "
                   f"into it is still in flight — double-buffer slot "
                   f"reused before its wait")
        elif (not same_fill and slot_copies(slot)
              and not slot_read.get(slot, True)):
            report("HL403",
                   f"async copy into slot {slot} before its last fill "
                   f"was read — double-buffer slot reused, its data "
                   f"lost")
        c = _Copy(slot, nbytes)
        copies.append(c)
        slot_read[slot] = False
        return c

    def complete(b):
        for c in b["attached"]:
            c.landed = True
        b["phase"] += 1
        b.update(pending=b["count"], tx=0, issued=0, noinc=0, attached=[])

    for ev in events:
        kind = ev[0]
        if kind == "mbar_init":
            bars[ev[1]] = dict(count=ev[2], pending=ev[2], tx=0, issued=0,
                               noinc=0, phase=0, attached=[])
        elif kind in ("expect_tx", "arrive", "cp_async_arrive_noinc"):
            b = bars.get(ev[1])
            if b is None:
                report("HL403", f"{kind} on mbarrier {ev[1]} that was "
                                f"never initialised")
                continue
            if kind == "expect_tx":
                b["tx"] += ev[2]
                b["pending"] -= 1
            elif kind == "arrive":
                b["pending"] -= 1
            else:
                b["noinc"] += ev[2]
                for c in copies:
                    if not c.landed and c.bar is None:
                        c.bar = ev[1]
                        c.group = None
                        b["attached"].append(c)
                open_group[:] = [c for c in open_group if c.bar is None]
            if b["pending"] < 0:
                report("HL403", f"more arrivals on mbarrier {ev[1]} than "
                                f"its count of {b['count']} in one phase")
        elif kind == "tma":
            _, slot, bar, nbytes, _coords, part = ev
            c = issue(slot, nbytes, part > 0)
            b = bars.get(bar)
            if b is None:
                report("HL403", f"TMA box into {slot} on mbarrier {bar} "
                                f"that was never initialised")
                c.landed = True
                continue
            c.bar = bar
            b["issued"] += nbytes
            b["attached"].append(c)
        elif kind == "cp_async":
            slot = ev[1]
            same = any(c.slot == slot for c in open_group)
            c = issue(slot, ev[2], same)
            c.group = "open"
            open_group.append(c)
        elif kind == "commit":
            for c in open_group:
                c.group = len(groups)
            groups.append(list(open_group))
            open_group = []
        elif kind == "wait_prior":
            for g in groups[:max(0, len(groups) - ev[1])]:
                for c in g:
                    if c.bar is None:
                        c.landed = True
        elif kind == "wait":
            _, bar, parity = ev
            b = bars.get(bar)
            if b is None:
                report("HL403", f"wait on mbarrier {bar} that was never "
                                f"initialised — the kernel would block "
                                f"forever")
                continue
            if parity != b["phase"] % 2:
                continue  # the phase of that parity has completed
            arrivals = b["count"] - b["pending"] + b["noinc"]
            if not b["attached"] and b["tx"] == 0 and arrivals < b["count"]:
                report("HL403",
                       f"wait on mbarrier {bar} (parity {parity}) with NO "
                       f"outstanding copy — the kernel would block forever "
                       f"(wait without a matching issue)")
            elif arrivals != b["count"]:
                what = ("never completes (a hang)"
                        if arrivals < b["count"] else "over-arrives")
                report("HL403",
                       f"wait on mbarrier {bar}: {arrivals} arrival(s) in "
                       f"a phase of count {b['count']} — the phase {what}")
            elif b["tx"] != b["issued"]:
                what = ("the phase never completes (a hang)"
                        if b["tx"] > b["issued"]
                        else "the phase completes before the data lands")
                report("HL403",
                       f"expect_tx of {b['tx']} bytes on mbarrier {bar} "
                       f"differs from the {b['issued']} bytes issued on its "
                       f"phase (a box counts its whole extent, zero-filled "
                       f"cells included) — {what}")
            complete(b)
        elif kind == "read":
            slot = ev[1]
            late = [c for c in slot_copies(slot) if not c.landed]
            if late:
                grouped = [c for c in late if c.group is not None]
                how = (f"a wait_prior leaves its commit group in flight"
                       if grouped else "its mbarrier phase has not been "
                       "waited")
                report("HL403", f"read of slot {slot} before its phase "
                                f"completed: {how}")
            slot_read[slot] = True
    leaked = [c for c in copies if not c.landed]
    if leaked:
        c = leaked[0]
        report("HL403",
               f"async copy into slot {c.slot} is never waited — it "
               f"outlives the kernel, and its arrival or bytes leak into "
               f"the next use of the shared memory")


# ---------------------------------------------------------------------------
# HL404
# ---------------------------------------------------------------------------

def _paint(plans, shape, rects):
    """Per compressed cell of ``shape``, how many blocks of ``plans``
    write it: (counts, per-dimension boundaries)."""
    import numpy as np

    ndim = len(shape)
    bounds = [{0, shape[d]} for d in range(ndim)]
    per_plan = []
    for plan in plans:
        ivs = []
        for d, axis in enumerate(_spans(plan)):
            lst = []
            for s in axis:
                if s.write is None:
                    continue
                lo, hi = max(0, s.write[0]), min(shape[d], s.write[1])
                if lo < hi:
                    lst.append((lo, hi))
                    bounds[d].update((lo, hi))
            ivs.append(lst)
        per_plan.append(ivs)
    for r in rects:
        for d, (lo, hi) in enumerate(r):
            bounds[d].update((lo, hi))
    bounds = [sorted(b) for b in bounds]
    index = [{v: i for i, v in enumerate(b)} for b in bounds]
    total = np.zeros([len(b) - 1 for b in bounds], dtype=np.int64)
    for ivs in per_plan:
        vecs = []
        for d, lst in enumerate(ivs):
            v = np.zeros(len(bounds[d]), dtype=np.int64)
            for lo, hi in lst:
                v[index[d][lo]] += 1
                v[index[d][hi]] -= 1
            vecs.append(np.cumsum(v)[:-1])
        out = vecs[0]
        for v in vecs[1:]:
            out = np.multiply.outer(out, v)
        total += out
    return total, bounds, index


def _region(total, index, rect):
    return total[tuple(slice(index[d][lo], index[d][hi])
                       for d, (lo, hi) in enumerate(rect))]


def _check_cover(plans, shape, cover, leave, report, what):
    import numpy as np

    total, _bounds, index = _paint(plans, shape, list(cover) + list(leave))
    for rect in cover:
        reg = _region(total, index, rect)
        if (reg == 0).any():
            report("HL404", f"output cells of {rect} are never visited by "
                            f"any block of {what} over its grid — those "
                            f"cells leave the kernel as whatever the buffer "
                            f"held")
        if (reg > 1).any():
            report("HL404", f"output cells of {rect} are written by "
                            f"{int(np.max(reg))} blocks of {what} — "
                            f"overlapping tiles race")
    for rect in leave:
        if (_region(total, index, rect) > 0).any():
            report("HL404", f"{what} writes cells of {rect}, which it "
                            f"must leave as they are (a Dirichlet ring or "
                            f"a band another launch owns)")


def _audit_coverage(plan, spans, report):
    shape = plan.arrays[plan.output].shape
    for d, (axis, sp) in enumerate(zip(plan.axes, spans)):
        writes = [s.write for s in sp if s.write is not None]
        for i, s in enumerate(sp):
            if s.write is not None and (s.write[0] < 0
                                        or s.write[1] > shape[d]):
                report("HL404", f"output tile {s.write} of span {i} on axis "
                                f"{d} lies outside the {shape[d]} cells of "
                                f"the output {shape} — the block would "
                                f"write past it")
        lens = {hi - lo for lo, hi in writes}
        if not axis.ragged_ok and writes and (
                len(lens) > 1 or shape[d] % max(lens)):
            report("HL404", f"output tile of {max(lens)} cells does not "
                            f"divide ref shape {shape} on axis {d}, and "
                            f"the kernel takes no ragged tile there")
        for lname, load in plan.loads.items():
            if not load.tiled:
                continue
            arr = plan.arrays[load.array].shape
            wins = [s.reads[lname][:2] for s in sp
                    if s.reads.get(lname) is not None]
            exts = {e for _, e in wins}
            if len(exts) > 1 or arr[d] % max(exts):
                report("HL404", f"input block of {max(exts)} cells does "
                                f"not divide ref shape {arr} on axis {d}")
            n = arr[d] // max(exts) if max(exts) else 0
            for i, (st, e) in enumerate(wins):
                if st < 0 or st + e > arr[d]:
                    report("HL404", f"input block {st // max(e, 1)} of span "
                                    f"{i} lies outside the {n} blocks of "
                                    f"ref shape {arr} on axis {d}")
    _check_cover([plan], shape, plan.cover, plan.leave, report,
                 plan.label)


# ---------------------------------------------------------------------------
# The audit
# ---------------------------------------------------------------------------

def _audit_plan(plan, report, limit_bytes):
    spans = _spans(plan)
    _audit_windows(plan, spans, report)
    _audit_smem(plan, report, limit_bytes)
    _audit_coverage(plan, spans, report)
    reps = _representatives(spans)
    n = 1
    for r in reps:
        n *= len(r)
    if n > _MAX_INSTANCES:
        report("HL403", f"{n} block classes, past the audit's "
                        f"{_MAX_INSTANCES}-class exhaustion bound — the "
                        f"span classes of this plan regressed",
               soundness=True)
        return
    seen_kinds = set()
    proved = set()
    for idx in itertools.product(*reps):
        block = tuple(spans[d][i] for d, i in enumerate(idx))
        if plan.kinds_of is not None:
            seen_kinds |= plan.kinds_of(block)
        if plan.schedule is None:
            continue
        events = plan.schedule(block)
        key = tuple(e[:4] if e[0] in ("tma", "cp_async") else e
                    for e in events)
        if key in proved:
            continue
        proved.add(key)
        simulate(events, report)
    if plan.kinds is not None and plan.kinds_of is not None:
        for name, count in sorted(plan.kinds.items()):
            if count and name not in seen_kinds:
                report("HL403", f"tile class {name!r} ({count} tiles by the "
                                f"picker's count) holds no audited block — "
                                f"its schedule and windows are not proved",
                       soundness=True)


def source_kernel_names() -> dict:
    """``{name: (file, line)}`` of every ``__global__`` function under
    ``csrc/`` (read as text: :func:`.astlint.cuda_globals`)."""
    from parallel_heat_tpu_torch.analysis.astlint import cuda_globals

    out = {}
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh", ".inc")):
            for kernel, line in cuda_globals(os.path.join(CSRC, name)):
                out[kernel] = (f"parallel_heat_tpu_torch/csrc/{name}", line)
    return out


def audit_kernels(plans=None, limit_bytes=None,
                  check_coverage=None) -> List[Finding]:
    """Run HL401-HL404 over ``plans`` (default: :func:`.plans.
    default_plans`, with the coverage cross-check against every
    ``__global__`` under ``csrc/``)."""
    from parallel_heat_tpu_torch.analysis.plans import (coverage_groups,
                                                        default_plans)

    if check_coverage is None:
        check_coverage = plans is None
    if plans is None:
        plans = default_plans()
    out: List[Finding] = []
    seen = set()
    covered = set()

    for plan in plans:
        covered.add(plan.kernel)
        label = f"{plan.label}/{plan.kernel}"
        src = _source_of(plan.entry)

        def report(rule, message, _label=label, _src=src, soundness=False):
            key = (rule, _label, message)
            if key not in seen:
                seen.add(key)
                out.append(Finding(rule, "error", _src, 0, _label, message,
                                   soundness=soundness))

        _audit_plan(plan, report, limit_bytes)

    for name, group in coverage_groups(plans):
        shape = group[0].arrays[group[0].output].shape
        full = [tuple((0, n) for n in shape)]

        def report(rule, message, _name=name, soundness=False):
            key = (rule, _name, message)
            if key not in seen:
                seen.add(key)
                out.append(Finding(rule, "error", _source_of(group[0].entry),
                                   0, _name, message, soundness=soundness))

        _check_cover(group, shape, full, [], report, f"{name} (bulk + band)")

    if check_coverage:
        for name, (fpath, line) in source_kernel_names().items():
            if name not in covered:
                out.append(Finding(
                    "HL401", "error", fpath, line, name,
                    f"__global__ function {name!r} is not covered by any "
                    f"kernel-audit target — every kernel needs a launch "
                    f"plan in analysis.plans.default_plans (or a justified "
                    f"baseline entry naming the plan that covers its body) "
                    f"so its windows, shared memory, async schedule and "
                    f"coverage stay proven", soundness=True))
    return out


def load_records(plan, index):
    """The loads of block ``index`` (one span index per axis) of ``plan``
    in issue order, as ``chip_smoke.py`` reads the kernels' record
    variant: ``(c0, c1, c2, bytes landed, expect_tx bytes, slot,
    parity)`` with the window's coordinates innermost first (z, y, x; a
    2D box's x, y and 0), the bytes landed a TMA box's whole (on the card,
    the box the launch encodes) or a cp.async fill's copies, 0 expected
    bytes for a cp.async fill, and the parity its consumer waits on (the
    slot's use count mod 2)."""
    block = tuple(a.span(i) for a, i in zip(plan.axes, index))
    expect: Dict[str, int] = {}
    uses: Dict[str, int] = {}
    out = []
    for ev in plan.schedule(block):
        if ev[0] == "expect_tx":
            expect[ev[1]] = ev[2]
        elif ev[0] in ("tma", "cp_async") and len(ev) > 3:
            coords = tuple(ev[4] if ev[0] == "tma" else ev[3])
            coords = coords + (0,) * (3 - len(coords))
            slot = int(re.search(r"\d*$", ev[1]).group() or 0)
            n = uses.get(ev[1], 0)
            uses[ev[1]] = n + 1
            exp = expect.pop(ev[2], 0) if ev[0] == "tma" else 0
            out.append(coords + (ev[3] if ev[0] == "tma" else ev[2], exp,
                                 slot, n & 1))
    return out


def _rule_runner(rule_id):
    def run():
        return run_kernels({rule_id})

    return run


KERNEL_RULES = {
    "HL401": ("error", "copy window or TMA box out of bounds, misaligned "
                       "or unprovable", _rule_runner("HL401")),
    "HL402": ("error", "shared memory or residency beyond the card",
              _rule_runner("HL402")),
    "HL403": ("error", "mbarrier / cp.async discipline violated",
              _rule_runner("HL403")),
    "HL404": ("error", "output tiles incomplete, overlapping or ragged",
              _rule_runner("HL404")),
}


def run_kernels(rules=None) -> List[Finding]:
    """Run the kernel audits over the default plans (one pass serves all
    four rules)."""
    wanted = set(KERNEL_RULES) if rules is None else set(rules)
    # Soundness sentinels survive any rule filter: they mean an audit
    # was skipped, so a --rules subset must not report clean.
    return [f for f in audit_kernels()
            if f.rule in wanted or f.soundness]
