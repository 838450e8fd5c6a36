"""Loops that stay on the card: bodies guarded by a flag in device memory,
captured once as a CUDA graph and replayed.

The JAX package compiles its loops into one program: the converge
windows run in a ``lax.while_loop`` (``parallel_heat_tpu/solver.py:301``),
the V-cycles of an implicit step in another
(``parallel_heat_tpu/ops/multigrid.py:405``), and a sharded round is one
program. Here a loop is a Python loop over launches, so each stop test
would be a host read of a device value. This module moves the test onto
the card:

- :func:`guard` runs a body where a 0-d bool tensor (the flag) holds,
  and :func:`repeat` runs it while the flag holds. Under :func:`capture`
  a guarded body is captured behind an IF node whose condition the card
  reads from the flag when it gets there, a repeated one behind a WHILE
  node (``csrc/heat_graph_loop.cu``); nested bodies nest. Otherwise the
  host reads the flag (the eager executor: every run on the CPU, and on
  the card only under :func:`eager`, the yardstick ``chip_smoke.py``
  holds the graphs to).
- :class:`WindowLoop` is the converge loop: :data:`WINDOW_COPIES` guarded
  check windows in one graph, the loop state (steps run, residual, the flag)
  on the card under exactly the JAX rule, one host read a replay with
  one replay in flight ahead of it. :class:`PeriodLoop` replays a fixed
  number of steps that leave the buffers in their order.

Capture launches nothing, so it never steps the state; each loop warms
up on a scratch copy of its state (and its spare, which nothing reads)
before it captures. A capture or a replay that fails raises; nothing
falls back to the host loop.

**Where the result sits.** A body that ping-pongs its two buffers an odd
number of times leaves the state in the other one. Copy ``i`` of a
window graph is captured on ``order[i % 2]`` (the order after ``i``
bodies), so the graph chains from replay to replay only when it holds an
even number of copies; after ``n`` bodies the state is in
``order[n % 2]``.

**Counters.** The wrappers count their launches in Python, which a
replay does not call. A capture counts what each guarded body adds to
the registered tallies (``stencil_kernels.counts``, ``multigrid.stats``
but its host reads) and takes the counts back; the body bumps a counter
on the card each time it runs. A launch of a graph adds its unguarded
part on the host, and :func:`settle` reads every counter once and adds
each body's share times the bodies the card ran.

**Route.** PyTorch's own IF nodes (``begin_capture_to_if_node``) came
after the torch 2.11 of the card's machine; there, PyTorch captures each
piece of a loop as a graph of its own (a segment, all of one loop in one
memory pool, so its allocator serves the temporaries) and
``csrc/heat_graph_loop.cu`` chains the segments and the conditional
nodes into one graph (IF: CUDA 12.3; WHILE: 12.4).
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch

HELPER = "heat_graph_loop"
(_CREATE, _ADD_CHILD, _ADD_IF, _ADD_WHILE, _CLOSE_WHILE, _COUNT, _INSTANTIATE,
 _UPLOAD, _LAUNCH, _DESTROY, _DESTROY_EXEC) = range(11)

# Check windows a window graph holds; a window that nests
# loops of its own (the V-cycles of implicit steps) runs far longer than
# the host takes to read a replay's state, and takes one (two where it
# flips the buffers): PERF.md has the measurements.
WINDOW_COPIES = 16
# Counter slots of one graph: one a distinct guarded body.
_SLOTS = 32

# What the device loops did since the last reset_stats(): host reads of a
# device value, graph launches, graphs captured, their capture and
# instantiation seconds, their nodes and guarded bodies.
stats = {"reads": 0, "launches": 0, "graphs": 0, "capture_s": 0.0,
         "nodes": 0, "guards": 0}

_tallies: List[tuple] = []
_helper: list = []
_capture: Optional["_Capture"] = None
_eager = False
_pending: Dict[int, "_Graph"] = {}
# Guarded bodies asked for, run or not (what a capture would hold).
_planned = [0]


def reset_stats() -> None:
    for name in stats:
        stats[name] = 0.0 if name == "capture_s" else 0


def register_tally(tally: dict, skip=()) -> None:
    """Count ``tally``'s entries (but ``skip``) through replays."""
    _tallies.append((tally, frozenset(skip)))


@contextlib.contextmanager
def eager():
    """Run the loops with the eager executor on the card too: every guard
    a host read, no graph. The yardstick the graphs are held to."""
    global _eager
    old, _eager = _eager, True
    try:
        yield
    finally:
        _eager = old


def on_card(t: torch.Tensor) -> bool:
    """Does a loop over ``t`` take the graphs?"""
    return t.device.type == "cuda" and not _eager


def read(t: torch.Tensor) -> list:
    """``t``'s values on the host: one read."""
    stats["reads"] += 1
    return t.reshape(-1).tolist()


def _lib():
    if not _helper:
        from parallel_heat_tpu_torch.kernels.build import load

        lib = load(HELPER)
        lib.heat_graph_window.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        _helper.append(lib)
    return _helper[0]


def _check(lib, what, code) -> None:
    if code != 0:
        reason = lib.heat_graph_loop_error_string(code).decode()
        raise RuntimeError(f"{HELPER} {what} failed: cudaError {code} "
                           f"({reason})")


def _call(op, a=None, b=None, c=None, d=None):
    lib = _lib()
    out = (ctypes.c_void_p * 3)()
    _check(lib, f"op {op}", lib.heat_graph_loop(op, a, b, c, d, out))
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Tallies
# ---------------------------------------------------------------------------

def _snapshot():
    return [dict(t) for t, _ in _tallies]


def _restore(snap) -> None:
    for (tally, _), old in zip(_tallies, snap):
        tally.update(old)


def _delta(before, after=None):
    """What the tallies gained since ``before``: a tuple of
    ``((key, n), ...)`` per tally, the skipped keys left out."""
    after = _snapshot() if after is None else after
    return tuple(tuple(sorted((k, after[i][k] - before[i].get(k, 0))
                              for k in after[i] if k not in skip
                              and after[i][k] != before[i].get(k, 0)))
                 for i, (_, skip) in enumerate(_tallies))


def _nothing():
    return tuple(() for _ in _tallies)


def _minus(a, b):
    out = []
    for da, db in zip(a, b):
        d = dict(da)
        for k, n in db:
            d[k] = d.get(k, 0) - n
        out.append(tuple(sorted((k, n) for k, n in d.items() if n)))
    return tuple(out)


def _merge(a, b):
    return _minus(a, tuple(tuple((k, -n) for k, n in d) for d in b))


def _add(delta, times: int) -> None:
    if times:
        for (tally, _), d in zip(_tallies, delta):
            for k, n in d:
                tally[k] += n * times


class Site:
    """A guarded body: what one run of it adds to the tallies, nested
    bodies left out, recorded at its first capture and held to every
    later one. A ``counted`` body bumps a counter on the card each time it
    runs, which :func:`settle` reads; the caller of one that is not counts
    its runs itself."""

    def __init__(self, name: str, counted: bool = True):
        self.name, self.counted = name, counted
        self.delta = None

    def record(self, delta) -> None:
        if self.delta is None:
            self.delta = delta
        elif delta != self.delta:
            raise RuntimeError(f"{self.name}: a capture counted {delta}, an "
                               f"earlier one {self.delta}")


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------

class _Capture:
    """One capture in progress: the segments, the IF nodes, the sites."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.counter = torch.zeros(_SLOTS, dtype=torch.int64, device=device)
        self.sites: List[Site] = []
        self.pool = None
        self.segments = []
        self.flags = []
        # Per frame (the top, then each open body): its items, ("seg",
        # graph) or (kind, flag, items) with kind "if" or "while", and
        # its nested bodies' share.
        self.frames = [[]]
        self.nested = [_nothing()]
        self.guards = 0
        self.seg = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        if self.pool is None:
            g.capture_begin()
        else:
            g.capture_begin(pool=self.pool)
        self.seg = g

    def end(self) -> None:
        g, self.seg = self.seg, None
        with warnings.catch_warnings():
            # A segment may be empty (two guards in a row); it is dropped.
            warnings.simplefilter("ignore")
            g.capture_end()
        self.segments.append(g)
        if self.pool is None:
            self.pool = g.pool()
        if _call(_COUNT, g.raw_cuda_graph())[0]:
            self.frames[-1].append(("seg", g))

    def abort(self) -> None:
        if self.seg is not None:
            with contextlib.suppress(Exception):
                self.seg.capture_end()
            self.seg = None

    def slot(self, site: Site) -> int:
        for i, s in enumerate(self.sites):
            if s is site:
                return i
        if len(self.sites) == _SLOTS:
            raise RuntimeError(f"a graph holds at most {_SLOTS} distinct "
                               f"guarded bodies")
        self.sites.append(site)
        return len(self.sites) - 1

    def guard(self, flag: torch.Tensor, body: Callable[[], object],
              site: Site, kind: str = "if") -> None:
        if flag.dtype != torch.bool or flag.dim() != 0:
            raise TypeError("a guard's flag is a 0-d bool tensor")
        self.end()
        self.frames.append([])
        self.nested.append(_nothing())
        before = _snapshot()
        self.begin()
        body()
        if site.counted:
            self.counter[self.slot(site)].add_(1)
        self.end()
        total = _delta(before)
        site.record(_minus(total, self.nested.pop()))
        items = self.frames.pop()
        self.nested[-1] = _merge(self.nested[-1], total)
        self.frames[-1].append((kind, flag, items))
        self.flags.append(flag)
        self.guards += 1
        self.begin()


def _assemble(graph, items):
    """Chain ``items`` into ``graph``; returns its last node and the
    nodes added, the segments' own nodes included."""
    dep, nodes = None, 0
    for item in items:
        if item[0] == "seg":
            seg = item[1].raw_cuda_graph()
            dep = _call(_ADD_CHILD, graph, dep, seg)[0]
            nodes += _call(_COUNT, seg)[0]
            continue
        kind, flag, sub = item
        op = _ADD_IF if kind == "if" else _ADD_WHILE
        dep, body, handle = _call(op, graph, dep, flag.data_ptr())
        last, n = _assemble(body, sub)
        nodes += 2 + n
        if kind == "while":
            _call(_CLOSE_WHILE, body, last, flag.data_ptr(), handle)
            nodes += 1
    return dep, nodes


class _Graph:
    """An instantiated graph of a capture, with what keeps it valid: the
    segments (their memory pool), the flags it reads and its counters."""

    def __init__(self, cap: _Capture, top):
        self.device = cap.device
        self.segments, self.flags = cap.segments, cap.flags
        self.counter, self.sites, self.top = cap.counter, cap.sites, top
        self.graph = self.exec = None
        self.graph = _call(_CREATE)[0]
        self.nodes = _assemble(self.graph, cap.frames[0])[1]
        self.guards = cap.guards
        self.exec = _call(_INSTANTIATE, self.graph)[0]
        _call(_UPLOAD, self.exec,
              torch.cuda.current_stream(self.device).cuda_stream)

    def launch(self) -> None:
        _call(_LAUNCH, self.exec,
              torch.cuda.current_stream(self.device).cuda_stream)
        stats["launches"] += 1
        _add(self.top, 1)
        if self.sites:
            _pending[id(self)] = self

    def __del__(self):
        with contextlib.suppress(Exception):
            if self.exec:
                _call(_DESTROY_EXEC, self.exec)
            if self.graph:
                _call(_DESTROY, self.graph)


def capture(device, fn: Callable[[], object]):
    """``(graph, out)``: ``fn()`` captured on ``device`` (nothing runs;
    its guards become IF nodes) and what it returned. The tallies are as
    they were; :attr:`_Graph.launch` and :func:`settle` count what the
    card runs."""
    global _capture
    if _capture is not None:
        raise RuntimeError("device-loop captures do not nest")
    _lib()
    t0 = time.perf_counter()
    torch.cuda.synchronize(device)
    before = _snapshot()
    cap = _Capture(device)
    _capture = cap
    try:
        with torch.cuda.stream(cap.stream):
            try:
                cap.begin()
                out = fn()
                cap.end()
            except BaseException:
                cap.abort()     # on the stream the capture began on
                raise
    finally:
        _capture = None
        total = _delta(before)
        _restore(before)
    graph = _Graph(cap, _minus(total, cap.nested[0]))
    torch.cuda.synchronize(device)
    stats["graphs"] += 1
    stats["capture_s"] += time.perf_counter() - t0
    stats["nodes"] += graph.nodes
    stats["guards"] += graph.guards
    return graph, out


def settle() -> None:
    """Read the counters of every graph launched since the last settle,
    in one read, and add each guarded body's share to the tallies."""
    settle_later()()


def settle_later() -> Callable[[], None]:
    """:func:`settle` in two halves, for a caller that must not wait on
    the card now: enqueue the counters' copy into pinned host memory, an
    event after it and the counters' reset, and return the function that
    waits for that event and adds the counts to the tallies."""
    graphs = list(_pending.values())
    _pending.clear()
    if not graphs:
        return lambda: None
    counters = torch.cat([g.counter[:len(g.sites)] for g in graphs])
    host = torch.empty(counters.shape, dtype=counters.dtype,
                       pin_memory=True)
    host.copy_(counters, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(counters.device))
    for g in graphs:
        g.counter.zero_()

    def finish():
        copied.synchronize()
        stats["reads"] += 1
        counts = host.tolist()
        i = 0
        for g in graphs:
            for site in g.sites:
                _add(site.delta, int(counts[i]))
                i += 1

    return finish


def _scratch(state):
    """A copy of ``state`` (a tensor, or a list of them)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    return [t.clone() for t in state]


def warm_up(fn: Callable, u, v):
    """Run ``fn(u', v)`` once with the eager executor, uncounted, ``u'``
    a scratch copy of the state ``u`` and ``v`` the run's spare (which
    nothing reads before a body writes it), so that what a capture needs
    done once for real (a library's first call, a cache) is done without
    touching the run's state and with one grid of scratch. Returns
    ``(u', out, guards)``: the copy, what ``fn`` returned, and the
    guarded bodies a capture of the call would hold. A loop captured on
    buffers in the other order (the state in its second buffer, as a
    stream meets it after a chunk that flipped them) warms up on the
    buffers in the run's order: its ``prepare`` takes them as
    ``warm``."""
    before, reads, planned = _snapshot(), stats["reads"], _planned[0]
    scratch = _scratch(u)
    with eager():
        out = fn(scratch, v)
    torch.cuda.synchronize()
    guards = _planned[0] - planned
    _restore(before)
    stats["reads"] = reads
    return scratch, out, guards


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def _holds(flag: torch.Tensor) -> bool:
    return bool(read(flag)[0])


def guard(flag: torch.Tensor, body: Callable[[], object],
          site: Site) -> None:
    """Run ``body()`` where the 0-d bool tensor ``flag`` holds: under a
    capture an IF node reads it on the card, otherwise the host does."""
    if _capture is not None:
        _capture.guard(flag, body, site)
        return
    _planned[0] += 1
    if _holds(flag):
        body()


def repeat(flag: torch.Tensor, body: Callable[[], object], most: int,
           site: Site, on_test: Optional[Callable[[], None]] = None) -> None:
    """``while flag: body()``, where the body clears ``flag`` after
    ``most`` runs at the latest. Under a capture, one body behind a WHILE
    node, which the card runs again while the flag holds; otherwise the
    host tests the flag before each body and once after the last,
    calling ``on_test()`` at each test, and raises past ``most``."""
    if _capture is not None:
        _capture.guard(flag, body, site, kind="while")
        return
    _planned[0] += 1
    for n in range(most + 1):
        if on_test is not None:
            on_test()
        if not _holds(flag):
            return
        if n == most:
            raise RuntimeError(f"{site.name}: the flag still holds after "
                               f"{most} bodies")
        body()


def _same(a, b) -> bool:
    """Are two states (tensors, or lists of them) the same buffers?"""
    if isinstance(a, torch.Tensor):
        return a is b
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _flips(u, v, out) -> bool:
    """Did a body on ``(u, v)`` leave the state in ``v``?"""
    if _same(out[0], u) and _same(out[1], v):
        return False
    if _same(out[0], v) and _same(out[1], u):
        return True
    raise RuntimeError("a loop body must leave the state in one of its two "
                       "buffers and the other as its spare")


# ---------------------------------------------------------------------------
# The loops
# ---------------------------------------------------------------------------

class WindowLoop:
    """The converge loop on the card: check windows of ``ci`` steps while
    ``res >= eps`` and ``k < full_steps`` (``res`` seeded with +inf, so a
    NaN residual stops it), the state ``(k, res)`` and the flag on the
    card.

    ``msr(u, v, ci) -> (u, v, res)`` advances a window. On the card
    :meth:`prepare` captures :data:`WINDOW_COPIES` guarded windows (one
    where a window nests loops of its own, never more than the run has
    windows, and an even number where a window flips the buffers), and
    :meth:`run` replays
    them with one replay in flight ahead of the host's one read a
    replay. Elsewhere the eager executor runs the same copies, the host
    reading each guard and the state once a replay. :meth:`run` returns
    ``(u, v, k, res)``, ``(u, v)`` the buffers in the order the windows
    left them."""

    def __init__(self, msr, *, ci: int, eps: float, full_steps: int):
        self.msr, self.ci, self.eps = msr, ci, eps
        self.full_steps = full_steps
        self.copies = WINDOW_COPIES
        self.graph = self.flip = self.st = None
        self.runs = 0
        # The windows the card ran are k / ci: no counter of their own.
        self.site = Site("converge window", counted=False)

    def _close(self, r: torch.Tensor) -> None:
        """End a window with its residual ``r`` (0-d float32): ``k +=
        ci``, ``res = r``, the flag ``res >= eps and k < full_steps``. On
        the card one thread of ``heat_graph_window``; its plain version
        on the CPU."""
        st = self.st
        if st.device.type == "cuda":
            if r.dtype != torch.float32 or r.numel() != 1:
                raise TypeError("a window's residual is a float32 scalar")
            lib = _lib()
            _check(lib, "heat_graph_window", lib.heat_graph_window(
                r.data_ptr(), st.data_ptr(), self.live.data_ptr(), self.ci,
                self.eps, float(self.full_steps),
                torch.cuda.current_stream(st.device).cuda_stream))
            return
        st[1].copy_(r)
        st[0].add_(self.ci)
        torch.logical_and(st[1] >= self.eps, st[0] < self.full_steps,
                          out=self.live)

    def _window(self, u, v):
        u2, v2, r = self.msr(u, v, self.ci)
        self._close(r)
        return u2, v2

    def _learn(self, flip: bool) -> None:
        """The order table's length, and the copies a graph must hold to
        chain from replay to replay."""
        self.flip = flip
        if flip and self.copies % 2:
            self.copies += 1

    def _bodies(self, u, v) -> None:
        """The guarded copies; copy ``i`` on the buffers ``i`` windows
        leave (the first run on the eager executor learns the order)."""
        order = ((u, v), (v, u))

        def body(i):
            a, b = order[i % 2] if self.flip else order[0]
            out = self._window(a, b)
            if self.flip is None:
                self._learn(_flips(a, b, out))
            elif _flips(a, b, out) != self.flip:
                raise RuntimeError("a window left the buffers in another "
                                   "order than the first one did")

        i = 0
        while i < self.copies:
            guard(self.live, lambda i=i: body(i), self.site)
            i += 1

    def prepare(self, u, v, warm=None) -> None:
        """Before the clock: the state on ``u``'s device and, on the card,
        a warm-up on a scratch copy of ``u`` (of ``warm[0]``, with
        ``warm[1]`` the spare, where given) and the window graph on
        ``(u, v)``."""
        device = _first(u).device
        self.st = torch.tensor([0.0, float("inf")], dtype=torch.float64,
                               device=device)
        self.live = torch.tensor(self.full_steps > 0, device=device)
        # The state a run starts from, copied in before every run but
        # the first (a stream replays one loop chunk after chunk).
        self.start = (self.st.clone(), self.live.clone())
        if self.full_steps <= 0 or not on_card(_first(u)):
            return
        wu, wv = warm if warm is not None else (u, v)
        a, out, nested = warm_up(
            lambda a, b: self.msr(a, b, self.ci), wu, wv)
        if nested:
            self.copies = 1
        self.copies = min(self.copies, self.full_steps // self.ci)
        self._learn(_flips(a, wv, out[:2]))
        self.pinned = [torch.empty(2, dtype=torch.float64, pin_memory=True)
                       for _ in range(2)]
        self.graph, _ = capture(device, lambda: self._bodies(u, v))

    def flips(self) -> Optional[bool]:
        """Does a run that does not stop early leave the state in the
        other buffer? None where no graph binds the order."""
        if self.graph is None:
            return None
        return bool(self.flip and (self.full_steps // self.ci) % 2)

    def run(self, u, v):
        if self.st is None:
            self.prepare(u, v)
        if self.full_steps <= 0:
            return u, v, 0, float("inf")
        if self.runs:
            # Enqueued copies from the start state: no host read.
            self.st.copy_(self.start[0])
            self.live.copy_(self.start[1])
        self.runs += 1
        k, res = (self._run_graph() if self.graph is not None
                  else self._run_eager(u, v))
        k = int(k)
        if self.graph is not None:
            _add(self.site.delta, k // self.ci)
        if self.flip and (k // self.ci) % 2:
            u, v = v, u
        return u, v, k, res

    def _stops(self, k, res) -> bool:
        return not (res >= self.eps and k < self.full_steps)

    def _run_eager(self, u, v):
        while True:
            self._bodies(u, v)
            k, res = read(self.st)
            if self._stops(k, res):
                return k, res

    def _run_graph(self):
        replays = -(-self.full_steps // (self.ci * self.copies))
        stream = torch.cuda.current_stream(self.st.device)
        done = [torch.cuda.Event(), torch.cuda.Event()]

        def issue(i):
            self.graph.launch()
            self.pinned[i % 2].copy_(self.st, non_blocking=True)
            done[i % 2].record(stream)

        issue(0)
        issued = 1
        for i in range(replays):
            if issued < replays:
                issue(issued)       # one replay in flight ahead of the read
                issued += 1
            done[i % 2].synchronize()
            stats["reads"] += 1
            k, res = self.pinned[i % 2].tolist()
            if self._stops(k, res):
                return k, res
        raise RuntimeError("the window loop ran out of replays with its "
                           "flag still set")


class PeriodLoop:
    """A fixed run of ``steps`` steps of ``ms(u, v, n) -> (u, v)``. On the
    card, :meth:`prepare` captures ``period`` steps (which must leave the
    buffers in their order: two rounds, two implicit steps) and the
    remainder, and :meth:`run` replays them; nothing is read. Elsewhere,
    ``ms(u, v, steps)``."""

    def __init__(self, ms, *, steps: int, period: int):
        self.ms, self.steps, self.period = ms, steps, period
        self.graphs = None

    def prepare(self, u, v, warm=None) -> None:
        if self.steps <= 0 or not on_card(_first(u)):
            return
        device = _first(u).device
        full, rem = divmod(self.steps, self.period)
        warm_up(lambda a, b: self.ms(a, b, self.period if full else rem),
                *(warm if warm is not None else (u, v)))
        self.graphs = []
        if full:
            g, out = capture(device, lambda: self.ms(u, v, self.period))
            if _flips(u, v, out):
                raise RuntimeError(f"{self.period} steps must leave the "
                                   f"buffers in their order")
            self.graphs += [g] * full
        self.end, self.start = (u, v), u
        if rem:
            g, self.end = capture(device, lambda: self.ms(u, v, rem))
            self.graphs.append(g)

    def flips(self) -> Optional[bool]:
        """Does a run leave the state in the other buffer? None where no
        graph binds the order."""
        if self.graphs is None:
            return None
        return not _same(self.end[0], self.start)

    def run(self, u, v):
        if self.steps <= 0:
            return u, v
        if self.graphs is None:
            return self.ms(u, v, self.steps)
        for g in self.graphs:
            g.launch()
        return self.end


def _first(state) -> torch.Tensor:
    return state if isinstance(state, torch.Tensor) else state[0]
