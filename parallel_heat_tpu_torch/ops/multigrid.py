"""Geometric-multigrid V-cycle behind the implicit time integrators.

The port of ``parallel_heat_tpu/ops/multigrid.py``, single device. The
implicit schemes (``HeatConfig.scheme = "backward_euler" |
"crank_nicolson"``) solve, every step, the linear system

    A u' = b,   A = I - theta*L,   L u = cx*(uE + uW - 2u)
                                       + cy*(uN + uS - 2u)

(theta = 1 for backward Euler with ``b = u``; theta = 1/2 for
Crank-Nicolson), which is unconditionally stable. The solver is a
textbook V(nu, nu) cycle: weighted-Jacobi smoothing (omega = 0.8),
full-weighting restriction centred on the vertex map ``fine = 2*coarse +
1``, bilinear prolongation, rediscretised coarse operators (level ``l``
carries ``theta*c / 4**l``) and ``_COARSE_SWEEPS`` extra sweeps on the
coarsest level. Cycles repeat until ``max|b - A u| <= mg_tol * max|b|``
or ``mg_cycles`` ran. Everything is float32, and the state is written
once per step, interior only.

As in the JAX package, the smoother, the residual and the norms are plain
array code; the two transfer operators are kernels:

- :func:`restrict` launches ``heat_mg_restrict``
  (csrc/heat_mg_restrict.cu: a few coarse cells a thread, each thread
  reading its fine window once), the counterpart of the Pallas kernel of
  that name; its plain version is :func:`restrict_full_weighting`;
- :func:`prolong` launches ``heat_mg_prolong`` (csrc/heat_mg_prolong.cu:
  a thread a coarse cell, writing the 2 x 2 fine cells it spans); its
  plain version is :func:`prolong_bilinear`.

A V-cycle issues them at a few microseconds of card time each, so their
host cost is the call: each wrapper finds a launch record
(:class:`TransferLaunch`, built and checked once per source shape,
dtype, device and output shape by :func:`transfer_record`) and makes one
``torch.empty`` and one ``ctypes`` call of four pointers. Each wrapper
takes its plain version only because the tensor it was given lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
:func:`transfer_ops` is the one decision site: the wrappers for
``backend="cuda"``, the plain versions for ``backend="torch"``. A kernel
and its plain version agree bitwise (every multiply is by a power of two
and the adds associate alike), so the two backends do.

Every level operation takes full arrays (Dirichlet ring included) with
any number of leading member axes, so the ensemble engine's batched
V-cycle is this same code on a ``(B, M, N)`` stack: a member of it is
bitwise the solo solve (:func:`_step_fn` freezes each member at its own
cycle verdict).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from parallel_heat_tpu_torch.config import HeatConfig, multigrid_level_shapes
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.utils import device_loop

# Weighted-Jacobi damping, fixed: it shapes the rate of convergence, never
# the converged answer.
_OMEGA = 0.8

# Extra smoothing sweeps in place of an exact coarsest-level solve: the
# rediscretised coefficients shrink 4x per level, so the coarsest operator
# is strongly diagonally dominant.
_COARSE_SWEEPS = 8

# What the step solves of this process did since the last reset_stats():
# implicit steps, V-cycles, and reads of a device value on the host (one
# per evaluation of the cycle loop's stopping test where the host
# evaluates it; none where the card does). A replayed graph counts its
# steps and cycles through ``device_loop.settle``.
stats = {"steps": 0, "cycles": 0, "host_syncs": 0}
device_loop.register_tally(stats, skip=("host_syncs",))


def reset_stats() -> None:
    for name in stats:
        stats[name] = 0


def scheme_theta(scheme: str) -> float:
    """The implicit weight theta of ``A = I - theta*L``."""
    return 0.5 if scheme == "crank_nicolson" else 1.0


def level_coefficients(config: HeatConfig):
    """``[(shape, ax, ay), ...]`` finest first: the hierarchy's shapes
    (``config.multigrid_level_shapes``) with the rediscretised operator
    coefficients ``theta*c / 4**l``."""
    theta = scheme_theta(config.scheme)
    shapes = multigrid_level_shapes(config.shape, config.mg_levels)
    return [(s, theta * config.cx / 4.0 ** l, theta * config.cy / 4.0 ** l)
            for l, s in enumerate(shapes)]


# ---------------------------------------------------------------------------
# Level operations (full float32 arrays with the ring; leading member axes
# allowed)
# ---------------------------------------------------------------------------

def _lap_interior(u, ax: float, ay: float):
    """``theta*L u`` on the interior, in the JAX package's spelling
    ``(up - c) + (down - c)``: no multiply inside the neighbour sums and
    one multiply per axis term."""
    c = u[..., 1:-1, 1:-1]
    tx = ax * ((u[..., 2:, 1:-1] - c) + (u[..., :-2, 1:-1] - c))
    ty = ay * ((u[..., 1:-1, 2:] - c) + (u[..., 1:-1, :-2] - c))
    return tx + ty


def apply_A_interior(u, ax: float, ay: float):
    """``(I - theta*L) u`` on the interior of a full level array."""
    return u[..., 1:-1, 1:-1] - _lap_interior(u, ax, ay)


def residual_interior(u, b, ax: float, ay: float):
    """``b - A u`` on the interior, spelled ``(b - u) + theta*L u``."""
    return ((b[..., 1:-1, 1:-1] - u[..., 1:-1, 1:-1])
            + _lap_interior(u, ax, ay))


def _max_abs(x):
    """Max-norm over the last two axes (NaN-propagating)."""
    return x.abs().amax(dim=(-2, -1))


def residual_norm(u, b, ax: float, ay: float):
    """Interior max-norm of ``b - A u``: the V-cycle's convergence
    quantity, one value per member."""
    return _max_abs(residual_interior(u, b, ax, ay))


def smooth(u, b, ax: float, ay: float):
    """One weighted-Jacobi sweep ``u += omega * (b - A u) / diag A`` into
    a new array; the ring is carried over untouched."""
    d = 1.0 + 2.0 * ax + 2.0 * ay
    new = (u[..., 1:-1, 1:-1]
           + (_OMEGA / d) * residual_interior(u, b, ax, ay))
    out = u.clone()
    out[..., 1:-1, 1:-1] = new
    return out


def _pad_ring(x):
    return F.pad(x, (1, 1, 1, 1))


def _restrict_interior(r, mc: int, nc: int):
    """The full-weighting interior expression: coarse interior vertex
    ``j`` sits at fine full index ``2j + 2``; the 1/16 tensor stencil as
    two [1 2 1]/4 passes, rows first, associated ``(a + 2b) + c``."""
    rows = 0.25 * (r[..., 1:2 * mc:2, :] + 2.0 * r[..., 2:2 * mc + 2:2, :]
                   + r[..., 3:2 * mc + 3:2, :])
    return 0.25 * (rows[..., 1:2 * nc:2] + 2.0 * rows[..., 2:2 * nc + 2:2]
                   + rows[..., 3:2 * nc + 3:2])


def restrict_full_weighting(r, coarse_shape: Tuple[int, int]):
    """Plain version of :func:`restrict`: full-weighting restriction of a
    full fine array ``r`` (ring included) onto the full coarse array
    (zero ring)."""
    sk.counts["restrict_full_weighting"] += 1
    mc, nc = coarse_shape[0] - 2, coarse_shape[1] - 2
    return _pad_ring(_restrict_interior(r, mc, nc))


def _prolong_rows(c, mf: int):
    """Bilinear interpolation along the second-to-last axis: full coarse
    rows (ring included, ``mc + 2``) to ``mf`` fine interior rows. Odd
    fine rows copy their coarse row; even fine rows average the two
    flanking coarse rows (the ring supplies the Dirichlet zero)."""
    mc = c.shape[-2] - 2
    ev = 0.5 * (c[..., 0:mc + 1, :] + c[..., 1:mc + 2, :])  # rows 0, 2, ..
    od = c[..., 1:mc + 1, :]                                 # rows 1, 3, ..
    core = torch.stack([ev[..., :mc, :], od], dim=-2).reshape(
        c.shape[:-2] + (2 * mc, c.shape[-1]))
    if mf == 2 * mc + 1:
        core = torch.cat([core, ev[..., mc:mc + 1, :]], dim=-2)
    return core


def prolong_bilinear(c, fine_interior: Tuple[int, int]):
    """Plain version of :func:`prolong`: bilinear prolongation of a full
    coarse array (ring included) to a full fine array with a zero ring,
    the correction to add to the fine iterate. Row pass first; the column
    pass averages two row-pass results."""
    sk.counts["prolong_bilinear"] += 1
    mf, nf = fine_interior
    rows = _prolong_rows(c, mf)
    cols = _prolong_rows(rows.transpose(-1, -2), nf).transpose(-1, -2)
    return _pad_ring(cols)


# ---------------------------------------------------------------------------
# The transfer kernels' launch records and wrappers
# ---------------------------------------------------------------------------

RESTRICT, PROLONG = "heat_mg_restrict", "heat_mg_prolong"


class _TransferArgs(ctypes.Structure):
    """A launch record's C half (``csrc/heat_mg.cuh`` ``HeatMgTransfer``),
    handed to the launcher by address."""

    _fields_ = [("batch", ctypes.c_int64), ("src_rows", ctypes.c_int64),
                ("src_cols", ctypes.c_int64), ("dst_rows", ctypes.c_int64),
                ("dst_cols", ctypes.c_int64), ("block_x", ctypes.c_int32),
                ("block_y", ctypes.c_int32), ("cells_y", ctypes.c_int32),
                ("cells_x", ctypes.c_int32)]


def _check_transfer(name: str, x: torch.Tensor, out_shape) -> tuple:
    """Validate transfer ``name`` of ``x`` (full arrays, leading member
    axes allowed) onto full arrays of ``out_shape``; returns the leading
    shape."""
    what = "restrict" if name == RESTRICT else "prolong"
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: float32 arrays only, got {x.dtype}")
    if x.dim() < 2 or min(x.shape[-2:]) < 3 or min(out_shape) < 3:
        raise ValueError(f"{what}: need full arrays of at least 3 x 3 (one "
                         f"interior cell), got {tuple(x.shape)} -> "
                         f"{tuple(out_shape)}")
    lead = tuple(x.shape[:-2])
    if x.numel() == 0:
        raise ValueError(f"{what}: empty batch {tuple(x.shape)}")
    if name == RESTRICT:
        mc, nc = out_shape[0] - 2, out_shape[1] - 2
        if 2 * mc > x.shape[-2] - 2 or 2 * nc > x.shape[-1] - 2:
            raise ValueError(f"restrict: coarse interior {(mc, nc)} is more "
                             f"than half the fine interior of "
                             f"{tuple(x.shape[-2:])}")
    else:
        for nf, nc in zip(out_shape, x.shape[-2:]):
            if (nf - 2) - 2 * (nc - 2) not in (0, 1):
                raise ValueError(f"prolong: fine shape {tuple(out_shape)} is "
                                 f"not twice the coarse interior of "
                                 f"{tuple(x.shape[-2:])}, or one more")
    if (x.device.type == "cuda"
            and x.device.index != torch.cuda.current_device()):
        raise ValueError(f"array on {x.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return lead


def transfer_geometry(name: str, out_shape, geometry=None):
    """``(block, cells, grid)`` of one launch of transfer kernel ``name``
    writing full arrays of ``out_shape`` (rows, columns), as the C
    launcher computes them: the thread block (lanes along a row, rows),
    the cells a thread takes and the thread blocks a member (x, y).
    Restrict: ``cells`` coarse cells (rows, columns) a thread,
    ``hopper_params.mg_restrict_cells`` (2 x 2 on levels of a wave of
    cells or more, else 1 x 1); prolong: one coarse cell a
    thread, whose 2 x 2 fine cells it writes, so a member is
    ``ceil(rows / 2) x ceil(cols / 2)`` threads. ``geometry`` ``(block,
    cells)`` overrides the parameters (the sweep's shapes)."""
    p = params()
    if geometry is not None:
        block, cells = (tuple(int(v) for v in g) for g in geometry)
    elif name == RESTRICT:
        block = tuple(p.mg_restrict_block)
        cells = p.mg_restrict_cells(out_shape)
    else:
        block, cells = tuple(p.mg_prolong_block), (1, 1)
    rows, cols = out_shape
    if name == PROLONG:
        threads = (-(-cols // 2), -(-rows // 2))
    else:
        threads = (-(-cols // cells[1]), -(-rows // cells[0]))
    grid = (-(-threads[0] // block[0]), -(-threads[1] // block[1]))
    return block, cells, grid


def _stream(device: torch.device) -> int:
    """The current stream's handle on ``device``, by PyTorch's raw getter
    (what its own compiled kernels launch with), which builds no
    ``torch.cuda.Stream``: 0.2 µs a call against 4.8 for
    ``torch.cuda.current_stream(device).cuda_stream``
    (``tools/launch_cost.py``, PERF.md section 3), a quarter of a
    transfer call's host time."""
    return torch._C._cuda_getCurrentRawStream(device.index)


class TransferLaunch:
    """The launch record of a transfer kernel at one geometry: ``name``
    (:data:`RESTRICT` or :data:`PROLONG`) from stacks of ``lead`` arrays
    of ``src_shape`` onto new arrays of ``dst_shape`` on ``device``.

    The shapes are checked against the kernel's rules, the grid and the
    C record (:class:`_TransferArgs`) laid out once, here; the library is
    loaded at the first launch. A call is then one ``torch.empty``, the
    current stream and one ``ctypes`` call of four pointers. Nothing here
    checks the tensors a launch is given: :func:`transfer_record` keys
    the record by their shape, type and device. ``geometry`` ``(block,
    cells)`` overrides the parameters (:func:`transfer_geometry`)."""

    __slots__ = ("name", "device", "out_shape", "block", "cells", "grid",
                 "_args", "_addr", "_lib", "_fn")

    def __init__(self, name: str, lead, src_shape, dst_shape, device,
                 geometry=None):
        if name not in (RESTRICT, PROLONG):
            raise ValueError(f"unknown transfer kernel {name!r}")
        lead, src_shape, dst_shape = (tuple(int(n) for n in s)
                                      for s in (lead, src_shape, dst_shape))
        batch = 1
        for n in lead:
            batch *= n
        self.block, self.cells, self.grid = transfer_geometry(
            name, dst_shape, geometry)
        allowed = ((1, 1), (1, 2), (2, 2)) if name == RESTRICT else ((1, 1),)
        if self.cells not in allowed:
            raise ValueError(f"{name}: cells a thread must be one of "
                             f"{allowed}, got {self.cells}")
        if (min(self.block) < 1 or self.block[0] * self.block[1] > 1024
                or batch > 65535 or self.grid[1] > 65535):
            raise ValueError(f"{name}: {batch} arrays and a grid of "
                             f"{self.grid} blocks of {self.block} threads "
                             f"exceed the launch's limits (65535 arrays, "
                             f"65535 block rows, 1024 threads)")
        self.name = name
        self.device = torch.device(device)
        self.out_shape = lead + dst_shape
        self._args = _TransferArgs(batch, *src_shape, *dst_shape,
                                   *self.block, *self.cells)
        self._addr = ctypes.addressof(self._args)
        self._lib = self._fn = None

    def launch(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """One launch from the contiguous ``src`` into ``dst``, both of
        this record's shapes on its device; raises if the launch is
        refused. Checks nothing and counts nothing."""
        if self._fn is None:
            from parallel_heat_tpu_torch.kernels.build import load

            self._lib = load(self.name)
            self._fn = getattr(self._lib, self.name)
        code = self._fn(self._addr, src.data_ptr(), dst.data_ptr(),
                        _stream(self.device))
        if code:
            sk._raise_on_error(self._lib, self.name, code)

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        """The kernel on the contiguous ``src`` into a new array; counts
        the launch."""
        out = torch.empty(self.out_shape, dtype=torch.float32,
                          device=self.device)
        self.launch(src, out)
        sk.counts[self.name] += 1
        return out


# Launch records by (kernel, source shape, dtype, device, output shape);
# cleared when full, since a process rarely meets more than a few
# hierarchies.
_records: dict = {}
_RECORDS_MAX = 256


def transfer_record(name: str, x: torch.Tensor, out_shape):
    """The launch record of transfer ``name`` for the source ``x`` onto
    full arrays of ``out_shape``, or None for a tensor on the CPU. The
    first call for a (shape, dtype, device, output shape) checks them
    (raising as :func:`restrict` and :func:`prolong` document) and builds
    the record; later calls find it. Every call checks that ``x`` lies on
    the current device."""
    key = (name, x.shape, x.dtype, x.device, out_shape)
    try:
        rec = _records.get(key)
    except TypeError:                   # an unhashable shape (a list)
        key = key[:-1] + (tuple(out_shape),)
        rec = _records.get(key)
    if rec is None:
        out_shape = tuple(int(n) for n in out_shape)
        lead = _check_transfer(name, x, out_shape)
        if x.device.type == "cpu":
            return None
        rec = TransferLaunch(name, lead, x.shape[-2:], out_shape, x.device)
        if len(_records) >= _RECORDS_MAX:
            _records.clear()
        _records[key] = rec
    elif x.device.index != torch.cuda.current_device():
        raise ValueError(f"array on {x.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return rec


def _launch_transfer(name, src, dst, geometry=None) -> None:
    """One launch of ``heat_mg_restrict`` or ``heat_mg_prolong`` from the
    contiguous stack ``src`` into ``dst`` at ``geometry`` (``(block,
    cells)``, the parameters' by default), through a record of its own;
    raises if the launch is refused. Checks nothing else and counts
    nothing."""
    TransferLaunch(name, src.shape[:-2], src.shape[-2:], dst.shape[-2:],
                   src.device, geometry).launch(src, dst)


def restrict(r: torch.Tensor, coarse_shape: Tuple[int, int]) -> torch.Tensor:
    """Kernel ``heat_mg_restrict``: full-weighting restriction of the full
    fine array ``r`` (ring included; leading member axes allowed) onto a
    new full coarse array of ``coarse_shape`` with a zero ring."""
    rec = transfer_record(RESTRICT, r, coarse_shape)
    if rec is None:
        return restrict_full_weighting(r, tuple(coarse_shape))
    return rec(r if r.is_contiguous() else r.contiguous())


def prolong(c: torch.Tensor, fine_shape: Tuple[int, int]) -> torch.Tensor:
    """Kernel ``heat_mg_prolong``: bilinear prolongation of the full
    coarse array ``c`` (ring included; leading member axes allowed) onto a
    new full fine array of ``fine_shape`` with a zero ring. Each fine
    interior extent must be twice the coarse one, or one more."""
    rec = transfer_record(PROLONG, c, fine_shape)
    if rec is None:
        return prolong_bilinear(c, (fine_shape[0] - 2, fine_shape[1] - 2))
    return rec(c if c.is_contiguous() else c.contiguous())


def transfer_ops(backend: str):
    """``(restrict(r, coarse_shape), prolong(c, fine_shape))``: the one
    decision site for the transfer spelling. ``backend="cuda"`` takes the
    kernels' wrappers (which serve a CPU tensor with their plain
    versions), ``backend="torch"`` the plain versions."""
    if backend == "cuda":
        return restrict, prolong
    return (restrict_full_weighting,
            lambda c, fine_shape: prolong_bilinear(
                c, (fine_shape[0] - 2, fine_shape[1] - 2)))


# ---------------------------------------------------------------------------
# The V-cycle and the implicit step
# ---------------------------------------------------------------------------

def _cycle_from_levels(levels, nu: int, restrict, prolong):
    """``vcycle(u, b) -> u`` over an explicit ``[(shape, ax, ay), ...]``
    hierarchy (finest first)."""

    def cycle(l, u, b):
        shape, ax, ay = levels[l]
        for _ in range(nu):
            u = smooth(u, b, ax, ay)
        if l + 1 < len(levels):
            cshape = levels[l + 1][0]
            r = _pad_ring(residual_interior(u, b, ax, ay))
            ec = cycle(l + 1, u.new_zeros(u.shape[:-2] + tuple(cshape)),
                       restrict(r, cshape))
            # The prolonged correction carries a zero ring, so the
            # boundary bits of u are exact through the add.
            u = u + prolong(ec, shape)
            for _ in range(nu):
                u = smooth(u, b, ax, ay)
        else:
            for _ in range(_COARSE_SWEEPS):
                u = smooth(u, b, ax, ay)
        return u

    return lambda u, b: cycle(0, u, b)


def _vcycle_fn(config: HeatConfig, backend: str):
    """``vcycle(u, b) -> u`` for the finest level."""
    restrict_, prolong_ = transfer_ops(backend)
    return _cycle_from_levels(level_coefficients(config), config.mg_smooth,
                              restrict_, prolong_)


def _rhs_fn(config: HeatConfig):
    """``(rhs(u) -> b, finish(x, u) -> u')`` for the scheme. Backward
    Euler solves ``A u' = u``. Crank-Nicolson solves ``(I - L/2) v = 2u``
    and sets ``u' = v - u``, algebraically ``(I - L/2) u' = (I + L/2) u``
    with an exact right-hand side and finish, as the JAX package does."""
    if config.scheme == "crank_nicolson":
        return (lambda u: 2.0 * u), (lambda x, u: x - u)
    return (lambda u: u), (lambda x, u: x)


def _solve(config: HeatConfig, backend: str, tally=stats,
           trace: bool = False):
    """``solve(b) -> (x, cycles, res0, bmax, trace)``: V-cycles from the
    initial guess ``b`` until every member's verdict, under the rule of
    the JAX loop (continue while ``res > tol`` and ``cycles <
    mg_cycles``, per member; a NaN residual ends it). A member that is
    done keeps its iterate, residual and cycle count while the others go
    on. The cycles run while a flag on the card holds
    (``utils/device_loop.repeat``): under a capture, one cycle behind a
    WHILE node, and nothing is read; otherwise the host reads the flag
    once per evaluation of the stopping test, counted with the cycles in
    ``tally``. With ``trace``, ``trace`` is the list of per-cycle
    residuals (an eager run only: it is observation)."""
    _, ax, ay = level_coefficients(config)[0]
    vcycle = _vcycle_fn(config, backend)
    tol_rel = config.mg_tol
    max_cycles = config.mg_cycles
    site = device_loop.Site("multigrid V-cycle")

    def solve(b):
        batched = b.dim() > 2
        bmax = _max_abs(b[..., 1:-1, 1:-1])
        tol = tol_rel * bmax
        res0 = residual_norm(b, b, ax, ay)
        # The loop's state, updated in place by each cycle.
        x, res = b.clone(), res0.clone()
        cycles = torch.zeros_like(res, dtype=torch.int32)
        live = (res > tol) & (cycles < max_cycles)
        go = live.any() if batched else live
        kept = []

        def cycle():
            x_new = vcycle(x, b)
            res_new = residual_norm(x_new, b, ax, ay)
            if batched:
                x.copy_(torch.where(live[..., None, None], x_new, x))
                res.copy_(torch.where(live, res_new, res))
            else:
                x.copy_(x_new)
                res.copy_(res_new)
            cycles.add_(live.to(torch.int32))
            torch.logical_and(res > tol, cycles < max_cycles, out=live)
            if batched:
                go.copy_(live.any())
            if trace:
                kept.append(res.clone())
            tally["cycles"] += 1

        def test():
            tally["host_syncs"] += 1

        device_loop.repeat(go, cycle, max_cycles, site, on_test=test)
        return x, cycles, res0, bmax, kept

    return solve


def _step_fn(config: HeatConfig, backend: str):
    """One implicit step ``step(u, out) -> res`` from ``u`` into the
    distinct buffer ``out``, where ``res`` is the interior max-norm of
    the update (per member), the converge mode's quantity. Builds b,
    cycles to the verdict, and writes the interior once; the ring is
    carried over."""
    solve = _solve(config, backend)
    rhs, finish = _rhs_fn(config)

    def step(u, out):
        b = rhs(u)
        x = solve(b)[0]
        new = finish(x, u)[..., 1:-1, 1:-1]
        res = _max_abs(new - u[..., 1:-1, 1:-1])
        out.copy_(u)
        out[..., 1:-1, 1:-1] = new
        stats["steps"] += 1
        return res

    return step


def implicit_multistep(config: HeatConfig, backend: str = "torch"):
    """``(multi_step(u, v, n) -> (u, v), multi_step_residual(u, v, n) ->
    (u, v, res))``, the implicit counterpart of the explicit multistep
    families, consumed by the same loops: ``u`` holds the state, ``v`` is
    the spare buffer, and each returns them swapped as the steps left
    them. The residual is ``max |u' - u|`` over the interior of the last
    step. The transfer kernels of a CUDA run are loaded here, before any
    clock starts."""
    from parallel_heat_tpu_torch.solver import steps_to_multistep

    if backend == "cuda" and torch.device(config.device).type == "cuda":
        from parallel_heat_tpu_torch.kernels.build import load

        load("heat_mg_restrict")
        load("heat_mg_prolong")
    step = _step_fn(config, backend)
    return steps_to_multistep(step, step)


# ---------------------------------------------------------------------------
# Observation only
# ---------------------------------------------------------------------------

def cycle_trace(config: HeatConfig, grid, max_cycles=None,
                backend: str = "torch") -> dict:
    """Re-solve ONE implicit step from ``grid`` (a 2D tensor, never
    advanced) with the step's own loop and verdict, and report the cycle
    count, the per-cycle residuals and the mean contraction factor; the
    JAX package's ``cycle_trace`` keys. ``max_cycles`` caps the budget
    only when given."""
    config = config.validate()
    if max_cycles is not None:
        config = config.replace(mg_cycles=min(config.mg_cycles,
                                              int(max_cycles)))
    rhs, _ = _rhs_fn(config)
    u = torch.as_tensor(grid, dtype=torch.float32)
    # Observation only: its cycles do not join the run's counts.
    tally = {"cycles": 0, "host_syncs": 0}
    _, cycles, res0, bmax, trace = _solve(config, backend, tally,
                                          trace=True)(rhs(u))
    r0, bmax = float(res0), float(bmax)
    tol = config.mg_tol * bmax
    used = [float(r) for r in trace]
    ratios, prev = [], r0
    for r in used:
        if prev > 0.0:
            ratios.append(r / prev)
        prev = r
    contraction = None
    if ratios:
        p = 1.0
        for q in ratios:
            p *= q
        contraction = p ** (1.0 / len(ratios))
    return {"cycles": int(cycles), "tol": tol,
            "residual_first": r0,
            "residual_last": used[-1] if used else r0,
            "residuals": used,
            "contraction": contraction,
            "levels": len(multigrid_level_shapes(config.shape,
                                                 config.mg_levels)),
            "converged": bool(used[-1] <= tol if used else r0 <= tol)}


def level_wall_shares(config: HeatConfig, repeats: int = 3) -> list:
    """Measured wall share of one smoothing sweep a level, normalised to
    sum to 1 (rounded to 4 places): each level's sweep (:func:`smooth`)
    on ``config.device`` timed alone, the minimum of ``repeats``, by CUDA
    events on the card and by ``perf_counter`` on the CPU. Observation
    only; the first ``vcycle`` event of a stream carries it."""
    import time

    config = config.validate()
    dev = torch.device(config.device)
    walls = []
    for shape, ax, ay in level_coefficients(config):
        u = torch.zeros(shape, dtype=torch.float32, device=dev)
        b = torch.ones(shape, dtype=torch.float32, device=dev)
        smooth(u, b, ax, ay)  # first call outside the bracket
        best = float("inf")
        for _ in range(repeats):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                smooth(u, b, ax, ay)
                end.record()
                end.synchronize()
                wall = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                smooth(u, b, ax, ay)
                wall = time.perf_counter() - t0
            best = min(best, wall)
        walls.append(best)
    total = sum(walls) or 1.0
    return [round(w / total, 4) for w in walls]


def explain_hierarchy(config: HeatConfig, backend: str) -> dict:
    """The resolved implicit path for ``solver.explain``: scheme, theta,
    the level hierarchy, the smoother, the transfers and the stopping
    rule, from the structures :func:`implicit_multistep` builds."""
    levels = level_coefficients(config)
    if backend == "cuda":
        cells = sorted({params().mg_restrict_cells(s)
                        for s, _, _ in levels[1:]})
        transfers = ("cuda heat_mg_restrict (" + " or ".join(
            f"{a} x {b}" for a, b in cells) + " coarse cells a thread)/"
            "heat_mg_prolong (a coarse cell's 2 x 2 fine cells a thread), "
            "a launch record a level pair")
    else:
        transfers = "torch full-weighting/bilinear"
    return {
        "scheme": config.scheme,
        "theta": scheme_theta(config.scheme),
        "levels": [{"shape": list(s), "cx": ax, "cy": ay}
                   for s, ax, ay in levels],
        "smoother": (f"weighted-Jacobi(omega={_OMEGA}) "
                     f"V({config.mg_smooth},{config.mg_smooth}), "
                     f"{_COARSE_SWEEPS} coarsest sweeps"),
        "transfers": transfers,
        "cycle_stop": (f"max|b - A u| <= {config.mg_tol:g} * max|b| "
                       f"or {config.mg_cycles} cycles"),
        "sharding": "single device",
    }
