"""The batched ensemble engine proper (see the package docstring).

The JAX package compiles each dispatch into one program. Here a dispatch
is a Python loop over launches on one CUDA stream that reads nothing back
until its end: the per-member verdicts (``done``, ``res``, ``steps_at``)
and the step counter live on the device for the ``window_rounds`` check
windows of a dispatch and come to the host in ONE copy per dispatch.
The state lives in two ``(B, *shape)`` buffers that the launches
ping-pong, as in ``solver.solve``.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from parallel_heat_tpu_torch.config import EnsembleConfig, HeatConfig
from torch.profiler import record_function

from parallel_heat_tpu_torch.solver import (
    HeatResult,
    _observer_free,
    device_scope,
    resolve_backend,
    single_multistep,
    model_for,
    resolve_device,
    torch_multistep,
)
from parallel_heat_tpu_torch.utils.timing import Timer


class EnsembleInterrupted(Exception):
    """Raised by an ``on_boundary`` callback to stop the run at a
    consistent boundary; carries the assembled full-order state so the
    caller can keep it. ``reason`` is a signal name or a string such as
    ``"deadline"``."""

    def __init__(self, reason: str, state: dict):
        super().__init__(reason)
        self.reason = reason
        self.state = state


# ---------------------------------------------------------------------------
# Batched observers (the member-axis counterparts of solver.grid_all_finite
# and solver.grid_stats; observation only)
# ---------------------------------------------------------------------------

def ensemble_all_finite(grids) -> np.ndarray:
    """Per-member runtime guard: ``(B,)`` bools, True where every cell of
    the member is finite. One read of the stack (a member's extrema are
    finite exactly when its cells are), the verdicts read on the host."""
    with record_function("heat:ens_guard"):
        mn, mx = torch.aminmax(grids.reshape(grids.shape[0], -1), dim=1)
        return (torch.isfinite(mn) & torch.isfinite(mx)).cpu().numpy()


def ensemble_grid_stats(grids, prev=None) -> List[dict]:
    """Per-member grid diagnostics: a list of B dicts with the keys of
    ``solver.grid_stats``. Sums accumulate in float32 per member; a
    member's ``heat`` may differ in its last bits from a solo
    ``grid_stats`` (another reduction order): diagnostics are
    observations, not part of the bitwise member contract."""
    with record_function("heat:ens_diag"):
        B = grids.shape[0]
        flat = grids.reshape(B, -1)
        mn, mx = torch.aminmax(flat, dim=1)
        cols = [mn, mx, flat.sum(dim=1)]
        if prev is not None:
            d = flat - prev.reshape(B, -1)
            dmn, dmx = torch.aminmax(d, dim=1)
            cols += [torch.linalg.vector_norm(d, dim=1),
                     torch.maximum(dmx, -dmn)]
        host = torch.stack(cols, dim=1).double().cpu().tolist()
    return [{"min": r[0], "max": r[1], "heat": r[2],
             "update_l2": r[3] if prev is not None else None,
             "update_linf": r[4] if prev is not None else None}
            for r in host]


# ---------------------------------------------------------------------------
# Path selection
# ---------------------------------------------------------------------------

def ensemble_path(config: HeatConfig) -> str:
    """``"M"`` (the member-batched kernel) or ``"vmap"`` (the torch
    multistep over a leading member axis) for ``config``'s resolved
    backend. The ONE decision site: :func:`_batched_multistep` executes it
    and ``solver.explain(..., ensemble=B)`` reports it."""
    if config.scheme != "explicit":
        # The implicit V-cycle batches over the member axis, each member
        # frozen at its own cycle verdict; M is an explicit Jacobi kernel.
        return "vmap"
    backend = resolve_backend(config, torch.device(config.device))
    if backend == "cuda" and config.ndim == 2:
        from parallel_heat_tpu_torch.ops import batched

        return batched.pick_ensemble_2d(config.shape)
    return "vmap"


def packable(config: HeatConfig):
    """``(ok, reason)``: may jobs of this config be coalesced into one
    ensemble dispatch under the bitwise member-parity contract? True
    exactly when the batched path computes what the solo ``solve()``
    would: the torch backend, an implicit scheme (the batched V-cycle is
    the solo one over a member axis, transfers included), or the cuda
    backend where the solo picker takes kernel A (M steps with A's own
    code). Streaming kernels have no batched twin and run solo."""
    try:
        config = config.validate()
    except (ValueError, NotImplementedError) as e:
        return False, f"invalid config: {e}"
    if config.is_sharded():
        return False, "sharded configs run solo (no member axis across a mesh)"
    backend = resolve_backend(config, torch.device(config.device))
    if config.scheme != "explicit":
        return True, ("vmap over the implicit V-cycle multistep "
                      "(member-bitwise: each member is frozen at its own "
                      "cycle verdict, and the transfer kernels take the "
                      "member axis)")
    if backend == "torch":
        return True, "vmap over the torch multistep family (member-bitwise)"
    if ensemble_path(config) == "M":
        return True, "member-batched kernel M (bitwise the solo kernel A)"
    return False, ("solo cuda path has no member-bitwise batched twin "
                   "(streaming kernel, or kernel M's launch plan declined "
                   "the geometry)")


def _batched_multistep(config: HeatConfig):
    """``(multi_step(u, v, k), multi_step_residual(u, v, k), path)`` on a
    member-batched ``(B, *shape)`` state in two ping-pong buffers; the
    residual variant returns a ``(B,)`` residual vector."""
    path = ensemble_path(config)
    if path == "M":
        from parallel_heat_tpu_torch.ops import batched

        ms, msr = batched.ensemble_multistep(config)
        return ms, msr, "M"
    if config.scheme != "explicit":
        backend = resolve_backend(config, torch.device(config.device))
        ms, msr = single_multistep(config, backend)
    else:
        ms, msr = torch_multistep(*map(float, config.coefficients))
    return ms, msr, "vmap"


# ---------------------------------------------------------------------------
# Dispatches
# ---------------------------------------------------------------------------

def _converge_dispatch(msr, keeps_input: bool, ci: int, eps: float,
                       ndim: int, windows: int, u, v, done, res, steps_at,
                       k):
    """Up to ``windows`` check windows with per-member freeze, nothing
    read on the host. Per window: ``ci`` steps with the residual over the
    whole batch; members already done keep their bits (masked update),
    the others latch the window's residual and step count, and those
    whose residual fell below ``eps`` become done. Once every member is
    done the remaining windows change nothing and the step counter ``k``
    (a device scalar, the steps the live members share) stops, as the JAX
    runner's loop ends early. ``keeps_input`` says that ``msr`` leaves its
    input buffer as it was (kernel M: one launch); a multistep that
    ping-pongs through it needs the window's start state set aside."""
    mask_shape = (-1,) + (1,) * ndim
    for _ in range(windows):
        k = k + ci * (~done.all())
        old = u if keeps_input else u.clone()
        new, spare, r = msr(u, v, ci)
        # Frozen members keep their bits.
        new.copy_(torch.where(done.view(mask_shape), old, new))
        res = torch.where(done, res, r)
        steps_at = torch.where(done, steps_at, k)
        # Done once the residual is not above eps: a NaN stops the member
        # as it stops the solo loop (``while res >= eps``); whether it
        # converged is ``res < eps``, read where the member parks.
        done = done | ~(r >= eps)
        u, v = new, spare
    return u, v, done, res, steps_at, k


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class EnsembleResult:
    """Outcome of one ensemble run, in ORIGINAL member order (member i of
    the result is member i of the input, whatever the compaction
    history)."""

    grids: torch.Tensor              # (B, *shape)
    steps_run: np.ndarray            # (B,) int64
    converged: Optional[np.ndarray]  # (B,) bool, converge mode only
    residual: Optional[np.ndarray]   # (B,) float64, converge mode only
    elapsed_s: float
    # (B,) runtime-guard verdicts (``guard_interval``), else None.
    finite: Optional[np.ndarray] = None
    # B grid_stats samples (``diag_interval``), else None.
    diagnostics: Optional[List[dict]] = None
    # (step, from_members, to_members) per compaction event.
    compactions: List[tuple] = field(default_factory=list)

    @property
    def members(self) -> int:
        return int(self.grids.shape[0])

    def member(self, i: int) -> HeatResult:
        """Member ``i`` as a solver :class:`HeatResult`."""
        return HeatResult(
            grid=self.grids[i], steps_run=int(self.steps_run[i]),
            converged=(bool(self.converged[i])
                       if self.converged is not None else None),
            residual=(float(self.residual[i])
                      if self.residual is not None else None),
            elapsed_s=self.elapsed_s,
            finite=(bool(self.finite[i]) if self.finite is not None
                    else None),
            diagnostics=(self.diagnostics[i]
                         if self.diagnostics is not None else None))

    def to_numpy(self) -> np.ndarray:
        """Copy the stacked final grids to host memory."""
        return self.grids.detach().cpu().numpy()


@dataclass
class EnsembleBoundary:
    """What an ``on_boundary`` callback sees after each dispatch: global
    progress plus an ``assemble()`` hook producing the full-order
    resumable state."""

    step: int          # absolute steps the live members have run
    batch: int         # current (possibly compacted) batch extent
    live: int          # members still advancing
    done_total: int    # members finished (parked or frozen in-batch)
    # The current (batch, *shape) state: a buffer the next dispatch
    # overwrites, so copy what must outlive the callback.
    live_grids: torch.Tensor
    assemble: Callable[[], dict]  # {"k", "grids", "done", "res", "steps"}
    # ORIGINAL member index of each position of the current batch: after
    # a compaction, position i is NOT member i.
    order: tuple = ()


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

class EnsembleSolver:
    """B independent members of one config, advanced together. Runs on
    ``device`` if given, else ``config.device`` (default ``cuda:0``); the
    CPU runs only when asked for. See the package docstring for the
    contracts and ``solver.explain(config, ensemble=B)`` for the resolved
    path."""

    def __init__(self, config: HeatConfig,
                 ensemble: Union[EnsembleConfig, int, None] = None,
                 device: Optional[str] = None):
        if ensemble is None:
            ensemble = EnsembleConfig()
        elif isinstance(ensemble, int):
            ensemble = EnsembleConfig(members=ensemble)
        config = config.validate()
        if config.is_sharded():
            raise ValueError(
                "EnsembleSolver is single-device per member: sharded "
                "mesh_shape configs run solo (the member axis does not "
                "span a mesh)")
        self.device = resolve_device(config, device)
        self.config = config.replace(device=str(self.device))
        self.ensemble = ensemble.validate()
        self.batch = self.ensemble.members

    # -- introspection ---------------------------------------------------

    def explain(self) -> dict:
        from parallel_heat_tpu_torch.solver import explain

        return explain(self.config, ensemble=self.batch)

    @property
    def path(self) -> str:
        return ensemble_path(self.config)

    # -- state construction ----------------------------------------------

    def initial_grids(self, initials=None) -> torch.Tensor:
        """The stacked ``(B, *shape)`` start state on the run's device.
        ``initials`` may be None (every member gets the model's initial
        condition), a single grid (broadcast to every member), or a
        stacked ``(B, *shape)`` array of per-member grids. Always a copy:
        the run writes its buffers in place."""
        B = self.batch
        shape = self.config.shape
        if initials is None:
            one = model_for(self.config).init_grid(self.device)
        else:
            one = torch.as_tensor(initials).to(device=self.device,
                                               dtype=torch.float32)
            if tuple(one.shape) == (B,) + shape:
                return one.clone().contiguous()
            if tuple(one.shape) != shape:
                raise ValueError(
                    f"initials shape {tuple(one.shape)} matches neither "
                    f"the member shape {shape} nor the stacked shape "
                    f"{(B,) + shape}")
        return one.expand((B,) + shape).clone().contiguous()

    # -- the run ---------------------------------------------------------

    def solve(self, initials=None, telemetry=None,
              chunk_steps: Optional[int] = None,
              on_boundary: Optional[Callable] = None,
              state: Optional[dict] = None) -> EnsembleResult:
        """Run every member to completion; returns an
        :class:`EnsembleResult` in original member order.

        Fixed mode runs ONE dispatch (one launch of kernel M on its path)
        unless ``chunk_steps`` is given; then the loop runs chunks with
        ``on_boundary`` called after each. Converge mode runs dispatches
        of ``EnsembleConfig.window_rounds`` check windows: the per-member
        verdicts are read once per dispatch, finished members freeze, and
        the batch compacts when the live fraction drops below
        ``EnsembleConfig.compact_threshold``.

        ``state`` resumes from an assembled boundary state:
        ``config.steps`` is the ABSOLUTE step target and ``state["k"]``
        the absolute step the grids correspond to. ``on_boundary`` may
        raise :class:`EnsembleInterrupted` to stop at a consistent
        boundary. The kernels are built and loaded before the clock
        starts; ``elapsed_s`` ends with a device synchronisation.

        ``telemetry`` (a ``utils.telemetry.Telemetry``) receives a
        ``run_header`` with the ``ensemble`` block, an ``ensemble_window``
        a dispatch, ``member_converged`` and ``ensemble_compaction`` in
        converge mode, and per member a ``diagnostics`` event (with
        ``member``, under ``diag_interval``) and a ``member_end``. The
        guard (``guard_interval``) and the diagnostics check and sample
        every member's final grid after the clock, against its initial
        grid, as the JAX package does.
        """
        config = self.config
        guard_interval = config.guard_interval
        diag_interval = config.diag_interval
        B = self.batch
        if telemetry is not None:
            telemetry.run_header(
                config, ensemble={"members": B, "path": self.path,
                                  "window_rounds":
                                      self.ensemble.window_rounds,
                                  "compact_threshold":
                                      self.ensemble.compact_threshold})
        config = _observer_free(config)
        with device_scope(self.device):
            ms, msr, path = _batched_multistep(config)
            if state is not None:
                u = self.initial_grids(state["grids"])
                k0 = int(state["k"])
            else:
                u = self.initial_grids(initials)
                k0 = 0
            diag_prev = u.clone() if diag_interval is not None else None
            with Timer(self.device) as timer:
                if not config.converge:
                    out = self._solve_fixed(ms, u, k0, chunk_steps,
                                            on_boundary, telemetry)
                else:
                    # Kernel M leaves its input buffer as it was.
                    out = self._solve_converge(ms, msr, path == "M", u, k0,
                                               state, on_boundary, telemetry)
            grids, steps_run, converged, residual, compactions = out
            finite = None
            if guard_interval is not None:
                finite = ensemble_all_finite(grids)
                if not finite.all():
                    bad = [int(i) for i in np.where(~finite)[0]]
                    warnings.warn(
                        f"runtime guard: non-finite grid values in "
                        f"ensemble member(s) {bad} (coefficient sum past "
                        f"the stability bound? see "
                        f"HeatConfig.stability_margin)", RuntimeWarning)
            diagnostics = None
            if diag_interval is not None:
                diagnostics = ensemble_grid_stats(grids, prev=diag_prev)
                for i, d in enumerate(diagnostics):
                    d["step"] = int(steps_run[i])
                    d["steps_since"] = int(steps_run[i]) - k0
                    if telemetry is not None:
                        telemetry.diagnostics(member=i, **d)
        if telemetry is not None:
            for i in range(B):
                telemetry.emit(
                    "member_end", member=i, step=int(steps_run[i]),
                    steps=int(steps_run[i]) - k0,
                    converged=(bool(converged[i])
                               if converged is not None else None),
                    residual=(float(residual[i])
                              if residual is not None else None),
                    finite=(bool(finite[i]) if finite is not None
                            else None))
        return EnsembleResult(
            grids=grids, steps_run=steps_run, converged=converged,
            residual=residual, elapsed_s=timer.elapsed_s, finite=finite,
            diagnostics=diagnostics, compactions=compactions)

    # -- fixed mode ------------------------------------------------------

    def _solve_fixed(self, ms, u, k0, chunk_steps, on_boundary, telemetry):
        B = self.batch
        total = self.config.steps
        remaining = total - k0
        if remaining < 0:
            raise ValueError(
                f"resume state at step {k0} is past the target {total}")
        chunk = chunk_steps if chunk_steps else max(1, remaining)
        v = torch.empty_like(u)
        k = k0
        while k < total:
            c = min(chunk, total - k)
            with record_function("heat:ens_chunk"):
                u, v = ms(u, v, c)
            k += c
            if telemetry is not None:
                telemetry.emit("ensemble_window", step=k, batch=B,
                               live=(B if k < total else 0),
                               done=(0 if k < total else B))
            if on_boundary is not None:

                def assemble(_u=u, _k=k):
                    return {"k": _k, "grids": _u.clone(),
                            "done": np.zeros(B, bool),
                            "res": np.full(B, np.inf, np.float64),
                            "steps": np.full(B, _k, np.int64)}

                on_boundary(EnsembleBoundary(
                    step=k, batch=B, live=B if k < total else 0,
                    done_total=0 if k < total else B, live_grids=u,
                    assemble=assemble, order=tuple(range(B))))
        steps_run = np.full(B, total, np.int64)
        return u, steps_run, None, None, []

    # -- converge mode ---------------------------------------------------

    def _solve_converge(self, ms, msr, keeps_input, u, k0, state,
                        on_boundary, telemetry):
        config = self.config
        dev = self.device
        B = self.batch
        total = config.steps
        ci = config.check_interval
        # The residual is float32 and is compared with eps as float32,
        # as the solo loop does.
        eps = float(np.float32(config.eps))
        n_full = total // ci
        rem = total % ci
        full_steps = n_full * ci
        W = self.ensemble.window_rounds
        thresh = self.ensemble.compact_threshold

        # Original-order member bookkeeping. `order[pos]` is the original
        # index of position `pos` of the current batch; parked members
        # live outside the batch, as copies (the batch's buffers are
        # overwritten by later dispatches).
        order = list(range(B))
        parked: dict = {}  # orig idx -> (grid, steps, res, converged)
        compactions: List[tuple] = []

        if state is not None:
            done_h = np.asarray(state["done"], bool).copy()
            res_h = np.asarray(state["res"], np.float64).copy()
            steps_h = np.asarray(state["steps"], np.int64).copy()
        else:
            done_h = np.zeros(B, bool)
            res_h = np.full(B, np.inf, np.float64)
            steps_h = np.full(B, k0, np.int64)
        # Members converged on entry are parked at once (a resumed
        # ensemble must not advance finished members); diverged ones ride
        # along frozen, as in the run that saved the state.
        conv_h = done_h & (res_h < eps)
        if conv_h.any():
            for i in np.where(conv_h)[0]:
                parked[int(i)] = (u[int(i)].clone(), int(steps_h[i]),
                                  float(res_h[i]), True)
            order = [int(i) for i in np.where(~conv_h)[0]]
            if order:
                u = u[torch.as_tensor(order, device=dev)]
        v = torch.empty_like(u)
        k = k0

        def assemble_state(u_cur, done_cur, res_cur, steps_cur, k_cur,
                           order_cur):
            """Full-order resumable snapshot."""
            slices = {}
            for pos, orig in enumerate(order_cur):
                slices[orig] = (u_cur[pos], int(steps_cur[pos]),
                                float(res_cur[pos]), bool(done_cur[pos]))
            slices.update(parked)
            return {"k": k_cur,
                    "grids": torch.stack([slices[i][0] for i in range(B)]),
                    "done": np.array([slices[i][3] for i in range(B)]),
                    "res": np.array([slices[i][2] for i in range(B)],
                                    np.float64),
                    "steps": np.array([slices[i][1] for i in range(B)],
                                      np.int64)}

        def verdicts_to_device():
            """The in-batch verdict state of the current `order`. Frozen
            members ride along (masked update) until a compaction parks
            them."""
            return (torch.tensor([bool(done_h[i]) for i in order],
                                 dtype=torch.bool, device=dev),
                    torch.tensor([res_h[i] for i in order],
                                 dtype=torch.float32, device=dev),
                    torch.tensor([steps_h[i] for i in order],
                                 dtype=torch.int32, device=dev))

        done_d, res_d, steps_d = verdicts_to_device()
        while order and k < full_steps:
            cur_B = len(order)
            w = min(W, (full_steps - k) // ci)
            if w <= 0:
                break
            k_d = torch.tensor(k, dtype=torch.int32, device=dev)
            with record_function("heat:ens_chunk"):
                u, v, done_d, res_d, steps_d, k_d = _converge_dispatch(
                    msr, keeps_input, ci, eps, config.ndim, w, u, v,
                    done_d, res_d, steps_d, k_d)
            # The dispatch's one read: verdicts and step counter in one
            # float64 array (a float32 residual, NaN included, and an
            # int32 count are exact in float64).
            host = torch.cat([
                torch.stack([done_d.double(), res_d.double(),
                             steps_d.double()]),
                k_d.double().expand(3, 1)], dim=1).cpu().numpy()
            k = int(host[0, -1])
            done = host[0, :-1] != 0
            res_w = host[1, :-1]
            steps_w = host[2, :-1].astype(np.int64)
            newly = [pos for pos in range(cur_B)
                     if done[pos] and not done_h[order[pos]]]
            for pos, orig in enumerate(order):
                res_h[orig] = res_w[pos]
                steps_h[orig] = steps_w[pos]
                done_h[orig] = done[pos]
            live = int((~done).sum())
            if telemetry is not None:
                telemetry.emit("ensemble_window", step=k, batch=cur_B,
                               live=live, done=B - live)
                for pos in newly:
                    telemetry.emit("member_converged", member=order[pos],
                                   step=int(steps_w[pos]),
                                   residual=float(res_w[pos]))
            if on_boundary is not None:
                on_boundary(EnsembleBoundary(
                    step=k, batch=cur_B, live=live, done_total=B - live,
                    live_grids=u,
                    assemble=functools.partial(
                        assemble_state, u, done, res_w, steps_w, k,
                        list(order)),
                    order=tuple(order)))
            if live == 0:
                break
            conv = done & (res_w < eps)
            if thresh is not None and conv.any() and live / cur_B < thresh:
                # Compaction: park converged members, keep the others in
                # a smaller batch. Member trajectories are invariant to
                # this (masked freeze against physical removal). A
                # diverged member stays, frozen, for the drain's tail.
                live_pos = [int(p) for p in np.where(~conv)[0]]
                for pos in np.where(conv)[0]:
                    parked[order[int(pos)]] = (
                        u[int(pos)].clone(), int(steps_w[pos]),
                        float(res_w[pos]), True)
                u = u[torch.as_tensor(live_pos, device=dev)]
                v = torch.empty_like(u)
                new_order = [order[p] for p in live_pos]
                compactions.append((k, cur_B, len(new_order)))
                if telemetry is not None:
                    telemetry.emit("ensemble_compaction", step=k,
                                   from_members=cur_B,
                                   to_members=len(new_order))
                order = new_order
                done_d, res_d, steps_d = verdicts_to_device()

        # Drain the batch: converged members park with their latched
        # verdicts; the rest run the rem leftover steps past their last
        # window (the solo loop's uninspected tail: past the last full
        # window, or past the window whose residual was NaN) and park
        # unconverged.
        if order:
            conv = np.array([bool(done_h[i]) and res_h[i] < eps
                             for i in order])
            # The tail applies only to members that stopped without
            # converging, and only when this call reached the end of the
            # window budget (a resumed, already complete state must not
            # run it again).
            if rem > 0 and k < total and not conv.all():
                old = u if keeps_input else u.clone()
                new, _ = ms(u, v, rem)
                keep = torch.as_tensor(conv, device=dev).view(
                    (-1,) + (1,) * config.ndim)
                u = torch.where(keep, old, new)
                for pos, orig in enumerate(order):
                    if not conv[pos]:
                        steps_h[orig] = (steps_h[orig] if done_h[orig]
                                         else full_steps) + rem
            for pos, orig in enumerate(order):
                parked[orig] = (u[pos], int(steps_h[orig]),
                                float(res_h[orig]), bool(conv[pos]))

        grids = torch.stack([parked[i][0] for i in range(B)])
        steps_run = np.array([parked[i][1] for i in range(B)], np.int64)
        residual = np.array([parked[i][2] for i in range(B)], np.float64)
        converged = np.array([parked[i][3] for i in range(B)], bool)
        if np.any(~np.isfinite(residual) & (steps_run >= ci)):
            warnings.warn(
                "simulation diverged: non-finite residual in at least "
                "one ensemble member (coefficient sum past the "
                "stability bound? see HeatConfig.stability_margin)",
                RuntimeWarning)
        return grids, steps_run, converged, residual, compactions
