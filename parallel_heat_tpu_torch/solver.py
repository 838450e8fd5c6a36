"""The solver: the port of ``parallel_heat_tpu/solver.py`` for 2D and
3D: the explicit scheme, and in 2D the implicit schemes (one multigrid
V-cycle solve per step, ``ops/multigrid.py``), on one block; and the
explicit scheme cut over a mesh of blocks (``mesh_shape``, 2D or 3D),
every block on the run's one device, by K-deep rounds
(``parallel/temporal.py``, ``parallel/temporal3d.py``) or, at depth 1
under the torch backend, the per-step exchange (``parallel/halo.py``,
``parallel/halo3d.py``). A sharded run's grid is assembled from its
blocks after the clock stops, and its residual is the max over the
blocks, taken on the card.

The JAX package compiles the whole run into one XLA program. Here the
run's loops stay on the card as CUDA graphs (``utils/device_loop.py``),
captured before the clock starts (``HeatResult.capture_s``):

- fixed-step mode on one explicit block launches the steps and reads
  nothing back until the end (kernel A runs them all in one launch);
  a sharded or implicit run replays a graph of two rounds (two steps)
  and the remainder, reading nothing;
- converge mode replays a graph of guarded check windows, the loop state
  on the card under exactly the JAX loop's rule (continue while ``res >=
  eps and k < full_steps``, ``res`` starting at +inf; after the loop
  ``converged = res < eps``; the tail of ``steps % check_interval`` steps
  runs only when not converged, eagerly), and reads the state once a
  replay. A NaN residual therefore ends the loop, as ``lax.while_loop``
  does.

On the CPU the same loops run eagerly, the host reading each stop test.

Precision (``HeatConfig.dtype``, ``accumulate``): the grid lives in its
storage dtype, float32, bfloat16 or float64, and arithmetic is float32,
on one block, 2D or 3D, and on 2D and 3D meshes. An explicit bfloat16
run takes A, E or E-uni in their bfloat16 forms (B and C when pinned),
in 3D F (D when pinned), on a 2D mesh the G family's, on a 3D mesh the
H family's (H-fused by default; H and H-defer with the band when
pinned);
under ``accumulate="f32chunk"`` (2D only) E or
E-uni carry float32 through each chunk of ``ops.stencil.F32CHUNK_DEPTH``
steps. An explicit float64 run takes the torch route: ``backend="auto"``
resolves to it on the card too, and ``backend="cuda"`` is refused by
``HeatConfig.validate``. An implicit step widens the state to float32
once and rounds the interior to storage once, at every dtype and on
either backend (``ops/multigrid.py``). Ensembles take every dtype and
mode too (``ensemble/engine.py``: kernel M in its bfloat16 form where the
solo run takes A, else, and in 3D, the torch route over a member axis).

The grid lives in two device buffers that the loop ping-pongs in place
(the reference's ``old = 1-old`` swap): each launch reads one and writes
the other, and no grid is allocated per step.

:func:`solve_stream` runs the same loops in host-visible chunks and
yields after each, with the observers of ``HeatConfig.guard_interval``
(:func:`grid_all_finite`) and ``diag_interval`` (:func:`grid_stats`) and
an optional telemetry sink; at ``pipeline_depth`` 2 (fixed mode on the
card) it dispatches the next chunk before it drains the last one's
observers. Observers read the grid and never write it: a run with them
is bitwise the run without.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from torch.profiler import record_function

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.config import OBSERVATION_ONLY_FIELDS, HeatConfig
from parallel_heat_tpu_torch.models import HeatPlate2D, HeatPlate3D
from parallel_heat_tpu_torch.ops.stencil import (step_2d, step_2d_residual,
                                                 step_3d, step_3d_residual)
from parallel_heat_tpu_torch.utils import device_loop, profiling
from parallel_heat_tpu_torch.utils.timing import Timer, synchronize


@dataclass
class HeatResult:
    """Outcome of one simulation run."""

    grid: torch.Tensor
    steps_run: int
    converged: Optional[bool]
    residual: Optional[float]
    elapsed_s: float
    # Seconds spent capturing and instantiating the run's graphs, before
    # the clock started (0 where no graph is made).
    capture_s: float = 0.0
    # The runtime guard's verdict (``HeatConfig.guard_interval``) where
    # it ran on this result's grid, else None. Observation only.
    finite: Optional[bool] = None
    # The grid_stats sample (``HeatConfig.diag_interval``: min, max,
    # heat, update_l2, update_linf, step, steps_since; ``vcycle`` in an
    # implicit run) where one ran on this result's grid, else None.
    diagnostics: Optional[dict] = None

    def to_numpy(self) -> np.ndarray:
        """Copy the final grid to host memory."""
        return self.grid.detach().cpu().numpy()


def model_for(config: HeatConfig):
    if config.ndim == 3:
        return HeatPlate3D(config.nx, config.ny, config.nz, config.cx,
                           config.cy, config.cz)
    return HeatPlate2D(config.nx, config.ny, config.cx, config.cy)


def resolve_device(config: HeatConfig,
                   device: Optional[str] = None) -> torch.device:
    """The device a run uses: ``device`` if given, else ``config.device``.
    A CUDA device without a usable GPU raises; the CPU is used only when
    asked for."""
    dev = torch.device(device if device is not None else config.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_backend(config: HeatConfig, dev: torch.device) -> str:
    """``config.backend``, or for "auto" cuda on a GPU device and torch on
    the CPU; float64 runs the torch route on either (the kernels store
    float32 and bfloat16)."""
    if config.backend != "auto":
        return config.backend
    if config.dtype == "float64":
        return "torch"
    return "cuda" if dev.type == "cuda" else "torch"


def steps_to_multistep(step, step_residual):
    """Lift one-step functions ``step(u, out)`` and ``step_residual(u,
    out) -> res`` to the ping-pong multistep interface of
    :func:`~parallel_heat_tpu_torch.ops.stencil_kernels.single_grid_multistep`."""

    def multi_step(u, v, k):
        for _ in range(k):
            step(u, v)
            u, v = v, u
        return u, v

    def multi_step_residual(u, v, k):
        # k-1 plain steps, then one with the residual: the residual is
        # the diff of the chunk's last step.
        u, v = multi_step(u, v, k - 1)
        res = step_residual(u, v)
        return v, u, res

    return multi_step, multi_step_residual


def torch_multistep(cx: float, cy: float, cz: Optional[float] = None,
                   accumulate: str = "storage"):
    """The "torch" backend: the textbook stencil of ``ops/stencil.py``,
    3D when ``cz`` is given; under ``accumulate="f32chunk"`` (2D) in
    chunks of ``F32CHUNK_DEPTH`` steps carried in float32, the counterpart
    of the JAX package's ``f32chunk_jnp_multistep``."""
    if accumulate == "f32chunk":
        from parallel_heat_tpu_torch.ops.stencil import (F32CHUNK_DEPTH,
                                                         f32chunk_steps)
        from parallel_heat_tpu_torch.ops.stencil_kernels import (
            _chunked_multistep)

        def chunk(u, out, k, want_res):
            return f32chunk_steps(u, out, k, want_res, cx, cy)

        return _chunked_multistep(chunk, F32CHUNK_DEPTH)
    if cz is None:
        one, one_residual, coeffs = step_2d, step_2d_residual, (cx, cy)
    else:
        one, one_residual, coeffs = step_3d, step_3d_residual, (cx, cy, cz)

    def step(u, out):
        out.copy_(one(u, *coeffs))

    def step_residual(u, out):
        new, res = one_residual(u, *coeffs)
        out.copy_(new)
        return res

    return steps_to_multistep(step, step_residual)


class _Loop:
    """The stepping and convergence policy of a run: :meth:`prepare`
    ``(u, v)`` before the clock, then ``loop(u, v) -> (grid, spare,
    steps_run, converged, residual)``. ``u`` holds the initial state and
    ``v`` is a spare of the same shape; ``converged``/``residual`` are
    None in fixed mode. A loop may run again from where the last run left
    its buffers (a stream's next chunk).

    On the card the loops run through ``utils/device_loop.py``: converge
    mode's check windows replayed as graphs with the stop test on the
    card (the tail, fewer than ``check_interval`` steps once a run, runs
    eagerly); fixed mode with a ``period`` (steps that leave the buffers
    in their order: two rounds of a sharded run, two implicit steps)
    replayed likewise, reading nothing; fixed mode without one (one
    block, explicit: kernel A runs every step in one launch) as plain
    launches. Elsewhere the same loops run eagerly.
    """

    def __init__(self, multi_step, multi_step_residual, config: HeatConfig,
                 period: Optional[int] = None):
        self.multi_step = multi_step
        self.steps = config.steps
        self.converge = config.converge
        if not self.converge:
            self.fixed = (device_loop.PeriodLoop(multi_step,
                                                 steps=self.steps,
                                                 period=period)
                          if period else None)
            return
        ci = config.check_interval
        # The JAX loop compares the float32 residual with eps as float32.
        self.eps = float(np.float32(config.eps))
        self.rem = self.steps % ci
        self.windows = device_loop.WindowLoop(
            multi_step_residual, ci=ci, eps=self.eps,
            full_steps=self.steps // ci * ci)

    def prepare(self, u, v, warm=None) -> None:
        """Before the clock; ``warm`` (state, spare) are the buffers a
        warm-up may run on where they are not ``(u, v)``
        (``device_loop.warm_up``)."""
        if not self.converge:
            if self.fixed is not None:
                self.fixed.prepare(u, v, warm)
            return
        self.windows.prepare(u, v, warm)

    def flips(self) -> Optional[bool]:
        """Does a run that does not stop early leave the state in ``v``?
        None where no graph binds the loop to its buffers' order."""
        loop = self.windows if self.converge else self.fixed
        return loop.flips() if loop is not None else None

    def __call__(self, u, v):
        if not self.converge:
            if self.steps > 0:
                u, v = (self.fixed.run(u, v) if self.fixed is not None
                        else self.multi_step(u, v, self.steps))
            return u, v, self.steps, None, None
        u, v, k, res = self.windows.run(u, v)
        converged = res < self.eps
        if self.rem > 0 and not converged:
            # Tail steps past the last full window, uninspected.
            u, v = self.multi_step(u, v, self.rem)
            k += self.rem
        return u, v, k, converged, res


def _period(config: HeatConfig, dev: torch.device) -> Optional[int]:
    """Fixed-mode steps a graph replays on the card: two rounds of a
    sharded run, two implicit steps; None for one explicit block, whose
    fixed run reads nothing back already (kernel A runs every step in
    one launch)."""
    if dev.type != "cuda":
        return None
    if config.is_sharded():
        return 2 * config.halo_depth
    return 2 if config.scheme != "explicit" else None


def _resolve_halo_depth(config: HeatConfig, backend: str) -> int:
    """``halo_depth`` None (auto) resolved under backend "cuda" on a mesh:
    in 2D kernel G's default depth (``hopper_params.g_k_default``) where
    the blocks hold it, else 1 (G at K = 1); in 3D kernel H's
    (``h_k_default``) capped at the smallest block extent, as the JAX
    package caps its depth sweep (``solver.py:114-156``). Under "torch",
    1 (the per-step exchange). Explicit values win."""
    if config.halo_depth is not None:
        return config.halo_depth
    if (config.scheme != "explicit" or not config.is_sharded()
            or backend != "cuda"):
        return 1
    from parallel_heat_tpu_torch.ops.hopper_params import params

    bmin = min(config.block_shape())
    if config.ndim == 3:
        return min(params().h_k_default, bmin)
    k = params().g_k_default
    return k if bmin >= k else 1


def _resolved(config: HeatConfig, backend: str) -> HeatConfig:
    """The config with a concrete ``halo_depth`` and ``halo_overlap``:
    the one place auto is substituted, shared by :func:`solve` and
    :func:`explain`. Single-block configs pass through."""
    if not config.is_sharded():
        return config
    from parallel_heat_tpu_torch.parallel.temporal import (
        resolve_halo_overlap)

    return config.replace(
        halo_depth=_resolve_halo_depth(config, backend),
        halo_overlap=resolve_halo_overlap(config, backend)).validate()


def sharded_multistep(config: HeatConfig, mesh, backend: str):
    """(multi_step, multi_step_residual) on the block lists of ``mesh``,
    for a resolved config: the K-deep rounds, or at depth 1 under the
    torch backend the per-step exchange (with ``overlap``'s
    interior/edge split). The kernel libraries of a CUDA run are loaded
    here, before any clock starts."""
    from parallel_heat_tpu_torch.parallel import temporal

    if config.halo_depth == 1 and backend == "torch":
        kw = dict(zip(("cx", "cy", "cz"), map(float, config.coefficients)),
                  grid_shape=config.shape, overlap=config.overlap)
        if config.ndim == 3:
            from parallel_heat_tpu_torch.parallel import halo3d

            one, one_residual = (halo3d.block_step_3d,
                                 halo3d.block_step_3d_residual)
        else:
            from parallel_heat_tpu_torch.parallel import halo

            one, one_residual = (halo.block_step_2d,
                                 halo.block_step_2d_residual)

        def step(us, vs):
            one(mesh, us, vs, **kw)

        def step_residual(us, vs):
            return one_residual(mesh, us, vs, **kw)

        return steps_to_multistep(step, step_residual)
    if backend == "cuda" and mesh.device.type == "cuda":
        from parallel_heat_tpu_torch.kernels.build import load

        if config.ndim == 3:
            from parallel_heat_tpu_torch.ops import (
                stencil_kernels_block_3d as skb)

            pick = skb.pick_block_temporal_3d
        else:
            from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb

            pick = skb.pick_block_temporal_2d
        kind, detail = pick(config.block_shape(), config.halo_depth,
                            config.dtype)
        if detail is not None:
            load(detail["kernel"])
            load(skb.entry(skb.BAND, config.dtype))
    return temporal.block_temporal_multistep(config, mesh, backend)


def single_multistep(config: HeatConfig, backend: str):
    """(multi_step, multi_step_residual) on the full grid, one device."""
    if config.scheme != "explicit":
        # Implicit schemes: every step is a multigrid V-cycle solve. The
        # one dispatch site; the ensemble engine's general path comes
        # through here too.
        from parallel_heat_tpu_torch.ops import multigrid

        return multigrid.implicit_multistep(config, backend)
    if backend == "cuda":
        if config.ndim == 3:
            from parallel_heat_tpu_torch.ops import stencil_kernels_3d

            return stencil_kernels_3d.single_grid_multistep_3d(config)
        from parallel_heat_tpu_torch.ops import stencil_kernels

        return stencil_kernels.single_grid_multistep(config)
    return torch_multistep(*map(float, config.coefficients),
                           accumulate=config.accumulate)


def _prepare_blocks(config: HeatConfig, mesh, initial):
    """The blocks of a sharded run, at the config's storage dtype: built
    per block from the model (no full-grid temporary), split from a full
    ``initial`` grid, or copied from a list of ``initial`` blocks in the
    mesh's row-major order (a bfloat16 array crosses by its bits)."""
    from parallel_heat_tpu_torch.convert import to_tensor

    bs = config.block_shape()
    if initial is None:
        model = model_for(config)
        return [model.init_block(mesh.device, mesh.origin(b, bs), bs,
                                 config.dtype)
                for b in range(mesh.size)]
    if isinstance(initial, (list, tuple)):
        if len(initial) != mesh.size or any(
                tuple(t.shape) != bs for t in initial):
            raise ValueError(f"initial blocks must be {mesh.size} arrays of "
                             f"{bs}, the blocks of mesh {mesh.shape}")
        return [to_tensor(t, config.dtype, mesh.device) for t in initial]
    if tuple(initial.shape) != config.shape:
        raise ValueError(f"initial grid shape {tuple(initial.shape)} does "
                         f"not match config shape {config.shape}")
    return mesh.split(to_tensor(initial, config.dtype, mesh.device))


def make_initial_grid(config: HeatConfig,
                      device: Optional[str] = None) -> torch.Tensor:
    """The model's initial grid of ``config`` (the polynomial plate of
    ``models.plate2d`` or ``plate3d``), whole, on ``device`` if given,
    else ``config.device``: the grid :func:`solve` starts from when it is
    given none, bitwise the JAX package's ``make_initial_grid``. A
    sharded config's grid is the assembled one."""
    config = config.validate()
    return model_for(config).init_grid(resolve_device(config, device),
                                       config.dtype)


def _prepare_initial(config: HeatConfig, initial,
                     dev: torch.device) -> torch.Tensor:
    """Default, validate, place, and copy in the config's storage dtype
    (the loop writes the buffers in place, so a caller's array is never
    touched; a bfloat16 numpy array crosses by its bits)."""
    from parallel_heat_tpu_torch.convert import to_tensor

    if initial is None:
        return model_for(config).init_grid(dev, config.dtype)
    if tuple(initial.shape) != config.shape:
        raise ValueError(f"initial grid shape {tuple(initial.shape)} does "
                         f"not match config shape {config.shape}")
    return to_tensor(initial, config.dtype, dev)


def device_scope(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _warn_if_diverged(res: Optional[float], steps_run: int,
                      checked: bool) -> None:
    """A non-finite converge-mode residual means the scheme blew up and
    the loop stopped early with ``converged=False``: say so. ``checked``
    is False when no window ran (the +inf seed is not a measurement)."""
    if checked and res is not None and not math.isfinite(res):
        warnings.warn(
            f"simulation diverged: non-finite residual after {steps_run} "
            f"steps (coefficient sum past the stability bound?); grid "
            f"values are garbage, boundary cells remain exact",
            RuntimeWarning,
        )


def explain(config: HeatConfig, device: Optional[str] = None,
            ensemble: Optional[int] = None) -> dict:
    """Resolve, without running or building anything, which path a
    config takes: device, backend and the kernel the picker chooses.
    The CLI prints it for ``--explain``. ``ensemble`` (a member count B)
    adds the ensemble engine's resolved path for this config, the
    decision ``ensemble.engine.ensemble_path`` executes, and the packing
    verdict (``ensemble.engine.packable``)."""
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    config = config.validate()
    name = device if device is not None else config.device
    dev = torch.device(name)
    config = config.replace(device=str(dev))
    backend = resolve_backend(config, dev)
    out = {
        "backend": backend,
        "device": str(dev),
        "dtype": config.dtype,
        "accumulate": config.accumulate,
        "shape": config.shape,
        "mode": "converge" if config.converge else "fixed",
        "scheme": config.scheme,
    }
    if config.guard_interval is not None:
        out["guard"] = (f"isfinite-all every {config.guard_interval} "
                        f"steps (observation-only)")
    if config.diag_interval is not None:
        out["diagnostics"] = (f"fused grid stats every "
                              f"{config.diag_interval} steps "
                              f"(observation-only)")
    if config.pipeline_depth is not None:
        out["pipeline"] = (f"depth {config.pipeline_depth} dispatch-"
                           f"ahead stream (dispatch-order only; "
                           f"observer drain overlaps the next chunk)")
    if ensemble is not None:
        from parallel_heat_tpu_torch.ensemble.engine import (ensemble_path,
                                                             packable)
        from parallel_heat_tpu_torch.ops.stencil_kernels import kernel_entry

        ok, reason = packable(config)
        if ensemble_path(config) == "M":
            path = (f"kernel M ({kernel_entry('M', config.dtype)}, "
                    f"member-batched resident multi-step"
                    + (", bfloat16 storage" if config.dtype == "bfloat16"
                       else "") + ")")
        elif config.scheme != "explicit":
            path = "vmap over the implicit V-cycle multistep"
        else:
            from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH

            path = "vmap over the torch multistep family" + {
                "bfloat16": (f", f32chunk: float32 carry through chunks of "
                             f"{F32CHUNK_DEPTH} steps"
                             if config.accumulate == "f32chunk"
                             else ", bfloat16 storage"),
                "float64": ", float64 storage, float32 arithmetic",
            }.get(config.dtype, "")
        out["ensemble"] = {
            "members": int(ensemble),
            "path": path,
            "packable": ok,
            "packable_reason": reason,
        }
    if config.scheme != "explicit":
        from parallel_heat_tpu_torch.ops import multigrid

        mg = multigrid.explain_hierarchy(config, backend)
        out["multigrid"] = mg
        out["path"] = (f"implicit {config.scheme}: multigrid V-cycle per "
                       f"step ({len(mg['levels'])} levels, "
                       f"{mg['smoother']}, {mg['transfers']})")
        if config.dtype != "float32":
            out["path"] += (f"; the {config.dtype} state widened to float32 "
                            f"once a step, the interior rounded to "
                            f"{config.dtype} once, float32 levels")
        return out
    plain = " (plain version on the CPU)" if dev.type == "cpu" else ""
    if config.accumulate == "f32chunk":
        from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH

        out["chunk_depth"] = (f"{F32CHUNK_DEPTH} steps carried in float32, "
                              f"one rounding to {config.dtype} a chunk "
                              f"(and after a remainder chunk)")
    if config.is_sharded():
        return _explain_sharded(config, out, backend, plain)
    if backend == "torch":
        out["path"] = "textbook torch stencil" + (
            " (float64 storage, float32 arithmetic: the kernels store "
            "float32 and bfloat16)" if config.dtype == "float64" else "")
        return out
    if config.ndim == 3:
        return _explain_3d(config, out, plain)
    kind, detail = sk.pick_single_2d(config.shape, config.dtype,
                                     config.accumulate)
    bf16 = "_bf16" if config.dtype == "bfloat16" else ""
    form = ("" if not bf16 else ", float32 carry (acc_f32)"
            if config.accumulate == "f32chunk" else ", bfloat16 storage")
    if kind == "A":
        ty, tx = detail["tile"]
        blocks = -(-config.shape[0] // ty) * -(-config.shape[1] // tx)
        out["path"] = (f"kernel A (heat_a_resident{bf16}, grid resident in "
                       f"shared memory{form}) tile={ty}x{tx} "
                       f"depth={detail['depth']} blocks={blocks}" + plain)
    elif kind in ("E", "E-uni"):
        from parallel_heat_tpu_torch.ops.hopper_params import params

        ty, tx = detail["tile"]
        lanes, warps = detail["block"]
        what = (f"heat_e_temporal{bf16}, K-step temporal, "
                f"{'cp.async' if not bf16 else 'widening'} load"
                if kind == "E" else f"heat_e_uni_temporal{bf16}, K-step "
                f"temporal, uniform TMA load")
        launches = (f" in launches of at most {params().e_k_default}"
                    if config.accumulate == "f32chunk" else "")
        out["path"] = (f"kernel {kind} ({what}{form}) tile={ty}x{tx}, "
                       f"{lanes}x{warps} threads K={detail['k']}{launches}"
                       + plain)
    elif kind in ("I", "I-uni"):
        from parallel_heat_tpu_torch.ops.hopper_params import params

        name = ("heat_i_tile_temporal" if kind == "I"
                else "heat_i_uni_tile_temporal")
        load = "cp.async" if kind == "I" else "uniform TMA"
        launches = (f" in launches of at most {params().i_k_default}"
                    if config.accumulate == "f32chunk" else "")
        out["path"] = (f"kernel {kind} ({name}{bf16}, K-step temporal over "
                       f"column bands, {load} load{form}) "
                       f"band={detail['band']} segment={detail['segment']} "
                       f"K={detail['k']}{launches}" + plain)
    elif kind == "B":
        bx, by = detail["block"]
        out["path"] = (f"kernel B (heat_b_step, one step) tile="
                       f"{by * detail['rows_per_thread']}x{bx}" + plain)
    elif kind == "C":
        ty, tx = detail["tile"]
        out["path"] = (f"kernel C (heat_c_tiled, one step, shared-memory "
                       f"tiles) tile={ty}x{tx}" + plain)
    else:
        out["path"] = "textbook torch stencil"
    forced = tune.forced("single_2d")
    out["decided_by"] = {"single_2d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    return out


def _explain_sharded(config: HeatConfig, out: dict, backend: str,
                     plain: str) -> dict:
    """The sharded path: mesh, blocks, the resolved depth and schedule
    ("(auto)" where they were resolved), and the round's kernels."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb

    res = _resolved(config, backend)
    k, mode = res.halo_depth, res.halo_overlap
    out["mesh"] = res.mesh_shape
    out["block_shape"] = res.block_shape()
    out["blocks_on"] = f"{out['device']} (every block of the mesh)"
    out["halo_depth"] = f"{k} (auto)" if config.halo_depth is None else k
    out["halo_overlap"] = (f"{mode} (auto)"
                           if config.halo_overlap in (None, "auto")
                           else mode)
    store = {"bfloat16": ", bfloat16 storage, float32 arithmetic",
             "float64": ", float64 storage, float32 arithmetic"}.get(
                 res.dtype, "")
    if backend == "torch" and k == 1:
        form = ("interior/edge split" if config.overlap and res.ndim == 2
                else "padded block")
        out["path"] = (f"per-step 1-deep halo exchange, textbook torch "
                       f"stencil ({form}){store}")
        return out
    if backend == "torch":
        out["path"] = (f"K-deep {'3D ' if res.ndim == 3 else ''}rounds "
                       f"(K={k}), textbook torch stencil, {mode} "
                       f"schedule{store}")
        return out
    if res.ndim == 3:
        return _explain_sharded_3d(res, out, k, mode, plain)
    bx, by = res.block_shape()
    kind, detail = skb.pick_block_temporal_2d((bx, by), k, res.dtype)
    forced = tune.forced("block_temporal_2d")
    out["decided_by"] = {"block_temporal_2d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    if kind == "torch":
        out["path"] = (f"K-deep rounds (K={k}), textbook torch stencil, "
                       f"{mode} schedule{store}")
        return out
    why = ""
    bf16 = res.dtype == "bfloat16"
    if kind == "G-fuse" and forced is None:
        why = (f"; G-fuse, not G-uni: block width {by} is not a multiple "
               f"of {8 if bf16 else 4} (G-uni's 16-byte loads)")
    if bf16:
        why += ("; bfloat16 storage (bfloat16 halos, every level rounded, "
                "float32 arithmetic)")
    if skb.pick_block_temporal_2d_deferred(kind, (bx, by), k, mode):
        round_ = (f"overlapped round: deferred bulk {detail['kernel']} "
                  f"(rows [{k}, {bx - k}) from u and the column tail) + "
                  f"band kernel {skb.entry(skb.BAND, res.dtype)}")
    else:
        reason = (f"; the block has {bx} rows, fewer than 2K = {2 * k}, so "
                  f"the monolithic round runs" if mode == "overlap"
                  and kind in ("G-uni", "G-fuse") else "")
        round_ = f"monolithic round: {detail['kernel']}{reason}"
    ty, tx = detail["tile"]
    lanes, warps = detail["block"]
    out["path"] = (f"kernel {kind} ({round_}), K-deep rounds K={k}, "
                   f"tile={ty}x{tx}, {lanes}x{warps} threads (a lane 4 "
                   f"columns of its warp's {detail['rows_per_warp']} rows)"
                   f"{why}" + plain)
    return out


def _explain_sharded_3d(res: HeatConfig, out: dict, k: int, mode: str,
                        plain: str) -> dict:
    """The sharded 3D path's round (the counterpart of the JAX package's
    kernel-H report, ``solver.py:823-846``)."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    bs = res.block_shape()
    kind, detail = skb3.pick_block_temporal_3d(bs, k, res.dtype)
    forced = tune.forced("block_temporal_3d")
    out["decided_by"] = {"block_temporal_3d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    store = (", bfloat16 storage, float32 arithmetic"
             if res.dtype == "bfloat16" else "")
    if kind == "torch":
        out["path"] = (f"K-deep 3D rounds (K={k}), textbook torch stencil, "
                       f"{mode} schedule{store}")
        return out
    halos = skb3.halos_of(bs, res.shape, k)
    if skb3.pick_block_temporal_3d_deferred(kind, bs, res.mesh_shape, k,
                                            mode):
        round_ = (f"overlapped round: deferred bulk {detail['kernel']} "
                  f"(x-planes [{k}, {bs[0] - k}) from u and the z and y "
                  f"tails) + band kernel {skb3.entry(skb3.BAND, res.dtype)} "
                  f"(every block's x bands in one launch, on F's plane "
                  f"loop)")
    elif kind == "H":
        round_ = (f"monolithic round: {detail['kernel']} on the assembled "
                  f"circular block")
    else:
        why = ("the deferred x bands run only when pinned (H-defer): the "
               "JAX package takes them only across processes"
               if kind == "H-fused" else
               "the overlapped round needs the overlap schedule, a sharded "
               "x axis and at least 2K x-planes a block")
        round_ = (f"monolithic round: {detail['kernel']}, pieces gathered "
                  f"in the kernel; {why}")
    bz, by = detail["block"]
    load = ""
    if detail.get("load") == "plain":
        load = (", every tile loads by one plain 2-byte load a cell, "
                "widened into the float32 ring (the bfloat16 form's one "
                "load: TMA needs 16-byte rows and a box that widens)")
    elif "load" in detail:
        hp = params()
        wy, wz = hp.h_tma_box(detail["block"], detail["rows"])
        ty, tz = hp.h_extent(detail["block"], detail["rows"])
        least = f"{2 * ty - 3 * k}x{max(2 * tz - 3 * k, wz)}"
        load = (f", tiles inside the block load by TMA (one {wy}x{wz} "
                f"(Y, Z) box a plane; bz % 4 == 0 and a tile inside the "
                f"block)" if detail["load"] == "tma"
                else f", tiles inside the block load by cp.async per cell "
                f"(TMA needs bz % 4 == 0 and a block of at least {least} "
                f"(Y, Z) cells at K={k}, which holds a tile, got "
                f"{bs[1]}x{bs[2]})")
    if res.dtype == "bfloat16":
        load += ("; bfloat16 storage (bfloat16 halos, every level rounded, "
                 "float32 arithmetic)")
    out["path"] = (f"kernel {kind} ({round_}), K-deep 3D rounds K={k}, "
                   f"halos={halos}, block={bz}x{by} threads of "
                   f"{detail['rows']} rows{load}" + plain)
    return out


def _explain_3d(config: HeatConfig, out: dict, plain: str) -> dict:
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    kind, detail = sk3.pick_single_3d(config.shape, config.dtype)
    bf16 = config.dtype == "bfloat16"
    form = ", bfloat16 storage" if bf16 else ""
    if kind == "F":
        ty, tz = detail["tile"]
        lanes, warps = detail["block"]
        wy, wz = params().f_extent(detail["block"], detail["rows"])
        load = (f"load=tma (one {wy}x{wz} (Y, Z) box a plane)"
                if detail["load"] == "tma" else
                f"load=cp.async (per {'group' if bf16 else 'cell'}; TMA "
                f"needs nz % {8 if bf16 else 4} == 0, got "
                f"nz={config.shape[2]})")
        out["path"] = (f"kernel F ({sk.kernel_entry('F', config.dtype)}, "
                       f"K-step temporal{form}, (Y, Z) tiles streamed down "
                       f"X) tile={ty}x{tz} "
                       f"block={lanes}x{warps} rows={detail['rows']} "
                       f"segment={detail['segment']} K={detail['k']} "
                       f"{load}" + plain)
    elif kind == "D":
        bz, by = detail["block"]
        out["path"] = (f"kernel D ({sk.kernel_entry('D', config.dtype)}, "
                       f"one step{form}) block={bz}x{by} "
                       f"planes={detail['planes']}" + plain)
    else:
        out["path"] = "textbook torch stencil"
    forced = tune.forced("single_3d")
    out["decided_by"] = {"single_3d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    return out


# ---------------------------------------------------------------------------
# Observers: the runtime guard and the grid diagnostics
# ---------------------------------------------------------------------------

# Cells a slab of the update norms' temporary holds (64 MiB of float32):
# ``u - prev`` of a 32768^2 grid at once would be a 4 GiB temporary.
_SLAB_CELLS = 1 << 24


def _observer_free(config: HeatConfig) -> HeatConfig:
    """``config`` with every observation-only field
    (``config.OBSERVATION_ONLY_FIELDS``) at its default: what the loops
    are built from, so an observed or pipelined run builds the plain
    run's loops and cannot diverge from it."""
    defaults = {f.name: f.default for f in dataclasses.fields(config)}
    kw = {name: defaults[name] for name in OBSERVATION_ONLY_FIELDS
          if getattr(config, name) != defaults[name]}
    return config.replace(**kw) if kw else config


def _blocks(state) -> list:
    return list(state) if isinstance(state, (list, tuple)) else [state]


def _pairs(state, prev=None, origins=None) -> list:
    """``[(block, prev block or None)]``: ``prev`` a tensor of the
    state's shape, a list of blocks, or (with ``origins``) the assembled
    grid, of which each block's cells are taken as a view."""
    blocks = _blocks(state)
    if prev is None:
        return [(b, None) for b in blocks]
    if isinstance(prev, (list, tuple)):
        return list(zip(blocks, prev))
    if origins is None:
        return [(blocks[0], prev)]
    return [(b, prev[tuple(slice(o, o + n) for o, n in zip(org, b.shape))])
            for b, org in zip(blocks, origins)]


def _finite_dev(state) -> torch.Tensor:
    """The guard on the card: a 0-d bool, True iff every cell of every
    block is finite. One read of the grid: the blocks' extrema are
    finite exactly when every cell is (a NaN makes both NaN)."""
    mm = torch.stack([torch.stack(torch.aminmax(b)) for b in _blocks(state)])
    return torch.isfinite(mm).all()


def _stats_dev(pairs) -> torch.Tensor:
    """The diagnostics on the card, as float64: ``[min, max, heat]`` and,
    where a baseline is paired, ``[update_l2, update_linf]`` after them.
    Blocks and then slabs of ``_SLAB_CELLS`` along the first axis are
    reduced one by one and their partials combined in that fixed order,
    with no atomics, so a value is the same from run to run and from
    depth to depth; sums accumulate in float32, as the JAX package's."""
    part, delta = [], []
    for u, p in pairs:
        # A bfloat16 grid sums in float32 (torch.sum of bfloat16 returns
        # bfloat16), float32 and float64 natively, as the JAX package's.
        acc = torch.float32 if u.element_size() < 4 else u.dtype
        mn, mx = torch.aminmax(u)
        heat = torch.sum(u, dtype=acc)
        part.append(torch.stack([mn.to(acc), mx.to(acc), heat]))
        if p is None:
            continue
        rows = max(1, _SLAB_CELLS // max(1, u[0].numel()))
        for r in range(0, u.shape[0], rows):
            d = u[r:r + rows].to(acc) - p[r:r + rows].to(acc)
            dmn, dmx = torch.aminmax(d)
            delta.append(torch.stack([dmn, dmx,
                                      torch.linalg.vector_norm(d)]))
    a = torch.stack(part)
    out = [a[:, 0].amin(), a[:, 1].amax(), a[:, 2].sum()]
    if delta:
        d = torch.stack(delta)
        out += [d[:, 2].square().sum().sqrt(),
                torch.maximum(d[:, 1], -d[:, 0]).amax()]
    return torch.stack(out).double()


def _stats_dict(vals) -> dict:
    vals = [float(v) for v in vals]
    l2, linf = (vals[3], vals[4]) if len(vals) == 5 else (None, None)
    return {"min": vals[0], "max": vals[1], "heat": vals[2],
            "update_l2": l2, "update_linf": linf}


def grid_all_finite(grid) -> bool:
    """The runtime guard: True iff every cell of ``grid`` (a tensor, or a
    list of a mesh's blocks) is finite. Reads the grid once on its device
    and the verdict on the host; writes nothing. The ``heat:guard``
    range names it in a profiler trace."""
    with record_function("heat:guard"):
        return bool(_finite_dev(grid))


def grid_stats(grid, prev=None) -> dict:
    """Grid diagnostics: ``min``, ``max``, ``heat`` (the sum of the
    cells) and, when ``prev`` (an earlier grid of the same shape, or its
    blocks) is given, ``update_l2``/``update_linf``, the norms of the
    change since ``prev``. Observation only, like
    :func:`grid_all_finite`; the ``heat:diag`` range names it."""
    return _sample(grid, prev)


def _sample(state, prev=None, origins=None) -> dict:
    """:func:`grid_stats` of ``state`` against ``prev`` (see
    :func:`_pairs`), read on the host."""
    with record_function("heat:diag"):
        return _stats_dict(_stats_dev(_pairs(state, prev, origins))
                           .tolist())


def _warn_guard_tripped(step: int) -> None:
    """The fixed-step counterpart of :func:`_warn_if_diverged`: the guard
    found non-finite values, so every step from the first bad one on made
    garbage (the boundary cells stay exact)."""
    warnings.warn(
        f"runtime guard: non-finite grid values detected at step {step} "
        f"(coefficient sum past the stability bound? see "
        f"HeatConfig.stability_margin); grid values are garbage from the "
        f"first bad step on, boundary cells remain exact",
        RuntimeWarning,
    )


def resolved_pipeline_depth(config: HeatConfig,
                            pipeline_depth: Optional[int] = None) -> int:
    """The dispatch depth :func:`solve_stream` runs ``config`` at: the
    explicit argument, else ``config.pipeline_depth``, else auto: 2 for a
    fixed-step run on the card, 1 otherwise. A converge chunk's verdict
    must be read before the next chunk is dispatched, and on the CPU
    there is no idle card for a chunk in flight to keep busy."""
    depth = (pipeline_depth if pipeline_depth is not None
             else config.pipeline_depth)
    if depth is not None:
        return depth
    if config.converge:
        return 1
    return 2 if torch.device(config.device).type == "cuda" else 1


class _Run:
    """The state of one run, for :func:`solve` and :func:`solve_stream`:
    the resolved config, the mesh (None on one block), the two buffers
    ``u`` (the initial state) and ``v`` (its spare), and the step
    functions; the kernels of a CUDA run are loaded here."""

    def __init__(self, config: HeatConfig, initial, dev: torch.device):
        self.dev = dev
        self.backend = resolve_backend(config, dev)
        self.mesh = self.origins = None
        if config.is_sharded():
            from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

            config = _resolved(config, self.backend)
            self.mesh = HeatMesh(config.mesh_shape, dev)
            self.ms, self.msr = sharded_multistep(config, self.mesh,
                                                  self.backend)
            self.u = _prepare_blocks(config, self.mesh, initial)
            self.v = [torch.empty_like(b) for b in self.u]
            bs = config.block_shape()
            self.origins = [self.mesh.origin(b, bs)
                            for b in range(self.mesh.size)]
        else:
            self.ms, self.msr = single_multistep(config, self.backend)
            self.u = _prepare_initial(config, initial, dev)
            self.v = torch.empty_like(self.u)
        self.config = config

    def loop(self, steps: int) -> _Loop:
        return _Loop(self.ms, self.msr, self.config.replace(steps=steps),
                     period=_period(self.config, self.dev))

    def grid(self, state) -> torch.Tensor:
        """The grid of ``state``: the buffer itself on one block, the
        assembled blocks (a new tensor) on a mesh."""
        return self.mesh.assemble(state) if self.mesh is not None else state

    def copy(self, state):
        """A copy of ``state`` that the run never writes."""
        if self.mesh is not None:
            return [b.clone() for b in state]
        return state.clone()

    def order(self, state) -> int:
        """0 where the state sits in ``u``, 1 where it sits in ``v``."""
        return 0 if device_loop._same(state, self.u) else 1


def solve(config: HeatConfig, initial=None,
          device: Optional[str] = None) -> HeatResult:
    """Run one simulation end to end. The main entry point.

    Runs on ``device`` if given, else ``config.device`` (default
    ``cuda:0``); the CPU runs only when asked for. ``initial`` (a tensor
    or array) defaults to the model's polynomial initial condition and is
    copied first. The kernels are built and loaded before the clock
    starts, so ``elapsed_s`` covers the step loop only, ended by a device
    synchronisation.

    A run is one loop with no boundary to observe inside it, so the guard
    (``guard_interval``) and the diagnostics (``diag_interval``) check
    and sample the final grid once (``HeatResult.finite``,
    ``.diagnostics``, against the initial grid), after the clock;
    :func:`solve_stream` observes within a run.
    """
    config = config.validate()
    guard_interval = config.guard_interval
    diag_interval = config.diag_interval
    config = _observer_free(config)
    dev = resolve_device(config, device)
    config = config.replace(device=str(dev))
    with device_scope(dev):
        run = _Run(config, initial, dev)
        config = run.config
        loop = run.loop(config.steps)
        captured = device_loop.stats["capture_s"]
        loop.prepare(run.u, run.v)
        captured = device_loop.stats["capture_s"] - captured
        baseline = run.copy(run.u) if diag_interval is not None else None
        with record_function("heat:solve"), Timer(dev) as timer:
            state, _, steps_run, converged, residual = loop(run.u, run.v)
        device_loop.settle()
        grid = run.grid(state)
        _warn_if_diverged(residual, steps_run,
                          config.converge
                          and steps_run >= config.check_interval)
        finite = None
        if guard_interval is not None:
            finite = grid_all_finite(state)
            if not finite:
                _warn_guard_tripped(steps_run)
        diag = None
        if diag_interval is not None:
            diag = _sample(state, baseline)
            diag["step"] = steps_run
            diag["steps_since"] = steps_run
            if config.scheme != "explicit":
                from parallel_heat_tpu_torch.ops import multigrid

                diag["vcycle"] = multigrid.cycle_trace(config, grid,
                                                       backend=run.backend)
    return HeatResult(grid=grid, steps_run=steps_run, converged=converged,
                      residual=residual, elapsed_s=timer.elapsed_s,
                      capture_s=captured, finite=finite, diagnostics=diag)


class _Drain:
    """What a dispatched chunk's observers left on the card, on its way
    to the host: on the card, pinned host copies enqueued without
    blocking and one event recorded after them; on the CPU, the values
    themselves."""

    def __init__(self, dev: torch.device, *values):
        self.event = None
        if dev.type != "cuda":
            self.values = values
            return
        self.values = tuple(
            None if v is None else torch.empty(v.shape, dtype=v.dtype,
                                               pin_memory=True)
            for v in values)
        for host, v in zip(self.values, values):
            if v is not None:
                host.copy_(v, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(dev))

    def ready(self) -> bool:
        """Has the card finished everything up to this drain? (No
        wait.)"""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def solve_stream(config: HeatConfig, initial=None,
                 chunk_steps: Optional[int] = None, telemetry=None,
                 pipeline_depth: Optional[int] = None,
                 device: Optional[str] = None):
    """Iterate the simulation in host-visible chunks; yields a
    :class:`HeatResult` after each chunk (cumulative ``steps_run`` and
    ``elapsed_s``).

    Each chunk of ``chunk_steps`` steps (default: the whole run) runs the
    loop :func:`solve` runs, so a chunked run is bitwise the unchunked
    one. In converge mode ``chunk_steps`` is rounded up to a multiple of
    ``check_interval``, which keeps the check schedule of an unchunked
    run (the tail of ``steps % check_interval`` steps runs in the last
    chunk, where the unchunked run runs it); iteration stops at
    convergence. Under ``accumulate="f32chunk"`` in fixed mode it is
    rounded up to a multiple of ``ops.stencil.F32CHUNK_DEPTH``, so that
    the float32 carry rounds where the unchunked run's does (converge
    mode's windows already restart it where the unchunked run does).
    Every loop the stream needs (on the card: each chunk
    size, in each order of the two buffers a chunk may leave them in) is
    built and captured before the first chunk's clock.

    ``telemetry`` (a :class:`utils.telemetry.Telemetry`) receives a
    ``run_header`` and one ``chunk`` event a yield; with
    ``config.diag_interval``, a ``diagnostics`` event a sample
    (:func:`grid_stats` at the first chunk boundary at-or-after each
    multiple of the interval, and at the last chunk; also on
    ``HeatResult.diagnostics``) and, in an implicit run at depth 1, a
    ``vcycle`` event (``multigrid.cycle_trace`` of one step from the
    boundary's grid; the first also carries ``level_wall_share``); with
    ``config.guard_interval``, the guard's verdict on the same rule
    (``HeatResult.finite``). The JAX package's ``profile`` events (its
    work model, ``prof/``) are not emitted: ROADMAP queue 1 item 11.

    ``pipeline_depth`` (the argument, else ``config.pipeline_depth``,
    else :func:`resolved_pipeline_depth`'s auto: 2 for fixed-step runs on
    the card, 1 otherwise). At depth 1 each chunk is dispatched, waited
    for, observed and yielded; its yielded grid is the run's live buffer
    on one block (consume it before advancing the generator). At depth
    >= 2 (fixed mode only) up to ``depth`` chunks are in flight on the
    run's CUDA stream: chunk n+1 is enqueued before chunk n's observers
    are drained, their scalars travel to pinned host memory without
    blocking, and one event a chunk says when they have landed. Each
    yielded grid is then a copy enqueued before the next chunk, which
    survives advancing. Grids, guard verdicts and diagnostics are bitwise
    the depth-1 loop's; ``wall_s`` is then drain to drain, ``gap_s`` the
    card's idle time a drain could prove (it found the newest chunk's
    event complete), ``drain_wait_s`` the host's wait on a chunk.

    A mesh's grid is yielded assembled (a new tensor, which at depth >= 2
    is the protected copy); its guard and statistics reduce over the
    blocks without assembling them.
    """
    config = config.validate()
    dev = resolve_device(config, device)
    config = config.replace(device=str(dev))
    guard_interval = config.guard_interval
    diag_interval = config.diag_interval
    depth = resolved_pipeline_depth(config, pipeline_depth)
    if depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {depth}")
    elif depth > 1 and config.converge:
        raise ValueError(
            "pipeline_depth > 1 is fixed-step only (converge mode must "
            "read each chunk's convergence verdict before dispatching "
            "the next chunk)")
    config = _observer_free(config)
    if chunk_steps is not None and chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
    total = config.steps
    chunk = chunk_steps if chunk_steps else max(1, total)
    if config.converge:
        ci = config.check_interval
        chunk = -(-chunk // ci) * ci
    elif config.accumulate == "f32chunk":
        # A chunk boundary off the f32chunk grid would restart the float32
        # carry mid-chunk and move the rounding points off the unchunked
        # run's: round up to a multiple of the chunk depth, as the JAX
        # package does.
        from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH

        chunk = -(-chunk // F32CHUNK_DEPTH) * F32CHUNK_DEPTH
    with device_scope(dev):
        run = _Run(config, initial, dev)
        loops, captured = _stream_loops(run, total, chunk)
    config = run.config
    if telemetry is not None:
        telemetry.run_header(config, pipeline_depth=depth)
        cells = profiling.cell_count(config)
        bytes_per_cell = profiling.bytes_per_cell(config)

    def loop_for(c, state):
        key = (c, run.order(state))
        if key not in loops:
            # A loop with no graph to capture: nothing binds it to the
            # buffers' order, and its prepare does nothing.
            loops[key] = run.loop(c)
        return loops[key]

    state, spare = run.u, run.v
    done = 0
    elapsed = 0.0
    next_guard = guard_interval
    next_diag = diag_interval
    prev = run.copy(state) if next_diag is not None else None
    prev_step = 0

    if depth > 1:
        inflight = collections.deque()
        disp_done = 0
        t_mark = time.perf_counter()
        # Set by a drain that finds the newest dispatched chunk already
        # complete: the card is idle from then until the next dispatch,
        # which charges the window to its chunk's gap_s (a lower bound).
        idle_mark = None

        def _dispatch():  # heatlint: dispatch-region
            # HL201: nothing here may wait for the card; a wait would
            # serialise the pipeline this loop exists to fill.
            nonlocal state, spare, disp_done, next_guard, next_diag
            nonlocal prev, prev_step, idle_mark
            c = min(chunk, total - disp_done)
            loop = loop_for(c, state)
            td0 = time.perf_counter()
            with record_function("heat:chunk"):
                state, spare, _, _, _ = loop(state, spare)
            dispatch_s = time.perf_counter() - td0
            gap_s = 0.0
            if idle_mark is not None:
                gap_s = max(0.0, td0 - idle_mark)
                idle_mark = None
            disp_done += c
            end = disp_done
            is_last = end >= total
            # The yielded grid: a copy enqueued before the next chunk
            # writes the buffers (the last chunk's buffer is never
            # written again; a mesh's assembly is a new tensor anyway).
            keep = (state if is_last and run.mesh is None
                    else run.grid(state) if run.mesh is not None
                    else state.clone())
            fin = None
            if next_guard is not None and (end >= next_guard or is_last):
                with record_function("heat:guard"):
                    fin = _finite_dev(state)
                while next_guard <= end:
                    next_guard += guard_interval
            stats = steps_since = None
            if next_diag is not None and (end >= next_diag or is_last):
                with record_function("heat:diag"):
                    stats = _stats_dev(_pairs(state, prev, run.origins))
                steps_since = end - prev_step
                prev, prev_step = keep, end
                while next_diag <= end:
                    next_diag += diag_interval
            counted = device_loop.settle_later()
            inflight.append((keep, _Drain(dev, fin, stats), counted,
                             steps_since, c, dispatch_s, gap_s))

        while True:
            with device_scope(dev):
                while len(inflight) < depth and disp_done < total:
                    _dispatch()
            if not inflight:
                return
            (keep, drain, counted, steps_since, c, dispatch_s,
             gap_s) = inflight.popleft()
            tw0 = time.perf_counter()
            drain.wait()
            now = time.perf_counter()
            drain_wait_s = now - tw0
            chunk_wall = now - t_mark
            t_mark = now
            elapsed += chunk_wall
            done += c
            if inflight and inflight[-1][1].ready():
                idle_mark = now
            counted()
            fin, stats = drain.values
            finite = None if fin is None else bool(fin)
            if finite is False:
                _warn_guard_tripped(done)
            diag = None
            if stats is not None:
                diag = {**_stats_dict(stats.tolist()), "step": done,
                        "steps_since": steps_since}
            observe_s = time.perf_counter() - now
            if telemetry is not None:
                telemetry.chunk(step=done, steps=c, wall_s=chunk_wall,
                                cells=cells, bytes_per_cell=bytes_per_cell,
                                residual=None, converged=None,
                                finite=finite, gap_s=gap_s,
                                dispatch_s=dispatch_s,
                                drain_wait_s=drain_wait_s,
                                observe_s=observe_s)
                if diag is not None:
                    telemetry.diagnostics(**diag)
            yield HeatResult(grid=keep, steps_run=done, converged=None,
                             residual=None, elapsed_s=elapsed,
                             capture_s=captured, finite=finite,
                             diagnostics=diag)

    vc_shares_sent = False
    t_complete_prev = None
    while done < total:
        t_iter = time.perf_counter()
        # The host's time between the previous chunk's completion and
        # this dispatch: the observer and caller tax a chunk event
        # carries, which pipelining hides.
        gap_s = (t_iter - t_complete_prev
                 if t_complete_prev is not None else 0.0)
        c = min(chunk, total - done)
        loop = loop_for(c, state)
        t0 = time.perf_counter()
        with device_scope(dev), record_function("heat:chunk"):
            state, spare, k, conv, res = loop(state, spare)
            synchronize(dev)
        chunk_wall = time.perf_counter() - t0
        t_complete_prev = t0 + chunk_wall
        device_loop.settle()
        elapsed += chunk_wall
        done += k
        out_conv = bool(conv) if config.converge else None
        out_res = float(res) if config.converge else None
        _warn_if_diverged(out_res, done, k >= config.check_interval)
        # The last yield (all steps done, converged, or stopped early by
        # a non-finite residual): the guard and the diagnostics must not
        # leave the final grid unobserved.
        is_last = done >= total or bool(out_conv) or k < c
        with device_scope(dev):
            grid = run.grid(state)
            finite = None
            if next_guard is not None and (done >= next_guard or is_last):
                finite = grid_all_finite(state)
                while next_guard <= done:
                    next_guard += guard_interval
                if not finite:
                    _warn_guard_tripped(done)
            diag = None
            if next_diag is not None and (done >= next_diag or is_last):
                diag = _sample(state, prev, run.origins)
                diag["step"] = done
                diag["steps_since"] = done - prev_step
                prev, prev_step = run.copy(state), done
                while next_diag <= done:
                    next_diag += diag_interval
                if config.scheme != "explicit":
                    # The V-cycle sample: one step re-solved from this
                    # boundary's grid, observation only.
                    from parallel_heat_tpu_torch.ops import multigrid

                    vc = multigrid.cycle_trace(config, grid,
                                               backend=run.backend)
                    if not vc_shares_sent:
                        vc["level_wall_share"] = {
                            f"l{i}": s for i, s in enumerate(
                                multigrid.level_wall_shares(config))}
                        vc_shares_sent = True
                    diag["vcycle"] = vc
                    if telemetry is not None:
                        telemetry.emit("vcycle", step=done, **vc)
        if telemetry is not None:
            observe_s = time.perf_counter() - t_complete_prev
            telemetry.chunk(step=done, steps=k, wall_s=chunk_wall,
                            cells=cells, bytes_per_cell=bytes_per_cell,
                            residual=out_res, converged=out_conv,
                            finite=finite, gap_s=gap_s,
                            observe_s=observe_s)
            if diag is not None:
                telemetry.diagnostics(**diag)
        yield HeatResult(grid=grid, steps_run=done, converged=out_conv,
                         residual=out_res, elapsed_s=elapsed,
                         capture_s=captured, finite=finite,
                         diagnostics=diag)
        if out_conv or k < c:
            return


def _stream_loops(run: _Run, total: int, chunk: int):
    """``({(steps, order): _Loop}, capture seconds)``: the loops a stream
    of ``total`` steps in chunks of ``chunk`` meets, prepared (on the
    card: warmed up and captured) before its clock. ``order`` says which
    buffer holds the state when the chunk starts (``_Run.order``); a
    chunk whose loop flips the buffers hands the next one the other
    order, so full chunks may need both, the last chunk the one it
    meets."""
    loops = {}
    captured = device_loop.stats["capture_s"]

    def prepare(c, order):
        if (c, order) not in loops:
            bufs = (run.u, run.v)
            loop = run.loop(c)
            # A warm-up writes the spare: the run's spare, whichever
            # order the loop is captured in.
            loop.prepare(bufs[order], bufs[1 - order], warm=bufs)
            loops[(c, order)] = loop
        return loops[(c, order)]

    full, rem = divmod(total, chunk)
    order = 0
    if full:
        flips = prepare(chunk, 0).flips()
        if flips and full > 1:
            prepare(chunk, 1)
        order = int(bool(flips)) * (full % 2)
    if rem:
        prepare(rem, order)
    return loops, device_loop.stats["capture_s"] - captured
