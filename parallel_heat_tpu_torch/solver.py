"""The solver: the port of ``parallel_heat_tpu/solver.py`` for 2D and
3D: the explicit scheme, and in 2D the implicit schemes (one multigrid
V-cycle solve per step, ``ops/multigrid.py``), on one block; and the
explicit scheme cut over a mesh of blocks (``mesh_shape``, 2D or 3D),
every block on the run's one device, by K-deep rounds
(``parallel/temporal.py``, ``parallel/temporal3d.py``) or, at depth 1
under the torch backend, the per-step exchange (``parallel/halo.py``,
``parallel/halo3d.py``). A sharded run's grid is assembled from its
blocks after the clock stops, and its residual is the max over the
blocks, taken on the card and read once per check window.

The JAX package compiles the whole run into one XLA program. Here the
run is a Python loop over kernel launches on one CUDA stream:

- fixed-step mode launches the steps and reads nothing back until the
  end;
- converge mode advances ``check_interval`` steps per window and reads
  the window's residual to the host once per window — one device sync
  per window, under exactly the JAX loop's rule (continue while
  ``res >= eps and k < full_steps``, ``res`` starting at +inf; after the
  loop ``converged = res < eps``; the tail of ``steps % check_interval``
  steps runs only when not converged). A NaN residual therefore ends the
  loop, as ``lax.while_loop`` does.

The grid lives in two device buffers that the loop ping-pongs in place
(the reference's ``old = 1-old`` swap): each launch reads one and writes
the other, and no grid is allocated per step.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.config import HeatConfig
from parallel_heat_tpu_torch.models import HeatPlate2D, HeatPlate3D
from parallel_heat_tpu_torch.ops.stencil import (step_2d, step_2d_residual,
                                                 step_3d, step_3d_residual)
from parallel_heat_tpu_torch.utils.timing import Timer


@dataclass
class HeatResult:
    """Outcome of one simulation run."""

    grid: torch.Tensor
    steps_run: int
    converged: Optional[bool]
    residual: Optional[float]
    elapsed_s: float

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
    if config.backend != "auto":
        return config.backend
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


def torch_multistep(cx: float, cy: float, cz: Optional[float] = None):
    """The "torch" backend: the textbook stencil of ``ops/stencil.py``,
    3D when ``cz`` is given."""
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


def _make_loop(multi_step, multi_step_residual, config: HeatConfig):
    """Build ``run(u, v) -> (grid, steps_run, converged, residual)``.

    ``u`` holds the initial state and ``v`` is a spare buffer of the same
    shape; this function encodes only the stepping and convergence
    policy. ``converged``/``residual`` are None in fixed mode.
    """
    steps = config.steps

    if not config.converge:

        def run_fixed(u, v):
            if steps > 0:
                u, v = multi_step(u, v, steps)
            return u, steps, None, None

        return run_fixed

    ci = config.check_interval
    # The JAX loop compares the float32 residual with eps as float32.
    eps = float(np.float32(config.eps))
    n_full = steps // ci
    rem = steps % ci
    full_steps = n_full * ci

    def run_converge(u, v):
        k = 0
        res = math.inf
        while res >= eps and k < full_steps:
            u, v, r = multi_step_residual(u, v, ci)
            res = float(r)  # the window's one host sync
            k += ci
        converged = res < eps
        if rem > 0 and not converged:
            # Tail steps past the last full window, uninspected.
            u, v = multi_step(u, v, rem)
            k += rem
        return u, k, converged, res

    return run_converge


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
        kind, detail = pick(config.block_shape(), config.halo_depth)
        if detail is not None:
            load(detail["kernel"])
            load(skb.BAND)
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
    return torch_multistep(*map(float, config.coefficients))


def _prepare_blocks(config: HeatConfig, mesh, initial):
    """The blocks of a sharded run: built per block from the model (no
    full-grid temporary), split from a full ``initial`` grid, or copied
    from a list of ``initial`` blocks in the mesh's row-major order."""
    bs = config.block_shape()
    if initial is None:
        model = model_for(config)
        return [model.init_block(mesh.device, mesh.origin(b, bs), bs)
                for b in range(mesh.size)]
    if isinstance(initial, (list, tuple)):
        if len(initial) != mesh.size or any(
                tuple(t.shape) != bs for t in initial):
            raise ValueError(f"initial blocks must be {mesh.size} arrays of "
                             f"{bs}, the blocks of mesh {mesh.shape}")
        return [torch.as_tensor(t).to(device=mesh.device,
                                      dtype=torch.float32,
                                      copy=True).contiguous()
                for t in initial]
    if tuple(initial.shape) != config.shape:
        raise ValueError(f"initial grid shape {tuple(initial.shape)} does "
                         f"not match config shape {config.shape}")
    return mesh.split(torch.as_tensor(initial))


def make_initial_grid(config: HeatConfig,
                      device: Optional[str] = None) -> torch.Tensor:
    """The model's initial grid of ``config`` (the polynomial plate of
    ``models.plate2d`` or ``plate3d``), whole, on ``device`` if given,
    else ``config.device``: the grid :func:`solve` starts from when it is
    given none, bitwise the JAX package's ``make_initial_grid``. A
    sharded config's grid is the assembled one."""
    config = config.validate()
    return model_for(config).init_grid(resolve_device(config, device))


def _prepare_initial(config: HeatConfig, initial,
                     dev: torch.device) -> torch.Tensor:
    """Default, validate, place, and copy (the loop writes the buffers in
    place, so a caller's array is never touched)."""
    if initial is None:
        return model_for(config).init_grid(dev)
    if tuple(initial.shape) != config.shape:
        raise ValueError(f"initial grid shape {tuple(initial.shape)} does "
                         f"not match config shape {config.shape}")
    return torch.as_tensor(initial).to(device=dev, dtype=torch.float32,
                                       copy=True).contiguous()


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
        "shape": config.shape,
        "mode": "converge" if config.converge else "fixed",
        "scheme": config.scheme,
    }
    if ensemble is not None:
        from parallel_heat_tpu_torch.ensemble.engine import (ensemble_path,
                                                             packable)

        ok, reason = packable(config)
        out["ensemble"] = {
            "members": int(ensemble),
            "path": ("kernel M (heat_m_ensemble, member-batched resident "
                     "multi-step)"
                     if ensemble_path(config) == "M"
                     else "vmap over the torch multistep family"),
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
        return out
    plain = " (plain version on the CPU)" if dev.type == "cpu" else ""
    if config.is_sharded():
        return _explain_sharded(config, out, backend, plain)
    if backend == "torch":
        out["path"] = "textbook torch stencil"
        return out
    if config.ndim == 3:
        return _explain_3d(config, out, plain)
    kind, detail = sk.pick_single_2d(config.shape)
    if kind == "A":
        ty, tx = detail["tile"]
        blocks = -(-config.shape[0] // ty) * -(-config.shape[1] // tx)
        out["path"] = (f"kernel A (heat_a_resident, grid resident in shared "
                       f"memory) tile={ty}x{tx} depth={detail['depth']} "
                       f"blocks={blocks}" + plain)
    elif kind in ("E", "E-uni"):
        ty, tx = detail["tile"]
        lanes, warps = detail["block"]
        what = ("heat_e_temporal, K-step temporal, cp.async load"
                if kind == "E" else "heat_e_uni_temporal, K-step temporal, "
                "uniform TMA load")
        out["path"] = (f"kernel {kind} ({what}) tile={ty}x{tx}, "
                       f"{lanes}x{warps} threads K={detail['k']}" + plain)
    elif kind in ("I", "I-uni"):
        name = ("heat_i_tile_temporal" if kind == "I"
                else "heat_i_uni_tile_temporal")
        out["path"] = (f"kernel {kind} ({name}, K-step temporal over "
                       f"column bands) band={detail['band']} "
                       f"segment={detail['segment']} K={detail['k']}"
                       + plain)
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
    if backend == "torch" and k == 1:
        form = ("interior/edge split" if config.overlap and res.ndim == 2
                else "padded block")
        out["path"] = (f"per-step 1-deep halo exchange, textbook torch "
                       f"stencil ({form})")
        return out
    if res.ndim == 3:
        return _explain_sharded_3d(res, out, k, mode, plain)
    bx, by = res.block_shape()
    kind, detail = skb.pick_block_temporal_2d((bx, by), k)
    forced = tune.forced("block_temporal_2d")
    out["decided_by"] = {"block_temporal_2d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    if kind == "torch":
        out["path"] = (f"K-deep rounds (K={k}), textbook torch stencil, "
                       f"{mode} schedule")
        return out
    why = ""
    if kind == "G-fuse" and forced is None:
        why = (f"; G-fuse, not G-uni: block width {by} is not a multiple "
               f"of 4 (G-uni's 16-byte loads)")
    if skb.pick_block_temporal_2d_deferred(kind, (bx, by), k, mode):
        round_ = (f"overlapped round: deferred bulk {detail['kernel']} "
                  f"(rows [{k}, {bx - k}) from u and the column tail) + "
                  f"band kernel {skb.BAND}")
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
    kind, detail = skb3.pick_block_temporal_3d(bs, k)
    forced = tune.forced("block_temporal_3d")
    out["decided_by"] = {"block_temporal_3d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    if kind == "torch":
        out["path"] = (f"K-deep 3D rounds (K={k}), textbook torch stencil, "
                       f"{mode} schedule")
        return out
    halos = skb3.halos_of(bs, res.shape, k)
    if skb3.pick_block_temporal_3d_deferred(kind, bs, res.mesh_shape, k,
                                            mode):
        round_ = (f"overlapped round: deferred bulk {detail['kernel']} "
                  f"(x-planes [{k}, {bs[0] - k}) from u and the z and y "
                  f"tails) + band kernel {skb3.BAND} (every block's x "
                  f"bands in one launch, on F's plane loop)")
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
    if "load" in detail:
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
    out["path"] = (f"kernel {kind} ({round_}), K-deep 3D rounds K={k}, "
                   f"halos={halos}, block={bz}x{by} threads of "
                   f"{detail['rows']} rows{load}" + plain)
    return out


def _explain_3d(config: HeatConfig, out: dict, plain: str) -> dict:
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    kind, detail = sk3.pick_single_3d(config.shape)
    if kind == "F":
        ty, tz = detail["tile"]
        lanes, warps = detail["block"]
        wy, wz = params().f_extent(detail["block"], detail["rows"])
        load = (f"load=tma (one {wy}x{wz} (Y, Z) box a plane)"
                if detail["load"] == "tma" else
                f"load=cp.async (per cell; TMA needs nz % 4 == 0, got "
                f"nz={config.shape[2]})")
        out["path"] = (f"kernel F (heat_f_temporal3d, K-step temporal, "
                       f"(Y, Z) tiles streamed down X) tile={ty}x{tz} "
                       f"block={lanes}x{warps} rows={detail['rows']} "
                       f"segment={detail['segment']} K={detail['k']} "
                       f"{load}" + plain)
    elif kind == "D":
        bz, by = detail["block"]
        out["path"] = (f"kernel D (heat_d_step3d, one step) block={bz}x{by} "
                       f"planes={detail['planes']}" + plain)
    else:
        out["path"] = "textbook torch stencil"
    forced = tune.forced("single_3d")
    out["decided_by"] = {"single_3d": {
        "source": "forced" if forced == kind else "default-order",
        "choice": kind}}
    return out


def solve(config: HeatConfig, initial=None,
          device: Optional[str] = None) -> HeatResult:
    """Run one simulation end to end. The main entry point.

    Runs on ``device`` if given, else ``config.device`` (default
    ``cuda:0``); the CPU runs only when asked for. ``initial`` (a tensor
    or array) defaults to the model's polynomial initial condition and is
    copied first. The kernels are built and loaded before the clock
    starts, so ``elapsed_s`` covers the step loop only, ended by a device
    synchronisation.
    """
    config = config.validate()
    dev = resolve_device(config, device)
    config = config.replace(device=str(dev))
    backend = resolve_backend(config, dev)
    with device_scope(dev):
        if config.is_sharded():
            from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

            config = _resolved(config, backend)
            mesh = HeatMesh(config.mesh_shape, dev)
            multi_step, multi_step_residual = sharded_multistep(
                config, mesh, backend)
            u = _prepare_blocks(config, mesh, initial)
            v = [torch.empty_like(b) for b in u]
        else:
            multi_step, multi_step_residual = single_multistep(config,
                                                               backend)
            u = _prepare_initial(config, initial, dev)
            v = torch.empty_like(u)
        run = _make_loop(multi_step, multi_step_residual, config)
        with Timer(dev) as timer:
            grid, steps_run, converged, residual = run(u, v)
        if config.is_sharded():
            grid = mesh.assemble(grid)
    _warn_if_diverged(residual, steps_run,
                      config.converge and steps_run >= config.check_interval)
    return HeatResult(grid=grid, steps_run=steps_run, converged=converged,
                      residual=residual, elapsed_s=timer.elapsed_s)
