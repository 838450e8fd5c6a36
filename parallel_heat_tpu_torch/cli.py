"""Command-line interface of the port.

The flags and output lines are the JAX CLI's (``parallel_heat_tpu.cli``)
for the fields this package has: banner, grid line, converged-at or
did-not-converge, elapsed time, and the grid dump (``.dat`` for a 2D
grid, ``.npy`` for a 3D one or a path ending in ``.npy``). ``--ensemble
B`` runs B members of the config through the ensemble engine and prints
one line per member, as the JAX CLI does; ``--scheme`` and the ``--mg-*``
flags select the implicit integrators; ``--mesh``, ``--no-overlap``,
``--halo-depth`` and ``--halo-overlap`` cut a run over a mesh of blocks
(``--mesh dx,dy``, or ``dx,dy,dz`` with ``--nz``), all on the run's one
device (``auto`` is the one-device mesh). ``--initial-out`` writes the
initial grid as ``--out`` writes the final one, ``--quiet`` prints no
progress lines, and ``--dtype`` and ``--accumulate`` take the JAX CLI's
names (bfloat16 and float64 on one block, 2D or 3D: the explicit scheme,
the implicit schemes in 2D and ``--ensemble``; on a 2D mesh both, on a
3D mesh float64, bfloat16 there refused by ``HeatConfig.validate``).
``--out`` and ``--ensemble`` write a ``.npy`` as the JAX CLI does, a
bfloat16 grid or stack by its raw cells (``utils/io.py`` ``save_npy``).

The observers are the JAX CLI's too: ``--guard-interval`` and
``--diag-interval`` set the runtime guard and the grid diagnostics,
``--pipeline-depth`` the stream's dispatch depth, ``--metrics FILE``
appends the run's telemetry (JSONL, read by ``tools/metrics_report.py``)
and ``--heartbeat FILE`` keeps a liveness file; with either, the run goes
through a one-chunk ``solve_stream`` (bitwise ``solve``) and ends with a
``run_end`` event. ``--profile DIR`` (alias ``--trace``) writes a
``torch.profiler`` Chrome trace of the run into DIR.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="parallel_heat_tpu_torch",
        description="Jacobi heat-diffusion solver on PyTorch and CUDA",
    )
    ap.add_argument("--nx", type=int, default=20, help="grid rows (NXPROB)")
    ap.add_argument("--ny", type=int, default=20, help="grid cols (NYPROB)")
    ap.add_argument("--nz", type=int, default=None,
                    help="grid depth; enables the 3D 7-point stencil")
    ap.add_argument("--steps", type=int, default=10_000,
                    help="step count (exact in fixed mode, cap in converge)")
    ap.add_argument("--converge", action="store_true",
                    help="stop when max |du| < eps (CONVERGE build flag)")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--check-interval", type=int, default=20,
                    help="steps between convergence checks (STEP macro)")
    ap.add_argument("--cx", type=float, default=0.1)
    ap.add_argument("--cy", type=float, default=0.1)
    ap.add_argument("--cz", type=float, default=0.1)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float64"],
                    help="storage dtype (arithmetic is float32 at every "
                         "dtype); bfloat16 and float64 run on one block, "
                         "2D or 3D (explicit, implicit in 2D, "
                         "--ensemble), and on a --mesh (bfloat16 on 2D "
                         "meshes only); an explicit float64 run on the "
                         "torch route")
    ap.add_argument("--accumulate", default="storage",
                    choices=("storage", "f32chunk"),
                    help="sub-f32 accumulation semantics (SEMANTICS.md): "
                         "'storage' rounds the state to the storage "
                         "dtype every step; 'f32chunk' (bfloat16, 2D "
                         "single-device) carries f32 across each 16-step "
                         "chunk and rounds once per chunk")
    ap.add_argument("--scheme", default="explicit",
                    choices=("explicit", "backward_euler",
                             "crank_nicolson"),
                    help="time integrator: the explicit Jacobi update "
                         "(step capped by the stability bound), or an "
                         "unconditionally stable implicit scheme whose "
                         "per-step linear solve is a geometric-multigrid "
                         "V-cycle (2D)")
    ap.add_argument("--mg-tol", type=float, default=None,
                    help="implicit schemes: per-step relative residual "
                         "target of the V-cycle iteration (default 1e-3)")
    ap.add_argument("--mg-cycles", type=int, default=None,
                    help="implicit schemes: V-cycle cap per step "
                         "(default 50)")
    ap.add_argument("--mg-smooth", type=int, default=None,
                    help="implicit schemes: weighted-Jacobi pre/post "
                         "sweeps per level (default 1)")
    ap.add_argument("--mg-levels", type=int, default=None,
                    help="implicit schemes: hierarchy depth cap "
                         "(default: coarsen fully)")
    ap.add_argument("--pipeline-depth", default="auto", metavar="D",
                    help="stream dispatch pipelining: keep D chunks in "
                         "flight — chunk n+1 is enqueued on the card "
                         "before chunk n's observers (guard, diagnostics, "
                         "telemetry) drain, so the card does not idle "
                         "through them. Dispatch order only: grids and "
                         "observations are identical to a synchronous "
                         "run. 'auto' (default) = 2 for fixed-step runs "
                         "on the card, 1 otherwise; D > 1 with --converge "
                         "is an error")
    ap.add_argument("--ensemble", type=int, default=None, metavar="B",
                    help="run B independent members of this config as one "
                         "batched ensemble; --out then writes the stacked "
                         "(B, ...) member grids as one .npy file")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="cuda: the hand-written Hopper kernels; torch: the "
                         "textbook stencil in plain PyTorch; auto: cuda on "
                         "a GPU device, torch on the CPU")
    ap.add_argument("--mesh", default=None,
                    help="mesh of blocks, e.g. '2,4', or '2,2,2' with --nz "
                         "(default: one block; "
                         "'auto' factorizes the one device this package "
                         "runs on, so it gives (1, 1)); every block lives "
                         "on --device")
    ap.add_argument("--no-overlap", action="store_true",
                    help="per-step (halo depth 1) torch path: pad the "
                         "block with its halos instead of the "
                         "interior/edge split")
    ap.add_argument("--halo-depth", default="auto", metavar="K",
                    help="exchange K-deep halos once per K steps (sharded "
                         "runs). 'auto' takes kernel G's depth (2D) or "
                         "kernel H's (3D) under backend cuda where the "
                         "blocks hold it, else 1; see --explain")
    ap.add_argument("--halo-overlap", default="auto",
                    choices=("auto", "phase", "overlap", "pipeline"),
                    help="schedule of the K-deep rounds (bitwise the same "
                         "results): 'phase' runs both exchange phases, "
                         "then the kernel; 'overlap' runs the bulk between "
                         "them and the edge bands after; 'pipeline' is not "
                         "ported yet; 'auto' is 'overlap'")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (cuda:0), 'cuda:N' or 'cpu'; without a GPU "
                         "the run fails unless 'cpu' is given")
    ap.add_argument("--out", default=None,
                    help="write the final grid: a .dat file for a 2D grid, "
                         ".npy for a 3D grid or a path ending in .npy")
    ap.add_argument("--initial-out", default=None, metavar="FILE",
                    help="write the initial grid, as --out writes the "
                         "final one (reference: initial_im.dat)")
    ap.add_argument("--guard-interval", type=int, default=None,
                    metavar="N",
                    help="steps between on-device isfinite-all guard "
                         "checks (observation-only, never changes "
                         "numerics); a trip warns")
    ap.add_argument("--diag-interval", type=int, default=None,
                    metavar="N",
                    help="steps between on-device grid-stats samples "
                         "(min/max/total heat content, L2/L-inf update "
                         "residual — observation-only like the guard, "
                         "never changes numerics). Emitted as "
                         "'diagnostics' telemetry events when --metrics "
                         "is set")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run "
                         "(CPU and CUDA activity) into DIR")
    ap.add_argument("--trace", dest="profile", metavar="DIR",
                    help="alias for --profile (view the Chrome trace "
                         "with Perfetto or chrome://tracing; the run's "
                         "phases appear under heat:* ranges and the "
                         "kernels under their heat_* names)")
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="append one JSONL telemetry event per stream "
                         "chunk to FILE (schema-versioned: run header, "
                         "per-chunk throughput, guard and diagnostics — "
                         "summarize with tools/metrics_report.py). "
                         "Observation-only: results are bitwise the "
                         "uninstrumented run's")
    ap.add_argument("--heartbeat", default=None, metavar="FILE",
                    help="atomically rewrite FILE with a small liveness "
                         "JSON document ({step, last_event, residual, "
                         "...}) on telemetry events, for external probes")
    ap.add_argument("--monitor-hint", action="store_true",
                    help="print the tools/monitor.py invocation that "
                         "watches this run's --heartbeat/--metrics files")
    ap.add_argument("--explain", action="store_true",
                    help="print the resolved path (backend, kernel, tile, "
                         "K) and exit without running")
    ap.add_argument("--quiet", action="store_true",
                    help="print no progress lines (errors still go to "
                         "stderr)")
    return ap


def _parse_mesh(arg: Optional[str], ndim: int):
    """``--mesh``: None, 'auto' (the one device: all ones), 'dx,dy' or
    'dx,dy,dz'."""
    if arg is None:
        return None
    if arg == "auto":
        from parallel_heat_tpu_torch.parallel.mesh import pick_mesh_shape

        return pick_mesh_shape(1, ndim)
    try:
        return tuple(int(x) for x in arg.split(","))
    except ValueError:
        raise SystemExit(f"invalid --mesh {arg!r}: expected e.g. '2,4'")


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from parallel_heat_tpu_torch import HeatConfig, solve

    if args.halo_depth == "auto":
        halo_depth = None
    else:
        try:
            halo_depth = int(args.halo_depth)
        except ValueError:
            print(f"error: --halo-depth must be an integer or 'auto', got "
                  f"{args.halo_depth!r}", file=sys.stderr)
            return 2
    if args.pipeline_depth == "auto":
        # None lets solve_stream resolve it (resolved_pipeline_depth).
        pipeline_depth = None
    else:
        try:
            pipeline_depth = int(args.pipeline_depth)
        except ValueError:
            print(f"error: --pipeline-depth must be an integer or "
                  f"'auto', got {args.pipeline_depth!r}",
                  file=sys.stderr)
            return 2
    config = HeatConfig(nx=args.nx, ny=args.ny, nz=args.nz, cx=args.cx,
                        cy=args.cy, cz=args.cz, steps=args.steps,
                        converge=args.converge, eps=args.eps,
                        check_interval=args.check_interval,
                        dtype=args.dtype, accumulate=args.accumulate,
                        backend=args.backend, device=args.device,
                        scheme=args.scheme,
                        mesh_shape=_parse_mesh(
                            args.mesh, 2 if args.nz is None else 3),
                        overlap=not args.no_overlap, halo_depth=halo_depth,
                        halo_overlap=(None if args.halo_overlap == "auto"
                                      else args.halo_overlap),
                        guard_interval=args.guard_interval,
                        diag_interval=args.diag_interval,
                        pipeline_depth=pipeline_depth,
                        # Only the knobs given: unset ones keep their
                        # defaults, which --scheme explicit requires.
                        **{k: v for k, v in (("mg_tol", args.mg_tol),
                                             ("mg_cycles", args.mg_cycles),
                                             ("mg_smooth", args.mg_smooth),
                                             ("mg_levels", args.mg_levels))
                           if v is not None})
    try:
        config.validate()
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.ensemble is not None and args.ensemble < 1:
        print(f"error: --ensemble must be >= 1, got {args.ensemble}",
              file=sys.stderr)
        return 2
    if args.explain:
        from parallel_heat_tpu_torch.solver import explain

        for key, val in explain(config, ensemble=args.ensemble).items():
            print(f"{key}: {val}")
        return 0
    if args.monitor_hint and not (args.metrics or args.heartbeat):
        print("error: --monitor-hint requires --metrics and/or "
              "--heartbeat (the files the monitor watches)",
              file=sys.stderr)
        return 2
    if args.ensemble is not None:
        if args.initial_out:
            print("error: --ensemble does not take --initial-out",
                  file=sys.stderr)
            return 2
        return _run_ensemble(args, config)

    from parallel_heat_tpu_torch.solver import make_initial_grid

    say = (lambda *a: None) if args.quiet else print
    say(f"Starting parallel_heat_tpu_torch on 1 device(s), mesh "
        f"{config.mesh_or_unit()}.")
    grid = "x".join(map(str, config.shape))
    if config.converge:
        say(f"Grid size: {grid}  "
            f"Time steps: - (converge, eps={config.eps:g})")
    else:
        say(f"Grid size: {grid}  Time steps: {config.steps}")
    telemetry = _telemetry(args)

    def run():
        if telemetry is None:
            return solve(config)
        # A one-chunk stream: bitwise solve(), and the run leaves its
        # header and chunk events behind.
        from parallel_heat_tpu_torch.solver import solve_stream

        result = None
        for result in solve_stream(config, telemetry=telemetry):
            pass
        return result if result is not None else solve(config)

    try:
        if args.initial_out:
            written = _write_grid(args.initial_out, make_initial_grid(config))
            say(f"Initial grid written to {written}")
        if args.profile:
            from parallel_heat_tpu_torch.utils.profiling import trace

            with trace(args.profile) as done:
                result = run()
                done(result.grid)
            say(f"Profiler trace written to {args.profile}")
        else:
            result = run()
        if telemetry is not None:
            telemetry.run_end(outcome="complete",
                              steps_done=result.steps_run,
                              wall_s=result.elapsed_s)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if telemetry is not None:
            telemetry.close()
    if config.converge:
        if result.converged:
            say(f"Converged after {result.steps_run} steps")
        else:
            say(f"Did not converge (ran {result.steps_run} steps, "
                f"residual {result.residual:g})")
    say(f"Elapsed time {result.elapsed_s:.6f} secs")
    if args.out:
        written = _write_grid(args.out, result.grid)
        say(f"Final grid written to {written}")
    return 0


def _telemetry(args):
    """The run's sink for --metrics/--heartbeat (None without them), its
    file writes on a background thread; prints the monitor hint."""
    if not (args.metrics or args.heartbeat):
        return None
    from parallel_heat_tpu_torch.utils.telemetry import Telemetry

    telemetry = Telemetry(args.metrics, heartbeat=args.heartbeat,
                          async_io=True)
    if args.monitor_hint:
        import shlex

        hint = ["python", "tools/monitor.py"]
        if args.heartbeat:
            hint += ["--heartbeat", telemetry.heartbeat_path]
        if args.metrics:
            hint += ["--metrics", telemetry.path]
        # print, not say: the flag asks for this one line, and --quiet
        # must not swallow it.
        print("Monitor with: " + " ".join(shlex.quote(t) for t in hint))
    return telemetry


def _run_ensemble(args, config) -> int:
    """The --ensemble B path: one batched run, one line per member."""
    from parallel_heat_tpu_torch import EnsembleSolver

    say = (lambda *a: None) if args.quiet else print
    telemetry = _telemetry(args)
    say(f"Starting parallel_heat_tpu_torch ensemble: {args.ensemble} "
          f"member(s) of {'x'.join(map(str, config.shape))}, "
          + (f"converge eps={config.eps:g}" if config.converge
             else f"{config.steps} steps"))
    try:
        solver = EnsembleSolver(config, args.ensemble)
    except ValueError as e:
        if telemetry is not None:
            telemetry.close()
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        result = solver.solve(telemetry=telemetry)
        if telemetry is not None:
            telemetry.run_end(outcome="complete",
                              steps_done=int(result.steps_run.max()),
                              wall_s=result.elapsed_s)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if telemetry is not None:
            telemetry.close()
    for i in range(result.members):
        line = f"member {i}: {int(result.steps_run[i])} steps"
        if result.converged is not None:
            line += (f", converged={bool(result.converged[i])}, "
                     f"residual={float(result.residual[i]):g}")
        say(line)
    if result.compactions:
        say("compactions: " + ", ".join(
            f"step {k}: {a}->{b}" for k, a, b in result.compactions))
    say(f"Elapsed time {result.elapsed_s:.6f} secs")
    if args.out:
        from parallel_heat_tpu_torch.utils.io import save_npy

        path = args.out
        if not path.endswith(".npy"):
            path += ".npy"
        save_npy(path, result.grids)
        say(f"Stacked member grids written to {path}")
    return 0


def _write_grid(path: str, grid) -> str:
    """Write the grid; returns the path actually written (a 3D grid has
    no .dat form and is stored as .npy, as the JAX CLI does)."""
    from parallel_heat_tpu_torch.utils.io import save_npy, write_dat

    path = str(path)
    grid = grid.detach().cpu()
    # Both writers give the JAX CLI's bytes (utils/io.py): a bfloat16
    # grid's .npy holds its raw 2-byte cells, its .dat its values.
    if path.endswith(".npy") or grid.dim() != 2:
        if not path.endswith(".npy"):
            path += ".npy"
        save_npy(path, grid)
        return path
    write_dat(path, grid)
    return path


if __name__ == "__main__":
    raise SystemExit(main())
