"""Elapsed seconds, the card's idle share and peak memory of the runs
``chip_smoke.py``'s device_loop phase measures, through ``solve()`` of
whichever copy of the package is imported: this tree's, or an older
tree's put first on the path, so that two versions of the loops are held
to each other on one card.

    python -m parallel_heat_tpu_torch.tools.loop_compare [--eager]
        [--runs N] [--only LABEL ...]
    PYTHONPATH=<older tree> python <this tree>/parallel_heat_tpu_torch/tools/loop_compare.py

Needs a CUDA device and nvcc. For each run: one solve to build and load
what it needs, then ``--runs`` timed solves (``elapsed_s``, the seconds
spent capturing graphs before the clock where the package reports them,
and the peak of ``torch.cuda.max_memory_allocated`` over the solve less
what was held before it), then one profiled solve whose trace spans the
solver's clock alone (the card's busy time over that run's
``elapsed_s``). ``--eager`` runs the loops with the device loop's eager
executor (every stop test a host read), where the package has one.
Prints the card's name and power limit (``nvidia-smi``), the package's
path, then one JSON line a run with its steps, verdict, residual and a
checksum of the grid's bits (the sum of its float32 words as integers),
which two versions' lines must share.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys

import torch

# chip_smoke.py's device_loop runs (its WINDOW, CONV, IMP_*, SHARD_* and
# MAIN_STEPS): label, HeatConfig keywords.
_CONV = dict(converge=True, check_interval=20, eps=1e-3)
_IMP = dict(nx=512, ny=512, cx=22.5, cy=22.5, steps=20)
RUNS = [
    ("1000^2 converge A", dict(nx=1000, ny=1000, steps=10000, **_CONV)),
    ("512^2 backward Euler", dict(scheme="backward_euler", **_IMP)),
    ("512^2 Crank-Nicolson", dict(scheme="crank_nicolson", **_IMP)),
    ("1000^2 (2, 4) converge", dict(nx=1000, ny=1000, steps=10000,
                                    mesh_shape=(2, 4), **_CONV)),
    ("64^3 (2, 2, 2) converge", dict(nx=64, ny=64, nz=64, steps=2000,
                                     mesh_shape=(2, 2, 2), **_CONV)),
    ("32768^2 (2, 4) fixed", dict(nx=32768, ny=32768, steps=200,
                                  mesh_shape=(2, 4))),
    ("1024^3 (2, 2, 2) fixed", dict(nx=1024, ny=1024, nz=1024, steps=200,
                                    mesh_shape=(2, 2, 2))),
]


def _mode(eager: bool):
    if not eager:
        return contextlib.nullcontext()
    from parallel_heat_tpu_torch.utils import device_loop

    return device_loop.eager()


def _checksum(grid: torch.Tensor) -> int:
    return int(grid.contiguous().view(torch.int32).sum(dtype=torch.int64))


def _busy_ms(cfg) -> tuple:
    """``(busy_ms, elapsed_s)`` of one solve profiled over the solver's
    clock (``solver.Timer``) alone."""
    from torch._C._autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parallel_heat_tpu_torch import solver

    traces, clock = [], solver.Timer

    class Traced(clock):
        def __enter__(self):
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            super().__exit__(*exc)
            self.prof.__exit__(*exc)
            traces.append(self.prof)
            return False

    solver.Timer = Traced
    try:
        res = solver.solve(cfg)
    finally:
        solver.Timer = clock
    events = traces[0].profiler.kineto_results.events()
    busy = sum(e.duration_ns() for e in events
               if e.device_type() == DeviceType.CUDA) / 1e6
    return busy, res.elapsed_s


def measure(label: str, kw: dict, runs: int, eager: bool) -> dict:
    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(**kw)
    with _mode(eager):
        solve(cfg)
        elapsed, capture, peak = [], [], []
        for _ in range(runs):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            res = solve(cfg)
            peak.append((torch.cuda.max_memory_allocated() - held) / 2 ** 20)
            elapsed.append(res.elapsed_s)
            capture.append(getattr(res, "capture_s", None))
        out = {"run": label, "steps_run": res.steps_run,
               "converged": res.converged, "residual": res.residual,
               "grid_bits_sum": _checksum(res.grid), "elapsed_s": elapsed,
               "elapsed_s_median": statistics.median(elapsed),
               "capture_s": capture, "peak_mib": peak}
        del res
        busy, wall = _busy_ms(cfg)
    out.update(device_busy_ms=busy, profiled_elapsed_s=wall,
               idle_share=1 - busy / 1e3 / wall)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eager", action="store_true",
                    help="the device loop's eager executor")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="labels of the runs to make (all by default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_compare needs a CUDA device", file=sys.stderr)
        return 2
    import parallel_heat_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"package": parallel_heat_tpu_torch.__file__,
                      "eager": args.eager}), flush=True)
    torch.cuda.set_device(0)
    for label, kw in RUNS:
        if args.only is None or label in args.only:
            print(json.dumps(measure(label, kw, args.runs, args.eager)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
