"""Profiling: the port of ``parallel_heat_tpu/utils/profiling.py``.

- :func:`trace`: a ``torch.profiler`` trace of a region, CPU and CUDA
  activity, written as a Chrome trace (Perfetto, ``chrome://tracing``).
  The solver's phases appear under ``heat:*`` record-function ranges
  (``heat:solve``, ``heat:chunk``, ``heat:guard``, ``heat:diag``) and the
  kernels under their own names.
- :func:`step_stats`: steps/s, Mcells·steps/s and effective GB/s of a
  result, without a trace viewer.

The chained-slope and interleaved min-of-N timing lives in
``utils/measure.py``; this module re-exports it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

from parallel_heat_tpu_torch.utils.measure import (  # noqa: F401 — re-exports
    bench_rounds_paired, calibrated_slope, calibrated_slope_paired,
    chain_slope, chain_time, sync)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the region, CPU and (where a card is
    present) CUDA activity, written into ``log_dir`` as a Chrome trace
    (``trace.<pid>.json``).

    Yields a one-argument callable: pass it what the region produces (a
    tensor, a list of blocks or a result) and it is synchronised before
    the trace closes, so the trace holds the card's whole work, not just
    its launches::

        with trace("/tmp/prof") as done:
            res = solve(cfg)
            done(res.grid)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    targets = []
    with profile(activities=activities) as prof:
        yield targets.append
        for t in targets:
            sync(t)
    os.makedirs(str(log_dir), exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(str(log_dir), f"trace.{os.getpid()}.json"))


@dataclass
class StepStats:
    """Throughput summary of a timed run."""

    cells: int
    steps: int
    elapsed_s: float
    bytes_per_cell: int = 8  # one read + one write of f32 per step

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.elapsed_s

    @property
    def mcells_steps_per_s(self) -> float:
        return self.cells * self.steps / self.elapsed_s / 1e6

    @property
    def effective_hbm_gb_s(self) -> float:
        """Lower bound on the memory rate of a streaming step."""
        return (self.cells * self.bytes_per_cell * self.steps
                / self.elapsed_s / 1e9)

    def summary(self) -> str:
        return (f"{self.steps} steps on {self.cells} cells in "
                f"{self.elapsed_s:.4f}s: "
                f"{self.mcells_steps_per_s:,.0f} Mcells*steps/s, "
                f"{self.steps_per_s:,.0f} steps/s, "
                f">= {self.effective_hbm_gb_s:.0f} GB/s effective")


def cell_count(config) -> int:
    """Total grid cells of a config: the throughput denominator."""
    cells = 1
    for n in config.shape:
        cells *= n
    return cells


def bytes_per_cell(config) -> int:
    """Memory traffic model: one read and one write of the storage dtype
    per cell per step. The one source for :func:`step_stats` and the
    telemetry chunk events."""
    return 2 * getattr(torch, config.dtype).itemsize


def step_stats(result, config) -> StepStats:
    """:class:`StepStats` of a solver result and its config."""
    return StepStats(
        cells=cell_count(config),
        steps=max(result.steps_run, 1),
        elapsed_s=result.elapsed_s,
        bytes_per_cell=bytes_per_cell(config),
    )


class Timeline:
    """Phase timer for driver-level instrumentation (the reference's
    ``MPI_Wtime`` bracketing, generalised to named phases)."""

    def __init__(self):
        self.phases: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def mark(self, name: str, sync_on=None) -> float:
        if sync_on is not None:
            sync(sync_on)
        now = time.perf_counter()
        dt = now - self._t0
        self.phases.append((name, dt))
        self._t0 = now
        return dt

    def summary(self) -> str:
        if not self.phases:
            return "  (no phases marked)"
        total = sum(dt for _, dt in self.phases)
        # Sub-resolution phases sum to 0: print 0%, not divide by zero.
        denom = total if total > 0 else 1.0
        lines = [f"  {name:<24s} {dt:9.4f}s ({dt/denom*100:5.1f}%)"
                 for name, dt in self.phases]
        return "\n".join(lines + [f"  {'total':<24s} {total:9.4f}s"])
