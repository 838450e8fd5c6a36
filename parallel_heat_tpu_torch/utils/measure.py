"""Measured timing: the interleaved min-of-N protocol, the port of
``parallel_heat_tpu/utils/measure.py``.

- **Chained calls, one terminal flush** (:func:`chain_time`): run
  ``reps`` calls back to back with no synchronisation between them, then
  one device synchronisation. The slope between two rep counts cancels
  the constant cost of a call and its flush.
- **Min of raw endpoints** (:func:`chain_slope`): noise on a wall clock
  only adds, so the minimum over the raw endpoint times converges on the
  true time; a minimum over per-batch slopes would be biased low.
- **Interleaving** (:func:`calibrated_slope_paired`,
  :func:`interleaved_min_of_n`): clocks drift over tens of seconds;
  measuring every variant inside each round lands the drift on all of
  them alike.

Every entry point takes an injectable ``clock`` (a zero-argument callable
returning seconds, default ``time.perf_counter``), so the arithmetic is
testable against a fake clock. :func:`sync` is a device synchronisation
of the tensor's device, or of each block's.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Clock = Callable[[], float]


def default_clock() -> float:
    """The default injectable timebase (``time.perf_counter``)."""
    return time.perf_counter()


def sync(x) -> None:
    """Wait until the card has finished the work that produces ``x``: a
    synchronisation of the device of ``x`` (a tensor, a list of blocks,
    or a result with a ``grid``). A CPU tensor needs none."""
    x = getattr(x, "grid", x)  # accept a HeatResult directly
    blocks = x if isinstance(x, (list, tuple)) else [x]
    for dev in {t.device for t in blocks}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def sync_floor(u0, samples: int = 3, *,
               clock: Optional[Clock] = None) -> float:
    """Median seconds of one :func:`sync` with nothing in flight: the
    constant a one-shot timing carries."""
    clock = clock or default_clock
    times = []
    for _ in range(max(1, samples)):
        t0 = clock()
        sync(u0)
        times.append(clock() - t0)
    return sorted(times)[len(times) // 2]


def timed_call(fn: Callable[[], Any], *, flush=sync,
               clock: Optional[Clock] = None) -> Tuple[float, Any]:
    """One bracketed measurement: ``(wall_seconds, fn())``.

    ``flush`` is applied to the result before the closing clock read;
    pass ``flush=None`` when ``fn`` synchronises itself.
    """
    clock = clock or default_clock
    t0 = clock()
    out = fn()
    if flush is not None and out is not None:
        flush(out)
    return clock() - t0, out


def min_of_n(fn: Callable[[], Any], rounds: int = 3, *, flush=sync,
             clock: Optional[Clock] = None) -> Tuple[float, Any]:
    """Min-of-N wall for one already-warmed measurement:
    ``(min_wall_seconds, last_result)``. Warm ``fn`` (its kernels built
    and loaded, its first call made) before calling."""
    best, out = float("inf"), None
    for _ in range(max(1, rounds)):
        wall, out = timed_call(fn, flush=flush, clock=clock)
        best = min(best, wall)
    return best, out


def interleaved_min_of_n(named_fns: Dict[str, Callable[[], Any]],
                         rounds: int = 3, *, flush=sync,
                         clock: Optional[Clock] = None
                         ) -> Dict[str, float]:
    """The interleaved min-of-N protocol over whole measured calls:
    every round measures ALL variants once, in dict order, so clock
    drift lands on each variant alike; returns ``{name: min wall}``.
    Use :func:`calibrated_slope_paired` when a call's work is small
    enough that its fixed cost must be cancelled by a slope.
    """
    walls: Dict[str, list] = {name: [] for name in named_fns}
    for _ in range(max(1, rounds)):
        for name, fn in named_fns.items():
            wall, _ = timed_call(fn, flush=flush, clock=clock)
            walls[name].append(wall)
    return {name: min(ts) for name, ts in walls.items()}


def interleaved_min_self_timed(named_fns: Dict[str, Callable[[], float]],
                               rounds: int = 3) -> Dict[str, float]:
    """:func:`interleaved_min_of_n` for SELF-TIMED callables: each fn
    returns its own measured wall seconds (for a bracket that must
    exclude per-call setup). Every round runs ALL variants in dict
    order."""
    walls: Dict[str, list] = {name: [] for name in named_fns}
    for _ in range(max(1, rounds)):
        for name, fn in named_fns.items():
            walls[name].append(float(fn()))
    return {name: min(ts) for name, ts in walls.items()}


# ---------------------------------------------------------------------------
# The chained-slope family (the fixed cost of a call cancelled)
# ---------------------------------------------------------------------------

def chain_time(step_fn, u0, reps: int, *,
               clock: Optional[Clock] = None) -> float:
    """Wall-clock seconds for ``reps`` chained ``step_fn`` applications.

    Copy ``u0`` first (a step may write its input in place; the copy
    protects the caller's tensor), apply ``g = step_fn(g)`` ``reps``
    times with no synchronisation between them, then one terminal
    :func:`sync`. ``step_fn`` must return the next grid.
    """
    clock = clock or default_clock
    g = u0.clone()
    sync(g)
    t0 = clock()
    # heatlint: begin dispatch-region
    for _ in range(reps):
        g = step_fn(g)
    # heatlint: end dispatch-region
    sync(g)
    return clock() - t0


def chain_slope(step_fn, u0, reps_a: int, reps_b: int,
                batches: int = 1, *,
                clock: Optional[Clock] = None) -> float:
    """Steady-state seconds per ``step_fn`` call via the chained slope.

    Measures each endpoint ``batches`` times, takes the minimum of the
    *raw times* (transport noise — dispatch jitter, host scheduling —
    is strictly additive on wall-clock, so min converges on the true
    time; a min over per-batch *slopes* would instead be biased low,
    preferentially keeping batches whose short endpoint got inflated),
    then returns ``(min t_b - min t_a) / (reps_b - reps_a)``. Raises
    ``RuntimeError`` when the slope is non-positive (noise swamped the
    measurement: a call's work far below its fixed cost); callers must
    surface that rather than report a garbage rate.
    """
    assert reps_b > reps_a >= 1 and batches >= 1
    t_a = min(chain_time(step_fn, u0, reps_a, clock=clock)
              for _ in range(batches))
    t_b = min(chain_time(step_fn, u0, reps_b, clock=clock)
              for _ in range(batches))
    per = (t_b - t_a) / (reps_b - reps_a)
    if per <= 0:
        raise RuntimeError(
            f"non-positive chained slope ({t_b:.4f}s for {reps_b} reps vs "
            f"{t_a:.4f}s for {reps_a}): measurement noise exceeds per-call "
            f"compute; increase the batch budget"
        )
    return per


def _calibrate_reps(step_fn, u0, span_s: float, max_reps: int, *,
                    clock: Optional[Clock] = None) -> Tuple[int, bool]:
    """Size the long endpoint to hold ``span_s`` seconds of REAL device
    work -> ``(reps_b, short_span)``. Calibration is itself a slope,
    ``(t_33 - t_1) / 32``, which cancels a call's fixed cost.
    ``short_span`` is True when even ``max_reps`` cannot hold 60% of the
    requested device work, a regime callers must refuse or surface."""
    t1 = chain_time(step_fn, u0, 1, clock=clock)
    t33 = chain_time(step_fn, u0, 33, clock=clock)
    per_est = (t33 - t1) / 32
    if per_est <= 0:
        per_est = span_s / max_reps  # fall through to the reps cap
    want = 1 + max(32, int(span_s / per_est))
    # >= 2 so the slope divisor is never zero, whatever max_reps a
    # caller passes.
    reps_b = max(2, min(want, max_reps))
    short = reps_b < want and reps_b * per_est < 0.6 * span_s
    return reps_b, short


def calibrated_slope(step_fn, u0, span_s: float = 0.5,
                     batches: int = 3, max_reps: int = 3000, *,
                     clock: Optional[Clock] = None) -> float:
    """:func:`chain_slope` with the long endpoint sized by
    :func:`_calibrate_reps` so it holds ``span_s`` seconds of real
    device work. Raises ``RuntimeError`` (from :func:`chain_slope`, or
    directly in the short-span regime) rather than returning a garbage
    number."""
    reps_b, short = _calibrate_reps(step_fn, u0, span_s, max_reps,
                                    clock=clock)
    if short:
        raise RuntimeError(
            f"per-call compute too small: even {max_reps} reps span "
            f"<{0.6 * span_s:.2f} s of device work; raise max_reps or "
            f"use a larger problem")
    return chain_slope(step_fn, u0, 1, reps_b, batches=batches,
                       clock=clock)


def bench_rounds_paired(named_fns, u0, steps_per_call,
                        span_s: float = 0.5, batches: int = 3,
                        max_reps: int = 3000):
    """Warm and time a set of round fns with
    :func:`calibrated_slope_paired`; print one line per variant and
    return ``{name: Gcells*steps/s}``. A variant whose first call fails
    prints FAILED and is excluded; a variant whose slope is noise prints
    so rather than reporting a garbage rate. ``steps_per_call[name]`` is
    how many stencil steps one call advances (K for temporal rounds).
    """
    import math

    runs = {}
    for name, fn in named_fns.items():
        try:
            sync(fn(u0.clone()))
        except Exception as e:  # noqa: BLE001 — surface, don't crash the A/B
            print(f"{name:26s}: FAILED {type(e).__name__}: {e}")
            continue
        runs[name] = fn
    pers = calibrated_slope_paired(runs, u0, span_s=span_s,
                                   batches=batches, max_reps=max_reps)
    cells = math.prod(u0.shape)
    out = {}
    for name, per in pers.items():
        if per is None:
            print(f"{name:26s}: no trustworthy slope "
                  f"(non-positive, or max_reps spans <60% of span_s)")
            continue
        k = steps_per_call[name]
        g = cells * k / per / 1e9
        print(f"{name:26s}: {per*1e3:8.2f} ms/call {per/k*1e6:9.1f} "
              f"us/step {g:7.1f} Gcells*steps/s")
        out[name] = g
    return out


def calibrated_slope_paired(named_fns, u0, span_s: float = 0.5,
                            batches: int = 3, max_reps: int = 3000, *,
                            clock: Optional[Clock] = None):
    """Paired :func:`calibrated_slope` over several step fns.

    Every batch interleaves ALL variants' endpoint measurements, so
    clock drift lands on each variant alike and the
    min-of-raw-endpoints slope compares like with like. Returns
    ``{name: seconds per call}``; a variant whose slope comes out
    non-positive maps to ``None`` (surface it, don't guess), and so
    does one in the short-span regime (here a ``None`` keeps the other
    variants' paired comparison alive where :func:`calibrated_slope`
    would raise).
    """
    reps = {}
    short_span = set()
    for name, fn in named_fns.items():
        reps[name], short = _calibrate_reps(fn, u0, span_s, max_reps,
                                            clock=clock)
        if short:
            short_span.add(name)
    timed = [n for n in named_fns if n not in short_span]
    t_a = {n: [] for n in timed}
    t_b = {n: [] for n in timed}
    for _ in range(batches):
        for name in timed:
            t_a[name].append(chain_time(named_fns[name], u0, 1,
                                        clock=clock))
            t_b[name].append(chain_time(named_fns[name], u0,
                                        reps[name], clock=clock))
    out = {}
    for name in named_fns:
        if name in short_span:
            out[name] = None
            continue
        per = (min(t_b[name]) - min(t_a[name])) / (reps[name] - 1)
        out[name] = per if per > 0 else None
    return out
