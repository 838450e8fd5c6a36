"""What the measurement probes share: a variant's row of times, the slope
of a time over a depth, and a least-squares line.

Each probe (``kernel_probe``, ``vpu_roofline``, ``probe_temporal``,
``ab_temporal``) times its variants by the card's own clock
(``bench_kernels.device_ms``, a ``torch.profiler`` trace) and by CUDA
events (``bench_kernels.time_ms``) over ``made`` launches at each of a
few depths (steps or passes a launch), then reads a step and the
launch's fixed share off the two depths furthest apart.
"""

from __future__ import annotations

import numpy as np

from parallel_heat_tpu_torch.bench_kernels import device_ms
from parallel_heat_tpu_torch.bench_kernels import time_ms as events_ms


def fit(xs, ms):
    """``(us a unit of x, us fixed)``: the least-squares line through
    ``(x, ms)``."""
    step, fixed = np.polyfit(np.asarray(xs, float), np.asarray(ms, float), 1)
    return float(step) * 1e3, float(fixed) * 1e3


def time_row(row: dict, run, depths, instance: str, made: int,
             key: str = "k") -> dict:
    """Fill ``row["device_ms"]`` and ``row["events_ms"]`` with the ms of
    one ``run(d)`` at each depth ``d`` of ``depths``, keyed
    ``f"{key}{d}"``: the device time of the kernel whose name holds
    ``instance`` over ``made`` launches, and CUDA events over as many.
    Returns ``row``."""
    row.setdefault("device_ms", {})
    row.setdefault("events_ms", {})
    for d in depths:
        def once(d=d):  # heatlint: dispatch-region
            run(d)

        row["device_ms"][f"{key}{d}"] = device_ms(once, instance, made)
        row["events_ms"][f"{key}{d}"] = events_ms(once, made)
    return row


def slope_row(row: dict, depths, key: str = "k", per: str = "step") -> dict:
    """Add ``row["device_us"]`` and ``row["events_us"]`` to a row of
    :func:`time_row`: by each clock, the microseconds a unit of depth
    (``per``) by the slope between the smallest and largest depth, and the
    launch's fixed share (``"fixed"``) by the intercept. Returns ``row``."""
    lo, hi = min(depths), max(depths)
    for clock in ("device_ms", "events_ms"):
        t = row[clock]
        step = (t[f"{key}{hi}"] - t[f"{key}{lo}"]) / (hi - lo)
        row[clock.replace("ms", "us")] = {
            per: step * 1e3, "fixed": (t[f"{key}{lo}"] - lo * step) * 1e3}
    return row
