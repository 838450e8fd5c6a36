"""How often a ``torch.profiler`` trace of the card loses kernel records,
with and without idle host time inside the trace around the launches.

    python -m parallel_heat_tpu_torch.tools.profiler_records [--seconds 120]
        [--made 40] [--pad 0.02]

Needs a CUDA device and nvcc. For ``--seconds`` it takes traces
(``bench_kernels.card_trace``) of ``--made`` back-to-back launches of
one kernel, in turns: two kernels (kernel B's step on a 1024^2 plate,
launched through ``ctypes`` as every kernel of the port is, and one
``torch.add`` of 2^22 floats) each under two waits (none, and ``--pad``
seconds of idle host on each side of the burst; ``bench_kernels``'
``TRACE_PAD_S`` by default). A trace's kept records are the records of
the kernel's name in its ``key_averages()``. Prints the card's name and
power limit (``nvidia-smi``), then one JSON object: for each kernel and
wait, the traces taken, the traces that kept fewer records than
launches, fewer than 70% of them (those ``bench_kernels.device_ms``
takes again) and more than launches, the records lost in all, and the
fewest kept.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

KERNELS = {"heat_b_step": "heat_b_step_kernel", "add": "elementwise"}


def census(dev, seconds: float, made: int, pad: float) -> dict:
    """The counts described in the module's docstring."""
    from parallel_heat_tpu_torch.bench_kernels import card_trace
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    u = torch.rand((1024, 1024), dtype=torch.float32, device=dev)
    v = torch.empty_like(u)
    x = torch.rand(1 << 22, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    launch = {"heat_b_step": lambda: sk.strip_step(u, v, cx=0.1, cy=0.1),
              "add": lambda: torch.add(x, 1.0, out=y)}
    rows = {f"{k}@{w}": {"kernel": k, "pad_s": w, "traces": 0, "short": 0,
                         "below_70": 0, "over": 0, "records_lost": 0,
                         "fewest_kept": made}
            for k in KERNELS for w in (0.0, pad)}
    for fn in launch.values():
        fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for key, row in rows.items():
            fn = launch[row["kernel"]]
            with card_trace(row["pad_s"]) as prof:
                for _ in range(made):
                    fn()
            kept = sum(e.count for e in prof.key_averages()
                       if KERNELS[row["kernel"]] in e.key
                       and e.self_device_time_total > 0)
            row["traces"] += 1
            row["short"] += kept < made
            row["below_70"] += kept < 0.7 * made
            row["over"] += kept > made
            row["records_lost"] += max(0, made - kept)
            row["fewest_kept"] = min(row["fewest_kept"], kept)
    return {"seconds": time.perf_counter() - t0, "made": made,
            "rows": list(rows.values())}


def main(argv=None) -> int:
    from parallel_heat_tpu_torch.bench_kernels import TRACE_PAD_S

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--made", type=int, default=40)
    ap.add_argument("--pad", type=float, default=TRACE_PAD_S)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps(census(dev, args.seconds, args.made, args.pad)),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
