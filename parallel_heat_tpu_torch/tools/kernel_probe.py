"""Kernel A's anatomy on the card: where a launch of A spends its time.

    python -m parallel_heat_tpu_torch.tools.kernel_probe [--size 1000]
        [--ks 20,2000] [--ladder 1,2,4,8,20] [--made 40] [--out FILE]

The Hopper port of the JAX package's ``tools/kernel_probe.py``. That
probe cut one cost at a time out of kernel A's VMEM loop on the TPU; this
one cuts the costs of A's launch on the H100, as compile-time variants of
A's own kernel (``csrc/heat_probe_kernel.cu``, ``csrc/heat_a.cuh``),
launched exactly as A is, at A's tile, depth and thread block:

- ``full``: A as shipped, the only variant that computes A's function;
- ``no_barrier``: no grid-wide barrier between groups of steps;
- ``no_exchange``: no band written and no frame read between groups;
- ``copy_step``: each cell-step a copy instead of the combine, the loop's
  addressing and barriers kept;
- ``no_edge``: every block stepped as one inside the interior.

Needs a CUDA device and nvcc. Checks first that ``full`` is bitwise A's
plain version on the plate (K = 20 with the residual) and refuses to
time otherwise. Prints the card's name and power limit, then one JSON
line per variant: device milliseconds of a launch at each K of ``--ks``
(``torch.profiler``, over ``--made`` launches) and by CUDA events,
microseconds a step by the slope between the smallest and largest K, and
the launch's fixed share by the intercept; then one ``ladder`` line, A's
device time at each K of ``--ladder`` with a step and the fixed share by
a least-squares fit; then the ``anatomy`` line: per step, what each cut
saves against ``full`` and its share of ``full``'s step.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from parallel_heat_tpu_torch.bench_kernels import card_line, device_ms
from parallel_heat_tpu_torch.models import HeatPlate2D
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32
from parallel_heat_tpu_torch.tools.probing import fit, slope_row, time_row

VARIANTS = ("full", "no_barrier", "no_exchange", "copy_step", "no_edge")
CX = CY = 0.1

# Launches of heat_probe_kernel since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_kernel": 0}


def probe_steps(variant: str, u: torch.Tensor, out: torch.Tensor, k: int,
                with_residual: bool = True, *, cx: float,
                cy: float) -> Optional[torch.Tensor]:
    """Variant ``variant`` of kernel A: ``k`` steps of ``u`` into ``out``
    in one launch at A's launch shape (``stencil_kernels.a_launch``);
    returns the last step's residual or None without ``with_residual``.
    Only ``"full"`` computes A's function: on a CPU tensor it takes A's
    plain version, and the other variants, which are no function, raise."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    launch = sk._a_checked(u, out, k)
    if u.device.type == "cpu":
        if variant != "full":
            raise ValueError(f"probe variant {variant!r} is a measurement, "
                             f"not a function: it runs only on the card")
        return sk.resident_steps_plain(u, out, k, with_residual, cx=cx,
                                       cy=cy)
    from parallel_heat_tpu_torch.kernels.build import load

    xch, bits = sk.a_scratch(u, k, launch, with_residual)
    lib = load("heat_probe_kernel")
    code = lib.heat_probe_kernel(
        VARIANTS.index(variant), u.data_ptr(), out.data_ptr(), sk._ptr(xch),
        sk._ptr(bits), u.shape[0], u.shape[1], k, launch["depth"],
        launch["tile"][0], launch["tile"][1], launch["block"][0],
        launch["block"][1], *coeffs_f32(cx, cy), sk._stream(u))
    sk._raise_on_error(lib, "heat_probe_kernel", code)
    counts["heat_probe_kernel"] += 1
    return sk._residual_view(bits) if bits is not None else None


def anatomy(size: int = 1000, ks=(20, 2000), ladder=(1, 2, 4, 8, 20),
            made: int = 40):
    """Yield the probe's JSON rows (see the module's docstring) on the
    ``size`` x ``size`` plate on the current CUDA device."""
    dev = torch.device("cuda", torch.cuda.current_device())
    kw = dict(cx=CX, cy=CY)
    u = HeatPlate2D(size, size).init_grid(dev)
    v, want = torch.empty_like(u), torch.empty_like(u)
    launch = sk.a_launch((size, size))
    rp = sk.resident_steps_plain(u, want, 20, **kw)
    rk = probe_steps("full", u, v, 20, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(v, want) and torch.equal(rk, rp)):
        raise RuntimeError(f"probe variant 'full' at {size}^2, K = 20 is "
                           f"not bitwise A's plain version")
    card = card_line()
    shape = {"size": size, "tile": list(launch["tile"]),
             "depth": launch["depth"], "block": list(launch["block"])}
    lo, hi = min(ks), max(ks)
    per = {}
    for i, variant in enumerate(VARIANTS):
        row = {"probe": variant, **shape, "device_ms": {}, "events_ms": {},
               "card": card}

        def run(k, variant=variant):
            probe_steps(variant, u, v, k, True, **kw)

        time_row(row, run, ks, f"heat_a_resident_kernel<{i}>", made)
        slope_row(row, ks)
        per[variant] = row["device_us"]
        yield row
    times = []
    for k in ladder:
        def run(k=k):
            sk.resident_steps(u, v, k, True, **kw)

        times.append(device_ms(run, "heat_a_resident_kernel<0>", made))
    step, fixed = fit(ladder, times)
    yield {"ladder": "heat_a_resident", **shape,
           "device_ms": {f"k{k}": t for k, t in zip(ladder, times)},
           "step_us": step, "fixed_us": fixed, "card": card}
    full = per["full"]["step"]
    cuts = {name: full - per[variant]["step"] for name, variant in (
        ("barrier", "no_barrier"), ("exchange", "no_exchange"),
        ("combine", "copy_step"), ("edge_tests", "no_edge"))}
    yield {"anatomy": "heat_a_resident", **shape, "k": [lo, hi],
           "step_us": full, "fixed_us": per["full"]["fixed"],
           "cut_us_per_step": cuts,
           "cut_share_of_step": {n: c / full for n, c in cuts.items()},
           "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--ks", default="20,2000",
                    help="depths whose slope is a step (smallest, largest)")
    ap.add_argument("--ladder", default="1,2,4,8,20",
                    help="depths of A's K ladder")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a measurement")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    rows = []
    for row in anatomy(args.size, [int(x) for x in args.ks.split(",")],
                       [int(x) for x in args.ladder.split(",")], args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
