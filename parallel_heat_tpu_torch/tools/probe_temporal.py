"""Kernel E-uni's anatomy on the card: where a launch of E-uni spends its
time.

    python -m parallel_heat_tpu_torch.tools.probe_temporal
        [--sizes 16384,8192] [--k 8] [--ladder 1,2,4,6,8] [--made 40]
        [--out FILE]

The Hopper port of the JAX package's ``tools/probe_temporal.py``. That
probe took kernel E's strip pipeline apart on the TPU (coefficient form,
residual, row mask, unrolled steps); this one cuts the costs of E-uni's
launch on the H100, the one-device 2D main path's kernel, as
compile-time variants of E-uni's own block (``csrc/heat_probe_temporal.cu``,
``csrc/heat_e_uni.cuh``), launched exactly as E-uni is, at its tile, K
and thread block:

- ``full``: E-uni as shipped, the only variant that computes E-uni's
  function;
- ``no_residual``: the last step folds no residual (the TPU's ``nores``);
- ``no_edge``: every tile stepped as an interior tile, no test a cell
  (``norowmask``);
- ``copy_step``: a copy in the combine's place, the walk's loads,
  shuffles and stores kept: the combine's share (what ``coeff`` asked);
- ``no_load``: no TMA box and no wait: the tiles' load;
- ``no_store``: the last step stores nothing, its residual kept so that
  the K steps stay live: the last store.

The TPU's ``unroll`` and its tile and substrip sweep have no counterpart:
nvcc unrolls the row walk, and ``bench_kernels.py --only e`` sweeps
E-uni's tiles.

Needs a CUDA device and nvcc. Checks first that ``full`` is bitwise
E-uni's plain version (grid and residual) on each plate at K, and
refuses to time otherwise. Prints the card's name and power limit, then
per plate one JSON line per variant (device ms of a launch with the
residual, ``torch.profiler`` over ``--made`` launches, and CUDA events)
and an ``anatomy`` line: what each cut saves against ``full``, in ms a
launch and as a share of it (a difference at the same K, not a slope: a
K-step launch's work a step grows with its halo); then a ``ladder`` line,
E-uni's own device time (no residual, as the main path launches it) at
each K of ``--ladder`` on the first plate, with a step and the launch's
fixed share by a least-squares fit over all of them and over the upper
half (at K = 1 and 2 a launch is held by its bytes, and the line bends).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from parallel_heat_tpu_torch.models import HeatPlate2D
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params

VARIANTS = ("full", "no_residual", "no_edge", "copy_step", "no_load",
            "no_store")
# What each cut variant takes out of a launch.
CUTS = {"residual": "no_residual", "edge_tests": "no_edge",
        "combine": "copy_step", "load": "no_load", "store": "no_store"}
SIZES = (16384, 8192)
LADDER = (1, 2, 4, 6, 8)
CX = CY = 0.1

# Launches of heat_probe_temporal since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_temporal": 0}


def probe_steps(variant: str, u: torch.Tensor, out: torch.Tensor, k: int,
                with_residual: bool = True, *, cx: float,
                cy: float) -> Optional[torch.Tensor]:
    """Variant ``variant`` of kernel E-uni: ``k`` steps of ``u`` into
    ``out`` in one launch at E-uni's tile and thread block; returns the
    last step's residual (``full`` only) or None. ``no_store`` always
    runs with its residual, which keeps its steps live. Only ``"full"``
    computes E-uni's function: on a CPU tensor it takes E-uni's plain
    version, and the other variants, which are no function, raise."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    sk._e_checked("heat_probe_temporal", u, out, k)
    if u.device.type == "cpu":
        if variant != "full":
            raise ValueError(f"probe variant {variant!r} is a measurement, "
                             f"not a function: it runs only on the card")
        return sk.temporal_steps_uni_plain(u, out, k, with_residual, cx=cx,
                                           cy=cy)
    p = params()
    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual or variant == "no_store" else None)
    sk._launch_e(u, out, k, bits, cx, cy, p.e_tile, p.e_block,
                 "heat_probe_temporal", VARIANTS.index(variant))
    counts["heat_probe_temporal"] += 1
    return (sk._residual_view(bits)
            if variant == "full" and with_residual else None)


def anatomy(sizes=SIZES, k: int = 8, ladder=LADDER, made: int = 40,
            device=None):
    """Yield the probe's JSON rows (see the module's docstring) on the
    ``size`` x ``size`` plates of ``sizes`` on ``device`` (the current
    CUDA device by default)."""
    from parallel_heat_tpu_torch.bench_kernels import card_line, device_ms
    from parallel_heat_tpu_torch.tools.probing import fit, time_row

    dev = device or torch.device("cuda", torch.cuda.current_device())
    kw = dict(cx=CX, cy=CY)
    card = card_line()
    p = params()
    launch = {"tile": list(p.e_tile), "block": list(p.e_block)}
    for size in sizes:
        u = HeatPlate2D(size, size).init_grid(dev)
        v, want = torch.empty_like(u), torch.empty_like(u)
        rp = sk.temporal_steps_uni_plain(u, want, k, **kw)
        rk = probe_steps("full", u, v, k, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(v, want) and torch.equal(rk, rp)):
            raise RuntimeError(f"probe variant 'full' at {size}^2, K = {k} "
                               f"is not bitwise E-uni's plain version")
        del want
        ms = {}
        for variant in VARIANTS:
            row = {"probe": variant, "size": size, "k": k, **launch,
                   "card": card}

            def run(kk, variant=variant):
                probe_steps(variant, u, v, kk, **kw)

            time_row(row, run, (k,), "heat_probe_temporal_kernel", made)
            ms[variant] = row["device_ms"][f"k{k}"]
            yield row
        full = ms["full"]
        cuts = {name: full - ms[variant] for name, variant in CUTS.items()}
        yield {"anatomy": "heat_e_uni_temporal", "size": size, "k": k,
               **launch, "full_ms": full, "cut_ms": cuts,
               "cut_share": {n: c / full for n, c in cuts.items()},
               "card": card}
        if size == sizes[0]:
            times = []
            for kk in ladder:
                def once(kk=kk):
                    sk.temporal_steps_uni(u, v, kk, False, **kw)

                times.append(device_ms(once, "heat_e_uni_temporal_kernel",
                                       made))
            step, fixed = fit(ladder, times)
            # The upper half alone: at small K a launch is held by its
            # bytes, not its steps, and the line bends.
            half = len(ladder) // 2
            upper = fit(ladder[half:], times[half:])
            yield {"ladder": "heat_e_uni_temporal", "size": size, **launch,
                   "device_ms": {f"k{kk}": t for kk, t in zip(ladder, times)},
                   "step_us": step, "fixed_us": fixed,
                   "upper_k": list(ladder[half:]), "upper_step_us": upper[0],
                   "upper_fixed_us": upper[1], "card": card}
        del u, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="plate sizes (the ladder runs on the first)")
    ap.add_argument("--k", type=int, default=params().e_k_default)
    ap.add_argument("--ladder", default=",".join(map(str, LADDER)),
                    help="depths of E-uni's K ladder")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a measurement")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_temporal: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    for row in anatomy([int(x) for x in args.sizes.split(",")], args.k,
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
