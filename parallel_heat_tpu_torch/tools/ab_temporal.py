"""How kernel E-uni pins the Dirichlet ring, A against B, on the card.

    python -m parallel_heat_tpu_torch.tools.ab_temporal
        [--sizes 16384,8192,1024] [--k 8] [--batches 3] [--tries 2]
        [--made 40] [--out FILE]

The Hopper port of the JAX package's ``tools/ab_temporal.py``. That
probe raced boundary forms of kernel E's strip pipeline on the TPU; this
one races E-uni's launch in variants that differ only in how a tile that
reaches past the grid's interior (an edge tile) keeps the ring fixed
(``csrc/heat_probe_ab_temporal.cu``); interior tiles run the same code in
every variant:

- ``prod``: as shipped: an edge tile tests each cell's row and column
  and copies the cells outside the interior;
- ``vcoeff``: per-lane coefficient vectors (a0 -> 1, cx and cy -> 0 on
  ring columns) and the coefficients (1, 0, 0) on ring rows, with no
  test a cell. A measurement only: 0 x inf poisons the ring of a
  diverging grid, and -0.0 + 0 turns a -0.0 ring cell into +0.0; on a
  CPU tensor it raises;
- ``rowcopy``: columns by the coefficient vectors; after every step the
  ring rows are restored from the step's source buffer, which holds them
  as loaded (the copy a step keeps), and the last step copies them by a
  test a row. It is bitwise ``prod`` on the plate and on finite random
  grids whose ring holds no -0.0 (and whose interior stays finite); on a
  CPU tensor it computes ``prod``'s plain version.

The TPU probe's ``vzero`` and ``vzero2`` zeroed the garbage bands its DMA
window left in scratch. E-uni's TMA box lands zeros outside the grid
(``csrc/heat_e_uni_temporal.cu``), so no band is left to zero: neither is
built, and asking for one raises.

Needs a CUDA device and nvcc. Checks first that ``prod`` and ``rowcopy``
are bitwise E-uni's plain version (grid and residual) on each plate at
K, and refuses to time otherwise. Prints the card's name and power
limit, then per plate: in each of ``--batches`` batches every variant in
turn (the order reversed every other batch), each timed ``--tries`` times
by its device time over ``--made`` launches with the residual
(``torch.profiler``) and by CUDA events (which at 1024^2 time the host's
launches, not the card), the minimum of each kept; one JSON line per
plate with each variant's batch times, its mean over ``prod``'s and
whether it beat ``prod`` in every batch (a variant wins only so).
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

VARIANTS = ("prod", "vcoeff", "rowcopy")
# The boundary forms' codes in csrc/heat_temporal.cuh (kHeatLoopFull,
# kHeatLoopVCoeff, kHeatLoopRowCopy).
CODES = {"prod": 0, "vcoeff": 6, "rowcopy": 7}
FUNCTIONS = ("prod", "rowcopy")
MOOT = ("vzero", "vzero2")
SIZES = (16384, 8192, 1024)
CX = CY = 0.1

# Launches of heat_probe_ab_temporal since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_ab_temporal": 0}


def ab_steps(variant: str, u: torch.Tensor, out: torch.Tensor, k: int,
             with_residual: bool = True, *, cx: float,
             cy: float) -> Optional[torch.Tensor]:
    """Boundary form ``variant`` of kernel E-uni: ``k`` steps of ``u``
    into ``out`` in one launch at E-uni's tile and thread block; returns
    the last step's residual (0-d float32 tensor) or None without
    ``with_residual``. On a CPU tensor ``prod`` and ``rowcopy`` take
    E-uni's plain version and ``vcoeff``, a measurement, raises."""
    if variant in MOOT:
        raise ValueError(f"{variant!r} is moot here: it zeroed the garbage "
                         f"bands a DMA window left in scratch, and E-uni's "
                         f"TMA load lands zeros outside the grid, so no "
                         f"band is left to zero")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    sk._e_checked("heat_probe_ab_temporal", u, out, k)
    if u.device.type == "cpu":
        if variant not in FUNCTIONS:
            raise ValueError(f"boundary form {variant!r} is a measurement, "
                             f"not a function: it runs only on the card")
        return sk.temporal_steps_uni_plain(u, out, k, with_residual, cx=cx,
                                           cy=cy)
    p = params()
    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual else None)
    sk._launch_e(u, out, k, bits, cx, cy, p.e_tile, p.e_block,
                 "heat_probe_ab_temporal", CODES[variant])
    counts["heat_probe_ab_temporal"] += 1
    return sk._residual_view(bits) if bits is not None else None


def turns(sizes=SIZES, k: int = 8, batches: int = 3, tries: int = 2,
          made: int = 40, device=None):
    """Yield the probe's JSON rows (see the module's docstring) on the
    ``size`` x ``size`` plates of ``sizes`` on ``device`` (the current
    CUDA device by default)."""
    from parallel_heat_tpu_torch.bench_kernels import card_line
    from parallel_heat_tpu_torch.tools.probing import time_row

    dev = device or torch.device("cuda", torch.cuda.current_device())
    kw = dict(cx=CX, cy=CY)
    card = card_line()
    p = params()
    for size in sizes:
        u = HeatPlate2D(size, size).init_grid(dev)
        v, want = torch.empty_like(u), torch.empty_like(u)
        rp = sk.temporal_steps_uni_plain(u, want, k, **kw)
        for variant in FUNCTIONS:
            v.fill_(float("nan"))
            rk = ab_steps(variant, u, v, k, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(v, want) and torch.equal(rk, rp)):
                raise RuntimeError(f"boundary form {variant!r} at {size}^2, "
                                   f"K = {k} is not bitwise E-uni's plain "
                                   f"version")
        del want
        times = {variant: [] for variant in VARIANTS}
        events = {variant: [] for variant in VARIANTS}
        for b in range(batches):
            order = VARIANTS if b % 2 == 0 else VARIANTS[::-1]
            for variant in order:
                def run(kk, variant=variant):
                    ab_steps(variant, u, v, kk, **kw)

                rows = [time_row({}, run, (k,),
                                 "heat_probe_ab_temporal_kernel", made)
                        for _ in range(tries)]
                times[variant].append(min(r["device_ms"][f"k{k}"]
                                          for r in rows))
                events[variant].append(min(r["events_ms"][f"k{k}"]
                                           for r in rows))
        prod = times["prod"]
        kinds = p.e_tile_kinds((size, size), k)
        yield {"ab": "heat_e_uni_temporal", "size": size, "k": k,
               "tile": list(p.e_tile), "block": list(p.e_block),
               "edge_tile_share": kinds["copies"] / kinds["tiles"],
               "device_ms": times, "events_ms": events,
               "over_prod": {n: sum(t) / sum(prod) for n, t in times.items()},
               "wins_every_batch": {
                   n: all(a < b for a, b in zip(t, prod))
                   for n, t in times.items() if n != "prod"},
               "card": card}
        del u, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--k", type=int, default=params().e_k_default)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--tries", type=int, default=2,
                    help="timings of a variant a batch, the least kept")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a timing")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_temporal: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    for row in turns([int(x) for x in args.sizes.split(",")], args.k,
                     args.batches, args.tries, args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
