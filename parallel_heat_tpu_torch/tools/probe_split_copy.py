"""Does the form of kernel E-uni's tile load cost its steps anything?

    python -m parallel_heat_tpu_torch.tools.probe_split_copy
        [--sizes 16384,4096] [--k 8] [--batches 3] [--tries 2]
        [--made 40] [--out FILE] [--sass]

The Hopper port of the JAX package's ``tools/probe_split_copy.py``. That
probe split kernel E's strip copy on the TPU, the compute kept; this one
(``csrc/heat_probe_split_copy.cu``) launches E-uni's block, the
one-device 2D main path's kernel, with its tile's load cut into pieces,
at E-uni's tile, K and thread block. The TPU's names, on Hopper:

- ``whole``: one TMA box, one mbarrier: E-uni as shipped;
- ``lanes2``, ``lanes4``: 2 or 4 column slices, an mbarrier each; a box
  lands with its own row pitch, so a slice is one box a row;
- ``lanes2-1sem``: the two slices on one mbarrier;
- ``rows2``: two boxes of half the rows, an mbarrier each;
- ``subwin``: the shared rows 32 floats wider than the box, filled by one
  box a row (the slot wider than its copy);
- ``branchy``: ``whole``'s box issued under three branches on where the
  tile lies;
- ``rows<w>`` (``w`` the block's warps, ``rows8`` at E-uni's 32 x 8):
  one box and one mbarrier per warp's run of rows, a warp waiting only on
  the bands that its first step reads.

Every form computes E-uni's K steps without the residual, so on a CPU
tensor each takes E-uni's plain version. A box lands on a 128-byte
boundary of shared memory, so every form but ``whole`` and ``branchy``
needs shared rows of a multiple of 32 floats (at E-uni's 96 x 112 tile,
K = 5 .. 8), lane slices of a multiple of 32 floats, and ``rows2`` an even
number of rows; other geometry is refused, on every device.

Needs a CUDA device and nvcc. Checks first that every form is bitwise
E-uni's plain version on each plate at K, and refuses to time otherwise.
Prints the card's name and power limit, then per plate one JSON line: in
each of ``--batches`` batches every form in turn (the order reversed
every other batch), each timed ``--tries`` times by its device time over
``--made`` launches (``torch.profiler``) and by CUDA events, the minimum
of each kept; each form's mean over ``whole``'s and whether it beat
``whole`` in every batch.
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

# The TPU probe's forms, in the order of csrc/heat_e_uni.cuh's codes
# (kHeatLoadWhole .. kHeatLoadBranchy); rows<w> is code 7.
TPU_FORMS = ("whole", "lanes2", "lanes2-1sem", "rows2", "lanes4", "subwin",
             "branchy")
ROW_BANDS = 7
SLICES = {"lanes2": 2, "lanes2-1sem": 2, "lanes4": 4}
SIZES = (16384, 4096)
CX = CY = 0.1

# Launches of heat_probe_split_copy since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_split_copy": 0}


def variants(block=None) -> tuple:
    """The forms at thread block ``block`` (E-uni's by default): the
    TPU's seven and ``rows<w>``."""
    return TPU_FORMS + (f"rows{(block or params().e_block)[1]}",)


def code(variant: str, block=None) -> int:
    """The form's code in ``csrc/heat_e_uni.cuh``."""
    if variant in TPU_FORMS:
        return TPU_FORMS.index(variant)
    if variant == variants(block)[-1]:
        return ROW_BANDS
    raise ValueError(f"unknown form {variant!r}; one of {variants(block)}")


def refusal(variant: str, k: int, tile=None, block=None) -> Optional[str]:
    """Why form ``variant`` cannot load a framed tile of ``tile`` at depth
    ``k`` (``csrc/heat_e_uni.cuh`` ``heat_e_uni_load_fits``), or None."""
    code(variant, block)
    if variant in ("whole", "branchy"):
        return None
    ty, tx = tile or params().e_tile
    sy, sx = ty + 2 * k, params().row_floats(k, tx)
    if sx % 32:
        return (f"{variant}: shared rows of {sx} floats at K={k} and tile "
                f"{(ty, tx)}; a box lands on a 128-byte boundary, so the "
                f"rows must be a multiple of 32 floats")
    slices = SLICES.get(variant, 1)
    if (sx // slices) % 32:
        return (f"{variant}: {slices} slices of a {sx}-float row are "
                f"{sx // slices} floats, not a multiple of 32")
    if variant == "rows2" and sy % 2:
        return f"rows2: {sy} rows do not split in two halves"
    return None


def split_steps(variant: str, u: torch.Tensor, out: torch.Tensor, k: int,
                *, cx: float, cy: float, tile=None, block=None) -> None:
    """Load form ``variant`` of kernel E-uni: ``k`` steps of ``u`` into
    ``out`` in one launch at ``tile`` and ``block`` (E-uni's by default),
    no residual. Every form computes E-uni's function: on a CPU tensor it
    takes E-uni's plain version. Raises for a form the geometry refuses
    (:func:`refusal`), on every device."""
    code(variant, block)
    sk._e_checked("heat_probe_split_copy", u, out, k)
    why = refusal(variant, k, tile, block)
    if why is not None:
        raise ValueError(why)
    if u.device.type == "cpu":
        sk.temporal_steps_uni_plain(u, out, k, False, cx=cx, cy=cy)
        return
    p = params()
    sk._launch_e(u, out, k, None, cx, cy, tuple(tile or p.e_tile),
                 tuple(block or p.e_block), "heat_probe_split_copy",
                 code(variant, block))
    counts["heat_probe_split_copy"] += 1


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
    forms = [v for v in variants() if refusal(v, k) is None]
    for size in sizes:
        u = HeatPlate2D(size, size).init_grid(dev)
        v, want = torch.empty_like(u), torch.empty_like(u)
        sk.temporal_steps_uni_plain(u, want, k, False, **kw)
        for form in forms:
            v.fill_(float("nan"))
            split_steps(form, u, v, k, **kw)
            torch.cuda.synchronize()
            if not torch.equal(v, want):
                raise RuntimeError(f"load form {form!r} at {size}^2, K = {k} "
                                   f"is not bitwise E-uni's plain version")
        del want
        times = {form: [] for form in forms}
        events = {form: [] for form in forms}
        for b in range(batches):
            for form in (forms if b % 2 == 0 else forms[::-1]):
                def run(kk, form=form):
                    split_steps(form, u, v, kk, **kw)

                rows = [time_row({}, run, (k,),
                                 "heat_probe_split_copy_kernel", made)
                        for _ in range(tries)]
                times[form].append(min(r["device_ms"][f"k{k}"] for r in rows))
                events[form].append(min(r["events_ms"][f"k{k}"] for r in rows))
        whole = times["whole"]
        yield {"split": "heat_e_uni_temporal", "size": size, "k": k,
               "tile": list(p.e_tile), "block": list(p.e_block),
               "device_ms": times, "events_ms": events,
               "over_whole": {n: sum(t) / sum(whole)
                              for n, t in times.items()},
               "wins_every_batch": {
                   n: all(a < b for a, b in zip(t, whole))
                   for n, t in times.items() if n != "whole"},
               "refused": {f: refusal(f, k) for f in variants()
                           if f not in forms},
               "card": card}
        del u, v
        torch.cuda.empty_cache()


def sass_report():
    """Per form's kernel instance, the TMA loads (``UTMALDG``) and
    mbarrier waits (``SYNCS``) in its machine code (``cuobjdump -sass``):
    whether ``branchy``'s three issues stay three."""
    from parallel_heat_tpu_torch import bench_kernels as bk
    from parallel_heat_tpu_torch.kernels import build

    path = build.build("heat_probe_split_copy")["heat_probe_split_copy"]
    functions, _ = bk._sass_functions(path)
    for name, instrs in sorted(functions.items()):
        yield {"sass": build.demangle(name),
               "utmaldg": sum("UTMALDG" in i for i in instrs),
               "syncs": sum(i.startswith("SYNCS") or " SYNCS" in i
                            for i in instrs),
               "instructions": len(instrs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--k", type=int, default=params().e_k_default)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--tries", type=int, default=2,
                    help="timings of a form a batch, the least kept")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a timing")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--sass", action="store_true",
                    help="first print each form's TMA loads and mbarrier "
                         "waits in its machine code")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_split_copy: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    if args.sass:
        for row in sass_report():
            print(json.dumps(row), flush=True)
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
