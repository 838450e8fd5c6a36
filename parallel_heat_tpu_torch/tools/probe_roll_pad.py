"""How the tile loop takes a cell's left and right neighbours, on the card.

    python -m parallel_heat_tpu_torch.tools.probe_roll_pad
        [--plates A:1000:20,A:1000:64,A:1859:64,E-uni:16384:8]
        [--batches 3] [--tries 2] [--made 40] [--sass] [--out FILE]

The Hopper port of the JAX package's ``tools/ab_roll_pad.py``. That
probe raced kernel A against a form whose state lived in padded
(M, N+2) buffers, the left and right neighbours read as lane-offset
slices instead of two lane rolls. Here the register-blocked tile loop
that A, M, E, E-uni and G share (``csrc/heat_temporal.cuh`` ``heat_rows``)
holds a lane's 4 columns of a row in a float4 register, and the
neighbours belong to the lanes beside it. Three forms that compute the
same function (``csrc/heat_probe_roll_pad.cu``), each on kernel A's
launch and on kernel E-uni's, exactly as those launch:

- ``prod``: as shipped, two warp shuffles a row, and one broadcast
  shared load for lanes 0 and 31;
- ``padslice`` (the TPU variant's analog): no shuffle, each lane reads
  the float before and the float after its group from shared memory;
- ``nbr4``: no shuffle, each lane reads the neighbour groups' float4s.

All three are A's (or E-uni's) function: on a CPU tensor each takes the
kernel's plain version.

Needs a CUDA device and nvcc. First :func:`check` holds every form
bitwise to its kernel's plain version (grid and residual) where the
forms' reads differ from the shuffles' (the row's last group in an active
lane): A at every halo depth 1 .. 8 on a random 1000^2 and at several K
on 1001 x 999, 21 x 23 and 20 x 24, E-uni at every compiled K on
1001 x 1000 and 20 x 24. Then per plate (kernel, size, K) every form
again on the plate and on a random grid, and refuses to time otherwise.
Prints the card's name and power limit, then per plate: in each of
``--batches`` batches every form in turn (the order reversed every other
batch), each timed ``--tries`` times by its device time over ``--made``
launches with the residual (``torch.profiler``) and by CUDA events, the
least of each kept; one JSON line per plate with each form's batch
times, its mean over ``prod``'s and whether it beat ``prod`` in every
batch (a form wins only so). With ``--sass``, one line per kernel
instance: instructions, shared loads (LDS), shuffles (SHFL) and shared
bytes a cell-step of each stepping loop.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from parallel_heat_tpu_torch.models import HeatPlate2D
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

FORMS = ("prod", "padslice", "nbr4")
# The neighbour forms' codes in csrc/heat_temporal.cuh (kHeatLoopFull,
# kHeatLoopPadSlice, kHeatLoopNbr4) and the kernels' in
# csrc/heat_probe_roll_pad.cu.
CODES = {"prod": 0, "padslice": 10, "nbr4": 11}
KERNELS = {"A": 0, "E-uni": 1}
# (kernel, size, K): A at BASELINE Table 7's converge window and at the
# TPU probe's K, A at its largest square (the TPU probe's 2048^2 does not
# fit A here), E-uni at the main path's 16384^2.
PLATES = (("A", 1000, 20), ("A", 1000, 64), ("A", 1859, 64),
          ("E-uni", 16384, 8))
CX = CY = 0.1

# Launches of heat_probe_roll_pad since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_roll_pad": 0}


def instance(kernel: str, form: str) -> str:
    """The name of ``form``'s kernel instance on ``kernel``'s launch, as
    the profiler reports it."""
    if kernel == "E-uni":
        return f"heat_probe_roll_pad_kernel<{CODES[form]}>"
    return ("heat_a_resident_kernel<0>" if form == "prod"
            else f"heat_a_loop_kernel<{CODES[form]}>")


def roll_pad_steps(kernel: str, form: str, u: torch.Tensor,
                   out: torch.Tensor, k: int, with_residual: bool = True, *,
                   cx: float, cy: float,
                   depth: Optional[int] = None) -> Optional[torch.Tensor]:
    """Neighbour form ``form`` of kernel ``kernel`` ("A" or "E-uni"):
    ``k`` steps of ``u`` into ``out`` in one launch at the kernel's own
    launch shape (A's at halo depth ``depth`` and the tile
    ``hopper_params.a_tile`` takes for it, where given); returns the last
    step's residual (0-d float32 tensor) or None without
    ``with_residual``. Every form computes the kernel's function: on a CPU
    tensor it takes the kernel's plain version."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of "
                         f"{tuple(KERNELS)}")
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    p = params()
    if kernel == "A":
        launch = sk._a_checked(u, out, k)
        if depth is not None:
            tile = p.a_tile(tuple(u.shape), depth, p.a_block)
            if tile is None:
                raise ValueError(f"grid {tuple(u.shape)} does not fit "
                                 f"resident at halo depth {depth}")
            launch = {"tile": tile, "depth": depth, "block": p.a_block}
        if u.device.type == "cpu":
            return sk.resident_steps_plain(u, out, k, with_residual, cx=cx,
                                           cy=cy)
        xch, bits = sk.a_scratch(u, k, launch, with_residual)
    else:
        if depth is not None:
            raise ValueError("E-uni has no halo depth but K")
        sk._e_checked("heat_probe_roll_pad", u, out, k)
        if u.device.type == "cpu":
            return sk.temporal_steps_uni_plain(u, out, k, with_residual,
                                               cx=cx, cy=cy)
        launch = {"tile": p.e_tile, "depth": 0, "block": p.e_block}
        xch = None
        bits = (torch.empty(1, dtype=torch.int32, device=u.device)
                if with_residual else None)
    from parallel_heat_tpu_torch.kernels.build import load

    lib = load("heat_probe_roll_pad")
    code = lib.heat_probe_roll_pad(
        KERNELS[kernel], CODES[form], u.data_ptr(), out.data_ptr(),
        sk._ptr(xch), sk._ptr(bits), u.shape[0], u.shape[1], k,
        launch["depth"], launch["tile"][0], launch["tile"][1],
        launch["block"][0], launch["block"][1], *coeffs_f32(cx, cy),
        sk._stream(u))
    sk._raise_on_error(lib, "heat_probe_roll_pad", code)
    counts["heat_probe_roll_pad"] += 1
    return sk._residual_view(bits) if bits is not None else None


def _plain(kernel, u, out, k, **kw):
    plain = (sk.resident_steps_plain if kernel == "A"
             else sk.temporal_steps_uni_plain)
    return plain(u, out, k, True, **kw)


def _hold(kernel, u, k, what, depth=None, **kw) -> dict:
    """Every form of ``kernel`` on ``u`` at depth ``k`` bitwise the
    kernel's plain version, grid and residual (RuntimeError otherwise);
    returns each form's max |diff| (0.0)."""
    want = torch.empty_like(u)
    rp = _plain(kernel, u, want, k, **kw)
    err = {}
    for form in FORMS:
        got = torch.full_like(u, float("nan"))
        r = roll_pad_steps(kernel, form, u, got, k, cx=kw["cx"],
                           cy=kw["cy"], depth=depth)
        if u.is_cuda:
            torch.cuda.synchronize()
        diff = err[form] = float((got - want).abs().max())
        if not (torch.equal(got, want) and torch.equal(r, rp)):
            raise RuntimeError(
                f"neighbour form {form!r} of {kernel} on {what} "
                f"(K = {k}{'' if depth is None else f', depth {depth}'}) is "
                f"not bitwise its plain version: max diff {diff}, "
                f"{int((got != want).sum())} cells differ, residual "
                f"{float(r)} against {float(rp)}")
    return err


def check(device=None) -> dict:
    """Every form bitwise its kernel's plain version (grid and residual)
    on the grids where the forms' reads differ from the shuffles' (see the
    module's docstring); raises RuntimeError otherwise. Returns ``{"A":
    [...], "E-uni": [...]}``, the (shape, K, depth) checked, and
    ``max_abs_err``, by kernel and form."""
    dev = device or torch.device("cuda", torch.cuda.current_device())
    p = params()
    rng = np.random.default_rng(23)
    kw = dict(cx=CX, cy=CY)
    done = {"A": [], "E-uni": []}
    err = {kernel: dict.fromkeys(FORMS, 0.0) for kernel in KERNELS}

    def hold(kernel, u, k, depth=None):
        for form, diff in _hold(kernel, u, k, tuple(u.shape), depth,
                                **kw).items():
            err[kernel][form] = max(err[kernel][form], diff)
        done[kernel].append([list(u.shape), k, depth])

    def rand(shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)

    u = rand((1000, 1000))
    for d in range(1, 9):
        if p.a_tile((1000, 1000), d, p.a_block) is not None:
            hold("A", u, 20, d)
    for shape, ks in (((1001, 999), (1, 5, 20)), ((21, 23), (1, 3, 4, 9, 20)),
                      ((20, 24), (1, 4, 9, 20))):
        u = rand(shape)
        for k in ks:
            hold("A", u, k)
    for shape in ((1001, 1000), (20, 24)):
        u = rand(shape)
        for k in range(1, p.e_k_max() + 1):
            hold("E-uni", u, k)
    return {**done, "max_abs_err": err}


def turns(plates=PLATES, batches: int = 3, tries: int = 2, made: int = 40,
          device=None):
    """Yield the probe's JSON rows (see the module's docstring) for the
    ``(kernel, size, K)`` plates of ``plates`` on ``device`` (the current
    CUDA device by default)."""
    from parallel_heat_tpu_torch.bench_kernels import card_line
    from parallel_heat_tpu_torch.tools.probing import time_row

    dev = device or torch.device("cuda", torch.cuda.current_device())
    kw = dict(cx=CX, cy=CY)
    card = card_line()
    p = params()
    rng = np.random.default_rng(29)
    for kernel, size, k in plates:
        noise = torch.from_numpy((rng.standard_normal((size, size)) * 10
                                  ).astype(np.float32)).to(dev)
        _hold(kernel, noise, k, f"random {size}^2", **kw)
        del noise
        u = HeatPlate2D(size, size).init_grid(dev)
        _hold(kernel, u, k, f"the {size}^2 plate", **kw)
        v = torch.empty_like(u)
        times = {form: [] for form in FORMS}
        events = {form: [] for form in FORMS}
        for b in range(batches):
            order = FORMS if b % 2 == 0 else FORMS[::-1]
            for form in order:
                def run(kk, form=form):
                    roll_pad_steps(kernel, form, u, v, kk, **kw)

                rows = [time_row({}, run, (k,), instance(kernel, form), made)
                        for _ in range(tries)]
                times[form].append(min(r["device_ms"][f"k{k}"]
                                       for r in rows))
                events[form].append(min(r["events_ms"][f"k{k}"]
                                        for r in rows))
        if kernel == "A":
            launch = sk.a_launch((size, size))
        else:
            launch = {"tile": p.e_tile, "depth": None, "block": p.e_block}
        prod = times["prod"]
        yield {"roll_pad": ("heat_a_resident" if kernel == "A"
                            else "heat_e_uni_temporal"),
               "size": size, "k": k, "tile": list(launch["tile"]),
               "depth": launch["depth"], "block": list(launch["block"]),
               "device_ms": times, "events_ms": events,
               "over_prod": {f: sum(t) / sum(prod) for f, t in times.items()},
               "wins_every_batch": {
                   f: all(a < b for a, b in zip(t, prod))
                   for f, t in times.items() if f != "prod"},
               "card": card}
        del u, v
        torch.cuda.empty_cache()


def sass_rows():
    """Per kernel instance of the probe's library (its SASS, by
    ``cuobjdump``): each stepping loop's instructions, shared loads,
    shuffles and shared bytes a cell-step, and the test-free inner step's
    (``bench_kernels.sass_step_report``)."""
    from parallel_heat_tpu_torch.bench_kernels import (_sass_functions,
                                                       sass_step_report)
    from parallel_heat_tpu_torch.kernels import build

    path = build.build("heat_probe_roll_pad")["heat_probe_roll_pad"]
    _, sass = _sass_functions(path)
    for row in sass_step_report(sass):
        yield {"sass": build.demangle(row["instance"]),
               "step_per_cell_step": row["step_per_cell_step"],
               "loops": row["loops"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plates", default=",".join(
        f"{kernel}:{size}:{k}" for kernel, size, k in PLATES),
        help="kernel:size:K, comma-separated")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--tries", type=int, default=2,
                    help="timings of a form a batch, the least kept")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a timing")
    ap.add_argument("--sass", action="store_true",
                    help="also print each instance's loop counts")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_roll_pad: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    plates = [(kernel, int(size), int(k)) for kernel, size, k in
              (x.split(":") for x in args.plates.split(","))]
    print(card_line(), flush=True)
    rows = [{"check": "heat_probe_roll_pad", **check()}]
    print(json.dumps(rows[0]), flush=True)
    for row in turns(plates, args.batches, args.tries, args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.sass:
        for row in sass_rows():
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
