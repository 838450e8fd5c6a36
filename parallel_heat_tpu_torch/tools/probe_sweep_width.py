"""The shared-memory sweep's rate along a ladder of row widths, on the card.

    python -m parallel_heat_tpu_torch.tools.probe_sweep_width
        [--widths 124,128,...,384] [--depths 64,1024] [--made 40]
        [--out FILE]

The Hopper port of the JAX package's ``tools/probe_sweep_width.py``. That
probe swept one VMEM-resident ``(272, N)`` pair at widths N of 4096 to
5120 to find lane-tile-count cliffs. A TPU core's VMEM holds that pair;
on Hopper its counterpart is one SM's shared memory, which a row of 4096
floats by 272 rows does not fit, so this one
(``csrc/heat_probe_sweep_width.cu``, body ``csrc/heat_probe_sweep.cuh``)
runs a stack of ``(R, w)`` members, one block of 32 x 16 threads an SM,
each sweeping its member's band of rows in the tile loop's layout: warps
on runs of rows, lanes on groups of 4 columns in passes of 32. The
ladder's widths lie around the rows that E's and G's 112-wide tiles give
the tile loop (``row_floats``: 120 floats at K <= 4, 128 at K = 5 .. 8)
and past them: 124 to 384 floats, R = 73, rows [8, 72), every pair of
buffers under a block's 227 KB.

The function (:func:`sweep_plain`): both buffers start as the member,
then ``D // 2`` pairs of sweeps of rows ``[lo, lo + rows)``, ``new =
(0.6 C + 0.1 (U + D)) + 0.1 (L + R)`` rounded in float32 in that order, L
and R periodic along the row; rows outside the band are the input.

Needs a CUDA device and nvcc. Checks first that the kernel is bitwise its
plain version at each width, and refuses to time otherwise. Prints the
card's name and power limit, then one JSON line per width: device ms
(``torch.profiler``) and CUDA-event ms of a launch at each depth of
``--depths``, µs a sweep by the slope between them (the one load and
store and the launch cancel), Gcells/s, its share of the ladder's best,
the SM clock under it and the sweep's bound (shared bytes, each band cell
read and written once, over 128 bytes a clock an SM at the maximum
clock); and ``conv2d`` with circular padding, chained, a sweep over the
stack (TF32 off), the yardstick.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params

WIDTHS = (124, 128, 132, 136, 144, 160, 192, 256, 320, 384)
R, LO, ROWS = 73, 8, 64
BLOCK = (32, 16)
DEPTHS = (64, 1024)
# The sweep's coefficients, float32 (the TPU probes' a0 and cc), and its
# FP32 operations a cell: 3 multiplies and 4 adds.
A0 = float(np.float32(0.6))
CC = float(np.float32(0.1))
OPS_PER_CELL = 7

# Launches of heat_probe_sweep_width since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_sweep_width": 0}


def _check(u, out, sweeps, lo, rows) -> None:
    if u.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"float32 stacks only, got {u.dtype} -> {out.dtype}")
    if u.dim() != 3 or out.shape != u.shape:
        raise ValueError(f"need an (S, R, w) stack and an out of its shape, "
                         f"got {tuple(u.shape)} -> {tuple(out.shape)}")
    _, r, w = u.shape
    if w < 4 or lo < 1 or rows < 1 or lo + rows > r - 1:
        raise ValueError(f"a band of rows [{lo}, {lo + rows}) needs a row "
                         f"above and below it in {r} rows, and a width of "
                         f"at least 4 (got {w})")
    if sweeps < 0:
        raise ValueError(f"sweeps must be at least 0, got {sweeps}")
    budget = params().smem_per_block_max
    if 2 * 4 * r * w > budget:
        raise ValueError(f"a pair of {r} x {w} buffers, {8 * r * w} bytes, "
                         f"exceeds a block's {budget} bytes of shared "
                         f"memory")
    if u.device != out.device or u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"u on {u.device}, out on {out.device}")
    if not (u.is_contiguous() and out.is_contiguous()):
        raise ValueError("u and out must be contiguous")
    if u.data_ptr() == out.data_ptr():
        raise ValueError("out must be a different buffer from u")


def sweep_plain(u: torch.Tensor, out: torch.Tensor, sweeps: int, *,
                lo: int = LO, rows: int = ROWS) -> None:
    """Plain version of the sweep probes: ``sweeps // 2`` pairs of sweeps
    of rows ``[lo, lo + rows)`` of every member of the (S, R, w) stack
    ``u`` into ``out``, both buffers starting as the member, each
    operation rounded in float32 in the kernel's order."""
    _check(u, out, sweeps, lo, rows)
    a0 = torch.tensor(A0, dtype=torch.float32, device=u.device)
    cc = torch.tensor(CC, dtype=torch.float32, device=u.device)
    a, b = u.clone(), u.clone()

    def one(src, dst):
        c = src[:, lo:lo + rows]
        new = ((a0 * c + cc * (src[:, lo - 1:lo + rows - 1]
                               + src[:, lo + 1:lo + rows + 1]))
               + cc * (torch.roll(c, 1, 2) + torch.roll(c, -1, 2)))
        dst[:, lo:lo + rows] = new

    for _ in range(sweeps // 2):
        one(a, b)
        one(b, a)
    out.copy_(a)


def launch(name: str, u: torch.Tensor, out: torch.Tensor, sweeps: int,
           lo: int, rows: int) -> None:
    """One launch of sweep probe ``name`` (``heat_probe_sweep_width`` or
    ``heat_probe_store_align``, the same body) on a CUDA stack; checks
    nothing and counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    lib = load(name)
    code = getattr(lib, name)(u.data_ptr(), out.data_ptr(), *u.shape, lo,
                              rows, sweeps, *BLOCK, sk._stream(u))
    sk._raise_on_error(lib, name, code)


def sweep(u: torch.Tensor, out: torch.Tensor, sweeps: int, *, lo: int = LO,
          rows: int = ROWS) -> None:
    """``sweeps // 2`` pairs of sweeps of rows ``[lo, lo + rows)`` of every
    member of the (S, R, w) float32 stack ``u`` into ``out``, one block an
    SM (:func:`sweep_plain` is the function). On a CPU tensor it takes its
    plain version."""
    _check(u, out, sweeps, lo, rows)
    if u.device.type == "cpu":
        sweep_plain(u, out, sweeps, lo=lo, rows=rows)
        return
    launch("heat_probe_sweep_width", u, out, sweeps, lo, rows)
    counts["heat_probe_sweep_width"] += 1


def conv_ms(u: torch.Tensor, reps: int = 8) -> float:
    """``conv2d`` with circular padding and the sweep's weights, chained
    ``reps`` times over the whole stack, by CUDA events: ms a sweep."""
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.bench_kernels import time_ms

    torch.backends.cudnn.allow_tf32 = False
    w = torch.tensor([[0.0, CC, 0.0], [CC, A0, CC], [0.0, CC, 0.0]],
                     dtype=torch.float32, device=u.device).view(1, 1, 3, 3)
    x = u.unsqueeze(1)

    def chain():
        y = x
        for _ in range(reps):
            y = F.conv2d(F.pad(y, (1, 1, 1, 1), mode="circular"), w)

    return time_ms(chain, 3) / reps


def bound_us(shape, rows: int, sms: int, clock_mhz: float):
    """``(µs, "shared bytes" or "operations")``: the least time of one
    sweep of ``rows`` rows of every member of an (S, R, w) stack, its
    shared bytes (each band cell read once and written once) over 128
    bytes a clock an SM, or its FP32 operations over 128 lanes a clock an
    SM, whichever is larger."""
    s, _, w = shape
    cells = s * rows * w
    per_us = 128 * sms * clock_mhz
    t_bytes, t_ops = 8 * cells / per_us, OPS_PER_CELL * cells / per_us
    return ((t_bytes, "shared bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def slopes(run, shapes, rows: int, depths, instance: str, made: int,
           device):
    """Yield, for each ``(label, shape)`` of ``shapes``, a JSON row of
    ``run(u, out, d)`` on a random stack of ``shape`` timed at each depth
    of ``depths`` (sweeps): device and event ms, µs a sweep by the slope,
    Gcells/s, the SM clock under it, the bound and the ``conv2d``
    yardstick. Checks ``run`` bitwise its plain version (``run(u, out,
    d, plain=True)``) at 4 sweeps first."""
    from parallel_heat_tpu_torch.bench_kernels import card_line
    from parallel_heat_tpu_torch.tools.probing import slope_row, time_row
    from parallel_heat_tpu_torch.tools.vpu_roofline import sm_clocks

    card = card_line()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    hi = max(depths)
    for label, shape in shapes:
        u = torch.from_numpy(np.random.default_rng(shape[-1]).standard_normal(
            shape).astype(np.float32)).to(device)
        v, want = torch.empty_like(u), torch.empty_like(u)
        run(u, v, 4)
        run(u, want, 4, plain=True)
        torch.cuda.synchronize()
        if not torch.equal(v, want):
            raise RuntimeError(f"{instance} at {label} differs from its "
                               f"plain version in {int((v != want).sum())} "
                               f"cells")
        row = {**label, "members": shape[0], "rows_total": shape[1],
               "width": shape[2], "rows": rows, "block": list(BLOCK),
               "card": card}
        time_row(row, lambda d, u=u, v=v: run(u, v, d), depths, instance,
                 made, key="d")
        slope_row(row, depths, key="d", per="sweep")
        us = row["device_us"]["sweep"]
        launches = max(1, int(300 / row["device_ms"][f"d{hi}"]))
        clock, most = sm_clocks(lambda: run(u, v, hi), launches)
        bound, by = bound_us(shape, rows, sms, most)
        cells = shape[0] * rows * shape[2]
        row.update({"us_per_sweep": us, "g_cells_per_s": cells / us / 1e3,
                    "g_cells_per_s_per_sm": cells / us / 1e3 / sms,
                    "shared_bytes_per_clock_per_sm": 8 * cells / us / sms
                    / clock, "sm_clock_mhz": clock,
                    "max_sm_clock_mhz": most, "bound_us_per_sweep": bound,
                    "bound_by": by, "bound_share": bound / us,
                    "conv2d_circular_us_per_sweep": conv_ms(u) * 1e3})
        yield row
        del u, v, want


def ladder(widths=WIDTHS, depths=DEPTHS, made: int = 40, device=None):
    """Yield the probe's JSON rows (see the module's docstring): a stack
    of one ``R`` x ``w`` member an SM of ``device`` (the current CUDA
    device by default) at each width of ``widths``, then a ``best`` line."""
    dev = device or torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run(u, v, d, plain=False):
        (sweep_plain if plain else sweep)(u, v, d)

    rows = list(slopes(run, [({"sweep_width": w}, (sms, R, w))
                             for w in widths], ROWS, depths,
                       "heat_probe_sweep_width_kernel", made, dev))
    best = max(r["g_cells_per_s"] for r in rows)
    for r in rows:
        r["over_best"] = r["g_cells_per_s"] / best
        yield r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--depths", default=",".join(map(str, DEPTHS)),
                    help="sweep counts whose slope is a sweep (smallest, "
                         "largest)")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a measurement")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_sweep_width: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    for row in ladder([int(x) for x in args.widths.split(",")],
                      [int(x) for x in args.depths.split(",")], args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
