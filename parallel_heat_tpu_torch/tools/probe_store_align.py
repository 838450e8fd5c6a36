"""What the shared-memory sweep's stores cost when they cannot be 16-byte
vectors, and whether the band's first row moves anything, on the card.

    python -m parallel_heat_tpu_torch.tools.probe_store_align
        [--offsets 1,8,9,16] [--widths 128,129] [--depths 64,1024]
        [--made 40] [--out FILE]

The Hopper port of the JAX package's ``tools/probe_store_align.py``. That
probe timed one VMEM-resident ``(296, 4224)`` ping-pong sweep with its
band of rows starting at 1, 8, 9 and 16, to price stores that straddle
the TPU's (8, 128) tiling. Shared memory has no row tiling: a row of w
floats starts on 16 bytes whenever w is a multiple of 4. So this one
(``csrc/heat_probe_store_align.cu``, the width ladder's body
``csrc/heat_probe_sweep.cuh``) runs each offset at a row pitch that is a
multiple of 4 floats (128: float4 loads and stores) and at one more (129:
no 16-byte access aligned, one float a lane), on a stack of one 81 x w
member an SM, rows [lo, lo + 64).

The function is :func:`~.probe_sweep_width.sweep_plain`'s with the band's
first row ``lo``. It measures shared memory only, as the TPU probe
measured VMEM only.

Needs a CUDA device and nvcc. Checks first that the kernel is bitwise its
plain version at each offset and width, and refuses to time otherwise.
Prints the card's name and power limit, then one JSON line per width and
offset (the width ladder's fields: µs a sweep by the slope between the
depths, Gcells/s, the bound, the ``conv2d`` yardstick) with its rate
over ``lo = 8``'s at the same width and over the aligned width's at the
same offset.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from parallel_heat_tpu_torch.tools import probe_sweep_width as psw

OFFSETS = (1, 8, 9, 16)
WIDTHS = (128, 129)
R, ROWS = 81, 64

# Launches of heat_probe_store_align since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_store_align": 0}


def align_sweep(u: torch.Tensor, out: torch.Tensor, sweeps: int, *,
                lo: int, rows: int = ROWS) -> None:
    """``sweeps // 2`` pairs of sweeps of rows ``[lo, lo + rows)`` of every
    member of the (S, R, w) float32 stack ``u`` into ``out``, one block an
    SM (``probe_sweep_width.sweep_plain`` is the function). On a CPU tensor
    it takes its plain version."""
    psw._check(u, out, sweeps, lo, rows)
    if u.device.type == "cpu":
        psw.sweep_plain(u, out, sweeps, lo=lo, rows=rows)
        return
    psw.launch("heat_probe_store_align", u, out, sweeps, lo, rows)
    counts["heat_probe_store_align"] += 1


def offsets(widths=WIDTHS, los=OFFSETS, depths=psw.DEPTHS, made: int = 40,
            device=None):
    """Yield the probe's JSON rows (see the module's docstring): a stack
    of one ``R`` x ``w`` member an SM of ``device`` (the current CUDA
    device by default) at each width and offset."""
    dev = device or torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for w in widths:
        for lo in los:
            def run(u, v, d, plain=False, lo=lo):
                if plain:
                    psw.sweep_plain(u, v, d, lo=lo, rows=ROWS)
                else:
                    align_sweep(u, v, d, lo=lo)

            rows += psw.slopes(run, [({"store_align": lo}, (sms, R, w))],
                               ROWS, depths, "heat_probe_store_align_kernel",
                               made, dev)
    rate = {(r["width"], r["store_align"]): r["g_cells_per_s"] for r in rows}
    for r in rows:
        w, lo = r["width"], r["store_align"]
        r["over_lo8"] = rate[w, lo] / rate.get((w, 8), rate[w, lo])
        r["over_aligned_width"] = rate[w, lo] / rate.get(
            (widths[0], lo), rate[w, lo])
        yield r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--offsets", default=",".join(map(str, OFFSETS)))
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)),
                    help="row pitches: a multiple of 4 floats, and not")
    ap.add_argument("--depths", default=",".join(map(str, psw.DEPTHS)),
                    help="sweep counts whose slope is a sweep")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a measurement")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_store_align: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    for row in offsets([int(x) for x in args.widths.split(",")],
                       [int(x) for x in args.offsets.split(",")],
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
