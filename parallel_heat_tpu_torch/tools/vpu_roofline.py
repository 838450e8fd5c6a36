"""The card's issue-rate roofline: what the SMs' FP32 pipes and shared
memory sustain in the tile loop's layout, with no device memory in the
timed loop.

    python -m parallel_heat_tpu_torch.tools.vpu_roofline [--rows 192]
        [--cols 128] [--passes 64,1024] [--made 40] [--out FILE]
        [--sass DIR]

The Hopper port of the JAX package's ``tools/vpu_roofline.py``. That
probe swept a VMEM-resident buffer with FMA chains and the 5-point mix to
pin the TPU's vector rate; this one (``csrc/heat_probe_vpu_roofline.cu``)
runs one block of 32 x 16 threads on each SM, each holding its own
``rows`` x ``cols`` tile of an (SMs, rows, cols) float32 stack in two
shared buffers (96 KB each at the defaults, so one block an SM: 25 MB
resident across an H100's 132 SMs), loaded once, swept D times, stored
once:

- ``fma P=n`` (n in 1, 2, 4, 8, 16): each element of rows 1 .. R-2 goes
  through ``x = a x + b`` n times a pass by ``__fmaf_rn``, a = 0.9999 and
  b = 1e-7 as kernel arguments: at P = 1 the shared-memory rate, as P
  grows the FFMA rate;
- ``muladd P=n``: the same chain, a rounded multiply and a rounded add,
  the rounding the stencil's combine uses;
- ``stencil``: the tile loop's own row walk (``heat_rows`` with the edge
  test) at cx = cy = 0.1: D Jacobi steps of each member, its ring pinned;
- ``no_shuffle``: the walk with left and right taken as the cell (the
  TPU probe's ``noroll``), which prices the shuffles and the shared read
  of lanes 0 and 31;
- ``no_row_load``: up and down taken as the cell too (``noshift``), the
  combine's arithmetic floor;
- ``no_edge``: the walk without the edge test, every cell updated (the
  ring too): the path that E's, E-uni's and G's tiles inside the grid's
  interior run, and so the issue ceiling of their step.

``fma``, ``muladd`` and ``stencil`` compute a function, each with a plain
version here (:func:`sweep_plain`; the chains' on a CPU tensor is what
:func:`sweep` computes); ``no_shuffle``, ``no_row_load`` and ``no_edge``
are measurements and run only on the card.

Needs a CUDA device and nvcc. Checks first that ``fma`` (P = 1 and 16),
``muladd`` (P = 16) and ``stencil`` are bitwise their plain versions on
the stack and refuses to time otherwise. Prints the card's name and
power limit, then one JSON line per variant: device ms (``torch.profiler``)
and CUDA-event ms of a launch at each pass count of ``--passes``, µs a
pass by the slope between them (so the one load, the one store and the
launch cancel), elements or cell-steps a second for the card and an SM,
FP32 instructions a clock an SM, the SM clock that ``nvidia-smi`` reads
while the variant runs, and the pass's bound: the larger of its FP32
instructions over 128 lanes x SMs x the maximum SM clock and its shared
bytes (each cell read once, written once) over 128 bytes x SMs x that
clock. Then a ``library`` line: ``conv2d`` with the stencil's weights
(TF32 off) and ``torch.addcmul`` for the chain, per pass over the stack.
``--sass DIR`` also writes the probe's machine code to
``DIR/heat_probe_vpu_roofline.sass`` and prints, per instance, its
loops' FFMA, FMUL and FADD counts.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from parallel_heat_tpu_torch.ops import batched
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

KINDS = ("fma", "muladd", "stencil", "no_shuffle", "no_row_load",
         "no_edge")
FUNCTIONS = ("fma", "muladd", "stencil")
CHAIN_DEPTHS = (1, 2, 4, 8, 16)
# The chain's constants, float32 (the TPU probe's a and b).
A = float(np.float32(0.9999))
B = float(np.float32(1e-7))
CX = CY = 0.1
ROWS, COLS = 192, 128
BLOCK = (32, 16)
PASSES = (64, 1024)
# The variants a run times, and those held bitwise first.
VARIANTS = ([("fma", p) for p in CHAIN_DEPTHS]
            + [("muladd", p) for p in CHAIN_DEPTHS]
            + [(kind, 0) for kind in KINDS[2:]])
CHECKED = (("fma", 1), ("fma", 16), ("muladd", 16), ("stencil", 0))
# The walk's FP32 operations a cell-step: the combine's 3 multiplies and
# 4 adds.
COMBINE_OPS = 7

# Launches of heat_probe_vpu_roofline since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_vpu_roofline": 0}


def variant_name(kind: str, p: int) -> str:
    return f"{kind} P={p}" if kind in ("fma", "muladd") else kind


def _check(kind, u, out, passes, p) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    chain = kind in ("fma", "muladd")
    if chain and p not in CHAIN_DEPTHS:
        raise ValueError(f"{kind}: chain depth P must be one of "
                         f"{CHAIN_DEPTHS}, got {p}")
    if not chain and p != 0:
        raise ValueError(f"{kind} takes no chain depth (P = 0), got {p}")
    if passes < 1:
        raise ValueError(f"passes must be at least 1, got {passes}")
    if u.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"float32 stacks only, got {u.dtype} -> {out.dtype}")
    if u.dim() != 3 or out.shape != u.shape:
        raise ValueError(f"need an (S, R, N) stack and an out of its shape, "
                         f"got {tuple(u.shape)} -> {tuple(out.shape)}")
    _, rows, cols = u.shape
    if rows < 3 or cols < 8 or cols % 4:
        raise ValueError(f"a member must have at least 3 rows and a width "
                         f"that is a multiple of 4 and at least 8, got "
                         f"{rows} x {cols}")
    budget = params().smem_per_block_max
    if 2 * 4 * rows * cols > budget:
        raise ValueError(f"two {rows} x {cols} buffers exceed a block's "
                         f"{budget} bytes of shared memory")
    if u.device != out.device or u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"u on {u.device}, out on {out.device}")
    if not (u.is_contiguous() and out.is_contiguous()):
        raise ValueError("u and out must be contiguous")
    if u.data_ptr() == out.data_ptr():
        raise ValueError("out must be a different buffer from u")


def sweep_plain(kind: str, u: torch.Tensor, out: torch.Tensor, passes: int,
                p: int = 0, *, cx: float = CX, cy: float = CY) -> None:
    """Plain version of :func:`sweep` for the kinds that compute a
    function. ``stencil``: ``passes`` Jacobi steps of every member, its
    ring pinned (kernel M's plain version, ``batched.ensemble_steps_plain``,
    each step rounded as the kernel rounds it). ``muladd``: rows 1 .. R-2
    through ``x * a + b`` ``p * passes`` times in float32, each operation
    rounded. ``fma``: the same with ``a x`` exact in float64 and ``a x +
    b`` rounded once to float32: ``__fmaf_rn`` but where the float64 sum
    lands on a float32 midpoint (then the two roundings may differ)."""
    _check(kind, u, out, passes, p)
    if kind == "stencil":
        batched.ensemble_steps_plain(u, out, passes, False, cx=cx, cy=cy)
        return
    if kind not in FUNCTIONS:
        raise ValueError(f"{kind} is a measurement, not a function: it has "
                         f"no plain version")
    x = u[:, 1:-1]
    for _ in range(p * passes):
        x = (x.double() * A + B).float() if kind == "fma" else x * A + B
    out.copy_(u)
    out[:, 1:-1] = x


def sweep(kind: str, u: torch.Tensor, out: torch.Tensor, passes: int,
          p: int = 0, *, cx: float = CX, cy: float = CY) -> None:
    """Variant ``kind`` of the roofline (chain depth ``p`` for ``fma``
    and ``muladd``, 0 for the walk's variants): ``passes`` passes over
    every member of the (S, R, N) float32 stack ``u`` into ``out``, one
    block a member, one block an SM. On a CPU tensor the kinds that
    compute a function take their plain version (:func:`sweep_plain`),
    and the others, which are no function, raise."""
    _check(kind, u, out, passes, p)
    if u.device.type == "cpu":
        if kind not in FUNCTIONS:
            raise ValueError(f"roofline variant {kind!r} is a measurement, "
                             f"not a function: it runs only on the card")
        sweep_plain(kind, u, out, passes, p, cx=cx, cy=cy)
        return
    from parallel_heat_tpu_torch.kernels.build import load

    lib = load("heat_probe_vpu_roofline")
    code = lib.heat_probe_vpu_roofline(
        KINDS.index(kind), p, u.data_ptr(), out.data_ptr(), *u.shape, passes,
        *BLOCK, A, B, *coeffs_f32(cx, cy), sk._stream(u))
    sk._raise_on_error(lib, "heat_probe_vpu_roofline", code)
    counts["heat_probe_vpu_roofline"] += 1


def occupancy(kind: str, p: int, rows: int, cols: int) -> int:
    """Blocks of variant (kind, p) that one SM of the current card holds
    at once at the launch's shared memory (1, or the launch refuses)."""
    import ctypes

    from parallel_heat_tpu_torch.kernels.build import load

    lib = load("heat_probe_vpu_roofline")
    fn = lib.heat_probe_vpu_roofline_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    code = fn(KINDS.index(kind), p, rows, cols, *BLOCK, ctypes.byref(blocks))
    sk._raise_on_error(lib, "heat_probe_vpu_roofline", code)
    return blocks.value


def sm_clocks(load=None, launches: int = 0):
    """``(SM clock, its maximum)`` in MHz as ``nvidia-smi`` reads them;
    with ``load``, read while ``launches`` calls of ``load()`` keep the
    card busy."""
    for _ in range(launches):
        load()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    if launches:
        torch.cuda.synchronize()
    cur, most = out.strip().splitlines()[0].split(",")
    return float(cur), float(most)


def work(kind: str, p: int, shape):
    """``(units, instructions, shared bytes)`` of one pass over an (S, R,
    N) stack: elements of rows 1 .. R-2 (chains) or interior cell-steps
    (the walk), the FP32 instructions of the function (P FFMA, or P FMUL
    and P FADD, an element; the combine's 7 a cell-step) and its shared
    traffic (each element or cell of rows 1 .. R-2 read and written
    once)."""
    s, rows, cols = shape
    elements = s * (rows - 2) * cols
    if kind in ("fma", "muladd"):
        per = p if kind == "fma" else 2 * p
        return elements, per * elements, 8 * elements
    cells = s * (rows - 2) * (cols - 2)
    return cells, COMBINE_OPS * cells, 8 * elements


def bound_us(kind: str, p: int, shape, sms: int, clock_mhz: float):
    """``(µs, "instructions" or "shared bytes")``: the least time of one
    pass, its FP32 instructions over 128 lanes x SMs x the clock or its
    shared bytes over 128 bytes x SMs x the clock, whichever is larger."""
    _, instructions, nbytes = work(kind, p, shape)
    per_us = 128 * sms * clock_mhz
    t_ops, t_bytes = instructions / per_us, nbytes / per_us
    return ((t_ops, "instructions") if t_ops >= t_bytes
            else (t_bytes, "shared bytes"))


def library_ms(u: torch.Tensor, p: int, reps: int = 8):
    """``(conv2d ms, addcmul ms)`` a pass over the stack ``u``, by CUDA
    events: ``conv2d`` with the stencil's weights (padding 1, TF32 off)
    chained ``reps`` times, and ``torch.addcmul`` chained ``p * reps``
    times, each over ``reps``."""
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.bench_kernels import time_ms

    torch.backends.cudnn.allow_tf32 = False
    a0, cx, cy = coeffs_f32(CX, CY)
    w = torch.tensor([[0.0, cx, 0.0], [cy, a0, cy], [0.0, cx, 0.0]],
                     dtype=torch.float32, device=u.device).view(1, 1, 3, 3)
    x = u.unsqueeze(1)
    a = torch.tensor(A, device=u.device)
    b = torch.tensor(B, device=u.device)

    def conv():
        y = x
        for _ in range(reps):
            y = F.conv2d(y, w, padding=1)

    def chain():
        y = u
        for _ in range(p * reps):
            y = torch.addcmul(b, y, a)

    return time_ms(conv, 3) / reps, time_ms(chain, 3) / reps


def roofline(rows: int = ROWS, cols: int = COLS, passes=PASSES,
             made: int = 40, variants=VARIANTS, device=None):
    """Yield the probe's JSON rows (see the module's docstring) on a stack
    of one ``rows`` x ``cols`` member an SM of ``device`` (the current
    CUDA device by default)."""
    from parallel_heat_tpu_torch.bench_kernels import card_line
    from parallel_heat_tpu_torch.tools.probing import slope_row, time_row

    dev = device or torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = (sms, rows, cols)
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).to(dev)
    v, want = torch.empty_like(u), torch.empty_like(u)
    for kind, p in CHECKED:
        sweep(kind, u, v, 4, p)
        sweep_plain(kind, u, want, 4, p)
        torch.cuda.synchronize()
        if not torch.equal(v, want):
            bad = int((v != want).sum())
            raise RuntimeError(f"roofline variant {variant_name(kind, p)} "
                               f"differs from its plain version in {bad} of "
                               f"{v.numel()} cells")
    card = card_line()
    lo, hi = min(passes), max(passes)
    for kind, p in variants:
        row = {"roofline": variant_name(kind, p), "members": sms,
               "rows": rows, "cols": cols, "block": list(BLOCK),
               "blocks_per_sm": occupancy(kind, p, rows, cols),
               "device_ms": {}, "events_ms": {}, "card": card}

        def run(d, kind=kind, p=p):
            sweep(kind, u, v, d, p)

        time_row(row, run, passes, "heat_probe_vpu_roofline_kernel", made,
                 key="d")
        slope_row(row, passes, key="d", per="pass")
        us = row["device_us"]["pass"]
        launches = max(1, int(300 / row["device_ms"][f"d{hi}"]))
        clock, most = sm_clocks(lambda: run(hi), launches)
        units, instructions, nbytes = work(kind, p, shape)
        unit = ("elements" if kind in ("fma", "muladd")
                else "cell_steps")
        bound, by = bound_us(kind, p, shape, sms, most)
        row.update({
            "us_per_pass": us, f"g_{unit}_per_s": units / us / 1e3,
            f"g_{unit}_per_s_per_sm": units / us / 1e3 / sms,
            "g_fp32_instructions_per_s": instructions / us / 1e3,
            "fp32_instructions_per_clock_per_sm":
                instructions / us / sms / clock,
            "shared_bytes_per_clock_per_sm": nbytes / us / sms / clock,
            "sm_clock_mhz": clock, "max_sm_clock_mhz": most,
            "bound_us_per_pass": bound, "bound_by": by,
            "bound_share": bound / us})
        yield row
    conv, chain = library_ms(u, 16)
    yield {"library": "conv2d (stencil's weights, TF32 off) a pass; "
                      "torch.addcmul x 16 a pass (fma P=16)",
           "members": sms, "rows": rows, "cols": cols, "conv2d_ms": conv,
           "addcmul_p16_ms": chain, "card": card}


def sass_report(out_dir: str):
    """Per instance of the probe's library: its loops that hold FP32
    arithmetic, with their instructions, FFMA, FMUL, FADD and shared
    bytes (``cuobjdump -sass``, written to ``out_dir``), and for the walk's
    instances the instructions a cell-step of the test-free inner step."""
    import os
    import re

    from parallel_heat_tpu_torch import bench_kernels as bk
    from parallel_heat_tpu_torch.kernels import build

    path = build.build("heat_probe_vpu_roofline")["heat_probe_vpu_roofline"]
    _, sass = bk._sass_functions(path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "heat_probe_vpu_roofline.sass"),
              "w") as fp:
        fp.write(sass)
    # The walk's instances (kinds 2 .. 5): their test-free inner step a
    # cell-step, as bench_kernels reads the solver's kernels.
    walks = {r["instance"]: r["step_per_cell_step"]
             for r in bk.sass_step_report(sass, re.compile(r"ILi[2-5]ELi0E"))}
    for chunk in re.split(r"(?=\n\s*Function : )", sass):
        name = re.search(r"Function : (\S+)", chunk)
        if not name:
            continue
        instrs = [(int(a, 16), t) for a, t in bk._SASS_LINE.findall(chunk)]
        loops = []
        for lo, hi, _ in bk.sass_loops(chunk):
            c = bk._sass_counts(instrs, int(lo, 16), int(hi, 16) + 1)
            if c["ffma"] or c["fmul"] or c["fadd"]:
                loops.append({"at": lo, **c})
        row = {"sass": build.demangle(name.group(1)), "loops": loops}
        if name.group(1) in walks:
            row["step_per_cell_step"] = walks[name.group(1)]
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    ap.add_argument("--passes", default=",".join(map(str, PASSES)),
                    help="pass counts whose slope is a pass (smallest, "
                         "largest)")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a measurement")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--sass", default=None, metavar="DIR",
                    help="write the probe's machine code to DIR and print "
                         "its loops' FP32 instruction counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vpu_roofline: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    if args.sass:
        for row in sass_report(args.sass):
            print(json.dumps(row), flush=True)
    for row in roofline(args.rows, args.cols,
                        [int(x) for x in args.passes.split(",")], args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
