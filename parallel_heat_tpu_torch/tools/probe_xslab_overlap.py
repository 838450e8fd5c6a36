"""Does kernel F overlap its plane loads with its levels, on the card?

    python -m parallel_heat_tpu_torch.tools.probe_xslab_overlap
        [--sizes 512,256] [--loads tma,cp.async] [--tries 2] [--made 40]
        [--out FILE]

The Hopper port of the JAX package's ``tools/ab_xslab_overlap.py``. That
probe asked whether F's slab DMA ran under its compute (the larger of the
two) or after it (their sum), by moving the K - 1 intermediate sweeps out
of the DMA slots into two buffers of their own. F's plane loop here
already keeps its levels out of the load slots (in registers and level
buffers of their own, ``csrc/heat_temporal3d.cuh`` ``HeatFLoop``), so the
probe asks by decomposition instead: F's launch at its default shape
(``hopper_params.f_shape(3)``) in three variants of its plane loop
(``csrc/heat_probe_xslab_overlap.cu``):

- ``full``: F as shipped, the only variant that computes a function: on a
  CPU tensor it takes F's plain version;
- ``no_step``: the stream alone: each plane loaded, waited for and
  refilled as in F, each output plane stored as F stores it, no level
  stepped;
- ``no_load``: the compute alone: after the first ring's worth of planes
  nothing is loaded or waited for, the levels stepping over the ring as
  it lies, the barrier a plane kept.

The two measurement variants raise on a CPU tensor. Only K = 3 (F's
default depth) is compiled; another K raises.

Needs a CUDA device and nvcc. Per size and load (TMA, or cp.async), checks
first that ``full`` is bitwise F's plain version (grid and residual) on
the plate, and refuses to time otherwise. Prints the card's name and power
limit, then one JSON line per size and load: each variant's device ms
over ``--made`` launches without the residual (``torch.profiler``, the
least of ``--tries``) and by CUDA events; the ``max`` and ``sum`` models,
``full / max(no_step, no_load)`` and ``full / (no_step + no_load)``; and
the ring ladder: ``full`` and ``no_step`` at every prefetch depth from 1
to the most whose planes fit a block's shared memory.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from parallel_heat_tpu_torch.models import HeatPlate3D
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

VARIANTS = ("full", "no_step", "no_load")
# The variants' codes in csrc/heat_temporal3d.cuh (kHeatFFull,
# kHeatFNoStep, kHeatFNoLoad).
CODES = {"full": 0, "no_step": 1, "no_load": 2}
SIZES = (512, 256)
CX = CY = CZ = 0.1

# Launches of heat_probe_xslab_overlap since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_xslab_overlap": 0}


def prefetch_max(k: int) -> int:
    """The most planes in flight whose ring fits one block's shared memory
    at F's shape for depth ``k`` (at most ``f_prefetch_max``)."""
    p = params()
    block, rows, _ = p.f_shape(k)
    return max(q for q in range(1, p.f_prefetch_max + 1)
               if p.f_k_max(block, rows, q) >= k)


def overlap_steps(variant: str, u: torch.Tensor, out: torch.Tensor, k: int,
                  with_residual: bool = False, *, cx: float, cy: float,
                  cz: float, load: Optional[str] = None,
                  prefetch: Optional[int] = None) -> Optional[torch.Tensor]:
    """Variant ``variant`` of kernel F: ``k`` steps of ``u`` into ``out``
    in one launch at F's shape (``prefetch`` planes in flight, F's by
    default), each plane's tile by ``load`` (:func:`.f_load`'s pick by
    default); returns the last step's residual or None without
    ``with_residual``. Only ``"full"`` computes F's function: on a CPU
    tensor it takes F's plain version, and the other variants raise."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    sk._check(u, out, ndim=3)
    p = params()
    if k != p.f_k_default:
        raise ValueError(f"the overlap probe compiles K = {p.f_k_default} "
                         f"only (F's default depth and shape), got {k}")
    fits = sk3.f_load(u.shape, u)
    if load is None:
        load = fits
    elif load not in sk3.LOADS:
        raise ValueError(f"load must be one of {sk3.LOADS}, got {load!r}")
    elif load == "tma" and fits != "tma":
        raise ValueError(f"the TMA load needs nz % 4 == 0 and a 16-byte "
                         f"aligned grid; got {tuple(u.shape)}")
    block, rows, prefetch_f = p.f_shape(k)
    prefetch = prefetch or prefetch_f
    if not 1 <= prefetch <= prefetch_max(k):
        raise ValueError(f"prefetch must be in [1, {prefetch_max(k)}] (the "
                         f"ring in one block's shared memory), got "
                         f"{prefetch}")
    if u.device.type == "cpu":
        if variant != "full":
            raise ValueError(f"probe variant {variant!r} is a measurement, "
                             f"not a function: it runs only on the card")
        return sk3.xslab_steps_3d_plain(u, out, k, with_residual, cx=cx,
                                        cy=cy, cz=cz)
    from parallel_heat_tpu_torch.kernels.build import load as load_lib

    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual else None)
    _, _, seg = p.f_launch(tuple(u.shape), k, block, rows)
    lib = load_lib("heat_probe_xslab_overlap")
    code = lib.heat_probe_xslab_overlap(
        CODES[variant], u.data_ptr(), out.data_ptr(), sk._ptr(bits),
        *u.shape, k, block[0], block[1], rows, seg, prefetch,
        int(load == "tma"), *coeffs3_f32(cx, cy, cz), sk._stream(u))
    sk._raise_on_error(lib, "heat_probe_xslab_overlap", code)
    counts["heat_probe_xslab_overlap"] += 1
    return sk._residual_view(bits) if bits is not None else None


def check(u: torch.Tensor, k: int, load: str) -> float:
    """``full`` bitwise F's plain version on ``u`` (grid and residual)
    under ``load``; RuntimeError otherwise. Returns the max |diff|."""
    kw = dict(cx=CX, cy=CY, cz=CZ)
    want, got = torch.empty_like(u), torch.full_like(u, float("nan"))
    rp = sk3.xslab_steps_3d_plain(u, want, k, True, **kw)
    r = overlap_steps("full", u, got, k, True, load=load, **kw)
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    if not (torch.equal(got, want) and torch.equal(r, rp)):
        raise RuntimeError(f"probe variant 'full' ({load}) at "
                           f"{tuple(u.shape)}, K = {k} is not bitwise F's "
                           f"plain version: max diff {diff}")
    return diff


def overlap(sizes=SIZES, k: int = 3, loads=sk3.LOADS, tries: int = 2,
            made: int = 40, ladder=None, device=None):
    """Yield the probe's JSON rows (see the module's docstring) on the
    ``size``^3 plates of ``sizes`` under each of ``loads``, on ``device``
    (the current CUDA device by default); ``ladder``: the prefetch depths
    of the ring ladder (1 .. :func:`prefetch_max` by default)."""
    from parallel_heat_tpu_torch.bench_kernels import (card_line,
                                                       device_ms, time_ms)

    dev = device or torch.device("cuda", torch.cuda.current_device())
    kw = dict(cx=CX, cy=CY, cz=CZ)
    card = card_line()
    p = params()
    block, rows, prefetch = p.f_shape(k)
    ladder = tuple(ladder or range(1, prefetch_max(k) + 1))
    for size in sizes:
        u = HeatPlate3D(size, size, size).init_grid(dev)
        v = torch.empty_like(u)
        for load in loads:
            err = check(u, k, load)

            def timed(variant, q=prefetch):
                def run():
                    overlap_steps(variant, u, v, k, load=load, prefetch=q,
                                  **kw)

                name = f"heat_probe_xslab_overlap_kernel<{CODES[variant]},"
                return (min(device_ms(run, name, made) for _ in range(tries)),
                        min(time_ms(run, made) for _ in range(tries)))

            times, events = {}, {}
            for variant in VARIANTS:
                times[variant], events[variant] = timed(variant)
            full, stream, compute = (times[v_] for v_ in VARIANTS)
            rungs = {variant: {str(q): timed(variant, q)[0] for q in ladder}
                     for variant in ("full", "no_step")}
            yield {"xslab_overlap": "heat_f_temporal3d", "size": size,
                   "k": k, "load": load, "block": list(block), "rows": rows,
                   "prefetch": prefetch,
                   "segment": p.f_launch((size,) * 3, k, block, rows)[2],
                   "max_abs_err": err, "device_ms": times,
                   "events_ms": events,
                   "max_model": full / max(stream, compute),
                   "sum_model": full / (stream + compute),
                   "ladder_device_ms": rungs, "card": card}
        del u, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--loads", default=",".join(sk3.LOADS))
    ap.add_argument("--tries", type=int, default=2,
                    help="timings of a variant, the least kept")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a timing")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_xslab_overlap: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    for row in overlap([int(x) for x in args.sizes.split(",")],
                       params().f_k_default, args.loads.split(","),
                       args.tries, args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
