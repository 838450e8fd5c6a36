"""The host cost of one launch, measured alone: where a call of the
multigrid transfer kernels spends its time.

    python -m parallel_heat_tpu_torch.tools.launch_cost [--calls 10000]
        [--size 512]

Needs a CUDA device and nvcc. At the implicit main path's finest pair
(``--size``^2 <-> its coarse level, 512^2 <-> 257^2 by default) it times
each piece of one call of ``multigrid.restrict`` and
``multigrid.prolong`` alone, by ``time.perf_counter`` over ``--calls``
calls with no sync between them, in whichever tree
``parallel_heat_tpu_torch`` is imported from: a tree whose wrappers
build launch records (``TransferLaunch``) gives the record's lookup, the
output's ``torch.empty``, the current stream, a bare ``ctypes`` launch
with its arguments prepared and the whole call; an older one gives its
checks, ``.contiguous()``, ``torch.empty``, ``load()``, ``params()``,
the stream and its ten-argument launch. For scale: one ``torch.add`` of
two 257^2 arrays, ``torch.cuda.current_device()`` and the raw stream
getter. Then, by CUDA events over as many calls, the whole call, the
``torch.add`` and the library call of the same function (``conv2d`` at
stride 2 with the full-weighting weights, ``conv_transpose2d`` with the
bilinear ones; TF32 off), each in ms a call: while a kernel takes less
card time than the host takes to issue it, events time the issue.

Prints the card's name and power limit (``nvidia-smi``), then one JSON
object. Run it from another tree's root with ``PYTHONPATH`` set to that
tree to time that tree's call.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def host_us(fn, calls: int) -> float:
    """Host microseconds of one ``fn()``: ``time.perf_counter`` around
    ``calls`` calls, after one warm call, with no sync between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # heatlint: begin dispatch-region
    for _ in range(calls):
        fn()
    # heatlint: end dispatch-region
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _pieces(name: str, src, out_shape, dev) -> dict:
    """``{piece: fn}`` of one call of transfer ``name`` from ``src`` onto
    ``out_shape`` in the tree imported."""
    from parallel_heat_tpu_torch.kernels.build import load
    from parallel_heat_tpu_torch.ops import multigrid as mg

    what = "restrict" if name == "heat_mg_restrict" else "prolong"
    call = getattr(mg, what)
    dst = torch.empty(out_shape, dtype=torch.float32, device=dev)
    lib = load(name)
    fn = getattr(lib, name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    src_ptr, dst_ptr = src.data_ptr(), dst.data_ptr()
    pieces = {}
    if hasattr(mg, "TransferLaunch"):
        rec = mg.transfer_record(name, src, out_shape)
        addr = rec._addr
        pieces["record lookup"] = lambda: mg.transfer_record(name, src,
                                                             out_shape)
        pieces["torch.empty"] = lambda: torch.empty(
            rec.out_shape, dtype=torch.float32, device=dev)
        pieces["current stream"] = lambda: torch.cuda.current_stream(
            dev).cuda_stream
        pieces["ctypes launch, prepared"] = lambda: fn(addr, src_ptr,
                                                       dst_ptr, stream)
    else:
        from parallel_heat_tpu_torch.ops import stencil_kernels as sk
        from parallel_heat_tpu_torch.ops.hopper_params import params

        block = params().mg_block
        shapes = (*src.shape[-2:], *out_shape)
        pieces["checks"] = lambda: mg._check_transfer(src, out_shape, what)
        pieces[".contiguous()"] = src.contiguous
        pieces["torch.empty"] = lambda: torch.empty(
            out_shape, dtype=torch.float32, device=dev)
        pieces["load()"] = lambda: load(name)
        pieces["params()"] = lambda: params().mg_block
        pieces["current stream"] = lambda: sk._stream(src)
        pieces["ctypes launch, prepared"] = lambda: fn(
            src_ptr, dst_ptr, 1, *shapes, block[0], block[1], stream)
    pieces["current device"] = torch.cuda.current_device
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        pieces["raw stream"] = lambda: raw(dev.index)
    pieces["call"] = lambda: call(src, out_shape)
    return pieces


def breakdown(dev, calls: int = 10000, size: int = 512) -> dict:
    """The host cost of each piece of a restrict and a prolong call at
    ``size``^2 <-> its coarse level (µs a call), and the whole call, a
    ``torch.add`` and the library call by CUDA events (ms a call)."""
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.bench_kernels import time_ms
    from parallel_heat_tpu_torch.ops import multigrid as mg

    torch.backends.cudnn.allow_tf32 = False
    fine = (size, size)
    coarse = ((size - 2) // 2 + 2,) * 2
    rng = np.random.default_rng(0)
    r = torch.from_numpy((rng.standard_normal(fine) * 10)
                         .astype(np.float32)).to(dev)
    c = torch.from_numpy((rng.standard_normal(coarse) * 10)
                         .astype(np.float32)).to(dev)
    c[0] = c[-1] = 0
    c[:, 0] = c[:, -1] = 0
    a = torch.ones(coarse, device=dev)
    b = torch.ones(coarse, device=dev)
    w = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]],
                     device=dev).view(1, 1, 3, 3)
    rx = r[1:, 1:].contiguous().view(1, 1, size - 1, size - 1)
    cx = c[1:-1, 1:-1].contiguous().view(1, 1, coarse[0] - 2, coarse[1] - 2)
    out = {"calls": calls, "fine": list(fine), "coarse": list(coarse),
           "tree_has_launch_records": hasattr(mg, "TransferLaunch")}
    for name, src, shape, library in (
            ("heat_mg_restrict", r, coarse,
             lambda: F.conv2d(rx, w / 16.0, stride=2)),
            ("heat_mg_prolong", c, fine,
             lambda: F.conv_transpose2d(cx, w / 4.0, stride=2))):
        pieces = _pieces(name, src, shape, dev)
        row = {"host_us": {p: host_us(fn, calls)
                           for p, fn in pieces.items()}}
        row["host_us"]["torch.add 257^2"] = host_us(
            lambda: torch.add(a, b), calls)
        row["events_ms"] = {"call": time_ms(pieces["call"], calls, 10),
                            "torch.add 257^2": time_ms(
                                lambda: torch.add(a, b), calls, 10),
                            "library call": time_ms(library, calls // 10,
                                                    10)}
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps(breakdown(dev, args.calls, args.size)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
