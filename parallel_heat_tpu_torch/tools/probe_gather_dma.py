"""What a tile's load costs alone on the card: a dense box against a tile
gathered from two arrays.

    python -m parallel_heat_tpu_torch.tools.probe_gather_dma
        [--sizes 4096,16384] [--tail 128] [--made 40] [--out FILE]

The Hopper port of the JAX package's ``tools/probe_gather_dma.py``. That
probe timed kernel E's dense strip windows against kernel G-fuse's
gathered ones on the TPU, DMA alone. A full-width strip of 4096 floats a
row fits no shared memory, so this one (``csrc/heat_probe_gather_dma.cu``)
cuts the ``(M, N)`` array into windows of E-uni's framed tile, ``T + 2K``
rows (96 + 16) of ``row_floats(K, 112)`` = 128 floats at a stride of 112
columns, each window clamped inside its array as the TPU clamps its last
strip, and lets one block an SM walk them double-buffered, touching one
element a window. Forms (the TPU's names):

- ``dense``: one TMA box of the grid a window; ``dense-cpasync``: the
  same window by 16-byte cp.async;
- ``gather``: G-fuse's form, the window's 128 floats from the grid and
  ``--tail`` floats more from a second array, by cp.async into one slot
  of the wider pitch; ``gather-tma``: the same two pieces as two TMA boxes
  into two dense sub-slots;
- ``extdense``: one TMA box of an array that holds the gather's pieces
  side by side, so that a window is dense again at the wider width.

The function is the TPU's: the first cell of the last window (on the
TPU's own strips, ``u[min((n-1) T, M-W), 0]``). With ``check``, each
block also returns the last window it loaded, so that a check can hold
every loaded byte against the plain version's windows.

Needs a CUDA device and nvcc. Checks first, with ``check``, every form
against its plain version on each array, and refuses to time otherwise.
Prints the card's name and power limit, then per size and form one JSON
line: device ms of a launch (``torch.profiler`` over ``--made`` launches)
and CUDA events; the bytes landed in shared memory and their GB/s; the
bytes of the arrays that the windows cover, each read once (the frames
that windows share are landed twice, and L2 may serve the second), their
GB/s and its share of HBM's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params

VARIANTS = ("dense", "dense-cpasync", "gather", "gather-tma", "extdense")
# Each form's load in csrc/heat_probe_gather_dma.cu: kGatherBox (0) or
# kGatherCpAsync (1).
LOADS = {"dense": 0, "dense-cpasync": 1, "gather": 1, "gather-tma": 0,
         "extdense": 0}
GATHERS = ("gather", "gather-tma")
SIZES = (4096, 16384)
TAIL = 128
BLOCK = (32, 8)

# Launches of heat_probe_gather_dma since the last reset; the solver's
# registry (stencil_kernels.counts) holds only the solver's kernels.
counts = {"heat_probe_gather_dma": 0}


def n_windows(shape, rows: int, k: int, cols: int, stride: int):
    """``(down, across)``: the windows of an ``(M, C)`` array, ``rows +
    2k`` rows at a stride of ``rows`` (``M // rows`` of them, as the TPU's
    strips) and ``cols`` floats at a stride of ``stride`` (enough to reach
    the last column)."""
    m, c = shape
    across = -(-(c - cols) // stride) + 1 if c > cols else 1
    return m // rows, across


def origins(shape, rows: int, k: int, cols: int, stride: int, t: int):
    """``(y0, x0)`` of window ``t`` (row-major over the windows),
    clamped inside the array."""
    m, c = shape
    _, across = n_windows(shape, rows, k, cols, stride)
    i, j = divmod(t, across)
    return min(i * rows, m - rows - 2 * k), min(j * stride, c - cols)


def _check(variant, u, t, rows, k, cols, stride, blocks):
    if variant not in VARIANTS:
        raise ValueError(f"unknown form {variant!r}; one of {VARIANTS}")
    gather = variant in GATHERS
    if gather != (t is not None):
        raise ValueError(f"{variant} takes "
                         f"{'a tail array' if gather else 'no tail array'}")
    arrays = [u] + ([t] if gather else [])
    for x in arrays:
        if x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError(f"2D float32 arrays only, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != u.device or not x.is_contiguous():
            raise ValueError("contiguous arrays on one device")
        if x.shape[1] % 4:
            raise ValueError(f"array widths must be multiples of 4 floats, "
                             f"got {tuple(x.shape)}")
    m, c = u.shape
    w = rows + 2 * k
    if rows < 1 or k < 0 or w > m:
        raise ValueError(f"windows of {rows} + 2 x {k} rows do not fit "
                         f"{m} rows")
    if cols < 4 or cols % 4 or cols > c or stride < 4 or stride % 4:
        raise ValueError(f"windows of {cols} floats at a stride of {stride} "
                         f"(both multiples of 4) do not fit a width of {c}")
    if blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if gather:
        _, across = n_windows(u.shape, rows, k, cols, stride)
        if t.shape[0] != m or t.shape[1] % across:
            raise ValueError(f"the tail array must have {m} rows and a "
                             f"piece for each of the {across} windows "
                             f"across, got {tuple(t.shape)}")
    tail = t.shape[1] // n_windows(u.shape, rows, k, cols, stride)[1] \
        if gather else 0
    budget = params().smem_per_block_max
    need = 128 + 2 * (-(-(w * (cols + tail)) // 32) * 32) * 4 + 16
    if need > budget:
        raise ValueError(f"two slots of {w} x {cols + tail} floats exceed a "
                         f"block's {budget} bytes of shared memory")
    if LOADS[variant] == 0 and (w > 256 or cols > 256 or tail > 256
                                or (w * cols) % 32):
        raise ValueError(f"{variant}: a TMA box is at most 256 cells a side "
                         f"and a second piece starts on 128 bytes; got "
                         f"{w} x {cols} (+ {tail})")
    return tail


def gather_dma_plain(variant: str, u: torch.Tensor,
                     t: Optional[torch.Tensor] = None, *, rows: int, k: int,
                     cols: int, stride: int, blocks: int = 1,
                     check: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of :func:`gather_dma`: the first cell of the last
    window, and with ``check`` the last window of each of the ``blocks``
    blocks that walk the windows (block ``b`` takes windows ``b, b +
    blocks, ...``), ``(blocks, W, cols + tail)``."""
    tail = _check(variant, u, t, rows, k, cols, stride, blocks)
    down, across = n_windows(u.shape, rows, k, cols, stride)
    tiles = down * across
    grid = min(tiles, blocks)
    w = rows + 2 * k

    def window(n):
        y0, x0 = origins(u.shape, rows, k, cols, stride, n)
        core = u[y0:y0 + w, x0:x0 + cols]
        if not tail:
            return core
        j = n % across
        return torch.cat([core, t[y0:y0 + w, j * tail:(j + 1) * tail]], 1)

    elem = window(tiles - 1)[0, 0].clone()
    if not check:
        return elem, None
    last = [b + ((tiles - b - 1) // grid) * grid for b in range(grid)]
    return elem, torch.stack([window(n) for n in last])


def gather_dma(variant: str, u: torch.Tensor,
               t: Optional[torch.Tensor] = None, *, rows: int, k: int,
               cols: int, stride: int, blocks: Optional[int] = None,
               check: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Form ``variant`` of the load probe on the ``(M, C)`` float32 array
    ``u`` (and, for ``gather`` and ``gather-tma``, the tail array ``t``,
    ``(M, across x tail)``): windows of ``rows + 2k`` rows by ``cols``
    floats at a column stride of ``stride`` (:func:`n_windows`), each
    loaded once into shared memory by ``blocks`` blocks (one an SM by
    default). Returns the first cell of the last window (0-d) and, with
    ``check``, each block's last window. On a CPU tensor it takes its
    plain version."""
    if blocks is None:
        blocks = (torch.cuda.get_device_properties(u.device)
                  .multi_processor_count if u.device.type == "cuda" else 1)
    tail = _check(variant, u, t, rows, k, cols, stride, blocks)
    if u.device.type == "cpu":
        return gather_dma_plain(variant, u, t, rows=rows, k=k, cols=cols,
                                stride=stride, blocks=blocks, check=check)
    from parallel_heat_tpu_torch.kernels.build import load

    down, across = n_windows(u.shape, rows, k, cols, stride)
    grid = min(down * across, blocks)
    elem = torch.empty((), dtype=torch.float32, device=u.device)
    windows = (torch.empty((grid, rows + 2 * k, cols + tail),
                           dtype=torch.float32, device=u.device)
               if check else None)
    lib = load("heat_probe_gather_dma")
    code = lib.heat_probe_gather_dma(
        LOADS[variant], u.data_ptr(), t.data_ptr() if tail else None,
        elem.data_ptr(), windows.data_ptr() if check else None, u.shape[0],
        u.shape[1], cols, stride, t.shape[1] if tail else 0, tail, rows, k,
        blocks, *BLOCK, sk._stream(u))
    sk._raise_on_error(lib, "heat_probe_gather_dma", code)
    counts["heat_probe_gather_dma"] += 1
    return elem, windows


def arrays(variant: str, u: torch.Tensor, tail: int, *, rows: int, k: int,
           cols: int, stride: int):
    """``(array, tail array or None, cols, stride)`` of form ``variant``
    on the grid ``u``: the grid itself for ``dense`` and
    ``dense-cpasync``; the grid and a random tail array of ``tail`` floats
    a window for the gathers; for ``extdense`` the gather's pieces side by
    side, each window ``cols + tail`` floats, one after another."""
    if variant not in GATHERS + ("extdense",):
        return u, None, cols, stride
    _, across = n_windows(tuple(u.shape), rows, k, cols, stride)
    g = torch.Generator(device=u.device).manual_seed(0)
    t = torch.randn((u.shape[0], across * tail), generator=g,
                    device=u.device)
    if variant in GATHERS:
        return u, t, cols, stride
    pieces = []
    for j in range(across):
        x0 = min(j * stride, u.shape[1] - cols)
        pieces += [u[:, x0:x0 + cols], t[:, j * tail:(j + 1) * tail]]
    return torch.cat(pieces, 1).contiguous(), None, cols + tail, cols + tail


def landed_bytes(shape, rows, k, cols, stride, tail=0) -> int:
    """Bytes a launch lands in shared memory: every window once."""
    down, across = n_windows(shape, rows, k, cols, stride)
    return 4 * down * across * (rows + 2 * k) * (cols + tail)


def read_bytes(shape, rows, k, cols, stride, tail=0) -> int:
    """Bytes of the arrays that the windows cover, each read once: the
    rows down to the last window's of the whole width (the windows across
    reach the last column), and of the tail array as many rows of its
    pieces. Windows overlap by their frames, which L2 may serve, so a
    launch lands more than this in shared memory
    (:func:`landed_bytes`)."""
    m, c = shape
    down, across = n_windows(shape, rows, k, cols, stride)
    covered = min(m, (down - 1) * rows + rows + 2 * k)
    return 4 * covered * (c + across * tail)


def timings(sizes=SIZES, tail: int = TAIL, made: int = 40, device=None):
    """Yield the probe's JSON rows (see the module's docstring) on random
    ``size`` x ``size`` arrays of ``sizes`` on ``device`` (the current
    CUDA device by default), at E-uni's framed tile and depth."""
    from parallel_heat_tpu_torch.bench_kernels import card_line
    from parallel_heat_tpu_torch.tools.probing import time_row

    dev = device or torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    p = params()
    k, (ty, tx) = p.e_k_default, p.e_tile
    geo = dict(rows=ty, k=k, cols=p.row_floats(k, tx), stride=tx)
    for size in sizes:
        u = torch.from_numpy(np.random.default_rng(size).standard_normal(
            (size, size)).astype(np.float32)).to(dev)
        for variant in VARIANTS:
            a, t, cols, stride = arrays(variant, u, tail, **geo)
            kw = dict(rows=ty, k=k, cols=cols, stride=stride)
            got, win = gather_dma(variant, a, t, check=True, **kw)
            want, wwin = gather_dma_plain(variant, a, t, check=True,
                                          blocks=win.shape[0], **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(win, wwin)):
                raise RuntimeError(f"gather probe {variant!r} at {size}^2 "
                                   f"loaded other cells than its plain "
                                   f"version's windows")
            row = {"gather_dma": variant, "size": size, "rows": ty, "k": k,
                   "cols": cols, "stride": stride,
                   "tail": tail if variant in GATHERS else 0,
                   "block": list(BLOCK), "card": card}

            def run(_, variant=variant, a=a, t=t, kw=kw):
                gather_dma(variant, a, t, **kw)

            time_row(row, run, (1,), "heat_probe_gather_dma_kernel", made,
                     key="x")
            shape = tuple(a.shape)
            nbytes = landed_bytes(shape, ty, k, cols, stride, row["tail"])
            hbm = read_bytes(shape, ty, k, cols, stride, row["tail"])
            ms = row["device_ms"]["x1"]
            row.update({"landed_bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
                        "read_bytes": hbm, "read_gb_per_s": hbm / ms / 1e6,
                        "read_share_of_hbm": hbm / ms / 1e-3
                        / p.hbm_bytes_per_s})
            yield row
            del a, t
        del u
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--tail", type=int, default=TAIL,
                    help="floats a window of the gather takes from its "
                         "second array")
    ap.add_argument("--made", type=int, default=40,
                    help="launches a measurement")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather_dma: no CUDA device", file=sys.stderr)
        return 2
    from parallel_heat_tpu_torch.bench_kernels import card_line

    print(card_line(), flush=True)
    rows = []
    for row in timings([int(x) for x in args.sizes.split(",")], args.tail,
                       args.made):
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fp:
            for row in rows:
                fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
