"""The load probe (``parallel_heat_tpu_torch.tools.probe_gather_dma``)
against the JAX package's ``tools/probe_gather_dma.py``.

Both compute one float32 element: the first cell of the last window they
load, on the TPU's strips ``u[min((n-1) T, M-W), 0]``. The JAX probe
runs here in interpret mode, as the JAX package's own tests run its
Pallas kernels on the CPU; the port, on the CPU, through its plain
version. The element is compared bitwise (it is a copy). With ``check``,
the port also returns each block's last window, held here against numpy
slicing of the arrays.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.probe_gather_dma as jgather
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import probe_gather_dma as gd


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("form", ["dense", "dense-cpasync"])
def test_dense_element_matches_the_jax_probe(interpret, form):
    u = _rand((64, 256), 0)
    want = np.asarray(jgather.build_probe(64, 256, 256, 16, 8, 1)(
        jnp.asarray(u)))[0, 0]
    got, _ = gd.gather_dma(form, torch.from_numpy(u), rows=16, k=8,
                           cols=256, stride=256)
    assert got.shape == () and got.item() == want == u[32, 0]


@pytest.mark.parametrize("form", gd.GATHERS)
def test_gather_element_matches_the_jax_probe(interpret, form):
    u, t = _rand((64, 256), 1), _rand((64, 128), 2)
    want = np.asarray(jgather.build_probe(64, 256, 384, 16, 8, 2, tail=128)(
        jnp.asarray(u), jnp.asarray(t)))[0, 0]
    got, _ = gd.gather_dma(form, torch.from_numpy(u), torch.from_numpy(t),
                           rows=16, k=8, cols=256, stride=256)
    assert got.item() == want == u[32, 0]


def test_extdense_element_matches_the_jax_probe(interpret):
    u, t = _rand((64, 128), 3), _rand((64, 128), 4)
    ext = np.concatenate([u, t], 1)
    want = np.asarray(jgather.build_probe(64, 256, 256, 16, 8, 1)(
        jnp.asarray(ext)))[0, 0]
    got, _ = gd.gather_dma("extdense", torch.from_numpy(ext), rows=16, k=8,
                           cols=256, stride=256)
    assert got.item() == want == ext[32, 0]


def _numpy_windows(u, t, rows, k, cols, stride, tail, blocks):
    m, c = u.shape
    w = rows + 2 * k
    down = m // rows
    across = -(-(c - cols) // stride) + 1 if c > cols else 1
    tiles = down * across
    grid = min(blocks, tiles)
    out = []
    for b in range(grid):
        n = b
        while n + grid < tiles:
            n += grid
        i, j = divmod(n, across)
        y0, x0 = min(i * rows, m - w), min(j * stride, c - cols)
        win = u[y0:y0 + w, x0:x0 + cols]
        if tail:
            win = np.concatenate([win, t[y0:y0 + w, j * tail:(j + 1) * tail]],
                                 1)
        out.append(win)
    return out[(tiles - 1) % grid][0, 0], np.stack(out)


@pytest.mark.parametrize("blocks", [1, 5, 40])
@pytest.mark.parametrize("form", gd.VARIANTS)
def test_check_windows_are_numpy_slices(form, blocks):
    rows, k, cols, stride = 16, 8, 128, 112
    u = _rand((72, 256), blocks)
    tail = 32 if form in gd.GATHERS else 0
    t = _rand((72, 3 * tail), blocks + 1) if tail else None
    elem, windows = gd.gather_dma(
        form, torch.from_numpy(u), None if t is None else torch.from_numpy(t),
        rows=rows, k=k, cols=cols, stride=stride, blocks=blocks, check=True)
    want_elem, want = _numpy_windows(u, t, rows, k, cols, stride, tail,
                                     blocks)
    assert elem.item() == want_elem
    np.testing.assert_array_equal(windows.numpy(), want)


def test_arrays_lay_the_gathers_pieces_side_by_side():
    u = torch.from_numpy(_rand((40, 256), 5))
    geo = dict(rows=16, k=4, cols=128, stride=112)
    a, t, cols, stride = gd.arrays("gather", u, 32, **geo)
    assert a is u and t.shape == (40, 3 * 32) and (cols, stride) == (128, 112)
    ext, none, ecols, estride = gd.arrays("extdense", u, 32, **geo)
    assert none is None and ecols == estride == 160
    _, gwin = gd.gather_dma("gather", u, t, check=True, blocks=3, **geo)
    _, ewin = gd.gather_dma("extdense", ext, rows=16, k=4, cols=ecols,
                            stride=estride, check=True, blocks=3)
    assert torch.equal(gwin, ewin)
    assert gd.landed_bytes((40, 256), 16, 4, 128, 112, 32) == \
        4 * 2 * 3 * 24 * 160
    assert gd.read_bytes((40, 256), 16, 4, 128, 112, 32) == \
        4 * 40 * (256 + 3 * 32)


@pytest.mark.parametrize("case", ["form", "tail", "no_tail", "rows",
                                  "width", "box", "smem", "tail_width"])
def test_gather_refuses_bad_input(case):
    u = torch.zeros(64, 256)
    t = torch.zeros(64, 128)
    kw = dict(rows=16, k=8, cols=256, stride=256)
    form, arrays = "dense", (u, None)
    if case == "form":
        form = "scatter"
    elif case == "tail":
        arrays = (u, t)
    elif case == "no_tail":
        form = "gather"
    elif case == "rows":
        kw["rows"] = 60
    elif case == "width":
        kw["cols"] = 260
    elif case == "box":
        form, arrays = "gather-tma", (torch.zeros(64, 512), t)
        kw["cols"] = 384
    elif case == "smem":
        form = "gather"
        arrays = (torch.zeros(300, 256), torch.zeros(300, 128))
        kw["rows"] = 200
    else:  # a tail array without a whole piece for each of 3 windows
        form, arrays = "gather", (u, torch.zeros(64, 100))
        kw.update(cols=128, stride=112)
    with pytest.raises(ValueError):
        gd.gather_dma(form, *arrays, **kw)


def test_gather_dma_builds_beside_the_twenty_kernels():
    assert "heat_probe_gather_dma" in build.TOOLS
    assert "heat_probe_gather_dma" not in build.KERNELS
    assert "heat_probe_gather_dma" not in sk.counts
    assert gd.counts == {"heat_probe_gather_dma": 0}
