"""The sweep probes (``parallel_heat_tpu_torch.tools.probe_sweep_width``
and ``probe_store_align``, one shared-memory sweep) against the JAX
package's ``tools/probe_sweep_width.py`` and ``tools/probe_store_align.py``.

Both compute ``D // 2`` pairs of sweeps of a band of rows, ``(0.6 C +
0.1 (U + D)) + 0.1 (L + R)`` with L and R periodic. The JAX probes run
here in interpret mode, as the JAX package's own tests run its Pallas
kernels on the CPU; the port, on the CPU, through its plain version. The
JAX probes start only their output as the input: the second sweep of a
pair reads scratch rows ``lo - 1`` and ``lo + rows`` that nothing wrote,
which interpret mode fills with NaN, so ``D - 1`` rows at each edge of the
band (``2 (D // 2) - 1``) are undefined there. The port starts both
buffers as the input, which defines them. So the parity compares only
the rows the JAX probe leaves finite (``atol=1e-5``: XLA may round the
combine otherwise), after asserting that they hold ``[lo + D - 1, lo +
rows - D + 1)``; the port's every row is held bitwise to a numpy sweep
whose scratch starts as the input.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.probe_store_align as jalign
import tools.probe_sweep_width as jwidth
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import probe_store_align as sa
from parallel_heat_tpu_torch.tools import probe_sweep_width as sw


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _numpy_sweeps(u, lo, rows, d):
    """The function in numpy float32, both buffers starting as ``u``."""
    a0, cc = np.float32(0.6), np.float32(0.1)
    a, b = u.copy(), u.copy()
    for _ in range(d // 2):
        for src, dst in ((a, b), (b, a)):
            c = src[lo:lo + rows]
            dst[lo:lo + rows] = ((a0 * c + cc * (src[lo - 1:lo + rows - 1]
                                                 + src[lo + 1:lo + rows + 1]))
                                 + cc * (np.roll(c, 1, 1) + np.roll(c, -1, 1)))
    return a


def _hold(jax_out, port, u, lo, rows, d):
    jax_out = np.asarray(jax_out)
    finite = np.isfinite(jax_out).all(axis=1)
    assert finite[lo + d - 1:lo + rows - d + 1].all()
    np.testing.assert_allclose(port[finite], jax_out[finite], rtol=0,
                               atol=1e-5)
    outside = np.r_[0:lo, lo + rows:u.shape[0]]
    np.testing.assert_array_equal(jax_out[outside], u[outside])
    np.testing.assert_array_equal(port[outside], u[outside])
    assert np.isfinite(port).all()
    np.testing.assert_array_equal(port, _numpy_sweeps(u, lo, rows, d))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("d", [2, 4, 5])
@pytest.mark.parametrize("lo", sa.OFFSETS)
def test_store_align_matches_the_jax_probe(interpret, lo, d):
    u = _rand((48, 128), lo + d)
    want = jalign.build(48, 128, lo, 24, d)(jnp.asarray(u))
    got = torch.empty((1, 48, 128))
    sa.align_sweep(torch.from_numpy(u)[None], got, d, lo=lo, rows=24)
    _hold(want, got[0].numpy(), u, lo, 24, d)


def test_sweep_width_matches_the_jax_probe(interpret):
    u = _rand((40, 256), 7)
    want = jwidth.build(40, 256, 24, 4)(jnp.asarray(u))
    got = torch.empty((1, 40, 256))
    sw.sweep(torch.from_numpy(u)[None], got, 4, lo=8, rows=24)
    _hold(want, got[0].numpy(), u, 8, 24, 4)


@pytest.mark.parametrize("width", [4, 5, 31, 128, 129])
@pytest.mark.parametrize("d", [0, 1, 2, 3, 6])
def test_sweep_is_numpy_on_a_stack(width, d):
    u = _rand((3, 20, width), width + d)
    got = torch.empty(u.shape)
    sw.sweep(torch.from_numpy(u), got, d, lo=3, rows=15)
    for m in range(3):
        np.testing.assert_array_equal(got[m].numpy(),
                                      _numpy_sweeps(u[m], 3, 15, d))
    if d < 2:
        np.testing.assert_array_equal(got.numpy(), u)


def test_both_entry_points_compute_one_function():
    u = torch.from_numpy(_rand((2, 30, 64), 3))
    a, b = torch.empty_like(u), torch.empty_like(u)
    sw.sweep(u, a, 6, lo=9, rows=16)
    sa.align_sweep(u, b, 6, lo=9, rows=16)
    assert torch.equal(a, b)
    assert sw.counts["heat_probe_sweep_width"] == 0
    assert sa.counts["heat_probe_store_align"] == 0


def test_card_shapes_fit_one_sm():
    for w in sw.WIDTHS:
        assert 8 * sw.R * w <= 232_448
        assert sw.LO + sw.ROWS <= sw.R - 1
    for w in sa.WIDTHS:
        assert 8 * sa.R * w <= 232_448
        assert max(sa.OFFSETS) + sa.ROWS <= sa.R - 1
    assert sa.WIDTHS[0] % 4 == 0 and sa.WIDTHS[1] % 4 != 0


@pytest.mark.parametrize("case", ["smem", "below", "above", "sweeps",
                                  "width", "rank", "alias"])
def test_sweep_refuses_bad_input(case):
    shape = {"smem": (1, 300, 256), "width": (1, 20, 3),
             "rank": (20, 64)}.get(case, (1, 20, 64))
    u = torch.zeros(shape)
    out = u if case == "alias" else torch.empty_like(u)
    lo, rows, d = {"below": (5, 15, 2), "above": (0, 10, 2),
                   "sweeps": (3, 10, -1)}.get(case, (3, 10, 2))
    with pytest.raises(ValueError):
        sw.sweep(u, out, d, lo=lo, rows=rows)
    with pytest.raises(ValueError):
        sa.align_sweep(u, out, d, lo=lo, rows=rows)


def test_sweep_probes_build_beside_the_twenty_kernels():
    for name in ("heat_probe_sweep_width", "heat_probe_store_align"):
        assert name in build.TOOLS
        assert name not in build.KERNELS
        assert name not in sk.counts
    assert build.TOOLS["heat_probe_sweep_width"][1] == \
        build.TOOLS["heat_probe_store_align"][1]
