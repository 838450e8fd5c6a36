"""The neighbour-form probe of kernels A and E-uni
(``parallel_heat_tpu_torch.tools.probe_roll_pad``) against the JAX
package's ``tools/ab_roll_pad.py``.

The JAX probe's ``build_padslice`` is kernel A's K steps with the last
step's residual, its state in padded (M, N+2) buffers and the left and
right neighbours read as lane-offset slices; it runs here in interpret
mode, as the JAX package's own tests run its Pallas kernels on the CPU.
Every form of the port's probe (``prod``, ``padslice``, ``nbr4``, on A's
launch and on E-uni's) computes its kernel's function, and on the CPU
takes the kernel's plain version; the card's kernels are held bitwise to
those in ``chip_smoke.py``. Where the forms read other cells than the
shuffles (past a row's end), ``tests/test_torch_a_loop.py``'s emulation
reads NaN and still holds A bitwise. Tolerance ``rtol=1e-5, atol=1e-5``:
the textbook and factored forms of the step round differently by a few
ulps a step; the ring bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.ab_roll_pad as jrp
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import probe_roll_pad as rp

_JAX = {}


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(np.float32)


def _jax_padslice(monkeypatch, shape, k):
    """The JAX probe's grid and residual on ``_rand(shape, k)``, once per
    (shape, k)."""
    if (shape, k) not in _JAX:
        monkeypatch.setattr(pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
        grid, res = jrp.build_padslice(shape, k, strip_rows=16)(
            jnp.asarray(_rand(shape, k)))
        _JAX[shape, k] = (np.asarray(grid), float(res))
    return _JAX[shape, k]


@pytest.mark.parametrize("form", rp.FORMS)
@pytest.mark.parametrize("kernel", ["A", "E-uni"])
@pytest.mark.parametrize("k", [2, 6])
@pytest.mark.parametrize("shape", [(64, 128), (96, 128)])
def test_form_matches_the_jax_probe(monkeypatch, shape, k, kernel, form):
    grid, res = _jax_padslice(monkeypatch, shape, k)
    u = _rand(shape, k)
    got = torch.empty(shape, dtype=torch.float32)
    r = rp.roll_pad_steps(kernel, form, torch.from_numpy(u), got, k, cx=0.1,
                          cy=0.1)
    np.testing.assert_allclose(got.numpy(), grid, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(r), res, rtol=1e-5, atol=1e-5)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got.numpy()[sl], u[sl])


@pytest.mark.parametrize("form", rp.FORMS)
@pytest.mark.parametrize("kernel,k", [("A", 1), ("A", 9), ("A", 20),
                                      ("E-uni", 1), ("E-uni", 6)])
def test_forms_are_the_kernels_plain_versions_on_the_cpu(kernel, k, form):
    u = torch.from_numpy(_rand((45, 52), k))
    got, want = torch.empty_like(u), torch.empty_like(u)
    plain = (sk.resident_steps_plain if kernel == "A"
             else sk.temporal_steps_uni_plain)
    name = ("resident_steps_plain" if kernel == "A"
            else "temporal_steps_uni_plain")
    sk.reset_counts()
    rp.counts["heat_probe_roll_pad"] = 0
    r = rp.roll_pad_steps(kernel, form, u, got, k, cx=0.1, cy=0.2)
    assert sk.counts[name] == 1
    assert rp.counts["heat_probe_roll_pad"] == 0
    rq = plain(u, want, k, cx=0.1, cy=0.2)
    assert torch.equal(got, want) and torch.equal(r, rq)
    assert rp.roll_pad_steps(kernel, form, u, got, k, False, cx=0.1,
                             cy=0.2) is None


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_a_takes_a_halo_depth(depth):
    u = torch.from_numpy(_rand((40, 36), depth))
    got, want = torch.empty_like(u), torch.empty_like(u)
    r = rp.roll_pad_steps("A", "padslice", u, got, 20, cx=0.1, cy=0.1,
                          depth=depth)
    rq = sk.resident_steps_plain(u, want, 20, cx=0.1, cy=0.1)
    assert torch.equal(got, want) and torch.equal(r, rq)


@pytest.mark.parametrize("case", ["kernel", "form", "k", "width", "depth",
                                  "too_large", "shape"])
def test_bad_input_is_refused(case):
    u = torch.zeros((2048, 2048) if case == "too_large"
                    else (20, 23) if case == "width" else (20, 24))
    out = torch.empty(20, 25) if case == "shape" else torch.empty_like(u)
    kernel = ("B" if case == "kernel"
              else "E-uni" if case in ("width", "depth") else "A")
    form = "roll" if case == "form" else "padslice"
    with pytest.raises(ValueError):
        rp.roll_pad_steps(kernel, form, u, out, 0 if case == "k" else 4,
                          cx=0.1, cy=0.1, depth=2 if case == "depth" else None)


def test_instances_name_each_kernel_and_form():
    names = {rp.instance(kernel, form) for kernel in rp.KERNELS
             for form in rp.FORMS}
    assert len(names) == 6
    assert rp.instance("A", "prod") == "heat_a_resident_kernel<0>"
    assert rp.CODES["prod"] == 0 and len(set(rp.CODES.values())) == 3


def test_probe_builds_beside_the_twenty_kernels():
    assert "heat_probe_roll_pad" in build.TOOLS
    assert "heat_probe_roll_pad" not in build.KERNELS
    assert "heat_probe_roll_pad" not in sk.counts
    assert rp.PLATES[0] == ("A", 1000, 20)
