"""Kernel E-uni's boundary A/B probe
(``parallel_heat_tpu_torch.tools.ab_temporal``) against the JAX
package's ``tools/ab_temporal.py``.

``prod`` and ``rowcopy`` compute kernel E's K steps and the last step's
residual (``rowcopy`` bitwise ``prod`` on finite grids whose ring holds
no -0.0): the JAX ones on its strip pipeline, run here in interpret mode
as the JAX package's own tests run its Pallas kernels on the CPU; the
port's, on the CPU, through E-uni's plain version. ``vcoeff`` is a
measurement (unsafe on a diverging grid) and refuses the CPU; the TPU
probe's ``vzero`` and ``vzero2`` are refused by name, since E-uni's TMA
load lands zeros outside the grid. Tolerance ``rtol=1e-5, atol=1e-5``:
the forms round differently by a few ulps a step; the ring bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.ab_temporal as jab
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import ab_temporal as ab


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(np.float32)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("shape", [(64, 256), (96, 128)])
@pytest.mark.parametrize("variant", ["prod", "rowcopy"])
def test_boundary_form_matches_the_jax_probe(monkeypatch, variant, shape,
                                             k):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    u = _rand(shape, k + len(variant))
    grid, res = jab.build(shape, k, 32, 16, variant)(jnp.asarray(u))
    got = torch.empty(shape, dtype=torch.float32)
    r = ab.ab_steps(variant, torch.from_numpy(u), got, k, cx=0.1, cy=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(grid), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(r), float(np.asarray(res)[0, 0]),
                               rtol=1e-5, atol=1e-5)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got.numpy()[sl], u[sl])


def test_vcoeff_raises_on_the_cpu():
    u = torch.from_numpy(_rand((20, 24), 0))
    with pytest.raises(ValueError, match="runs only on the card"):
        ab.ab_steps("vcoeff", u, torch.empty_like(u), 4, cx=0.1, cy=0.1)


@pytest.mark.parametrize("variant", ["vzero", "vzero2"])
def test_zeroing_forms_are_refused_as_moot(variant):
    u = torch.from_numpy(_rand((20, 24), 0))
    with pytest.raises(ValueError, match="TMA load lands zeros"):
        ab.ab_steps(variant, u, torch.empty_like(u), 4, cx=0.1, cy=0.1)


@pytest.mark.parametrize("variant", ["prod", "rowcopy"])
def test_functions_are_e_uni_plain_on_the_cpu(variant):
    u = torch.from_numpy(_rand((33, 40), 1))
    got, want = torch.empty_like(u), torch.empty_like(u)
    ab.counts["heat_probe_ab_temporal"] = 0
    r = ab.ab_steps(variant, u, got, 6, cx=0.1, cy=0.2)
    rp = sk.temporal_steps_uni_plain(u, want, 6, cx=0.1, cy=0.2)
    assert torch.equal(got, want) and torch.equal(r, rp)
    assert ab.counts["heat_probe_ab_temporal"] == 0


def test_unknown_form_is_refused():
    u = torch.zeros((20, 24))
    with pytest.raises(ValueError, match="unknown variant"):
        ab.ab_steps("select", u, torch.empty_like(u), 4, cx=0.1, cy=0.1)


def test_probe_builds_beside_the_twenty_kernels():
    assert "heat_probe_ab_temporal" in build.TOOLS
    assert "heat_probe_ab_temporal" not in build.KERNELS
    assert "heat_probe_ab_temporal" not in sk.counts
    assert set(ab.CODES) == set(ab.VARIANTS) and ab.CODES["prod"] == 0
