"""Kernel E-uni's anatomy probe
(``parallel_heat_tpu_torch.tools.probe_temporal``) against the JAX
package's ``tools/probe_temporal.py``.

Only the two probes' full variants compute a function, kernel E's K steps
and the last step's residual: the JAX one (``base``) in the textbook form
on its strip pipeline, run here in interpret mode as the JAX package's
own tests run its Pallas kernels on the CPU, the port's in the factored
form (on the CPU its wrapper takes E-uni's plain version). The cut
variants take one cost each out of a launch on the card and compute
nothing to compare: on the CPU they refuse to run. Tolerance ``rtol=1e-5,
atol=1e-5``: the two forms round differently by a few ulps a step; the
Dirichlet ring bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.probe_temporal as jprobe
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import probe_temporal as pt


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(np.float32)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("shape", [(64, 256), (96, 128)])
def test_probe_full_matches_the_jax_probe(monkeypatch, shape, k):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    u = _rand(shape, k)
    grid, res = jprobe.build(shape, k, 32, 16, "base")(jnp.asarray(u))
    got = torch.empty(shape, dtype=torch.float32)
    r = pt.probe_steps("full", torch.from_numpy(u), got, k, cx=0.1, cy=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(grid), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(r), float(np.asarray(res)[0, 0]),
                               rtol=1e-5, atol=1e-5)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got.numpy()[sl], u[sl])


@pytest.mark.parametrize("k", [1, 5, 8])
def test_probe_full_is_e_uni_plain_on_the_cpu(k):
    u = torch.from_numpy(_rand((45, 52), k))
    got, want = torch.empty_like(u), torch.empty_like(u)
    sk.reset_counts()
    pt.counts["heat_probe_temporal"] = 0
    r = pt.probe_steps("full", u, got, k, cx=0.1, cy=0.2)
    assert sk.counts["temporal_steps_uni_plain"] == 1
    assert pt.counts["heat_probe_temporal"] == 0
    rp = sk.temporal_steps_uni_plain(u, want, k, cx=0.1, cy=0.2)
    assert torch.equal(got, want) and torch.equal(r, rp)
    assert pt.probe_steps("full", u, got, k, False, cx=0.1, cy=0.2) is None


@pytest.mark.parametrize("variant", pt.VARIANTS[1:])
def test_probe_cut_variants_raise_on_the_cpu(variant):
    u = torch.from_numpy(_rand((20, 24), 0))
    with pytest.raises(ValueError, match="runs only on the card"):
        pt.probe_steps(variant, u, torch.empty_like(u), 4, cx=0.1, cy=0.1)


@pytest.mark.parametrize("case", ["variant", "k", "width", "shape"])
def test_probe_refuses_bad_input(case):
    u = torch.zeros((20, 26) if case == "width" else (20, 24))
    out = torch.empty(20, 28) if case == "shape" else torch.empty_like(u)
    variant = "unroll" if case == "variant" else "full"
    with pytest.raises(ValueError):
        pt.probe_steps(variant, u, out, 0 if case == "k" else 4, cx=0.1,
                       cy=0.1)


def test_probe_names_what_each_cut_takes():
    assert set(pt.CUTS.values()) == set(pt.VARIANTS[1:])


def test_probe_builds_beside_the_twenty_kernels():
    assert "heat_probe_temporal" in build.TOOLS
    assert "heat_probe_temporal" not in build.KERNELS
    assert "heat_probe_temporal" not in sk.counts
    assert build.TOOLS["heat_probe_temporal"][1][1:] == \
        build.KERNELS["heat_e_uni_temporal"][1]
