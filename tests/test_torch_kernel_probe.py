"""Kernel A's anatomy probe (``parallel_heat_tpu_torch.tools.kernel_probe``)
against the JAX package's ``tools/kernel_probe.py``.

Only the two probes' ``full`` variants compute a function, kernel A's K
steps: the JAX one in the textbook form ``c + cx (u + d - 2c) + cy (l + r
- 2c)`` on a TPU layout (run here in interpret mode, as the JAX package's
own tests run its Pallas kernels on the CPU), the port's in the factored
form of ``ops/stencil.py`` (on the CPU its wrapper takes A's plain
version). The other variants cut one cost each out of a launch on their
own device and compute nothing to compare: on the CPU the port's refuse
to run. Tolerance ``rtol=1e-5, atol=1e-5``: the two forms round
differently by a few ulps a step.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.kernel_probe as jprobe
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import kernel_probe as kp


def _rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(np.float32)


@pytest.mark.parametrize("k", [2, 20])
@pytest.mark.parametrize("shape", [(24, 40), (33, 20)])
def test_probe_full_matches_the_jax_probe(monkeypatch, shape, k):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    u = _rand(shape, k)
    want = np.asarray(jprobe.build(shape, k, "full")(jnp.asarray(u)))
    got = torch.empty(shape, dtype=torch.float32)
    kp.probe_steps("full", torch.from_numpy(u), got, k, cx=0.1, cy=0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got.numpy()[sl], u[sl])


@pytest.mark.parametrize("k", [1, 9, 20])
def test_probe_full_is_a_on_the_cpu(k):
    u = torch.from_numpy(_rand((45, 50), k))
    got, want = torch.empty_like(u), torch.empty_like(u)
    sk.reset_counts()
    kp.counts["heat_probe_kernel"] = 0
    r = kp.probe_steps("full", u, got, k, cx=0.1, cy=0.2)
    assert sk.counts["resident_steps_plain"] == 1
    assert kp.counts["heat_probe_kernel"] == 0
    rp = sk.resident_steps_plain(u, want, k, cx=0.1, cy=0.2)
    assert torch.equal(got, want) and torch.equal(r, rp)
    assert kp.probe_steps("full", u, got, k, False, cx=0.1, cy=0.2) is None


@pytest.mark.parametrize("variant", kp.VARIANTS[1:])
def test_probe_variants_are_no_function_on_the_cpu(variant):
    u = torch.from_numpy(_rand((20, 24), 0))
    with pytest.raises(ValueError, match="runs only on the card"):
        kp.probe_steps(variant, u, torch.empty_like(u), 5, cx=0.1, cy=0.1)


@pytest.mark.parametrize("case", ["variant", "k", "too_large", "shape"])
def test_probe_refuses_bad_input(case):
    u = torch.zeros((2048, 2048) if case == "too_large" else (20, 24))
    out = torch.empty_like(u) if case != "shape" else torch.empty(20, 25)
    variant = "no_roll" if case == "variant" else "full"
    with pytest.raises(ValueError):
        kp.probe_steps(variant, u, out, 0 if case == "k" else 4, cx=0.1,
                       cy=0.1)


def test_probe_builds_beside_the_twenty_kernels():
    # The probe's library is a tool's: built and loaded like a kernel's,
    # never one of the solver's twenty (KERNELS, stencil_kernels.counts).
    assert "heat_probe_kernel" in build.TOOLS
    assert "heat_probe_kernel" not in build.KERNELS
    assert "heat_probe_kernel" not in sk.counts
    path = build.library_path("heat_probe_kernel")
    assert path.name.startswith("libheat_probe_kernel-")
    assert path != build.library_path("heat_a_resident")
