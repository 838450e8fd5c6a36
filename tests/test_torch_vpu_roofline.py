"""The issue-rate roofline probe
(``parallel_heat_tpu_torch.tools.vpu_roofline``) against the JAX
package's ``tools/vpu_roofline.py`` and ``ops/stencil.step_2d``.

The probe's chains and walk compute functions on each member of a stack:
``fma`` and ``muladd`` D passes of a P-deep chain ``x = a x + b`` over
rows 1 .. R-2, ``stencil`` D Jacobi steps with the ring pinned. On the
CPU the port takes their plain versions; the JAX chain runs in interpret
mode, as the JAX package's own tests run its Pallas kernels on the CPU.
Tolerances: the chains at one ulp an operation, ``rtol = P D 2^-23``
(a fused multiply-add and a multiply then an add round differently by at
most an ulp of the result, 2^-23 of it at the foot of a binade, and XLA
on the CPU may contract the JAX chain's ``a * x + b`` into one; a =
0.9999 keeps what came before from growing): 2.4e-7 to 1.9e-6 over the
cases; the walk at ``rtol=1e-5,
atol=1e-5`` (the port's factored combine against the JAX package's
textbook form, a few ulps a step), with the ring bitwise. The
measurement variants compute nothing to compare and refuse the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.vpu_roofline as jroof
from parallel_heat_tpu.ops.stencil import step_2d
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.tools import vpu_roofline as vr

SHAPES = [(24, 256), (40, 128)]


def _stack(shape, seed, members=2):
    return (np.random.default_rng(seed).standard_normal(
        (members,) + shape)).astype(np.float32)


@pytest.mark.parametrize("passes", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind,p", [("fma", 1), ("fma", 4), ("muladd", 4)])
def test_chain_matches_the_jax_probe(monkeypatch, kind, p, shape, passes):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    u = _stack(shape, p + passes)
    got = torch.empty(u.shape, dtype=torch.float32)
    vr.sweep(kind, torch.from_numpy(u), got, passes, p)
    call = jroof._build("fma", *shape, passes, P=p)
    for member in range(u.shape[0]):
        want = np.asarray(call(jnp.asarray(u[member])))
        np.testing.assert_allclose(got[member].numpy(), want,
                                   rtol=p * passes * 2.0 ** -23)
        np.testing.assert_array_equal(got[member, 0].numpy(), u[member, 0])
        np.testing.assert_array_equal(got[member, -1].numpy(), u[member, -1])


@pytest.mark.parametrize("passes", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_stencil_matches_step_2d(shape, passes):
    u = _stack(shape, passes) * 10
    got = torch.empty(u.shape, dtype=torch.float32)
    vr.sweep("stencil", torch.from_numpy(u), got, passes, cx=0.1, cy=0.1)
    for member in range(u.shape[0]):
        want = jnp.asarray(u[member])
        for _ in range(passes):
            want = step_2d(want, 0.1, 0.1)
        want = np.asarray(want)
        g = got[member].numpy()
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_array_equal(g[sl], u[member][sl])


@pytest.mark.parametrize("kind,p", [("fma", 2), ("muladd", 16),
                                    ("stencil", 0)])
def test_functions_take_their_plain_version_on_the_cpu(kind, p):
    u = torch.from_numpy(_stack((20, 32), 3))
    got, want = torch.empty_like(u), torch.empty_like(u)
    sk.reset_counts()
    vr.counts["heat_probe_vpu_roofline"] = 0
    vr.sweep(kind, u, got, 3, p)
    vr.sweep_plain(kind, u, want, 3, p)
    assert torch.equal(got, want)
    assert vr.counts["heat_probe_vpu_roofline"] == 0


def test_fma_plain_rounds_once():
    # a x exact in float64, then one rounding of a x + b to float32: the
    # fused multiply-add's value, not the mul-add's two roundings.
    x = np.float32(1.0) + np.float32(2.0) ** -23
    u = torch.full((1, 3, 8), float(x))
    got = torch.empty_like(u)
    vr.sweep_plain("fma", u, got, 1, 1)
    exact = np.float64(vr.A) * np.float64(x) + np.float64(vr.B)
    assert got[0, 1, 0].item() == float(np.float32(exact))
    assert got[0, 0, 0].item() == float(x)


@pytest.mark.parametrize("kind", ["no_shuffle", "no_row_load", "no_edge"])
def test_measurement_variants_raise_on_the_cpu(kind):
    u = torch.from_numpy(_stack((20, 32), 0))
    with pytest.raises(ValueError, match="runs only on the card"):
        vr.sweep(kind, u, torch.empty_like(u), 2)
    with pytest.raises(ValueError, match="no plain version"):
        vr.sweep_plain(kind, u, torch.empty_like(u), 2)


@pytest.mark.parametrize("case", ["kind", "fma_p", "muladd_p", "walk_p",
                                  "passes", "ragged_cols", "narrow", "rows",
                                  "too_large", "grid", "dtype"])
def test_bad_shapes_and_depths_are_refused(case):
    shape = {"ragged_cols": (1, 20, 30), "narrow": (1, 20, 4),
             "rows": (1, 2, 32), "too_large": (1, 256, 256),
             "grid": (20, 32)}.get(case, (1, 20, 32))
    u = torch.zeros(shape, dtype=torch.float64 if case == "dtype"
                    else torch.float32)
    kind, p = {"kind": ("roll", 0), "fma_p": ("fma", 3),
               "muladd_p": ("muladd", 0), "walk_p": ("stencil", 1)}.get(
                   case, ("fma", 1))
    with pytest.raises((ValueError, TypeError)):
        vr.sweep(kind, u, torch.empty_like(u), 0 if case == "passes" else 2,
                 p)


def test_bound_is_shared_bytes_at_p1_and_issue_at_p16():
    shape = (132, vr.ROWS, vr.COLS)
    assert vr.bound_us("fma", 1, shape, 132, 1980.0)[1] == "shared bytes"
    assert vr.bound_us("fma", 16, shape, 132, 1980.0)[1] == "instructions"
    units, ops, nbytes = vr.work("stencil", 0, shape)
    assert units == 132 * (vr.ROWS - 2) * (vr.COLS - 2)
    assert ops == 7 * units and nbytes == 8 * 132 * (vr.ROWS - 2) * vr.COLS
    # One block an SM: two buffers of the default tile exceed half of a
    # block's shared memory, so no second block fits.
    from parallel_heat_tpu_torch.ops.hopper_params import params
    assert 2 * 4 * vr.ROWS * vr.COLS > params().smem_per_block_max // 2


def test_probe_builds_beside_the_twenty_kernels():
    assert "heat_probe_vpu_roofline" in build.TOOLS
    assert "heat_probe_vpu_roofline" not in build.KERNELS
    assert "heat_probe_vpu_roofline" not in sk.counts
    path = build.library_path("heat_probe_vpu_roofline")
    assert path.name.startswith("libheat_probe_vpu_roofline-")
