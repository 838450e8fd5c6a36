"""The port's multigrid level operations against the JAX package.

Everything runs on the CPU: the transfer wrappers take their plain
versions there, and the JAX transfer kernels (``_build_restrict_kernel``,
``_build_prolong_kernel``) run in Pallas interpret mode.

Tolerances:

- restriction and prolongation: **bitwise** against both the JAX kernels
  and the jnp spellings. Every multiply is by a power of two (exact, so
  an FMA contraction in XLA:CPU cannot change a bit) and the additions
  associate as in the JAX spelling, ``(a + 2b) + c``;
- smoother, residual and operator: ``rtol=1e-5`` with an ``atol`` of 1e-5
  of the data's scale. XLA:CPU contracts the single multiply of each
  axis term into an FMA where eager PyTorch rounds it first;
- within the port, the ``cuda`` and ``torch`` transfer spellings, and a
  member of a stack against the member alone: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu.ops import multigrid as jmg
from parallel_heat_tpu_torch import HeatConfig
from parallel_heat_tpu_torch.config import multigrid_level_shapes
from parallel_heat_tpu_torch.ops import multigrid as mg
from parallel_heat_tpu_torch.ops import stencil_kernels as sk

# Fine full shapes: even and odd interiors on each axis, and the
# smallest hierarchy step (a 3 x 2 interior onto 1 x 1).
FINE = [(34, 34), (35, 33), (66, 41), (5, 4), (20, 19)]


def _rand(shape, seed, ring=True):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 10).astype(np.float32)
    if not ring:
        a[..., 0, :] = a[..., -1, :] = 0
        a[..., :, 0] = a[..., :, -1] = 0
    return a


def _coarse(fine):
    return ((fine[0] - 2) // 2 + 2, (fine[1] - 2) // 2 + 2)


def _ring_is_zero(a):
    return not (a[..., 0, :].any() or a[..., -1, :].any()
                or a[..., :, 0].any() or a[..., :, -1].any())


def test_level_shapes_are_the_jax_packages():
    from parallel_heat_tpu.config import multigrid_level_shapes as jshapes

    for shape in [(66, 66), (20, 20), (513, 300), (5, 5), (34, 35)]:
        for levels in (None, 1, 3):
            assert (multigrid_level_shapes(shape, levels)
                    == jshapes(shape, levels))


@pytest.mark.parametrize("fine", FINE)
def test_restrict_is_bitwise_the_jax_kernel_and_jnp(fine):
    r = _rand(fine, seed=1)
    cs = _coarse(fine)
    got = mg.restrict(torch.from_numpy(r), cs).numpy()
    assert got.shape == cs and _ring_is_zero(got)
    kernel = np.asarray(jmg._build_restrict_kernel(fine, cs)(r))
    plain = np.asarray(jmg.restrict_full_weighting(r, cs))
    assert np.array_equal(got, kernel)
    assert np.array_equal(got, plain)
    assert np.array_equal(
        got, mg.restrict_full_weighting(torch.from_numpy(r), cs).numpy())


@pytest.mark.parametrize("fine", FINE)
def test_prolong_is_bitwise_the_jax_kernel_and_jnp(fine):
    cs = _coarse(fine)
    c = _rand(cs, seed=2, ring=False)
    got = mg.prolong(torch.from_numpy(c), fine).numpy()
    assert got.shape == fine and _ring_is_zero(got)
    kernel = np.asarray(jmg._build_prolong_kernel(cs, fine)(c))
    plain = np.asarray(jmg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2)))
    assert np.array_equal(got, kernel)
    assert np.array_equal(got, plain)


def test_transfers_of_a_constant_and_of_a_stack():
    # Full weighting of a constant interior is the constant away from the
    # ring; bilinear prolongation of it likewise.
    r = torch.zeros((18, 18))
    r[1:-1, 1:-1] = 3.0
    c = mg.restrict(r, (10, 10))
    assert torch.equal(c[2:-2, 2:-2], torch.full((6, 6), 3.0))
    f = mg.prolong(c, (18, 18))
    assert torch.equal(f[4:-4, 4:-4], torch.full((10, 10), 3.0))
    # A stack of members is each member alone.
    stack = torch.from_numpy(_rand((3, 35, 33), seed=3))
    cs = _coarse((35, 33))
    got = mg.restrict(stack, cs)
    back = mg.prolong(got, (35, 33))
    assert got.shape == (3,) + cs and back.shape == (3, 35, 33)
    for b in range(3):
        assert torch.equal(got[b], mg.restrict(stack[b], cs))
        assert torch.equal(back[b], mg.prolong(got[b], (35, 33)))


@pytest.mark.parametrize("case", ["dtype", "tiny", "coarse_too_large",
                                  "fine_not_double"])
def test_transfers_reject_bad_inputs(case):
    if case == "dtype":
        with pytest.raises(TypeError):
            mg.restrict(torch.zeros((10, 10), dtype=torch.float64), (6, 6))
    elif case == "tiny":
        with pytest.raises(ValueError):
            mg.restrict(torch.zeros((10, 10)), (2, 6))
    elif case == "coarse_too_large":
        with pytest.raises(ValueError, match="more than half"):
            mg.restrict(torch.zeros((10, 10)), (7, 6))
    else:
        with pytest.raises(ValueError, match="not twice"):
            mg.prolong(torch.zeros((6, 6)), (12, 10))


def test_transfer_ops_picks_by_backend_and_counts():
    r = torch.from_numpy(_rand((34, 34), seed=4))
    sk.reset_counts()
    out = {}
    for backend in ("cuda", "torch"):
        restrict, prolong = mg.transfer_ops(backend)
        c = restrict(r, (18, 18))
        out[backend] = (c, prolong(c, (34, 34)))
    # On the CPU both spellings end in the plain versions, and no kernel
    # launches.
    assert torch.equal(out["cuda"][0], out["torch"][0])
    assert torch.equal(out["cuda"][1], out["torch"][1])
    assert sk.counts["restrict_full_weighting"] == 2
    assert sk.counts["prolong_bilinear"] == 2
    assert sk.counts["heat_mg_restrict"] == sk.counts["heat_mg_prolong"] == 0


@pytest.mark.parametrize("shape", [(34, 34), (21, 40)])
@pytest.mark.parametrize("ax,ay", [(22.5, 22.5), (1.4, 5.6)])
def test_level_operations_match_jax(shape, ax, ay):
    u, b = _rand(shape, seed=5), _rand(shape, seed=6)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    scale = 10.0 * (1 + 4 * (ax + ay))
    tol = dict(rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(mg.apply_A_interior(tu, ax, ay).numpy(),
                               np.asarray(jmg.apply_A_interior(u, ax, ay)),
                               **tol)
    np.testing.assert_allclose(
        mg.residual_interior(tu, tb, ax, ay).numpy(),
        np.asarray(jmg.residual_interior(u, b, ax, ay)), **tol)
    np.testing.assert_allclose(float(mg.residual_norm(tu, tb, ax, ay)),
                               float(jmg.residual_norm(u, b, ax, ay)),
                               rtol=1e-5)
    got = mg.smooth(tu, tb, ax, ay).numpy()
    want = jmg.smooth(jnp.asarray(u), jnp.asarray(b), ax, ay)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    # The ring is carried over, bit for bit.
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert np.array_equal(got[sl], u[sl])


def test_hierarchy_matches_jax():
    kw = dict(nx=66, ny=50, cx=22.5, cy=11.0, scheme="crank_nicolson",
              mg_levels=3)
    got = mg.level_coefficients(HeatConfig(device="cpu", **kw))
    want = jmg.level_coefficients(jx.HeatConfig(**kw))
    assert got == want
    assert mg.scheme_theta("crank_nicolson") == 0.5
    assert mg.scheme_theta("backward_euler") == 1.0
    assert (mg._OMEGA, mg._COARSE_SWEEPS) == (jmg._OMEGA, jmg._COARSE_SWEEPS)
