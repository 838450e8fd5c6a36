"""The PyTorch port's ``solve()`` against the JAX package and the oracle.

The port runs on the CPU (``device="cpu"``) under backend ``torch``
(the textbook stencil) and backend ``cuda`` (which takes the kernels'
plain versions because the tensors lie on the CPU). The reference is
JAX's ``solve(HeatConfig(..., backend="jnp"))`` and the float64 oracle
``tests/oracle.py``, on the same configurations.

Tolerances:

- backend ``torch`` evaluates the same textbook tree as JAX's jnp path:
  ``rtol=1e-5, atol=1e-3`` against both references (the oracle contract
  of ``tests/test_solver.py``);
- backend ``cuda`` evaluates the kernels' factored combine, whose
  float32 constants (``a0 = f32(0.6)``) drift about 1e-5 relative in
  300 steps: ``rtol=1e-4, atol=1e-3``, the JAX package's own
  pallas-vs-jnp solve contract (``tests/test_pallas.py``).

``steps_run`` and ``converged`` must be identical everywhere; each eps
is chosen away from the residuals, so no few-ulp difference can move
the stopping window.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import oracle  # noqa: E402

import parallel_heat_tpu as jx  # noqa: E402
from parallel_heat_tpu.models import HeatPlate2D as JaxPlate  # noqa: E402
from parallel_heat_tpu_torch import (HeatConfig, HeatPlate2D,  # noqa: E402
                                     explain, solve, tune)
from parallel_heat_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

TOL = {"torch": dict(rtol=1e-5, atol=1e-3), "cuda": dict(rtol=1e-4, atol=1e-3)}
BACKENDS = ["torch", "cuda"]


def _jax(**kw):
    return jx.solve(jx.HeatConfig(backend="jnp", **kw))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nx,ny,steps", [(64, 64, 300), (100, 75, 257),
                                         (256, 256, 300)])
def test_fixed_matches_jax_and_oracle(backend, nx, ny, steps):
    res = solve(HeatConfig(nx=nx, ny=ny, steps=steps, backend=backend),
                device="cpu")
    ref = _jax(nx=nx, ny=ny, steps=steps)
    assert res.steps_run == ref.steps_run == steps
    assert res.converged is None and res.residual is None
    got = res.to_numpy()
    np.testing.assert_allclose(got, np.asarray(ref.grid), **TOL[backend])
    want = oracle.run(oracle.init_grid(nx, ny), steps)
    np.testing.assert_allclose(got, want, **TOL[backend])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nx,ny", [(64, 48), (100, 75)])
def test_unequal_coefficients_match_jax_and_oracle(backend, nx, ny):
    # cx != cy, so an update that swapped the two axes cannot pass.
    kw = dict(nx=nx, ny=ny, cx=0.1, cy=0.2, steps=200)
    res = solve(HeatConfig(backend=backend, **kw), device="cpu")
    ref = _jax(**kw)
    got = res.to_numpy()
    np.testing.assert_allclose(got, np.asarray(ref.grid), **TOL[backend])
    want = oracle.run(oracle.init_grid(nx, ny), 200, cx=0.1, cy=0.2)
    np.testing.assert_allclose(got, want, **TOL[backend])
    swapped = oracle.run(oracle.init_grid(nx, ny), 200, cx=0.2, cy=0.1)
    assert not np.allclose(got, swapped, **TOL[backend])


@pytest.mark.parametrize("backend", BACKENDS)
def test_converge_matches_jax_and_oracle(backend):
    # Converges at step 1980 with residual 9.3e-4 (the window before:
    # above 1e-3 by a margin far beyond any ulp difference).
    kw = dict(nx=20, ny=20, steps=10000, converge=True, check_interval=20,
              eps=1e-3)
    res = solve(HeatConfig(backend=backend, **kw), device="cpu")
    ref = _jax(**kw)
    want_u, want_k, want_conv, want_res = oracle.run_converge(
        oracle.init_grid(20, 20), 10000, 20, 1e-3)
    assert res.steps_run == ref.steps_run == want_k == 1980
    assert res.converged is ref.converged is True and want_conv
    np.testing.assert_allclose(res.residual, float(ref.residual), rtol=1e-3)
    np.testing.assert_allclose(res.residual, want_res, rtol=1e-3)
    np.testing.assert_allclose(res.to_numpy(), np.asarray(ref.grid),
                               **TOL[backend])
    np.testing.assert_allclose(res.to_numpy(), want_u, **TOL[backend])


@pytest.mark.parametrize("backend", BACKENDS)
def test_converge_tail_runs_when_not_converged(backend):
    # 113 = 5 windows of 20 + a 13-step tail; eps far below any residual.
    kw = dict(nx=30, ny=30, steps=113, converge=True, check_interval=20,
              eps=1e-9)
    res = solve(HeatConfig(backend=backend, **kw), device="cpu")
    ref = _jax(**kw)
    assert res.steps_run == ref.steps_run == 113
    assert res.converged is ref.converged is False
    np.testing.assert_allclose(res.residual, float(ref.residual), rtol=1e-3)
    want = oracle.run(oracle.init_grid(30, 30), 113)
    np.testing.assert_allclose(res.to_numpy(), want, **TOL[backend])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("converge", [False, True])
def test_zero_steps(backend, converge):
    cfg = HeatConfig(nx=16, ny=12, steps=0, converge=converge,
                     backend=backend)
    res = solve(cfg, device="cpu")
    ref = _jax(nx=16, ny=12, steps=0, converge=converge)
    assert res.steps_run == ref.steps_run == 0
    assert res.converged == ref.converged
    if converge:
        assert res.residual == float(ref.residual) == float("inf")
    np.testing.assert_array_equal(res.to_numpy(), np.asarray(ref.grid))


@pytest.mark.parametrize("nx,ny", [(256, 256), (1000, 1000), (31, 17)])
def test_init_grid_bitwise_equal_to_jax(nx, ny):
    got = HeatPlate2D(nx, ny).init_grid("cpu").numpy()
    want = np.asarray(JaxPlate(nx, ny).init_grid())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(HeatPlate2D(nx, ny).init_grid_np(),
                                  JaxPlate(nx, ny).init_grid_np())


def test_initial_is_copied_and_honored():
    rng = np.random.default_rng(0)
    init = (rng.standard_normal((24, 20)) * 5).astype(np.float32)
    t = torch.from_numpy(init.copy())
    res = solve(HeatConfig(nx=24, ny=20, steps=9, backend="cuda"),
                initial=t, device="cpu")
    assert np.array_equal(t.numpy(), init)  # the caller's tensor untouched
    ref = jx.solve(jx.HeatConfig(nx=24, ny=20, steps=9, backend="jnp"),
                   initial=init)
    np.testing.assert_allclose(res.to_numpy(), np.asarray(ref.grid),
                               **TOL["cuda"])
    with pytest.raises(ValueError, match="does not match"):
        solve(HeatConfig(nx=25, ny=20, steps=1), initial=t, device="cpu")


@pytest.mark.parametrize("choice,kernel", [
    ("E", "temporal_steps_plain"), ("B", "strip_step_plain"),
    ("A", "resident_steps_plain"), ("E-uni", "temporal_steps_uni_plain"),
    ("C", "tiled_step_plain"), ("I", "tile_temporal_steps_plain"),
    ("I-uni", "tile_temporal_steps_uni_plain")])
def test_forced_pick_drives_solve(choice, kernel):
    # tune.force pins the single_2d site through the real solve(); the
    # kernels' plain versions give bitwise the same grid (A(K), E(K),
    # E-uni(K), I(K) and I-uni(K) are K B's, C is B).
    cfg = HeatConfig(nx=40, ny=36, steps=21, backend="cuda")
    sk.reset_counts()
    with tune.force("single_2d", choice):
        res = solve(cfg, device="cpu")
    assert sk.counts[kernel] > 0
    plains = {name for name in sk.counts if name.endswith("_plain")}
    assert all(sk.counts[other] == 0 for other in plains - {kernel})
    with tune.force("single_2d", "B"):
        base = solve(cfg.replace(backend="cuda"), device="cpu")
    assert torch.equal(res.grid, base.grid)


def test_explain_reports_the_pick():
    cfg = HeatConfig(nx=16384, ny=16384, steps=10)
    out = explain(cfg, device="cpu")
    assert out["backend"] == "torch"  # auto on the CPU
    out = explain(cfg.replace(backend="cuda"), device="cpu")
    assert out["path"].startswith("kernel E") and "K=8" in out["path"]
    small = explain(cfg.replace(nx=1000, ny=1000, backend="cuda"),
                    device="cpu")
    ty, tx = sk.params().a_tile((1000, 1000))
    assert small["path"].startswith("kernel A") and \
        f"tile={ty}x{tx} depth={sk.params().a_depth}" in small["path"]
    with tune.force("single_2d", "B"):
        out = explain(cfg.replace(backend="cuda"), device="cpu")
    assert out["path"].startswith("kernel B")
    assert out["decided_by"]["single_2d"] == {"source": "forced",
                                              "choice": "B"}


def test_diverging_run_reports_nan_and_stops_like_jax():
    # cx + cy past the stability bound: the residual turns non-finite
    # and ends the loop exactly where JAX's while_loop ends it.
    kw = dict(nx=24, ny=24, cx=0.4, cy=0.4, steps=2000, converge=True,
              check_interval=20, eps=1e-3)
    with pytest.warns(RuntimeWarning):
        ref = _jax(**kw)
    for backend in BACKENDS:
        with pytest.warns(RuntimeWarning):
            res = solve(HeatConfig(backend=backend, **kw), device="cpu")
        assert res.steps_run == ref.steps_run
        assert res.converged is ref.converged is False
        assert np.isnan(res.residual) == np.isnan(float(ref.residual))
        g = res.to_numpy()
        w = np.asarray(ref.grid)
        for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_array_equal(g[sl], w[sl])
