"""The port's implicit stepping against the JAX package.

Everything runs on the CPU, against JAX's ``backend="jnp"`` run of the
same config, at ``cx = cy = 22.5`` (45 times the explicit bound).

Tolerances:

- a run pinned to a fixed cycle count (``mg_tol`` tiny, ``mg_cycles =
  3``) executes the same operations on both sides; what differs is
  XLA:CPU's FMA contraction of the one multiply per axis term, a
  few ulp per operation: ``rtol=2e-5`` with an ``atol`` of 2e-5 of the
  grid's scale after 5 steps;
- a run that cycles to ``mg_tol`` stops each step's solve at a residual
  of at most ``mg_tol * max|b|``, and the two sides' iterates differ by
  rounding only while their cycle counts agree: the same bound over 6
  steps, and the cycle counts from ``cycle_trace`` must be equal (the
  residuals fall by about half a cycle, so none sits within a few ulp of
  its tolerance). Over the 20 steps of a converge run a step may stop
  one cycle apart on the two sides, which moves its solution by up to
  ``mg_tol * max|b|`` (``|A^-1| <= 1``), and neither scheme amplifies
  it: ``atol = mg_tol * max|grid|`` there, with identical ``steps_run``;
- Dirichlet cells: bit-exact;
- within the port, ``backend="cuda"`` against ``backend="torch"`` and a
  member of an ensemble against the solo solve: bitwise.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu import solver as jsolver
from parallel_heat_tpu.ops import multigrid as jmg
from parallel_heat_tpu_torch import (EnsembleSolver, HeatConfig, convert,
                                     explain, solve)
from parallel_heat_tpu_torch.cli import main as cli_main
from parallel_heat_tpu_torch.ensemble import ensemble_path
from parallel_heat_tpu_torch.ops import multigrid as mg

SCHEMES = ["backward_euler", "crank_nicolson"]
STIFF = dict(cx=22.5, cy=22.5)


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def _ring_exact(got, u0):
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert np.array_equal(got[sl], u0[sl])


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 10).astype(np.float32)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("nx,ny", [(34, 34), (66, 41)])
def test_fixed_cycle_count_matches_jax(scheme, nx, ny, backend):
    kw = dict(nx=nx, ny=ny, steps=5, scheme=scheme, mg_tol=1e-30,
              mg_cycles=3, mg_levels=4, **STIFF)
    u0 = _rand((nx, ny), seed=nx)
    ref = jx.solve(jx.HeatConfig(backend="jnp", **kw), initial=u0)
    mg.reset_stats()
    res = solve(HeatConfig(backend=backend, **kw), initial=u0, device="cpu")
    assert mg.stats == {"steps": 5, "cycles": 15, "host_syncs": 20}
    assert res.steps_run == ref.steps_run == 5
    _close(res.to_numpy(), np.asarray(ref.grid))
    _ring_exact(res.to_numpy(), u0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cycling_to_mg_tol_matches_jax(scheme):
    kw = dict(nx=66, ny=66, steps=6, scheme=scheme, **STIFF)
    cfg = HeatConfig(**kw)
    jcfg = jx.HeatConfig(backend="jnp", **kw)
    ref = jx.solve(jcfg)
    res = solve(cfg, device="cpu")
    _close(res.to_numpy(), np.asarray(ref.grid))
    # The same cycle count, first step and last, and the same trace.
    for grid in (None, res.grid):
        start = (solve(cfg.replace(steps=0), device="cpu").grid
                 if grid is None else grid)
        got = mg.cycle_trace(cfg, start)
        want = jmg.cycle_trace(jcfg, np.asarray(start))
        assert set(got) == set(want)
        assert got["cycles"] == want["cycles"] > 0
        assert got["levels"] == want["levels"] == 5
        assert got["converged"] and want["converged"]
        # No residual within a few ulp of its tolerance.
        assert got["residual_last"] < 0.98 * got["tol"]
        np.testing.assert_allclose(got["residuals"], want["residuals"],
                                   rtol=1e-3)
        np.testing.assert_allclose(got["contraction"], want["contraction"],
                                   rtol=1e-3)
    assert mg.cycle_trace(cfg, res.grid, max_cycles=2)["cycles"] == 2


@pytest.mark.parametrize("scheme", SCHEMES)
def test_converge_mode_matches_jax(scheme):
    # The update's max-norm falls through eps = 50 between the windows
    # that end at steps 15 and 20 (190 then 34 for backward Euler, 82
    # then 34 for Crank-Nicolson): a margin of tens of percent.
    kw = dict(nx=34, ny=34, steps=60, converge=True, eps=50.0,
              check_interval=5, scheme=scheme, **STIFF)
    ref = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    res = solve(HeatConfig(**kw), device="cpu")
    assert res.steps_run == ref.steps_run == 20
    assert res.converged is True and bool(ref.converged)
    np.testing.assert_allclose(res.residual, float(ref.residual), rtol=1e-2)
    want = np.asarray(ref.grid)
    np.testing.assert_allclose(res.to_numpy(), want, rtol=2e-5,
                               atol=1e-3 * float(np.abs(want).max()))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cuda_and_torch_backends_are_bitwise_on_the_cpu(scheme):
    kw = dict(nx=50, ny=37, steps=4, scheme=scheme, **STIFF)
    a = solve(HeatConfig(backend="cuda", **kw), device="cpu")
    b = solve(HeatConfig(backend="torch", **kw), device="cpu")
    assert torch.equal(a.grid, b.grid)


def test_backward_euler_holds_its_linear_system():
    # One step: ||b - A u'|| <= mg_tol * ||b||, evaluated in float64.
    cfg = HeatConfig(nx=66, ny=66, steps=1, scheme="backward_euler",
                     mg_tol=1e-4, **STIFF)
    u0 = _rand((66, 66), seed=7)
    new = solve(cfg, initial=u0, device="cpu").to_numpy().astype(np.float64)
    b = u0.astype(np.float64)
    c = new[1:-1, 1:-1]
    lap = (22.5 * (new[2:, 1:-1] + new[:-2, 1:-1] - 2 * c)
           + 22.5 * (new[1:-1, 2:] + new[1:-1, :-2] - 2 * c))
    res = np.abs(b[1:-1, 1:-1] - (c - lap)).max()
    # 1.05: the float32 solve's rounding on top of its own verdict.
    assert res <= 1.05 * 1e-4 * np.abs(b[1:-1, 1:-1]).max()


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_ensemble_member_is_bitwise_the_solo_implicit_solve(scheme, backend):
    # Members of very different smoothness need different cycle counts,
    # so the per-member freeze inside a step's solve is exercised.
    cfg = HeatConfig(nx=34, ny=30, steps=4, scheme=scheme, backend=backend,
                     device="cpu", **STIFF)
    assert ensemble_path(cfg) == "vmap"
    smooth = solve(cfg.replace(steps=0)).to_numpy()
    inits = np.stack([smooth, _rand((34, 30), seed=8),
                      np.zeros((34, 30), np.float32)])
    cycles = [mg.cycle_trace(cfg, inits[i])["cycles"] for i in range(3)]
    assert len(set(cycles)) == 3 and cycles[2] == 0
    got = EnsembleSolver(cfg, 3).solve(initials=inits)
    for i in range(3):
        solo = solve(cfg, initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid), i


def test_ensemble_converge_implicit_matches_solo():
    cfg = HeatConfig(nx=34, ny=34, steps=60, converge=True, eps=2.0,
                     check_interval=5, scheme="backward_euler",
                     device="cpu", **STIFF)
    base = solve(cfg.replace(steps=0)).to_numpy()
    inits = np.stack([base * np.float32(s) for s in (1.0, 0.01, 30.0)])
    got = EnsembleSolver(cfg, 3).solve(initials=inits)
    assert len(set(got.steps_run.tolist())) > 1
    for i in range(3):
        solo = solve(cfg, initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid), i
        assert int(got.steps_run[i]) == solo.steps_run
        assert float(got.residual[i]) == solo.residual


# --- config, spec, explain, CLI ---------------------------------------------

@pytest.mark.parametrize("knob,value", [("mg_tol", 1e-4), ("mg_cycles", 9),
                                        ("mg_smooth", 2), ("mg_levels", 3)])
def test_mg_knobs_with_explicit_are_refused_with_the_jax_message(knob,
                                                                  value):
    with pytest.raises(ValueError) as ours:
        HeatConfig(**{knob: value}).validate()
    with pytest.raises(ValueError) as theirs:
        jx.HeatConfig(**{knob: value}).validate()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw,match", [
    (dict(scheme="implicit"), "scheme must be one of"),
    (dict(scheme="backward_euler", nz=8), "2D-only"),
    (dict(scheme="backward_euler", mg_tol=0.0), "mg_tol"),
    (dict(scheme="backward_euler", mg_cycles=0), "mg_cycles"),
    (dict(scheme="crank_nicolson", mg_smooth=0), "mg_smooth"),
    (dict(scheme="crank_nicolson", mg_levels=0), "mg_levels")])
def test_validate_rejects_bad_scheme_fields(kw, match):
    with pytest.raises(ValueError, match=match):
        HeatConfig(**kw).validate()


def test_no_stability_warning_for_implicit_schemes(recwarn):
    HeatConfig(scheme="backward_euler", **STIFF).validate()
    assert not [w for w in recwarn if "stability" in str(w.message)]
    with pytest.warns(RuntimeWarning, match="scheme='backward_euler'"):
        HeatConfig(**STIFF).validate()


def test_one_spec_loads_in_both_packages():
    jcfg = jx.HeatConfig(nx=34, ny=34, steps=3, scheme="backward_euler",
                         mg_tol=1e-4, mg_levels=3, **STIFF)
    spec = jcfg.to_json()
    assert jx.HeatConfig.from_json(spec) == jcfg
    cfg = HeatConfig.from_json(spec)
    assert (cfg.scheme, cfg.mg_tol, cfg.mg_levels) == ("backward_euler",
                                                       1e-4, 3)
    fields = json.loads(spec)
    cfg2, grid = convert.from_jax(dataclasses.asdict(jcfg), None,
                                  device="cpu")
    assert grid is None and cfg2 == cfg.replace(device="cpu")
    # mg_partition belongs to sharded runs, which the port does not have.
    fields["mg_partition"] = "replicated"
    with pytest.raises(ValueError, match="mg_partition=.*not implemented"):
        HeatConfig.from_dict(fields)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_explain_multigrid_keys_are_the_jax_packages(backend):
    kw = dict(nx=66, ny=50, scheme="crank_nicolson", mg_levels=3, **STIFF)
    got = explain(HeatConfig(backend=backend, device="cpu", **kw))
    want = jsolver.explain(jx.HeatConfig(backend="jnp", **kw))
    assert set(got["multigrid"]) == set(want["multigrid"])
    assert got["multigrid"]["levels"] == want["multigrid"]["levels"]
    assert got["multigrid"]["smoother"] == want["multigrid"]["smoother"]
    assert got["multigrid"]["cycle_stop"] == want["multigrid"]["cycle_stop"]
    assert got["scheme"] == want["scheme"] == "crank_nicolson"
    assert got["path"].startswith("implicit crank_nicolson: multigrid")
    assert ("heat_mg_restrict" in got["multigrid"]["transfers"]) == (
        backend == "cuda")


def test_cli_runs_an_implicit_scheme_and_an_implicit_ensemble(capsys):
    common = ["--nx", "34", "--ny", "34", "--cx", "22.5", "--cy", "22.5",
              "--steps", "3", "--device", "cpu"]
    assert cli_main(common + ["--scheme", "backward_euler", "--mg-tol",
                              "1e-4"]) == 0
    assert "Elapsed time" in capsys.readouterr().out
    assert cli_main(common + ["--scheme", "crank_nicolson", "--ensemble",
                              "2"]) == 0
    out = capsys.readouterr().out
    assert "member 1: 3 steps" in out
    assert cli_main(common + ["--mg-cycles", "4"]) == 2
    assert "only apply to the implicit" in capsys.readouterr().err
    assert cli_main(common + ["--scheme", "backward_euler", "--explain",
                              "--ensemble", "4"]) == 0
    out = capsys.readouterr().out
    assert "multigrid:" in out and "ensemble:" in out
