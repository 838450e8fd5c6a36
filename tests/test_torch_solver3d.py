"""The PyTorch port's 3D ``solve()``, model, config, conversion and CLI
against the JAX package and the float64 oracle.

The port runs on the CPU (``device="cpu"``) under backend ``torch`` (the
textbook 7-point stencil) and backend ``cuda`` (kernels F and D, which
take their plain versions because the tensors lie on the CPU). The
references are JAX's ``solve(HeatConfig(..., nz=..., backend="jnp"))``
and ``tests/oracle.py``'s float64 ``step3d``.

Tolerances: ``rtol=1e-5, atol=1e-6 * max|u0|``. The polynomial initial
grid reaches about 1e7 at these sizes, so an absolute tolerance has to
scale with it; measured at 32x24x40 after 50 steps, the textbook path
sits within 4.2e-7 * max|u0| of the references and the kernels'
factored combine (float32 constants, ``a0 = f32(0.4)``) within 1.4e-6
relative. ``steps_run`` and ``converged`` must be identical, and the
faces bit-exact; each eps is chosen away from the residuals, so no
few-ulp difference can move the stopping window.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import oracle  # noqa: E402

import parallel_heat_tpu as jx  # noqa: E402
from parallel_heat_tpu.models import HeatPlate3D as JaxPlate3D  # noqa: E402
from parallel_heat_tpu_torch import (HeatConfig, HeatPlate3D,  # noqa: E402
                                     cli, convert, explain, solve, tune)
from parallel_heat_tpu_torch.ops import stencil_kernels as sk  # noqa: E402

BACKENDS = ["torch", "cuda"]
FACES = (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
         np.s_[:, :, -1])


def _jax(**kw):
    return jx.solve(jx.HeatConfig(backend="jnp", **kw))


def _close(got, want, u0):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(u0).max()))


def _oracle(shape, steps, cx=0.1, cy=0.1, cz=0.1):
    u = HeatPlate3D(*shape).init_grid_np(np.float64)
    for _ in range(steps):
        u = oracle.step3d(u, cx, cy, cz)
    return u


def _oracle_converge(shape, steps, ci, eps):
    """The chunked convergence rule (as ``oracle.run_converge``), 3D."""
    u = HeatPlate3D(*shape).init_grid_np(np.float64)
    k, res = 0, np.inf
    for _ in range(steps // ci):
        for _ in range(ci):
            prev, u = u, oracle.step3d(u)
        k += ci
        res = np.max(np.abs(u - prev))
        if res < eps:
            return u, k, True, res
    return u, k, False, res


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape,steps,coeffs", [
    ((32, 24, 40), 50, (0.1, 0.1, 0.1)),
    ((20, 17, 23), 37, (0.1, 0.15, 0.05))])
def test_fixed_3d_matches_jax_and_oracle(backend, shape, steps, coeffs):
    kw = dict(nx=shape[0], ny=shape[1], nz=shape[2], steps=steps,
              cx=coeffs[0], cy=coeffs[1], cz=coeffs[2])
    res = solve(HeatConfig(backend=backend, **kw), device="cpu")
    ref = _jax(**kw)
    assert res.steps_run == ref.steps_run == steps
    assert res.converged is None and res.residual is None
    got = res.to_numpy()
    u0 = HeatPlate3D(*shape).init_grid_np()
    assert got.shape == shape
    _close(got, np.asarray(ref.grid), u0)
    _close(got, _oracle(shape, steps, *coeffs), u0)
    for sl in FACES:
        np.testing.assert_array_equal(got[sl], u0[sl])
    if coeffs[0] != coeffs[2]:
        # cx != cz: an update that swapped two axes cannot pass.
        swapped = _oracle(shape, steps, coeffs[2], coeffs[1], coeffs[0])
        assert not np.allclose(got, swapped, rtol=1e-5,
                               atol=1e-6 * np.abs(u0).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_converge_3d_matches_jax_and_oracle(backend):
    # 10^3 converges at step 360 with residual 5.7e-4; the window before
    # sits above 1e-3 by far more than any ulp difference.
    kw = dict(nx=10, ny=10, nz=10, steps=5000, converge=True,
              check_interval=20, eps=1e-3)
    res = solve(HeatConfig(backend=backend, **kw), device="cpu")
    ref = _jax(**kw)
    want_u, want_k, want_conv, want_res = _oracle_converge((10, 10, 10),
                                                           5000, 20, 1e-3)
    assert res.steps_run == ref.steps_run == want_k == 360
    assert res.converged is ref.converged is True and want_conv
    np.testing.assert_allclose(res.residual, float(ref.residual), rtol=1e-3)
    np.testing.assert_allclose(res.residual, want_res, rtol=1e-3)
    u0 = HeatPlate3D(10, 10, 10).init_grid_np()
    _close(res.to_numpy(), np.asarray(ref.grid), u0)
    _close(res.to_numpy(), want_u, u0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_converge_3d_tail_runs_when_not_converged(backend):
    # 113 = 5 windows of 20 + a 13-step tail; eps far below any residual.
    kw = dict(nx=12, ny=10, nz=14, steps=113, converge=True,
              check_interval=20, eps=1e-9)
    res = solve(HeatConfig(backend=backend, **kw), device="cpu")
    ref = _jax(**kw)
    assert res.steps_run == ref.steps_run == 113
    assert res.converged is ref.converged is False
    np.testing.assert_allclose(res.residual, float(ref.residual), rtol=1e-3)
    _close(res.to_numpy(), _oracle((12, 10, 14), 113),
           HeatPlate3D(12, 10, 14).init_grid_np())


@pytest.mark.parametrize("choice,plain", [("F", "xslab_steps_3d_plain"),
                                          ("D", "slab_step_3d_plain")])
def test_forced_pick_drives_solve_3d(choice, plain):
    # tune.force pins the single_3d site through the real solve(); F(K)
    # is K D steps, so both give bitwise the same grid.
    cfg = HeatConfig(nx=14, ny=11, nz=17, steps=23, backend="cuda")
    sk.reset_counts()
    with tune.force("single_3d", choice):
        res = solve(cfg, device="cpu")
    assert sk.counts[plain] > 0
    assert all(n == 0 for name, n in sk.counts.items() if name != plain)
    with tune.force("single_3d", "D"):
        base = solve(cfg, device="cpu")
    assert torch.equal(res.grid, base.grid)


@pytest.mark.parametrize("shape", [(64, 64, 64), (31, 17, 9), (512, 3, 5)])
def test_init_grid_3d_bitwise_equal_to_jax(shape):
    got = HeatPlate3D(*shape).init_grid("cpu").numpy()
    want = np.asarray(JaxPlate3D(*shape).init_grid())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(HeatPlate3D(*shape).init_grid_np(),
                                  JaxPlate3D(*shape).init_grid_np())


def test_explain_3d_reports_the_pick():
    cfg = HeatConfig(nx=512, ny=512, nz=512, steps=10)
    assert explain(cfg, device="cpu")["path"] == "textbook torch stencil"
    out = explain(cfg.replace(backend="cuda"), device="cpu")
    k = sk.params().f_k_default
    assert out["shape"] == (512, 512, 512)
    assert out["path"].startswith("kernel F (heat_f_temporal3d")
    assert f"K={k}" in out["path"]
    assert out["decided_by"]["single_3d"] == {"source": "default-order",
                                              "choice": "F"}
    with tune.force("single_3d", "D"):
        out = explain(cfg.replace(backend="cuda"), device="cpu")
    assert out["path"].startswith("kernel D (heat_d_step3d")
    assert out["decided_by"]["single_3d"] == {"source": "forced",
                                              "choice": "D"}


def test_config_3d_fields():
    cfg = HeatConfig(nx=8, ny=9, nz=10, cz=0.05)
    assert cfg.ndim == 3 and cfg.shape == (8, 9, 10)
    assert cfg.coefficients == (0.1, 0.1, 0.05)
    assert HeatConfig(nx=8, ny=9).ndim == 2
    with pytest.raises(ValueError, match="at least 3"):
        HeatConfig(nx=8, ny=9, nz=2).validate()
    with pytest.warns(RuntimeWarning, match="stability"):
        HeatConfig(nx=8, ny=9, nz=10, cx=0.2, cy=0.2, cz=0.2).validate()


def test_from_dict_and_from_jax_take_a_3d_spec():
    jcfg = jx.HeatConfig(nx=12, ny=10, nz=14, cz=0.05, steps=30,
                         backend="jnp")
    fields = dataclasses.asdict(jcfg)
    cfg = HeatConfig.from_dict({k: v for k, v in fields.items()
                                if k not in ("backend",)})
    assert (cfg.nx, cfg.ny, cfg.nz, cfg.cz) == (12, 10, 14, 0.05)
    assert HeatConfig.from_json(cfg.to_json()) == cfg
    half = jx.solve(jcfg)
    full = jx.solve(dataclasses.replace(jcfg, steps=60))
    conf, grid = convert.from_jax(fields, np.asarray(half.grid),
                                  device="cpu")
    assert conf.shape == (12, 10, 14) and conf.backend == "torch"
    np.testing.assert_array_equal(grid.numpy(), np.asarray(half.grid))
    res = solve(conf, initial=grid, device="cpu")
    _close(res.to_numpy(), np.asarray(full.grid),
           HeatPlate3D(12, 10, 14).init_grid_np())
    with pytest.raises(ValueError, match="does not match"):
        convert.from_jax(fields, np.zeros((12, 10), np.float32),
                         device="cpu")


def test_cli_3d_writes_npy_like_the_jax_cli(tmp_path, capsys):
    from parallel_heat_tpu import cli as jcli

    base = ["--nx", "12", "--ny", "10", "--nz", "14", "--steps", "30",
            "--cz", "0.05"]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    rc = cli.main(base + ["--device", "cpu", "--out", str(ours)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    jrc = jcli.main(base + ["--backend", "jnp", "--out", str(theirs)])
    jlines = capsys.readouterr().out.splitlines()
    assert jrc == 0
    assert "Grid size: 12x10x14  Time steps: 30" in lines
    assert f"Final grid written to {ours}.npy" in lines
    assert f"Final grid written to {theirs}.npy" in jlines
    got = np.load(f"{ours}.npy")
    want = solve(HeatConfig(nx=12, ny=10, nz=14, cz=0.05, steps=30),
                 device="cpu").to_numpy()
    np.testing.assert_array_equal(got, want)
    _close(got, np.load(f"{theirs}.npy"),
           HeatPlate3D(12, 10, 14).init_grid_np())
    # A 2D grid asked for as .npy is written as .npy too.
    path = tmp_path / "flat.npy"
    assert cli.main(["--nx", "9", "--ny", "8", "--steps", "5", "--device",
                     "cpu", "--out", str(path)]) == 0
    assert np.load(path).shape == (9, 8)


def test_cli_coefficients_reach_the_solver(tmp_path, capsys):
    path = tmp_path / "final.npy"
    rc = cli.main(["--nx", "24", "--ny", "20", "--steps", "40", "--cx",
                   "0.1", "--cy", "0.2", "--device", "cpu", "--out",
                   str(path)])
    assert rc == 0
    want = solve(HeatConfig(nx=24, ny=20, cx=0.1, cy=0.2, steps=40),
                 device="cpu").to_numpy()
    np.testing.assert_array_equal(np.load(path), want)
    other = solve(HeatConfig(nx=24, ny=20, steps=40), device="cpu")
    assert not np.array_equal(np.load(path), other.to_numpy())
