"""The device loop (``utils/device_loop.py``) on the CPU: the eager
executor, which runs the same guarded bodies as the card's graphs with
the host reading each guard.

On the card a converge run replays ``copies`` guarded check windows a
graph; here the eager executor runs the same copies, the state read once
a "replay". Whatever the copies, every run must be bitwise the per-window
host loop the port ran before (:func:`_host_loop`, kept here as the
reference): ``steps_run``, ``converged``, residual and grid. Against the
JAX package's ``solve`` the contract is the solver tests' own: the
kernels' factored combine drifts about 1e-5 relative in 300 steps
(``rtol=1e-4, atol=1e-3``), the implicit runs those of
``tests/test_torch_implicit.py``; ``steps_run`` and ``converged`` are
identical and Dirichlet cells bit-exact.
"""

import math

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu_torch import HeatConfig, solve
from parallel_heat_tpu_torch import solver as tsolver
from parallel_heat_tpu_torch.ops import multigrid as mg
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh
from parallel_heat_tpu_torch.utils import device_loop as dl

TOL = dict(rtol=1e-4, atol=1e-3)
# 1 and 3 copies (3 grows to 4 where a window flips the buffers), the
# default, and more than any run here has windows.
COPIES = [1, 3, 16, 1000]


def _host_loop(ms, msr, config, u, v):
    """The converge loop as the port ran it before the device loop: one
    host read a window, under the JAX rule."""
    ci = config.check_interval
    eps = float(np.float32(config.eps))
    full_steps = config.steps // ci * ci
    rem = config.steps % ci
    k, res = 0, math.inf
    while res >= eps and k < full_steps:
        u, v, r = msr(u, v, ci)
        res = float(r)
        k += ci
    converged = res < eps
    if rem > 0 and not converged:
        u, v = ms(u, v, rem)
        k += rem
    return u, k, converged, res


def _reference(config):
    """``(grid, steps_run, converged, residual)`` of the host loop on the
    run's own multistep family and initial state."""
    config = config.validate().replace(device="cpu")
    backend = tsolver.resolve_backend(config, torch.device("cpu"))
    if config.is_sharded():
        config = tsolver._resolved(config, backend)
        mesh = HeatMesh(config.mesh_shape, torch.device("cpu"))
        ms, msr = tsolver.sharded_multistep(config, mesh, backend)
        u = tsolver._prepare_blocks(config, mesh, None)
        v = [torch.empty_like(b) for b in u]
        grid, k, conv, res = _host_loop(ms, msr, config, u, v)
        return mesh.assemble(grid), k, conv, res
    ms, msr = tsolver.single_multistep(config, backend)
    u = tsolver._prepare_initial(config, None, torch.device("cpu"))
    return _host_loop(ms, msr, config, u, torch.empty_like(u))


def _solve(cfg, copies, monkeypatch):
    monkeypatch.setattr(dl, "WINDOW_COPIES", copies)
    return solve(cfg, device="cpu")


def _same_as_host_loop(res, cfg):
    grid, k, conv, r = _reference(cfg)
    assert (res.steps_run, res.converged) == (k, conv)
    assert res.residual == r or (math.isnan(res.residual)
                                 and math.isnan(r))
    assert _bitwise(res.grid, grid)


def _bitwise(a, b):
    """Equal bit for bit (NaN cells included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ring_exact(got, want):
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got[sl], want[sl])


# (config, steps_run, converged): a stop mid-replay, a stop at the last
# window (1980 = 99 windows, the residual falls below eps at the 99th),
# a run that never converges, a tail (1990 = 99 windows + 10 steps)
# after a run that does not converge, a tail skipped because the run
# converged, and fewer steps than a window (the tail alone).
CASES = {
    "stop_mid_replay": (dict(nx=20, ny=20, steps=10000), 1980, True),
    "stop_at_last_window": (dict(nx=20, ny=20, steps=1980), 1980, True),
    "never_converges": (dict(nx=20, ny=20, steps=400), 400, False),
    "tail_runs": (dict(nx=20, ny=20, steps=1990, eps=1e-6), 1990, False),
    "tail_skipped": (dict(nx=20, ny=20, steps=1990), 1980, True),
    "fewer_steps_than_a_window": (dict(nx=20, ny=20, steps=13), 13, False),
    "zero_steps": (dict(nx=20, ny=20, steps=0), 0, False),
}


@pytest.mark.parametrize("copies", COPIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_converge_eager_executor_is_the_host_loop(case, copies, monkeypatch):
    kw, steps_run, converged = CASES[case]
    kw = dict(dict(converge=True, check_interval=20, eps=1e-3), **kw)
    res = _solve(HeatConfig(backend="cuda", **kw), copies, monkeypatch)
    assert (res.steps_run, res.converged) == (steps_run, converged)
    _same_as_host_loop(res, HeatConfig(backend="cuda", **kw))
    ref = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    assert res.steps_run == ref.steps_run
    assert res.converged == bool(ref.converged)
    np.testing.assert_allclose(res.to_numpy(), np.asarray(ref.grid), **TOL)
    _ring_exact(res.to_numpy(), np.asarray(ref.grid))


@pytest.mark.parametrize("copies", COPIES)
@pytest.mark.parametrize("kernel", ["A", "E", "B"])
def test_every_window_parity_is_the_host_loop(kernel, copies, monkeypatch):
    # A (one launch a window) and E (8 + 8 + 4 steps: three launches)
    # leave the state in the spare buffer after a window, B (20 launches)
    # in the first: the order table either way.
    from parallel_heat_tpu_torch import tune

    kw = dict(nx=20, ny=20, steps=10000, converge=True, check_interval=20,
              eps=1e-3, backend="cuda")
    with tune.force("single_2d", kernel):
        res = _solve(HeatConfig(**kw), copies, monkeypatch)
        _same_as_host_loop(res, HeatConfig(**kw))
    assert res.steps_run == 1980


@pytest.mark.parametrize("copies", COPIES)
def test_divergence_stops_at_the_nan_window(copies, monkeypatch):
    # 16^2 past the stability bound: the residual is NaN at step 140.
    kw = dict(nx=16, ny=16, cx=0.4, cy=0.4, steps=200, converge=True,
              check_interval=20, eps=1e-3)
    with pytest.warns(RuntimeWarning):
        res = _solve(HeatConfig(backend="cuda", **kw), copies, monkeypatch)
    assert res.steps_run == 140 and res.converged is False
    assert math.isnan(res.residual)
    _same_as_host_loop(res, HeatConfig(backend="cuda", **kw))
    with pytest.warns(RuntimeWarning):
        ref = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    assert ref.steps_run == 140 and math.isnan(float(ref.residual))
    _ring_exact(res.to_numpy(), np.asarray(ref.grid))


@pytest.mark.parametrize("copies", [1, 3, 16])
@pytest.mark.parametrize("mesh,kw", [
    ((2, 2), dict(nx=20, ny=20, steps=10000, eps=1e-3)),
    ((2, 2, 2), dict(nx=10, ny=10, nz=10, steps=2000, eps=1e-3)),
], ids=["2d", "3d"])
def test_sharded_converge_is_the_host_loop(mesh, kw, copies, monkeypatch):
    kw = dict(kw, converge=True, check_interval=20, mesh_shape=mesh,
              backend="cuda")
    res = _solve(HeatConfig(**kw), copies, monkeypatch)
    assert res.converged is True
    _same_as_host_loop(res, HeatConfig(**kw))
    one = solve(HeatConfig(**dict(kw, mesh_shape=None)), device="cpu")
    assert (res.steps_run, res.converged) == (one.steps_run, one.converged)
    assert _bitwise(res.grid, one.grid)


def test_ten_cubed_on_a_mesh_converges_at_360(monkeypatch):
    kw = dict(nx=10, ny=10, nz=10, steps=2000, converge=True,
              check_interval=20, eps=1e-3, backend="cuda")
    res = _solve(HeatConfig(mesh_shape=(2, 2, 2), **kw), 3, monkeypatch)
    ref = jx.solve(jx.HeatConfig(**dict(kw, backend="jnp")))
    assert res.steps_run == ref.steps_run == 360
    np.testing.assert_allclose(res.to_numpy(), np.asarray(ref.grid), **TOL)


SCHEMES = ["backward_euler", "crank_nicolson"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_implicit_fixed_counts_cycles_and_host_tests(scheme):
    # mg_cycles = 3 with an unreachable tolerance: every step runs the
    # loop to its bound, and the host tests the flag 3 + 1 times.
    kw = dict(nx=34, ny=34, steps=5, scheme=scheme, mg_tol=1e-30,
              mg_cycles=3, mg_levels=4, cx=22.5, cy=22.5)
    mg.reset_stats()
    sk.reset_counts()
    res = solve(HeatConfig(backend="cuda", **kw), device="cpu")
    assert mg.stats == {"steps": 5, "cycles": 15, "host_syncs": 20}
    assert sk.counts["restrict_full_weighting"] == 15 * 3
    ref = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    scale = float(np.abs(np.asarray(ref.grid)).max())
    np.testing.assert_allclose(res.to_numpy(), np.asarray(ref.grid),
                               rtol=2e-5, atol=2e-5 * scale)


@pytest.mark.parametrize("copies", [1, 3, 16])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_implicit_converge_is_the_host_loop(scheme, copies, monkeypatch):
    # The update's max-norm falls through eps = 50 between the windows
    # that end at steps 15 and 20 (tests/test_torch_implicit.py).
    kw = dict(nx=34, ny=34, steps=60, converge=True, eps=50.0,
              check_interval=5, scheme=scheme, cx=22.5, cy=22.5)
    mg.reset_stats()
    res = _solve(HeatConfig(**kw), copies, monkeypatch)
    stats = dict(mg.stats)
    assert res.steps_run == 20 and res.converged is True
    assert stats["steps"] == 20
    assert stats["host_syncs"] == stats["cycles"] + 20
    mg.reset_stats()
    _same_as_host_loop(res, HeatConfig(**kw))
    assert mg.stats == stats
    ref = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    assert ref.steps_run == 20
    want = np.asarray(ref.grid)
    np.testing.assert_allclose(res.to_numpy(), want, rtol=2e-5,
                               atol=1e-3 * float(np.abs(want).max()))
    _ring_exact(res.to_numpy(), want)


# ---------------------------------------------------------------------------
# The loop pieces
# ---------------------------------------------------------------------------

def _toy(launches):
    """A multistep whose window is ``launches`` ping-pongs of ``+1``, its
    residual 100 / (value + 1), and the buffers each window left."""
    seen = []

    def msr(u, v, n):
        for _ in range(launches):
            v.copy_(u + 1)
            u, v = v, u
        seen.append((u, v))
        return u, v, (100.0 / (u + 1)).reshape(())

    return msr, seen


@pytest.mark.parametrize("copies", [1, 2, 3, 5])
@pytest.mark.parametrize("launches", [1, 2, 3])
def test_parity_table(launches, copies, monkeypatch):
    # Window i starts on the buffers i windows leave: for an odd number
    # of launches a window, the order flips every window and a graph's
    # copies are made even so that it chains from replay to replay.
    msr, seen = _toy(launches)
    monkeypatch.setattr(dl, "WINDOW_COPIES", copies)
    loop = dl.WindowLoop(msr, ci=1, eps=1.0, full_steps=1000)
    u, v = torch.zeros(1), torch.zeros(1)
    loop.prepare(u, v)
    a, b, k, res = loop.run(u, v)
    # 100 / (x + 1) < 1 once x = 100: after 100 / launches windows.
    windows = -(-100 // launches)
    assert k == windows and res < 1.0
    assert float(a) == windows * launches
    flip = launches % 2 == 1
    assert loop.flip is flip
    assert loop.copies == copies + (flip and copies % 2)
    for i, (x, y) in enumerate(seen):
        odd = flip and i % 2 == 0
        assert (x, y) == ((v, u) if odd else (u, v))
    assert (a, b) == seen[-1]


def test_repeat_tests_the_flag_once_past_the_last_body():
    n = torch.zeros((), dtype=torch.int64)
    flag = torch.ones((), dtype=torch.bool)
    tests = []

    def body():
        n.add_(1)
        torch.lt(n, 4, out=flag)

    dl.repeat(flag, body, 4, dl.Site("toy"), on_test=lambda: tests.append(1))
    assert int(n) == 4 and len(tests) == 5
    flag.fill_(True)
    with pytest.raises(RuntimeError, match="still holds after 3"):
        dl.repeat(flag, lambda: None, 3, dl.Site("stuck"))


def test_guard_skips_where_the_flag_is_clear():
    ran = []
    dl.guard(torch.tensor(False), lambda: ran.append(0), dl.Site("off"))
    dl.guard(torch.tensor(True), lambda: ran.append(1), dl.Site("on"))
    assert ran == [1]


def test_loops_run_plain_off_the_card():
    # The CPU makes no graph: no capture, nothing launched.
    dl.reset_stats()
    res = solve(HeatConfig(nx=64, ny=64, steps=50, mesh_shape=(2, 2)),
                device="cpu")
    assert res.capture_s == 0.0
    assert dl.stats["graphs"] == dl.stats["launches"] == 0
    assert tsolver._period(HeatConfig(nx=8, ny=8), torch.device("cpu")) is None


@pytest.mark.parametrize("cfg,period", [
    (dict(nx=64, ny=64), None),
    (dict(nx=64, ny=64, scheme="backward_euler"), 2),
    (dict(nx=64, ny=64, mesh_shape=(2, 2), halo_depth=8), 16),
])
def test_period_on_the_card(cfg, period):
    assert tsolver._period(HeatConfig(**cfg),
                           torch.device("cuda", 0)) == period


def test_site_holds_every_capture_to_the_first():
    site = dl.Site("s")
    site.record(((("heat_b_step", 1),),))
    site.record(((("heat_b_step", 1),),))
    with pytest.raises(RuntimeError, match="earlier one"):
        site.record(((("heat_b_step", 2),),))
