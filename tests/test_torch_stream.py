"""The PyTorch port's ``solve_stream``, runtime guard and grid diagnostics
against the JAX package and against the port's own ``solve``.

The port runs on the CPU under backend ``torch`` (held to JAX's jnp path)
and backend ``cuda`` (the kernels' plain versions, held to JAX
``backend="pallas"`` in interpret mode, as ROADMAP queue 3 prescribes for
long runs).

Tolerances:

- grids: ``rtol=1e-5, atol=1e-3`` for ``torch`` against jnp, ``rtol=1e-4,
  atol=1e-3`` for ``cuda`` against pallas (``tests/test_torch_solver.py``'s
  few-ulp contracts); ``steps_run``, ``converged``, the number of yields
  and the guard's verdicts identical; a converge residual within 1e-4
  relative (the grids' contract);
- the port against itself (a chunked stream against its own ``solve``,
  depth 1 against depth 2, observers on against off): bitwise grids and
  identical ``finite`` and ``diagnostics``;
- ``grid_stats``: ``min`` and ``max`` exact; ``heat`` and the update norms
  within 1e-6 relative of JAX's, plus JAX's own distance from the exact
  (float64) value of the same reduction: JAX's float32 sum of a 32 x 40
  grid was seen 2.8e-6 off the float64 sum, where the port's is within
  1.2e-7, so 1e-6 of JAX's alone would fail on JAX's error. A sum's
  1e-6 is taken of the sum of the magnitudes (a random grid's sum
  cancels).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu import solver as jsolver
from parallel_heat_tpu.ops import multigrid as jmg
from parallel_heat_tpu_torch import HeatConfig, explain, solve
from parallel_heat_tpu_torch import solver as tsolver

TOL = {"torch": dict(rtol=1e-5, atol=1e-3), "cuda": dict(rtol=1e-4, atol=1e-3)}
JAX_BACKEND = {"torch": "jnp", "cuda": "pallas"}
STAT_KEYS = ("min", "max", "heat", "update_l2", "update_linf")


def _rows(gen):
    """Each yield's fields, its grid copied before the generator
    advances (the depth-1 contract)."""
    out = []
    for r in gen:
        out.append({"steps_run": r.steps_run, "converged": r.converged,
                    "residual": r.residual, "finite": r.finite,
                    "diagnostics": r.diagnostics,
                    "grid": np.array(r.to_numpy(), copy=True)})
    return out


def _port(kw, **stream):
    return _rows(tsolver.solve_stream(HeatConfig(device="cpu", **kw),
                                      **stream))


def _jax(kw, backend, **stream):
    kw = {k: v for k, v in kw.items() if k != "backend"}
    return _rows(jsolver.solve_stream(
        jx.HeatConfig(backend=JAX_BACKEND[backend], **kw), **stream))


def _exact_stats(grid, prev):
    """The float64 values of the reductions, and each one's scale: a
    sum's error is relative to the sum of the magnitudes, which is
    larger than the sum where signs cancel."""
    g = np.asarray(grid, np.float64)
    out = {"heat": g.sum(), "scale": np.abs(g).sum()}
    if prev is not None:
        d = g - np.asarray(prev, np.float64)
        out["update_l2"] = np.sqrt((d * d).sum())
        out["update_linf"] = np.abs(d).max()
    return out


def _stats_close(mine, theirs, exact):
    assert mine["min"] == theirs["min"] and mine["max"] == theirs["max"]
    for key in ("heat", "update_l2", "update_linf"):
        if theirs[key] is None:
            assert mine[key] is None
            continue
        scale = exact["scale"] if key == "heat" else abs(exact[key])
        slack = 1e-6 * scale + abs(theirs[key] - exact[key])
        assert abs(mine[key] - theirs[key]) <= slack, (key, mine, theirs)


def _same_row(a, b):
    """Bitwise: the grids and every observation."""
    assert np.array_equal(a["grid"], b["grid"], equal_nan=True)
    for key in ("steps_run", "converged", "residual", "finite",
                "diagnostics"):
        assert a[key] == b[key], key


CONV = dict(converge=True, check_interval=20)
STREAM_CASES = [
    ("torch", dict(nx=32, ny=40, steps=50), 10),
    ("torch", dict(nx=32, ny=40, steps=50), 7),
    ("torch", dict(nx=32, ny=40, steps=300, eps=1e-2, **CONV), 30),
    ("torch", dict(nx=20, ny=20, steps=10_000, eps=1e-3, **CONV), 500),
    ("cuda", dict(nx=32, ny=32, steps=27), 10),
    ("cuda", dict(nx=20, ny=20, steps=10_000, eps=1e-3, **CONV), 500),
]


@pytest.mark.parametrize("backend,kw,chunk", STREAM_CASES)
def test_stream_matches_jax_stream(backend, kw, chunk):
    obs = dict(guard_interval=20, diag_interval=20)
    mine = _port(dict(kw, backend=backend, **obs), chunk_steps=chunk)
    theirs = _jax(dict(kw, **obs), backend, chunk_steps=chunk)
    assert len(mine) == len(theirs) >= 2
    prev = np.asarray(jx.make_initial_grid(jx.HeatConfig(
        nx=kw["nx"], ny=kw["ny"])))
    for a, b in zip(mine, theirs):
        assert (a["steps_run"], a["converged"], a["finite"]) == (
            b["steps_run"], b["converged"], b["finite"])
        if b["residual"] is not None:
            assert a["residual"] == pytest.approx(b["residual"], rel=1e-4)
        np.testing.assert_allclose(a["grid"], b["grid"], **TOL[backend])
        assert (a["diagnostics"] is None) == (b["diagnostics"] is None)
        if b["diagnostics"] is None:
            continue
        da, db = a["diagnostics"], b["diagnostics"]
        assert set(da) == set(db)
        assert (da["step"], da["steps_since"]) == (db["step"],
                                                   db["steps_since"])
        # The grids differ by the few-ulp contract, so do their stats;
        # the port's stats are its own grid's within 1e-6.
        np.testing.assert_allclose([da[k] for k in STAT_KEYS],
                                   [db[k] for k in STAT_KEYS],
                                   **TOL[backend])
        exact = _exact_stats(a["grid"], prev)
        for key in ("heat", "update_l2", "update_linf"):
            assert da[key] == pytest.approx(exact[key], rel=1e-6, abs=1e-6)
        assert (da["min"], da["max"]) == (a["grid"].min(), a["grid"].max())
        prev = a["grid"]
    if kw.get("converge"):
        # chunk_steps is rounded up to a multiple of check_interval.
        ci = kw["check_interval"]
        assert mine[0]["steps_run"] == -(-chunk // ci) * ci


BITWISE_CASES = {
    "2d fixed": (dict(nx=64, ny=48, steps=50), 7),
    "2d converge": (dict(nx=20, ny=20, steps=3000, eps=1e-3, **CONV), 100),
    "2d cuda": (dict(nx=40, ny=36, steps=40, backend="cuda"), 12),
    "3d": (dict(nx=12, ny=10, nz=14, steps=20, backend="cuda"), 6),
    "mesh (2, 2)": (dict(nx=32, ny=32, steps=27, mesh_shape=(2, 2),
                         backend="cuda"), 10),
    "mesh converge": (dict(nx=20, ny=20, steps=3000, eps=1e-3,
                           mesh_shape=(2, 2), backend="cuda", **CONV), 200),
    "backward euler": (dict(nx=32, ny=32, steps=6, cx=22.5, cy=22.5,
                            scheme="backward_euler", diag_interval=2), 2),
}


@pytest.mark.parametrize("name", sorted(BITWISE_CASES))
def test_chunked_stream_bitwise_solve(name):
    kw, chunk = BITWISE_CASES[name]
    rows = _port(kw, chunk_steps=chunk)
    one = solve(HeatConfig(device="cpu", **kw))
    assert (rows[-1]["steps_run"], rows[-1]["converged"],
            rows[-1]["residual"]) == (one.steps_run, one.converged,
                                      one.residual)
    assert np.array_equal(rows[-1]["grid"], one.to_numpy())
    # The whole run as one chunk is solve() too, chunk by chunk.
    whole = _port(kw)
    assert len(whole) == 1
    assert np.array_equal(whole[0]["grid"], one.to_numpy())
    if kw.get("scheme") == "backward_euler":
        # The vcycle sample rides the diagnostics: its cycles are the JAX
        # package's cycle_trace of the same boundary grid.
        jcfg = jx.HeatConfig(**{k: v for k, v in kw.items()
                                if k != "diag_interval"}, backend="jnp")
        for r in rows:
            vc = r["diagnostics"]["vcycle"]
            want = jmg.cycle_trace(jcfg, r["grid"])
            assert vc["cycles"] == want["cycles"]
            assert vc["levels"] == want["levels"]
            assert vc["converged"] == want["converged"]
        shares = rows[0]["diagnostics"]["vcycle"]["level_wall_share"]
        assert list(shares) == [f"l{i}" for i in range(len(shares))]
        assert sum(shares.values()) == pytest.approx(1.0, abs=1e-3)
        assert "level_wall_share" not in rows[1]["diagnostics"]["vcycle"]


DEPTH_CASES = {
    "2d": dict(nx=48, ny=40, steps=60),
    "mesh (2, 2)": dict(nx=32, ny=32, steps=60, mesh_shape=(2, 2),
                        backend="cuda"),
    "backward euler": dict(nx=32, ny=32, steps=8, cx=22.5, cy=22.5,
                           scheme="backward_euler"),
}


@pytest.mark.parametrize("name", sorted(DEPTH_CASES))
def test_depth_two_bitwise_depth_one(name):
    kw = dict(DEPTH_CASES[name], guard_interval=20, diag_interval=20)
    chunk = 10 if kw["steps"] > 10 else 2
    if kw["steps"] <= 10:
        kw.update(guard_interval=2, diag_interval=4)
    one = _port(kw, chunk_steps=chunk, pipeline_depth=1)
    # Depth 2: every result held before any is read, so each grid must
    # survive the generator's advancing (a protected copy).
    held = list(tsolver.solve_stream(HeatConfig(device="cpu", **kw),
                                     chunk_steps=chunk, pipeline_depth=2))
    two = [{"steps_run": r.steps_run, "converged": r.converged,
            "residual": r.residual, "finite": r.finite,
            "diagnostics": r.diagnostics, "grid": r.to_numpy()}
           for r in held]
    assert len(one) == len(two) == -(-kw["steps"] // chunk)
    assert any(r["finite"] is not None for r in one)
    assert any(r["diagnostics"] is not None for r in one)
    for a, b in zip(one, two):
        if a["diagnostics"] is not None:
            # The V-cycle sample is taken at depth 1 only (it would
            # wait for the card inside the dispatch).
            a["diagnostics"].pop("vcycle", None)
        _same_row(a, b)


def test_observers_toggled_bitwise():
    from parallel_heat_tpu_torch.utils.telemetry import Telemetry

    kw = dict(nx=40, ny=40, steps=45)
    plain = _port(kw, chunk_steps=10)
    sink = Telemetry(None)
    watched = _port(dict(kw, guard_interval=5, diag_interval=15,
                         pipeline_depth=1), chunk_steps=10, telemetry=sink)
    sink.close()
    assert [r["steps_run"] for r in plain] == [10, 20, 30, 40, 45]
    for a, b in zip(plain, watched):
        assert np.array_equal(a["grid"], b["grid"])
        assert a["finite"] is None and b["finite"] is True
    # The first boundary at-or-after each multiple of 15, and the last.
    assert [r["diagnostics"] is not None for r in watched] == [
        False, True, True, False, True]


def test_guard_trips_at_jaxs_chunk_and_warns():
    kw = dict(nx=16, ny=16, cx=0.4, cy=0.4, steps=200, guard_interval=20)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mine = _port(kw, chunk_steps=20)
    assert any("runtime guard" in str(x.message) for x in w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = _jax(kw, "torch", chunk_steps=20)
    verdicts = [r["finite"] for r in mine]
    assert verdicts == [r["finite"] for r in theirs]
    assert True in verdicts and False in verdicts
    first = verdicts.index(False)
    assert mine[first]["steps_run"] == theirs[first]["steps_run"]
    # The Dirichlet ring stays exact after the blow-up.
    u0 = tsolver.make_initial_grid(HeatConfig(nx=16, ny=16, device="cpu"))
    last = mine[-1]["grid"]
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert np.array_equal(last[sl], u0.numpy()[sl])


@pytest.mark.parametrize("shape,seed", [((32, 40), 0), ((64, 64), 1),
                                        ((256, 256), 2), ((17, 9, 12), 3)])
def test_grid_stats_against_jax(shape, seed):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(shape) * 1000.0).astype(np.float32)
    p = u + rng.standard_normal(shape).astype(np.float32)
    mine = tsolver.grid_stats(torch.from_numpy(u), prev=torch.from_numpy(p))
    theirs = jsolver.grid_stats(u, prev=p)
    _stats_close(mine, theirs, _exact_stats(u, p))
    solo = tsolver.grid_stats(torch.from_numpy(u))
    _stats_close(solo, jsolver.grid_stats(u), _exact_stats(u, None))
    assert tsolver.grid_all_finite(torch.from_numpy(u))
    for bad in (np.nan, np.inf, -np.inf):
        v = u.copy()
        v.flat[rng.integers(v.size)] = bad
        assert tsolver.grid_all_finite(torch.from_numpy(v)) is False
        assert jsolver.grid_all_finite(v) is False


def test_grid_stats_of_blocks_and_slabs_match_the_whole(monkeypatch):
    # A mesh's blocks reduce without assembly; slabs bound the update's
    # temporary. Both change only the order of float32 partial sums.
    rng = np.random.default_rng(4)
    u = torch.from_numpy((rng.standard_normal((64, 48)) * 100.0)
                         .astype(np.float32))
    p = u + torch.from_numpy(rng.standard_normal((64, 48))
                             .astype(np.float32))
    whole = tsolver.grid_stats(u, prev=p)
    monkeypatch.setattr(tsolver, "_SLAB_CELLS", 48 * 5)
    sliced = tsolver.grid_stats(u, prev=p)
    blocks = [u[:32], u[32:]]
    pieces = tsolver._stats_dict(tsolver._stats_dev(tsolver._pairs(
        blocks, p, [(0, 0), (32, 0)])).tolist())
    exact = _exact_stats(u.numpy(), p.numpy())
    for got in (sliced, pieces):
        assert (got["min"], got["max"]) == (whole["min"], whole["max"])
        assert got["update_linf"] == whole["update_linf"]
        assert abs(got["heat"] - exact["heat"]) <= 1e-6 * exact["scale"]
        assert got["update_l2"] == pytest.approx(exact["update_l2"],
                                                 rel=1e-6)


def test_refusals():
    cfg = HeatConfig(nx=16, ny=16, steps=10, device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth must be >= 1"):
        list(tsolver.solve_stream(cfg, pipeline_depth=0))
    with pytest.raises(ValueError, match="fixed-step only"):
        list(tsolver.solve_stream(cfg.replace(converge=True),
                                  pipeline_depth=2))
    with pytest.raises(ValueError, match="chunk_steps"):
        list(tsolver.solve_stream(cfg, chunk_steps=0))
    with pytest.raises(ValueError, match="fixed-step only"):
        HeatConfig(converge=True, pipeline_depth=2).validate()
    for field in ("guard_interval", "diag_interval", "pipeline_depth"):
        with pytest.raises(ValueError, match=field):
            HeatConfig(**{field: 0}).validate()
    assert list(tsolver.solve_stream(cfg.replace(steps=0))) == []


def test_resolved_pipeline_depth():
    fixed = HeatConfig(nx=16, ny=16, device="cpu")
    for cfg in (fixed, fixed.replace(converge=True),
                fixed.replace(device="cuda", converge=True)):
        assert (tsolver.resolved_pipeline_depth(cfg)
                == jsolver.resolved_pipeline_depth(jx.HeatConfig(
                    converge=cfg.converge)) == 1)
    assert tsolver.resolved_pipeline_depth(fixed.replace(device="cuda")) == 2
    assert tsolver.resolved_pipeline_depth(fixed, 3) == 3
    assert tsolver.resolved_pipeline_depth(fixed.replace(
        pipeline_depth=2)) == 2


def test_explain_reports_the_observers_as_jax_does():
    kw = dict(nx=32, ny=32, guard_interval=10, diag_interval=5,
              pipeline_depth=2)
    mine = explain(HeatConfig(device="cpu", **kw))
    theirs = jsolver.explain(jx.HeatConfig(**kw))
    for key in ("guard", "diagnostics", "pipeline"):
        assert mine[key] == theirs[key]
    plain = explain(HeatConfig(device="cpu", nx=32, ny=32))
    assert not {"guard", "diagnostics", "pipeline"} & set(plain)


def test_solve_checks_and_samples_the_end_state():
    kw = dict(nx=40, ny=36, steps=30, guard_interval=7, diag_interval=9)
    mine = solve(HeatConfig(device="cpu", **kw))
    theirs = jsolver.solve(jx.HeatConfig(backend="jnp", **kw))
    assert mine.finite is theirs.finite is True
    assert {k: mine.diagnostics[k] for k in ("step", "steps_since")} == {
        "step": 30, "steps_since": 30}
    u0 = jx.make_initial_grid(jx.HeatConfig(nx=40, ny=36))
    _stats_close(mine.diagnostics, theirs.diagnostics,
                 _exact_stats(np.asarray(theirs.grid), np.asarray(u0)))
    bare = solve(HeatConfig(device="cpu", **dict(kw, guard_interval=None,
                                                 diag_interval=None)))
    assert torch.equal(bare.grid, mine.grid)
    assert bare.finite is None and bare.diagnostics is None


class _FakeLoop:
    def __init__(self, steps, flips):
        self.steps, self._flips, self.prepared = steps, flips, None

    def prepare(self, u, v, warm=None):
        self.prepared = (u, v, warm)

    def flips(self):
        return self._flips


@pytest.mark.parametrize("total,chunk,flips,want", [
    (200, 40, True, [(40, 0), (40, 1)]),
    (200, 40, False, [(40, 0)]),
    (50, 20, True, [(20, 0), (20, 1), (10, 0)]),
    (70, 20, True, [(20, 0), (20, 1), (10, 1)]),
    (30, 20, True, [(20, 0), (10, 1)]),
    (10, 20, True, [(10, 0)]),
    (50, 20, None, [(20, 0), (10, 0)]),
])
def test_stream_captures_each_loop_it_meets_before_the_clock(
        total, chunk, flips, want):
    # On the card a loop is captured on its buffers: a chunk that leaves
    # the state in the spare hands the next chunk the other order.
    u, v = torch.zeros(3), torch.zeros(3)

    class Run:
        pass

    run = Run()
    run.u, run.v = u, v
    run.loop = lambda c: _FakeLoop(c, flips)
    loops, _ = tsolver._stream_loops(run, total, chunk)
    assert sorted(loops) == sorted(want)
    for (c, order), loop in loops.items():
        a, b, warm = loop.prepared
        assert (a, b) == ((u, v) if order == 0 else (v, u))
        # The warm-up writes only the run's spare.
        assert warm[0] is u and warm[1] is v


def test_observation_only_fields_are_the_jax_packages():
    from parallel_heat_tpu import config as jconfig
    from parallel_heat_tpu_torch import config as tconfig

    assert tconfig.OBSERVATION_ONLY_FIELDS == jconfig.OBSERVATION_ONLY_FIELDS
    cfg = HeatConfig(guard_interval=3, diag_interval=4, pipeline_depth=2)
    free = tsolver._observer_free(cfg)
    assert free == HeatConfig()
    names = {f.name for f in dataclasses.fields(HeatConfig)}
    assert set(tconfig.OBSERVATION_ONLY_FIELDS) <= names
