"""The PyTorch port's telemetry, profiling and measurement helpers against
the JAX package's.

The same runs go through both packages on the CPU (the port under backend
``torch``, JAX under ``jnp``) with a sink each; the event streams must
carry the same event names in the same order with the same keys, apart
from JAX's ``profile`` events (its work model, not ported: ROADMAP queue
1 item 11) and, in ``run_header``, JAX's ``jax_version`` against the
port's ``torch_version`` and ``device_kind`` (the card's name).
``tools/metrics_report.py`` must summarize both files alike: chunks,
steps, guard verdicts and diagnostics samples equal.

Tolerances: counts and keys exact; the timers' arithmetic under an
injected clock exact (it is the same arithmetic); the ensemble observers'
``min``/``max``/verdicts exact on the same stack, the update norms within
1e-6 relative of JAX's and of the float64 value, ``heat`` within 1e-6 of
the sum of the magnitudes (a random member's sum cancels) of both.
"""

import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu.ensemble import engine as jens
from parallel_heat_tpu.utils import measure as jmeasure
from parallel_heat_tpu.utils import profiling as jprof
from parallel_heat_tpu.utils.telemetry import Telemetry as JTelemetry
from parallel_heat_tpu_torch import EnsembleSolver, HeatConfig
from parallel_heat_tpu_torch import solver as tsolver
from parallel_heat_tpu_torch.ensemble import engine as tens
from parallel_heat_tpu_torch.utils import measure as tmeasure
from parallel_heat_tpu_torch.utils import profiling as tprof
from parallel_heat_tpu_torch.utils import telemetry as ttel
from parallel_heat_tpu_torch.utils import tracing as ttrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER_ONLY = {"jax_version", "torch_version", "device_kind"}


def _report():
    spec = importlib.util.spec_from_file_location(
        "metrics_report", os.path.join(ROOT, "tools", "metrics_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _shape(events):
    """(name, keys) per event, JAX's profile events left out."""
    return [(e["event"], frozenset(e) - HEADER_ONLY) for e in events
            if e["event"] != "profile"]


def _stream_both(tmp_path, kw, **stream):
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ttel.Telemetry(mine) as sink:
            for _ in tsolver.solve_stream(HeatConfig(device="cpu", **kw),
                                          telemetry=sink, **stream):
                pass
            sink.run_end(outcome="complete")
        with JTelemetry(theirs) as sink:
            for _ in jx.solve_stream(jx.HeatConfig(backend="jnp", **kw),
                                     telemetry=sink, **stream):
                pass
            sink.run_end(outcome="complete")
    return _events(mine), _events(theirs)


RUNS = {
    "2d fixed": (dict(nx=32, ny=40, steps=50, guard_interval=20,
                      diag_interval=20), dict(chunk_steps=10)),
    "2d fixed depth 2": (dict(nx=32, ny=40, steps=50, guard_interval=20,
                              diag_interval=20),
                         dict(chunk_steps=10, pipeline_depth=2)),
    "2d converge": (dict(nx=20, ny=20, steps=10_000, converge=True,
                         check_interval=20, eps=1e-3, guard_interval=500,
                         diag_interval=500), dict(chunk_steps=500)),
    "implicit": (dict(nx=32, ny=32, steps=6, cx=22.5, cy=22.5,
                      scheme="backward_euler", diag_interval=2),
                 dict(chunk_steps=2)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_stream_events_match_jax(tmp_path, name):
    kw, stream = RUNS[name]
    mine, theirs = _stream_both(tmp_path, kw, **stream)
    assert _shape(mine) == _shape(theirs)
    header = mine[0]
    assert header["event"] == "run_header" and header["platform"] == "cpu"
    assert header["torch_version"] == torch.__version__
    assert header["schema_version"] == ttel.SCHEMA_VERSION == 2
    assert header["explain"]["path"]
    if kw.get("scheme"):
        vc = [e for e in mine if e["event"] == "vcycle"]
        assert "level_wall_share" in vc[0] and len(vc) == 3
    # The repo's jax-free reader sees the same run in both files.
    rep = _report()
    a = rep.summarize(rep.load_events(str(tmp_path / "port.jsonl"))[0])
    b = rep.summarize(rep.load_events(str(tmp_path / "jax.jsonl"))[0])
    for key in ("count", "steps_total", "guard_checked", "guard_bad"):
        assert a["chunks"][key] == b["chunks"][key], key
    assert (a.get("convergence", {}).get("diag_samples")
            == b.get("convergence", {}).get("diag_samples"))
    assert a["header"]["platform"] == "cpu"


def _ensemble_inits(n, scales):
    base = np.asarray(jx.make_initial_grid(jx.HeatConfig(nx=n, ny=n)))
    return np.stack([base * s for s in scales]).astype(np.float32)


@pytest.mark.parametrize("converge", [False, True])
def test_ensemble_events_match_jax(tmp_path, converge):
    kw = dict(nx=20, ny=20, steps=400, guard_interval=50, diag_interval=50)
    if converge:
        kw.update(steps=10_000, converge=True, check_interval=20, eps=1e-3)
    inits = _ensemble_inits(20, (1.0, 0.5, 0.01, 2.0, 1e-4, 3.0))
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    with ttel.Telemetry(mine) as sink:
        got = EnsembleSolver(HeatConfig(device="cpu", **kw), 6).solve(
            initials=inits, telemetry=sink)
    with JTelemetry(theirs) as sink:
        want = jx.EnsembleSolver(jx.HeatConfig(backend="jnp", **kw),
                                 6).solve(initials=inits, telemetry=sink)
    a, b = _events(mine), _events(theirs)
    assert _shape(a) == _shape(b)
    names = [e["event"] for e in a]
    assert names.count("member_end") == 6
    assert names.count("diagnostics") == 6
    if converge:
        assert "member_converged" in names and "ensemble_compaction" in names
    assert np.array_equal(got.steps_run, np.asarray(want.steps_run))
    assert got.finite.tolist() == np.asarray(want.finite).tolist()
    assert [e["member"] for e in a if e["event"] == "member_end"] == list(
        range(6))
    assert a[0]["ensemble"]["members"] == 6


def test_ensemble_observers_match_jax():
    # 8 members of 32^2, one of them diverging.
    rng = np.random.default_rng(7)
    grids = (rng.standard_normal((8, 32, 32)) * 100).astype(np.float32)
    grids[5, 3, 4] = np.nan
    grids[6, 7, 8] = np.inf
    prev = grids + rng.standard_normal(grids.shape).astype(np.float32)
    mine_f = tens.ensemble_all_finite(torch.from_numpy(grids))
    want_f = jens.ensemble_all_finite(grids)
    assert mine_f.tolist() == np.asarray(want_f).tolist()
    assert mine_f.tolist() == [True] * 5 + [False, False, True]
    for p in (None, prev):
        mine = tens.ensemble_grid_stats(
            torch.from_numpy(grids),
            None if p is None else torch.from_numpy(p))
        want = jens.ensemble_grid_stats(grids, p)
        assert len(mine) == len(want) == 8
        for i, (m, w) in enumerate(zip(mine, want)):
            assert set(m) == set(w)
            for key in ("min", "max"):
                assert m[key] == w[key] or (np.isnan(m[key])
                                            and np.isnan(w[key]))
            if i in (5, 6):
                assert not np.isfinite(m["heat"])
                continue
            g = grids[i].astype(np.float64)
            # A sum's error scales with the sum of the magnitudes.
            scale = np.abs(g).sum()
            assert abs(m["heat"] - g.sum()) <= 1e-6 * scale
            assert abs(m["heat"] - w["heat"]) <= 1e-6 * scale
            if p is not None:
                d = g - p[i].astype(np.float64)
                for key, val in (("update_l2", np.sqrt((d * d).sum())),
                                 ("update_linf", np.abs(d).max())):
                    assert m[key] == pytest.approx(val, rel=1e-6)
                    assert m[key] == pytest.approx(w[key], rel=1e-6)
            if p is None:
                assert m["update_l2"] is None and w["update_l2"] is None


def test_async_writer_keeps_order_and_drains_on_close(tmp_path):
    p = tmp_path / "a.jsonl"
    with ttel.Telemetry(p, async_io=True) as tel:
        for i in range(50):
            tel.emit("chunk", step=i)
        tel.run_end(outcome="complete")
    ev = _events(p)
    assert [e["step"] for e in ev if e["event"] == "chunk"] == list(range(50))
    assert ev[-1]["event"] == "run_end"
    # The same sink, synchronous, writes the same lines but the clocks.
    q = tmp_path / "s.jsonl"
    with ttel.Telemetry(q) as tel:
        for i in range(50):
            tel.emit("chunk", step=i)
        tel.run_end(outcome="complete")
    strip = ("t_wall", "t_mono")
    assert ([{k: v for k, v in e.items() if k not in strip} for e in ev]
            == [{k: v for k, v in e.items() if k not in strip}
                for e in _events(q)])


def test_async_writer_failure_warns_once_and_goes_quiet(tmp_path):
    tel = ttel.Telemetry(tmp_path / "a.jsonl", async_io=True)
    tel._f.close()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for i in range(5):
            tel.emit("chunk", step=i)
        tel.close()
    assert sum("telemetry sink" in str(x.message) for x in w) == 1
    tel.emit("chunk", step=99)


def test_heartbeat_throttles(tmp_path):
    hb = tmp_path / "hb.json"
    with ttel.Telemetry(tmp_path / "m.jsonl", heartbeat=hb,
                        heartbeat_interval_s=3600.0) as tel:
        tel.emit("chunk", step=1)
        assert json.load(open(hb))["events"] == 1
        tel.emit("chunk", step=2)
        tel.emit("chunk", step=3)
        assert json.load(open(hb))["events"] == 1
        tel.emit("run_end", outcome="complete")
        forced = json.load(open(hb))
        assert forced["events"] == 4 and forced["last_event"] == "run_end"
        tel.emit("chunk", step=4)
    final = json.load(open(hb))
    assert final["events"] == 5 and final["last_step"] == 4


def test_shard_path_and_process_info():
    for args in (("runs/m.jsonl", 3, 4), ("runs/m.jsonl", 0, 1),
                 ("hb", 1, 2)):
        assert ttel.shard_path(*args) == jx.utils.telemetry.shard_path(*args)
    assert ttel._process_info() == (0, 1)


def test_trace_context_matches_jax(monkeypatch):
    from parallel_heat_tpu.utils import tracing as jtrace

    ctx = ttrace.TraceContext("t1", "s1").child("s2")
    jctx = jtrace.TraceContext("t1", "s1").child("s2")
    assert ctx.to_dict() == jctx.to_dict()
    assert ctx.to_env() == jctx.to_env()
    assert ttrace.TraceContext.from_dict({"trace_id": 1}) is None
    for k, v in ctx.to_env().items():
        monkeypatch.setenv(k, v)
    assert ttrace.TraceContext.from_env() == ctx
    tel = ttel.Telemetry(None)
    assert tel.trace == ctx
    tel.close()
    tid = ttrace.new_trace_id(clock=lambda: 1.5)
    assert tid.startswith("t0000000001500-")


class _Clock:
    """A clock that advances by the given steps, one a read."""

    def __init__(self, steps):
        self.steps, self.t = list(steps), 0.0

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 1.0
        return self.t


@pytest.mark.parametrize("steps", [[1.0, 2.0, 3.0, 5.0, 8.0, 13.0],
                                   [0.5] * 20, [2.0, 1.0] * 10])
def test_measure_timers_under_an_injected_clock(steps):
    u = torch.zeros(4, 4)
    for fn, args in ((tmeasure.timed_call, ()),
                     (tmeasure.min_of_n, (3,))):
        jfn = getattr(jmeasure, fn.__name__)
        mine = fn(lambda: u, *args, flush=None, clock=_Clock(steps))[0]
        theirs = jfn(lambda: u, *args, flush=None, clock=_Clock(steps))[0]
        assert mine == theirs
        # A flush runs on each result inside the bracket, once a call.
        flushed, jflushed = [], []
        mine = fn(lambda: u, *args, flush=flushed.append,
                  clock=_Clock(steps))
        theirs = jfn(lambda: u, *args, flush=jflushed.append,
                     clock=_Clock(steps))
        assert mine[0] == theirs[0] and mine[1] is u
        assert len(flushed) == len(jflushed) == (args[0] if args else 1)
    tmeasure.sync(u)   # a CPU tensor: nothing to wait for
    fns = {"a": lambda: u, "b": lambda: u}
    assert (tmeasure.interleaved_min_of_n(fns, 3, flush=None,
                                          clock=_Clock(steps))
            == jmeasure.interleaved_min_of_n(fns, 3, flush=None,
                                             clock=_Clock(steps)))
    walls = iter(steps * 3)
    named = {"a": lambda: next(walls), "b": lambda: next(walls)}
    walls_j = iter(steps * 3)
    named_j = {"a": lambda: next(walls_j), "b": lambda: next(walls_j)}
    assert (tmeasure.interleaved_min_self_timed(named, 3)
            == jmeasure.interleaved_min_self_timed(named_j, 3))
    assert tmeasure.sync_floor(u, 3, clock=_Clock(steps)) == (
        jmeasure.sync_floor(np.zeros((4, 4), np.float32), 3,
                            clock=_Clock(steps)))


def test_chain_slope_under_an_injected_clock():
    u = torch.zeros(8)
    # Two clock reads a chain_time: endpoints of 1 and 5 reps, taking
    # 2.0 and 6.0 s: a slope of 1.0 s a call.
    clock = _Clock([0.0, 2.0, 0.0, 6.0])
    assert tmeasure.chain_slope(lambda g: g + 1, u, 1, 5,
                                clock=clock) == 1.0
    with pytest.raises(RuntimeError, match="non-positive"):
        tmeasure.chain_slope(lambda g: g, u, 1, 5,
                             clock=_Clock([0.0, 5.0, 0.0, 1.0]))
    # The caller's tensor is never written.
    assert torch.equal(u, torch.zeros(8))


def test_step_stats_and_timeline_match_jax():
    for kw in (dict(nx=64, ny=48), dict(nx=8, ny=8, nz=8)):
        cfg, jcfg = HeatConfig(device="cpu", **kw), jx.HeatConfig(**kw)
        assert tprof.cell_count(cfg) == jprof.cell_count(jcfg)
        assert tprof.bytes_per_cell(cfg) == jprof.bytes_per_cell(jcfg) == 8
        res = tsolver.solve(cfg.replace(steps=7))
        mine = tprof.step_stats(res, cfg)
        theirs = jprof.StepStats(cells=mine.cells, steps=mine.steps,
                                 elapsed_s=mine.elapsed_s,
                                 bytes_per_cell=mine.bytes_per_cell)
        assert mine.steps == 7
        assert mine.summary() == theirs.summary()
        assert mine.mcells_steps_per_s == theirs.mcells_steps_per_s
    for tl, jtl in ((tprof.Timeline(), jprof.Timeline()),):
        assert tl.summary() == jtl.summary() == "  (no phases marked)"
        tl.phases = jtl.phases = [("a", 1.0), ("b", 3.0)]
        assert tl.summary() == jtl.summary()
        tl.phases = jtl.phases = [("a", 0.0)]
        assert tl.summary() == jtl.summary()
        assert tl.mark("x", sync_on=torch.zeros(2)) >= 0.0


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "prof") as done:
        res = tsolver.solve(HeatConfig(nx=16, ny=16, steps=5, device="cpu"))
        done(res.grid)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "heat:solve" in names
