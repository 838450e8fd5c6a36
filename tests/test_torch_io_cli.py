"""The PyTorch port's I/O, CLI, config and state carry-over against the
JAX package.

Tolerances: ``.dat`` files are compared byte for byte (the two writers
format the same float32 values); grids that went through the port's
kernel plain versions are held to ``rtol=1e-4, atol=1e-3``, the JAX
package's own pallas-vs-jnp solve contract (``tests/test_pallas.py``),
and grids of the textbook ``torch`` backend to ``rtol=1e-5, atol=1e-3``
(``tests/test_solver.py``'s oracle contract). A grid read back from a
``.dat`` file is off by at most the ``%6.1f`` rounding, 0.05, plus one
float32 ulp of the value for parsing the decimal back.
"""

import dataclasses

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu.utils import io as jio
from parallel_heat_tpu_torch import HeatConfig, convert, solve
from parallel_heat_tpu_torch import cli
from parallel_heat_tpu_torch import config as tconfig
from parallel_heat_tpu_torch.utils import io as tio

KERNEL_TOL = dict(rtol=1e-4, atol=1e-3)


def _assert_dat_close(back, u, rounds=1):
    u = np.asarray(u, dtype=np.float32)
    tol = rounds * (0.05 + np.spacing(np.abs(u)))
    assert np.all(np.abs(back.astype(np.float64) - u) <= tol)


def _rand(shape, seed, scale=1000.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((7, 5), 0), ((33, 48), 1),
                                        ((1, 9), 2)])
def test_dat_bytes_identical_to_jax(tmp_path, shape, seed):
    u = _rand(shape, seed)
    u[0, 0] = -0.05  # a value on the rounding boundary of "%6.1f"
    ours, theirs = tmp_path / "ours.dat", tmp_path / "theirs.dat"
    tio.write_dat(ours, torch.from_numpy(u))
    jio.write_dat(theirs, u, use_native=False)
    assert ours.read_bytes() == theirs.read_bytes()
    back = tio.read_dat(ours)
    assert back.shape == shape and back.dtype == np.float32
    np.testing.assert_array_equal(back, jio.read_dat(theirs, use_native=False))
    _assert_dat_close(back, u)


def test_dat_of_a_solve_round_trips(tmp_path):
    res = solve(HeatConfig(nx=40, ny=30, steps=50, backend="cuda"),
                device="cpu")
    path = tmp_path / "final.dat"
    tio.write_dat(path, res.grid)
    back = tio.read_dat(path)
    _assert_dat_close(back, res.to_numpy())
    with pytest.raises(ValueError, match="2D-only"):
        tio.write_dat(path, np.zeros((2, 2, 2), np.float32))


def _cli_lines(capsys, argv):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


@pytest.mark.parametrize("extra", [[], ["--converge", "--eps", "1e-3",
                                        "--steps", "10000"]])
def test_cli_runs_on_the_cpu_like_the_jax_cli(tmp_path, capsys, extra):
    from parallel_heat_tpu import cli as jcli

    base = ["--nx", "20", "--ny", "20", "--steps", "300"] + extra
    ours, theirs = tmp_path / "ours.dat", tmp_path / "theirs.dat"
    rc, lines, err = _cli_lines(capsys, base + ["--device", "cpu",
                                                "--out", str(ours)])
    assert rc == 0, err
    jrc = jcli.main(base + ["--backend", "jnp", "--out", str(theirs)])
    jlines = capsys.readouterr().out.splitlines()
    assert jrc == 0
    assert lines[0] == ("Starting parallel_heat_tpu_torch on 1 device(s), "
                        "mesh (1, 1).")
    assert jlines[0].startswith("Starting parallel_heat_tpu on 1 device(s)")

    def drop_times(ls):
        return [ln for ln in ls[1:] if not ln.startswith("Elapsed time ")]

    # Grid line, converged-at line and the .dat line agree (the paths
    # differ by name only).
    assert ([ln.replace("ours", "X") for ln in drop_times(lines)]
            == [ln.replace("theirs", "X") for ln in drop_times(jlines)])
    assert any(ln.startswith("Elapsed time ") for ln in lines)
    _assert_dat_close(tio.read_dat(ours), tio.read_dat(theirs), rounds=2)


@pytest.mark.parametrize("flags", [["--initial-out"], ["--quiet"],
                                   ["--dtype", "float32"],
                                   ["--quiet", "--initial-out",
                                    "--converge"]])
def test_cli_flags_write_the_jax_clis_bytes(tmp_path, capsys, flags):
    from parallel_heat_tpu import cli as jcli

    base = ["--nx", "20", "--ny", "20", "--steps", "300"]
    extra = [f for f in flags if f != "--initial-out"]
    runs = {}
    for name, main, tail in (("ours", cli.main, ["--device", "cpu"]),
                             ("theirs", jcli.main, ["--backend", "jnp"])):
        argv = base + extra + tail + ["--out", str(tmp_path / f"{name}.dat")]
        if "--initial-out" in flags:
            argv += ["--initial-out", str(tmp_path / f"{name}_0.dat")]
        rc = main(argv)
        out = capsys.readouterr()
        assert rc == 0, out.err
        runs[name] = out.out.splitlines()
    for stem in ["", "_0"] if "--initial-out" in flags else [""]:
        ours = (tmp_path / f"ours{stem}.dat").read_bytes()
        assert ours == (tmp_path / f"theirs{stem}.dat").read_bytes()
    if "--quiet" in flags:
        assert runs["ours"] == runs["theirs"] == []
    elif "--initial-out" in flags:
        assert f"Initial grid written to {tmp_path / 'ours_0.dat'}" in \
            runs["ours"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_cli_refuses_other_dtypes(capsys, dtype):
    # What stays refused on a 3D mesh: bfloat16 (the CLI names the
    # ROADMAP.md item), and float64 under --backend cuda (it runs the
    # torch rounds).
    extra = ["--backend", "cuda"] if dtype == "float64" else []
    rc, lines, err = _cli_lines(capsys, ["--nx", "20", "--ny", "20",
                                         "--nz", "8", "--mesh", "2,2,2",
                                         "--device", "cpu",
                                         "--dtype", dtype] + extra)
    assert rc == 2 and lines == []
    assert ("ROADMAP.md queue 2 item 24.4" if dtype == "bfloat16"
            else "backend='cuda' does not take") in err


@pytest.mark.parametrize("flags", [
    ["--dtype", "bfloat16"],
    ["--dtype", "bfloat16", "--accumulate", "f32chunk"],
    ["--dtype", "bfloat16", "--accumulate", "f32chunk", "--converge",
     "--initial-out"],
    ["--dtype", "float64"]],
    ids=["bf16", "bf16-f32chunk", "bf16-f32chunk-converge", "float64"])
def test_cli_precision_flags_write_the_jax_clis_bytes(tmp_path, capsys,
                                                      flags):
    # The port's torch route and the JAX CLI's jnp path compute the same
    # textbook tree at the same rounding points, so the .dat files (the
    # float32 values of the grid, "%6.1f") are the same bytes. The JAX
    # CLI turns on JAX's x64 mode for float64 and leaves it on: it is
    # restored here.
    import jax

    from parallel_heat_tpu import cli as jcli

    base = ["--nx", "20", "--ny", "24", "--steps", "300"]
    extra = [f for f in flags if f != "--initial-out"]
    was = jax.config.jax_enable_x64
    try:
        for name, main, tail in (("ours", cli.main,
                                  ["--device", "cpu", "--backend", "torch"]),
                                 ("theirs", jcli.main, ["--backend", "jnp"])):
            argv = base + extra + tail + ["--out",
                                          str(tmp_path / f"{name}.dat")]
            if "--initial-out" in flags:
                argv += ["--initial-out", str(tmp_path / f"{name}_0.dat")]
            rc = main(argv)
            out = capsys.readouterr()
            assert rc == 0, out.err
    finally:
        jax.config.update("jax_enable_x64", was)
    for stem in ["", "_0"] if "--initial-out" in flags else [""]:
        ours = (tmp_path / f"ours{stem}.dat").read_bytes()
        assert ours == (tmp_path / f"theirs{stem}.dat").read_bytes()


def test_cli_bf16_f32chunk_pinned_to_i_uni_writes_e_unis_bytes(tmp_path,
                                                               capsys):
    # A pin to I-uni under --dtype bfloat16 --accumulate f32chunk runs
    # through the CLI on I-uni's carry form (its plain version here) and
    # writes the bytes of the run pinned to E-uni.
    from parallel_heat_tpu_torch import tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    argv = ["--nx", "24", "--ny", "32", "--steps", "70", "--device", "cpu",
            "--backend", "cuda", "--dtype", "bfloat16", "--accumulate",
            "f32chunk"]
    for pin, plain in (("E-uni", "temporal_steps_uni_plain"),
                       ("I-uni", "tile_temporal_steps_uni_plain")):
        with tune.force("single_2d", pin):
            sk.reset_counts()
            rc = cli.main(argv + ["--out", str(tmp_path / f"{pin}.dat")])
            assert {n for n, c in sk.counts.items() if c} == {plain}
        assert rc == 0, capsys.readouterr().err
    assert (tmp_path / "I-uni.dat").read_bytes() == (
        tmp_path / "E-uni.dat").read_bytes()


def test_cli_ensemble_refuses_initial_out(capsys, tmp_path):
    rc, _, err = _cli_lines(capsys, ["--nx", "20", "--ny", "20",
                                     "--device", "cpu", "--ensemble", "2",
                                     "--initial-out",
                                     str(tmp_path / "i.dat")])
    assert rc == 2 and "--initial-out" in err


@pytest.mark.parametrize("shape", [(20, 20), (33, 17), (6, 7, 9)])
def test_make_initial_grid_is_the_jax_packages(shape):
    from parallel_heat_tpu.solver import make_initial_grid as jmake

    from parallel_heat_tpu_torch import make_initial_grid

    dims = dict(zip(("nx", "ny", "nz"), shape))
    ours = make_initial_grid(HeatConfig(**dims), device="cpu")
    theirs = np.asarray(jmake(jx.HeatConfig(**dims)))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_cli_explain_and_errors(capsys):
    rc, lines, _ = _cli_lines(capsys, ["--nx", "64", "--ny", "64",
                                       "--backend", "cuda", "--device",
                                       "cpu", "--explain"])
    assert rc == 0
    assert "backend: cuda" in lines
    # A 64^2 grid fits resident in shared memory: kernel A.
    assert any(ln.startswith("path: kernel A") for ln in lines)
    rc, _, err = _cli_lines(capsys, ["--nx", "2", "--device", "cpu"])
    assert rc == 2 and "at least 3 cells" in err


def test_solve_without_a_card_raises_unless_cpu_is_asked(monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HeatConfig(nx=16, ny=16, steps=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(cfg.replace(device="cuda:0"))
    assert solve(cfg, device="cpu").steps_run == 3
    rc, lines, err = _cli_lines(capsys, ["--nx", "16", "--ny", "16",
                                         "--steps", "3"])
    assert rc == 1 and "no CUDA device" in err
    assert not any(ln.startswith("Elapsed") for ln in lines)


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_from_jax_reproduces_the_jax_final_grid(backend):
    jcfg = jx.HeatConfig(nx=48, ny=40, steps=120, backend=backend)
    ref = jx.solve(jcfg)
    cfg, grid = convert.from_jax(dataclasses.asdict(jcfg), None,
                                 device="cpu")
    assert grid is None
    assert (cfg.nx, cfg.ny, cfg.steps, cfg.cx, cfg.cy) == (48, 40, 120,
                                                          0.1, 0.1)
    res = solve(cfg, device="cpu")
    assert res.steps_run == ref.steps_run
    np.testing.assert_allclose(res.to_numpy(), np.asarray(ref.grid),
                               **KERNEL_TOL)


def test_from_jax_carries_a_grid_across():
    # 60 steps in JAX, the next 60 in the port == 120 steps in JAX.
    kw = dict(nx=36, ny=52, backend="jnp")
    half = jx.solve(jx.HeatConfig(steps=60, **kw))
    full = jx.solve(jx.HeatConfig(steps=120, **kw))
    fields = dataclasses.asdict(jx.HeatConfig(steps=60, **kw))
    cfg, grid = convert.from_jax(fields, np.asarray(half.grid), device="cpu")
    assert grid.dtype == torch.float32 and grid.device.type == "cpu"
    np.testing.assert_array_equal(grid.numpy(), np.asarray(half.grid))
    res = solve(cfg, initial=grid, device="cpu")
    np.testing.assert_allclose(res.to_numpy(), np.asarray(full.grid),
                               rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="does not match"):
        convert.from_jax(fields, np.zeros((3, 3), np.float32), device="cpu")


@pytest.mark.parametrize("field,value", [("mg_partition", "replicated"),
                                         ("accumulate", "f32")])
def test_from_jax_refuses_jax_only_features(field, value):
    # mg_partition is a JAX-only field; accumulate is this package's too,
    # and a value neither package takes is refused by its own check.
    fields = dataclasses.asdict(jx.HeatConfig(nx=16, ny=16))
    fields[field] = value
    match = (f"{field}=.*not implemented"
             if field in tconfig.JAX_ONLY_DEFAULTS
             else f"{field} must be 'storage' or 'f32chunk'")
    with pytest.raises(ValueError, match=match):
        convert.from_jax(fields, None, device="cpu")


@pytest.mark.parametrize("field,value", [("guard_interval", 5),
                                         ("pipeline_depth", 2),
                                         ("diag_interval", 7)])
def test_from_jax_carries_the_observers(field, value):
    fields = dataclasses.asdict(jx.HeatConfig(nx=16, ny=16))
    fields[field] = value
    cfg, grid = convert.from_jax(fields, None, device="cpu")
    assert getattr(cfg, field) == value and grid is None
    spec = {"nx": 16, "ny": 16, field: value}
    assert getattr(HeatConfig.from_dict(spec), field) == value


@pytest.mark.parametrize("dtype", ["bfloat16", "float64", "float16"])
def test_validate_rejects_other_dtypes(dtype):
    # float16 is no storage dtype of either package; bfloat16 is refused on
    # a 3D mesh, naming the ROADMAP.md item, and float64 on a mesh under
    # backend="cuda" (it runs the torch rounds).
    match = {"float16": "dtype must be one of",
             "bfloat16": "ROADMAP.md queue 2 item 24.4",
             "float64": "backend='cuda' does not take"}[dtype]
    with pytest.raises(ValueError, match=match):
        HeatConfig(dtype=dtype, nx=8, ny=8, nz=8, mesh_shape=(2, 2, 2),
                   backend="cuda" if dtype == "float64" else "auto"
                   ).validate()


@pytest.mark.parametrize("kw,match", [
    ({"nx": 2}, "at least 3"), ({"steps": -1}, "steps"),
    ({"converge": True, "check_interval": 0}, "check_interval"),
    ({"converge": True, "eps": 0.0}, "eps"),
    ({"backend": "pallas"}, "backend"), ({"device": "tpu"}, "device"),
    ({"device": "cuda:x"}, "device")])
def test_validate_rejects_bad_fields(kw, match):
    with pytest.raises(ValueError, match=match):
        HeatConfig(**kw).validate()


def test_validate_warns_past_the_stability_bound():
    with pytest.warns(RuntimeWarning, match="stability"):
        HeatConfig(cx=0.3, cy=0.3).validate()


def test_from_dict_and_json():
    cfg = HeatConfig(nx=30, ny=20, steps=7, converge=True, device="cpu")
    assert HeatConfig.from_json(cfg.to_json()) == cfg
    with pytest.raises(ValueError, match="unknown HeatConfig fields"):
        HeatConfig.from_dict({"nx": 8, "colour": "red"})
    # accumulate is this package's field, under the JAX package's rules:
    # f32chunk needs a sub-float32 dtype.
    with pytest.raises(ValueError, match="only applies to sub-f32"):
        HeatConfig.from_dict({"nx": 8, "accumulate": "f32chunk"})
    assert HeatConfig.from_dict({"nx": 8, "accumulate": "f32chunk",
                                 "dtype": "bfloat16"}).accumulate == "f32chunk"
    with pytest.raises(ValueError, match="mg_partition=.*not implemented"):
        HeatConfig.from_dict({"nx": 8, "mg_partition": "partitioned"})
    # JAX-only fields at their JAX defaults mean the same run: accepted.
    assert HeatConfig.from_dict({"nx": 8, "mg_partition": "auto",
                                 "scheme": "explicit"}).nx == 8
    # The mesh fields are this package's too; a JSON list becomes a tuple.
    assert HeatConfig.from_dict({"nx": 8, "ny": 8, "mesh_shape": [2, 4],
                                 "halo_depth": 2}).mesh_shape == (2, 4)


def test_every_field_is_classified_once():
    names = [f.name for f in dataclasses.fields(HeatConfig)]
    sem, obs = tconfig.SEMANTIC_FIELDS, tconfig.OBSERVATION_ONLY_FIELDS
    assert sorted(sem + obs) == sorted(names)
    assert not set(sem) & set(obs)
    # The shared names are the JAX package's, classified the same way.
    from parallel_heat_tpu import config as jconfig

    assert set(sem) - {"device"} <= set(jconfig.SEMANTIC_FIELDS)
    jax_fields = {f.name for f in dataclasses.fields(jx.HeatConfig)}
    assert set(names) - {"device"} <= jax_fields
    assert set(tconfig.JAX_ONLY_DEFAULTS) == jax_fields - set(names)
    defaults = {f.name: f.default for f in dataclasses.fields(jx.HeatConfig)}
    for name, value in tconfig.JAX_ONLY_DEFAULTS.items():
        assert defaults[name] == value, name
    # The observers are the JAX package's, classified the same way.
    assert obs == jconfig.OBSERVATION_ONLY_FIELDS


def test_cli_metrics_file_reads_in_metrics_report(tmp_path, capsys):
    import importlib.util
    import os

    path = tmp_path / "runs" / "m.jsonl"
    rc, lines, err = _cli_lines(capsys, [
        "--nx", "32", "--ny", "32", "--steps", "40", "--device", "cpu",
        "--guard-interval", "10", "--diag-interval", "20",
        "--metrics", str(path), "--heartbeat", str(tmp_path / "hb.json"),
        "--monitor-hint"])
    assert rc == 0, err
    assert any(ln.startswith("Monitor with: python tools/monitor.py")
               for ln in lines)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "metrics_report", os.path.join(root, "tools", "metrics_report.py"))
    rep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rep)
    events, bad, torn = rep.load_events(str(path))
    assert (bad, torn) == (0, False)
    doc = rep.summarize(events)
    assert [e["event"] for e in events] == ["run_header", "chunk",
                                            "diagnostics", "run_end"]
    assert doc["chunks"]["steps_total"] == 40
    assert doc["chunks"]["guard_checked"] == 1
    assert doc["convergence"]["diag_samples"] == 1
    assert events[-1]["outcome"] == "complete"
    # The one-chunk stream is bitwise the plain run.
    plain, traced = tmp_path / "a.dat", tmp_path / "b.dat"
    for out, extra in ((plain, []), (traced, ["--metrics",
                                              str(tmp_path / "n.jsonl")])):
        assert cli.main(["--nx", "32", "--ny", "32", "--steps", "40",
                         "--device", "cpu", "--quiet", "--out", str(out)]
                        + extra) == 0
    assert plain.read_bytes() == traced.read_bytes()


def test_cli_observer_flags_in_explain_and_errors(capsys):
    from parallel_heat_tpu import cli as jcli

    base = ["--nx", "32", "--ny", "32", "--guard-interval", "10",
            "--diag-interval", "5", "--pipeline-depth", "2", "--explain"]
    rc, lines, _ = _cli_lines(capsys, base + ["--device", "cpu"])
    assert rc == 0
    assert jcli.main(base) == 0
    theirs = capsys.readouterr().out.splitlines()
    for key in ("guard: ", "diagnostics: ", "pipeline: "):
        mine = [ln for ln in lines if ln.startswith(key)]
        assert mine and mine == [ln for ln in theirs if ln.startswith(key)]
    # --pipeline-depth 2 with --converge: the JAX CLI's error and code.
    bad = ["--nx", "16", "--ny", "16", "--steps", "10", "--converge",
           "--pipeline-depth", "2"]
    rc, _, err = _cli_lines(capsys, bad + ["--device", "cpu"])
    assert jcli.main(bad) == rc == 2
    assert err == capsys.readouterr().err
    assert "fixed-step only" in err
    rc, _, err = _cli_lines(capsys, ["--nx", "16", "--device", "cpu",
                                     "--pipeline-depth", "deep"])
    assert rc == 2 and "--pipeline-depth" in err
    rc, _, err = _cli_lines(capsys, ["--nx", "16", "--device", "cpu",
                                     "--monitor-hint"])
    assert rc == 2 and "--monitor-hint requires" in err


@pytest.mark.parametrize("flag", ["--profile", "--trace"])
def test_cli_profile_leaves_a_trace_file(tmp_path, capsys, flag):
    out = tmp_path / "prof"
    rc, lines, err = _cli_lines(capsys, ["--nx", "24", "--ny", "24",
                                         "--steps", "10", "--device", "cpu",
                                         flag, str(out)])
    assert rc == 0, err
    assert f"Profiler trace written to {out}" in lines
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
