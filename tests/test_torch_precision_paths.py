"""The precision contract off the 2D main path, against the JAX package:
the bfloat16 forms of kernels M, B and C, bfloat16, ``f32chunk`` and
float64 ensembles, and the implicit schemes at bfloat16 and float64
(``SEMANTICS.md`` "Precision").

On the CPU the port's cuda route runs the kernels' plain versions, which
round where the kernels round (``chip_smoke.py`` and
``tests/test_torch_card.py`` hold the kernels bitwise to them on the
card). Inputs are made with numpy from a seed; a bfloat16 grid is rounded
from the same float32 values on both sides, so the inputs agree bit for
bit. The helpers and tolerances are ``tests/test_torch_precision.py``'s,
in bfloat16 ulps of each cell's expected value:

- M's plain version against the JAX builder in interpret mode: every
  level rounds, so ``STORAGE_ULPS`` (3) over up to 20 steps (2 seen); its
  residuals 2 bfloat16 ulps of the grid's largest value (a stored level);
- one step of B's and C's plain versions against the JAX builders: the
  step rounds once, so ``CARRY_ULPS`` (1); its residual is the update
  against the input, identical on both sides, so ``rtol=1e-4``;
- whole ensemble runs through M against JAX Pallas: **6 ulps**. Every
  level rounds, and a rounding that an FMA flips early is carried and
  spreads to its neighbours over the following steps: 1 ulp seen at 37
  steps, 4 from 60 steps on, and no more up to 400; the torch route against
  JAX jnp (the ``f32chunk`` and float64 ensembles, the vmap path on both
  sides): bitwise at bfloat16, and at float64 ``rtol=1e-6``, the bound of
  ``test_float64_matches_jax_under_x64`` (XLA:CPU's x64 program was seen
  an ulp of float32 off the eager tree);
- the implicit schemes: at bfloat16 ``STORAGE_ULPS`` against both JAX
  backends (their float32 V-cycles differ by XLA:CPU's contractions, a
  few float32 ulps, which a bfloat16 rounding flips now and then: 0 seen
  over 20 steps); at float64 the bound ``tests/test_torch_implicit.py``
  gives a 20-step float32 run, ``rtol=2e-5`` with an ``atol`` of
  ``mg_tol`` times the grid's scale (a step may stop a cycle apart on the
  two sides; Crank-Nicolson was seen 2.2e-4 of the scale apart), because
  every stored float64 level is a float32 value, exactly: within the port
  a float64 run is bitwise the float32 run, widened;
- ``steps_run`` and ``converged`` identical; within the port a member of
  an ensemble is bitwise its solo ``solve()``; the Dirichlet ring bit for
  bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import parallel_heat_tpu as jx
from parallel_heat_tpu.ensemble.engine import EnsembleSolver as JaxEnsemble
from parallel_heat_tpu.ops import batched as jbatched
from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch import (EnsembleSolver, HeatConfig, explain,
                                     solve, tune)
from parallel_heat_tpu_torch.ensemble.engine import ensemble_path, packable
from parallel_heat_tpu_torch.ops import batched
from parallel_heat_tpu_torch.ops import multigrid as mg
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.solver import make_initial_grid
from test_torch_precision import (BF16, CARRY_ULPS, STORAGE_ULPS,
                                  _assert_ring, _bits, _close_res,
                                  _pair, _rand, _ulps)

STIFF = dict(cx=22.5, cy=22.5)
M_RUN_ULPS = 6
SCHEMES = ["backward_euler", "crank_nicolson"]


def _x64(fn):
    """Run ``fn()`` with JAX's x64 mode on, restoring it after."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", was)


def _same_bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else (
        torch.int32 if a.element_size() == 4 else torch.int64)
    return torch.equal(a.view(view), b.view(view))


# ---------------------------------------------------------------------------
# Each new form's plain version against the JAX builder at bfloat16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 20])
@pytest.mark.parametrize("batch,shape", [(3, (16, 20)), (1, (33, 47)),
                                         (4, (64, 64)), (2, (200, 200))],
                         ids=["3x16x20", "1x33x47", "4x64x64", "2x200x200"])
def test_m_bf16_plain_matches_heat_m_ens_vmem_multistep(batch, shape, k):
    # One-block members (up to 166^2 on the card) and a tiled one (200^2):
    # the plain version has no tiling, the card's launch is held bitwise
    # to it at both. Each member is bitwise A's bfloat16 form alone.
    u32 = _rand((batch,) + shape, batch + k)
    uj, ut = _pair(u32)
    want, wres = jbatched._build_ensemble_vmem_multistep(
        batch, shape, "bfloat16", 0.1, 0.2, k)(uj)
    out = torch.empty_like(ut)
    res = batched.ensemble_steps(ut, out, k, True, cx=0.1, cy=0.2)
    assert out.dtype == BF16 and res.shape == (batch,)
    assert _ulps(out, want) <= STORAGE_ULPS
    wres = np.asarray(wres).reshape(-1)
    for b in range(batch):
        _close_res(res[b], wres[b], False, u32[b])
        _assert_ring(out[b], ut[b])
        one = torch.empty_like(ut[b])
        r1 = sk.resident_steps(ut[b].contiguous(), one, k, True, cx=0.1,
                               cy=0.2)
        assert _same_bits(one, out[b]) and float(r1) == float(res[b])


@pytest.mark.parametrize("cx,cy", [(0.1, 0.1), (0.1, 0.2)])
@pytest.mark.parametrize("kernel,shape", [
    ("B", (64, 128)), ("B", (48, 384)), ("B", (64, 256)), ("C", (48, 2048)),
], ids=["B-64x128", "B-48x384", "B-64x256", "C-48x2048"])
def test_b_and_c_bf16_plain_match_the_jax_kernels(kernel, shape, cx, cy):
    # _build_strip_kernel (:294) and _build_tiled_kernel (:3059) at
    # bfloat16. The JAX tiled kernel takes no bfloat16 grid narrower than
    # 2048 columns or shorter than 48 rows, hence C's 98304 cells.
    build, wrapper, plain = (
        (ps._build_strip_kernel, sk.strip_step, sk.strip_step_plain)
        if kernel == "B" else
        (ps._build_tiled_kernel, sk.tiled_step, sk.tiled_step_plain))
    u32 = _rand(shape, shape[1])
    uj, ut = _pair(u32)
    want, wres = build(shape, "bfloat16", cx, cy, shape,
                       sharded=False)[0](uj, 0, 0)
    assert want.dtype == jnp.bfloat16
    out = torch.empty_like(ut)
    res = plain(ut, out, cx=cx, cy=cy)
    assert out.dtype == BF16
    assert _ulps(out, want) <= CARRY_ULPS
    _close_res(res, wres, True, u32)
    _assert_ring(out, ut)
    again = torch.empty_like(ut)
    assert float(wrapper(ut, again, cx=cx, cy=cy)) == float(res)
    assert _same_bits(again, out)


@pytest.mark.parametrize("shape", [(37, 83), (21, 23), (20, 24)])
def test_b_and_c_bf16_on_ragged_grids(shape):
    # The JAX strips and tiles decline ragged bfloat16 grids; A takes them
    # at one step, at the same rounding points.
    assert ps._build_strip_kernel(shape, "bfloat16", 0.1, 0.2, shape,
                                  sharded=False) is None
    u32 = _rand(shape, 3)
    uj, ut = _pair(u32)
    want, wres = ps._build_vmem_multistep(shape, "bfloat16", 0.1, 0.2, 1)(uj)
    for plain in (sk.strip_step_plain, sk.tiled_step_plain):
        out = torch.empty_like(ut)
        res = plain(ut, out, cx=0.1, cy=0.2)
        assert _ulps(out, want) <= CARRY_ULPS
        _close_res(res, wres, True, u32)
        _assert_ring(out, ut)
        one = torch.empty_like(ut)
        r1 = sk.resident_steps(ut, one, 1, True, cx=0.1, cy=0.2)
        assert _same_bits(one, out) and float(r1) == float(res)


def test_b_and_c_bf16_keep_a_nan_ring_and_report_nan():
    u32 = _rand((20, 24), 5)
    ut = torch.from_numpy(u32).to(BF16)
    ut.view(torch.int16)[0, 5] = 0x7FC1
    ut.view(torch.int16)[7, -1] = 0x7F81
    ut.view(torch.int16)[9, 9] = 0x7FC1
    for launch in (sk.strip_step, sk.tiled_step):
        out = torch.empty_like(ut)
        assert torch.isnan(launch(ut, out, cx=0.1, cy=0.1))
        _assert_ring(out, ut)


# ---------------------------------------------------------------------------
# The pickers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 20), (166, 166), (512, 512),
                                   (1000, 1000), (1859, 1859), (2000, 2000),
                                   (4096, 4096)])
def test_pick_ensemble_m_exactly_where_the_solo_pick_is_a(shape):
    for dtype in ("float32", "bfloat16"):
        a = sk.pick_single_2d(shape, dtype)[0] == "A"
        assert (batched.pick_ensemble_2d(shape, dtype) == "M") == a
        assert batched.pick_ensemble_2d(shape, dtype, "f32chunk") == "vmap"
    assert batched.pick_ensemble_2d(shape, "float64") == "vmap"


def test_pins_at_bfloat16():
    for pin in ("B", "C"):
        with tune.force("single_2d", pin):
            kind, _ = sk.pick_single_2d((64, 256), "bfloat16")
            assert kind == pin
            assert sk.kernel_entry(kind, "bfloat16") == (
                "heat_b_step_bf16" if pin == "B" else "heat_c_tiled_bf16")
            with pytest.warns(RuntimeWarning, match="infeasible"):
                assert sk.pick_single_2d((64, 256), "bfloat16",
                                         "f32chunk")[0] == "E-uni"
    for pin in ("I", "I-uni"):
        with tune.force("single_2d", pin):
            kind, _ = sk.pick_single_2d((64, 256), "bfloat16")
            assert kind == pin
            assert sk.kernel_entry(kind, "bfloat16") == (
                "heat_i_tile_temporal_bf16" if pin == "I"
                else "heat_i_uni_tile_temporal_bf16")
    # A run pinned to B or C at bfloat16 is bitwise A's run (one step a
    # launch, every level rounded).
    cfg = HeatConfig(nx=40, ny=48, steps=9, dtype="bfloat16", backend="cuda",
                     device="cpu")
    a = solve(cfg).grid
    for pin in ("B", "C"):
        with tune.force("single_2d", pin):
            sk.reset_counts()
            assert _same_bits(solve(cfg).grid, a)
            plain = "strip_step_plain" if pin == "B" else "tiled_step_plain"
            assert sk.counts[plain] == 9


# ---------------------------------------------------------------------------
# Ensembles: bfloat16 (M), f32chunk (vmap) and float64 (vmap)
# ---------------------------------------------------------------------------

def _spread(shape, scales, seed=0):
    """Positive member grids, scaled so that they stop at different
    windows."""
    base = (np.random.default_rng(seed).random(shape) * 5).astype(np.float32)
    return np.stack([base * np.float32(s) for s in scales])


def _solo_bitwise(cfg, res, inits):
    for i in range(inits.shape[0]):
        one = solve(cfg, initial=inits[i], device="cpu")
        assert _same_bits(res.grids[i], one.grid)
        assert int(res.steps_run[i]) == one.steps_run
        if cfg.converge:
            assert bool(res.converged[i]) == one.converged
            assert float(res.residual[i]) == one.residual


@pytest.mark.parametrize("converge", [False, True], ids=["fixed", "converge"])
@pytest.mark.parametrize("accumulate", ["storage", "f32chunk"])
def test_bf16_ensembles_match_the_jax_engine(accumulate, converge):
    # storage: path M on both sides (JAX Pallas in interpret mode, the
    # port's plain version of M); f32chunk: vmap on both sides over the
    # carry's textbook chunks, bitwise. eps = 0.01 lies away from the
    # members' residuals: under storage the first member stops at step 60
    # (0.0078) and the others run to the cap on the bfloat16 floor (0.031
    # and 0.075 at 4000 steps); under f32chunk they stop at 40, 80 and
    # 180.
    kw = dict(nx=24, ny=40, cx=0.1, cy=0.2, dtype="bfloat16",
              accumulate=accumulate, steps=37)
    if converge:
        kw.update(steps=400, converge=True, eps=1e-2, check_interval=20)
    init = _spread((24, 40), [1, 3, 9])
    theirs = JaxEnsemble(jx.HeatConfig(backend="pallas", **kw), 3)
    ours = EnsembleSolver(HeatConfig(backend="cuda", device="cpu", **kw), 3)
    path = "M" if accumulate == "storage" else "vmap"
    assert ours.path == theirs.path == path
    jr = theirs.solve(initials=jnp.asarray(init).astype(jnp.bfloat16))
    inits = torch.from_numpy(init).to(BF16)
    sk.reset_counts()
    pr = ours.solve(initials=inits)
    if path == "M":
        assert sk.counts["ensemble_steps_plain"] > 0
    assert pr.grids.dtype == BF16
    assert pr.steps_run.tolist() == np.asarray(jr.steps_run).tolist()
    if converge:
        assert pr.converged.tolist() == np.asarray(jr.converged).tolist()
        assert len(set(pr.steps_run.tolist())) > 1
    if path == "M":
        assert _ulps(pr.grids, jr.grids) <= M_RUN_ULPS
    else:
        np.testing.assert_array_equal(_bits(pr.grids), _bits(jr.grids))
        if converge:
            np.testing.assert_array_equal(pr.residual,
                                          np.asarray(jr.residual))
    for b in range(3):
        _assert_ring(pr.grids[b], inits[b])
    _solo_bitwise(HeatConfig(backend="cuda" if path == "M" else "torch",
                             device="cpu", **kw), pr, inits)


@pytest.mark.parametrize("converge", [False, True], ids=["fixed", "converge"])
def test_float64_ensembles_match_the_jax_engine_under_x64(converge):
    kw = dict(nx=24, ny=40, cx=0.1, cy=0.2, dtype="float64", steps=37)
    if converge:
        kw.update(steps=4000, converge=True, eps=1e-2, check_interval=20)
    init = _spread((24, 40), [1, 3, 9]).astype(np.float64)

    def theirs():
        js = JaxEnsemble(jx.HeatConfig(backend="jnp", **kw), 3)
        r = js.solve(initials=jnp.asarray(init))
        return (js.path, np.asarray(r.grids), np.asarray(r.steps_run),
                None if r.converged is None else np.asarray(r.converged))

    jpath, jgrids, jsteps, jconv = _x64(theirs)
    ours = EnsembleSolver(HeatConfig(device="cpu", **kw), 3)
    assert ours.path == jpath == "vmap"
    pr = ours.solve(initials=init)
    assert pr.grids.dtype == torch.float64 and jgrids.dtype == np.float64
    np.testing.assert_allclose(pr.grids.numpy(), jgrids, rtol=1e-6, atol=0)
    assert pr.steps_run.tolist() == jsteps.tolist()
    if converge:
        assert pr.converged.tolist() == jconv.tolist()
        assert len(set(pr.steps_run.tolist())) > 1
    _solo_bitwise(HeatConfig(device="cpu", **kw), pr, torch.from_numpy(init))


def test_ensemble_f32chunk_chunk_steps_round_up_to_the_carry_depth():
    # Chunk boundaries are rounding points: chunk_steps=10 runs chunks of
    # 16, as the JAX engine rounds them, bitwise the unchunked run.
    kw = dict(nx=24, ny=40, steps=64, dtype="bfloat16",
              accumulate="f32chunk", device="cpu")
    es = EnsembleSolver(HeatConfig(**kw), 2)
    seen = []
    chunked = es.solve(chunk_steps=10, on_boundary=lambda b: seen.append(
        b.step))
    assert seen == [16, 32, 48, 64]
    assert _same_bits(chunked.grids, es.solve().grids)


def test_ensemble_observers_sum_bf16_in_float32():
    from parallel_heat_tpu.ensemble.engine import (ensemble_grid_stats as
                                                   jstats)
    from parallel_heat_tpu_torch.ensemble.engine import (
        ensemble_all_finite, ensemble_grid_stats)

    g32 = _spread((24, 40), [1, 3], seed=1) * 10
    p32 = _spread((24, 40), [1, 3], seed=2) * 10
    (gj, gt), (pj, pt) = _pair(g32), _pair(p32)
    gt[1].view(torch.int16)[3, 4] = 0x7FC1
    gj = gj.at[1, 3, 4].set(jnp.nan)
    assert ensemble_all_finite(gt).tolist() == [True, False]
    ours, theirs = ensemble_grid_stats(gt, pt), jstats(gj, pj)
    for o, t in zip(ours[:1], theirs[:1]):
        assert (o["min"], o["max"]) == (t["min"], t["max"])
        for key in ("heat", "update_l2", "update_linf"):
            np.testing.assert_allclose(o[key], t[key], rtol=1e-6)


def test_packable_answers():
    cases = [
        (dict(dtype="bfloat16", backend="cuda"), True, "kernel M"),
        (dict(dtype="bfloat16", accumulate="f32chunk", backend="cuda"), False,
         "f32chunk"),
        (dict(dtype="bfloat16", backend="torch"), True, "torch"),
        (dict(dtype="bfloat16", accumulate="f32chunk", backend="torch"), True,
         "torch"),
        (dict(dtype="float64"), True, "torch"),
        (dict(dtype="bfloat16", scheme="backward_euler", **STIFF), True,
         "V-cycle"),
        (dict(dtype="float64", scheme="crank_nicolson", backend="cuda",
              **STIFF), True, "V-cycle"),
        (dict(nx=4096, ny=4096, dtype="bfloat16", backend="cuda"), False,
         "no member-bitwise"),
        # 3D on one block: the vmap route, as in the JAX package.
        (dict(nz=8, dtype="bfloat16", backend="torch"), True, "torch"),
        (dict(nz=8, dtype="bfloat16", backend="cuda"), False,
         "no member-bitwise"),
        (dict(nz=8, dtype="float64"), True, "torch"),
    ]
    for kw, ok, why in cases:
        cfg = HeatConfig(**{"nx": 64, "ny": 64, "device": "cpu", **kw})
        got, reason = packable(cfg)
        assert got == ok and why in reason, (kw, got, reason)
    # Meshes run their precision solo, whatever the dtype.
    for kw in (dict(dtype="bfloat16", mesh_shape=(2, 2)),
               dict(dtype="float64", mesh_shape=(2, 2))):
        got, reason = packable(HeatConfig(nx=64, ny=64, **kw))
        assert not got and "sharded configs run solo" in reason


@pytest.mark.parametrize("kw,expect", [
    (dict(dtype="bfloat16", backend="cuda"),
     "kernel M (heat_m_ensemble_bf16"),
    (dict(dtype="bfloat16", accumulate="f32chunk", backend="cuda"),
     "float32 carry through chunks of 16"),
    (dict(dtype="float64"), "float64 storage"),
    (dict(dtype="bfloat16", scheme="backward_euler", **STIFF),
     "implicit V-cycle"),
], ids=["M-bf16", "f32chunk", "float64", "implicit"])
def test_explain_names_the_ensemble_precision_path(kw, expect):
    out = explain(HeatConfig(nx=512, ny=512, **kw), device="cuda",
                  ensemble=64)
    assert expect in out["ensemble"]["path"], out["ensemble"]
    assert out["dtype"] == kw["dtype"]


# ---------------------------------------------------------------------------
# The implicit schemes at bfloat16 and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_bf16_implicit_matches_jax(scheme, backend):
    kw = dict(nx=34, ny=34, steps=20, scheme=scheme, dtype="bfloat16",
              **STIFF)
    ours = solve(HeatConfig(backend=backend, **kw), device="cpu")
    assert ours.grid.dtype == BF16
    for jb in ("jnp", "pallas"):
        theirs = jx.solve(jx.HeatConfig(backend=jb, **kw))
        assert _ulps(ours.grid, theirs.grid) <= STORAGE_ULPS
    _assert_ring(ours.grid, make_initial_grid(HeatConfig(device="cpu",
                                                         **kw)))
    other = solve(HeatConfig(backend="cuda" if backend == "torch"
                             else "torch", **kw), device="cpu")
    assert _same_bits(ours.grid, other.grid)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_float64_implicit_matches_jax_under_x64(scheme):
    kw = dict(nx=34, ny=34, steps=20, scheme=scheme, dtype="float64",
              **STIFF)
    theirs = _x64(lambda: np.asarray(jx.solve(jx.HeatConfig(
        backend="jnp", **kw)).grid))
    assert theirs.dtype == np.float64
    f32 = solve(HeatConfig(**dict(kw, dtype="float32")), device="cpu").grid
    for backend in ("torch", "cuda"):
        cfg = HeatConfig(backend=backend, **kw)
        ours = solve(cfg, device="cpu")
        assert ours.grid.dtype == torch.float64
        scale = float(np.abs(theirs).max())
        np.testing.assert_allclose(ours.to_numpy(), theirs, rtol=2e-5,
                                   atol=cfg.mg_tol * scale)
        # Every stored level is a float32 value, exactly: the float32 run.
        assert torch.equal(ours.grid, f32.double())


@pytest.mark.parametrize("dtype,eps", [("bfloat16", 50.0),
                                       ("float64", 50.0)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_implicit_converge_at_precision_matches_jax(scheme, dtype, eps):
    kw = dict(nx=34, ny=34, steps=60, converge=True, eps=eps,
              check_interval=5, scheme=scheme, dtype=dtype, **STIFF)

    def theirs():
        r = jx.solve(jx.HeatConfig(backend="jnp", **kw))
        return int(r.steps_run), bool(r.converged), float(r.residual)

    jsteps, jconv, jres = (_x64(theirs) if dtype == "float64"
                           else theirs())
    ours = solve(HeatConfig(**kw), device="cpu")
    assert (ours.steps_run, ours.converged) == (jsteps, jconv)
    np.testing.assert_allclose(ours.residual, jres, rtol=1e-2)
    if dtype == "bfloat16":
        # A bfloat16 residual is a difference of two stored levels.
        assert ours.residual == jres


def test_implicit_residual_is_taken_after_rounding():
    # The residual of a bfloat16 step is the stored level, widened,
    # against the level the step read, as the JAX package takes it; the
    # unrounded update (the same step on a float32 copy of the level)
    # crosses eps = 8050 a step earlier (8035.7 at step 4, against 8064
    # after rounding), so a converge run stops at step 5, as JAX's does,
    # and not at step 4.
    kw = dict(nx=34, ny=34, scheme="backward_euler", dtype="bfloat16",
              **STIFF)
    cfg = HeatConfig(steps=1, device="cpu", **kw).validate()
    step = mg._step_fn(cfg, "torch")
    u = make_initial_grid(cfg)
    out, level = torch.empty_like(u), torch.empty(u.shape)
    before, after = [], []
    for _ in range(6):
        after.append(float(step(u, out)))
        before.append(float(step(u.float(), level)))
        assert _same_bits(out, level.to(BF16))
        want = (out.float() - u.float())[1:-1, 1:-1].abs().max()
        assert after[-1] == float(want)
        u, out = out, u
    eps = 8050.0
    first = [next(i + 1 for i, r in enumerate(rs) if r < eps)
             for rs in (before, after)]
    assert first == [4, 5]
    run = dict(kw, steps=40, converge=True, eps=eps, check_interval=1)
    theirs = jx.solve(jx.HeatConfig(backend="jnp", **run))
    ours = solve(HeatConfig(**run), device="cpu")
    assert ours.steps_run == int(theirs.steps_run) == 5 and ours.converged
    assert ours.residual == float(theirs.residual) == after[4]


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_implicit_ensemble_members_are_their_solo_solves(dtype):
    kw = dict(nx=34, ny=34, steps=4, scheme="crank_nicolson", dtype=dtype,
              backend="cuda", device="cpu", **STIFF)
    cfg = HeatConfig(**kw)
    init = torch.from_numpy(_spread((34, 34), [1, 2, 4]) * 100).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float64)
    es = EnsembleSolver(cfg, 3)
    assert ensemble_path(cfg) == "vmap"
    _solo_bitwise(cfg, es.solve(initials=init), init)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_explain_names_the_implicit_widen_and_round(dtype):
    out = explain(HeatConfig(nx=512, ny=512, scheme="backward_euler",
                             dtype=dtype, backend="cuda", **STIFF),
                  device="cuda")
    assert out["backend"] == "cuda" and out["dtype"] == dtype
    assert (f"widened to float32 once a step, the interior rounded to "
            f"{dtype} once" in out["path"]), out["path"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,out", [
    (["--ensemble", "4", "--dtype", "bfloat16"], "g.npy"),
    (["--scheme", "backward_euler", "--cx", "22.5", "--cy", "22.5",
      "--steps", "5", "--dtype", "bfloat16"], "g.dat"),
    (["--scheme", "backward_euler", "--cx", "22.5", "--cy", "22.5",
      "--steps", "5", "--dtype", "float64"], "g.dat"),
    (["--ensemble", "3", "--dtype", "bfloat16", "--accumulate",
      "f32chunk"], "g.npy"),
], ids=["ensemble-bf16", "backward-euler-bf16", "backward-euler-f64",
        "ensemble-f32chunk"])
def test_cli_precision_runs_write_the_jax_clis_bytes(tmp_path, capsys, flags,
                                                     out):
    from parallel_heat_tpu import cli as jcli

    from parallel_heat_tpu_torch import cli

    base = ["--nx", "32", "--ny", "32", "--steps", "20"]
    lines = {}
    was = jax.config.jax_enable_x64
    try:
        for name, main, tail in (("ours", cli.main,
                                  ["--device", "cpu", "--backend", "torch"]),
                                 ("theirs", jcli.main, ["--backend", "jnp"])):
            path = tmp_path / name
            path.mkdir()
            rc = main(base + flags + tail + ["--out", str(path / out)])
            got = capsys.readouterr()
            assert rc == 0, got.err
            lines[name] = [ln.replace(str(path), "").replace(
                "parallel_heat_tpu_torch", "parallel_heat_tpu")
                for ln in got.out.splitlines() if "Elapsed" not in ln]
    finally:
        jax.config.update("jax_enable_x64", was)
    assert lines["ours"] == lines["theirs"]
    assert ((tmp_path / "ours" / out).read_bytes()
            == (tmp_path / "theirs" / out).read_bytes())
