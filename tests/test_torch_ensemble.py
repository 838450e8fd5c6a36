"""The port's ensemble engine and kernel M against the JAX package.

Everything runs on the CPU. Kernel M's wrapper takes its plain version
there (the tensors lie on the CPU); the JAX kernel M
(``ops/batched._build_ensemble_vmem_multistep``) runs in Pallas interpret
mode, as ``tests/test_ensemble.py`` runs it.

Tolerances:

- grids against the JAX package: ``rtol=1e-5, atol=1e-5`` at up to 25
  steps of values of order 10, residuals ``rtol=1e-4``: the few-ulp
  contract of ``tests/test_torch_kernels.py``. Both sides evaluate the
  factored combine, but XLA:CPU may contract multiply-adds into FMAs
  where eager PyTorch rounds every operation; against the jnp path (the
  textbook tree) the same bound holds at these depths;
- Dirichlet cells: bit-exact;
- within the port: none. A member of a batched run is bitwise the solo
  ``solve()`` on the same path, and a resumed run bitwise the
  uninterrupted one.

``steps_run``, ``converged`` and the compaction events must be identical
to the JAX engine's; each eps is chosen away from every member's
residuals, so no few-ulp difference can move a stopping window.
"""

import dataclasses

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu import solver as jsolver
from parallel_heat_tpu.ensemble.engine import EnsembleSolver as JaxEnsemble
from parallel_heat_tpu.ops import batched as jbatched
from parallel_heat_tpu_torch import (EnsembleConfig, EnsembleSolver,
                                     HeatConfig, convert, explain, solve,
                                     tune)
from parallel_heat_tpu_torch.config import (ENSEMBLE_ORCHESTRATION_FIELDS,
                                            ENSEMBLE_SEMANTIC_FIELDS)
from parallel_heat_tpu_torch.ensemble import (EnsembleInterrupted,
                                              ensemble_path, packable)
from parallel_heat_tpu_torch.ops import batched
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params

GRID_TOL = dict(rtol=1e-5, atol=1e-5)
COEFFS = [(0.1, 0.1), (0.1, 0.2)]


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10).astype(np.float32)


def _spread(shape, scales, seed=0):
    """Positive member grids of one shape, scaled so that they converge
    at different windows."""
    rng = np.random.default_rng(seed)
    base = (rng.random(shape) * 5).astype(np.float32)
    return np.stack([base * np.float32(s) for s in scales])


def _assert_ring_exact(got, u):
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert np.array_equal(got[sl], u[sl])


# --- (a) kernel M's plain version against the JAX kernel and jnp ----------

@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [1, 7, 25])
@pytest.mark.parametrize("batch,shape", [(3, (16, 20)), (1, (33, 47)),
                                         (4, (64, 64))])
def test_m_plain_matches_jax_kernel_m_and_jnp(batch, shape, k, cx, cy):
    u = _rand((batch,) + shape, seed=batch + k)
    got = torch.empty(u.shape)
    res = batched.ensemble_steps(torch.from_numpy(u), got, k, cx=cx, cy=cy)
    assert res.shape == (batch,) and res.dtype == torch.float32
    fn = jbatched._build_ensemble_vmem_multistep(batch, shape, "float32",
                                                 cx, cy, k)
    want, want_res = fn(np.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRID_TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), rtol=1e-4)
    _assert_ring_exact(got.numpy(), u)
    for b in range(batch):
        ref = jx.solve(jx.HeatConfig(nx=shape[0], ny=shape[1], cx=cx, cy=cy,
                                     steps=k, backend="jnp"), initial=u[b])
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref.grid),
                                   **GRID_TOL)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_m_member_is_bitwise_kernel_a_on_that_member(k):
    # On the CPU both take their plain versions; on the card the two
    # kernels share their step code (tests/test_torch_card.py).
    u = torch.from_numpy(_rand((3, 24, 31), seed=k))
    got = torch.empty_like(u)
    res = batched.ensemble_steps(u, got, k, cx=0.1, cy=0.2)
    nores = torch.empty_like(u)
    assert batched.ensemble_steps(u, nores, k, False, cx=0.1,
                                  cy=0.2) is None
    assert torch.equal(got, nores)
    for b in range(3):
        one = torch.empty_like(u[b])
        r = sk.resident_steps(u[b].contiguous(), one, k, cx=0.1, cy=0.2)
        assert torch.equal(one, got[b]) and float(r) == float(res[b])


def test_m_residual_nan_stays_with_its_member():
    u = torch.from_numpy(_rand((4, 20, 20), seed=5))
    clean = torch.empty_like(u)
    batched.ensemble_steps(u, clean, 5, cx=0.1, cy=0.1)
    u[2, 7, 9] = float("nan")
    got = torch.empty_like(u)
    res = batched.ensemble_steps(u, got, 5, cx=0.1, cy=0.1)
    assert torch.isnan(res).tolist() == [False, False, True, False]
    for b in (0, 1, 3):
        assert torch.equal(got[b], clean[b])


@pytest.mark.parametrize("case", ["rank", "dtype", "shape", "alias", "k",
                                  "small", "strided"])
def test_ensemble_steps_rejects_bad_inputs(case):
    u = torch.zeros((2, 16, 16))
    out = torch.empty_like(u)
    k = 3
    if case == "rank":
        u, out = u[0], out[0]
    elif case == "dtype":
        u = u.double()
    elif case == "shape":
        out = torch.empty((2, 16, 17))
    elif case == "alias":
        out = u
    elif case == "k":
        k = 0
    elif case == "small":
        u, out = torch.zeros((2, 2, 16)), torch.empty((2, 2, 16))
    elif case == "strided":
        u = torch.zeros((2, 16, 32))[:, :, ::2]
    with pytest.raises((ValueError, TypeError)):
        batched.ensemble_steps(u, out, k, cx=0.1, cy=0.1)


def test_m_launch_plan():
    p = params()
    # A small member: one block per member, a one-cell frame.
    small = p.m_plan(64, (24, 20))
    assert small["tiles"] == 1 and small["groups"] == 64
    assert small["depth"] == 1 and small["tile"] == (24, 20)
    # 512^2 does not fit one block: groups of tiles that cover a member,
    # every group resident at once, each tile within one block's memory.
    big = p.m_plan(64, (512, 512))
    ty, tx = big["tile"]
    assert big["tiles"] == -(-512 // ty) * -(-512 // tx) > 1
    assert big["groups"] * big["tiles"] <= p.sm_count
    assert p.m_smem_bytes(big["tile"], big["depth"]) <= p.smem_per_block_max
    # Past the card's shared memory, no plan: the picker takes vmap.
    assert p.m_plan(2, (4000, 4000)) is None
    assert batched.pick_ensemble_2d((4000, 4000)) == "vmap"
    assert batched.pick_ensemble_2d((512, 512)) == "M"
    with tune.force("ensemble_2d", "vmap"):
        assert batched.pick_ensemble_2d((512, 512)) == "vmap"
    with tune.force("ensemble_2d", "M"), pytest.warns(RuntimeWarning):
        assert batched.pick_ensemble_2d((4000, 4000)) == "vmap"
    # M admits where the solo picker takes A.
    with tune.force("single_2d", "E"):
        assert batched.pick_ensemble_2d((512, 512)) == "vmap"


# --- (c) the engine against the JAX engine, and member parity -------------

def _both(kw, ens_kw, inits, backend):
    """The port's and the JAX package's ensemble runs of one config."""
    jcfg = jx.HeatConfig(backend={"torch": "jnp", "cuda": "pallas"}[backend],
                         **kw)
    jens = jx.EnsembleConfig(**ens_kw)
    cfg, ens, grids = convert.from_jax(
        dataclasses.asdict(jcfg), inits, device="cpu",
        ensemble_fields=dataclasses.asdict(jens))
    assert cfg.backend == backend and ens.members == len(inits)
    got = EnsembleSolver(cfg, ens).solve(initials=grids)
    want = JaxEnsemble(jcfg, jens).solve(initials=inits)
    return cfg, got, want


@pytest.mark.parametrize("backend,path", [("torch", "vmap"), ("cuda", "M")])
def test_fixed_matches_jax_engine_and_solo(backend, path):
    kw = dict(nx=18, ny=22, cx=0.1, cy=0.15, steps=23)
    inits = _rand((4, 18, 22), seed=1)
    cfg, got, want = _both(kw, dict(members=4), inits, backend)
    assert ensemble_path(cfg) == path
    assert got.converged is None and got.residual is None
    assert got.steps_run.tolist() == want.steps_run.tolist() == [23] * 4
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.grids),
                               **GRID_TOL)
    _assert_ring_exact(got.to_numpy(), inits)
    for i in range(4):
        solo = solve(cfg, initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid)
        member = got.member(i)
        assert member.steps_run == 23 and member.converged is None


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("window_rounds,threshold", [(1, 0.75), (4, 0.5),
                                                     (2, None)])
def test_converge_matches_jax_engine_and_solo(backend, window_rounds,
                                              threshold):
    # eps = 1e-3: every member's residual crosses it with a margin of
    # percent (they fall about 0.4% a step), far beyond any ulp.
    kw = dict(nx=18, ny=22, steps=4000, converge=True, eps=1e-3,
              check_interval=20)
    inits = _spread((18, 22), (0.05, 0.1, 0.5, 1.0, 10.0, 40.0))
    ens_kw = dict(members=6, window_rounds=window_rounds,
                  compact_threshold=threshold)
    cfg, got, want = _both(kw, ens_kw, inits, backend)
    assert len(set(got.steps_run.tolist())) > 1
    assert got.steps_run.tolist() == want.steps_run.tolist()
    assert got.converged.tolist() == want.converged.tolist()
    assert got.compactions == [tuple(c) for c in want.compactions]
    assert bool(got.compactions) == (threshold is not None)
    np.testing.assert_allclose(got.residual, want.residual, rtol=1e-3)
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.grids),
                               **GRID_TOL)
    for i in range(6):
        solo = solve(cfg, initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid), i
        assert int(got.steps_run[i]) == solo.steps_run, i
        assert bool(got.converged[i]) == solo.converged, i
        assert float(got.residual[i]) == solo.residual, i


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_converge_tail_runs_for_unconverged_members(backend):
    # 53 = 2 windows of 20 + a 13-step tail. Member 0 converges in the
    # first window (eps above its residual there), the others never do.
    kw = dict(nx=16, ny=16, steps=53, converge=True, eps=1e-4,
              check_interval=20)
    inits = _spread((16, 16), (1e-6, 1.0, 3.0))
    cfg, got, want = _both(kw, dict(members=3), inits, backend)
    assert got.steps_run.tolist() == want.steps_run.tolist() == [20, 53, 53]
    assert got.converged.tolist() == [True, False, False]
    for i in range(3):
        solo = solve(cfg, initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid), i
        assert float(got.residual[i]) == solo.residual


def test_3d_members_take_the_vmap_path_bitwise():
    cfg = HeatConfig(nx=10, ny=12, nz=8, steps=11, backend="cuda",
                     device="cpu")
    assert ensemble_path(cfg) == "vmap"
    inits = _rand((2, 10, 12, 8), seed=3)
    got = EnsembleSolver(cfg, 2).solve(initials=inits)
    for i in range(2):
        solo = solve(cfg.replace(backend="torch"), initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid)


def test_initials_default_and_broadcast():
    cfg = HeatConfig(nx=16, ny=16, steps=9, backend="cuda", device="cpu")
    solo = solve(cfg)
    got = EnsembleSolver(cfg, 3).solve()
    one = _rand((16, 16), seed=2)
    cast = EnsembleSolver(cfg, 3).solve(initials=one)
    solo_one = solve(cfg, initial=one)
    for i in range(3):
        assert torch.equal(got.grids[i], solo.grid)
        assert torch.equal(cast.grids[i], solo_one.grid)
    with pytest.raises(ValueError, match="matches neither"):
        EnsembleSolver(cfg, 3).solve(initials=np.zeros((2, 16, 16)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_resume_from_a_boundary_state_is_bitwise(backend):
    cfg = HeatConfig(nx=18, ny=22, steps=4000, converge=True, eps=1e-3,
                     check_interval=20, backend=backend, device="cpu")
    ens = EnsembleConfig(members=5, window_rounds=2, compact_threshold=0.7)
    inits = _spread((18, 22), (0.05, 0.5, 1.0, 10.0, 40.0))
    whole = EnsembleSolver(cfg, ens).solve(initials=inits)
    seen = []

    def stop_at_third(boundary):
        seen.append((boundary.step, boundary.batch, boundary.live,
                     boundary.order))
        if len(seen) == 3:
            raise EnsembleInterrupted("deadline", boundary.assemble())

    with pytest.raises(EnsembleInterrupted) as caught:
        EnsembleSolver(cfg, ens).solve(initials=inits,
                                       on_boundary=stop_at_third)
    state = caught.value.state
    assert caught.value.reason == "deadline" and state["k"] == seen[-1][0]
    assert state["done"].any() and not state["done"].all()
    resumed = EnsembleSolver(cfg, ens).solve(state=state)
    assert torch.equal(resumed.grids, whole.grids)
    assert resumed.steps_run.tolist() == whole.steps_run.tolist()
    assert resumed.converged.tolist() == whole.converged.tolist()
    assert resumed.residual.tolist() == whole.residual.tolist()


def test_fixed_chunks_and_resume_are_bitwise():
    cfg = HeatConfig(nx=16, ny=20, steps=50, backend="cuda", device="cpu")
    inits = _rand((3, 16, 20), seed=4)
    whole = EnsembleSolver(cfg, 3).solve(initials=inits)
    states = []
    chunked = EnsembleSolver(cfg, 3).solve(
        initials=inits, chunk_steps=20,
        on_boundary=lambda b: states.append(b.assemble()))
    assert [s["k"] for s in states] == [20, 40, 50]
    assert torch.equal(chunked.grids, whole.grids)
    resumed = EnsembleSolver(cfg, 3).solve(state=states[0])
    assert torch.equal(resumed.grids, whole.grids)
    with pytest.raises(ValueError, match="past the target"):
        EnsembleSolver(cfg.replace(steps=10), 3).solve(state=states[0])


# --- config, explain, packable ---------------------------------------------

def test_ensemble_config_is_the_jax_packages():
    from parallel_heat_tpu import config as jconfig

    assert ENSEMBLE_SEMANTIC_FIELDS == jconfig.ENSEMBLE_SEMANTIC_FIELDS
    assert (ENSEMBLE_ORCHESTRATION_FIELDS
            == jconfig.ENSEMBLE_ORCHESTRATION_FIELDS)
    ens = EnsembleConfig(members=5, compact_threshold=None, window_rounds=7)
    assert ens.to_json() == jx.EnsembleConfig(
        members=5, compact_threshold=None, window_rounds=7).to_json()
    assert EnsembleConfig.from_json(ens.to_json()) == ens
    assert ens.orchestration_free() == EnsembleConfig(members=5)
    for bad in (dict(members=0), dict(compact_threshold=0.0),
                dict(compact_threshold=1.5), dict(window_rounds=0)):
        with pytest.raises(ValueError):
            EnsembleConfig(**bad).validate()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_explain_ensemble_keys_are_the_jax_packages(backend):
    cfg = HeatConfig(nx=32, ny=32, backend=backend, device="cpu")
    got = explain(cfg, ensemble=8)
    want = jsolver.explain(jx.HeatConfig(nx=32, ny=32, backend="jnp"),
                           ensemble=8)
    assert set(got["ensemble"]) == set(want["ensemble"])
    assert got["ensemble"]["members"] == 8
    assert got["ensemble"]["packable"] is True
    assert ("kernel M" in got["ensemble"]["path"]) == (backend == "cuda")
    assert "ensemble" not in explain(cfg)
    assert EnsembleSolver(cfg, 8).explain()["ensemble"] == got["ensemble"]


def test_packable_verdicts():
    assert packable(HeatConfig(backend="torch", device="cpu"))[0]
    assert packable(HeatConfig(backend="cuda", device="cpu"))[0]
    # A streaming kernel has no batched twin.
    ok, reason = packable(HeatConfig(nx=4000, ny=4000, backend="cuda",
                                     device="cpu"))
    assert not ok and "no member-bitwise batched twin" in reason
    ok, reason = packable(HeatConfig(nx=2))
    assert not ok and reason.startswith("invalid config")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_diverging_member_stops_where_its_solo_solve_stops(backend):
    # cx + cy = 0.8 is past the explicit scheme's stability bound, so the
    # plate's member diverges and its residual turns NaN; its solo solve()
    # stops at that window (``while res >= eps``). The zero member and the
    # 1e-30 one converge in the first window. Each member is held to the
    # JAX package's solo solve(), not to its ensemble, which runs the
    # diverged member on to the end: steps_run and converged to the solo
    # run on the same path, a finite grid to the jnp solo run. A diverged
    # grid is inf and NaN wherever the blow-up got first, by each path's
    # own roundings (the Pallas kernel in interpret mode lets XLA:CPU
    # contract multiply-adds, kernel M's plain version factors the
    # combine): there only its Dirichlet ring is held to JAX's, and the
    # grid is held bitwise to the port's solo run on the same path.
    kw = dict(nx=20, ny=20, cx=0.4, cy=0.4, steps=300, converge=True)
    jcfg = jx.HeatConfig(backend={"torch": "jnp", "cuda": "pallas"}[backend],
                         **kw)
    cfg = convert.from_jax(dataclasses.asdict(jcfg), None, device="cpu")[0]
    base = EnsembleSolver(cfg, 1).initial_grids()[0].numpy()
    inits = np.stack([base * np.float32(s) for s in (1.0, 0.0, 1e-30)])
    with pytest.warns(RuntimeWarning, match="diverged"):
        got = EnsembleSolver(cfg, 3).solve(initials=inits)
    assert ensemble_path(cfg) == {"torch": "vmap", "cuda": "M"}[backend]
    for i in range(3):
        want = jx.solve(jcfg, initial=inits[i])
        textbook = jx.solve(jcfg.replace(backend="jnp"), initial=inits[i])
        solo = solve(cfg, initial=inits[i])
        assert int(got.steps_run[i]) == want.steps_run == solo.steps_run, i
        assert want.steps_run == textbook.steps_run, i
        assert bool(got.converged[i]) == bool(want.converged), i
        assert bool(got.converged[i]) == solo.converged, i
        ref = np.asarray(textbook.grid)
        if np.isfinite(ref).all():
            np.testing.assert_allclose(got.grids[i].numpy(), ref,
                                       **GRID_TOL)
        else:
            assert not np.isfinite(got.grids[i].numpy()).all(), i
            _assert_ring_exact(got.grids[i].numpy()[None], ref[None])
        assert np.array_equal(got.grids[i].numpy(), solo.grid.numpy(),
                              equal_nan=True), i
    assert got.steps_run.tolist()[0] < 300
    assert got.converged.tolist() == [False, True, True]
    assert np.isnan(got.residual[0])


# Five members of the unstable 20^2 plate (cx + cy = 0.8), checked every
# 10 steps of 305: the plate scaled 1e12, 1 and 1e6 diverge (their
# residuals turn NaN at steps 100, 140 and 120), 0 and 1e-30 converge at
# step 10. Under compact_threshold 0.5 the first compaction comes at step
# 100, when member 0 has just latched on its NaN: it parks the two
# converged members and keeps member 0, diverged, in the batch beside
# the two live ones.
DIVERGE_SCALES = (1e12, 1.0, 0.0, 1e-30, 1e6)


def _diverging(backend):
    cfg = HeatConfig(nx=20, ny=20, cx=0.4, cy=0.4, steps=305, converge=True,
                     check_interval=10, backend=backend, device="cpu")
    base = EnsembleSolver(cfg, 1).initial_grids()[0].numpy()
    inits = np.stack([base * np.float32(s) for s in DIVERGE_SCALES])
    ens = EnsembleConfig(members=len(DIVERGE_SCALES), window_rounds=1,
                         compact_threshold=0.5)
    return cfg, inits, ens


def _assert_members_are_solo_runs(cfg, inits, got):
    for i, init in enumerate(inits):
        solo = solve(cfg, initial=init)
        assert int(got.steps_run[i]) == solo.steps_run, i
        assert bool(got.converged[i]) == solo.converged, i
        assert np.array_equal(got.grids[i].numpy(), solo.grid.numpy(),
                              equal_nan=True), i


def _assert_same_run(a, b):
    assert np.array_equal(a.grids.numpy(), b.grids.numpy(), equal_nan=True)
    assert a.steps_run.tolist() == b.steps_run.tolist()
    assert a.converged.tolist() == b.converged.tolist()
    assert np.array_equal(a.residual, b.residual, equal_nan=True)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_diverged_member_at_a_compaction_stops_where_its_solo_solve_stops(
        backend):
    cfg, inits, ens = _diverging(backend)
    seen = []
    with pytest.warns(RuntimeWarning, match="diverged"):
        got = EnsembleSolver(cfg, ens).solve(
            initials=inits, on_boundary=lambda b: seen.append(
                (b.step, b.batch, b.order)))
    # The compaction at step 100 kept member 0, latched on its NaN, in a
    # batch of three.
    assert got.compactions == [(100, 5, 3)]
    assert (110, 3, (0, 1, 4)) in seen
    assert got.steps_run.tolist() == [105, 145, 10, 10, 125]
    assert got.converged.tolist() == [False, False, True, True, False]
    _assert_members_are_solo_runs(cfg, inits, got)
    # Compaction changes no member's run.
    with pytest.warns(RuntimeWarning, match="diverged"):
        flat = EnsembleSolver(cfg, dataclasses.replace(
            ens, compact_threshold=None)).solve(initials=inits)
    assert flat.compactions == []
    _assert_same_run(got, flat)


@pytest.mark.parametrize("at", [100, 110], ids=["at-nan", "past-compaction"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_resume_after_a_member_diverged_is_bitwise(backend, at):
    # A state saved at the boundary of member 0's NaN window (before the
    # compaction that follows it), or one window on, when member 0 rides
    # diverged in the compacted batch: the resumed run is the whole
    # run, and each member its solo solve().
    cfg, inits, ens = _diverging(backend)
    with pytest.warns(RuntimeWarning, match="diverged"):
        whole = EnsembleSolver(cfg, ens).solve(initials=inits)

    def stop(boundary):
        if boundary.step == at:
            raise EnsembleInterrupted("deadline", boundary.assemble())

    with pytest.raises(EnsembleInterrupted) as caught:
        EnsembleSolver(cfg, ens).solve(initials=inits, on_boundary=stop)
    state = caught.value.state
    assert state["k"] == at
    assert state["done"].tolist() == [True, False, True, True, False]
    assert np.isnan(state["res"][0])
    with pytest.warns(RuntimeWarning, match="diverged"):
        resumed = EnsembleSolver(cfg, ens).solve(state=state)
    _assert_same_run(resumed, whole)
    _assert_members_are_solo_runs(cfg, inits, resumed)
