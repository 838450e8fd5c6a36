"""The precision contract of the PyTorch port against the JAX package:
bfloat16 storage, ``accumulate="f32chunk"`` and float64 on the 2D
single-block explicit path (``SEMANTICS.md`` "Precision").

On the CPU the port's cuda route runs the kernels' plain versions, which
round where the kernels round (``chip_smoke.py`` and
``tests/test_torch_card.py`` hold the kernels bitwise to them on the
card). Inputs are made with numpy from a seed and handed to both
packages; a bfloat16 grid is rounded from the same float32 values on
both sides (round to nearest even), so the inputs agree bit for bit.

Tolerances, in bfloat16 ulps of each cell's expected value (the grids
here are positive, so a relative ulp is meaningful):

- the cuda route's plain versions against the JAX Pallas builders in
  interpret mode, as ROADMAP.md queue 3 advises: both evaluate the
  factored combine, but XLA:CPU may contract a multiply and an add into
  an FMA where eager PyTorch rounds each operation. A float32 difference
  of an ulp flips a bfloat16 rounding now and then: in storage mode every
  level rounds, so **3 ulps** over a chunk of up to 16 steps (2 seen); a
  carried chunk rounds once, so **1 ulp**. A residual is the last step's
  float32 update less the level it read: a carried level is float32 on
  both sides, so ``rtol=1e-4``, the few-ulp contract of
  ``tests/test_torch_kernels.py``; a stored level is bfloat16, and a
  flipped rounding of it moves the difference by that level's ulp, so
  **2 ulps of the grid's largest value**, absolute;
- the torch route against the JAX jnp path: **0 ulps**. Both evaluate
  the textbook tree, which XLA:CPU compiles without contraction (the
  basis of the JAX package's sharded-equals-single-device contract), at
  the same rounding points;
- whole runs of the cuda route against JAX Pallas: ``rtol=8e-3`` (about
  2 ulps), the JAX package's own cross-path contract
  (``tests/test_accumulate.py``);
- ``steps_run`` and ``converged`` must be identical where both sides
  compute the same tree; the Dirichlet ring is bit-exact everywhere,
  NaN payloads included.
"""

import contextlib
import dataclasses
import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu.ops.stencil import step_2d as jstep_2d
from parallel_heat_tpu.solver import grid_stats as jgrid_stats
from parallel_heat_tpu.solver import make_initial_grid as jmake
from parallel_heat_tpu.solver import solve_stream as jsolve_stream
from parallel_heat_tpu_torch import (EnsembleSolver, HeatConfig, convert,
                                     explain, solve, tune)
from parallel_heat_tpu_torch.ensemble.engine import packable
from parallel_heat_tpu_torch.ops import hopper_params
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH
from parallel_heat_tpu_torch.solver import (grid_stats, make_initial_grid,
                                            solve_stream)

BF16 = torch.bfloat16
SHAPE = (64, 256)
RAGGED = (37, 83)
RAGGED_UNI = (37, 88)        # ragged rows, rows of 16-byte multiples
COEFFS = [(0.1, 0.1), (0.1, 0.2)]
STORAGE_ULPS = 3
CARRY_ULPS = 1


def _rand(shape, seed):
    """Positive float32 values in [1, 100), made from a seed."""
    return np.random.default_rng(seed).uniform(1, 100, shape).astype(
        np.float32)


def _pair(u32):
    """The same bfloat16 grid for both packages."""
    return (jnp.asarray(u32).astype(jnp.bfloat16),
            torch.from_numpy(u32).to(BF16))


def _f32(x) -> np.ndarray:
    """float32 values of a JAX array or a torch tensor (exact for
    bfloat16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _ulps(got, want) -> float:
    """max |got - want| in bfloat16 ulps of each expected value."""
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def _close_res(got, want, acc, u32):
    """A residual against the JAX one: ``rtol=1e-4`` for a carried level,
    2 bfloat16 ulps of the grid's largest value for a stored one."""
    if acc:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    else:
        top = float(np.max(np.abs(u32)))
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        assert abs(float(got) - float(want)) <= 2 * ulp


def _bits(x) -> np.ndarray:
    """The bit pattern of a bfloat16 grid (JAX array or tensor)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _ring(a) -> list:
    return [a[0], a[-1], a[:, 0], a[:, -1]]


def _assert_ring(got, u):
    for g, w in zip(_ring(_bits(got)), _ring(_bits(u))):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Validation: the JAX package's rules and messages, and this slice's
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(accumulate="f64always"),
    dict(accumulate="f32chunk"),
    dict(nz=16, dtype="bfloat16", accumulate="f32chunk"),
    dict(nx=32, ny=32, dtype="bfloat16", mesh_shape=(2, 2),
         accumulate="f32chunk"),
    dict(nx=18, ny=18, cx=22.5, cy=22.5, dtype="bfloat16",
         scheme="backward_euler", accumulate="f32chunk"),
], ids=["bad-value", "f32-storage", "3d", "mesh", "implicit"])
def test_accumulate_validation_is_the_jax_packages(kw):
    # The counterparts of tests/test_accumulate.py's validation tests:
    # the same configs refused with the same messages.
    kw = {"nx": 16, "ny": 16, **kw}
    with pytest.raises(ValueError) as theirs:
        jx.HeatConfig(**kw).validate()
    with pytest.raises(ValueError) as ours:
        HeatConfig(**kw).validate()
    assert str(ours.value) == str(theirs.value)


def test_accumulate_and_dtypes_accepted_where_the_jax_package_takes_them():
    # (The JAX package takes float64 only in its x64 mode:
    # test_float64_matches_jax_under_x64.)
    for kw in (dict(dtype="bfloat16"), dict(dtype="float64"),
               dict(dtype="bfloat16", accumulate="f32chunk")):
        assert HeatConfig(nx=16, ny=16, **kw).validate().dtype == kw["dtype"]
        if kw["dtype"] != "float64":
            jx.HeatConfig(nx=16, ny=16, **kw).validate()


@pytest.mark.parametrize("kw", [
    dict(nz=8, dtype="bfloat16"),
    dict(nx=32, ny=32, dtype="bfloat16", mesh_shape=(2, 2)),
    dict(cx=22.5, cy=22.5, dtype="bfloat16", scheme="backward_euler"),
    dict(nz=8, dtype="float64"),
    dict(nx=32, ny=32, dtype="float64", mesh_shape=(2, 2)),
    dict(cx=22.5, cy=22.5, dtype="float64", scheme="crank_nicolson"),
    dict(nx=32, ny=32, nz=32, dtype="bfloat16", mesh_shape=(2, 2, 2)),
], ids=["bf16-3d", "bf16-mesh", "bf16-implicit", "f64-3d", "f64-mesh",
        "f64-implicit", "bf16-3d-mesh"])
def test_precision_refused_off_the_2d_single_block_path(kw):
    # Off the 2D single-block path nothing is refused any more: 3D on one
    # block, 2D and 3D meshes and the implicit schemes run, at both dtypes
    # (the implicit schemes on both backends: their transfer kernels see
    # float32 levels only; an explicit float64 run, on one block or a
    # mesh, on the torch route; bfloat16 on a 3D mesh on both, the cuda
    # rounds through the H family's bfloat16 forms).
    cfg = HeatConfig(**{"nx": 16, "ny": 16, **kw})
    backends = (("auto", "torch") if kw["dtype"] == "float64"
                and "scheme" not in kw else ("auto", "torch", "cuda"))
    for backend in backends:
        assert cfg.replace(backend=backend).validate().dtype == kw["dtype"]


def test_float64_runs_the_torch_route_and_refuses_backend_cuda():
    with pytest.raises(ValueError, match="backend='cuda' does not take"):
        HeatConfig(dtype="float64", backend="cuda").validate()
    # ... for the explicit scheme: an implicit step's kernels see float32.
    HeatConfig(cx=22.5, cy=22.5, dtype="float64", backend="cuda",
               scheme="backward_euler").validate()
    cfg = HeatConfig(nx=64, ny=64, dtype="float64")
    out = explain(cfg, device="cuda")
    assert out["backend"] == "torch" and "float64 storage" in out["path"]
    assert sk.pick_single_2d((64, 64), "float64") == ("torch", None)


def test_bfloat16_ensembles_are_refused():
    # On meshes: a 2D or 3D mesh runs bfloat16 solo, and the ensemble says
    # so (3D on one block runs: tests/test_torch_precision_3d.py).
    cfg = HeatConfig(nx=16, ny=16, steps=4, dtype="bfloat16", device="cpu")
    for kw, match in ((dict(nz=8, mesh_shape=(2, 2, 2)),
                       "mesh_shape configs run solo"),
                      (dict(nx=32, ny=32, mesh_shape=(2, 2)),
                       "mesh_shape configs run solo")):
        with pytest.raises(ValueError, match=match):
            EnsembleSolver(cfg.replace(**kw), 2)


def test_bfloat16_ensembles_run_in_2d():
    # A 2D stack runs, stays bfloat16, and is packable on the torch route.
    cfg = HeatConfig(nx=16, ny=16, steps=4, dtype="bfloat16", device="cpu")
    res = EnsembleSolver(cfg, 2).solve()
    assert res.grids.dtype == BF16 and res.steps_run.tolist() == [4, 4]
    ok, _ = packable(cfg)
    assert ok


# ---------------------------------------------------------------------------
# The decision site
# ---------------------------------------------------------------------------

def test_chunk_depth_is_the_jax_sublane_count():
    assert F32CHUNK_DEPTH == ps._sub_rows(jnp.bfloat16) == 16


@pytest.mark.parametrize("shape", [(32, 128), SHAPE, (128, 1024), RAGGED,
                                   (1000, 1000), (4096, 4100)])
def test_pick_never_chooses_single_step_kernels_under_f32chunk(shape):
    # A, B and C round every step: under f32chunk the picker takes E-uni
    # (rows of 16-byte multiples) or E, each chunk F32CHUNK_DEPTH steps,
    # whatever a pin or the launch depth says. I and I-uni carry their
    # levels in float32 too: a pin to either resolves, I-uni only on rows
    # of 16-byte multiples, each chunk F32CHUNK_DEPTH steps.
    kind, detail = sk.pick_single_2d(shape, "bfloat16", "f32chunk")
    want = "E-uni" if shape[1] % 8 == 0 else "E"
    assert (kind, detail["k"]) == (want, F32CHUNK_DEPTH)
    for pin in ("A", "B", "C", "I", "I-uni"):
        feasible = pin == "I" or (pin == "I-uni" and shape[1] % 8 == 0)
        with tune.force("single_2d", pin), warnings.catch_warnings(
                record=True) as seen:
            warnings.simplefilter("always")
            kind, detail = sk.pick_single_2d(shape, "bfloat16", "f32chunk")
        assert (kind, detail["k"]) == ((pin if feasible else want),
                                       F32CHUNK_DEPTH)
        assert any("infeasible" in str(w.message)
                   for w in seen) == (not feasible)


def test_pick_at_bfloat16_storage():
    # A's domain is float32's (its shared buffers hold float32); E-uni
    # needs widths of a multiple of 8 cells; B and C take a pin; so do I
    # and I-uni, I-uni where E-uni does.
    assert sk.pick_single_2d((1000, 1000), "bfloat16")[0] == "A"
    assert sk.pick_single_2d((4096, 4096), "bfloat16")[0] == "E-uni"
    assert sk.pick_single_2d((4096, 4100), "bfloat16")[0] == "E"
    assert sk.pick_single_2d((4096, 4100), "float32")[0] == "E-uni"
    for pin in ("B", "C"):
        with tune.force("single_2d", pin):
            assert sk.pick_single_2d((4096, 4096), "bfloat16")[0] == pin
    for pin in ("I", "I-uni"):
        with tune.force("single_2d", pin):
            kind, detail = sk.pick_single_2d((4096, 4096), "bfloat16")
            assert (kind, detail["k"]) == (
                pin, hopper_params.params().i_k_default)
    with tune.force("single_2d", "I-uni"), pytest.warns(
            RuntimeWarning, match="infeasible"):
        assert sk.pick_single_2d((4096, 4100), "bfloat16")[0] == "E"
    with tune.force("single_2d", "E"):
        assert sk.pick_single_2d((1000, 1000), "bfloat16")[0] == "E"


# ---------------------------------------------------------------------------
# Each new form's plain version against the JAX builder at bfloat16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("shape", [SHAPE, RAGGED], ids=["64x256", "37x83"])
def test_a_bf16_matches_heat_a_vmem_multistep(shape, k, cx, cy):
    u32 = _rand(shape, k)
    uj, ut = _pair(u32)
    want, wres = ps._build_vmem_multistep(shape, "bfloat16", cx, cy, k)(uj)
    out = torch.empty_like(ut)
    res = sk.resident_steps(ut, out, k, True, cx=cx, cy=cy)
    assert out.dtype == BF16
    assert _ulps(out, want) <= STORAGE_ULPS
    _close_res(res, wres, False, u32)
    _assert_ring(out, ut)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("acc", [False, True], ids=["storage", "acc_f32"])
@pytest.mark.parametrize("uni", [False, True], ids=["E", "E-uni"])
def test_e_bf16_matches_the_temporal_strips(uni, acc, k, cx, cy):
    # E (_build_temporal_strip :607) and E-uni
    # (_build_temporal_strip_uniform :832), storage and acc_f32.
    build = (ps._build_temporal_strip_uniform if uni
             else ps._build_temporal_strip)
    plain = sk.temporal_steps_uni_plain if uni else sk.temporal_steps_plain
    u32 = _rand(SHAPE, 10 + k)
    uj, ut = _pair(u32)
    want, wres = build(SHAPE, "bfloat16", cx, cy, k, acc_f32=acc)(uj)
    out = torch.empty_like(ut)
    res = plain(ut, out, k, True, cx=cx, cy=cy, acc_f32=acc)
    assert _ulps(out, want) <= (CARRY_ULPS if acc else STORAGE_ULPS)
    _close_res(res, wres, acc, u32)
    _assert_ring(out, ut)
    launch = sk.temporal_steps_uni if uni else sk.temporal_steps
    if k <= hopper_params.params().e_k_max() or acc:
        # The wrapper takes this depth, a carry chunk deeper than a launch
        # across a float32 level: on the CPU, the plain versions.
        if k > hopper_params.params().e_k_max():
            launch = sk._carry_chunks(functools.partial(launch, cx=cx, cy=cy))
        else:
            launch = functools.partial(launch, cx=cx, cy=cy, acc_f32=acc)
        again = torch.empty_like(ut)
        r2 = launch(ut, again, k, True)
        assert torch.equal(again.view(torch.int16), out.view(torch.int16))
        assert float(r2) == float(res)


@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("acc", [False, True], ids=["storage", "acc_f32"])
@pytest.mark.parametrize("uni", [False, True], ids=["E", "E-uni"])
def test_e_bf16_on_a_ragged_grid(uni, acc, k):
    # The JAX strips decline 37 rows (no whole sublane strips); A takes
    # the grid at the storage form's rounding points, and the chunk
    # function of f32chunk_jnp_multistep at the carry's (the textbook
    # tree, so a carried chunk may differ by its one rounding).
    shape = RAGGED_UNI if uni else RAGGED
    cx, cy = 0.1, 0.2
    assert ps._build_temporal_strip(shape, "bfloat16", cx, cy, k) is None
    u32 = _rand(shape, 20 + k)
    uj, ut = _pair(u32)
    if acc:
        want, wres = ps.f32chunk_jnp_multistep(shape, "bfloat16", cx,
                                               cy)[1](uj, k)
    else:
        want, wres = ps._build_vmem_multistep(shape, "bfloat16", cx, cy,
                                              k)(uj)
    launch = sk.temporal_steps_uni_plain if uni else sk.temporal_steps_plain
    out = torch.empty_like(ut)
    res = launch(ut, out, k, True, cx=cx, cy=cy, acc_f32=acc)
    assert _ulps(out, want) <= (CARRY_ULPS if acc else STORAGE_ULPS)
    _close_res(res, wres, acc, u32)
    _assert_ring(out, ut)


@pytest.mark.parametrize("k", [1, 9, 16])
def test_carry_across_a_float32_level_is_one_chunk(k):
    # A chunk in two launches (bfloat16 -> float32 level -> bfloat16) is
    # bitwise the chunk in one: the level carries every float32 bit.
    ut = _pair(_rand(SHAPE, 30))[1]
    one = torch.empty_like(ut)
    r1 = sk.temporal_steps_plain(ut, one, k, True, cx=0.1, cy=0.2,
                                 acc_f32=True)
    launch = sk._carry_chunks(functools.partial(sk.temporal_steps, cx=0.1,
                                                cy=0.2))
    two = torch.empty_like(ut)
    r2 = launch(ut, two, k, True)
    assert torch.equal(one.view(torch.int16), two.view(torch.int16))
    assert float(r1) == float(r2)


def test_forms_refuse_what_they_do_not_take():
    ut = _pair(_rand((20, 24), 1))[1]
    out = torch.empty_like(ut)
    with pytest.raises(ValueError, match="k must be in"):
        sk.temporal_steps(ut, out, 9, cx=0.1, cy=0.1)        # storage K
    with pytest.raises(ValueError, match="k must be in"):
        sk.temporal_steps(ut, out, 9, cx=0.1, cy=0.1, acc_f32=True)
    with pytest.raises(TypeError):
        sk.temporal_steps(ut, torch.empty(20, 24), 4, cx=0.1, cy=0.1)
    with pytest.raises(TypeError):                           # B and C:
        sk.strip_step(ut, torch.empty(20, 24), cx=0.1, cy=0.1)  # storage
    with pytest.raises(TypeError):                           # forms only
        sk.tiled_step(ut.float(), out, cx=0.1, cy=0.1)
    with pytest.raises(TypeError):                           # I: the
        sk.tile_temporal_steps(ut, torch.empty(20, 24), 4,   # forms' pairs
                               cx=0.1, cy=0.1)
    narrow = _pair(_rand((20, 20), 1))[1]
    with pytest.raises(ValueError, match="multiple of 8"):
        sk.temporal_steps_uni(narrow, torch.empty_like(narrow), 4, cx=0.1,
                              cy=0.1)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

def _jax_cfg(**kw):
    return jx.HeatConfig(**kw)


@pytest.mark.parametrize("steps", [17, 20, 37])
@pytest.mark.parametrize("accumulate", ["storage", "f32chunk"])
def test_torch_route_matches_jax_jnp_bitwise(accumulate, steps):
    kw = dict(nx=64, ny=256, steps=steps, dtype="bfloat16",
              accumulate=accumulate)
    theirs = jx.solve(_jax_cfg(backend="jnp", **kw)).grid
    ours = solve(HeatConfig(backend="torch", device="cpu", **kw)).grid
    assert ours.dtype == BF16
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def _oracle_f32chunk(u0, n, K):
    """tests/test_accumulate.py's hand-rolled chunk loop: K-step float32
    chunks, one rounding to storage per chunk."""
    v = jnp.asarray(u0)
    while n > 0:
        kk = min(K, n)
        w = v.astype(jnp.float32)
        for _ in range(kk):
            w = jstep_2d(w, 0.1, 0.1)
        v = w.astype(v.dtype)
        n -= kk
    return v


@pytest.mark.parametrize("steps", [16, 17, 20, 31, 33])
def test_f32chunk_rounds_every_16_steps_and_at_the_remainder(steps):
    # steps = 16q + r: q chunks of 16 and a remainder chunk of r that
    # rounds after r steps (17 = 16 + 1, a converge window of 20 = 16 + 4);
    # the torch route is bitwise the hand-rolled loop.
    cfg = HeatConfig(nx=40, ny=48, steps=steps, dtype="bfloat16",
                     accumulate="f32chunk", device="cpu", backend="torch")
    u0 = make_initial_grid(cfg)
    want = _oracle_f32chunk(jnp.asarray(u0.float().numpy()).astype(
        jnp.bfloat16), steps, 16)
    np.testing.assert_array_equal(_bits(solve(cfg).grid), _bits(want))


@pytest.mark.parametrize("k,launches", [
    (1, [("bf16", "bf16", 1, True)]),
    (8, [("bf16", "bf16", 8, True)]),
    (9, [("bf16", "f32", 8, False), ("f32", "bf16", 1, True)]),
    (16, [("bf16", "f32", 8, False), ("f32", "bf16", 8, True)]),
])
def test_carry_chunk_splits_at_the_default_depth(k, launches):
    # A chunk deeper than e_k_default runs as two launches across a
    # float32 level, the first e_k_default steps deep; only the last
    # rounds and computes the residual.
    assert hopper_params.params().e_k_default == 8
    seen = []
    name = {BF16: "bf16", torch.float32: "f32"}

    def launch(u, v, kk, want_res, acc_f32):
        assert acc_f32 and v.shape == u.shape
        seen.append((name[u.dtype], name[v.dtype], kk, want_res))

    ut = _pair(_rand((20, 24), 4))[1]
    sk._carry_chunks(launch)(ut, torch.empty_like(ut), k, True)
    assert seen == launches


@pytest.mark.parametrize("accumulate", ["storage", "f32chunk"])
def test_cuda_route_matches_jax_pallas(accumulate):
    kw = dict(nx=64, ny=256, steps=37, dtype="bfloat16",
              accumulate=accumulate)
    theirs = jx.solve(_jax_cfg(backend="pallas", **kw)).grid
    ours = solve(HeatConfig(backend="cuda", device="cpu", **kw)).grid
    np.testing.assert_allclose(_f32(ours), _f32(theirs), rtol=8e-3, atol=0)
    _assert_ring(ours, make_initial_grid(HeatConfig(device="cpu", **kw)))


def test_converge_on_the_plate_runs_to_the_cap_as_the_jax_package():
    # At bfloat16 the plate's values (to 1.6e7 at 128^2) have ulps far
    # above eps = 1e-3: the pre-rounding residual never falls below it,
    # and the run goes to its step cap. That is the contract, and both
    # packages stop at the same step.
    kw = dict(nx=128, ny=128, steps=400, converge=True, eps=1e-3,
              check_interval=20, dtype="bfloat16")
    theirs = jx.solve(_jax_cfg(backend="jnp", **kw))
    for backend in ("torch", "cuda"):
        ours = solve(HeatConfig(backend=backend, device="cpu", **kw))
        assert (ours.steps_run, ours.converged) == (
            theirs.steps_run, theirs.converged) == (400, False)
    ours = solve(HeatConfig(backend="torch", device="cpu", **kw))
    assert ours.residual == float(theirs.residual)
    np.testing.assert_array_equal(_bits(ours.grid), _bits(theirs.grid))


def test_f32chunk_converge_mode_matches_the_jax_package():
    # tests/test_accumulate.py's converge case: the residual is the last
    # step's pre-rounding float32 update; the torch route stops where JAX
    # jnp stops, the cuda route within three windows of it.
    kw = dict(nx=20, ny=128, steps=6000, converge=True, eps=1.0,
              check_interval=16, dtype="bfloat16", accumulate="f32chunk")
    theirs = jx.solve(_jax_cfg(backend="jnp", **kw))
    torch_route = solve(HeatConfig(backend="torch", device="cpu", **kw))
    cuda_route = solve(HeatConfig(backend="cuda", device="cpu", **kw))
    assert theirs.converged and torch_route.converged and cuda_route.converged
    assert torch_route.steps_run == theirs.steps_run
    assert abs(cuda_route.steps_run - theirs.steps_run) <= 48


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stream_misaligned_chunk_rounds_up_and_is_bitwise_solve(backend):
    kw = dict(nx=64, ny=256, steps=96, dtype="bfloat16",
              accumulate="f32chunk")
    cfg = HeatConfig(backend=backend, device="cpu", **kw)
    whole = solve(cfg).grid
    seen = [(r.steps_run, r.grid.clone()) for r in solve_stream(
        cfg, chunk_steps=10)]
    theirs = [r.steps_run for r in jsolve_stream(
        _jax_cfg(backend="jnp", **kw), chunk_steps=10)]
    assert [s for s, _ in seen] == theirs == [16, 32, 48, 64, 80, 96]
    assert torch.equal(seen[-1][1].view(torch.int16), whole.view(torch.int16))
    # Converge mode: the check windows already restart the carry where
    # the unchunked run does.
    kwc = dict(nx=32, ny=64, steps=64, converge=True, eps=1e-30,
               check_interval=4, dtype="bfloat16", accumulate="f32chunk")
    cfgc = HeatConfig(backend=backend, device="cpu", **kwc)
    lastc = list(solve_stream(cfgc, chunk_steps=10))[-1]
    assert torch.equal(lastc.grid.view(torch.int16),
                       solve(cfgc).grid.view(torch.int16))


@pytest.mark.parametrize("accumulate", ["storage", "f32chunk"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_ring_bit_exact_in_a_diverging_bf16_run(backend, accumulate):
    # cx = cy = 0.4 is past the stability bound: the interior blows up to
    # inf and NaN; the ring, seeded with a NaN of a payload no conversion
    # makes, keeps every bit.
    u32 = np.random.default_rng(3).standard_normal((16, 24)).astype(
        np.float32) * 10
    ut = torch.from_numpy(u32).to(BF16)
    ut.view(torch.int16)[0, 5] = 0x7FC1
    ut.view(torch.int16)[7, -1] = 0x7F81
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cfg = HeatConfig(nx=16, ny=24, cx=0.4, cy=0.4, steps=200,
                         dtype="bfloat16", accumulate=accumulate,
                         backend=backend, device="cpu")
        got = solve(cfg, initial=ut).grid
    assert not torch.isfinite(got[1:-1, 1:-1].float()).all()
    _assert_ring(got, ut)


def test_float64_matches_jax_under_x64():
    # float64 storage, float32 arithmetic on both sides (JAX in its x64
    # mode, where a float64 array stays float64). XLA:CPU's x64 program
    # was seen 1 float32 ulp off the eager textbook tree in 1.25% of the
    # cells after 37 steps, so rtol=1e-6 (8 float32 ulps); the initial
    # grid is bitwise, and the converge run stops at the same step.
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for kw in (dict(steps=37), dict(steps=400, converge=True, eps=1e-3,
                                       check_interval=20)):
            kw = dict(nx=40, ny=48, dtype="float64", **kw)
            theirs = jx.solve(_jax_cfg(backend="jnp", **kw))
            ours = solve(HeatConfig(device="cpu", **kw))
            assert ours.grid.dtype == torch.float64
            assert str(np.asarray(theirs.grid).dtype) == "float64"
            np.testing.assert_allclose(ours.to_numpy(),
                                       np.asarray(theirs.grid), rtol=1e-6,
                                       atol=0)
            assert (ours.steps_run, ours.converged) == (theirs.steps_run,
                                                        theirs.converged)
            init = np.asarray(jmake(_jax_cfg(**kw)))
            np.testing.assert_array_equal(
                make_initial_grid(HeatConfig(device="cpu", **kw)).numpy(),
                init)
    finally:
        jax.config.update("jax_enable_x64", was)


# ---------------------------------------------------------------------------
# Crossing over, the initial grid, the observers, explain
# ---------------------------------------------------------------------------

def test_initial_grid_bf16_is_the_jax_packages():
    for shape in ((20, 20), (33, 17), (300, 1000)):
        kw = dict(nx=shape[0], ny=shape[1], dtype="bfloat16")
        ours = make_initial_grid(HeatConfig(**kw), device="cpu")
        assert ours.dtype == BF16
        np.testing.assert_array_equal(_bits(ours),
                                      _bits(jmake(_jax_cfg(**kw))))


def test_from_jax_carries_a_bf16_grid_by_its_bits():
    kw = dict(nx=40, ny=48, dtype="bfloat16", accumulate="f32chunk")
    half = jx.solve(_jax_cfg(backend="jnp", steps=32, **kw))
    full = jx.solve(_jax_cfg(backend="jnp", steps=64, **kw))
    arr = np.asarray(half.grid)
    assert arr.dtype.name == "bfloat16"
    fields = dataclasses.asdict(_jax_cfg(backend="jnp", steps=32, **kw))
    cfg, grid = convert.from_jax(fields, arr, device="cpu")
    assert (cfg.dtype, cfg.accumulate, grid.dtype) == ("bfloat16",
                                                       "f32chunk", BF16)
    np.testing.assert_array_equal(_bits(grid), arr.view(np.int16))
    res = solve(cfg, initial=grid, device="cpu")
    np.testing.assert_array_equal(_bits(res.grid), _bits(full.grid))


def test_grid_stats_sum_bf16_in_float32():
    kw = dict(nx=64, ny=256, dtype="bfloat16")
    u = jmake(_jax_cfg(**kw))
    prev = jnp.asarray(_rand((64, 256), 4)).astype(jnp.bfloat16)
    theirs = jgrid_stats(u, prev)
    ut = make_initial_grid(HeatConfig(**kw), device="cpu")
    ours = grid_stats(ut, torch.from_numpy(_f32(prev)).to(BF16))
    assert ours["min"] == float(theirs["min"])
    assert ours["max"] == float(theirs["max"])
    for key in ("heat", "update_l2", "update_linf"):
        np.testing.assert_allclose(ours[key], float(theirs[key]), rtol=1e-6)


@pytest.mark.parametrize("kw,expect", [
    (dict(nx=1000, ny=1000), ("heat_a_resident_bf16", "bfloat16 storage")),
    (dict(nx=4096, ny=4096), ("heat_e_uni_temporal_bf16", "K=8")),
    (dict(nx=4096, ny=4100), ("heat_e_temporal_bf16", "widening load")),
    (dict(nx=4096, ny=4096, accumulate="f32chunk"),
     ("heat_e_uni_temporal_bf16", "float32 carry", "K=16")),
    (dict(nx=64, ny=100, accumulate="f32chunk"),
     ("heat_e_temporal_bf16", "K=16")),
    (dict(nx=4096, ny=4100, pin="I"),
     ("heat_i_tile_temporal_bf16", "bfloat16 storage", "K=8")),
    (dict(nx=4096, ny=4096, pin="I-uni", accumulate="f32chunk"),
     ("heat_i_uni_tile_temporal_bf16", "float32 carry", "K=16",
      "launches of at most 8")),
], ids=["A", "E-uni", "E", "E-uni-f32chunk", "E-f32chunk", "I-pinned",
        "I-uni-f32chunk-pinned"])
def test_explain_reports_the_precision_path(kw, expect):
    kw = dict(kw)
    pin = kw.pop("pin", None)
    with (tune.force("single_2d", pin) if pin
          else contextlib.nullcontext()):
        out = explain(HeatConfig(dtype="bfloat16", **kw), device="cuda")
    if pin:
        assert out["decided_by"]["single_2d"] == {"source": "forced",
                                                  "choice": pin}
    assert out["dtype"] == "bfloat16" and out["backend"] == "cuda"
    assert out["accumulate"] == kw.get("accumulate", "storage")
    assert all(e in out["path"] for e in expect), out["path"]
    assert ("chunk_depth" in out) == (out["accumulate"] == "f32chunk")
    if "chunk_depth" in out:
        assert out["chunk_depth"].startswith(f"{F32CHUNK_DEPTH} steps")


def test_plain_versions_use_the_kernels_rounding_points():
    # A storage level rounds before the next step reads it; a carried one
    # does not: two steps of the carry equal one chunk of the torch
    # route's order only up to the combine's form, but the carry's first
    # level is exactly the unrounded float32 step.
    ut = _pair(_rand((20, 24), 2))[1]
    a0, cx, cy = sk.coeffs_f32(0.1, 0.1)
    v = ut.float()
    want = v.clone()
    want[1:-1, 1:-1] = sk.combine_2d(v[1:-1, 1:-1], v[:-2, 1:-1], v[2:, 1:-1],
                                     v[1:-1, :-2], v[1:-1, 2:], a0, cx, cy)
    mid = torch.empty(20, 24)
    sk.temporal_steps(ut, mid, 1, False, cx=0.1, cy=0.1, acc_f32=True)
    assert torch.equal(mid, want)
    out = torch.empty_like(ut)
    sk.temporal_steps(ut, out, 1, False, cx=0.1, cy=0.1)
    assert torch.equal(out.view(torch.int16), want.to(BF16).view(torch.int16))
