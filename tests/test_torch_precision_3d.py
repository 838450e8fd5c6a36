"""The precision contract of the port in 3D on one block against the JAX
package: bfloat16 storage in kernels D and F, float64 on the torch route,
and both in 3D ensembles (``SEMANTICS.md`` "Precision").

On the CPU the wrappers of ``heat_d_step3d_bf16`` and
``heat_f_temporal3d_bf16`` run their plain versions, which round where
the kernels round (``chip_smoke.py`` and ``tests/test_torch_card.py``
hold the kernels bitwise to them on the card). Inputs are made with
numpy from a seed and handed to both packages as the same bfloat16 bits.
The tolerances are ``tests/test_torch_precision.py``'s, in bfloat16 ulps
of each cell's expected value:

- the plain versions against the JAX Pallas builders
  ``_build_slab_kernel_3d`` and ``_build_xslab_3d`` in interpret mode:
  **3 ulps** (storage mode: every level rounds, and XLA:CPU may contract a
  multiply and an add where eager PyTorch rounds each); a residual is the
  last step's float32 update less the bfloat16 level it read, so **2 ulps
  of the grid's largest value**, absolute;
- the torch route against the JAX jnp path: **0 ulps** (the textbook
  tree, compiled without contraction, at the same rounding points);
- whole runs of the cuda route against the JAX package's own pick (its
  F, or its jnp path, whose textbook tree differs from the kernels'
  factored combine): ``rtol=2e-2, atol=2.0``, the JAX package's own 3D
  bfloat16 cross-path contract (``tests/test_pallas3d_sharded.py``
  ``BF16_TOL``); in converge mode the same stop window where both sides
  compute the same tree, within one window of the jnp path's;
- ``grid_stats``: min and max exact, the float32 sums (``heat``,
  ``update_l2``) ``rtol=1e-4``: two sums of 49,152 cells in different
  orders (JAX's reduction tree, torch's) differ by about sqrt(n) float32
  ulps;
- float64 (float64 storage, float32 arithmetic) against the JAX jnp path
  under x64: ``rtol=1e-6`` (8 float32 ulps, as in 2D), and against
  ``tests/oracle.py``'s float64 steps within the float32 arithmetic's
  few ulps (``rtol=1e-5``);
- ``steps_run`` and ``converged`` identical; the six Dirichlet faces bit
  for bit everywhere, NaN payloads included; F at depth K bitwise K
  steps of D.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import oracle
import parallel_heat_tpu as jx
from parallel_heat_tpu.ensemble.engine import packable as jpackable
from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu.solver import make_initial_grid as jmake
from parallel_heat_tpu_torch import (EnsembleSolver, HeatConfig, explain,
                                     solve, tune)
from parallel_heat_tpu_torch.ensemble.engine import packable
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.solver import (grid_stats, make_initial_grid,
                                            solve_stream)

from test_torch_precision import (BF16, STORAGE_ULPS, _bits, _close_res,
                                  _f32, _pair, _ulps)

COEFFS3 = [(0.1, 0.1, 0.1), (0.1, 0.15, 0.05)]
F_SHAPE = (24, 16, 128)      # the JAX F takes it (Z % 128 == 0), K to 8
NAN_BITS = (0x7FC1, -64, 0x7F81)   # -64 is 0xFFC0


def _rand3(shape, seed):
    """Positive float32 values in [1, 100), made from a seed."""
    return np.random.default_rng(seed).uniform(1, 100, shape).astype(
        np.float32)


def _faces(a) -> list:
    return [a[0], a[-1], a[:, 0], a[:, -1], a[:, :, 0], a[:, :, -1]]


def _assert_faces(got, u):
    for g, w in zip(_faces(_bits(got)), _faces(_bits(u))):
        np.testing.assert_array_equal(g, w)


def _nan_seeded(shape, seed):
    """A bfloat16 grid with NaNs of payloads no conversion makes, inside
    and on the faces."""
    ut = torch.from_numpy(_rand3(shape, seed)).to(BF16)
    bits = ut.view(torch.int16)
    nx, ny, nz = shape
    for at, b in zip(((nx // 2, ny // 2, nz // 3), (0, ny // 2, nz // 2),
                      (nx // 2, ny - 1, 1)), NAN_BITS):
        bits[at] = b
    return ut


def _steps_of_d(u, k, cx, cy, cz):
    """``k`` steps of D's plain version: the grid and the last residual."""
    src, dst = u.clone(), torch.empty_like(u)
    for _ in range(k):
        res = sk3.slab_step_3d_plain(src, dst, cx=cx, cy=cy, cz=cz)
        src, dst = dst, src
    return src, res


# ---------------------------------------------------------------------------
# D's and F's bfloat16 forms against the JAX builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cx,cy,cz", COEFFS3)
@pytest.mark.parametrize("shape", [(16, 48, 128), (24, 48, 256)])
def test_d_bf16_matches_the_slab_builder(shape, cx, cy, cz):
    # D (_build_slab_kernel_3d :3708) at bfloat16, one step.
    u32 = _rand3(shape, sum(shape))
    uj, ut = _pair(u32)
    want, wres = ps._build_slab_kernel_3d(shape, "bfloat16", cx, cy, cz)(uj)
    out = torch.full(shape, float("nan"), dtype=BF16)
    res = sk3.slab_step_3d_plain(ut, out, cx=cx, cy=cy, cz=cz)
    assert out.dtype == BF16 and str(want.dtype) == "bfloat16"
    assert _ulps(out, want) <= STORAGE_ULPS
    _close_res(res, wres, False, u32)
    _assert_faces(out, ut)
    # The wrapper on the CPU is its plain version, bit for bit.
    again = torch.full_like(out, float("nan"))
    r2 = sk3.slab_step_3d(ut, again, cx=cx, cy=cy, cz=cz)
    np.testing.assert_array_equal(_bits(again), _bits(out))
    assert float(r2) == float(res)


@pytest.mark.parametrize("cx,cy,cz", COEFFS3)
@pytest.mark.parametrize("k", [1, 3, 8])
def test_f_bf16_matches_the_xslab_builder(k, cx, cy, cz):
    # F (_build_xslab_3d :3932) at bfloat16, slabs of 8 planes: every
    # level stored in bfloat16 on both sides.
    u32 = _rand3(F_SHAPE, 20 + k)
    uj, ut = _pair(u32)
    want, wres = ps._build_xslab_3d(F_SHAPE, "bfloat16", cx, cy, cz, 8,
                                    k)(uj)
    out = torch.full(F_SHAPE, float("nan"), dtype=BF16)
    res = sk3.xslab_steps_3d_plain(ut, out, k, True, cx=cx, cy=cy, cz=cz)
    assert out.dtype == BF16
    assert _ulps(out, want) <= STORAGE_ULPS
    _close_res(res, wres, False, u32)
    _assert_faces(out, ut)
    again = torch.full_like(out, float("nan"))
    r2 = sk3.xslab_steps_3d(ut, again, k, True, cx=cx, cy=cy, cz=cz)
    np.testing.assert_array_equal(_bits(again), _bits(out))
    assert float(r2) == float(res)


@pytest.mark.parametrize("shape", [F_SHAPE, (9, 13, 21), (5, 3, 300)])
@pytest.mark.parametrize("k", range(1, 9))
def test_f_bf16_is_k_steps_of_d_bf16(k, shape):
    ut = torch.from_numpy(_rand3(shape, k) - 50).to(BF16)
    kw = dict(cx=0.1, cy=0.15, cz=0.05)
    out = torch.full_like(ut, float("nan"))
    res = sk3.xslab_steps_3d_plain(ut, out, k, True, **kw)
    chain, rd = _steps_of_d(ut, k, **kw)
    np.testing.assert_array_equal(_bits(out), _bits(chain))
    assert float(res) == float(rd)
    nores = torch.empty_like(ut)
    assert sk3.xslab_steps_3d_plain(ut, nores, k, False, **kw) is None
    np.testing.assert_array_equal(_bits(nores), _bits(out))


def test_plain_versions_round_every_level():
    # A level below K rounds to bfloat16 before the next one reads it:
    # two steps are one step applied to the rounded first level, and the
    # residual is the float32 update against the level it read.
    ut = torch.from_numpy(_rand3((9, 10, 12), 4)).to(BF16)
    kw = dict(cx=0.1, cy=0.1, cz=0.1)
    first = torch.empty_like(ut)
    sk3.slab_step_3d_plain(ut, first, **kw)
    assert first.dtype == BF16
    two, second = torch.empty_like(ut), torch.empty_like(ut)
    res2 = sk3.xslab_steps_3d_plain(ut, two, 2, True, **kw)
    res1 = sk3.slab_step_3d_plain(first, second, **kw)
    np.testing.assert_array_equal(_bits(two), _bits(second))
    assert float(res2) == float(res1)


def test_wrappers_count_their_plain_versions_on_the_cpu():
    ut = torch.from_numpy(_rand3((9, 10, 16), 5)).to(BF16)
    out = torch.empty_like(ut)
    sk.reset_counts()
    sk3.slab_step_3d(ut, out, cx=0.1, cy=0.1, cz=0.1)
    sk3.xslab_steps_3d(ut, out, 3, True, cx=0.1, cy=0.1, cz=0.1)
    ran = {k: n for k, n in sk.counts.items() if n}
    assert ran == {"slab_step_3d_plain": 1, "xslab_steps_3d_plain": 1}
    assert sk.kernel_entry("D", BF16) == "heat_d_step3d_bf16"
    assert sk.kernel_entry("F", "bfloat16") == "heat_f_temporal3d_bf16"
    assert sk.kernel_entry("F", "float32") == "heat_f_temporal3d"
    assert {"heat_d_step3d_bf16", "heat_f_temporal3d_bf16"} <= set(sk.counts)


def test_faces_bit_exact_with_nan_payloads():
    ut = _nan_seeded((12, 14, 40), 6)
    kw = dict(cx=0.1, cy=0.1, cz=0.1)
    for k in (1, 3, 8):
        out = torch.empty_like(ut)
        res = sk3.xslab_steps_3d(ut, out, k, True, **kw)
        assert np.isnan(float(res))
        _assert_faces(out, ut)
    out = torch.empty_like(ut)
    assert np.isnan(float(sk3.slab_step_3d(ut, out, **kw)))
    _assert_faces(out, ut)
    # In a diverging run (past the stability bound) too, on both routes.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for backend in ("cuda", "torch"):
            got = solve(HeatConfig(nx=12, ny=14, nz=40, cx=0.3, cy=0.3,
                                   cz=0.3, steps=120, dtype="bfloat16",
                                   backend=backend, device="cpu"),
                        initial=ut).grid
            assert not torch.isfinite(got[1:-1, 1:-1, 1:-1].float()).all()
            _assert_faces(got, ut)


def test_wrappers_refuse_what_they_do_not_take():
    kw = dict(cx=0.1, cy=0.1, cz=0.1)
    u = torch.zeros((6, 6, 204), dtype=BF16)
    with pytest.raises(ValueError, match="nz % 8 == 0"):
        sk3.xslab_steps_3d(u, torch.empty_like(u), 3, load="tma", **kw)
    # float32 takes TMA at nz = 204: its rows are 16-byte multiples.
    sk3.xslab_steps_3d(u.float(), torch.empty(u.shape), 3, load="tma", **kw)
    for a, b in ((u, torch.empty(u.shape)), (u.double(), u.double()),
                 (u.float(), torch.empty_like(u))):
        with pytest.raises(TypeError):
            sk3.slab_step_3d(a, b.clone(), **kw)
        with pytest.raises(TypeError):
            sk3.xslab_steps_3d(a, b.clone(), 3, **kw)


# ---------------------------------------------------------------------------
# F's geometry at 2-byte cells
# ---------------------------------------------------------------------------

def test_f_geometry_by_element_size():
    p = params()
    # The halo along Z: 16 bytes of cells, so K <= 8 pads 8 bfloat16 cells
    # and the output tile is 112 wide, against 120 at float32 for K <= 4.
    assert [p.f_pad(k) for k in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert [p.f_pad(k, 2) for k in (1, 4, 5, 8)] == [8, 8, 8, 8]
    assert p.f_tile(3) == (26, 120) and p.f_tile(3, elem=2) == (26, 112)
    # bfloat16 ring planes take half the bytes; the levels stay float32.
    f32, bf16 = p.f_smem_bytes(3), p.f_smem_bytes(3, elem=2)
    slots = (p.f_prefetch + 2) * (32 + 2) * 128
    assert f32 - bf16 == 2 * slots
    # The shapes are the float32 twins' but at K = 4, where the default
    # 16 warps exceed the bfloat16 form's bound (12 warps at 1 or 2 rows,
    # K >= 4) and the first deep shape takes it.
    assert p.f_max_warps(2, 3, 2) == 16 and p.f_max_warps(2, 4, 2) == 12
    assert p.f_max_warps(2, 4) == 16 and p.f_max_warps(4, 8, 2) == 8
    assert not p.f_takes((32, 16), 2, 4, elem=2) and p.f_takes((32, 16), 2, 4)
    assert p.f_takes((32, 12), 2, 4, elem=2)
    assert p.f_k_max(elem=2) == 3 and p.f_k_max() == 4
    for k in range(1, 9):
        if k != 4:
            assert p.f_shape(k, 2)[:2] == p.f_shape(k)[:2]
    assert p.f_shape(4, 2)[:2] == ((32, 8), 4)
    assert p.f_tma_fits((4, 4, 204)) and not p.f_tma_fits((4, 4, 204),
                                                          "bfloat16")
    assert p.f_tma_fits((4, 4, 200), "bfloat16")
    assert p.f_tma_fits((4, 4, 200), BF16)
    assert sk3.f_load((512,) * 3, dtype="bfloat16") == "tma"
    assert sk3.f_load((67, 130, 204), dtype="bfloat16") == "cp.async"
    assert sk3.f_load((67, 130, 204)) == "tma"
    u = torch.empty((4, 4, 204), dtype=BF16)
    assert sk3.f_load(u.shape, u) == "cp.async"
    assert sk3.f_load(u.shape, u.float()) == "tma"
    assert p.f_launch((512,) * 3, 3, elem=2)[:2] == (26, 112)


# ---------------------------------------------------------------------------
# The decision site and explain
# ---------------------------------------------------------------------------

def test_pick_single_3d_at_each_dtype():
    shape = (512, 512, 512)
    kind, detail = sk3.pick_single_3d(shape, "bfloat16")
    assert kind == "F" and detail["tile"] == (26, 112)
    assert detail["load"] == "tma"
    assert sk3.pick_single_3d((64, 64, 204), BF16)[1]["load"] == "cp.async"
    assert sk3.pick_single_3d((64, 64, 204))[1]["load"] == "tma"
    assert sk3.pick_single_3d(shape)[1]["tile"] == (26, 120)
    assert sk3.pick_single_3d(shape, "float64") == ("torch", None)
    with tune.force("single_3d", "D"):
        assert sk3.pick_single_3d(shape, "bfloat16")[0] == "D"
        assert sk3.pick_single_3d(shape, "float64") == ("torch", None)
    # The JAX picker takes F at 512^3 too (its feasibility: Z % 128 == 0);
    # the port's F takes every grid, so its picker has no jnp fallback.
    assert ps.pick_single_3d(shape, "bfloat16")[0] == "F"


@pytest.mark.parametrize("dtype,pin,expect", [
    ("bfloat16", None, ("heat_f_temporal3d_bf16", "bfloat16 storage",
                        "tile=26x112", "load=tma")),
    ("bfloat16", "D", ("heat_d_step3d_bf16", "bfloat16 storage")),
    ("float32", None, ("heat_f_temporal3d,", "tile=26x120")),
    ("float64", None, ("textbook torch stencil", "float64 storage")),
], ids=["bf16-F", "bf16-D", "f32-F", "f64"])
def test_explain_reports_the_3d_precision_path(dtype, pin, expect):
    cfg = HeatConfig(nx=512, ny=512, nz=512, dtype=dtype)
    if pin:
        with tune.force("single_3d", pin):
            out = explain(cfg, device="cuda")
    else:
        out = explain(cfg, device="cuda")
    assert out["dtype"] == dtype
    assert out["backend"] == ("torch" if dtype == "float64" else "cuda")
    assert all(e in out["path"] for e in expect), out["path"]
    ragged = explain(HeatConfig(nx=67, ny=130, nz=204, dtype="bfloat16"),
                     device="cuda")["path"]
    assert "nz % 8 == 0" in ragged and "load=cp.async" in ragged


# ---------------------------------------------------------------------------
# Validation: what runs and what stays refused
# ---------------------------------------------------------------------------

def test_3d_bf16_and_float64_validate_on_one_block():
    for dtype in ("bfloat16", "float64"):
        cfg = HeatConfig(nx=8, ny=8, nz=8, dtype=dtype).validate()
        assert cfg.dtype == dtype
    jx.HeatConfig(nx=8, ny=8, nz=8, dtype="bfloat16").validate()


@pytest.mark.parametrize("kw,match", [
    (dict(dtype="bfloat16", mesh_shape=(2, 2, 2)), None),
    (dict(dtype="float64", mesh_shape=(2, 2, 2), backend="cuda"),
     "backend='cuda' does not take"),
    (dict(dtype="bfloat16", mesh_shape=(1, 2, 1)), None),
    (dict(dtype="bfloat16", accumulate="f32chunk"), "2D-only"),
    (dict(dtype="float64", backend="cuda"), "backend='cuda' does not take"),
], ids=["bf16-mesh", "f64-mesh", "bf16-mesh-1d", "f32chunk", "f64-cuda"])
def test_refusals_that_stay_in_3d(kw, match):
    # bfloat16 on 3D meshes (match None) validates on both backends; the
    # others stay refused.
    cfg = HeatConfig(nx=8, ny=8, nz=8, **kw)
    if match is None:
        for backend in ("auto", "torch", "cuda"):
            assert cfg.replace(backend=backend).validate().dtype == \
                "bfloat16"
        return
    with pytest.raises(ValueError, match=match):
        cfg.validate()


def test_f32chunk_in_3d_is_refused_with_the_jax_message():
    kw = dict(nx=8, ny=8, nz=8, dtype="bfloat16", accumulate="f32chunk")
    with pytest.raises(ValueError) as theirs:
        jx.HeatConfig(**kw).validate()
    with pytest.raises(ValueError) as ours:
        HeatConfig(**kw).validate()
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Whole runs against the JAX package
# ---------------------------------------------------------------------------

def test_initial_grid_3d_is_the_jax_packages():
    for shape in ((8, 9, 10), (24, 16, 128)):
        kw = dict(nx=shape[0], ny=shape[1], nz=shape[2], dtype="bfloat16")
        ours = make_initial_grid(HeatConfig(**kw), device="cpu")
        assert ours.dtype == BF16
        np.testing.assert_array_equal(_bits(ours),
                                      _bits(jmake(jx.HeatConfig(**kw))))


@pytest.mark.parametrize("steps", [17, 37])
def test_torch_route_3d_bf16_matches_jax_jnp_bitwise(steps):
    kw = dict(nx=12, ny=14, nz=20, steps=steps, dtype="bfloat16")
    theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw)).grid
    ours = solve(HeatConfig(backend="torch", device="cpu", **kw)).grid
    assert ours.dtype == BF16
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


@pytest.mark.parametrize("shape", [F_SHAPE, (20, 18, 40)],
                         ids=["jax-F", "jax-jnp"])
def test_cuda_route_3d_bf16_matches_the_jax_package(shape):
    # F's plain version against the JAX package's own pick: its F in
    # interpret mode where Z % 128 == 0, else its jnp path.
    kw = dict(nx=shape[0], ny=shape[1], nz=shape[2], steps=37,
              dtype="bfloat16")
    jcfg = jx.HeatConfig(**kw)
    assert ps.pick_single_3d(shape, "bfloat16")[0] == (
        "F" if shape[2] % 128 == 0 else "jnp")
    theirs = jx.solve(jcfg)
    sk.reset_counts()
    ours = solve(HeatConfig(backend="cuda", device="cpu", **kw))
    assert sk.counts["xslab_steps_3d_plain"] > 0
    assert ours.grid.dtype == BF16 and ours.steps_run == theirs.steps_run
    np.testing.assert_allclose(_f32(ours.grid), _f32(theirs.grid),
                               rtol=2e-2, atol=2.0)
    _assert_faces(ours.grid, make_initial_grid(HeatConfig(device="cpu",
                                                          **kw)))
    # Pinned D is bitwise the F run.
    with tune.force("single_3d", "D"):
        pinned = solve(HeatConfig(backend="cuda", device="cpu", **kw))
    np.testing.assert_array_equal(_bits(pinned.grid), _bits(ours.grid))


def test_converge_3d_bf16_runs_to_the_cap_as_the_jax_package():
    # The plate's bfloat16 ulps dwarf eps: the pre-rounding residual never
    # falls below it, and both packages stop at the cap, in the same
    # window.
    kw = dict(nx=24, ny=16, nz=128, steps=200, converge=True, eps=1e-3,
              check_interval=20, dtype="bfloat16")
    theirs = jx.solve(jx.HeatConfig(**kw))
    jnp_run = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    runs = {b: solve(HeatConfig(backend=b, device="cpu", **kw))
            for b in ("cuda", "torch")}
    with tune.force("single_3d", "D"):
        runs["D"] = solve(HeatConfig(backend="cuda", device="cpu", **kw))
    for r in runs.values():
        assert (r.steps_run, r.converged) == (
            theirs.steps_run, theirs.converged) == (200, False)
    np.testing.assert_array_equal(_bits(runs["D"].grid),
                                  _bits(runs["cuda"].grid))
    assert runs["D"].residual == runs["cuda"].residual
    assert runs["torch"].residual == float(jnp_run.residual)
    np.testing.assert_array_equal(_bits(runs["torch"].grid),
                                  _bits(jnp_run.grid))


@pytest.mark.parametrize("shape,eps", [(F_SHAPE, 1e-2), (F_SHAPE, 3e-2),
                                       ((20, 18, 40), 1e-2)],
                         ids=["jax-F-1e-2", "jax-F-3e-2", "jax-jnp-1e-2"])
def test_converge_3d_bf16_stops_where_the_jax_package_stops(shape, eps):
    # The plate scaled to a peak of 10 (ulps below eps): the residual
    # falls under eps after several windows. The torch route stops in the
    # JAX jnp path's window; the cuda route in the JAX package's own
    # pick's where that is F (the same tree), within one window of its jnp
    # path's otherwise.
    from parallel_heat_tpu_torch.models import HeatPlate3D

    plate = HeatPlate3D(*shape).init_grid_np(np.float64)
    uj, ut = _pair((plate / plate.max() * 10).astype(np.float32))
    kw = dict(nx=shape[0], ny=shape[1], nz=shape[2], steps=4000,
              converge=True, eps=eps, check_interval=20, dtype="bfloat16")
    jax_f = ps.pick_single_3d(shape, "bfloat16")[0] == "F"
    for jb, ob in (("jnp", "torch"), ("auto", "cuda")):
        theirs = jx.solve(jx.HeatConfig(backend=jb, **kw), initial=uj)
        ours = solve(HeatConfig(backend=ob, device="cpu", **kw),
                     initial=ut)
        assert theirs.converged and ours.converged
        assert theirs.steps_run > 3 * kw["check_interval"]
        if ob == "torch" or jax_f:
            assert ours.steps_run == theirs.steps_run
        else:
            assert abs(ours.steps_run - theirs.steps_run) <= 20
    # The stream of the same run is bitwise solve().
    cfg = HeatConfig(backend="cuda", device="cpu", **kw)
    last = list(solve_stream(cfg, initial=ut, chunk_steps=100))[-1]
    whole = solve(cfg, initial=ut)
    assert (last.steps_run, last.converged) == (whole.steps_run,
                                                whole.converged)
    np.testing.assert_array_equal(_bits(last.grid), _bits(whole.grid))


@pytest.mark.parametrize("chunk", [10, 40])
def test_stream_3d_bf16_is_bitwise_solve(chunk):
    cfg = HeatConfig(nx=12, ny=14, nz=20, steps=80, dtype="bfloat16",
                     backend="cuda", device="cpu")
    whole = solve(cfg).grid
    seen = [(r.steps_run, r.grid.clone()) for r in solve_stream(
        cfg, chunk_steps=chunk)]
    assert [s for s, _ in seen] == list(range(chunk, 81, chunk))
    np.testing.assert_array_equal(_bits(seen[-1][1]), _bits(whole))


def test_grid_stats_3d_sum_bf16_in_float32():
    from parallel_heat_tpu.solver import grid_stats as jgrid_stats

    kw = dict(nx=24, ny=16, nz=128, dtype="bfloat16")
    u = jmake(jx.HeatConfig(**kw))
    uj, ut = _pair(_rand3((24, 16, 128), 4))
    theirs = jgrid_stats(u, uj)
    ours = grid_stats(make_initial_grid(HeatConfig(**kw), device="cpu"), ut)
    assert ours["min"] == float(theirs["min"])
    assert ours["max"] == float(theirs["max"])
    assert ours["update_linf"] == float(theirs["update_linf"])
    for key in ("heat", "update_l2"):
        np.testing.assert_allclose(ours[key], float(theirs[key]), rtol=1e-4)


def test_float64_3d_matches_jax_under_x64_and_the_oracle():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for kw in (dict(steps=37), dict(steps=400, converge=True, eps=1e-3,
                                       check_interval=20)):
            kw = dict(nx=12, ny=14, nz=20, dtype="float64", **kw)
            theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw))
            ours = solve(HeatConfig(device="cpu", **kw))
            assert ours.grid.dtype == torch.float64
            assert str(np.asarray(theirs.grid).dtype) == "float64"
            np.testing.assert_allclose(ours.to_numpy(),
                                       np.asarray(theirs.grid), rtol=1e-6,
                                       atol=0)
            assert (ours.steps_run, ours.converged) == (theirs.steps_run,
                                                        theirs.converged)
            np.testing.assert_array_equal(
                make_initial_grid(HeatConfig(device="cpu", **kw)).numpy(),
                np.asarray(jmake(jx.HeatConfig(**kw))))
    finally:
        jax.config.update("jax_enable_x64", was)
    # Against the float64 oracle: float32 arithmetic's few ulps.
    cfg = HeatConfig(nx=12, ny=14, nz=20, steps=37, dtype="float64",
                     device="cpu")
    u = make_initial_grid(cfg).numpy()
    want = u.copy()
    for _ in range(37):
        want = oracle.step3d(want)
    got = solve(cfg).to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Ensembles: the vmap route at bfloat16 and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,backend", [
    ("bfloat16", "auto"), ("bfloat16", "torch"), ("bfloat16", "cuda"),
    ("float64", "auto"), ("float64", "torch")])
def test_3d_ensembles_run_on_vmap_member_bitwise(dtype, backend):
    # (backend="cuda" refuses float64: test_refusals_that_stay_in_3d.)
    cfg = HeatConfig(nx=10, ny=12, nz=14, steps=23, dtype=dtype,
                     backend=backend, device="cpu")
    gen = np.random.default_rng(5)
    inits = torch.from_numpy(gen.uniform(0, 50, (3, 10, 12, 14))).to(
        BF16 if dtype == "bfloat16" else torch.float64)
    es = EnsembleSolver(cfg, 3)
    assert es.path == "vmap"
    res = es.solve(initials=inits)
    assert res.grids.dtype == inits.dtype
    assert res.steps_run.tolist() == [23] * 3
    for i in range(3):
        one = solve(cfg.replace(backend="torch"), initial=inits[i])
        np.testing.assert_array_equal(
            res.grids[i].view(torch.int16 if dtype == "bfloat16"
                              else torch.int64).numpy(),
            one.grid.view(torch.int16 if dtype == "bfloat16"
                          else torch.int64).numpy())
    # initial_grids in the config's dtype.
    assert es.initial_grids().dtype == inits.dtype


@pytest.mark.parametrize("backend,jbackend", [("torch", "jnp"),
                                              ("cuda", "pallas")])
def test_3d_packable_is_the_jax_packages(backend, jbackend):
    for dtype in ("bfloat16", "float32"):
        kw = dict(nx=10, ny=12, nz=14, steps=5, dtype=dtype)
        ok, _ = packable(HeatConfig(backend=backend, device="cpu", **kw))
        jok, _ = jpackable(jx.HeatConfig(backend=jbackend, **kw))
        assert ok == jok == (backend == "torch")
    ok, _ = packable(HeatConfig(nx=10, ny=12, nz=14, dtype="float64",
                                device="cpu"))
    assert ok


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_cli_3d_precision_writes_the_jax_clis_npy(tmp_path, capsys, dtype):
    # --nz with --dtype: the .npy of the JAX CLI's torch-route twin (its
    # jnp path), bit for bit at bfloat16 ('<V2' cells); at float64 (JAX
    # under x64) the same header and values within rtol=1e-6, this file's
    # float64 contract. The cuda route's .npy is its solve() grid's bytes.
    from parallel_heat_tpu import cli as jcli
    from parallel_heat_tpu_torch import cli

    base = ["--nx", "12", "--ny", "14", "--nz", "20", "--steps", "37",
            "--dtype", dtype]
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        for name, main, tail in (
                ("ours", cli.main, ["--device", "cpu", "--backend",
                                    "torch"]),
                ("theirs", jcli.main, ["--backend", "jnp"]),
                ("cuda", cli.main, ["--device", "cpu", "--backend",
                                    "cuda" if dtype == "bfloat16"
                                    else "auto"])):
            rc = main(base + tail + ["--out", str(tmp_path / f"{name}.npy")])
            out = capsys.readouterr()
            assert rc == 0, out.err
    finally:
        jax.config.update("jax_enable_x64", was)
    ours = (tmp_path / "ours.npy").read_bytes()
    theirs = (tmp_path / "theirs.npy").read_bytes()
    if dtype == "bfloat16":
        assert ours == theirs and b"'<V2'" in ours[:128]
    else:
        a, b = (np.load(tmp_path / f"{n}.npy") for n in ("ours", "theirs"))
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    grid = solve(HeatConfig(nx=12, ny=14, nz=20, steps=37, dtype=dtype,
                            device="cpu", backend="cuda" if dtype ==
                            "bfloat16" else "auto")).grid
    body = (tmp_path / "cuda.npy").read_bytes()[-grid.numel()
                                                 * grid.element_size():]
    assert body == grid.contiguous().view(
        torch.int16 if dtype == "bfloat16" else torch.int64).numpy().tobytes()
