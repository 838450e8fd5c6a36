"""Kernels D and F of the PyTorch port against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the
CUDA kernels ``heat_d_step3d`` and ``heat_f_temporal3d`` are held
bitwise to those versions on the card by ``chip_smoke.py`` and
``tests/test_torch_card.py``). Here the plain versions are held to the
JAX package's Pallas kernels ``heat_d_slab_3d`` and ``heat_f_xslab_3d``,
run in interpret mode at the shapes ``tests/test_pallas.py`` runs them,
on the same seeded numpy inputs, with cx = cy = cz and with
cx, cy, cz = 0.1, 0.15, 0.05 (so any swap of axes cannot pass).

Tolerances: ``rtol=1e-5, atol=1e-5`` on grids and ``rtol=1e-4`` on
residuals — the few-ulp contract of ``tests/test_pallas.py`` (both sides
evaluate the factored combine, but XLA:CPU may contract multiply-adds
into FMAs where eager PyTorch rounds every operation, and a residual, a
difference of nearly equal values, magnifies those ulps). The six faces
are held bit-exact, plain F(K) bitwise to K plain D steps, and a NaN
must reach the residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params

COEFFS = [(0.1, 0.1, 0.1), (0.1, 0.15, 0.05)]
FACES = (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
         np.s_[:, :, -1])


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10).astype(np.float32)


def _kw(coeffs):
    return dict(zip(("cx", "cy", "cz"), coeffs))


def _close_grid(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _close_res(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def _assert_faces_exact(got, u):
    g, w = np.asarray(got), np.asarray(u)
    for sl in FACES:
        np.testing.assert_array_equal(g[sl], w[sl])


@pytest.mark.parametrize("coeffs", COEFFS)
def test_slab_step_3d_matches_heat_d_slab_3d(coeffs):
    shape = (16, 48, 128)  # tests/test_pallas.py's kernel D shape
    u = _rand(shape, seed=7)
    fn = ps._build_slab_kernel_3d(shape, "float32", *coeffs)
    want, wres = fn(jnp.asarray(u))
    out = torch.empty(shape, dtype=torch.float32)
    res = sk3.slab_step_3d(torch.from_numpy(u), out, **_kw(coeffs))
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_faces_exact(out.numpy(), u)


@pytest.mark.parametrize("with_residual", [True, False])
@pytest.mark.parametrize("coeffs", COEFFS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_xslab_steps_3d_matches_heat_f_xslab_3d(k, coeffs, with_residual):
    shape = (24, 16, 128)  # tests/test_pallas.py's kernel F shape
    u = _rand(shape, seed=8)
    fn = ps._build_xslab_3d(shape, "float32", *coeffs, 8, k, with_residual)
    want, wres = fn(jnp.asarray(u))
    out = torch.empty(shape, dtype=torch.float32)
    res = sk3.xslab_steps_3d(torch.from_numpy(u), out, k, with_residual,
                             **_kw(coeffs))
    _close_grid(out.numpy(), want)
    _assert_faces_exact(out.numpy(), u)
    if with_residual:
        _close_res(res, wres)
    else:
        assert res is None


@pytest.mark.parametrize("coeffs", COEFFS)
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_plain_f_is_k_plain_d_steps_bitwise(k, coeffs):
    u = torch.from_numpy(_rand((13, 9, 21), seed=5))
    out = torch.empty_like(u)
    res = sk3.xslab_steps_3d_plain(u, out, k, **_kw(coeffs))
    src, dst = u.clone(), torch.empty_like(u)
    for _ in range(k):
        rd = sk3.slab_step_3d_plain(src, dst, **_kw(coeffs))
        src, dst = dst, src
    assert torch.equal(out, src)
    assert float(res) == float(rd)


@pytest.mark.parametrize("n", [10, 16, 5])
def test_chunked_multistep_3d_matches_xslab_multistep(n):
    # The port's K-step chunks (K = f_k_default) against the JAX
    # package's (its own K): the same n steps, so the same grid and the
    # last step's residual; only the pass holding the last step reduces.
    shape = (24, 16, 128)
    u = _rand(shape, seed=9)
    multi_step_j, run_j = ps._xslab_multistep_3d(shape, "float32", 0.1, 0.1,
                                                 0.1)
    want, wres = run_j(jnp.asarray(u), n)
    calls = []

    def temporal(a, b, k, want_res):
        calls.append((k, want_res))
        return sk3.xslab_steps_3d(a, b, k, want_res, cx=0.1, cy=0.1, cz=0.1)

    K = params().f_k_default
    multi_step, multi_step_residual = sk._chunked_multistep(temporal, K)
    t = torch.from_numpy(u.copy())
    got, _, res = multi_step_residual(t, torch.empty_like(t), n)
    _close_grid(got.numpy(), want)
    _close_res(res, wres)
    kk = min(K, n)
    full, rem = divmod(n, kk)
    expect = [(kk, False)] * full + ([(rem, False)] if rem else [])
    expect[-1] = (expect[-1][0], True)
    assert calls == expect
    t2 = torch.from_numpy(u.copy())
    got2, _ = multi_step(t2, torch.empty_like(t2), n)
    assert torch.equal(got, got2)


def test_single_grid_multistep_3d_picks_and_chunks():
    from parallel_heat_tpu_torch import HeatConfig

    cfg = HeatConfig(nx=12, ny=10, nz=14, steps=7, backend="cuda",
                     device="cpu")
    u = torch.from_numpy(_rand(cfg.shape, seed=12))
    runs = {}
    for choice in ("F", "D", "torch"):
        sk.reset_counts()
        with tune.force("single_3d", choice):
            multi_step, multi_step_residual = sk3.single_grid_multistep_3d(
                cfg)
        a = u.clone()
        got, _, res = multi_step_residual(a, torch.empty_like(a), 7)
        runs[choice] = (got.clone(), float(res), dict(sk.counts))
    k = params().f_k_default
    assert runs["F"][2]["xslab_steps_3d_plain"] == -(-7 // k)
    assert runs["D"][2]["slab_step_3d_plain"] == 7
    assert torch.equal(runs["F"][0], runs["D"][0])
    assert runs["F"][1] == runs["D"][1]
    # The textbook stencil agrees to a few ulp, not bitwise.
    _close_grid(runs["torch"][0].numpy(), runs["F"][0].numpy())


def test_nan_residual_propagates_3d():
    u = _rand((16, 48, 128), seed=6)
    u[8, 7, 30] = np.nan
    fn = ps._build_slab_kernel_3d((16, 48, 128), "float32", 0.1, 0.1, 0.1)
    _, wres = fn(jnp.asarray(u))
    assert np.isnan(float(wres))  # the JAX kernel's semantics
    kw = dict(cx=0.1, cy=0.1, cz=0.1)
    launches = [lambda t, o: sk3.slab_step_3d(t, o, **kw)]
    for k in (1, 3):
        launches.append(lambda t, o, k=k: sk3.xslab_steps_3d(t, o, k, **kw))
    for launch in launches:
        out = torch.empty(u.shape, dtype=torch.float32)
        res = launch(torch.from_numpy(u), out)
        assert np.isnan(float(res))
        _assert_faces_exact(out.numpy(), u)


def test_3d_wrappers_count_their_calls_on_the_cpu():
    u = torch.from_numpy(_rand((6, 5, 7), seed=3))
    sk.reset_counts()
    sk3.slab_step_3d(u, torch.empty_like(u), cx=0.1, cy=0.1, cz=0.1)
    sk3.xslab_steps_3d(u, torch.empty_like(u), 2, cx=0.1, cy=0.1, cz=0.1)
    assert sk3.counts is sk.counts
    assert sk.counts["heat_d_step3d"] == sk.counts["heat_f_temporal3d"] == 0
    assert sk.counts["slab_step_3d_plain"] == 1
    assert sk.counts["xslab_steps_3d_plain"] == 1


@pytest.mark.parametrize("case", ["dtype", "shape", "alias", "strided",
                                  "device", "small", "rank", "k"])
def test_3d_wrappers_reject_bad_inputs(case):
    u = torch.zeros((6, 5, 7))
    out = torch.empty_like(u)
    k = 2
    if case == "dtype":
        u = u.double()
    elif case == "shape":
        out = torch.empty((6, 5, 8))
    elif case == "alias":
        out = u
    elif case == "strided":
        u = torch.zeros((6, 5, 14))[:, :, ::2]
    elif case == "device":
        u = torch.zeros((6, 5, 7), device="meta")
    elif case == "small":
        u, out = torch.zeros((6, 2, 7)), torch.empty((6, 2, 7))
    elif case == "rank":
        u, out = torch.zeros((6, 5)), torch.empty((6, 5))
    elif case == "k":
        k = params().f_k_max() + 1
    sk.reset_counts()
    with pytest.raises((TypeError, ValueError)):
        sk3.xslab_steps_3d(u, out, k, cx=0.1, cy=0.1, cz=0.1)
    with pytest.raises((TypeError, ValueError)):
        sk3.xslab_steps_3d(u, out, 0 if case == "k" else k, cx=0.1, cy=0.1,
                           cz=0.1)
    if case != "k":
        with pytest.raises((TypeError, ValueError)):
            sk3.slab_step_3d(u, out, cx=0.1, cy=0.1, cz=0.1)
    assert all(n == 0 for n in sk.counts.values())


def test_pick_single_3d_default_and_forced():
    p = params()
    kind, detail = sk3.pick_single_3d((512, 512, 512))
    tile_y, tile_z, seg = p.f_launch((512, 512, 512), p.f_k_default)
    assert (kind, detail) == ("F", {"k": p.f_k_default,
                                    "tile": (tile_y, tile_z),
                                    "block": p.f_block, "rows": p.f_rows,
                                    "segment": seg})
    # F's tiled design takes every grid of 3^3 and more.
    for shape in [(3, 3, 3), (5, 3, 300), (67, 130, 201)]:
        assert sk3.pick_single_3d(shape)[0] == "F"
    with tune.force("single_3d", "D"):
        assert sk3.pick_single_3d((512, 512, 512)) == (
            "D", {"block": p.d_block, "planes": p.d_planes})
    with tune.force("single_3d", "torch"):
        assert sk3.pick_single_3d((8, 8, 8)) == ("torch", None)
    # The 2D site does not pin the 3D one.
    with tune.force("single_2d", "B"):
        assert sk3.pick_single_3d((8, 8, 8))[0] == "F"
    for shape in [(8, 8), (8, 2, 8)]:
        with pytest.raises(ValueError, match="3D grid"):
            sk3.pick_single_3d(shape)
    with pytest.raises(ValueError):
        with tune.force("single_3d", "E"):
            pass


@pytest.mark.parametrize("shape", [(512, 512, 512), (3, 3, 3), (5, 3, 300),
                                   (67, 130, 201), (1291, 1299, 1301)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_f_launch_covers_the_grid_within_the_card(shape, k):
    p = params()
    tile_y, tile_z, seg = p.f_launch(shape, k)
    wy, wz = p.f_extent()
    assert (wy, wz) == (p.f_block[1] * p.f_rows, p.f_block[0])
    assert (tile_y, tile_z) == (wy - 2 * k, wz - 2 * k)
    assert seg >= p.f_seg_planes_min
    blocks = -(-shape[1] // tile_y) * -(-shape[2] // tile_z) \
        * -(-shape[0] // seg)
    assert blocks < 2 ** 31
    assert p.f_smem_bytes(k) + p.static_smem_bytes <= p.smem_per_block_max


def test_hopper_params_3d_budget():
    p = params()
    assert 1 <= p.f_k_default <= p.f_k_max() <= p.f_k_compiled
    bz, by = p.f_block
    assert bz % 32 == 0 and bz * by <= 512 and p.f_rows in (1, 2, 4)
    assert p.d_block[0] * p.d_block[1] % 32 == 0
    assert (p.f_smem_bytes(p.f_k_max()) + p.static_smem_bytes
            <= p.smem_per_block_max)
