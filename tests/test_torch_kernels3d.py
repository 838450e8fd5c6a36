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
        k = params().f_k_compiled + 1
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
                                    "segment": seg, "load": "tma"})
    # 32 x 128 extended tiles at K = 3: 26 x 120 output cells.
    assert (tile_y, tile_z) == (26, 120)
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
    block, rows, prefetch = p.f_shape(k)
    assert p.f_takes(block, rows, k)
    assert k <= p.f_k_max(block, rows, prefetch)
    tile_y, tile_z, seg = p.f_launch(shape, k, block, rows)
    wy, wz = p.f_extent(block, rows)
    assert (wy, wz) == (block[1] * rows, 128)
    # K rows a side along Y; K rounded up to a group of 4 along Z, so a
    # tile's box starts on 16 bytes.
    assert (tile_y, tile_z) == (wy - 2 * k, wz - 2 * (-(-k // 4) * 4))
    assert (tile_y, tile_z) == p.f_tile(k, block, rows)
    assert tile_z % 4 == 0 and p.f_pad(k) % 4 == 0 and p.f_pad(k) >= k
    assert seg >= p.f_seg_planes_min
    blocks = -(-shape[1] // tile_y) * -(-shape[2] // tile_z) \
        * -(-shape[0] // seg)
    assert blocks < 2 ** 31
    assert (p.f_smem_bytes(k, block, rows, prefetch) + p.static_smem_bytes
            <= p.smem_per_block_max)


def test_hopper_params_3d_budget():
    p = params()
    assert 1 <= p.f_k_default <= p.f_k_max() <= p.f_k_compiled
    lanes, warps = p.f_block
    assert lanes == 32 and p.f_rows in (1, 2, 4)
    assert warps <= (8 if p.f_rows == 4 else 16)
    assert p.f_takes(p.f_block, p.f_rows, p.f_k_default)
    assert 1 <= p.f_prefetch <= p.f_prefetch_max
    assert p.d_block[0] * p.d_block[1] % 32 == 0
    assert (p.f_smem_bytes(p.f_k_max()) + p.static_smem_bytes
            <= p.smem_per_block_max)
    assert (p.f_smem_bytes(p.f_k_max() + 1) + p.static_smem_bytes
            > p.smem_per_block_max)
    # Every compiled depth has a launch shape: the default's up to its
    # deepest K, a deeper one past it.
    for k in range(1, p.f_k_compiled + 1):
        block, rows, prefetch = p.f_shape(k)
        assert p.f_takes(block, rows, k)
        assert k <= p.f_k_max(block, rows, prefetch)
        if k <= p.f_k_max():
            assert (block, rows, prefetch) == (p.f_block, p.f_rows,
                                               p.f_prefetch)
        else:
            assert (block, rows) in p.f_deep_shapes
        assert p.f_launch((64, 64, 64), k)[:2] == p.f_tile(k, block, rows)
    assert p.f_shape(p.f_k_compiled + 1) is None


# (lanes, warps), rows, K, taken: the shape rule of csrc/heat_temporal3d.cuh
# heat_f_takes, which hopper_params.f_takes restates (chip_smoke.py holds
# the C launcher to f_takes on the card).
F_SHAPE_TABLE = [
    ((32, 16), 2, 3, True), ((32, 8), 4, 3, True), ((32, 16), 1, 7, True),
    ((32, 1), 4, 1, True), ((32, 12), 2, 8, True), ((32, 8), 4, 8, True),
    ((32, 16), 4, 3, False),   # 4 rows: at most 8 warps
    ((32, 17), 2, 3, False),   # at most 16 warps
    ((64, 8), 2, 3, False),    # a warp spans the tile's 128 cells
    ((32, 8), 3, 3, False),    # 1, 2 or 4 rows
    ((32, 4), 1, 2, False),    # no output row: 2K = W R
    ((32, 2), 2, 2, False),
    ((32, 8), 4, 9, False),    # compiled depths 1 .. 8
    ((32, 8), 4, 0, False),
    ((32, 0), 2, 1, False),
]


@pytest.mark.parametrize("block,rows,k,taken", F_SHAPE_TABLE,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_f_shape_rule(block, rows, k, taken):
    assert params().f_takes(block, rows, k) == taken


def test_f_shape_rule_is_the_launchers():
    # The constants of the C rule, read from its source: 32 lanes, the
    # warps a block of `rows` rows may have, the compiled depths.
    from pathlib import Path

    src = (Path(sk3.__file__).parents[1] / "csrc"
           / "heat_temporal3d.cuh").read_text()
    assert "constexpr int kFLanes = 32;" in src
    assert "constexpr int kFWidth = 4 * kFLanes;" in src
    assert f"constexpr int kFMaxK = {params().f_k_compiled};" in src
    assert (f"constexpr int kFMaxPrefetch = {params().f_prefetch_max};"
            in src)
    assert "return rows == 4 ? 8 : elem == 2 && k >= 4 ? 12 : 16;" in src
    p = params()
    assert [p.f_max_warps(r) for r in (1, 2, 4)] == [16, 16, 8]
    assert [p.f_max_warps(r, 4, 2) for r in (1, 2, 4)] == [12, 12, 8]
    assert p.f_max_warps(2, 3, 2) == 16
    assert params().f_width == 128


@pytest.mark.parametrize("shape,load", [
    ((512, 512, 512), "tma"), ((512, 512, 508), "tma"),
    ((67, 130, 204), "tma"), ((5, 3, 300), "tma"), ((3, 3, 4), "tma"),
    ((67, 130, 201), "cp.async"), ((512, 512, 510), "cp.async"),
    ((3, 3, 3), "cp.async"), ((1291, 1299, 1301), "cp.async"),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_f_load_is_chosen_by_nz(shape, load):
    # TMA needs 16-byte strides: nz % 4 == 0.
    assert sk3.f_load(shape) == load
    assert params().f_tma_fits(shape) == (load == "tma")
    assert sk3.pick_single_3d(shape)[1]["load"] == load
    from parallel_heat_tpu_torch import HeatConfig
    from parallel_heat_tpu_torch.solver import explain

    cfg = HeatConfig(nx=shape[0], ny=shape[1], nz=shape[2], steps=6,
                     backend="cuda")
    assert f"load={load}" in explain(cfg, device="cpu")["path"]
    # A grid at an address that is not a multiple of 16 bytes takes the
    # cp.async load whatever its shape.
    thin = (3,) + shape[1:]
    base = torch.zeros(int(np.prod(thin)) + 1)
    assert sk3.f_load(thin, base[1:].view(thin)) == "cp.async"
    assert sk3.f_load(thin, base[:-1].view(thin)) == load


def test_xslab_load_argument():
    u = torch.from_numpy(_rand((6, 5, 7), seed=4))
    out = torch.empty_like(u)
    sk.reset_counts()
    with pytest.raises(ValueError, match="TMA load needs nz % 4 == 0"):
        sk3.xslab_steps_3d(u, out, 2, load="tma", cx=0.1, cy=0.1, cz=0.1)
    with pytest.raises(ValueError, match="load must be one of"):
        sk3.xslab_steps_3d(u, out, 2, load="bulk", cx=0.1, cy=0.1, cz=0.1)
    assert all(n == 0 for n in sk.counts.values())
    # On the CPU every load runs the plain version.
    u8 = torch.from_numpy(_rand((6, 5, 8), seed=4))
    got = {}
    for load in (None, "tma", "cp.async"):
        o = torch.empty_like(u8)
        r = sk3.xslab_steps_3d(u8, o, 3, load=load, cx=0.1, cy=0.1, cz=0.1)
        got[load] = (o, float(r))
    assert sk.counts["xslab_steps_3d_plain"] == 3
    for load in ("tma", "cp.async"):
        assert torch.equal(got[load][0], got[None][0])
        assert got[load][1] == got[None][1]


def test_h_parameters_are_not_moved_by_f():
    # The sharded 3D kernels keep their own launch shapes and budgets:
    # the values before F's plane loop had its own parameters.
    p = params()
    assert p.h_extent() == (64, 32)
    assert p.h_prefetch == 6 and p.h_tma_prefetch == 4
    assert p.h_k_max() == 8
    assert [p.h_tma_smem_bytes(k) for k in range(1, 9)] == [
        58544, 78000, 97456, 116912, 136368, 155824, 175280, 194736]
    assert [p.h_smem_bytes(k) for k in range(1, 9)] == [
        67584, 84480, 101376, 118272, 135168, 152064, 168960, 185856]
    assert [p.h_launch((512, 512, 512), k, 512) for k in range(1, 9)] == [
        74, 74, 86, 103, 103, 103, 128, 171]
    assert p.h_tma_box() == (64, 36)
    assert p.h_tiles((512, 512, 512), 3) == (126, 54)
    assert [p.h_k_max(b, r) for b, r in [((32, 16), 4), ((32, 8), 2),
                                         ((64, 4), 4), ((64, 8), 1)]] == [
        8, 7, 7, 3]


def test_explain_names_f_its_k_tile_and_load():
    from parallel_heat_tpu_torch import HeatConfig
    from parallel_heat_tpu_torch.solver import explain

    p = params()
    path = explain(HeatConfig(nx=512, ny=512, nz=512, steps=10,
                              backend="cuda"), device="cpu")["path"]
    k = p.f_k_default
    ty, tz = p.f_tile(k)
    wy, wz = p.f_extent()
    assert path.startswith("kernel F (heat_f_temporal3d")
    assert f"K={k}" in path and f"tile={ty}x{tz}" in path
    assert f"block={p.f_block[0]}x{p.f_block[1]} rows={p.f_rows}" in path
    assert f"load=tma (one {wy}x{wz} (Y, Z) box a plane)" in path
    with tune.force("single_3d", "D"):
        path = explain(HeatConfig(nx=512, ny=512, nz=511, steps=10,
                                  backend="cuda"), device="cpu")["path"]
    assert path.startswith("kernel D (heat_d_step3d")


def _tile_kinds_brute(shape, k, block, rows):
    p = params()
    _, ny, nz = shape
    wy, wz = p.f_extent(block, rows)
    ty, tz = p.f_tile(k, block, rows)
    tiles = []
    for a in range(-(-ny // ty)):
        for c in range(-(-nz // tz)):
            y0, z0 = a * ty - k, c * tz - p.f_pad(k)
            ys = [y for y in range(y0, y0 + wy)]
            zs = [z for z in range(z0, z0 + wz)]
            tiles.append(all(1 <= y <= ny - 2 for y in ys)
                         and all(1 <= z <= nz - 2 for z in zs))
    return len(tiles), sum(tiles)


@pytest.mark.parametrize("shape,k", [((5, 512, 512), 3), ((5, 130, 204), 1),
                                     ((5, 130, 201), 6), ((5, 3, 300), 3),
                                     ((5, 70, 252), 3)])
def test_f_tile_kinds_count_the_tiles(shape, k):
    p = params()
    block, rows, _ = p.f_shape(k)
    kinds = p.f_tile_kinds(shape, k, block, rows)
    tiles, interior = _tile_kinds_brute(shape, k, block, rows)
    assert kinds["tiles"] == tiles
    assert kinds["interior"] == interior
    assert kinds["edge"] == tiles - interior
    assert kinds["top"] == -(-shape[2] // p.f_tile(k, block, rows)[1])
