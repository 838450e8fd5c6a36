"""Kernels A, B, C, E, E-uni, I and I-uni of the PyTorch port against the
JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the
CUDA kernels are held bitwise to those versions on the card by
``chip_smoke.py``). Here the plain versions are held to the JAX
package's Pallas kernels ``heat_a_vmem_multistep``, ``heat_b_strip``,
``heat_c_tiled``, ``heat_e_temporal_strip``,
``heat_e_uni_temporal_strip``, ``heat_i_tile_temporal`` and
``heat_i_uni_tile_temporal``, run in interpret mode as
``tests/test_pallas.py`` runs them, on the same seeded numpy inputs,
with equal coefficients and with cx != cy (so a swap of the two axes
cannot pass).

Tolerances: ``rtol=1e-5, atol=1e-5`` on grids and ``rtol=1e-4`` on
residuals — the few-ulp contract of ``tests/test_pallas.py``. Both sides
evaluate the factored combine, but XLA:CPU may contract multiply-adds
into FMAs where eager PyTorch rounds every operation; a residual is a
difference of nearly equal values, which magnifies those ulps. The
Dirichlet boundary is held bit-exact, plain A(K), E(K), E-uni(K), I(K)
and I-uni(K) bitwise to K plain B steps, plain C bitwise to plain B, and
a NaN must reach the residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params

CX = CY = 0.1
SHAPES = [(64, 128), (96, 128)]
COEFFS = [(0.1, 0.1), (0.1, 0.2)]


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10).astype(np.float32)


def _close_grid(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _close_res(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def _assert_boundary_exact(got, u):
    g, w = np.asarray(got), np.asarray(u)
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(g[sl], w[sl])


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", SHAPES)
def test_strip_step_matches_heat_b_strip(shape, cx, cy):
    u = _rand(shape, seed=1)
    fn, _ = ps._build_strip_kernel(shape, "float32", cx, cy, shape,
                                   sharded=False)
    want, wres = fn(jnp.asarray(u), 0, 0)
    out = torch.empty(shape, dtype=torch.float32)
    res = sk.strip_step(torch.from_numpy(u), out, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_boundary_exact(out.numpy(), u)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 8])
def test_temporal_steps_matches_heat_e_temporal_strip(k, shape, cx, cy):
    u = _rand(shape, seed=3)
    fn = ps._build_temporal_strip(shape, "float32", cx, cy, k)
    want, wres = fn(jnp.asarray(u))
    out = torch.empty(shape, dtype=torch.float32)
    res = sk.temporal_steps(torch.from_numpy(u), out, k, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_boundary_exact(out.numpy(), u)
    # The residual-free variant computes the same grid.
    out2 = torch.empty(shape, dtype=torch.float32)
    assert sk.temporal_steps(torch.from_numpy(u), out2, k, False,
                             cx=cx, cy=cy) is None
    assert torch.equal(out, out2)


@pytest.mark.parametrize("cx,cy", COEFFS)
def test_tiled_step_matches_heat_c_tiled(cx, cy):
    shape = (32, 2048)  # two column chunks of the JAX kernel's tiles
    u = _rand(shape, seed=2)
    fn, _ = ps._build_tiled_kernel(shape, "float32", cx, cy, shape,
                                   sharded=False)
    want, wres = fn(jnp.asarray(u), 0, 0)
    out = torch.empty(shape, dtype=torch.float32)
    res = sk.tiled_step(torch.from_numpy(u), out, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_boundary_exact(out.numpy(), u)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [1, 3, 8])
def test_temporal_steps_uni_matches_heat_e_uni_temporal_strip(k, shape, cx,
                                                              cy):
    u = _rand(shape, seed=9)
    fn = ps._build_temporal_strip_uniform(shape, "float32", cx, cy, k)
    want, wres = fn(jnp.asarray(u))
    out = torch.empty(shape, dtype=torch.float32)
    res = sk.temporal_steps_uni(torch.from_numpy(u), out, k, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_boundary_exact(out.numpy(), u)
    out2 = torch.empty(shape, dtype=torch.float32)
    assert sk.temporal_steps_uni(torch.from_numpy(u), out2, k, False,
                                 cx=cx, cy=cy) is None
    assert torch.equal(out, out2)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", [(64, 256), (96, 128)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_tile_temporal_steps_match_heat_i_tile_temporal(k, shape, cx, cy,
                                                        uniform):
    u = _rand(shape, seed=11)
    if uniform:
        fn = ps._build_tile_temporal_2d_uniform(shape, "float32", cx, cy, k)
        launch = sk.tile_temporal_steps_uni
    else:
        fn = ps._build_tile_temporal_2d(shape, "float32", cx, cy, k)
        launch = sk.tile_temporal_steps
    want, wres = fn(jnp.asarray(u))
    out = torch.empty(shape, dtype=torch.float32)
    res = launch(torch.from_numpy(u), out, k, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_boundary_exact(out.numpy(), u)
    out2 = torch.empty(shape, dtype=torch.float32)
    assert launch(torch.from_numpy(u), out2, k, False, cx=cx, cy=cy) is None
    assert torch.equal(out, out2)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [1, 4, 20])
def test_resident_steps_matches_heat_a_vmem_multistep(k, shape, cx, cy):
    # k = 20 is one converge window of the default check_interval, the
    # chunk one launch of A advances on the main path.
    u = _rand(shape, seed=8)
    fn = ps._build_vmem_multistep(shape, "float32", cx, cy, k)
    want, wres = fn(jnp.asarray(u))
    out = torch.empty(shape, dtype=torch.float32)
    res = sk.resident_steps(torch.from_numpy(u), out, k, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _assert_boundary_exact(out.numpy(), u)
    out2 = torch.empty(shape, dtype=torch.float32)
    assert sk.resident_steps(torch.from_numpy(u), out2, k, False,
                             cx=cx, cy=cy) is None
    assert torch.equal(out, out2)


@pytest.mark.parametrize("n", [20, 16, 5])
def test_chunked_multistep_matches_temporal_multistep(n):
    # n = 20 is two K=8 passes plus a remainder pass; 16 is exactly two
    # passes; 5 is one short pass. The residual is the last step's.
    shape = (64, 128)
    u = _rand(shape, seed=4)
    multi_step_j, run_j = ps._temporal_multistep(shape, "float32", CX, CY)
    want, wres = run_j(jnp.asarray(u), n)
    calls = []

    def temporal(a, b, k, want_res):
        calls.append((k, want_res))
        return sk.temporal_steps(a, b, k, want_res, cx=CX, cy=CY)

    multi_step, multi_step_residual = sk._chunked_multistep(temporal, 8)
    t = torch.from_numpy(u.copy())
    got, spare, res = multi_step_residual(t, torch.empty_like(t), n)
    _close_grid(got.numpy(), want)
    _close_res(res, wres)
    # Only the pass holding the chunk's last step reduces the residual.
    kk = min(8, n)
    full, rem = divmod(n, kk)
    expect = [(kk, False)] * full + ([(rem, False)] if rem else [])
    expect[-1] = (expect[-1][0], True)
    assert calls == expect
    t2 = torch.from_numpy(u.copy())
    got2, _ = multi_step(t2, torch.empty_like(t2), n)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("plain", ["temporal_steps_plain",
                                   "resident_steps_plain",
                                   "temporal_steps_uni_plain",
                                   "tile_temporal_steps_plain",
                                   "tile_temporal_steps_uni_plain"])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_plain_e_is_k_plain_b_steps_bitwise(k, plain):
    u = torch.from_numpy(_rand((37, 53), seed=5))
    out = torch.empty_like(u)
    res = getattr(sk, plain)(u, out, k, cx=CX, cy=0.2)
    src, dst = u.clone(), torch.empty_like(u)
    for _ in range(k):
        rb = sk.strip_step_plain(src, dst, cx=CX, cy=0.2)
        src, dst = dst, src
    assert torch.equal(out, src)
    assert float(res) == float(rb)


def test_plain_c_is_plain_b_bitwise():
    u = torch.from_numpy(_rand((37, 53), seed=10))
    out, want = torch.empty_like(u), torch.empty_like(u)
    res = sk.tiled_step_plain(u, out, cx=CX, cy=0.2)
    rb = sk.strip_step_plain(u, want, cx=CX, cy=0.2)
    assert torch.equal(out, want) and float(res) == float(rb)


def test_nan_residual_propagates():
    u = _rand((64, 128), seed=6)
    u[20, 30] = np.nan
    fn, _ = ps._build_strip_kernel((64, 128), "float32", CX, CY, (64, 128),
                                   sharded=False)
    _, wres = fn(jnp.asarray(u), 0, 0)
    assert np.isnan(float(wres))  # the JAX kernel's semantics
    launches = [lambda t, o: sk.strip_step(t, o, cx=CX, cy=CY),
                lambda t, o: sk.tiled_step(t, o, cx=CX, cy=CY)]
    for k in (1, 8):
        launches += [
            lambda t, o, k=k: sk.temporal_steps(t, o, k, cx=CX, cy=CY),
            lambda t, o, k=k: sk.temporal_steps_uni(t, o, k, cx=CX, cy=CY),
            lambda t, o, k=k: sk.tile_temporal_steps(t, o, k, cx=CX, cy=CY),
            lambda t, o, k=k: sk.tile_temporal_steps_uni(t, o, k, cx=CX,
                                                         cy=CY),
            lambda t, o, k=k: sk.resident_steps(t, o, k, cx=CX, cy=CY)]
    for launch in launches:
        out = torch.empty(u.shape, dtype=torch.float32)
        res = launch(torch.from_numpy(u), out)
        assert np.isnan(float(res))
        _assert_boundary_exact(out.numpy(), u)


def test_wrappers_count_their_calls_on_the_cpu():
    u = torch.from_numpy(_rand((16, 16), seed=7))
    sk.reset_counts()
    sk.strip_step(u, torch.empty_like(u), cx=CX, cy=CY)
    sk.temporal_steps(u, torch.empty_like(u), 3, cx=CX, cy=CY)
    sk.resident_steps(u, torch.empty_like(u), 30, cx=CX, cy=CY)
    sk.tiled_step(u, torch.empty_like(u), cx=CX, cy=CY)
    sk.temporal_steps_uni(u, torch.empty_like(u), 2, cx=CX, cy=CY)
    sk.tile_temporal_steps(u, torch.empty_like(u), 2, cx=CX, cy=CY)
    sk.tile_temporal_steps_uni(u, torch.empty_like(u), 2, cx=CX, cy=CY)
    u3 = torch.from_numpy(_rand((6, 5, 7), seed=7))
    sk3.slab_step_3d(u3, torch.empty_like(u3), cx=CX, cy=CY, cz=0.05)
    sk3.xslab_steps_3d(u3, torch.empty_like(u3), 2, cx=CX, cy=CY, cz=0.05)
    from parallel_heat_tpu_torch.ops import batched, multigrid

    ub = torch.from_numpy(_rand((2, 9, 11), seed=8))
    batched.ensemble_steps(ub, torch.empty_like(ub), 2, cx=CX, cy=CY)
    multigrid.prolong(multigrid.restrict(ub, (5, 6)), (9, 11))
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    mesh = HeatMesh((2, 1))
    us = mesh.split(torch.from_numpy(_rand((16, 8), seed=9)))
    tail, hn, hs = temporal.exchange_halos_fused_2d(mesh, us, 2)[0]
    ext = temporal.exchange_halos_circular_2d(mesh, us, 2)[0]
    kw = dict(origin=(0, 0), grid_shape=(16, 8), cx=CX, cy=CY)
    out = torch.empty(8, 8)
    skb.block_fused(us[0], tail, hn, hs, out, 2, **kw)
    skb.block_uniform(us[0], tail, None, None, out, 2, **kw)
    skb.band_fix(us[0], tail, hn, hs, out, 2, **kw)
    skb.block_circular(ext, out, 2, **kw)
    skb.block_padded(ext, out, 2, **kw)
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal3d

    mesh3 = HeatMesh((2, 1, 1))
    us3 = mesh3.split(torch.from_numpy(_rand((8, 5, 6), seed=10)))
    zt, yt, xlo, xhi = temporal3d.exchange_halos_fused_3d(mesh3, us3, 2)[0]
    ext3 = temporal3d.exchange_halos_circular_3d(mesh3, us3, 2)[0]
    kw3 = dict(origin=(0, 0, 0), grid_shape=(8, 5, 6), cx=CX, cy=CY, cz=0.05)
    out3 = torch.empty(4, 5, 6)
    skb3.h_block_fused(us3[0], zt, yt, xlo, xhi, out3, 2, **kw3)
    skb3.h_band_fix(us3[0], zt, yt, xlo, xhi, out3, 2, **kw3)
    skb3.h_block(ext3, out3, 2, **kw3)
    # On the CPU the plain versions run; the kernels never launch. One
    # registry holds all twenty kernels, the counts of A's, B's, C's, D's,
    # E's, E-uni's, F's, I's, I-uni's, M's and the G family's bfloat16
    # forms (storage, and E's, E-uni's, I's and I-uni's acc_f32), and the
    # plain versions.
    assert all(n == 0 for name, n in sk.counts.items()
               if name.startswith("heat_"))
    assert all(n == 1 for name, n in sk.counts.items()
               if not name.startswith("heat_"))
    assert {"heat_d_step3d_bf16", "heat_f_temporal3d_bf16",
            *skb.KERNEL_OF_BF16.values(), skb.BAND_BF16} <= set(sk.counts)
    assert len(sk.counts) == 59


@pytest.mark.parametrize("case", ["dtype", "shape", "alias", "strided",
                                  "device", "small", "k"])
def test_wrappers_reject_bad_inputs(case):
    u = torch.zeros((16, 16))
    out = torch.empty_like(u)
    k = 3
    if case == "dtype":
        u = u.double()
    elif case == "shape":
        out = torch.empty((16, 17))
    elif case == "alias":
        out = u
    elif case == "strided":
        u = torch.zeros((16, 32))[:, ::2]
    elif case == "device":
        u = torch.zeros((16, 16), device="meta")
    elif case == "small":
        u, out = torch.zeros((2, 16)), torch.empty((2, 16))
    elif case == "k":
        k = params().e_k_max() + 1
    with pytest.raises((TypeError, ValueError)):
        sk.temporal_steps(u, out, k, cx=CX, cy=CY)
    with pytest.raises((TypeError, ValueError)):
        sk.temporal_steps_uni(u, out, k, cx=CX, cy=CY)
    for launch in (sk.tile_temporal_steps, sk.tile_temporal_steps_uni):
        with pytest.raises((TypeError, ValueError)):
            launch(u, out, 9 if case == "k" else k, cx=CX, cy=CY)
    with pytest.raises((TypeError, ValueError)):
        sk.resident_steps(u, out, 0 if case == "k" else k, cx=CX, cy=CY)
    if case != "k":
        with pytest.raises((TypeError, ValueError)):
            sk.strip_step(u, out, cx=CX, cy=CY)
        with pytest.raises((TypeError, ValueError)):
            sk.tiled_step(u, out, cx=CX, cy=CY)


@pytest.mark.parametrize("launch,plain", [
    ("temporal_steps_uni", "temporal_steps_uni_plain"),
    ("tile_temporal_steps_uni", "tile_temporal_steps_uni_plain")])
def test_temporal_steps_uni_refuses_a_width_not_a_multiple_of_4(launch,
                                                                plain):
    u = torch.zeros((16, 18))
    sk.reset_counts()
    with pytest.raises(ValueError, match="multiple of 4"):
        getattr(sk, launch)(u, torch.empty_like(u), 2, cx=CX, cy=CY)
    assert sk.counts[plain] == 0


@pytest.mark.parametrize("shape", [(16384, 16384), (4096, 4096),
                                   (1000, 1000), (20, 20)])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_i_launch_covers_the_grid(shape, k):
    p = params()
    tile_x, seg_rows = p.i_launch(shape, k)
    assert tile_x + 2 * p.i_pad(k) == 128 and p.i_pad(k) >= k
    assert seg_rows >= p.i_seg_rows_min
    bands = -(-shape[1] // tile_x)
    segments = -(-shape[0] // seg_rows)
    assert bands * tile_x >= shape[1] and segments * seg_rows >= shape[0]


def test_resident_steps_refuses_a_grid_too_large_to_be_resident():
    # Refused on the CPU too, before the plain version runs: the wrapper
    # takes on the CPU exactly what the kernel takes on the card.
    u = torch.zeros((2048, 2048))
    sk.reset_counts()
    with pytest.raises(ValueError, match="does not fit resident"):
        sk.resident_steps(u, torch.empty_like(u), 4, cx=CX, cy=CY)
    assert sk.counts["resident_steps_plain"] == 0


@pytest.mark.parametrize("shape", [(3, 3), (20, 20), (256, 256), (300, 200),
                                   (1000, 1000), (1001, 999), (1800, 1800),
                                   (5, 4099)])
def test_a_tile_covers_the_grid_within_the_card(shape):
    p = params()
    ty, tx = p.a_tile(shape)
    blocks = -(-shape[0] // ty) * -(-shape[1] // tx)
    assert ty <= shape[0] and tx <= shape[1]
    assert blocks <= p.sm_count
    assert (p.a_smem_bytes((ty, tx)) + p.static_smem_bytes
            <= p.smem_per_block_max)


def test_pick_single_2d_default_and_forced():
    from parallel_heat_tpu_torch import tune

    p = params()
    kind, detail = sk.pick_single_2d((16384, 16384))
    assert kind == "E-uni" and detail["k"] == p.e_k_default
    # A width that is not a multiple of 4 takes E.
    assert sk.pick_single_2d((4099, 4099))[0] == "E"
    # A grid that fits resident takes A, as the JAX package's takes A
    # where the grid fits in VMEM.
    assert sk.pick_single_2d((1000, 1000)) == (
        "A", {"tile": p.a_tile((1000, 1000)), "depth": p.a_depth,
              "block": p.a_block})
    assert p.a_tile((2048, 2048)) is None
    assert sk.pick_single_2d((2048, 2048))[0] == "E-uni"
    with tune.force("single_2d", "B"):
        assert sk.pick_single_2d((16384, 16384))[0] == "B"
    with tune.force("single_2d", "E"):
        assert sk.pick_single_2d((1000, 1000))[0] == "E"
    with tune.force("single_2d", "C"):
        assert sk.pick_single_2d((1000, 1000)) == (
            "C", {"tile": p.c_tile, "block": p.c_block})
    with tune.force("single_2d", "E-uni"):
        with pytest.warns(RuntimeWarning, match="infeasible"):
            assert sk.pick_single_2d((4099, 4099))[0] == "E"
    for choice in ("I", "I-uni"):
        with tune.force("single_2d", choice):
            kind, detail = sk.pick_single_2d((4096, 4096))
        assert kind == choice and detail["k"] == p.i_k_default
    with tune.force("single_2d", "I-uni"):
        with pytest.warns(RuntimeWarning, match="infeasible"):
            assert sk.pick_single_2d((4099, 4099))[0] == "E"
    with tune.force("single_2d", "torch"):
        assert sk.pick_single_2d((64, 64)) == ("torch", None)
    with tune.force("single_2d", "A"):
        with pytest.warns(RuntimeWarning, match="infeasible"):
            assert sk.pick_single_2d((16384, 16384))[0] == "E-uni"
    with pytest.raises(ValueError):
        with tune.force("single_2d", "G"):
            pass


def test_hopper_params_budget():
    p = params()
    assert 1 <= p.e_k_default <= p.e_k_max()
    per_block = p.smem_per_sm // p.e_min_blocks_per_sm \
        - p.smem_reserved_per_block
    assert p.e_smem_bytes(p.e_k_max()) + p.static_smem_bytes <= per_block
    assert p.e_smem_bytes(p.e_k_max() + 1) + p.static_smem_bytes > per_block


def test_build_raises_without_nvcc(monkeypatch):
    # No fallback: a machine without the CUDA toolkit gets a BuildError.
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.nvcc()


def test_library_path_tracks_source_digest():
    a = build.library_path("heat_b_step")
    b = build.library_path("heat_e_temporal")
    assert a.parent == build.BUILD_DIR and a != b
    names = {build.library_path(name).name for name in build.KERNELS}
    assert len(names) == len(build.KERNELS) == 23
    assert a.name.startswith("libheat_b_step-") and a.suffix == ".so"
    assert build.library_path("heat_b_step") == a


# ---------------------------------------------------------------------------
# Kernels E and E-uni on the register-blocked tile loop
# (csrc/heat_temporal.cuh): launch shapes, shared memory, tile kinds and
# E-uni's TMA box
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile,block,ok", [
    ((96, 112), (32, 8), True),
    ((64, 240), (32, 16), True),
    ((8, 4), (32, 1), True),
    ((96, 110), (32, 8), False),    # width not a multiple of 4
    ((0, 112), (32, 8), False),
    ((96, 112), (64, 4), False),    # a row of threads must be a warp
    ((96, 112), (32, 17), False),   # over the 512-thread launch bound
    ((96, 112), (32, 32), False),   # 1024 threads: the column walk's shape
])
def test_e_launch_shapes_are_the_loops(tile, block, ok):
    p = params()
    assert p.loop_takes(tile, block) is ok
    if not ok:
        u = torch.zeros((64, 128))
        for name in ("heat_e_temporal", "heat_e_uni_temporal"):
            with pytest.raises(ValueError, match="does not take"):
                sk._launch_e(u, torch.empty_like(u), 2, None, CX, CY, tile,
                             block, name)


def test_e_defaults_are_a_shape_the_loop_takes():
    p = params()
    assert p.loop_takes(p.e_tile, p.e_block)
    assert all(p.e_box_fits(k) for k in range(1, p.e_k_max() + 1))


def test_e_smem_and_k_max_on_padded_rows():
    p = params()
    ty, tx = p.e_tile
    for k in range(1, 10):
        assert p.e_smem_bytes(k) == 2 * (ty + 2 * k) * p.row_floats(k, tx) * 4
        assert p.e_smem_bytes(k, tma=True) == p.e_smem_bytes(k) + 136
    # 96 x 112 at K = 8: 112 rows of 128 floats, two buffers of 56 KiB.
    assert p.e_smem_bytes(8) == 114_688
    # K = 9 pads to 136 floats a row: 124,032 bytes, one block an SM.
    assert p.e_smem_bytes(9) == 124_032
    assert p.e_k_max() == 8
    per_block = (p.smem_per_sm // p.e_min_blocks_per_sm
                 - p.smem_reserved_per_block)
    assert p.e_smem_bytes(8, tma=True) + p.static_smem_bytes <= per_block
    # A smaller tile goes deeper; a 240-wide one stops where its box
    # would pass 256 floats.
    assert p.e_k_max((32, 112)) > 8
    assert p.row_floats(8, 240) == 256 and p.e_box_fits(8, (32, 240))
    assert not p.e_box_fits(9, (32, 240))
    assert p.e_k_max((32, 240)) == 8


def test_e_tile_kinds_count_the_branches():
    p = params()
    # 1001 x 999 at K = 8: 11 x 9 tiles of 96 x 112; the last row tile 41
    # rows, the last column tile 103 columns (a last group of 3).
    kinds = p.e_tile_kinds((1001, 999), 8)
    assert kinds["tiles"] == 99
    # Inside: row tiles 1-9 (9 * 96 + 104 = 968 <= 1001) by column tiles
    # 1-7 (7 * 112 + 120 = 904 <= 999).
    assert kinds["inside"] == 9 * 7 and kinds["grid_edge"] == 99 - 63
    assert kinds["top"] == kinds["bottom"] == 9
    assert kinds["left"] == kinds["right"] == 11
    assert kinds["ragged_rows"] == 9 and kinds["ragged_cols"] == 11
    assert kinds["partial_group"] == 11
    assert kinds["interior"] == 63 and kinds["copies"] == 36
    # A width that is a multiple of 4 ends in no part group.
    assert p.e_tile_kinds((1001, 1000), 8)["partial_group"] == 0
    # A grid smaller than one tile: one tile at all four edges.
    for shape in ((20, 24), (21, 23)):
        one = p.e_tile_kinds(shape, 3)
        assert one["tiles"] == one["grid_edge"] == 1
        assert one["top"] == one["left"] == one["bottom"] == one["right"] == 1
        assert one["partial_group"] == (shape[1] % 4 != 0)
    # 16384^2: 171 x 147 tiles, the last row tile 64 rows, the last
    # column tile 32 columns.
    big = p.e_tile_kinds((16384, 16384), 8)
    assert big["tiles"] == 171 * 147
    assert big["ragged_rows"] == 147 and big["ragged_cols"] == 171
    assert big["inside"] == 169 * 145


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("tile", [(96, 112), (32, 240), (8, 4)])
def test_e_box_covers_the_framed_tile_on_16_byte_columns(k, tile):
    p = params()
    ty, tx = tile
    pad = (4 - k % 4) % 4
    for r, c in ((0, 0), (0, 1), (3, 2)):
        y0, x0, rows, cols = p.e_box(k, r, c, tile)
        # The framed tile: rows [r TY - K, + TY + 2K), columns
        # [c TX - K, + TX + 2K), inside the box.
        assert y0 == r * ty - k and rows == ty + 2 * k
        assert x0 <= c * tx - k and c * tx + tx + k <= x0 + cols
        # The box starts on a 16-byte column (negative for column tile
        # 0), is a whole number of 16-byte rows, and tile column K lands
        # on a 16-byte boundary of its shared row.
        assert x0 % 4 == 0 and cols % 4 == 0
        assert (c * tx - x0) % 4 == 0 and c * tx - x0 == k + pad
        assert cols == p.row_floats(k, tx)


def test_e_uni_launch_refuses_a_box_past_256_cells():
    u = torch.zeros((64, 256))
    with pytest.raises(ValueError, match="TMA box"):
        sk._launch_e(u, torch.empty_like(u), 9, None, CX, CY, (32, 240),
                     (32, 8), "heat_e_uni_temporal")


def test_pick_and_explain_name_e_uni_load_and_shape():
    from parallel_heat_tpu_torch import HeatConfig, explain

    p = params()
    kind, detail = sk.pick_single_2d((16384, 16384))
    assert kind == "E-uni" and detail["block"] == p.e_block
    ty, tx = p.e_tile
    lanes, warps = p.e_block
    out = explain(HeatConfig(nx=16384, ny=16384, steps=200, backend="cuda"),
                  device="cpu")
    assert "heat_e_uni_temporal" in out["path"]
    assert "uniform TMA load" in out["path"]
    assert f"tile={ty}x{tx}, {lanes}x{warps} threads" in out["path"]
    e = explain(HeatConfig(nx=4099, ny=4099, steps=200, backend="cuda"),
                device="cpu")
    assert "heat_e_temporal" in e["path"] and "cp.async load" in e["path"]
