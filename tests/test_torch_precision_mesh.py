"""Precision on meshes: the port's sharded runs at bfloat16 and float64
against its one-block runs and the JAX package.

bfloat16 runs on 2D meshes under both backends: the torch rounds (the
per-step exchange of ``parallel/halo.py`` at depth 1, the K-deep
textbook rounds of ``parallel/temporal.py`` deeper) and the kernel
rounds, whose bfloat16 forms of G, G-circ, G-fuse, G-uni and the band
run here as their plain versions (``tests/test_torch_card.py`` and
``chip_smoke.py`` hold the kernels bitwise to them on the card). float64
runs on 2D and 3D meshes under the torch rounds. Inputs are made with
numpy from a seed; a bfloat16 grid is rounded from the same float32
values on both sides, so the inputs agree bit for bit.

Tolerances:

- every level rounds to the storage dtype where the one-block run
  rounds it, so each sharded run is **bitwise** the port's one-block run
  on the same backend, and each bfloat16 plain version is **bitwise** K
  steps of kernel B's bfloat16 plain version (``strip_step``) on the
  same cells of the assembled grid, with its float32 residual equal to
  the chain's last step's;
- the torch route against JAX ``backend="jnp"`` on the same mesh:
  **0 ulps** (both evaluate the textbook tree in float32, which XLA:CPU
  compiles without contraction, and round at the same points); the halo
  step of ``parallel/halo.py`` likewise, bitwise JAX's
  ``block_step_2d(_residual)``;
- the cuda route against JAX ``backend="pallas"`` (kernel G in interpret
  mode at ``halo_depth=16``, the port's kernels at K = 8): ``rtol=8e-3``
  (about 2 bfloat16 ulps, ``tests/test_torch_precision.py``'s whole-run
  contract: XLA:CPU may contract a multiply and an add into an FMA where
  eager PyTorch rounds each, and a float32 ulp flips a bfloat16
  rounding now and then), residuals within **2 bfloat16 ulps of the
  grid's largest value**;
- float64 (float32 arithmetic, float64 storage) against JAX jnp under
  ``jax_enable_x64``: ``rtol=1e-6`` (8 float32 ulps, the one-block
  contract of ``tests/test_torch_precision.py``), and against
  ``tests/oracle.py``'s float64 steps ``rtol=1e-5`` with an absolute
  floor of ``1e-6`` of the grid's largest value;
- ``steps_run`` and ``converged`` are equal everywhere, and the
  Dirichlet ring is bit-exact, NaN payloads included.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import oracle
import parallel_heat_tpu as jx
from parallel_heat_tpu.parallel import halo as jhalo
from parallel_heat_tpu.parallel.mesh import make_heat_mesh
from parallel_heat_tpu.utils.compat import shard_map as jshard_map
from parallel_heat_tpu_torch import HeatConfig, HeatMesh, explain, solve
from parallel_heat_tpu_torch.models import HeatPlate2D, HeatPlate3D
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
from parallel_heat_tpu_torch.parallel import halo, temporal

BF16 = torch.bfloat16
CX, CY = 0.1, 0.2
NAN_PAYLOADS = (0x7FC1, -64, 0x7F81)      # -64 is 0xFFC0


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same_float(a, b) -> bool:
    a, b = float(a), float(b)
    return a == b or (a != a and b != b)


def _rand_bf16(shape, seed, nan=False):
    """A seeded bfloat16 grid of either sign (magnitudes to about 40);
    with ``nan`` NaNs of payloads no conversion makes, on the ring and
    inside."""
    u32 = np.random.default_rng(seed).standard_normal(shape) * 10
    u = torch.from_numpy(u32.astype(np.float32)).to(BF16)
    if nan:
        bits = u.view(torch.int16)
        m, n = shape
        for (i, j), b in zip(((0, n // 2), (m - 1, 1), (m // 3, n - 1),
                              (m // 2, n // 3)), NAN_PAYLOADS + (0x7FC1,)):
            bits[i, j] = b
    return u


def _ring(a):
    return [a[0], a[-1], a[:, 0], a[:, -1]]


def _assert_ring(got, want):
    for g, w in zip(_ring(got), _ring(want)):
        assert _same_bits(g, w)


# ---------------------------------------------------------------------------
# (a) The five bfloat16 plain versions against kernel B's bfloat16 chain
# ---------------------------------------------------------------------------

def _chain_b(g, k):
    """K calls of ``strip_step`` (kernel B's bfloat16 plain version) on
    the global grid: the grid and the last step's residual."""
    u, res = g, None
    for _ in range(k):
        out = torch.empty_like(u)
        res = sk.strip_step(u, out, cx=CX, cy=CY)
        u = out
    return u, res


# Blocks of (40, 48) (a width of 8k: G-uni takes it) and (41, 52) (4k but
# not 8k: G-uni's bfloat16 form does not), on (2, 2) meshes.
PLAIN_GRIDS = [(80, 96), (82, 104)]


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("grid", PLAIN_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("k", range(1, 9))
def test_bf16_plain_versions_are_k_steps_of_b(k, grid, nan):
    g = _rand_bf16(grid, seed=k + grid[1], nan=nan)
    want, want_res = _chain_b(g, k)
    mesh = HeatMesh((2, 2))
    us = mesh.split(g)
    bs = tuple(us[0].shape)
    xch = temporal.DeepExchange2D(mesh, bs, k, "cpu", BF16)
    xch.phase1(us)
    xch.phase2(us)
    assert all(t.dtype == BF16 for t in xch.tail + xch.halo_n + xch.halo_s)
    kw = dict(grid_shape=grid, cx=CX, cy=CY)
    res_of_blocks = []
    band_outs = []
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        cell = want[o[0]:o[0] + bs[0], o[1]:o[1] + bs[1]]
        ext_c = us[b].new_empty((bs[0] + 2 * k, bs[1] + 2 * k))
        ext_p = torch.empty_like(ext_c)
        xch.assemble_circular(b, us[b], ext_c)
        xch.assemble_padded(b, us[b], ext_p)
        runs = {"G-fuse": (us[b], *xch.pieces(b)), "G-circ": (ext_c,),
                "G": (ext_p,)}
        if bs[1] % 8 == 0:
            runs["G-uni"] = (us[b], *xch.pieces(b))
        else:
            with pytest.raises(ValueError, match="multiple of 4 .8 at"):
                skb.block_uniform(us[b], *xch.pieces(b), torch.empty_like(
                    us[b]), k, origin=o, **kw)
        first = None
        for kind, args in runs.items():
            out = torch.full_like(us[b], float("nan"))
            r = skb.LAUNCH[kind](*args, out, k, True, origin=o, **kw)
            assert out.dtype == BF16 and r.dtype == torch.float32
            assert _same_bits(out, cell), (kind, b)
            if b == 0:  # its first row and column are the grid's ring
                assert _same_bits(out[0], us[b][0])
                assert _same_bits(out[:, 0], us[b][:, 0])
            first = r if first is None else first
            assert _same_float(r, first), kind
        res_of_blocks.append(first)
        # The deferred bulk and the band, in place, are the monolithic
        # form, grid and max residual (blocks of exactly 2K rows too:
        # 40 rows at K = 20 do not arise here, so 2K-row blocks are the
        # test below).
        for kind in ("G-fuse",) + (("G-uni",) if "G-uni" in runs else ()):
            split = torch.full_like(us[b], float("nan"))
            rb = skb.LAUNCH[kind](us[b], xch.tail[b], None, None, split, k,
                                  True, origin=o, **kw)
            rf = skb.band_fix(us[b], *xch.pieces(b), split, k, True,
                              origin=o, **kw)
            assert _same_bits(split, cell)
            assert _same_float(torch.maximum(rb, rf), first)
        band_outs.append(torch.full_like(us[b], float("nan")))
    # The round's one band launch (its plain version) over every block.
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    rb = skb.BandLaunch(us, xch.tail, xch.halo_n, xch.halo_s, band_outs, k,
                        origins=origins, **kw)(True)
    for b, out in enumerate(band_outs):
        o = origins[b]
        cell = want[o[0]:o[0] + bs[0], o[1]:o[1] + bs[1]]
        assert _same_bits(out[:k], cell[:k])
        assert _same_bits(out[bs[0] - k:], cell[bs[0] - k:])
        assert bool(out[k:bs[0] - k].isnan().all())
    assert rb.dtype == torch.float32
    # Every block's residual is float32, and their max is the chain's.
    assert _same_float(torch.stack(res_of_blocks).amax(), want_res)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_bf16_deferred_bulk_of_blocks_of_2k_rows_is_empty(k):
    """Blocks of exactly 2K rows: the bulk writes nothing and returns a
    float32 zero; the band alone is the monolithic form."""
    grid = (4 * k, 48)
    g = _rand_bf16(grid, seed=k)
    want, _ = _chain_b(g, k)
    mesh = HeatMesh((2, 2))
    us = mesh.split(g)
    bs = tuple(us[0].shape)
    xch = temporal.DeepExchange2D(mesh, bs, k, "cpu", BF16)
    xch.phase1(us)
    xch.phase2(us)
    kw = dict(grid_shape=grid, cx=CX, cy=CY)
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        out = torch.full_like(us[b], float("nan"))
        rb = skb.block_uniform(us[b], xch.tail[b], None, None, out, k,
                               origin=o, **kw)
        assert rb.dtype == torch.float32 and float(rb) == 0.0
        assert bool(out.isnan().all())
        rm = skb.block_uniform(us[b], *xch.pieces(b), torch.empty_like(
            us[b]), k, origin=o, **kw)
        rf = skb.band_fix(us[b], *xch.pieces(b), out, k, origin=o, **kw)
        assert _same_bits(out, want[o[0]:o[0] + bs[0], o[1]:o[1] + bs[1]])
        assert _same_float(rf, rm)


def test_operands_of_one_launch_share_one_dtype():
    us = [torch.zeros((16, 24), dtype=BF16)]
    xch = temporal.DeepExchange2D(HeatMesh((1, 1)), (16, 24), 2, "cpu",
                                  torch.float32)
    kw = dict(origin=(0, 0), grid_shape=(16, 24), cx=CX, cy=CY)
    with pytest.raises(TypeError, match="one dtype"):
        skb.block_fused(us[0], *xch.pieces(0), torch.empty_like(us[0]), 2,
                        **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        skb.block_fused(*(t.double() for t in (us[0], *xch.pieces(0))),
                        torch.empty((16, 24), dtype=torch.float64), 2, **kw)


def test_bf16_entry_points_and_pickers():
    assert skb.KERNEL_OF_BF16["G-uni"] == "heat_g_block_uniform_bf16"
    assert skb.BAND_BF16 == "heat_g_band_fix_bf16"
    for name in (*skb.KERNEL_OF_BF16.values(), skb.BAND_BF16):
        assert sk.counts[name] == 0 or name in sk.counts
    # G-uni at bfloat16 only where the width is a multiple of 8.
    kind, detail = skb.pick_block_temporal_2d((16384, 8192), 8, "bfloat16")
    assert (kind, detail["kernel"]) == ("G-uni", "heat_g_block_uniform_bf16")
    kind, detail = skb.pick_block_temporal_2d((500, 252), 8, BF16)
    assert (kind, detail["kernel"]) == ("G-fuse", "heat_g_block_fused_bf16")
    assert skb.pick_block_temporal_2d((500, 252), 8)[0] == "G-uni"
    # The band's row load at bfloat16: widths and halo rows of 8k cells.
    from parallel_heat_tpu_torch.ops.hopper_params import params
    assert params().g_band_row_load((8192, 8192), 8, 2)
    assert not params().g_band_row_load((8192, 8192), 6, 2)
    assert params().g_band_row_load((8192, 8192), 6, 4)


# ---------------------------------------------------------------------------
# (b) Sharded bfloat16 runs bitwise the one-block run
# ---------------------------------------------------------------------------

def _small_initial(shape, seed):
    """Values in [0, 1): a bfloat16 run that can converge at eps 0.05."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32)).to(BF16)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bf16_fixed_is_bitwise_one_block(mesh, backend):
    kw = dict(nx=64, ny=64, steps=37, cx=CX, cy=CY, dtype="bfloat16",
              backend=backend)
    one = solve(HeatConfig(**kw), device="cpu")
    got = solve(HeatConfig(mesh_shape=mesh, **kw), device="cpu")
    assert got.grid.dtype == BF16 and got.steps_run == 37
    assert _same_bits(got.grid, one.grid)


@pytest.mark.parametrize("interval", [16, 12], ids=["multiple_of_k",
                                                    "not_multiple_of_k"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bf16_converge_is_bitwise_one_block(mesh, backend, interval):
    kw = dict(nx=64, ny=64, steps=2000, converge=True, eps=0.05,
              check_interval=interval, cx=CX, cy=CY, dtype="bfloat16",
              backend=backend)
    init = _small_initial((64, 64), seed=interval)
    one = solve(HeatConfig(**kw), device="cpu", initial=init)
    got = solve(HeatConfig(mesh_shape=mesh, **kw), device="cpu",
                initial=init)
    assert one.converged and one.steps_run < 2000
    assert (got.steps_run, got.converged) == (one.steps_run, one.converged)
    assert got.residual == one.residual
    assert _same_bits(got.grid, one.grid)


def test_sharded_bf16_cuda_route_counts_its_bf16_plain_versions():
    sk.reset_counts()
    solve(HeatConfig(nx=64, ny=64, steps=16, dtype="bfloat16",
                     backend="cuda", mesh_shape=(2, 4)), device="cpu")
    # Two rounds of K = 8: the deferred bulk's and the batched band's
    # plain versions (bfloat16 blocks of 32 x 16: G-uni).
    assert sk.counts["block_uniform_plain"] == 2 * 8
    assert sk.counts["band_fix_plain"] == 2
    out = explain(HeatConfig(nx=64, ny=64, dtype="bfloat16", backend="cuda",
                             mesh_shape=(2, 4)), device="cpu")
    assert "heat_g_block_uniform_bf16" in out["path"]
    assert "heat_g_band_fix_bf16" in out["path"]
    out = explain(HeatConfig(nx=64, ny=48, dtype="bfloat16", backend="cuda",
                             mesh_shape=(2, 4)), device="cpu")
    assert "heat_g_block_fused_bf16" in out["path"]
    assert "not a multiple of 8" in out["path"]


# ---------------------------------------------------------------------------
# (c) Against the JAX package's sharded runs
# ---------------------------------------------------------------------------

def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 2), (2, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_torch_route_bf16_matches_jax_jnp_bitwise(mesh, depth):
    kw = dict(nx=32, ny=64, steps=37, cx=CX, cy=CY, dtype="bfloat16",
              mesh_shape=mesh, halo_depth=depth)
    theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    ours = solve(HeatConfig(backend="torch", **kw), device="cpu")
    np.testing.assert_array_equal(_bits(ours.grid).numpy(),
                                  _np_bits(theirs.grid))


def test_torch_route_bf16_converge_matches_jax_jnp():
    kw = dict(nx=64, ny=64, steps=400, converge=True, eps=1e-3,
              check_interval=12, cx=CX, cy=CY, dtype="bfloat16",
              mesh_shape=(2, 2))
    theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    ours = solve(HeatConfig(backend="torch", **kw), device="cpu")
    assert (ours.steps_run, ours.converged) == (theirs.steps_run,
                                                theirs.converged)
    assert ours.residual == float(theirs.residual)
    np.testing.assert_array_equal(_bits(ours.grid).numpy(),
                                  _np_bits(theirs.grid))


@pytest.mark.parametrize("converge", [False, True], ids=["fixed", "converge"])
def test_cuda_route_bf16_matches_jax_pallas(converge):
    kw = dict(nx=64, ny=64, cx=CX, cy=CY, dtype="bfloat16",
              mesh_shape=(2, 2))
    kw.update(dict(steps=400, converge=True, eps=1e-3, check_interval=20)
              if converge else dict(steps=37))
    theirs = jx.solve(jx.HeatConfig(backend="pallas", halo_depth=16, **kw))
    ours = solve(HeatConfig(backend="cuda", **kw), device="cpu")
    got = ours.grid.float().numpy()
    want = np.asarray(theirs.grid).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=0)
    init = solve(HeatConfig(**{**kw, "steps": 0, "converge": False},
                            backend="cuda"), device="cpu").grid
    _assert_ring(ours.grid, init)
    assert (ours.steps_run, ours.converged) == (theirs.steps_run,
                                                theirs.converged)
    if converge:
        top = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert abs(ours.residual - float(theirs.residual)) <= 2 * ulp


def test_cuda_depth_16_stays_refused_at_bf16():
    with pytest.raises(ValueError, match="deeper rounds run under "
                                         "backend='torch'"):
        HeatConfig(nx=64, ny=64, dtype="bfloat16", mesh_shape=(2, 2),
                   halo_depth=16, backend="cuda").validate()
    out = explain(HeatConfig(nx=64, ny=64, dtype="bfloat16", mesh_shape=(2, 2),
                             backend="cuda"), device="cpu")
    assert out["halo_depth"] == "8 (auto)"


# ---------------------------------------------------------------------------
# (d) float64 on 2D and 3D meshes under the torch rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("dims", [dict(nx=40, ny=48, mesh_shape=(2, 2)),
                                  dict(nx=12, ny=16, nz=20,
                                       mesh_shape=(2, 2, 2))],
                         ids=["2d", "3d"])
def test_float64_mesh_is_bitwise_one_block_and_matches_jax_x64(dims, depth):
    kw = dict(steps=37, dtype="float64", **dims)
    one = solve(HeatConfig(**{**kw, "mesh_shape": None}), device="cpu")
    got = solve(HeatConfig(halo_depth=depth, **kw), device="cpu")
    assert got.grid.dtype == torch.float64
    assert _same_bits(got.grid, one.grid)
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        theirs = jx.solve(jx.HeatConfig(backend="jnp", halo_depth=depth,
                                        **kw))
        assert str(np.asarray(theirs.grid).dtype) == "float64"
        np.testing.assert_allclose(got.to_numpy(), np.asarray(theirs.grid),
                                   rtol=1e-6, atol=0)
    finally:
        jax.config.update("jax_enable_x64", was)
    u = HeatConfig(**kw)
    want = (HeatPlate3D(u.nx, u.ny, u.nz).init_grid_np(np.float64)
            if u.ndim == 3 else HeatPlate2D(u.nx, u.ny).init_grid_np(
                np.float64))
    for _ in range(37):
        want = (oracle.step3d(want, 0.1, 0.1, 0.1) if u.ndim == 3
                else oracle.step(want, 0.1, 0.1))
    np.testing.assert_allclose(got.to_numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_float64_mesh_converge_matches_one_block():
    kw = dict(nx=40, ny=48, steps=2000, converge=True, eps=1e-3,
              check_interval=20, dtype="float64")
    init = np.random.default_rng(5).uniform(0, 1, (40, 48))
    one = solve(HeatConfig(**kw), device="cpu", initial=init)
    for depth in (1, 4):
        got = solve(HeatConfig(mesh_shape=(2, 2), halo_depth=depth, **kw),
                    device="cpu", initial=init)
        assert one.converged
        assert (got.steps_run, got.converged, got.residual) == (
            one.steps_run, one.converged, one.residual)
        assert _same_bits(got.grid, one.grid)


# ---------------------------------------------------------------------------
# (e) Diverging mesh runs against the JAX one-block run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,backend", [("bfloat16", "torch"),
                                           ("bfloat16", "cuda"),
                                           ("float64", "torch")])
def test_diverging_mesh_run_matches_the_jax_one_block_run(dtype, backend):
    # cx = cy = 0.4 is past the stability bound: the interior blows up to
    # inf and NaN. The JAX package's sharded converge loop reports NaN as
    # converged (ROADMAP.md queue 3), so the port's mesh run is held to
    # JAX's one-block run: not converged, and on the torch route stopped
    # at the same window (its residual NaN) with the same grid. The cuda
    # route's factored combine keeps that window's residual at +inf (JAX's
    # Pallas kernel, which pins the ring by multiplying, reaches NaN
    # there), so it runs on to the step cap, as the port's one-block cuda
    # run does.
    kw = dict(nx=16, ny=24, cx=0.4, cy=0.4, steps=200, converge=True,
              eps=1e-3, check_interval=20, dtype=dtype)
    init = np.random.default_rng(3).standard_normal((16, 24)) * 10
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw),
                          initial=init.astype(np.float32))
    finally:
        jax.config.update("jax_enable_x64", was)
    ut = torch.from_numpy(init.astype(np.float32)).to(
        BF16 if dtype == "bfloat16" else torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = solve(HeatConfig(backend=backend, **kw), device="cpu",
                    initial=ut)
        got = solve(HeatConfig(backend=backend, mesh_shape=(2, 2), **kw),
                    device="cpu", initial=ut)
    assert (got.steps_run, got.converged, str(got.residual)) == (
        one.steps_run, one.converged, str(one.residual))
    assert not got.converged and not theirs.converged
    if backend == "torch":
        assert got.steps_run == theirs.steps_run < 200
        assert got.residual != got.residual
    else:
        assert got.steps_run == 200 and got.residual == float("inf")
    assert _same_bits(got.grid, one.grid)
    assert not torch.isfinite(got.grid[1:-1, 1:-1].double()).all()
    _assert_ring(got.grid, ut)
    if backend == "torch":
        np.testing.assert_array_equal(got.grid.double().numpy(),
                                      np.asarray(theirs.grid, np.float64))


# ---------------------------------------------------------------------------
# (f) The per-step halo update at bfloat16 and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_halo_step_matches_jax_block_step(dtype, overlap):
    grid, mesh_shape = (16, 24), (2, 2)
    u32 = (np.random.default_rng(7).uniform(1, 100, grid)
           .astype(np.float32))
    ours_in = torch.from_numpy(u32).to(
        BF16 if dtype == "bfloat16" else torch.float64)
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(ours_in)
    outs = [torch.empty_like(u) for u in us]
    kw = dict(grid_shape=grid, cx=CX, cy=CY, overlap=overlap)
    res = halo.block_step_2d_residual(mesh, us, outs, **kw)
    outs1 = [torch.empty_like(u) for u in us]
    halo.block_step_2d(mesh, us, outs1, **kw)
    assert all(_same_bits(a, b) for a, b in zip(outs, outs1))
    assert res.dtype == torch.float32
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        jm = make_heat_mesh(mesh_shape)
        spec = P("x", "y")

        def step(u):
            bidx = (jax.lax.axis_index("x"), jax.lax.axis_index("y"))
            return jhalo.block_step_2d_residual(
                u, mesh_shape=mesh_shape, grid_shape=grid, block_index=bidx,
                cx=CX, cy=CY, axis_names=("x", "y"), overlap=overlap)

        import jax.numpy as jnp
        jin = jnp.asarray(u32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                      else jnp.float64)
        jout, jres = jshard_map(step, mesh=jm, in_specs=spec,
                                out_specs=(spec, P()))(jin)
        jout = np.asarray(jout)
        jres = float(jres)
    finally:
        jax.config.update("jax_enable_x64", was)
    got = mesh.assemble(outs)
    np.testing.assert_array_equal(_bits(got).numpy(), _np_bits(jout))
    assert float(res) == jres


# ---------------------------------------------------------------------------
# (g) The blocks keep the storage dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [BF16, torch.float64, torch.float32])
def test_split_keeps_the_grids_dtype(dtype):
    g = _rand_bf16((8, 12), seed=1, nan=True).to(dtype) if dtype != BF16 \
        else _rand_bf16((8, 12), seed=1, nan=True)
    blocks = HeatMesh((2, 4)).split(g)
    assert all(b.dtype == dtype for b in blocks)
    assert _same_bits(HeatMesh((2, 4)).assemble(blocks), g)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_blocks_are_the_initial_grids_slices(dtype):
    # solve() builds a mesh's blocks per block (models' init_block): bit
    # for bit the slices of the whole initial grid, in 2D and 3D.
    from parallel_heat_tpu_torch.ops.stencil import storage_dtype

    for model, mesh_shape in ((HeatPlate2D(40, 56), (2, 4)),
                              (HeatPlate3D(12, 16, 20), (2, 2, 2))):
        whole = model.init_grid("cpu", storage_dtype(dtype))
        mesh = HeatMesh(mesh_shape)
        bs = mesh.block_shape(tuple(whole.shape))
        for b in range(mesh.size):
            o = mesh.origin(b, bs)
            block = model.init_block("cpu", o, bs, dtype)
            idx = tuple(slice(a, a + s) for a, s in zip(o, bs))
            assert block.dtype == storage_dtype(dtype)
            assert _same_bits(block, whole[idx])


def test_solve_splits_an_initial_grid_at_the_configs_dtype():
    # A float32 initial grid for a bfloat16 mesh run is rounded once, as
    # the one-block run rounds it; a bfloat16 numpy array crosses by its
    # bits.
    init = np.random.default_rng(2).uniform(0, 1, (32, 48)).astype(np.float32)
    kw = dict(nx=32, ny=48, steps=5, dtype="bfloat16", backend="torch")
    one = solve(HeatConfig(**kw), device="cpu", initial=init)
    got = solve(HeatConfig(mesh_shape=(2, 2), **kw), device="cpu",
                initial=init)
    assert _same_bits(got.grid, one.grid)
    zero = solve(HeatConfig(**{**kw, "steps": 0}, mesh_shape=(2, 2)),
                 device="cpu", initial=torch.from_numpy(init).to(BF16))
    assert _same_bits(zero.grid, torch.from_numpy(init).to(BF16))


# ---------------------------------------------------------------------------
# The CLI on a mesh at bfloat16 and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--dtype", "bfloat16"], ["--dtype", "bfloat16", "--halo-depth", "4"],
    ["--dtype", "float64"], ["--dtype", "float64", "--halo-depth", "2"]],
    ids=["bf16", "bf16-depth4", "float64", "float64-depth2"])
def test_cli_mesh_precision_writes_the_jax_clis_bytes(tmp_path, capsys,
                                                      flags):
    # The port's torch rounds and the JAX CLI's jnp path on the same mesh
    # compute the same textbook tree at the same rounding points, so the
    # .dat files are the same bytes; the port's cuda route (the G kernels'
    # bfloat16 plain versions here) writes its one-block run's bytes. The
    # JAX CLI turns on JAX's x64 mode for float64: it is restored here.
    from parallel_heat_tpu import cli as jcli
    from parallel_heat_tpu_torch import cli

    base = ["--nx", "24", "--ny", "32", "--steps", "60", "--mesh", "2,2"]
    was = jax.config.jax_enable_x64
    try:
        for name, main, tail in (
                ("ours", cli.main, ["--device", "cpu", "--backend", "torch"]),
                ("theirs", jcli.main, ["--backend", "jnp"])):
            rc = main(base + flags + tail + ["--out",
                                             str(tmp_path / f"{name}.dat")])
            out = capsys.readouterr()
            assert rc == 0, out.err
    finally:
        jax.config.update("jax_enable_x64", was)
    ours = (tmp_path / "ours.dat").read_bytes()
    assert ours == (tmp_path / "theirs.dat").read_bytes()
    if flags[1] == "bfloat16" and len(flags) == 2:
        for name, argv in (("cuda_mesh", base), ("cuda_one", base[:-2])):
            rc = cli.main(argv + flags + ["--device", "cpu", "--backend",
                                          "cuda", "--out",
                                          str(tmp_path / f"{name}.dat")])
            assert rc == 0, capsys.readouterr().err
        assert ((tmp_path / "cuda_mesh.dat").read_bytes()
                == (tmp_path / "cuda_one.dat").read_bytes())
