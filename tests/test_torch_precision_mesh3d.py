"""bfloat16 on 3D meshes: the port's sharded 3D runs at bfloat16 against
its one-block runs and the JAX package.

bfloat16 runs on 3D meshes under both backends: the torch rounds (the
per-step exchange of ``parallel/halo3d.py`` at depth 1, the K-deep
textbook rounds of ``parallel/temporal.py`` deeper) and the kernel
rounds, whose bfloat16 forms of H-fused, H and the 3D band run here as
their plain versions (``tests/test_torch_card.py`` and ``chip_smoke.py``
hold the kernels bitwise to them on the card). Inputs are made with
numpy from a seed; a bfloat16 grid is rounded from the same float32
values on both sides, so the inputs agree bit for bit.

Tolerances:

- every level rounds to bfloat16 where the one-block run rounds it, so
  each sharded run is **bitwise** the port's one-block run on the same
  backend, and each bfloat16 plain version is **bitwise** K steps of
  kernel D's bfloat16 form (``slab_step_3d``, its plain version here) on
  the same cells of the assembled grid, with its float32 residual equal
  to the chain's last step's;
- the torch route against JAX ``backend="jnp"`` on the same mesh:
  **0 ulps** (both evaluate the textbook tree in float32, which XLA:CPU
  compiles without contraction, and round at the same points);
- the cuda route against JAX ``backend="pallas"`` (kernel H in interpret
  mode at ``halo_depth=8``, the port's kernels at their K):
  ``rtol=8e-3`` (about 2 bfloat16 ulps, the whole-run contract of
  ``tests/test_torch_precision_mesh.py``), residuals within **2 bfloat16
  ulps of the grid's largest value**;
- ``steps_run`` and ``converged`` are equal everywhere, and the six
  Dirichlet faces are bit-exact, NaN payloads included.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu_torch import HeatConfig, HeatMesh, explain, solve, tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.parallel import temporal3d

BF16 = torch.bfloat16
COEFFS = dict(cx=0.1, cy=0.15, cz=0.05)
NAN_PAYLOADS = (0x7FC1, -64, 0x7F81)      # -64 is 0xFFC0


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same_float(a, b) -> bool:
    a, b = float(a), float(b)
    return a == b or (a != a and b != b)


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _rand_bf16(shape, seed, nan=False):
    """A seeded bfloat16 grid of either sign (magnitudes to about 40);
    with ``nan`` NaNs of payloads no conversion makes, on the faces and
    inside."""
    u32 = np.random.default_rng(seed).standard_normal(shape) * 10
    u = torch.from_numpy(u32.astype(np.float32)).to(BF16)
    if nan:
        bits = u.view(torch.int16)
        x, y, z = shape
        for (i, j, c), b in zip(((0, y // 2, z // 3), (x - 1, 1, 2),
                                 (x // 2, y - 1, z // 2),
                                 (x // 2, y // 3, z // 4)),
                                NAN_PAYLOADS + (0x7FC1,)):
            bits[i, j, c] = b
    return u


def _faces(a):
    return [a[0], a[-1], a[:, 0], a[:, -1], a[:, :, 0], a[:, :, -1]]


def _assert_faces(got, want):
    for g, w in zip(_faces(got), _faces(want)):
        assert _same_bits(g, w)


def _chain_d(g, k):
    """K calls of ``slab_step_3d`` (kernel D's bfloat16 form, its plain
    version on the CPU) on the global grid: the grid and the last step's
    residual."""
    u, res = g, None
    for _ in range(k):
        out = torch.empty_like(u)
        res = sk3.slab_step_3d(u, out, **COEFFS)
        u = out
    return u, res


def _exchanged(g, mesh_shape, k):
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(g)
    bs = tuple(us[0].shape)
    xch = temporal3d.DeepExchange3D(mesh, bs, k, "cpu", BF16)
    xch.lead(us)
    xch.last(us)
    return mesh, us, bs, xch


# ---------------------------------------------------------------------------
# (a) The three bfloat16 plain versions against kernel D's bfloat16 chain
# ---------------------------------------------------------------------------

# Ragged blocks on a mesh cut along every axis, on one with z unsharded
# and on one cut along y only; every K up to the block's smallest extent
# (8 on the first).
PLAIN_CASES = [((2, 2, 2), (8, 10, 13)), ((2, 4, 1), (9, 6, 12)),
               ((1, 2, 1), (10, 9, 11))]


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("k,case", [
    (k, case) for case in PLAIN_CASES for k in range(1, min(case[1]) + 1)],
    ids=lambda v: "x".join(map(str, v[0])) if isinstance(v, tuple) else v)
def test_bf16_plain_versions_are_k_steps_of_d(k, case, nan):
    mesh_shape, block = case
    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    g = _rand_bf16(grid, seed=k + sum(block), nan=nan)
    want, want_res = _chain_d(g, k)
    mesh, us, bs, xch = _exchanged(g, mesh_shape, k)
    assert all(t.dtype == BF16 for side in (xch.ztail, xch.ytail, xch.xlo,
                                            xch.xhi)
               for t in side if t is not None)
    kw = dict(grid_shape=grid, **COEFFS)
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    res_of_blocks = []
    for b in range(mesh.size):
        o = origins[b]
        cell = want[tuple(slice(a, a + n) for a, n in zip(o, bs))]
        contiguous = torch.empty(xch.circular_shape, dtype=BF16)
        padded = xch.new_circular()
        assert padded.stride(1) % 8 == 0
        first = None
        for label, run in (
                ("H-fused", lambda out: skb3.h_block_fused(
                    us[b], *xch.pieces(b), out, k, True, origin=o, **kw)),
                ("H", lambda out: skb3.h_block(contiguous, out, k, True,
                                               origin=o, **kw)),
                ("H padded", lambda out: skb3.h_block(padded, out, k, True,
                                                      origin=o, **kw))):
            xch.assemble_circular(b, us[b], contiguous)
            xch.assemble_circular(b, us[b], padded)
            out = torch.full(bs, float("nan"), dtype=BF16)
            r = run(out)
            assert out.dtype == BF16 and r.dtype == torch.float32
            assert _same_bits(out, cell), (label, b)
            first = r if first is None else first
            assert _same_float(r, first), label
        res_of_blocks.append(first)
        if xch.halos[0] and bs[0] >= 2 * k:
            # The deferred bulk and the band, in place, are the
            # monolithic form, grid and max residual.
            zt, yt, _, _ = xch.pieces(b)
            split = torch.full(bs, float("nan"), dtype=BF16)
            rb = skb3.h_block_fused(us[b], zt, yt, None, None, split, k,
                                    True, defer_x=True, origin=o, **kw)
            rf = skb3.h_band_fix(us[b], *xch.pieces(b), split, k, True,
                                 origin=o, **kw)
            assert _same_bits(split, cell)
            assert rb.dtype == rf.dtype == torch.float32
            assert _same_float(torch.maximum(rb, rf), first)
    if xch.halos[0] and bs[0] >= 2 * k:
        # The round's one band launch (its plain version) over every
        # block.
        outs = [torch.full(bs, float("nan"), dtype=BF16) for _ in us]
        rb = skb3.BandLaunch3D(us, xch.ztail, xch.ytail, xch.xlo, xch.xhi,
                               outs, k, origins=origins, **kw)(True)
        for b, out in enumerate(outs):
            cell = want[tuple(slice(a, a + n) for a, n in zip(origins[b],
                                                               bs))]
            assert _same_bits(out[:k], cell[:k])
            assert _same_bits(out[bs[0] - k:], cell[bs[0] - k:])
            assert bool(out[k:bs[0] - k].isnan().all())
        assert rb.dtype == torch.float32
    assert _same_float(torch.stack(res_of_blocks).amax(), want_res)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_bf16_deferred_bulk_of_blocks_of_2k_planes_is_empty(k):
    """Blocks of exactly 2K x-planes: the bulk writes nothing and returns
    a float32 zero; the band alone is the monolithic form."""
    grid = (4 * k, 12, 14)
    g = _rand_bf16(grid, seed=k)
    want, _ = _chain_d(g, k)
    mesh, us, bs, xch = _exchanged(g, (2, 2, 2), k)
    kw = dict(grid_shape=grid, **COEFFS)
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        zt, yt, _, _ = xch.pieces(b)
        out = torch.full(bs, float("nan"), dtype=BF16)
        rb = skb3.h_block_fused(us[b], zt, yt, None, None, out, k,
                                defer_x=True, origin=o, **kw)
        assert rb.dtype == torch.float32 and float(rb) == 0.0
        assert bool(out.isnan().all())
        rm = skb3.h_block_fused(us[b], *xch.pieces(b), torch.empty_like(
            us[b]), k, origin=o, **kw)
        rf = skb3.h_band_fix(us[b], *xch.pieces(b), out, k, origin=o, **kw)
        assert _same_bits(out, want[tuple(slice(a, a + n)
                                          for a, n in zip(o, bs))])
        assert _same_float(rf, rm)


def test_bf16_plain_versions_round_every_level():
    # Each plain version's levels below K are bfloat16 values: stepping
    # the same pieces in float32 (no level rounded) gives other bits,
    # and the bfloat16 run's K steps are K one-step runs of itself.
    k, grid = 4, (16, 12, 20)
    g = _rand_bf16(grid, seed=11)
    _, us, bs, xch = _exchanged(g, (2, 2, 2), k)
    kw = dict(origin=(0, 0, 0), grid_shape=grid, **COEFFS)
    out = torch.empty(bs, dtype=BF16)
    skb3.h_block_fused(us[0], *xch.pieces(0), out, k, **kw)
    wide = torch.empty(bs)
    skb3.h_block_fused(*(None if t is None else t.float()
                         for t in (us[0], *xch.pieces(0))), wide, k, **kw)
    assert not _same_bits(out, wide.to(BF16))
    chain, _ = _chain_d(g, k)
    assert _same_bits(out, chain[:bs[0], :bs[1], :bs[2]])


def test_operands_of_one_launch_share_one_dtype():
    grid = (8, 8, 8)
    g = _rand_bf16(grid, seed=2)
    _, us, bs, xch = _exchanged(g, (2, 2, 2), 2)
    kw = dict(origin=(0, 0, 0), grid_shape=grid, **COEFFS)
    with pytest.raises(TypeError, match="one dtype"):
        skb3.h_block_fused(us[0], *xch.pieces(0), torch.empty(bs), 2, **kw)
    with pytest.raises(TypeError, match="one dtype"):
        skb3.h_block_fused(us[0].float(), *xch.pieces(0),
                           torch.empty(bs), 2, **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        skb3.h_block_fused(*(t.double() for t in (us[0], *xch.pieces(0))),
                           torch.empty(bs, dtype=torch.float64), 2, **kw)
    outs = [torch.empty(bs, dtype=BF16) for _ in us]
    outs[3] = torch.empty(bs)
    with pytest.raises(TypeError, match="one dtype"):
        skb3.BandLaunch3D(us, xch.ztail, xch.ytail, xch.xlo, xch.xhi, outs,
                          2, origins=[(0, 0, 0)] * 8, grid_shape=grid,
                          **COEFFS)


# ---------------------------------------------------------------------------
# (b) Sharded bfloat16 runs bitwise the one-block run
# ---------------------------------------------------------------------------

def _small_initial(shape, seed):
    """Values in [0, 1): a bfloat16 run that can converge at eps 0.05."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32)).to(BF16)


@pytest.mark.parametrize("kind", ["H-fused", "H", "H-defer"])
@pytest.mark.parametrize("mesh", [(2, 2, 2), (2, 4, 1), (1, 2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_sharded_bf16_cuda_fixed_is_bitwise_one_block(mesh, kind):
    kw = dict(nx=16, ny=20, nz=24, steps=13, dtype="bfloat16", **COEFFS)
    one = solve(HeatConfig(backend="cuda", **kw), device="cpu")
    with tune.force("block_temporal_3d", kind):
        got = solve(HeatConfig(backend="cuda", mesh_shape=mesh,
                               halo_overlap="overlap", **kw), device="cpu")
    assert got.grid.dtype == BF16 and got.steps_run == 13
    assert _same_bits(got.grid, one.grid)


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("mesh", [(2, 2, 2), (2, 4, 1)],
                         ids=lambda m: "x".join(map(str, m)))
def test_sharded_bf16_torch_fixed_is_bitwise_one_block(mesh, depth):
    kw = dict(nx=16, ny=20, nz=24, steps=13, dtype="bfloat16",
              backend="torch", **COEFFS)
    one = solve(HeatConfig(**kw), device="cpu")
    got = solve(HeatConfig(mesh_shape=mesh, halo_depth=depth, **kw),
                device="cpu")
    assert got.grid.dtype == BF16
    assert _same_bits(got.grid, one.grid)


@pytest.mark.parametrize("interval", [6, 8], ids=["multiple_of_k",
                                                  "not_multiple_of_k"])
@pytest.mark.parametrize("backend,kind", [("torch", None),
                                          ("cuda", "H-fused"),
                                          ("cuda", "H"),
                                          ("cuda", "H-defer")])
def test_sharded_bf16_converge_is_bitwise_one_block(backend, kind,
                                                    interval):
    kw = dict(nx=16, ny=16, nz=20, steps=600, converge=True, eps=0.05,
              check_interval=interval, dtype="bfloat16", backend=backend,
              **COEFFS)
    init = _small_initial((16, 16, 20), seed=interval)
    one = solve(HeatConfig(**kw), device="cpu", initial=init)
    cfg = HeatConfig(mesh_shape=(2, 2, 2), halo_overlap="overlap", **kw)
    if kind is None:
        got = solve(cfg, device="cpu", initial=init)
    else:
        with tune.force("block_temporal_3d", kind):
            got = solve(cfg, device="cpu", initial=init)
    assert one.converged and one.steps_run < 600
    assert (got.steps_run, got.converged) == (one.steps_run, one.converged)
    assert got.residual == one.residual
    assert _same_bits(got.grid, one.grid)


def test_sharded_bf16_cuda_route_counts_its_bf16_plain_versions():
    cfg = HeatConfig(nx=16, ny=20, nz=24, steps=6, dtype="bfloat16",
                     backend="cuda", mesh_shape=(2, 2, 2))
    sk.reset_counts()
    solve(cfg, device="cpu")
    # Two rounds of K = 3, the monolithic H-fused round's plain version
    # on each of the 8 bfloat16 blocks.
    assert sk.counts["h_block_fused_plain"] == 2 * 8
    assert not any(n for name, n in sk.counts.items()
                   if name.startswith("heat_"))
    sk.reset_counts()
    with tune.force("block_temporal_3d", "H-defer"):
        solve(cfg.replace(halo_overlap="overlap"), device="cpu")
    assert sk.counts["h_block_fused_plain"] == 2 * 8
    assert sk.counts["h_band_fix_plain"] == 2


# ---------------------------------------------------------------------------
# (c) The torch route against the JAX package's jnp path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("mesh", [(2, 2, 2), (2, 1, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_torch_route_bf16_matches_jax_jnp_bitwise(mesh, depth):
    kw = dict(nx=16, ny=12, nz=20, steps=13, dtype="bfloat16",
              mesh_shape=mesh, halo_depth=depth, **COEFFS)
    theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw))
    ours = solve(HeatConfig(backend="torch", **kw), device="cpu")
    np.testing.assert_array_equal(_bits(ours.grid).numpy(),
                                  _np_bits(theirs.grid))


# ---------------------------------------------------------------------------
# (d) The cuda route against the JAX package's kernel H
# ---------------------------------------------------------------------------

def _ulps(got, want) -> float:
    """max |got - want| in bfloat16 ulps of each expected value."""
    top = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return float((np.abs(got - want) / 2.0 ** (top - 7)).max())


@pytest.mark.parametrize("converge", [False, True], ids=["fixed", "converge"])
def test_cuda_route_bf16_matches_jax_pallas(converge):
    # tests/test_pallas3d_sharded.py test_kernel_h_bf16's run: 16^3 on
    # (2, 2, 2), kernel H in interpret mode at halo_depth=8; the port's
    # kernel rounds at their own depth (K = 3). Every cell within 2
    # bfloat16 ulps of its expected value; rtol=8e-3 is 2 ulps only at the
    # top of a binade, and over the converge case's 32 steps 24 cells
    # differ by 2 ulps just below one (relative 0.00813, as JAX's own
    # kernel H differs from its jnp path), so the fixed 16 steps (1 ulp at
    # most) are also held to rtol=8e-3.
    kw = dict(nx=16, ny=16, nz=16, dtype="bfloat16", mesh_shape=(2, 2, 2))
    kw.update(dict(steps=32, converge=True, eps=1e-3, check_interval=8)
              if converge else dict(steps=16))
    theirs = jx.solve(jx.HeatConfig(backend="pallas", halo_depth=8, **kw))
    ours = solve(HeatConfig(backend="cuda", **kw), device="cpu")
    assert "heat_h_block_3d_fused_bf16" in explain(
        HeatConfig(backend="cuda", **kw), device="cpu")["path"]
    got = ours.grid.float().numpy()
    want = np.asarray(theirs.grid).astype(np.float32)
    assert _ulps(got, want) <= 2
    if not converge:
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=0)
    init = solve(HeatConfig(**{**kw, "steps": 0, "converge": False},
                            backend="cuda"), device="cpu").grid
    _assert_faces(ours.grid, init)
    assert (ours.steps_run, ours.converged) == (theirs.steps_run,
                                                theirs.converged)
    if converge:
        top = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert abs(ours.residual - float(theirs.residual)) <= 2 * ulp


# ---------------------------------------------------------------------------
# (e) A diverging 3D-mesh run against the JAX one-block run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_diverging_mesh_run_matches_the_jax_one_block_run(backend):
    # cx = cy = cz = 0.4 is past the stability bound: the interior blows
    # up to inf and NaN. The JAX package's sharded converge loop reports
    # NaN as converged (ROADMAP.md queue 3), so the port's mesh run is
    # held to the port's one-block run bit for bit, and to JAX's one-block
    # run: not converged, and on the torch route stopped at the same
    # window with the same grid.
    kw = dict(nx=8, ny=12, nz=16, cx=0.4, cy=0.4, cz=0.4, steps=200,
              converge=True, eps=1e-3, check_interval=20, dtype="bfloat16")
    init = np.random.default_rng(3).standard_normal((8, 12, 16)) * 10
    theirs = jx.solve(jx.HeatConfig(backend="jnp", **kw),
                      initial=init.astype(np.float32))
    ut = torch.from_numpy(init.astype(np.float32)).to(BF16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        one = solve(HeatConfig(backend=backend, **kw), device="cpu",
                    initial=ut)
        got = solve(HeatConfig(backend=backend, mesh_shape=(2, 2, 2), **kw),
                    device="cpu", initial=ut)
    assert (got.steps_run, got.converged, str(got.residual)) == (
        one.steps_run, one.converged, str(one.residual))
    assert not got.converged and not theirs.converged
    assert _same_bits(got.grid, one.grid)
    assert not torch.isfinite(got.grid[1:-1, 1:-1, 1:-1].double()).all()
    _assert_faces(got.grid, ut)
    if backend == "torch":
        assert got.steps_run == theirs.steps_run < 200
        np.testing.assert_array_equal(got.grid.double().numpy(),
                                      np.asarray(theirs.grid, np.float64))


# ---------------------------------------------------------------------------
# (f) Entry points, pickers, the circular pitch and explain
# ---------------------------------------------------------------------------

def test_bf16_entry_points_and_pickers():
    assert skb3.KERNEL_OF_BF16 == {
        "H-fused": "heat_h_block_3d_fused_bf16", "H": "heat_h_block_3d_bf16",
        "H-defer": "heat_h_block_3d_fused_bf16"}
    assert skb3.BAND_BF16 == "heat_h_band_fix_3d_bf16"
    for name in (*skb3.KERNEL_OF_BF16.values(), skb3.BAND_BF16):
        assert name in sk.counts
        assert skb3.entry(name[:-5], "bfloat16") == name
        assert skb3.entry(name[:-5], BF16) == name
        assert skb3.entry(name[:-5], torch.float32) == name[:-5]
    block = (512, 512, 512)
    kind, detail = skb3.pick_block_temporal_3d(block, 3, "bfloat16")
    assert (kind, detail["kernel"], detail["load"]) == (
        "H-fused", "heat_h_block_3d_fused_bf16", "tma")
    assert skb3.pick_block_temporal_3d(block, 3)[1]["load"] == "tma"
    # Rows of 92 cells: 184 bytes, no bfloat16 box (float32 takes one).
    kind, detail = skb3.pick_block_temporal_3d((40, 128, 92), 3, BF16)
    assert (kind, detail["load"]) == ("H-fused", "cp.async")
    assert skb3.pick_block_temporal_3d((40, 128, 92), 3)[1]["load"] == "tma"
    with tune.force("block_temporal_3d", "H"):
        kind, detail = skb3.pick_block_temporal_3d(block, 4, BF16)
        assert detail["kernel"] == "heat_h_block_3d_bf16"
        # At bfloat16 K >= 4 takes 12 warps of 2 rows (168 registers).
        assert detail["block"] == (32, 12)
        assert skb3.pick_block_temporal_3d(block, 4)[1]["block"] == (32, 16)
    with tune.force("block_temporal_3d", "H-defer"):
        assert skb3.pick_block_temporal_3d(block, 3, BF16)[1]["kernel"] == \
            "heat_h_block_3d_fused_bf16"


# H-fused's bfloat16 load by block and K: the box where bz % 8 == 0 and
# the block holds a tile inside it at that K (a box is the 32 x 64 (Z, Y)
# extended tile 8 cells wider: bz >= 40), the pairs and registers
# ("cp.async") elsewhere.
H_BF16_LOAD_CASES = [((512, 512, 512), 3, "tma"), ((512, 512, 512), 8, "tma"),
                     ((40, 128, 92), 3, "cp.async"),
                     ((40, 128, 96), 3, "tma"),
                     ((40, 100, 96), 3, "cp.async"),   # no tile inside in y
                     ((40, 128, 48), 8, "tma"),
                     ((40, 128, 48), 1, "cp.async"),   # none inside in z
                     ((20, 128, 136), 5, "tma"), ((6, 50, 70), 3, "cp.async")]


@pytest.mark.parametrize("block,k,load", H_BF16_LOAD_CASES)
def test_bf16_h_load_rule(block, k, load):
    p = params()
    assert p.h_tma_fits(block, k, elem=2) == (load == "tma")
    assert skb3.h_load(block, k, dtype="bfloat16") == load
    assert skb3.h_load(block, k, u=torch.empty(block, dtype=BF16)) == load
    # Float32 boxes need 16-byte rows of 4 cells, and are 4 cells wider.
    assert p.h_tma_fits(block, k) == (
        block[2] % 4 == 0 and block[2] >= 36 and p.h_tiles(block, k)[0] > 0)
    if load == "tma":
        assert p.h_tiles(block, k)[0] > 0 and block[2] % 8 == 0
    assert p.h_tma_box(elem=2) == (64, 40) and p.h_tma_box() == (64, 36)


def test_bf16_h_fused_loads_give_the_same_bits_and_tma_refusals():
    # Blocks of 8 x 120 x 56 at K = 3 hold a tile inside them (from
    # 119 x 55), their rows 112 bytes: both loads run (on the CPU through
    # the plain version) and give the same bits; 8 x 120 x 52 (104-byte
    # rows) and 8 x 100 x 56 (no tile inside along y) refuse a pinned box
    # and run cp.async.
    for grid, boxed in (((16, 240, 112), True), ((16, 240, 104), False),
                        ((16, 200, 112), False)):
        g = _rand_bf16(grid, seed=8, nan=True)
        _, us, bs, xch = _exchanged(g, (2, 2, 2), 3)
        assert (skb3.h_load(bs, 3, us[0]) == "tma") == boxed
        kw = dict(origin=(0, 0, 0), grid_shape=grid, **COEFFS)
        ref = torch.full(bs, float("nan"), dtype=BF16)
        rp = skb3.h_block_fused_plain(us[0], *xch.pieces(0), ref, 3, **kw)
        for load in skb3.LOADS:
            out = torch.full(bs, float("nan"), dtype=BF16)
            if load == "tma" and not boxed:
                with pytest.raises(ValueError, match="TMA load needs bz % 8"):
                    skb3.h_block_fused(us[0], *xch.pieces(0), out, 3,
                                       load=load, **kw)
                continue
            r = skb3.h_block_fused(us[0], *xch.pieces(0), out, 3, load=load,
                                   **kw)
            assert _same_bits(out, ref) and _same_bits(r, rp), load
        with pytest.raises(ValueError, match="load must be one of"):
            skb3.h_block_fused(us[0], *xch.pieces(0), ref, 3, load="plain",
                               **kw)


def test_bf16_loads_and_their_refusals():
    p = params()
    assert p.h_tma_fits((512, 512, 512), 3, elem=2)
    assert skb3.h_load((512, 512, 512), 3, dtype="bfloat16") == "tma"
    assert not p.h_tma_fits((40, 128, 92), 3, elem=2)
    assert skb3.h_load((40, 128, 92), 3, dtype="bfloat16") == "cp.async"
    # The circular block's rows: 16 bytes, so 8 bfloat16 cells.
    assert p.hc_pitch(518) == 520 and p.hc_pitch(518, 2) == 520
    assert p.hc_pitch(522) == 524 and p.hc_pitch(522, 2) == 528
    # The band's vector load: rows of a multiple of 16 bytes.
    assert p.h_band_vec_fits((8, 8, 92)) and not p.h_band_vec_fits(
        (8, 8, 92), 2)
    assert p.h_band_vec_fits((8, 8, 96), 2)
    # The bfloat16 halo along Z is 8 cells: a 112-cell output tile.
    assert p.f_tile(3, (32, 16), 2, 2) == (26, 112)
    assert p.hc_launch((512, 512, 512), 3, elem=2)[:3] == (
        (32, 16), 2, p.hc_prefetch)
    assert p.h_band_shape(3, 2) == ((32, 16), 2, p.h_band_prefetch)
    assert p.h_band_shape(4, 2)[0] == (32, 12)
    grid = (8, 8, 16)
    g = _rand_bf16(grid, seed=4)
    _, us, bs, xch = _exchanged(g, (2, 2, 2), 2)
    kw = dict(origin=(0, 0, 0), grid_shape=grid, **COEFFS)
    with pytest.raises(ValueError, match="TMA load needs bz % 8"):
        skb3.h_block_fused(us[0], *xch.pieces(0), torch.empty_like(us[0]),
                           2, load="tma", **kw)
    skb3.h_block_fused(us[0], *xch.pieces(0), torch.empty_like(us[0]), 2,
                       load="cp.async", **kw)
    contiguous = torch.empty(xch.circular_shape, dtype=BF16)
    assert skb3.h_block_load(contiguous) == "cp.async"   # rows of 12
    assert skb3.h_block_load(xch.new_circular()) == "tma"
    with pytest.raises(ValueError, match="16 bytes"):
        skb3.h_block(contiguous, torch.empty_like(us[0]), 2, load="tma",
                     **kw)
    # Blocks of 6 z cells: 12 bytes a row, no vector load at bfloat16.
    grid = (8, 8, 12)
    mesh, us, bs, xch = _exchanged(_rand_bf16(grid, seed=6), (2, 2, 2), 2)
    operands = (us, xch.ztail, xch.ytail, xch.xlo, xch.xhi,
                [torch.empty_like(u) for u in us], 2)
    kw = dict(origins=[mesh.origin(b, bs) for b in range(8)],
              grid_shape=grid, **COEFFS)
    assert skb3.BandLaunch3D(*operands, **kw).load == "cells"
    with pytest.raises(ValueError, match="16-byte load"):
        skb3.BandLaunch3D(*operands, load="vec", **kw)


def test_explain_names_the_bf16_forms():
    base = dict(nx=32, ny=32, nz=40, dtype="bfloat16", backend="cuda",
                mesh_shape=(2, 2, 2))
    out = explain(HeatConfig(**base), device="cpu")
    assert out["decided_by"]["block_temporal_3d"]["choice"] == "H-fused"
    assert "heat_h_block_3d_fused_bf16" in out["path"]
    assert "4-byte cp.async of the word" in out["path"]
    assert "plain 2-byte load" not in out["path"]
    assert "bfloat16 storage" in out["path"]
    with tune.force("block_temporal_3d", "H-defer"):
        out = explain(HeatConfig(halo_overlap="overlap", **base),
                      device="cpu")
        assert "heat_h_band_fix_3d_bf16" in out["path"]
    with tune.force("block_temporal_3d", "H"):
        out = explain(HeatConfig(**base), device="cpu")
        assert "heat_h_block_3d_bf16" in out["path"]
    out = explain(HeatConfig(**{**base, "backend": "torch"}), device="cpu")
    assert "bfloat16 storage" in out["path"]


# ---------------------------------------------------------------------------
# (g) The CLI on a 3D mesh at bfloat16
# ---------------------------------------------------------------------------

def test_cli_3d_mesh_bf16_writes_the_jax_clis_bytes(tmp_path, capsys):
    # The port's torch rounds and the JAX CLI's jnp path on the same mesh
    # compute the same textbook tree at the same rounding points, so the
    # .npy files ('<V2' cells) are the same bytes; the port's cuda route
    # (the H family's bfloat16 plain versions here) writes its one-block
    # run's bytes.
    from parallel_heat_tpu import cli as jcli
    from parallel_heat_tpu_torch import cli

    base = ["--nx", "12", "--ny", "16", "--nz", "20", "--steps", "13",
            "--dtype", "bfloat16", "--mesh", "2,2,2"]
    for name, main, argv in (
            ("ours", cli.main, base + ["--device", "cpu", "--backend",
                                       "torch"]),
            ("theirs", jcli.main, base + ["--backend", "jnp"]),
            ("cuda_mesh", cli.main, base + ["--device", "cpu", "--backend",
                                            "cuda"]),
            ("cuda_one", cli.main, base[:-2] + ["--device", "cpu",
                                                "--backend", "cuda"])):
        rc = main(argv + ["--out", str(tmp_path / f"{name}.npy")])
        out = capsys.readouterr()
        assert rc == 0, out.err
    ours = (tmp_path / "ours.npy").read_bytes()
    assert ours == (tmp_path / "theirs.npy").read_bytes()
    assert b"'<V2'" in ours[:128]
    assert ((tmp_path / "cuda_mesh.npy").read_bytes()
            == (tmp_path / "cuda_one.npy").read_bytes())
