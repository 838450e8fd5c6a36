"""The sharded block kernels of the PyTorch port (G-uni, G-fuse, G-circ,
G and the band fix) against the JAX package's kernel-G builders.

On the CPU the port's wrappers run their plain PyTorch versions (the
CUDA kernels are held bitwise to those versions on the card by
``chip_smoke.py`` and ``tests/test_torch_card.py``). Here the plain
versions are held to the JAX package's Pallas builders
``_build_temporal_block_uniform``, ``_build_temporal_block_fused``,
``_build_temporal_block_circular``, ``_build_temporal_block`` and
``_build_band_fix_2d``, run in interpret mode as ``tests/test_temporal.py``
runs them, at K = 8 (the builders' f32 depth), on one block at a time.
The operands are cut out of a seeded global grid with numpy, as the
exchange delivers them, for a corner, an edge and an interior block of a
(3, 3) mesh, with cx = cy and cx != cy; the port's own exchange must give
the same operands bitwise.

Tolerances: ``rtol=1e-5, atol=1e-5`` on grids and ``rtol=1e-4`` on
residuals, the few-ulp contract of ``tests/test_torch_kernels.py``: the
JAX kernels pin the Dirichlet ring by multiplying with coefficient
vectors and XLA:CPU may contract multiply-adds into FMAs, where the port
selects and rounds every operation. The Dirichlet cells of a block are
held bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
from parallel_heat_tpu_torch.parallel import temporal
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

K = 8
MESH = (3, 3)
BLOCK = (16, 24)
GRID = (MESH[0] * BLOCK[0], MESH[1] * BLOCK[1])
BLOCKS = {"corner": 0, "edge": 1, "interior": 4}
COEFFS = [(0.1, 0.1), (0.1, 0.2)]


def _grid(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(GRID) * 10).astype(np.float32)


def _at(g, rows, cols):
    """``g[rows][:, cols]`` with zeros outside the grid."""
    out = np.zeros((len(rows), len(cols)), np.float32)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            if 0 <= r < g.shape[0] and 0 <= c < g.shape[1]:
                out[i, j] = g[r, c]
    return out


def _pieces_np(g, b, k=K):
    """Block ``b``'s ``u``, tail ``[hi | lo]`` and halo rows (circular
    columns ``[u | hi | lo]``), cut from the global grid in numpy."""
    bx, by = BLOCK
    r0, c0 = (b // MESH[1]) * bx, (b % MESH[1]) * by
    rows = list(range(r0, r0 + bx))
    circ = (list(range(c0, c0 + by + k))
            + list(range(c0 - k, c0)))
    u = g[r0:r0 + bx, c0:c0 + by].copy()
    tail = np.concatenate([_at(g, rows, range(c0 + by, c0 + by + k)),
                           _at(g, rows, range(c0 - k, c0))], axis=1)
    hn = _at(g, range(r0 - k, r0), circ)
    hs = _at(g, range(r0 + bx, r0 + bx + k), circ)
    return (r0, c0), u, tail, hn, hs


def _close_grid(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _close_res(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def _ring_exact(out, u, origin, rows=slice(None)):
    """The block's cells on the global Dirichlet ring kept their values."""
    r0, c0 = origin
    bx, by = BLOCK
    gr = r0 + np.arange(bx)[:, None]
    gc = c0 + np.arange(by)[None, :]
    ring = ((gr == 0) | (gr == GRID[0] - 1) | (gc == 0)
            | (gc == GRID[1] - 1))
    ring = np.broadcast_to(ring, (bx, by)).copy()
    keep = np.zeros((bx, by), bool)
    keep[rows] = True
    sel = ring & keep
    np.testing.assert_array_equal(np.asarray(out)[sel], u[sel])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("where", sorted(BLOCKS))
def test_port_exchange_delivers_the_numpy_pieces(where):
    g = _grid()
    b = BLOCKS[where]
    mesh = HeatMesh(MESH)
    us = mesh.split(torch.from_numpy(g))
    tail, hn, hs = temporal.exchange_halos_fused_2d(mesh, us, K)[b]
    _, u, w_tail, w_hn, w_hs = _pieces_np(g, b)
    for got, want in ((us[b], u), (tail, w_tail), (hn, w_hn), (hs, w_hs)):
        np.testing.assert_array_equal(got.numpy(), want)
    circ = temporal.exchange_halos_circular_2d(mesh, us, K)[b]
    np.testing.assert_array_equal(
        circ.numpy(), np.concatenate(
            [w_hn, np.concatenate([u, w_tail], axis=1), w_hs], axis=0))


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("where", sorted(BLOCKS))
@pytest.mark.parametrize("kind", ["G-uni", "G-fuse"])
def test_pieces_kernel_matches_jax_builder(kind, where, cx, cy):
    builder = (ps._build_temporal_block_uniform if kind == "G-uni"
               else ps._build_temporal_block_fused)
    origin, u, tail, hn, hs = _pieces_np(_grid(), BLOCKS[where])
    fn = builder(BLOCK, "float32", cx, cy, GRID, K)
    want, wres = fn(jnp.asarray(u), jnp.asarray(tail), jnp.asarray(hn),
                    jnp.asarray(hs), *origin)
    out = torch.empty(BLOCK)
    res = skb.LAUNCH[kind](_t(u), _t(tail), _t(hn), _t(hs), out, K,
                           origin=origin, grid_shape=GRID, cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _ring_exact(out.numpy(), u, origin)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("where", sorted(BLOCKS))
@pytest.mark.parametrize("kind", ["G-uni", "G-fuse"])
def test_deferred_bulk_matches_jax_builder(kind, where, cx, cy):
    builder = (ps._build_temporal_block_uniform if kind == "G-uni"
               else ps._build_temporal_block_fused)
    origin, u, tail, _, _ = _pieces_np(_grid(), BLOCKS[where])
    fn = builder(BLOCK, "float32", cx, cy, GRID, K, defer_ns=True)
    want, wres = fn(jnp.asarray(u), jnp.asarray(tail), *origin)
    out = torch.full(BLOCK, float("nan"))
    res = skb.LAUNCH[kind](_t(u), _t(tail), None, None, out, K,
                           origin=origin, grid_shape=GRID, cx=cx, cy=cy)
    rows = slice(K, BLOCK[0] - K)
    _close_grid(out.numpy()[rows], np.asarray(want)[rows])
    _close_res(res, wres)
    _ring_exact(out.numpy(), u, origin, rows)
    # The bulk writes no band row.
    assert np.isnan(out.numpy()[:K]).all() and np.isnan(
        out.numpy()[-K:]).all()


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("where", sorted(BLOCKS))
def test_band_fix_matches_jax_builder(where, cx, cy):
    origin, u, tail, hn, hs = _pieces_np(_grid(), BLOCKS[where])
    fn = ps._build_band_fix_2d(BLOCK, "float32", cx, cy, GRID, K)
    want, wres = fn(jnp.asarray(u), jnp.asarray(tail), jnp.asarray(hn),
                    jnp.asarray(hs), *origin)
    out = torch.full(BLOCK, float("nan"))
    res = skb.band_fix(_t(u), _t(tail), _t(hn), _t(hs), out, K,
                       origin=origin, grid_shape=GRID, cx=cx, cy=cy)
    got = np.concatenate([out.numpy()[:K], out.numpy()[-K:]])
    _close_grid(got, want)
    _close_res(res, wres)
    # In place: the rows between the bands are untouched.
    assert np.isnan(out.numpy()[K:-K]).all()


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("where", sorted(BLOCKS))
@pytest.mark.parametrize("kind", ["G-circ", "G"])
def test_assembled_kernel_matches_jax_builder(kind, where, cx, cy):
    origin, u, tail, hn, hs = _pieces_np(_grid(), BLOCKS[where])
    bx, by = BLOCK
    circ = np.concatenate([hn, np.concatenate([u, tail], axis=1), hs])
    if kind == "G-circ":
        ext = circ
        fn = ps._build_temporal_block_circular(BLOCK, "float32", cx, cy,
                                               GRID, K)
        want, wres = fn(jnp.asarray(ext), *origin)
    else:
        ext = skb.padded_of_circular(_t(circ), by, K).numpy()
        fn = ps._build_temporal_block(BLOCK, "float32", cx, cy, GRID, K)
        wide = np.zeros((bx + 2 * K, fn.padded_width), np.float32)
        wide[:, :by + 2 * K] = ext
        rows, wres = fn(jnp.asarray(wide), origin[0], origin[1] - K)
        want = np.asarray(rows)[:, K:K + by]
    out = torch.empty(BLOCK)
    res = skb.LAUNCH[kind](_t(ext), out, K, origin=origin, grid_shape=GRID,
                           cx=cx, cy=cy)
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _ring_exact(out.numpy(), u, origin)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("where", sorted(BLOCKS))
def test_plain_kinds_bitwise_each_other_and_one_grid_steps(where, k):
    """Every form, and the deferred bulk spliced with the band, is
    bitwise the others and bitwise k plain steps of the global grid (the
    chain the card holds the kernels to: G(K) is E(K) on the block)."""
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    g = _grid(seed=3)
    mesh = HeatMesh(MESH)
    b = BLOCKS[where]
    us = mesh.split(torch.from_numpy(g))
    origin = mesh.origin(b, BLOCK)
    tail, hn, hs = temporal.exchange_halos_fused_2d(mesh, us, k)[b]
    kw = dict(origin=origin, grid_shape=GRID, cx=0.1, cy=0.2)
    e_out = torch.empty(GRID)
    sk.temporal_steps(torch.from_numpy(g), e_out, k, cx=0.1, cy=0.2)
    want = e_out[origin[0]:origin[0] + BLOCK[0],
                 origin[1]:origin[1] + BLOCK[1]]
    outs = {}
    for kind in ("G-uni", "G-fuse"):
        outs[kind] = torch.empty(BLOCK)
        res = skb.LAUNCH[kind](us[b], tail, hn, hs, outs[kind], k, **kw)
        split = torch.empty(BLOCK)
        r_bulk = skb.LAUNCH[kind](us[b], tail, None, None, split, k, **kw)
        r_band = skb.band_fix(us[b], tail, hn, hs, split, k, **kw)
        assert torch.equal(split, outs[kind])
        assert float(torch.maximum(r_bulk, r_band)) == float(res)
    circ = temporal.exchange_halos_circular_2d(mesh, us, k)[b]
    pad = temporal.exchange_halos_deep_2d(mesh, us, k)[b]
    for kind, ext in (("G-circ", circ), ("G", pad)):
        outs[kind] = torch.empty(BLOCK)
        skb.LAUNCH[kind](ext, outs[kind], k, **kw)
    for kind, out in outs.items():
        assert torch.equal(out, want), kind


def _round_operands(grid, mesh_shape, k, seed):
    """Every block of a seeded ``grid`` on ``mesh_shape``, the port's
    exchange at depth ``k`` and the blocks' origins."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(grid) * 10).astype(np.float32)
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(torch.from_numpy(g))
    pieces = temporal.exchange_halos_fused_2d(mesh, us, k)
    bs = mesh.block_shape(grid)
    return us, pieces, [mesh.origin(b, bs) for b in range(mesh.size)]


# (mesh, block): blocks of exactly 2K rows and of more, widths that are
# and are not a multiple of 4 (a ragged last column tile either way).
BAND_MESHES = [((1, 2), (0, 13)), ((2, 2), (0, 24)), ((2, 4), (5, 13)),
               ((2, 4), (0, 22))]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("mesh_shape,extra", BAND_MESHES)
def test_band_blocks_plain_equals_per_block_plain(mesh_shape, extra, k):
    """The batched plain version (every block's band windows stepped as
    one batch) is bitwise the per-block plain version on each block,
    grid and residual, and writes no row between the bands."""
    rows = max(2 * k, 2) + extra[0]
    grid = (mesh_shape[0] * rows, mesh_shape[1] * extra[1])
    us, pieces, origins = _round_operands(grid, mesh_shape, k, seed=k)
    kw = dict(grid_shape=grid, cx=0.1, cy=0.2)
    got = [torch.full(u.shape, float("nan")) for u in us]
    want = [torch.full(u.shape, float("nan")) for u in us]
    r = skb.band_fix_blocks_plain(us, *zip(*pieces), got, k,
                                  origins=origins, **kw)
    rs = [skb.band_fix_plain(u, *pc, w, k, origin=o, **kw)
          for u, pc, w, o in zip(us, pieces, want, origins)]
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.nan_to_num(7.0), w_.nan_to_num(7.0))
        assert g_[k:-k].isnan().all()
    assert float(r) == float(torch.stack(rs).amax())
    assert skb.band_fix_blocks_plain(us, *zip(*pieces), got, k, False,
                                     origins=origins, **kw) is None


@pytest.mark.parametrize("cx,cy", COEFFS)
def test_band_blocks_match_jax_builder(cx, cy):
    """Every block of the (3, 3) mesh in one call of the batched band
    (its plain version here), each block against the JAX builder."""
    g = _grid()
    mesh = HeatMesh(MESH)
    us = mesh.split(torch.from_numpy(g))
    pieces = temporal.exchange_halos_fused_2d(mesh, us, K)
    origins = [mesh.origin(b, BLOCK) for b in range(mesh.size)]
    outs = [torch.full(BLOCK, float("nan")) for _ in us]
    res = skb.band_fix_blocks(us, *zip(*pieces), outs, K, origins=origins,
                              grid_shape=GRID, cx=cx, cy=cy)
    fn = ps._build_band_fix_2d(BLOCK, "float32", cx, cy, GRID, K)
    wres_all = []
    for where, b in sorted(BLOCKS.items()):
        origin, u, tail, hn, hs = _pieces_np(g, b)
        want, wres = fn(jnp.asarray(u), jnp.asarray(tail), jnp.asarray(hn),
                        jnp.asarray(hs), *origin)
        got = np.concatenate([outs[b].numpy()[:K], outs[b].numpy()[-K:]])
        _close_grid(got, want)
        _ring_exact(outs[b].numpy(), u, origin, np.r_[:K, -K:0])
        wres_all.append(float(wres))
    for out in outs:
        assert np.isnan(out.numpy()[K:-K]).all()
    # The residual is the max over all nine blocks' bands; the three
    # blocks the builder ran bound it from below.
    assert float(res) >= max(wres_all) * (1 - 1e-4)


@pytest.mark.parametrize("block,k,rows", [((16, 24), 8, True),
                                          ((16, 24), 2, True),
                                          ((16, 24), 3, False),
                                          ((500, 250), 8, False),
                                          ((500, 252), 1, False),
                                          ((16384, 8192), 8, True)])
def test_band_row_load_rule(block, k, rows):
    """The band kernel copies its windows' core columns 16 bytes at a
    time where the block's width and its halo rows (by + 2k) are
    multiples of 4 floats; the launch names the load it takes."""
    from parallel_heat_tpu_torch.ops.hopper_params import params

    assert params().g_band_row_load(block, k) is rows
    if block[0] > 500:
        return
    grid = (2 * block[0], 2 * block[1])
    us, pieces, origins = _round_operands(grid, (2, 2), k, seed=3)
    outs = [torch.empty_like(u) for u in us]
    launch = skb.BandLaunch(us, *zip(*pieces), outs, k, origins=origins,
                            grid_shape=grid, cx=0.1, cy=0.1)
    assert launch.load == ("rows" if rows else "cells")


def test_band_blocks_refuse_bad_operands():
    us, pieces, origins = _round_operands((32, 48), (2, 2), 3, seed=1)
    tails, hns, hss = (list(x) for x in zip(*pieces))
    outs = [torch.empty_like(u) for u in us]
    kw = dict(grid_shape=(32, 48), cx=0.1, cy=0.1)
    with pytest.raises(ValueError, match="one tail"):
        skb.band_fix_blocks(us, tails[:3], hns, hss, outs, 3,
                            origins=origins, **kw)
    with pytest.raises(ValueError, match="one shape"):
        skb.band_fix_blocks(us, tails, hns, hss,
                            outs[:3] + [torch.empty((16, 20))], 3,
                            origins=origins, **kw)
    with pytest.raises(ValueError, match="both halo rows"):
        skb.band_fix_blocks(us, tails, [None] * 4, [None] * 4, outs, 3,
                            origins=origins, **kw)
    thin, thin_pieces, thin_origins = _round_operands((10, 48), (2, 2), 3,
                                                      seed=2)
    with pytest.raises(ValueError, match="at least 2k"):
        skb.band_fix_blocks(thin, *zip(*thin_pieces),
                            [torch.empty_like(u) for u in thin], 3,
                            origins=thin_origins, grid_shape=(10, 48),
                            cx=0.1, cy=0.1)
    with pytest.raises(ValueError, match="does not take"):
        skb.BandLaunch(us, tails, hns, hss, outs, 3, origins=origins,
                       geometry=(238, 32, 8), **kw)
    with pytest.raises(ValueError, match="row load needs"):
        skb.BandLaunch(us, tails, hns, hss, outs, 3, origins=origins,
                       load="rows", **kw)
    with pytest.raises(ValueError, match="load must be one of"):
        skb.BandLaunch(us, tails, hns, hss, outs, 3, origins=origins,
                       load="tma", **kw)
    with pytest.raises(ValueError, match="measurement on the card"):
        skb.BandLaunch(us, tails, hns, hss, outs, 3, origins=origins,
                       load="none", **kw)
    with pytest.raises(ValueError, match="does not lie in the grid"):
        skb.band_fix_blocks(us, tails, hns, hss, outs, 3,
                            origins=origins[:3] + [(20, 30)], **kw)


def test_nan_block_gives_nan_residual_and_keeps_the_ring():
    g = _grid(seed=5)
    g[1, 30] = np.nan  # in the corner block (0, 1) next to the ring
    mesh = HeatMesh(MESH)
    us = mesh.split(torch.from_numpy(g))
    b = 1
    tail, hn, hs = temporal.exchange_halos_fused_2d(mesh, us, K)[b]
    out = torch.empty(BLOCK)
    res = skb.block_fused(us[b], tail, hn, hs, out, K,
                          origin=mesh.origin(b, BLOCK), grid_shape=GRID,
                          cx=0.1, cy=0.1)
    assert np.isnan(float(res))
    np.testing.assert_array_equal(out[0].numpy(), us[b][0].numpy())


def test_wrappers_refuse_bad_operands():
    u = torch.zeros(BLOCK)
    tail, hn = torch.zeros((16, 2 * K)), torch.zeros((K, 24 + 2 * K))
    kw = dict(origin=(0, 0), grid_shape=GRID, cx=0.1, cy=0.1)
    with pytest.raises(ValueError, match="both halo rows, or neither"):
        skb.block_fused(u, tail, hn, None, torch.empty(BLOCK), K, **kw)
    with pytest.raises(ValueError, match="multiple of 4"):
        skb.block_uniform(torch.zeros((16, 22)), torch.zeros((16, 2 * K)),
                          None, None, torch.empty((16, 22)), K, **kw)
    with pytest.raises(ValueError, match="2k"):
        skb.block_fused(torch.zeros((12, 24)), torch.zeros((12, 2 * K)),
                        None, None, torch.empty((12, 24)), K, **kw)
    with pytest.raises(ValueError, match="tail shape"):
        skb.block_fused(u, torch.zeros((16, K)), hn, hn,
                        torch.empty(BLOCK), K, **kw)
    with pytest.raises(ValueError, match="u shape"):
        skb.block_fused(torch.zeros((16, 20)), tail, hn, hn,
                        torch.empty(BLOCK), K, **kw)
    with pytest.raises(ValueError, match="does not lie in the grid"):
        skb.block_fused(u, tail, hn, hn, torch.empty(BLOCK), K,
                        **{**kw, "origin": (40, 0)})


def test_picker_default_forced_and_refused():
    from parallel_heat_tpu_torch import tune

    assert skb.pick_block_temporal_2d((16, 24), 8)[0] == "G-uni"
    assert skb.pick_block_temporal_2d((500, 250), 8)[0] == "G-fuse"
    for kind in ("G-circ", "G", "torch"):
        with tune.force("block_temporal_2d", kind):
            assert skb.pick_block_temporal_2d((16, 24), 8)[0] == kind
    with tune.force("block_temporal_2d", "G-uni"):
        with pytest.raises(ValueError, match="infeasible"):
            skb.pick_block_temporal_2d((500, 250), 8)
    assert skb.pick_block_temporal_2d_deferred("G-uni", (16, 24), 8,
                                               "overlap")
    assert not skb.pick_block_temporal_2d_deferred("G-uni", (10, 24), 8,
                                                   "overlap")
    assert not skb.pick_block_temporal_2d_deferred("G-uni", (16, 24), 8,
                                                   "phase")
    assert not skb.pick_block_temporal_2d_deferred("G-circ", (16, 24), 8,
                                                   "overlap")


# ---------------------------------------------------------------------------
# The register-blocked tile loop's rules (csrc/heat_temporal.cuh): shared
# memory, blocks an SM, depth, launch shapes, tile kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(1, 13))
@pytest.mark.parametrize("tile_x", [4, 28, 112, 240])
def test_g_rows_put_the_core_on_a_16_byte_boundary(k, tile_x):
    from parallel_heat_tpu_torch.ops.hopper_params import params

    sx = params().row_floats(k, tile_x)
    pad = (4 - k % 4) % 4
    assert (pad + k) % 4 == 0  # tile column k starts a group
    assert sx % 4 == 0 and pad + tile_x + 2 * k <= sx < pad + tile_x + 2 * k + 4


def test_g_smem_blocks_per_sm_and_k_max():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    ty, tx = p.g_tile
    for k in range(1, 10):
        assert p.g_smem_bytes(k) == 2 * (ty + 2 * k) * p.row_floats(k, tx) * 4
    # At 96 x 112: K = 8 is a 112 x 128 framed tile, two buffers of 56 KiB.
    assert p.row_floats(8, tx) == 128 and p.g_smem_bytes(8) == 114_688
    k_max = p.g_k_max()
    assert k_max == 8
    per_block = (p.smem_per_sm // p.e_min_blocks_per_sm
                 - p.smem_reserved_per_block)
    assert p.g_smem_bytes(k_max) + p.static_smem_bytes <= per_block
    assert p.g_smem_bytes(k_max + 1) + p.static_smem_bytes > per_block
    assert p.g_blocks_per_sm(k_max) >= p.e_min_blocks_per_sm
    assert p.g_blocks_per_sm(k_max + 1) < p.e_min_blocks_per_sm
    # Threads cap it too: 32 x 16 threads, 512 a block, four a SM.
    assert p.g_blocks_per_sm(1, (8, 112), (32, 16)) == 4
    # A smaller tile fits more blocks and deeper K.
    assert p.g_blocks_per_sm(8, (56, 112), (32, 4)) == 3
    assert p.g_blocks_per_sm(8, (32, 112), (32, 4)) == 4
    assert p.g_k_max((32, 112)) > k_max
    # Rows a warp: ceil((TY + 2K) / warps).
    assert p.g_run(8) == 14 and p.g_run(1, (96, 112), (32, 16)) == 7


@pytest.mark.parametrize("tile,block,ok", [
    ((96, 112), (32, 8), True),
    ((40, 240), (32, 16), True),
    ((1, 4), (32, 1), True),
    ((96, 110), (32, 8), False),    # width not a multiple of 4
    ((96, 2), (32, 8), False),
    ((0, 112), (32, 8), False),
    ((96, 112), (16, 16), False),   # a row of threads must be a warp
    ((96, 112), (64, 4), False),
    ((96, 112), (32, 17), False),   # over the 512-thread launch bound
    ((96, 112), (32, 32), False),
    ((96, 112), (32, 0), False),
])
def test_g_takes_the_loops_launch_shapes(tile, block, ok):
    from parallel_heat_tpu_torch.ops.hopper_params import params

    assert params().loop_takes(tile, block) is ok


def test_g_defaults_are_shapes_the_loop_takes():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    assert p.loop_takes(p.g_tile, p.g_block)
    for k in range(1, p.g_k_max() + 1):
        assert p.loop_takes((k, p.g_band_tile_x), p.g_band_block)


@pytest.mark.parametrize("name,geometry", [
    ("heat_g_block_uniform", (96, 110, 32, 8)),
    ("heat_g_block_fused", (96, 112, 16, 16)),
    ("heat_g_block_circular", (96, 112, 32, 32)),
    ("heat_g_band_fix", (238, 32, 16)),
])
def test_launch_refuses_shapes_the_loop_cannot_take(name, geometry):
    u = torch.zeros(BLOCK)
    kw = dict(origin=(0, 0), grid_shape=GRID, cx=0.1, cy=0.1)
    with pytest.raises(ValueError, match="does not take"):
        skb._launch(name, (u,), torch.empty(BLOCK), K, True,
                    geometry=geometry, **kw)


def test_g_tile_kinds_count_the_branches():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    # 500 x 250 blocks at K = 8: 6 x 3 tiles of 96 x 112, the last row
    # tile 20 rows, the last column tile 26 columns (a group of 2).
    kinds = p.g_tile_kinds((500, 250), 8, origin=(0, 250),
                           grid_shape=(1000, 1000))
    assert kinds["tiles"] == 18
    assert kinds["inside"] + kinds["block_edge"] == 18
    assert kinds["inside"] == 4  # row tiles 1-4 of column tile 1
    assert kinds["ragged_rows"] == 3 and kinds["ragged_cols"] == 6
    assert kinds["partial_group"] == 6
    assert kinds["global_edge"] == 3  # the top row of tiles
    assert p.g_tile_kinds((500, 252), 8)["partial_group"] == 0
    # The deferred bulk's region and the band's windows.
    bulk = p.g_tile_kinds((16384, 8192), 8, [(8, 16384 - 16)])
    assert bulk["tiles"] == 171 * 74 and bulk["ragged_rows"] == 74
    band = p.g_tile_kinds((16384, 8192), 8, [(0, 8), (16376, 8)],
                          (8, p.g_band_tile_x))
    assert band["tiles"] == 2 * 74 and band["inside"] == 0
    # The round's band launch over the 8 blocks of 32768^2 on (2, 4): 1184
    # thread blocks, 9 an SM by shared memory, so about one full wave of
    # the 132 SMs (one block alone gives 148, 1.1 an SM).
    thread_blocks = 8 * band["tiles"]
    assert thread_blocks == 1184 and thread_blocks > 8 * p.sm_count
    assert p.g_blocks_per_sm(8, (8, p.g_band_tile_x), p.g_band_block) == 9


def test_picker_and_explain_name_the_kernel_and_its_shape():
    from parallel_heat_tpu_torch import HeatConfig, explain
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    kind, detail = skb.pick_block_temporal_2d((16384, 8192), 8)
    assert kind == "G-uni" and detail["kernel"] == "heat_g_block_uniform"
    assert detail["tile"] == p.g_tile and detail["block"] == p.g_block
    assert detail["rows_per_warp"] == p.g_run(8)
    out = explain(HeatConfig(nx=32768, ny=32768, steps=200,
                             mesh_shape=(2, 4), backend="cuda"),
                  device="cpu")
    ty, tx = p.g_tile
    lanes, warps = p.g_block
    assert "heat_g_block_uniform" in out["path"]
    assert f"tile={ty}x{tx}, {lanes}x{warps} threads" in out["path"]
    assert f"warp's {p.g_run(8)} rows" in out["path"]
    fuse = explain(HeatConfig(nx=1000, ny=1000, mesh_shape=(2, 4),
                              backend="cuda"), device="cpu")
    assert "heat_g_block_fused" in fuse["path"]
    assert f"{lanes}x{warps} threads" in fuse["path"]
