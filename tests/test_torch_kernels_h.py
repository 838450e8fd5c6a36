"""The sharded 3D block kernels of the PyTorch port (H-fused, H and the 3D
band fix) against the JAX package's kernel-H builders.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held bitwise to those versions, and to kernel F's K steps, on
the card by ``chip_smoke.py`` and ``tests/test_torch_card.py``). Here the
plain versions are held to the JAX package's Pallas builders
``_build_temporal_block_3d``, ``_build_temporal_block_3d_fused`` (with and
without ``defer_x``) and ``_build_band_fix_3d``, run in interpret mode as
``tests/test_pallas3d_sharded.py`` runs them, on one block at a time. The
operands are cut out of a seeded global grid with numpy, as the exchange
delivers them, for a corner, an edge and an interior block of a (3, 3, 3)
mesh; the port's own exchange must give the same operands bitwise. The
JAX operands take the layout its builders ask for (``fn.tail_y``,
``fn.tail_z``: y tails padded with seam zeros to the sublane multiple);
the port's tails are ``[hi | lo]``, 2K wide.

Tolerances: ``rtol=1e-5, atol=1e-5`` on grids and ``rtol=1e-4`` on
residuals, the few-ulp contract of ``tests/test_torch_kernels_g.py``:
XLA:CPU may contract multiply-adds into FMAs, where the port rounds every
operation. The Dirichlet cells of a block are held bit-exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch import HeatConfig, explain, tune
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.parallel import temporal3d
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

MESH = (3, 3, 3)
BLOCK = (12, 10, 14)
GRID = tuple(m * b for m, b in zip(MESH, BLOCK))
# Mesh coordinates (0, 0, 0), (1, 0, 0) and (1, 1, 1).
BLOCKS = {"corner": 0, "edge": 9, "interior": 13}
COEFFS = [(0.1, 0.1, 0.1), (0.1, 0.15, 0.05)]
# K = 3 leaves two seam zeros in JAX's y tail (8 wide), K = 4 none.
CASES = ([(where, 3, c) for where in sorted(BLOCKS) for c in COEFFS]
         + [("interior", 4, COEFFS[1])])


def _grid(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(GRID) * 10).astype(np.float32)


def _at(g, xs, ys, zs):
    """``g[xs][:, ys][:, :, zs]`` with zeros outside the grid."""
    out = np.zeros((len(xs), len(ys), len(zs)), np.float32)
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            for m, z in enumerate(zs):
                if (0 <= x < g.shape[0] and 0 <= y < g.shape[1]
                        and 0 <= z < g.shape[2]):
                    out[i, j, m] = g[x, y, z]
    return out


def _circ(o, b, k, tail):
    """Global indices of an axis in the circular order ``[u | hi | seam |
    lo]`` (``None`` for a seam cell), the tail ``tail`` wide."""
    return (list(range(o, o + b + k)) + [None] * (tail - 2 * k)
            + list(range(o - k, o)))


def _take(g, xs, ys, zs):
    """``_at`` where ``None`` indices (seam cells) give zeros."""
    out = np.zeros((len(xs), len(ys), len(zs)), np.float32)
    ok = lambda v, n: v is not None and 0 <= v < n  # noqa: E731
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            for m, z in enumerate(zs):
                if (ok(x, g.shape[0]) and ok(y, g.shape[1])
                        and ok(z, g.shape[2])):
                    out[i, j, m] = g[x, y, z]
    return out


def _origin(b, mesh=MESH, block=BLOCK):
    c = HeatMesh(mesh).coords(b)
    return tuple(ci * bi for ci, bi in zip(c, block))


def _pieces_np(g, b, k, tail_y=None, tail_z=None, mesh=MESH, block=BLOCK):
    """Block ``b``'s ``u``, z tail, y tail and x slabs cut from the global
    grid ``g`` of a ``mesh`` of ``block`` blocks in numpy; tails ``2k``
    wide (the port's) unless given (JAX's)."""
    tail_y, tail_z = tail_y or 2 * k, tail_z or 2 * k
    bx, by, bz = block
    ox, oy, oz = _origin(b, mesh, block)
    xs = list(range(ox, ox + bx))
    ys = list(range(oy, oy + by))
    zc = _circ(oz, bz, k, tail_z)
    yc = _circ(oy, by, k, tail_y)
    u = g[ox:ox + bx, oy:oy + by, oz:oz + bz].copy()
    zt = _take(g, xs, ys, zc[bz:])
    yt = _take(g, xs, yc[by:], zc)
    xlo = _take(g, list(range(ox - k, ox)), yc, zc)
    xhi = _take(g, list(range(ox + bx, ox + bx + k)), yc, zc)
    return u, zt, yt, xlo, xhi


def _close_grid(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _close_res(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def _faces_exact(out, u, origin, planes=slice(None)):
    """The block's cells on the global Dirichlet faces kept their values."""
    idx = [o + np.arange(b) for o, b in zip(origin, BLOCK)]
    face = np.zeros(BLOCK, bool)
    for axis, (i, n) in enumerate(zip(idx, GRID)):
        shape = [1, 1, 1]
        shape[axis] = -1
        face |= ((i == 0) | (i == n - 1)).reshape(shape)
    keep = np.zeros(BLOCK, bool)
    keep[planes] = True
    sel = face & keep
    np.testing.assert_array_equal(np.asarray(out)[sel], u[sel])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_args(k, coeffs):
    return (BLOCK, "float32", *coeffs, GRID, k, (k, k, k))


def _jax_offsets(b, k):
    ox, oy, oz = _origin(b)
    return ox - k, oy, oz


def _kw(b, coeffs):
    return dict(origin=_origin(b), grid_shape=GRID,
                **dict(zip(("cx", "cy", "cz"), coeffs)))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("where", sorted(BLOCKS))
def test_port_exchange_delivers_the_numpy_pieces(where, k):
    g = _grid()
    b = BLOCKS[where]
    mesh = HeatMesh(MESH)
    us = mesh.split(torch.from_numpy(g))
    got = temporal3d.exchange_halos_fused_3d(mesh, us, k)[b]
    want = _pieces_np(g, b, k)
    np.testing.assert_array_equal(us[b].numpy(), want[0])
    for piece, w in zip(got, want[1:]):
        np.testing.assert_array_equal(piece.numpy(), w)
    # The circular block: x [lo | u | hi], y and z [u | hi | lo].
    u, zt, yt, xlo, xhi = want
    core = np.concatenate([np.concatenate([u, zt], axis=2), yt], axis=1)
    np.testing.assert_array_equal(
        temporal3d.exchange_halos_circular_3d(mesh, us, k)[b].numpy(),
        np.concatenate([xlo, core, xhi]))
    # The padded block of the textbook rounds: every axis [lo | u | hi].
    ox, oy, oz = _origin(b)
    np.testing.assert_array_equal(
        temporal3d.exchange_halos_deep_3d(mesh, us, k)[b].numpy(),
        _at(g, range(ox - k, ox + BLOCK[0] + k),
            range(oy - k, oy + BLOCK[1] + k),
            range(oz - k, oz + BLOCK[2] + k)))


@pytest.mark.parametrize("where,k,coeffs", CASES)
def test_fused_matches_jax_builder(where, k, coeffs):
    b = BLOCKS[where]
    g = _grid()
    fn = ps._build_temporal_block_3d_fused(*_jax_args(k, coeffs))
    jp = _pieces_np(g, b, k, fn.tail_y, fn.tail_z)
    want, wres = fn(*map(jnp.asarray, jp), *_jax_offsets(b, k))
    u, zt, yt, xlo, xhi = _pieces_np(g, b, k)
    out = torch.empty(BLOCK)
    res = skb3.h_block_fused(_t(u), _t(zt), _t(yt), _t(xlo), _t(xhi), out, k,
                             **_kw(b, coeffs))
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _faces_exact(out.numpy(), u, _origin(b))


@pytest.mark.parametrize("where,k,coeffs", CASES)
def test_deferred_bulk_matches_jax_builder(where, k, coeffs):
    b = BLOCKS[where]
    g = _grid()
    fn = ps._build_temporal_block_3d_fused(*_jax_args(k, coeffs),
                                           defer_x=True)
    u_j, zt_j, yt_j, _, _ = _pieces_np(g, b, k, fn.tail_y, fn.tail_z)
    want, wres = fn(jnp.asarray(u_j), jnp.asarray(zt_j), jnp.asarray(yt_j),
                    *_jax_offsets(b, k))
    u, zt, yt, _, _ = _pieces_np(g, b, k)
    out = torch.full(BLOCK, float("nan"))
    res = skb3.h_block_fused(_t(u), _t(zt), _t(yt), None, None, out, k,
                             defer_x=True, **_kw(b, coeffs))
    planes = slice(k, BLOCK[0] - k)
    _close_grid(out.numpy()[planes], np.asarray(want)[planes])
    _close_res(res, wres)
    _faces_exact(out.numpy(), u, _origin(b), planes)
    # The bulk writes no band plane.
    assert np.isnan(out.numpy()[:k]).all()
    assert np.isnan(out.numpy()[BLOCK[0] - k:]).all()


@pytest.mark.parametrize("where,k,coeffs", CASES)
def test_band_fix_matches_jax_builder(where, k, coeffs):
    b = BLOCKS[where]
    g = _grid()
    fn = ps._build_band_fix_3d(*_jax_args(k, coeffs))
    jp = _pieces_np(g, b, k, fn.tail_y, fn.tail_z)
    want, wres = fn(*map(jnp.asarray, jp), *_jax_offsets(b, k))
    u, zt, yt, xlo, xhi = _pieces_np(g, b, k)
    out = torch.full(BLOCK, float("nan"))
    res = skb3.h_band_fix(_t(u), _t(zt), _t(yt), _t(xlo), _t(xhi), out, k,
                          **_kw(b, coeffs))
    got = np.concatenate([out.numpy()[:k], out.numpy()[BLOCK[0] - k:]])
    _close_grid(got, want)
    _close_res(res, wres)
    # In place: the planes between the bands are untouched.
    assert np.isnan(out.numpy()[k:BLOCK[0] - k]).all()


@pytest.mark.parametrize("where,k,coeffs", CASES)
def test_assembled_block_matches_jax_builder(where, k, coeffs):
    b = BLOCKS[where]
    g = _grid()
    fn = ps._build_temporal_block_3d(*_jax_args(k, coeffs))

    def circular(p):
        u, zt, yt, xlo, xhi = p
        core = np.concatenate([np.concatenate([u, zt], axis=2), yt], axis=1)
        return np.concatenate([xlo, core, xhi])

    want, wres = fn(jnp.asarray(circular(
        _pieces_np(g, b, k, fn.tail_y, fn.tail_z))), *_jax_offsets(b, k))
    pieces = _pieces_np(g, b, k)
    out = torch.empty(BLOCK)
    res = skb3.h_block(_t(circular(pieces)), out, k, **_kw(b, coeffs))
    _close_grid(out.numpy(), want)
    _close_res(res, wres)
    _faces_exact(out.numpy(), pieces[0], _origin(b))


@pytest.mark.parametrize("mesh_shape", [(3, 3, 3), (2, 2, 1), (1, 2, 3)],
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_kinds_bitwise_each_other_and_one_grid_steps(k, mesh_shape):
    """Every form, and the deferred bulk spliced with the band, is bitwise
    the others and bitwise k plain steps of the global grid (the chain the
    card holds the kernels to: H(K) is F(K) on the block); a piece of an
    unsharded axis is None."""
    block = (11, 6, 7) if mesh_shape == (1, 2, 3) else (10, 6, 9)
    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    rng = np.random.default_rng(3)
    g = torch.from_numpy((rng.standard_normal(grid) * 10).astype(np.float32))
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(g)
    coeffs = dict(cx=0.1, cy=0.15, cz=0.05)
    f_out = torch.empty_like(g)
    sk3.xslab_steps_3d(g, f_out, k, **coeffs)
    pieces = temporal3d.exchange_halos_fused_3d(mesh, us, k)
    circ = temporal3d.exchange_halos_circular_3d(mesh, us, k)
    for b in range(mesh.size):
        o = mesh.origin(b, block)
        kw = dict(origin=o, grid_shape=grid, **coeffs)
        want = f_out[tuple(slice(a, a + n) for a, n in zip(o, block))]
        fused, assembled = torch.empty(block), torch.empty(block)
        res = skb3.h_block_fused(us[b], *pieces[b], fused, k, **kw)
        r_h = skb3.h_block(circ[b], assembled, k, **kw)
        assert torch.equal(fused, want) and torch.equal(assembled, want)
        assert torch.equal(res, r_h)
        if mesh_shape[0] > 1 and block[0] >= 2 * k:
            zt, yt, _, _ = pieces[b]
            split = torch.empty(block)
            r_bulk = skb3.h_block_fused(us[b], zt, yt, None, None, split, k,
                                        defer_x=True, **kw)
            r_band = skb3.h_band_fix(us[b], *pieces[b], split, k, **kw)
            assert torch.equal(split, fused)
            assert float(torch.maximum(r_bulk, r_band)) == float(res)


def test_nan_block_gives_nan_residual_and_keeps_the_faces():
    g = _grid(seed=5)
    g[1, 2, 1] = np.nan  # in the corner block, next to three faces
    mesh = HeatMesh(MESH)
    us = mesh.split(torch.from_numpy(g))
    k = 3
    pieces = temporal3d.exchange_halos_fused_3d(mesh, us, k)[0]
    kw = dict(origin=(0, 0, 0), grid_shape=GRID, cx=0.1, cy=0.1, cz=0.1)
    for launch in (lambda o: skb3.h_block_fused(us[0], *pieces, o, k, **kw),
                   lambda o: skb3.h_band_fix(us[0], *pieces, o, k, **kw)):
        out = torch.empty(BLOCK)
        assert np.isnan(float(launch(out)))
        for sl in (np.s_[0], np.s_[:k, 0], np.s_[:k, :, 0]):
            np.testing.assert_array_equal(out[sl].numpy(), us[0][sl].numpy())


def test_wrappers_refuse_bad_operands():
    u = torch.zeros(BLOCK)
    k = 3
    zt, yt = torch.zeros((12, 10, 2 * k)), torch.zeros((12, 2 * k, 20))
    slab = torch.zeros((k, 16, 20))
    kw = dict(origin=(12, 10, 14), grid_shape=GRID, cx=0.1, cy=0.1, cz=0.1)
    with pytest.raises(ValueError, match="ztail .* is needed"):
        skb3.h_block_fused(u, None, yt, slab, slab, torch.empty(BLOCK), k,
                           **kw)
    with pytest.raises(ValueError, match="xlo must be None"):
        skb3.h_block_fused(u, zt, yt, slab, slab, torch.empty(BLOCK), k,
                           defer_x=True, **kw)
    with pytest.raises(ValueError, match="ytail shape"):
        skb3.h_block_fused(u, zt, torch.zeros((12, 2 * k, 14)), slab, slab,
                           torch.empty(BLOCK), k, **kw)
    with pytest.raises(ValueError, match="2k"):
        skb3.h_block_fused(torch.zeros((4, 10, 14)), torch.zeros((4, 10, 6)),
                           torch.zeros((4, 6, 20)), None, None,
                           torch.empty((4, 10, 14)), k, defer_x=True, **kw)
    with pytest.raises(ValueError, match="spans the grid along x"):
        skb3.h_band_fix(torch.zeros((36, 10, 14)), zt, yt, slab, slab,
                        torch.empty((36, 10, 14)), k,
                        **{**kw, "origin": (0, 10, 14)})
    with pytest.raises(ValueError, match="ext shape"):
        skb3.h_block(torch.zeros((18, 16, 19)), torch.empty(BLOCK), k, **kw)
    with pytest.raises(ValueError, match="does not lie in the grid"):
        skb3.h_block_fused(u, zt, yt, slab, slab, torch.empty(BLOCK), k,
                           **{**kw, "origin": (30, 10, 14)})


def test_picker_default_forced_and_refused():
    block, mesh = (512, 512, 512), (2, 2, 2)
    assert skb3.pick_block_temporal_3d(block, 3)[0] == "H-fused"
    for kind in ("H", "H-defer", "torch"):
        with tune.force("block_temporal_3d", kind):
            assert skb3.pick_block_temporal_3d(block, 3)[0] == kind
    with tune.force("block_temporal_3d", "H"):
        with pytest.raises(ValueError, match="infeasible"):
            skb3.pick_block_temporal_3d((4, 8, 8), 5)
    # The JAX package's gate, on one process: the deferred pair runs only
    # when pinned, under overlap, with x sharded and 2K x-planes a block.
    deferred = skb3.pick_block_temporal_3d_deferred
    assert not deferred("H-fused", block, mesh, 3, "overlap")
    assert deferred("H-defer", block, mesh, 3, "overlap")
    assert deferred("H-defer", (6, 8, 8), mesh, 3, "overlap")
    assert not deferred("H-defer", (5, 8, 8), mesh, 3, "overlap")
    assert not deferred("H-defer", block, mesh, 3, "phase")
    assert not deferred("H-defer", block, (1, 2, 4), 3, "overlap")
    assert skb3.halos_of((8, 16, 16), (16, 16, 32), 3) == (3, 0, 3)


def test_init_block_is_the_slice_of_init_grid():
    from parallel_heat_tpu_torch.models import HeatPlate3D

    plate = HeatPlate3D(20, 18, 26)
    full = plate.init_grid("cpu")
    mesh = HeatMesh((2, 3, 2))
    bs = mesh.block_shape(plate.shape)
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        want = full[tuple(slice(a, a + n) for a, n in zip(o, bs))]
        assert torch.equal(plate.init_block("cpu", o, bs), want)


# --- The plane load of H-fused's tiles inside a block -----------------------

@pytest.mark.parametrize("shape,k,load", [
    ((512, 512, 512), 3, "tma"),    # the sharded 3D main path's block
    ((6, 128, 72), 3, "tma"),
    ((20, 128, 128), 3, "tma"),
    ((67, 128, 92), 1, "tma"),
    ((67, 124, 92), 1, "cp.async"),  # by under 2 * 64 - 3 = 125 rows
    ((67, 124, 92), 2, "tma"),       # 2 * 64 - 6 = 122
    ((50, 128, 52), 3, "cp.async"),  # bz under 2 * 32 - 9 = 55
    ((50, 128, 56), 3, "tma"),
    ((67, 70, 92), 3, "cp.async"),   # holds a box, but no tile inside it
    ((67, 70, 90), 3, "cp.async"),   # bz % 4 != 0: rows not 16-byte
    ((40, 128, 97), 3, "cp.async"),  # multiples
    ((50, 60, 40), 3, "cp.async"),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_load_is_chosen_by_geometry(shape, k, load):
    # The box: the extended tile (64 x 32 cells at the defaults), 4 cells
    # wider along z, since a box starts at a multiple of 4 cells.
    assert params().h_extent(params().h_block, params().h_rows) == (64, 32)
    assert params().h_tma_box() == (64, 36)
    assert skb3.h_load(shape, k) == load
    assert params().h_tma_fits(shape, k) == (load == "tma")
    # TMA runs in the tiles inside the block: the rule holds one.
    assert (params().h_tiles(shape, k)[0] > 0) >= (load == "tma")
    # The TMA instances take h_tma_rows rows a thread only.
    assert not params().h_tma_fits(shape, k, rows=2)
    # A block at an address that is not a multiple of 16 bytes takes the
    # cp.async load whatever its shape.
    thin = (2,) + shape[1:]
    base = torch.zeros(math.prod(thin) + 1)
    assert skb3.h_load(thin, k, base[1:].view(thin)) == "cp.async"
    assert skb3.h_load(thin, k, base[:-1].view(thin)) == load


def _tiles_brute(n, w, k):
    """(tiles, tiles whose extended range [start, start + w) lies in
    [0, n)) of one axis, tile t starting at t (w - 2k) - k."""
    tiles = -(-n // (w - 2 * k))
    return tiles, sum(1 for t in range(tiles)
                      if 0 <= t * (w - 2 * k) - k
                      and t * (w - 2 * k) - k + w <= n)


@pytest.mark.parametrize("block,rows", [((32, 16), 4), ((32, 8), 2),
                                        ((64, 4), 4)])
def test_tile_split_and_tma_rule_agree_with_enumeration(block, rows):
    p = params()
    wy, wz = p.h_extent(block, rows)
    for k in range(1, p.h_k_compiled + 1):
        if 2 * k >= min(wy, wz):
            continue
        for by in range(1, 3 * wy, 7):
            for bz in range(4, 3 * wz, 4):
                (ny, iy), (nz, iz) = (_tiles_brute(by, wy, k),
                                      _tiles_brute(bz, wz, k))
                got = p.h_tiles((9, by, bz), k, block, rows)
                assert got == (iy * iz, ny * nz - iy * iz), (k, by, bz)
                # The closed form of csrc/heat_h.cuh's heat_h_tma_fits:
                # the first tile that starts at 0 or past ends in the block.
                def holds(n, w):
                    step = w - 2 * k
                    return -(-k // step) * step - k + w <= n

                c_rule = (rows == p.h_tma_rows and wz + 4 <= 256
                          and bz >= wz + 4 and holds(by, wy)
                          and holds(bz, wz))
                assert p.h_tma_fits((9, by, bz), k, block, rows) == c_rule
                if c_rule:
                    assert got[0] > 0


def test_pinned_load_is_checked_and_gives_the_same_bits():
    g = _grid()
    b, k = BLOCKS["interior"], 3
    u, zt, yt, xlo, xhi = map(_t, _pieces_np(g, b, k))
    kw = _kw(b, COEFFS[1])
    assert skb3.h_load(BLOCK, k, u) == "cp.async"
    with pytest.raises(ValueError, match="TMA load needs bz % 4 == 0"):
        skb3.h_block_fused(u, zt, yt, xlo, xhi, torch.empty(BLOCK), k,
                           load="tma", **kw)
    with pytest.raises(ValueError, match="load must be one of"):
        skb3.h_block_fused(u, zt, yt, xlo, xhi, torch.empty(BLOCK), k,
                           load="bulk", **kw)
    pinned, default = torch.empty(BLOCK), torch.empty(BLOCK)
    r_pinned = skb3.h_block_fused(u, zt, yt, xlo, xhi, pinned, k,
                                  load="cp.async", **kw)
    r_default = skb3.h_block_fused(u, zt, yt, xlo, xhi, default, k, **kw)
    assert torch.equal(pinned, default) and torch.equal(r_pinned, r_default)


@pytest.mark.parametrize("n,nz,load", [(256, 256, "tma"), (256, 264, "tma"),
                                       (256, 260, "cp.async"),
                                       (128, 128, "cp.async")])
def test_explain_names_the_load(n, nz, load):
    cfg = HeatConfig(nx=n, ny=n, nz=nz, steps=6, mesh_shape=(2, 2, 2),
                     backend="cuda", device="cpu")
    out = explain(cfg)
    kind, detail = skb3.pick_block_temporal_3d(cfg.block_shape(), 3)
    assert kind == "H-fused" and detail["load"] == load
    if load == "tma":
        assert ("tiles inside the block load by TMA (one 64x36 (Y, Z) box "
                "a plane; bz % 4 == 0 and a tile inside the block)"
                ) in out["path"]
    else:
        assert ("tiles inside the block load by cp.async per cell (TMA "
                "needs bz % 4 == 0 and a block of at least 119x55 (Y, Z) "
                f"cells at K=3, which holds a tile, got {n // 2}x{nz // 2})"
                ) in out["path"]
    with tune.force("block_temporal_3d", "H"):
        assert "load" not in explain(cfg)["path"]


# A mesh whose blocks hold a tile inside them at K = 3 (2 * 64 - 9 rows,
# 2 * 32 - 9 columns, a multiple of 4), so that the card takes the TMA
# load there.
TMA_MESH, TMA_BLOCK = (2, 2, 2), (6, 120, 56)


@pytest.mark.parametrize("b", [0, 7])
@pytest.mark.parametrize("defer", [False, True], ids=["monolithic", "bulk"])
def test_fused_at_a_tma_geometry_matches_jax_builder(b, defer):
    k = params().h_k_default
    coeffs = COEFFS[1]
    grid = tuple(m * n for m, n in zip(TMA_MESH, TMA_BLOCK))
    assert skb3.h_load(TMA_BLOCK, k) == "tma"
    g = (np.random.default_rng(7).standard_normal(grid) * 10).astype(
        np.float32)
    fn = ps._build_temporal_block_3d_fused(TMA_BLOCK, "float32", *coeffs,
                                           grid, k, (k, k, k),
                                           defer_x=defer)
    jp = _pieces_np(g, b, k, fn.tail_y, fn.tail_z, TMA_MESH, TMA_BLOCK)
    o = _origin(b, TMA_MESH, TMA_BLOCK)
    want, wres = fn(*map(jnp.asarray, jp[:3] if defer else jp),
                    o[0] - k, o[1], o[2])
    u, zt, yt, xlo, xhi = _pieces_np(g, b, k, mesh=TMA_MESH,
                                     block=TMA_BLOCK)
    out = torch.full(TMA_BLOCK, float("nan"))
    res = skb3.h_block_fused(
        _t(u), _t(zt), _t(yt), None if defer else _t(xlo),
        None if defer else _t(xhi), out, k, defer_x=defer, origin=o,
        grid_shape=grid, **dict(zip(("cx", "cy", "cz"), coeffs)))
    planes = slice(k, TMA_BLOCK[0] - k) if defer else slice(None)
    _close_grid(out.numpy()[planes], np.asarray(want)[planes])
    _close_res(res, wres)


def test_ptxas_report_names_each_instance():
    from parallel_heat_tpu_torch.kernels import build

    sym = ("_Z28heat_h_block_3d_fused_kernelILi3ELi2ELb1EEvPKfS1_S1_S1_S1_"
           "PfPj")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'",
        f"ptxas info    : Function properties for {sym}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 62 registers, used 1 barriers, 128 bytes "
        "smem, 688 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z22heat_h_block_3d_kernelILi8ELi4EEvPKf' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z22heat_h_block_3d_kernelILi8ELi4EEvPKf",
        "    8 bytes stack frame, 80 bytes spill stores, 144 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, 400 bytes cmem[0]"])
    assert build.demangle(sym) == "heat_h_block_3d_fused_kernel<3, 2, true>"
    assert build.demangle("heat_plain") == "heat_plain"
    assert build.ptxas_report(log) == [
        {"instance": "heat_h_block_3d_fused_kernel<3, 2, true>",
         "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 62, "smem_bytes": 128},
        {"instance": "heat_h_block_3d_kernel<8, 4>", "stack_bytes": 8,
         "spill_stores": 80, "spill_loads": 144, "registers": 128,
         "smem_bytes": 0}]


def test_build_report_is_kept_beside_the_library(tmp_path, monkeypatch):
    from parallel_heat_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_LOG", {})
    name = "heat_h_block_3d_fused"
    assert build.build_log(name) == ""
    log = "ptxas info    : Used 90 registers"
    build.library_path(name).with_suffix(".log").write_text(log)
    assert build.build_log(name) == log   # a build by an earlier process
    build.BUILD_LOG[name] = "this process"
    assert build.build_log(name) == "this process"
