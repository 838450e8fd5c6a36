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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
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
                if (0 <= x < GRID[0] and 0 <= y < GRID[1]
                        and 0 <= z < GRID[2]):
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
                if ok(x, GRID[0]) and ok(y, GRID[1]) and ok(z, GRID[2]):
                    out[i, j, m] = g[x, y, z]
    return out


def _origin(b):
    c = HeatMesh(MESH).coords(b)
    return tuple(ci * bi for ci, bi in zip(c, BLOCK))


def _pieces_np(g, b, k, tail_y=None, tail_z=None):
    """Block ``b``'s ``u``, z tail, y tail and x slabs cut from the global
    grid in numpy; tails ``2k`` wide (the port's) unless given (JAX's)."""
    tail_y, tail_z = tail_y or 2 * k, tail_z or 2 * k
    bx, by, bz = BLOCK
    ox, oy, oz = _origin(b)
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
