"""The 3D band (``heat_h_band_fix_3d``): every block's bands of a round in
one launch, each tile on kernel F's plane loop; its geometry and plain
versions on the CPU.

The CUDA kernel runs only on the card, where ``tests/test_torch_card.py``
and ``chip_smoke.py`` hold it bitwise to its plain versions and to kernel
F. Its arithmetic is F's loop, emulated in ``tests/test_torch_f_loop.py``;
what is the band's own is checked here:

- the batched plain version (``band_fix_blocks_3d_plain``, what a launch
  over every block runs on the CPU) bitwise the per-block
  ``h_band_fix_plain``, its residual their max, on meshes (2, 2, 2),
  (2, 4, 1) and (2, 1, 1), at K = 1, 3 and 8, on ragged blocks and over a
  table larger than one launch's chunk;
- every block's bands against the JAX package's ``_build_band_fix_3d``
  in interpret mode (as ``tests/test_torch_kernels_h.py`` runs it), under
  its few-ulp contract: ``rtol=1e-5, atol=1e-5`` on grids and
  ``rtol=1e-4`` on residuals (XLA:CPU may contract multiply-adds into
  FMAs, where the port rounds every operation), the faces bit-exact;
- the launch's table entry (``_BandEntry3D``) against the C++ struct's
  layout, and the launch's parameters under 4 KB;
- the load, emulated in numpy as the kernel works it out (each row's
  piece and offset, ``HeatHBandSeg::load``): for every tile
  and input plane of both regions, with NaN in every ring cell it leaves
  alone, the cells put into a slot are the cells the pieces hold there,
  zeros outside the grid and past the K-deep frame, under both the
  4-byte and the 16-byte load; and the tile grid, each output cell of
  both regions written once, its kinds counted by
  ``hopper_params.h_band_tile_kinds``;
- a pinned H-defer sharded solve bitwise the H-fused one, one band call
  a round; and the operands the launcher refuses.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch import HeatConfig, solve, tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.parallel import temporal3d
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

f32 = np.float32
WIDTH = 128   # F's extended tile along Z (csrc/heat_temporal3d.cuh kFWidth)
# The band's table, arguments and loads (shared by its float32 and
# bfloat16 forms).
SRC = (Path(__file__).resolve().parent.parent / "parallel_heat_tpu_torch"
       / "csrc" / "heat_hb.cuh")
COEFFS = dict(cx=0.1, cy=0.15, cz=0.05)


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _exchanged(mesh_shape, block, k, seed=3):
    """A seeded grid cut into ``block`` blocks over ``mesh_shape``, its
    blocks and the K-deep exchange after all three phases."""
    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal(grid) * 10).astype(f32))
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(g)
    xch = temporal3d.DeepExchange3D(mesh, block, k, "cpu")
    xch.lead(us)
    xch.last(us)
    origins = [mesh.origin(b, block) for b in range(mesh.size)]
    return grid, g, us, xch, origins


def _pieces(xch):
    return xch.ztail, xch.ytail, xch.xlo, xch.xhi


# ---------------------------------------------------------------------------
# The batched plain version against the per-block one
# ---------------------------------------------------------------------------

# (mesh, block, K): the three meshes at K = 1, 3, 8, ragged blocks (no
# extent a multiple of 4), blocks of exactly 2K planes.
BATCH_CASES = [
    ((2, 2, 2), (10, 6, 9), 1), ((2, 2, 2), (10, 6, 9), 3),
    ((2, 2, 2), (17, 9, 11), 8), ((2, 4, 1), (9, 5, 7), 3),
    ((2, 4, 1), (16, 9, 10), 8), ((2, 1, 1), (7, 11, 13), 1),
    ((2, 1, 1), (6, 11, 13), 3), ((2, 1, 1), (16, 10, 9), 8)]


@pytest.mark.parametrize("mesh_shape,block,k", BATCH_CASES, ids=_ids)
def test_batched_plain_is_the_per_block_plain(mesh_shape, block, k):
    grid, g, us, xch, origins = _exchanged(mesh_shape, block, k)
    kw = dict(grid_shape=grid, **COEFFS)
    one = [torch.full(block, float("nan")) for _ in us]
    rs = [skb3.h_band_fix_plain(us[b], *xch.pieces(b), one[b], k,
                                origin=origins[b], **kw)
          for b in range(len(us))]
    got = [torch.full(block, float("nan")) for _ in us]
    sk.reset_counts()
    launch = skb3.BandLaunch3D(us, *_pieces(xch), got, k, origins=origins,
                               **kw)
    r = launch()
    assert sk.counts["h_band_fix_plain"] == 1
    for a, b_ in zip(got, one):
        assert torch.equal(a.nan_to_num(7.0), b_.nan_to_num(7.0))
        assert a[k:block[0] - k].isnan().all()
    assert torch.equal(r, torch.stack(rs).amax())
    assert launch(False) is None
    # The bands are kernel F's K steps of the global grid (the plain
    # version's chain), so bulk + band is the monolithic round.
    f_out = torch.empty_like(g)
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3

    sk3.xslab_steps_3d(g, f_out, k, **COEFFS)
    for o, a in zip(origins, got):
        want = f_out[tuple(slice(c, c + n) for c, n in zip(o, block))]
        assert torch.equal(a[:k], want[:k])
        assert torch.equal(a[block[0] - k:], want[block[0] - k:])


def test_batched_plain_over_more_blocks_than_one_chunk():
    """A table of more blocks than one launch takes (BAND_TABLE_3D): the
    plain version over all of them at once, each block as its own."""
    n = skb3.BAND_TABLE_3D + 2
    k, block = 1, (2, 5, 6)
    grid, _, us, xch, origins = _exchanged((n, 1, 1), block, k, seed=9)
    assert len(us) > skb3.BAND_TABLE_3D
    kw = dict(grid_shape=grid, **COEFFS)
    got = [torch.full(block, float("nan")) for _ in us]
    r = skb3.band_fix_blocks_3d(us, *_pieces(xch), got, k, origins=origins,
                                **kw)
    rs = []
    for b in range(len(us)):
        want = torch.full(block, float("nan"))
        rs.append(skb3.h_band_fix_plain(us[b], *xch.pieces(b), want, k,
                                        origin=origins[b], **kw))
        assert torch.equal(got[b], want)
    assert torch.equal(r, torch.stack(rs).amax())


def test_batched_plain_nan_reaches_the_residual_and_keeps_the_faces():
    k, block = 3, (8, 7, 9)
    grid, _, us, xch, origins = _exchanged((2, 2, 2), block, k, seed=5)
    us[0][1, 2, 1] = float("nan")   # next to three faces of block 0
    xch.lead(us)
    xch.last(us)
    got = [torch.empty(block) for _ in us]
    r = skb3.band_fix_blocks_3d(us, *_pieces(xch), got, k, origins=origins,
                                grid_shape=grid, **COEFFS)
    assert torch.isnan(r)
    for sl in (np.s_[0], np.s_[:k, 0], np.s_[:k, :, 0]):
        assert torch.equal(got[0][sl].nan_to_num(7.0),
                           us[0][sl].nan_to_num(7.0))


# ---------------------------------------------------------------------------
# Against the JAX package's band builder
# ---------------------------------------------------------------------------

JAX_MESH, JAX_BLOCK = (2, 2, 2), (10, 12, 14)
JAX_GRID = tuple(m * b for m, b in zip(JAX_MESH, JAX_BLOCK))


def _take(g, xs, ys, zs):
    """``g[xs][:, ys][:, :, zs]`` with zeros where an index is None (a
    seam cell) or lies outside the grid."""
    out = np.zeros((len(xs), len(ys), len(zs)), f32)
    ok = lambda v, n: v is not None and 0 <= v < n  # noqa: E731
    for i, x in enumerate(xs):
        for j, y in enumerate(ys):
            for m, z in enumerate(zs):
                if (ok(x, g.shape[0]) and ok(y, g.shape[1])
                        and ok(z, g.shape[2])):
                    out[i, j, m] = g[x, y, z]
    return out


def _circ(o, b, k, tail):
    """Global indices of an axis in the circular order ``[u | hi | seam |
    lo]`` (None for a seam cell), the tail ``tail`` wide."""
    return (list(range(o, o + b + k)) + [None] * (tail - 2 * k)
            + list(range(o - k, o)))


def _jax_pieces(g, origin, k, tail_y, tail_z):
    """Block ``u``, z tail, y tail and x slabs at ``origin`` in the JAX
    builder's layout (tails padded with seam zeros)."""
    bx, by, bz = JAX_BLOCK
    ox, oy, oz = origin
    xs = list(range(ox, ox + bx))
    ys = list(range(oy, oy + by))
    zc = _circ(oz, bz, k, tail_z)
    yc = _circ(oy, by, k, tail_y)
    return (g[ox:ox + bx, oy:oy + by, oz:oz + bz].copy(),
            _take(g, xs, ys, zc[bz:]), _take(g, xs, yc[by:], zc),
            _take(g, list(range(ox - k, ox)), yc, zc),
            _take(g, list(range(ox + bx, ox + bx + k)), yc, zc))


@pytest.mark.parametrize("k,coeffs", [(3, (0.1, 0.15, 0.05)),
                                      (2, (0.1, 0.1, 0.1))])
def test_every_block_matches_the_jax_band_builder(k, coeffs):
    """The round's launch over the 8 blocks of a (2, 2, 2) mesh (on the
    CPU, its batched plain version) against the JAX package's
    ``_build_band_fix_3d`` on each block."""
    kw3 = dict(zip(("cx", "cy", "cz"), coeffs))
    g = (np.random.default_rng(11).standard_normal(JAX_GRID) * 10).astype(f32)
    mesh = HeatMesh(JAX_MESH)
    us = mesh.split(torch.from_numpy(g))
    xch = temporal3d.DeepExchange3D(mesh, JAX_BLOCK, k, "cpu")
    xch.lead(us)
    xch.last(us)
    origins = [mesh.origin(b, JAX_BLOCK) for b in range(mesh.size)]
    got = [torch.full(JAX_BLOCK, float("nan")) for _ in us]
    res = skb3.band_fix_blocks_3d(us, *_pieces(xch), got, k, origins=origins,
                                  grid_shape=JAX_GRID, **kw3)
    fn = ps._build_band_fix_3d(JAX_BLOCK, "float32", *coeffs, JAX_GRID, k,
                               (k, k, k))
    bx = JAX_BLOCK[0]
    wres = []
    for b, o in enumerate(origins):
        jp = _jax_pieces(g, o, k, fn.tail_y, fn.tail_z)
        want, r = fn(*map(jnp.asarray, jp), o[0] - k, o[1], o[2])
        wres.append(float(r))
        band = np.concatenate([got[b].numpy()[:k], got[b].numpy()[bx - k:]])
        np.testing.assert_allclose(band, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        # The Dirichlet cells of the band planes are bit-exact.
        idx = [c + np.arange(n) for c, n in zip(o, JAX_BLOCK)]
        face = np.zeros(JAX_BLOCK, bool)
        for axis, (i, n) in enumerate(zip(idx, JAX_GRID)):
            shape = [1, 1, 1]
            shape[axis] = -1
            face |= ((i == 0) | (i == n - 1)).reshape(shape)
        face[k:bx - k] = False
        np.testing.assert_array_equal(got[b].numpy()[face],
                                      us[b].numpy()[face])
    np.testing.assert_allclose(float(res), max(wres), rtol=1e-4)


# ---------------------------------------------------------------------------
# The launch's table
# ---------------------------------------------------------------------------

def _c_struct_fields(name):
    """The member names of struct ``name`` in the kernel's source, in
    order."""
    body = re.search(rf"struct {name} {{(.*?)}};", SRC.read_text(),
                     re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.split("//")[0].strip()
        if decl:
            parts = decl.replace("*", " ").split(",")
            names += [parts[0].split()[-1]] + [q.strip() for q in parts[1:]]
    return names


def test_table_entry_matches_the_cpp_struct():
    """``_BandEntry3D`` is ``HeatHBandEntry``: six pointers, then the
    int64 origin, 72 bytes; the table holds BAND_TABLE_3D entries, and the
    kernel's parameters (the table and HeatHBandArgs) stay under 4 KB."""
    E = skb3._BandEntry3D
    c_names = _c_struct_fields("HeatHBandEntry")
    assert c_names == ["u", "zt", "yt", "xlo", "xhi", "out", "ox", "oy",
                       "oz"]
    assert [f[0] for f in E._fields_] == ["u", "ztail", "ytail", "xlo",
                                          "xhi", "out", "ox", "oy", "oz"]
    assert ctypes.sizeof(E) == 72
    assert [getattr(E, f[0]).offset for f in E._fields_] == [
        0, 8, 16, 24, 32, 40, 48, 56, 64]
    text = SRC.read_text()
    table = int(re.search(r"constexpr int kHeatHBandTable = (\d+);",
                          text).group(1))
    assert table == skb3.BAND_TABLE_3D

    class Args(ctypes.Structure):   # HeatHBandArgs, member for member
        _fields_ = ([("res", ctypes.c_void_p)]
                    + [(n, ctypes.c_int64) for n in ("nx", "ny", "nz", "bx",
                                                      "by", "bz", "tiles_z",
                                                      "tiles_y")]
                    + [(n, ctypes.c_int) for n in ("hy", "hz", "prefetch",
                                                    "vec_out", "vec_in")]
                    + [(n, ctypes.c_float) for n in ("a0", "cx", "cy",
                                                      "cz")])

    assert _c_struct_fields("HeatHBandArgs") == [f[0] for f in
                                                 Args._fields_]
    assert table * ctypes.sizeof(E) + ctypes.sizeof(Args) < 4096
    loads = re.search(r"enum HeatHBandLoad {(.*?)};", text, re.S).group(1)
    assert [int(v) for v in re.findall(r"= (\d+)", loads)] == list(
        range(len(skb3.BAND_LOADS_3D)))


# ---------------------------------------------------------------------------
# The load and the tile grid, emulated
# ---------------------------------------------------------------------------

def _tiles(block_shape, k, shape):
    """The kernel's tiles, ``[(y0, z0)]`` of each extended tile's first
    row and cell (block-local), as ``heat_h_band_fix_3d_kernel`` numbers
    them."""
    p = params()
    block, rows, _ = shape
    wy, _ = p.f_extent(block, rows)
    pad = p.f_pad(k)
    tiles_y, tiles_z = p.h_band_tiles(block_shape, k, shape)
    assert tiles_y * tiles_z > 0
    return [(ty * (wy - 2 * k) - k, tz * (WIDTH - 2 * pad) - pad)
            for ty in range(tiles_y) for tz in range(tiles_z)]


def _fixed(block_shape, halos, k, y0, z0, wy, vec_in):
    """Where ``HeatHBandSeg::load`` finds each (row, lane) of the tile,
    as it works it out plane by plane from the thread's first row and
    cell: the offset in a plane of the block (moff, rows of the block) or
    of the y tail (moff, the others), in a plane of the z tail (zoff, the
    cells of zsel in the block's rows) and of an x slab (coff); cin (the
    cell lies in the K-deep frame) and vrows (a 16-byte copy of the
    block); arrays of (wy, 32) or (wy, 32, 4)."""
    bx, by, bz = block_shape
    _, hy, hz = halos
    k2 = 2 * k
    ye, ze = by + 2 * hy, bz + 2 * hz
    ly = (y0 + np.arange(wy))[:, None]                      # (wy, 1)
    lz0 = (z0 + 4 * np.arange(32))[None, :]                 # (1, 32)
    zc0 = np.where(lz0 < 0, lz0 + ze, lz0)
    zb0 = np.where(lz0 < 0, lz0 + k2, lz0 - bz)
    in_u = (ly >= 0) & (ly < by)
    moff = np.where(in_u, ly * bz + lz0,
                    np.where(ly >= by, ly - by, ly + k2) * ze + zc0)
    zoff = ly * k2 + zb0
    coff = np.where(ly < 0, ly + ye, ly) * ze + zc0
    lz = lz0[..., None] + np.arange(4)                      # (1, 32, 4)
    zsel = (lz < 0) | (lz >= bz)
    cin = ((ly[..., None] >= -hy) & (ly[..., None] < by + hy) & (lz >= -hz)
           & (lz < bz + hz))
    lane_in_u = (lz0 >= 0) & (lz0 + 4 <= bz)
    vrows = vec_in & in_u & lane_in_u & cin.all(axis=-1)
    return (np.broadcast_to(moff, (wy, 32)), np.broadcast_to(zoff, (wy, 32)),
            np.broadcast_to(coff, (wy, 32)), np.broadcast_to(in_u, (wy, 32)),
            np.broadcast_to(zsel, (wy, 32, 4)), cin, vrows)


def _load_slot(pieces, block_shape, origin, grid, k, fixed, t, wy, vec):
    """The (wy, 128) cells HeatFLoop's kBand fetch puts into a ring slot
    for block-local input plane ``t``, NaN where it copies nothing, and
    the rows taken by a 16-byte copy (with ``vec``)."""
    u, zt, yt, xlo, xhi = pieces
    bx = block_shape[0]
    moff, zoff, coff, urows, zsel, cin, vrows = fixed
    slot = np.full((wy, 32, 4), np.nan, f32)
    j = np.arange(4)
    # "in ? p : u" with zero fill: every copy lands, data or zero.
    if 0 <= t < bx:
        pu, pz, py = (a[t].reshape(-1) if a is not None else None
                      for a in (u, zt, yt))
        for r in range(wy):
            for lane in range(32):
                if vec and vrows[r, lane]:
                    start = moff[r, lane]
                    assert start % 4 == 0   # a 16-byte aligned run of u
                    slot[r, lane] = pu[start:start + 4]
                    continue
                for jj in j:
                    if not cin[r, lane, jj]:
                        slot[r, lane, jj] = 0.0
                    elif not urows[r, lane]:
                        slot[r, lane, jj] = py[moff[r, lane] + jj]
                    elif zsel[r, lane, jj]:
                        slot[r, lane, jj] = pz[zoff[r, lane] + jj]
                    else:
                        slot[r, lane, jj] = pu[moff[r, lane] + jj]
    else:
        gx = origin[0] + t
        t_in = 0 <= gx < grid[0] and -k <= t < bx + k
        slab = (xlo[t + k] if t < 0 else xhi[t - bx]).reshape(-1)
        for r in range(wy):
            for lane in range(32):
                for jj in j:
                    slot[r, lane, jj] = (slab[coff[r, lane] + jj]
                                         if t_in and cin[r, lane, jj]
                                         else 0.0)
    return slot.reshape(wy, WIDTH)


# (mesh, block, K): a (2, 2, 2) corner and far block, ragged blocks on
# (3, 3, 3) (bz % 4 != 0: a lane straddles the block and its z tail),
# unsharded z (2, 4, 1) and y (2, 1, 2), K = 1, 3, 8.
LOAD_CASES = [
    ((2, 2, 2), (9, 40, 140), 3), ((3, 3, 3), (5, 31, 130), 1),
    ((3, 3, 3), (17, 21, 130), 8), ((2, 4, 1), (7, 40, 97), 3),
    ((2, 1, 2), (6, 50, 133), 3), ((2, 2, 2), (16, 17, 17), 8)]


@pytest.mark.parametrize("mesh_shape,bs,k", LOAD_CASES, ids=_ids)
def test_emulated_load_puts_the_pieces_cells_in_each_slot(mesh_shape, bs, k):
    p = params()
    shape = p.h_band_shape(k)
    block, rows, _ = shape
    wy, wz = p.f_extent(block, rows)
    grid, _, us, xch, origins = _exchanged(mesh_shape, bs, k, seed=sum(bs))
    mesh = xch.mesh
    halos = xch.halos
    bx, by, bz = bs
    vec_fits = p.h_band_vec_fits(bs)
    seen = {"vec": 0, "cells": 0}
    for b in sorted({0, mesh.size // 2, mesh.size - 1}):
        pieces = tuple(None if a is None else a.numpy() for a in
                       (us[b],) + xch.pieces(b))
        frame = skb3._frame_of_pieces(us[b], *xch.pieces(b), k).numpy()
        o = origins[b]
        # The frame with zeros outside the grid (the loads zero-fill there).
        idx = [c - k + np.arange(n + 2 * k) for c, n in zip(o, bs)]
        inside = np.ones(frame.shape, bool)
        for axis, (i, n) in enumerate(zip(idx, grid)):
            sh = [1, 1, 1]
            sh[axis] = -1
            inside &= ((i >= 0) & (i < n)).reshape(sh)
        frame = np.where(inside, frame, 0)
        for y0, z0 in _tiles(bs, k, shape):
            ly, lz = y0 + np.arange(wy), z0 + np.arange(wz)
            fy = (ly >= -k) & (ly < by + k)
            fz = (lz >= -k) & (lz < bz + k)
            for vec in ((False, True) if vec_fits else (False,)):
                fixed = _fixed(bs, halos, k, y0, z0, wy, vec)
                for x0 in (0, bx - k):           # the two regions
                    for t in range(x0 - k, x0 + 2 * k):
                        cells = _load_slot(pieces, bs, o, grid, k, fixed, t,
                                           wy, vec)
                        where = (f"block {b} tile ({y0}, {z0}) plane {t} "
                                 f"{'16-byte' if vec else '4-byte'}")
                        # Every slot cell is filled (NaN where no copy).
                        assert not np.isnan(cells).any(), where
                        want = frame[t + k][np.ix_(ly[fy] + k, lz[fz] + k)]
                        np.testing.assert_array_equal(
                            cells[np.ix_(fy, fz)], want, err_msg=where)
                        assert not cells[~fy].any(), where
                        assert not cells[:, ~fz].any(), where
                        if vec and 0 <= t < bx:
                            seen["vec"] += int(fixed[-1].sum())
                        seen["cells"] += 1
    assert seen["cells"] and (seen["vec"] > 0) == vec_fits


def _combine3(c, xm, xp, ym, yp, zm, zp, a0, cx, cy, cz):
    return (((a0 * c) + (cx * (xm + xp))) + (cy * (ym + yp))) \
        + (cz * (zm + zp))


def _emulate_band(g, origins, bs, halos, k, shape, coeffs):
    """The band launch's output planes of every block at ``origins`` of
    the global grid ``g``, and its residual: HeatFLoop::run_band's
    schedule (as ``tests/test_torch_f_loop.py`` replays F's loop) on each
    tile of each segment (segment q: block q // 2's region q % 2, one a
    thread block), the levels outside the segment's output cone not
    stepped (the level below passed on in their registers), every
    register, ring and level-buffer cell NaN until written; a plane's cells are the grid's inside the K-deep frame
    of the segment's block and inside the grid, zeros elsewhere (what the
    load puts there, emulated above)."""
    p = params()
    a0, cx, cy, cz = (f32(c) for c in coeffs)
    nx, ny, nz = g.shape
    bx, by, bz = bs
    _, hy, hz = halos
    block, R, prefetch = shape
    W = block[1]
    E = min(R, 2)
    wy, wz = p.f_extent(block, R)
    P = p.f_pad(k)
    S = 3 * k
    lanes, w_idx = np.arange(32), np.arange(W)
    outs = [np.full(bs, np.nan, dtype=f32) for _ in origins]
    rmax = np.uint32(0)
    slots = prefetch + 2
    segs = 2 * len(origins)
    for y0, z0 in _tiles(bs, k, shape):
        lz = z0 + 4 * lanes[:, None] + np.arange(4)[None, :]
        ly = y0 + w_idx[:, None] * R + np.arange(R)[None, :]
        cell = 4 * lanes[:, None] + np.arange(4)[None, :]
        row = w_idx[:, None] * R + np.arange(R)[None, :]
        zout = (cell >= P) & (cell < wz - P) & (lz < bz)
        yout = (row >= k) & (row < wy - k) & (ly < by)
        ys, zs = y0 + np.arange(wy), z0 + np.arange(wz)
        fy = (ys >= -hy) & (ys < by + hy)
        fz = (zs >= -hz) & (zs < bz + hz)
        for q in range(segs):
            ox, oy, oz = origins[q // 2]
            x0 = ox + (bx - k if q % 2 else 0)
            edge = (oy + y0 < 1 or oy + y0 + wy > ny - 1 or oz + z0 < 1
                    or oz + z0 + wz > nz - 1)
            ring = np.full((slots, wy + 2, wz), np.nan, dtype=f32)
            lev = np.full((max(k - 1, 0), 2, E * W + 2, wz), np.nan,
                          dtype=f32)

            def fetch(slot, v):
                l = (bx - 2 * k if q % 2 else -k) + v
                t = ox + l
                tile = np.zeros((wy, wz), dtype=f32)
                gy, gz = oy + ys, oz + zs
                my = fy & (gy >= 0) & (gy < ny)
                mz = fz & (gz >= 0) & (gz < nz)
                if 0 <= t < nx and -k <= l < bx + k:
                    tile[np.ix_(my, mz)] = g[t][np.ix_(gy[my], gz[mz])]
                ring[slot, 1:wy + 1] = tile

            regs = [np.full((k, W, R, 32, 4), np.nan, dtype=f32)
                    for _ in range(3)]
            for i in range(prefetch):
                if i < S:
                    fetch(i, i)
            cur = 0
            gz, gy = oz + lz, oy + ly
            for v in range(S):
                t = x0 - k + v
                zin = (gz >= 1) & (gz <= nz - 2)
                yin = (gy >= 1) & (gy <= ny - 2)
                U, M, D = regs[v % 3], regs[(v + 1) % 3], regs[(v + 2) % 3]
                prev = slots - 1 if cur == 0 else cur - 1
                if v + prefetch < S:
                    fetch((cur + prefetch) % slots, v + prefetch)
                check = edge or not (t - k >= 1 and t - 1 <= nx - 2)
                D[0] = ring[cur, 1:wy + 1].reshape(W, R, 32, 4)
                par = t & 1
                for s_ in range(1, k + 1):
                    if t < x0 - k + 2 * s_:      # outside the cone
                        if s_ < k:               # the level below passed on
                            D[s_] = M[s_ - 1]
                        continue
                    if s_ == 1:
                        pr = ring[prev].reshape(wy + 2, 32, 4)
                        yu, yd = pr[w_idx * R], pr[w_idx * R + R + 1]
                    else:
                        nb = lev[s_ - 2, par ^ 1].reshape(E * W + 2, 32, 4)
                        yu, yd = nb[E * w_idx], nb[1 + E * (w_idx + 1)]
                    x_in = (not check) or (1 <= t - s_ <= nx - 2)
                    nv = np.empty((W, R, 32, 4), dtype=f32)
                    with np.errstate(all="ignore"):
                        for r in range(R):
                            c = M[s_ - 1][:, r]
                            ym = M[s_ - 1][:, r - 1] if r > 0 else yu
                            yp = M[s_ - 1][:, r + 1] if r + 1 < R else yd
                            zl = np.concatenate([c[:, :1, 3], c[:, :-1, 3]],
                                                1)
                            zr = np.concatenate([c[:, 1:, 0], c[:, -1:, 0]],
                                                1)
                            zm = np.stack([zl, c[..., 0], c[..., 1],
                                           c[..., 2]], -1)
                            zp = np.stack([c[..., 1], c[..., 2], c[..., 3],
                                           zr], -1)
                            new = _combine3(c, U[s_ - 1][:, r],
                                            D[s_ - 1][:, r], ym, yp, zm, zp,
                                            a0, cx, cy, cz)
                            if check:
                                sel = (x_in & yin[:, r])[:, None, None] & zin
                                new = np.where(sel, new, c)
                            nv[:, r] = new
                    if s_ < k:
                        dst = lev[s_ - 1, par].reshape(E * W + 2, 32, 4)
                        dst[1 + E * w_idx] = nv[:, 0]
                        dst[1 + E * w_idx + E - 1] = nv[:, R - 1]
                        D[s_] = nv
                    elif x0 <= t - k < x0 + k:
                        for w in range(W):
                            for r in range(R):
                                if not yout[w, r]:
                                    continue
                                inm = zout & (zin & bool(x_in and yin[w, r])
                                              if check else True)
                                with np.errstate(all="ignore"):
                                    diff = np.abs(nv[w, r] - M[k - 1][w, r])
                                bits = diff.astype(f32).view(np.uint32)[inm]
                                if bits.size:
                                    rmax = max(rmax, bits.max())
                                outs[q // 2][t - k - ox, ly[w, r],
                                             lz[zout]] = nv[w, r][zout]
                cur = (cur + 1) % slots
    return outs, np.array([rmax], dtype=np.uint32).view(f32)[0]


# (mesh, block, K): the cone's skip at K = 1 .. 4 and 8; ragged blocks
# and unsharded y or z.
LOOP_CASES = [((2, 2, 2), (6, 30, 130), 3), ((2, 2, 2), (4, 30, 130), 2),
              ((3, 1, 1), (5, 29, 131), 1), ((2, 4, 1), (7, 20, 97), 3),
              ((2, 1, 1), (16, 17, 125), 8), ((2, 1, 2), (8, 40, 118), 4)]


@pytest.mark.parametrize("mesh_shape,bs,k", LOOP_CASES, ids=_ids)
def test_emulated_band_loop_is_the_plain_version(mesh_shape, bs, k):
    """The band launch's loop, one segment a thread block, the cone's
    skipped levels and NaN in every cell not yet written included, is
    bitwise the plain version on every block: band planes and residual."""
    p = params()
    shape = p.h_band_shape(k)
    grid, g, us, xch, origins = _exchanged(mesh_shape, bs, k, seed=k + 7)
    coeffs = (0.1, 0.15, 0.05)
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

    got, res = _emulate_band(g.numpy(), origins, bs, xch.halos, k, shape,
                             coeffs3_f32(*coeffs))
    want = [torch.full(bs, float("nan")) for _ in us]
    rp = skb3.band_fix_blocks_3d_plain(us, *_pieces(xch), want, k,
                                       origins=origins, grid_shape=grid,
                                       **COEFFS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    assert float(res) == float(rp)


# (block, halos, K, shape): ragged blocks, tiles taller and wider than the
# block, unsharded y or z, K = 1 .. 8 at the band's shapes.
GRID_CASES = [
    ((9, 70, 252), (3, 3, 3), 3), ((6, 26, 120), (3, 3, 3), 3),
    ((7, 133, 97), (1, 1, 1), 1), ((8, 90, 300), (4, 0, 4), 4),
    ((6, 90, 300), (3, 3, 0), 3), ((12, 64, 250), (5, 5, 5), 5),
    ((16, 20, 33), (8, 8, 8), 8), ((14, 40, 131), (7, 0, 0), 7)]


@pytest.mark.parametrize("block_shape,halos,k", GRID_CASES, ids=_ids)
def test_tile_grid_writes_each_band_cell_once_and_counts_the_kinds(
        block_shape, halos, k):
    p = params()
    shape = p.h_band_shape(k)
    block, rows, _ = shape
    assert p.h_band_takes(block, rows, k)
    bx, by, bz = block_shape
    wy, wz = p.f_extent(block, rows)
    pad = p.f_pad(k)
    cover = np.zeros(block_shape, np.int32)
    tiles = _tiles(block_shape, k, shape)
    for x0 in (0, bx - k):
        for y0, z0 in tiles:
            ys = [y for y in range(y0 + k, y0 + wy - k) if y < by]
            zs = [z for z in range(z0 + pad, z0 + wz - pad) if z < bz]
            cover[np.ix_(range(x0, x0 + k), ys, zs)] += 1
            assert y0 >= -k and z0 >= -pad and z0 % 4 == 0
    band = np.zeros(block_shape, bool)
    band[:k] = band[bx - k:] = True
    assert (cover[band] == 1).all() and (cover[~band] == 0).all()
    origin = tuple(h * 10 for h in halos)       # a block inside the grid
    grid = tuple(o + b + h * 10 for o, b, h in zip(origin, block_shape,
                                                     halos))
    kinds = p.h_band_tile_kinds(block_shape, k, halos, origin, grid)
    _, hy, hz = halos
    assert kinds["tiles"] == len(tiles)
    assert kinds["lo_y"] == sum(y0 < 0 and hy > 0 for y0, _ in tiles)
    assert kinds["lo_z"] == sum(z0 < 0 and hz > 0 for _, z0 in tiles)
    assert kinds["hi_y"] == sum(y0 + wy > by and hy > 0 for y0, _ in tiles)
    assert kinds["hi_z"] == sum(z0 + wz > bz and hz > 0 for _, z0 in tiles)
    assert kinds["straddle"] == sum(hz > 0 and bz % 4 != 0
                                    and z0 < bz < z0 + wz
                                    for _, z0 in tiles)
    assert kinds["interior"] + kinds["edge"] == len(tiles)


def test_main_block_tiles_and_shapes():
    p = params()
    bs, k = (512, 512, 512), p.h_k_default
    shape = p.h_band_shape(k)
    ty, tz = p.h_band_tiles(bs, k)
    kinds = p.h_band_tile_kinds(bs, k, (k, k, k), (0, 0, 0), (1024,) * 3)
    assert kinds["tiles"] == ty * tz and kinds["straddle"] == 0
    # A round of 8 blocks, two regions each, fills the card several times.
    assert 8 * 2 * ty * tz >= 4 * p.sm_count
    assert p.h_band_vec_fits(bs) and not p.h_band_vec_fits((512, 512, 90))
    # Every depth the H-defer round admits has a shape.
    assert p.h_band_k_max() >= p.h_k_max()
    for kk in range(1, p.h_band_k_max() + 1):
        block, rows, prefetch = p.h_band_shape(kk)
        assert p.h_band_takes(block, rows, kk)
        assert kk <= p.f_k_max(block, rows, prefetch)
    assert p.h_band_shape(p.f_k_compiled + 1) is None
    assert shape == p.h_band_shape(k)


# ---------------------------------------------------------------------------
# The round and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape,shape,depth,steps", [
    ((2, 2, 2), (16, 20, 24), 3, 7), ((2, 4, 1), (16, 16, 12), 4, 8),
    ((2, 1, 1), (12, 9, 10), 2, 5), ((2, 2, 2), (16, 16, 16), 1, 3)],
    ids=_ids)
def test_pinned_h_defer_solve_is_h_fused_with_one_band_call_a_round(
        mesh_shape, shape, depth, steps):
    dims = dict(zip(("nx", "ny", "nz"), shape), steps=steps)
    cfg = HeatConfig(backend="cuda", mesh_shape=mesh_shape, halo_depth=depth,
                     **dims)
    fused = solve(cfg, device="cpu")
    sk.reset_counts()
    with tune.force("block_temporal_3d", "H-defer"):
        got = solve(cfg, device="cpu")
    assert torch.equal(got.grid, fused.grid)
    rounds = -(-steps // depth)
    blocks = int(np.prod(mesh_shape))
    assert sk.counts["h_band_fix_plain"] == rounds
    assert sk.counts["h_block_fused_plain"] == rounds * blocks
    one = solve(HeatConfig(backend="cuda", **dims), device="cpu")
    assert torch.equal(got.grid, one.grid)


def test_round_makes_one_band_call_over_either_buffer_pair():
    """The H-defer round over a run's two buffer pairs, in turns: one band
    call a round, and each round bitwise the monolithic H-fused round,
    its residual the same."""
    k, block = 2, (6, 8, 8)
    grid, _, us, xch, origins = _exchanged((2, 2, 2), block, k)
    vs = [torch.empty_like(u) for u in us]
    with tune.force("block_temporal_3d", "H-defer"):
        defer = temporal3d.cuda_round_3d(xch, "H-defer", "overlap",
                                         grid_shape=grid, **COEFFS)
    fused = temporal3d.cuda_round_3d(xch, "H-fused", "overlap",
                                     grid_shape=grid, **COEFFS)
    a, b = us, vs
    for _ in range(3):
        want = [torch.empty_like(u) for u in a]
        r_want = fused(a, want, True)
        sk.reset_counts()
        r = defer(a, b, True)
        assert sk.counts["h_band_fix_plain"] == 1
        assert sk.counts["h_block_fused_plain"] == len(a)
        assert torch.equal(r, r_want)
        assert all(torch.equal(x, y) for x, y in zip(b, want))
        a, b = b, a


def test_launcher_refuses_bad_operands():
    k, block = 3, (8, 10, 14)
    grid, _, us, xch, origins = _exchanged((2, 2, 2), block, k)
    zt, yt, lo, hi = _pieces(xch)
    outs = [torch.empty(block) for _ in us]
    kw = dict(origins=origins, grid_shape=grid, **COEFFS)
    with pytest.raises(ValueError, match="for each of at least one"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, outs[:-1], k, **kw)
    with pytest.raises(ValueError, match="for each of at least one"):
        skb3.BandLaunch3D([], [], [], [], [], [], k, **{**kw, "origins": []})
    with pytest.raises(ValueError, match="blocks of one shape"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi,
                          outs[:-1] + [torch.empty((8, 10, 15))], k, **kw)
    with pytest.raises(ValueError, match="ytail shape"):
        skb3.BandLaunch3D(us, zt, [torch.zeros((8, 2 * k, 14))] * 8, lo, hi,
                          outs, k, **kw)
    with pytest.raises(ValueError, match="does not lie in the grid"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, outs, k,
                          **{**kw, "origins": [(9, 0, 0)] + origins[1:]})
    with pytest.raises(ValueError, match="load must be one of"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, outs, k, load="rows", **kw)
    with pytest.raises(ValueError, match="16-byte load"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, outs, k, load="vec", **kw)
    with pytest.raises(ValueError, match="does not take the shape"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, outs, k,
                          shape=((32, 16), 1, 4), **kw)
    with pytest.raises(ValueError, match="does not take the shape"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, outs, k,
                          shape=((32, 16), 2, 8), **kw)
    with pytest.raises(ValueError, match="different buffer"):
        skb3.BandLaunch3D(us, zt, yt, lo, hi, us, k, **kw)
    # Blocks of fewer than 2k planes, and an unsharded x axis.
    g2, _, us2, xch2, or2 = _exchanged((2, 2, 2), (5, 10, 14), k)
    with pytest.raises(ValueError, match="at least 2k"):
        skb3.BandLaunch3D(us2, *_pieces(xch2), [torch.empty((5, 10, 14))
                                               for _ in us2], k,
                          origins=or2, grid_shape=g2, **COEFFS)
    g3, _, us3, xch3, or3 = _exchanged((1, 2, 2), (8, 10, 14), k)
    with pytest.raises(ValueError, match="spans the grid along x"):
        skb3.BandLaunch3D(us3, xch3.ztail, xch3.ytail,
                          [torch.zeros((k, 16, 20))] * 4,
                          [torch.zeros((k, 16, 20))] * 4,
                          [torch.empty((8, 10, 14)) for _ in us3], k,
                          origins=or3, grid_shape=g3, **COEFFS)
    # The 16-byte load where it fits; the 4-byte one pinned; the one
    # block's call is a launch of one entry.
    g4, _, us4, xch4, or4 = _exchanged((2, 2, 2), (8, 10, 12), k)
    kw4 = dict(origins=or4, grid_shape=g4, **COEFFS)
    outs4 = [torch.empty((8, 10, 12)) for _ in us4]
    assert skb3.BandLaunch3D(us4, *_pieces(xch4), outs4, k,
                             **kw4).load == "vec"
    assert skb3.BandLaunch3D(us4, *_pieces(xch4), outs4, k, load="cells",
                             **kw4).load == "cells"
    assert skb3.BandLaunch3D(us, zt, yt, lo, hi, outs, k,
                             **kw).load == "cells"
