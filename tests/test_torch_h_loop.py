"""Kernel H on kernel F's plane loop: its geometry, on the CPU.

The CUDA kernel ``heat_h_block_3d`` (csrc/heat_h_block_3d.cu) runs only
on the card, where ``tests/test_torch_card.py`` and ``chip_smoke.py``
hold it bitwise to its plain version and to kernel F. Its arithmetic is
F's loop, emulated in ``tests/test_torch_f_loop.py``; what is H's own is
checked here:

- the tile grid over the block (``hopper_params.hc_tile_kinds``, the
  kernel's split into boxed and wrapped tiles) against a brute-force
  enumeration: every output cell written exactly once, each kind's
  count, and the launch shapes and layouts the wrappers refuse;
- the load, emulated in numpy: for every tile and input plane, the cells
  the TMA box (a tensor map of the circular block, zeros past it) or the
  per-cell cp.async (each row's circular offset fixed for the run, zeros
  outside the K-deep frame) put into the ring slot are the cells the
  circular layout holds there, at K = 1, 3 and 8, on ragged blocks and
  on meshes that leave an axis unsharded; the pad cells of a padded
  buffer (NaN here) are never read;
- the padded-pitch circular buffer of ``DeepExchange3D.new_circular``
  holding the values of the contiguous one and of the JAX package's
  ``exchange_halos_circular_3d`` (``shard_map`` over the 8 virtual CPU
  devices of ``tests/conftest.py``);
- a sharded solve with H pinned against the JAX package's sharded solve,
  under the few-ulp contract of ``tests/test_torch_sharded3d.py``
  (``rtol=1e-5, atol=1e-5``: XLA:CPU may contract multiply-adds into
  FMAs where the port rounds every operation), the faces bit-exact.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import parallel_heat_tpu as jx
from parallel_heat_tpu.parallel import temporal as jtemporal
from parallel_heat_tpu.parallel.mesh import AXIS_NAMES, make_heat_mesh
from parallel_heat_tpu.utils.compat import shard_map
from parallel_heat_tpu_torch import HeatConfig, solve, tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.parallel import temporal3d
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

f32 = np.float32
WIDTH = 128   # F's extended tile along Z (csrc/heat_temporal3d.cuh kFWidth)


def _tiles(block_shape, k, block, rows):
    """The kernel's tiles, ``[(y0, z0)]`` of each extended tile's first
    row and cell (block-local), as ``heat_h_block_3d_kernel`` numbers
    them: ``tiles_y`` by ``tiles_z``, tile t starting at t * (w - 2 pad)
    - pad."""
    p = params()
    _, by, bz = block_shape
    wy, _ = p.f_extent(block, rows)
    pad = p.f_pad(k)
    tiles_y = -(-by // (wy - 2 * k))
    tiles_z = -(-bz // (WIDTH - 2 * pad))
    return [(ty * (wy - 2 * k) - k, tz * (WIDTH - 2 * pad) - pad)
            for ty in range(tiles_y) for tz in range(tiles_z)]


def _boxed(y0, z0, halos, tma):
    """Does the tile take the box load (the kernel's test)?"""
    _, hy, hz = halos
    return tma and (y0 >= 0 or not hy) and (z0 >= 0 or not hz)


# (block, halos, K, (lanes, warps), rows): ragged blocks of every axis,
# a tile taller and wider than the block, unsharded axes (halo 0), K = 1
# to 8 at F's shapes.
GRID_CASES = [
    ((9, 70, 252), (3, 3, 3), 3, (32, 16), 2),
    ((5, 26, 120), (3, 3, 3), 3, (32, 16), 2),
    ((7, 133, 97), (1, 1, 1), 1, (32, 16), 2),
    ((6, 50, 70), (0, 3, 3), 3, (32, 16), 2),
    ((4, 90, 300), (3, 0, 3), 3, (32, 16), 2),
    ((4, 90, 300), (3, 3, 0), 3, (32, 16), 2),
    ((6, 64, 250), (5, 5, 5), 5, (32, 8), 4),
    ((3, 20, 33), (8, 8, 8), 8, (32, 8), 4),
    ((9, 40, 131), (2, 0, 0), 2, (32, 16), 1),
]


@pytest.mark.parametrize("block_shape,halos,k,block,rows", GRID_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_tile_grid_covers_each_output_once_and_counts_the_kinds(
        block_shape, halos, k, block, rows):
    p = params()
    assert p.f_takes(block, rows, k)
    bx, by, bz = block_shape
    wy, wz = p.f_extent(block, rows)
    pad = p.f_pad(k)
    cover = np.zeros((by, bz), np.int32)
    tiles = _tiles(block_shape, k, block, rows)
    for y0, z0 in tiles:
        ys = [y for y in range(y0 + k, y0 + wy - k) if y < by]
        zs = [z for z in range(z0 + pad, z0 + wz - pad) if z < bz]
        cover[np.ix_(ys, zs)] += 1
        assert y0 >= -k and z0 >= -pad and z0 % 4 == 0
    assert (cover == 1).all()
    origin = tuple(h * 10 for h in halos)       # a block inside the grid
    grid = tuple(o + b + h * 10 for o, b, h in zip(origin, block_shape,
                                                     halos))
    for tma in (True, False):
        kinds = p.hc_tile_kinds(block_shape, k, halos, origin, grid, tma,
                                block, rows)
        boxed = sum(_boxed(y0, z0, halos, tma) for y0, z0 in tiles)
        assert kinds["tiles"] == len(tiles)
        assert (kinds["boxed"], kinds["wrapped"]) == (boxed,
                                                      len(tiles) - boxed)
        assert kinds["interior"] + kinds["edge"] == len(tiles)
    # The first row and column of tiles reach below 0: wrapped where that
    # axis is sharded, boxed where it is not (those cells lie outside the
    # grid: the box's zeros).
    first = sum(bool((y0 < 0 and halos[1]) or (z0 < 0 and halos[2]))
                for y0, z0 in tiles)
    assert p.hc_tile_kinds(block_shape, k, halos, origin, grid, True, block,
                           rows)["wrapped"] == first
    # X segments cover the block's planes once.
    _, _, _, seg = p.hc_launch(block_shape, k, (block, rows, 4))
    planes = [x for s in range(0, bx, seg) for x in range(s, min(s + seg,
                                                                 bx))]
    assert planes == list(range(bx))


def test_main_block_tile_kinds_and_launch():
    p = params()
    bs, k = (512, 512, 512), p.h_k_default
    block, rows, prefetch, seg = p.hc_launch(bs, k)
    assert (block, rows, prefetch) == p.hc_shape(k)
    # 20 x 5 tiles of 26 x 120 output cells; the first row and column of
    # tiles read the lo pieces (24 of 100).
    for origin in ((0, 0, 0), (512, 512, 512)):
        kinds = p.hc_tile_kinds(bs, k, (k, k, k), origin, (1024,) * 3)
        assert (kinds["tiles"], kinds["boxed"], kinds["wrapped"]) == (100,
                                                                      76, 24)
    assert p.hc_tile_kinds(bs, k, (k, k, k), (0,) * 3, (1024,) * 3,
                           False)["boxed"] == 0
    assert -(-bs[0] // seg) * 100 >= p.sm_count


def test_shapes_and_layouts_the_wrapper_refuses():
    p = params()
    assert p.hc_k_max() == p.f_k_compiled
    for k in range(1, p.hc_k_max() + 1):
        block, rows, prefetch = p.hc_shape(k)
        assert p.f_takes(block, rows, k)
        assert k <= p.f_k_max(block, rows, prefetch)
    assert p.hc_shape(p.f_k_compiled + 1) is None
    assert not p.f_takes((32, 16), 4, 3) and not p.f_takes((16, 16), 2, 3)
    assert [p.hc_pitch(z) for z in (518, 520, 97, 1)] == [520, 520, 100, 4]
    mesh = HeatMesh((2, 2, 2))
    bs, k = (6, 10, 13), 3
    grid = tuple(2 * b for b in bs)
    us = mesh.split(torch.zeros(grid))
    xch = temporal3d.DeepExchange3D(mesh, bs, k, "cpu")
    kw = dict(origin=(0, 0, 0), grid_shape=grid, cx=0.1, cy=0.1, cz=0.1)
    contig = torch.zeros(xch.circular_shape)          # rows of 19 floats
    padded = xch.new_circular()
    assert padded.stride() == (16 * 20, 20, 1)
    assert skb3.pitched_ok(padded) and skb3.pitched_ok(contig)
    assert skb3.h_block_load(padded) == "tma"
    assert skb3.h_block_load(contig) == "cp.async"
    out = torch.empty(bs)
    with pytest.raises(ValueError, match="TMA load needs the circular"):
        skb3.h_block(contig, out, k, load="tma", **kw)
    with pytest.raises(ValueError, match="load must be one of"):
        skb3.h_block(padded, out, k, load="bulk", **kw)
    # Planes that are not packed rows of the pitch, and a column view.
    loose = torch.zeros((12, 17, 20))[:, :16, :19]
    with pytest.raises(ValueError, match="contiguous rows"):
        skb3.h_block(loose, out, k, **kw)
    with pytest.raises(ValueError, match="contiguous rows"):
        skb3.h_block(torch.zeros((12, 16, 38))[..., ::2], out, k, **kw)
    xch.lead(us)
    xch.last(us)
    xch.assemble_circular(0, us[0], padded)
    a, b = torch.empty(bs), torch.empty(bs)
    ra = skb3.h_block(padded, a, k, load="cp.async", **kw)
    rb = skb3.h_block(padded, b, k, **kw)
    assert torch.equal(a, b) and torch.equal(ra, rb)


def _load_slot(store, ext_x, ye, ze, pitch, block_shape, halos, k, block,
               rows, tma, t, y0, z0):
    """The (wy, 128) cells kernel H's load puts in a ring slot for
    block-local input plane ``t`` of the tile at ``(y0, z0)``, from the
    circular block's storage ``store`` (``ext_x`` planes of ``ye`` rows of
    ``pitch`` floats, ``ze`` of them the block's): the box of a tensor
    map of dims (ze, ye, ext_x) at (z0, y0, t + hx), or each lane's four
    4-byte copies from its row's fixed offset. Returns ``(cells, boxed)``."""
    p = params()
    bx, by, bz = block_shape
    hx, hy, hz = halos
    _, warps = block
    wy = warps * rows
    e = t + hx
    boxed = _boxed(y0, z0, halos, tma)
    cells = np.zeros((wy, WIDTH), f32)
    if not 0 <= e < ext_x:
        return cells, boxed
    ly = y0 + np.arange(wy)
    c = np.arange(WIDTH)
    if boxed:
        lz = z0 + c
        my, mz = (ly >= 0) & (ly < ye), (lz >= 0) & (lz < ze)
        cells[np.ix_(my, mz)] = store[e][np.ix_(ly[my], lz[mz])]
        return cells, boxed
    lz0 = z0 + 4 * (c // 4)
    zc0 = np.where(lz0 < 0, lz0 + ze, lz0)
    coff = (np.where(ly < 0, ly + ye, ly) * pitch)[:, None] + (zc0 + c % 4)
    lz = z0 + c
    cin = (((ly >= -hy) & (ly < by + hy))[:, None]
           & ((lz >= -hz) & (lz < bz + hz))[None, :])
    flat = store[e].reshape(-1)
    cells[cin] = flat[coff[cin]]
    assert p.f_pad(k) % 4 == 0 and z0 % 4 == 0
    return cells, boxed


# (mesh, block, K, padded): a (2, 2, 2) corner and far block, ragged
# blocks on (3, 3, 3), unsharded z (2, 4, 1) and x (1, 2, 2), K = 1, 3, 8.
LOAD_CASES = [
    ((2, 2, 2), (9, 60, 140), 3, True),
    ((2, 2, 2), (9, 60, 140), 3, False),
    ((3, 3, 3), (5, 31, 130), 1, True),
    ((3, 3, 3), (20, 21, 130), 8, True),
    ((2, 4, 1), (7, 40, 97), 3, True),
    ((1, 2, 2), (6, 60, 133), 3, True),
    ((2, 2, 2), (17, 17, 17), 8, False),
]


@pytest.mark.parametrize("mesh_shape,bs,k,padded", LOAD_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_emulated_load_puts_the_circular_cells_in_each_slot(mesh_shape, bs,
                                                            k, padded):
    p = params()
    block, rows, _ = p.hc_shape(k)
    grid = tuple(m * b for m, b in zip(mesh_shape, bs))
    rng = np.random.default_rng(sum(grid) + k)
    g = torch.from_numpy((rng.standard_normal(grid) * 10 + 20).astype(f32))
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(g)
    xch = temporal3d.DeepExchange3D(mesh, bs, k, "cpu")
    xch.lead(us)
    xch.last(us)
    halos = xch.halos
    ext_x, ye, ze = xch.circular_shape
    bx, by, bz = bs
    wy, wz = p.f_extent(block, rows)
    seen = {True: 0, False: 0}
    # The first block, the last and one between (every kind of edge).
    for b in sorted({0, mesh.size // 2, mesh.size - 1}):
        pitch = p.hc_pitch(ze) if padded else ze
        store = torch.full((ext_x, ye, pitch), float("nan"))
        ext = store[..., :ze]
        xch.assemble_circular(b, us[b], ext)
        frame = skb3._frame_of_pieces(
            *skb3._pieces_of_circular(ext, bs, halos), k).numpy()
        store = store.numpy()
        for tma in ((True, False) if padded else (False,)):
            for y0, z0 in _tiles(bs, k, block, rows):
                ly = y0 + np.arange(wy)
                lz = z0 + np.arange(wz)
                fy = (ly >= -k) & (ly < by + k)
                fz = (lz >= -k) & (lz < bz + k)
                for t in range(-k, bx + k):
                    cells, boxed = _load_slot(store, ext_x, ye, ze, pitch,
                                              bs, halos, k, block, rows, tma,
                                              t, y0, z0)
                    seen[boxed] += 1
                    # The pad cells are never read.
                    assert not np.isnan(cells).any(), (b, y0, z0, t)
                    want = frame[t + k][np.ix_(ly[fy] + k, lz[fz] + k)]
                    np.testing.assert_array_equal(
                        cells[np.ix_(fy, fz)], want,
                        err_msg=f"block {b} tile ({y0}, {z0}) plane {t} "
                                f"{'box' if boxed else 'cp.async'}")
                    if not boxed:   # zeros outside the K-deep frame
                        assert not cells[~fy].any()
                        assert not cells[:, ~fz].any()
    # Both loads ran where the layout takes TMA; the per-cell one always.
    assert seen[False] > 0 and (seen[True] > 0) == padded


def _jax_circular(g, mesh_shape, k):
    """Each block's circular block from the JAX package's exchange, its
    tails 2k wide where an axis is sharded (no seam zeros)."""
    mesh = make_heat_mesh(mesh_shape)
    tails = [2 * k if d > 1 else 0 for d in mesh_shape]
    spec = PartitionSpec(*AXIS_NAMES)
    fn = shard_map(lambda u: jtemporal.exchange_halos_circular_3d(
        u, k, mesh_shape, AXIS_NAMES, tail_y=tails[1], tail_z=tails[2]),
        mesh, in_specs=spec, out_specs=spec, check_vma=False)
    out = np.asarray(fn(g))
    ext = [s // d for s, d in zip(out.shape, mesh_shape)]
    hmesh = HeatMesh(mesh_shape)
    return [out[tuple(slice(c * e, (c + 1) * e)
                      for c, e in zip(hmesh.coords(b), ext))]
            for b in range(hmesh.size)]


@pytest.mark.parametrize("mesh_shape,bs,k", [
    ((2, 2, 2), (6, 7, 9), 3), ((2, 2, 2), (5, 8, 8), 1),
    ((2, 4, 1), (6, 5, 9), 2), ((1, 2, 4), (8, 6, 5), 3)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_padded_circular_buffer_holds_the_contiguous_and_jax_values(
        mesh_shape, bs, k):
    grid = tuple(m * b for m, b in zip(mesh_shape, bs))
    g = (np.random.default_rng(4).standard_normal(grid) * 10).astype(f32)
    mesh = HeatMesh(mesh_shape)
    us = mesh.split(torch.from_numpy(g))
    contig = temporal3d.exchange_halos_circular_3d(mesh, us, k)
    xch = temporal3d.DeepExchange3D(mesh, bs, k, "cpu")
    xch.lead(us)
    xch.last(us)
    jax_ext = _jax_circular(g, mesh_shape, k)
    for b in range(mesh.size):
        padded = xch.new_circular()
        assert padded.shape == contig[b].shape
        assert padded.stride(1) % 4 == 0 and padded.stride(2) == 1
        xch.assemble_circular(b, us[b], padded)
        assert torch.equal(padded, contig[b])
        np.testing.assert_array_equal(padded.numpy(), jax_ext[b])


@pytest.mark.parametrize("mesh_shape,shape,depth,steps", [
    ((2, 2, 2), (16, 20, 24), 3, 7), ((2, 4, 1), (16, 16, 12), 4, 8),
    ((2, 2, 2), (16, 16, 16), 1, 3)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_pinned_h_sharded_solve_matches_jax(mesh_shape, shape, depth, steps):
    dims = dict(zip(("nx", "ny", "nz"), shape), steps=steps)
    want = jx.solve(jx.HeatConfig(backend="jnp", mesh_shape=mesh_shape,
                                  halo_depth=depth, **dims)).to_numpy()
    sk.reset_counts()
    with tune.force("block_temporal_3d", "H"):
        got = solve(HeatConfig(backend="cuda", mesh_shape=mesh_shape,
                               halo_depth=depth, **dims), device="cpu")
    assert sk.counts["h_block_plain"] > 0
    assert not any(n for name, n in sk.counts.items()
                   if name.endswith("_plain") and name != "h_block_plain")
    g = got.to_numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * scale)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
               np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(g[sl], want[sl])
    one = solve(HeatConfig(backend="cuda", **dims), device="cpu")
    assert torch.equal(got.grid, one.grid)
