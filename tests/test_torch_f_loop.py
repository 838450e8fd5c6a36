"""Kernel F's register-blocked plane loop, emulated in numpy.

The CUDA kernel ``heat_f_temporal3d`` (csrc/heat_f_temporal3d.cu, its
loop ``HeatFLoop`` in csrc/heat_temporal3d.cuh) runs only on the card.
This file replays its schedule on the CPU, one thread block at a time
with all of the block's threads at once: the tiles of
``hopper_params.f_tile`` and ``f_pad``, the ring of ``prefetch + 2``
input planes with a lead and a tail row, the level buffers that hold only
each warp's first and last rows by the plane's parity, the three register
planes a level renamed plane by plane, Z neighbours by shuffle (lanes 0
and 31 take their own cell), and the checked step where a tile or a plane
reaches past the global interior. Every shared cell the load leaves alone
is NaN, so a value from outside the K-step cone that reached an output
would show. Each case is held bitwise, grid and residual, to the port's
plain version, whose arithmetic the kernel repeats operation for
operation (every operation rounded to float32 in both).

The bfloat16 form (``heat_f_temporal3d_bf16``, the same loop with
``Tin = Tout = __nv_bfloat16`` and a bfloat16 level layout) is emulated
too: a ring of bfloat16 cells (NaN bits in every cell not yet filled)
widened exactly as a lane reads its group, the 8-cell halo along Z
(``f_pad`` at 2 bytes), the levels held as bfloat16 bits (the packed
layout's registers; the float4 layout holds the same values widened),
each level below K rounded to bfloat16 before the copied cells are
restored, the store rounding the updated cells and narrowing the copied
ones, and the cp.async path's two routes (one 8-byte copy where a lane's
4 cells lie inside the grid on 8 bytes, 2-byte loads and zeros
elsewhere), each case held bitwise to the bfloat16 plain version.
"""

import numpy as np
import pytest
import torch

from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

f32 = np.float32
LANES = 32
NAN_BITS = np.uint16(0x7FC1)   # a NaN no conversion makes


def _widen(bits):
    """bfloat16 bits as float32, exactly (heat_widen)."""
    return (bits.astype(np.uint32) << 16).view(f32)


def _round(x):
    """float32 rounded to bfloat16 and widened back (heat_bf16_round), by
    torch's own conversion, as the plain version rounds."""
    b = torch.from_numpy(np.ascontiguousarray(x, dtype=f32)).to(
        torch.bfloat16)
    return _widen(b.view(torch.int16).numpy().view(np.uint16))


def _narrow(x):
    """The bfloat16 bits of a float32 that holds one (heat_bf16_exact)."""
    return (np.ascontiguousarray(x, dtype=f32).view(np.uint32) >> 16
            ).astype(np.uint16)


def _combine3(c, xm, xp, ym, yp, zm, zp, a0, cx, cy, cz):
    return (((a0 * c) + (cx * (xm + xp))) + (cy * (ym + yp))) \
        + (cz * (zm + zp))


def _emulate(u, k, block, rows, seg, prefetch, coeffs, load="cp.async",
             routes=None):
    """The kernel's output grid and residual for ``u``: float32, or with
    ``u`` a grid of bfloat16 bits (uint16) the bfloat16 form's, under
    ``load``; ``routes`` (a dict) counts the bfloat16 cp.async load's
    lane-rows by route ("copy8", "cells")."""
    p = params()
    a0, cx, cy, cz = (f32(c) for c in coeffs)
    nx, ny, nz = u.shape
    bf16 = u.dtype == np.uint16
    elem = 2 if bf16 else 4
    W, R = block[1], rows
    E = min(R, 2)
    wy, wz = p.f_extent(block, rows)
    ty, tz = p.f_tile(k, block, rows, elem)
    P = p.f_pad(k, elem)
    tiles_z, tiles_y = -(-nz // tz), -(-ny // ty)
    out = (np.full(u.shape, NAN_BITS) if bf16
           else np.full(u.shape, np.nan, dtype=f32))
    routes = {} if routes is None else routes
    rmax = np.uint32(0)
    slots = prefetch + 2
    lane, w_idx = np.arange(LANES), np.arange(W)
    for b in range(tiles_z * tiles_y * -(-nx // seg)):
        x0 = b // tiles_z // tiles_y * seg
        x1 = min(x0 + seg, nx)
        z0 = b % tiles_z * tz - P
        y0 = (b // tiles_z) % tiles_y * ty - k
        gz = z0 + 4 * lane[:, None] + np.arange(4)[None, :]
        gy = y0 + w_idx[:, None] * R + np.arange(R)[None, :]
        cell = 4 * lane[:, None] + np.arange(4)[None, :]
        row = w_idx[:, None] * R + np.arange(R)[None, :]
        zin = (gz >= 1) & (gz <= nz - 2)
        yin = (gy >= 1) & (gy <= ny - 2)
        zout = (cell >= P) & (cell < wz - P) & (gz < nz)
        yout = (row >= k) & (row < wy - k) & (gy < ny)
        edge = y0 < 1 or y0 + wy > ny - 1 or z0 < 1 or z0 + wz > nz - 1
        ring = (np.full((slots, wy + 2, wz), NAN_BITS) if bf16
                else np.full((slots, wy + 2, wz), np.nan, dtype=f32))
        lev = np.full((max(k - 1, 0), 2, E * W + 2, wz), np.nan, dtype=f32)
        ys, zs = np.arange(y0, y0 + wy), np.arange(z0, z0 + wz)
        yy, zz = (ys >= 0) & (ys < ny), (zs >= 0) & (zs < nz)
        if bf16:
            # A box starts on 16 bytes: TMA takes no other start.
            assert load != "tma" or (z0 % 8 == 0 and nz % 8 == 0)

        def fetch(slot, t):
            tile = np.zeros((wy, wz), dtype=u.dtype)
            if 0 <= t < nx:
                tile[np.ix_(yy, zz)] = u[t][np.ix_(ys[yy], zs[zz])]
            if bf16 and load == "cp.async" and 0 <= t < nx:
                # Per lane and row: one 8-byte copy where its 4 cells lie
                # inside the grid on 8 bytes, else a 2-byte load a cell
                # inside the grid and a zero outside it (the same bits).
                at = (t * ny + ys[:, None]) * nz + zs[None, 0::4]
                whole = (yy[:, None] & zz.reshape(LANES, 4).all(1)[None, :])
                copy8 = whole & (at % 4 == 0)
                routes["copy8"] = routes.get("copy8", 0) + int(copy8.sum())
                routes["cells"] = (routes.get("cells", 0)
                                   + int((~copy8).sum()))
            ring[slot, 1:wy + 1] = tile

        # The register planes of levels 0 .. K-1: float32, or at bfloat16
        # the levels' bits (the kernel's packed uint2 groups), widened
        # where they are read.
        regs = [np.zeros((k, W, R, LANES, 4), dtype=u.dtype)
                for _ in range(3)]
        read = _widen if bf16 else (lambda a: a)
        t0, t1 = x0 - k, x1 + k
        for i in range(prefetch):
            if t0 + i < t1:
                fetch(i, t0 + i)
        cur = 0
        for n, t in enumerate(range(t0, t1)):
            U, M, D = regs[n % 3], regs[(n + 1) % 3], regs[(n + 2) % 3]
            prev = slots - 1 if cur == 0 else cur - 1
            if t + prefetch < t1:
                fetch((cur + prefetch) % slots, t + prefetch)
            check = edge or not (t - k >= 1 and t - 1 <= nx - 2)
            D[0] = ring[cur, 1:wy + 1].reshape(W, R, LANES, 4)
            par = t & 1
            for s in range(1, k + 1):
                if s == 1:
                    pr = read(ring[prev]).reshape(wy + 2, LANES, 4)
                    yu, yd = pr[w_idx * R], pr[w_idx * R + R + 1]
                else:
                    nb = lev[s - 2, par ^ 1].reshape(E * W + 2, LANES, 4)
                    yu, yd = nb[E * w_idx], nb[1 + E * (w_idx + 1)]
                x_in = (not check) or (1 <= t - s <= nx - 2)
                v = np.empty((W, R, LANES, 4), dtype=u.dtype)
                new_k = np.empty((W, R, LANES, 4), dtype=f32)
                mid = read(M[s - 1])
                with np.errstate(all="ignore"):
                    for r in range(R):
                        c = mid[:, r]
                        ym = mid[:, r - 1] if r > 0 else yu
                        yp = mid[:, r + 1] if r + 1 < R else yd
                        zl = np.concatenate([c[:, :1, 3], c[:, :-1, 3]], 1)
                        zr = np.concatenate([c[:, 1:, 0], c[:, -1:, 0]], 1)
                        zm = np.stack([zl, c[..., 0], c[..., 1], c[..., 2]],
                                      -1)
                        zp = np.stack([c[..., 1], c[..., 2], c[..., 3], zr],
                                      -1)
                        new = _combine3(c, read(U[s - 1][:, r]),
                                        read(D[s - 1][:, r]), ym, yp, zm,
                                        zp, a0, cx, cy, cz)
                        new_k[:, r] = new
                        sel = ((x_in & yin[:, r])[:, None, None] & zin
                               if check else np.ones(new.shape, bool))
                        if bf16:
                            # Rounded, the copied cells' bits kept.
                            new = np.where(sel, _narrow(_round(new)),
                                           M[s - 1][:, r])
                        else:
                            new = np.where(sel, new, c)
                        v[:, r] = new
                if s < k:
                    dst = lev[s - 1, par].reshape(E * W + 2, LANES, 4)
                    dst[1 + E * w_idx] = read(v[:, 0])
                    dst[1 + E * w_idx + E - 1] = read(v[:, R - 1])
                    D[s] = v
                elif x0 <= t - k < x1:
                    for w in range(W):
                        for r in range(R):
                            if not yout[w, r]:
                                continue
                            inm = zout & (zin & bool(x_in and yin[w, r])
                                          if check else True)
                            with np.errstate(all="ignore"):
                                diff = np.abs(new_k[w, r] - mid[w, r])
                            bits = diff.astype(f32).view(np.uint32)[inm]
                            if bits.size:
                                rmax = max(rmax, bits.max())
                            out[t - k, gy[w, r], gz[zout]] = v[w, r][zout]
            cur = (cur + 1) % slots
    return out, np.array([rmax], dtype=np.uint32).view(f32)[0]


# (grid, K, (lanes, warps), rows, segment, prefetch): interior tiles
# (9 x 70 x 252 and 10 x 60 x 260 hold one), tiles past every side,
# ragged and partial last groups (nz % 4 != 0), one tile thicker than
# the grid (5 x 3 x 300, 6 x 5 x 3), every row count, one plane in
# flight and eight, K from 1 to 7.
CASES = [
    ((9, 70, 252), 3, (32, 16), 2, 4, 4),
    ((9, 70, 250), 3, (32, 16), 2, 3, 1),
    ((10, 60, 260), 2, (32, 8), 4, 3, 8),
    ((9, 45, 250), 1, (32, 16), 1, 5, 4),
    ((8, 30, 131), 4, (32, 8), 4, 2, 2),
    ((12, 17, 245), 5, (32, 8), 4, 4, 3),
    ((13, 40, 130), 7, (32, 8), 4, 6, 2),
    ((5, 3, 300), 3, (32, 16), 2, 64, 4),
    ((6, 5, 3), 1, (32, 16), 2, 2, 4),
]


@pytest.mark.parametrize("shape,k,block,rows,seg,prefetch", CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_plane_loop_emulation_is_the_plain_version(shape, k, block, rows,
                                                   seg, prefetch):
    p = params()
    assert p.f_takes(block, rows, k)
    assert k <= p.f_k_max(block, rows, prefetch)
    coeffs = (0.1, 0.15, 0.05)
    rng = np.random.default_rng(sum(shape) + k)
    u = (rng.standard_normal(shape) * 10).astype(f32)
    got, res = _emulate(u, k, block, rows, seg, prefetch,
                        coeffs3_f32(*coeffs))
    want = torch.empty(shape, dtype=torch.float32)
    rp = sk3.xslab_steps_3d_plain(torch.from_numpy(u), want, k, True,
                                  cx=coeffs[0], cy=coeffs[1], cz=coeffs[2])
    np.testing.assert_array_equal(got, want.numpy())
    assert float(res) == float(rp)


def test_plane_loop_emulation_reaches_the_nan():
    # A NaN in the interior reaches the residual; the faces stay.
    u = (np.random.default_rng(2).standard_normal((9, 40, 132)) * 10
         ).astype(f32)
    u[4, 20, 60] = np.nan
    got, res = _emulate(u, 3, (32, 16), 2, 4, 4, coeffs3_f32(0.1, 0.1, 0.1))
    assert np.isnan(res)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
               np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(got[sl], u[sl])


def _bf16_bits(shape, seed, nan=False):
    """A random bfloat16 grid's bits (either sign, magnitudes to about
    40); with ``nan`` NaNs of payloads no conversion makes, inside and on
    the faces."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((rng.standard_normal(shape) * 10).astype(f32))
    bits = u.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    if nan:
        nx, ny, nz = shape
        for at, b in (((nx // 2, ny // 2, nz // 3), 0x7FC1),
                      ((0, ny // 2, nz // 2), 0xFFC0),
                      ((nx // 2, ny - 1, 1), 0x7F81),
                      ((nx // 3, 1, nz - 1), 0x7FC1)):
            bits[at] = b
    return bits


def _bf16_plain(bits, k, coeffs):
    u = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    out = torch.full(bits.shape, float("nan"), dtype=torch.bfloat16)
    res = sk3.xslab_steps_3d_plain(u, out, k, True, cx=coeffs[0],
                                   cy=coeffs[1], cz=coeffs[2])
    return out.view(torch.int16).numpy().view(np.uint16), float(res)


# (grid, K, (lanes, warps), rows, segment, prefetch, load) at bfloat16:
# the shape rule's default and deep shapes, rows of 8k + 4 cells (TMA at
# float32, cp.async here: both copy routes), rows of 8k (TMA), odd rows,
# a tile thicker than the grid, K from 1 to 8.
BF16_CASES = [
    ((9, 70, 252), 3, (32, 16), 2, 4, 4, "cp.async"),
    ((9, 70, 256), 3, (32, 16), 2, 3, 1, "tma"),
    ((10, 60, 260), 2, (32, 8), 4, 3, 8, "cp.async"),
    ((9, 45, 248), 1, (32, 16), 1, 5, 4, "tma"),
    ((8, 30, 131), 4, (32, 8), 4, 2, 2, "cp.async"),
    ((12, 17, 245), 5, (32, 8), 4, 4, 3, "cp.async"),
    ((13, 40, 136), 7, (32, 8), 4, 6, 2, "tma"),
    ((20, 40, 130), 8, (32, 8), 4, 6, 4, "cp.async"),
    ((5, 3, 300), 3, (32, 16), 2, 64, 4, "cp.async"),
    ((6, 5, 3), 1, (32, 16), 2, 2, 4, "cp.async"),
]


@pytest.mark.parametrize("shape,k,block,rows,seg,prefetch,load", BF16_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_bf16_plane_loop_emulation_is_the_bf16_plain_version(
        shape, k, block, rows, seg, prefetch, load):
    p = params()
    assert p.f_takes(block, rows, k, elem=2)
    assert k <= p.f_k_max(block, rows, prefetch, elem=2)
    assert (load == "tma") == p.f_tma_fits(shape, "bfloat16")
    coeffs = (0.1, 0.15, 0.05)
    bits = _bf16_bits(shape, sum(shape) + k)
    routes = {}
    got, res = _emulate(bits, k, block, rows, seg, prefetch,
                        coeffs3_f32(*coeffs), load, routes)
    want, rp = _bf16_plain(bits, k, coeffs)
    np.testing.assert_array_equal(got, want)
    assert float(res) == rp
    if load == "cp.async" and shape[2] % 4 == 0 and shape[2] > 128:
        # Rows of 4k cells: inner groups copy 8 bytes, edge ones by cells.
        assert routes["copy8"] > 0 and routes["cells"] > 0


def test_bf16_halo_is_eight_cells():
    # A bfloat16 tile's box starts on 16 bytes at every K: the 8-cell
    # halo, 112 output cells along Z.
    p = params()
    for k in range(1, 9):
        assert p.f_pad(k, 2) == 8 and p.f_tile(k, elem=2)[1] == 112
    assert [p.f_pad(k) for k in (1, 4, 5, 8)] == [4, 4, 8, 8]


def test_bf16_plane_loop_emulation_reaches_the_nan():
    # A NaN in the interior reaches the residual; the faces keep their
    # bits, NaN payloads included.
    bits = _bf16_bits((9, 40, 132), 2, nan=True)
    got, res = _emulate(bits, 3, (32, 16), 2, 4, 4,
                        coeffs3_f32(0.1, 0.1, 0.1))
    assert np.isnan(res)
    want, rp = _bf16_plain(bits, 3, (0.1, 0.1, 0.1))
    assert np.isnan(rp)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
               np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_array_equal(got[sl], bits[sl])
        np.testing.assert_array_equal(want[sl], bits[sl])
    np.testing.assert_array_equal(np.isnan(_widen(got)),
                                  np.isnan(_widen(want)))
