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
"""

import numpy as np
import pytest
import torch

from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

f32 = np.float32
LANES = 32


def _combine3(c, xm, xp, ym, yp, zm, zp, a0, cx, cy, cz):
    return (((a0 * c) + (cx * (xm + xp))) + (cy * (ym + yp))) \
        + (cz * (zm + zp))


def _emulate(u, k, block, rows, seg, prefetch, coeffs):
    """The kernel's output grid and residual for ``u``."""
    p = params()
    a0, cx, cy, cz = (f32(c) for c in coeffs)
    nx, ny, nz = u.shape
    W, R = block[1], rows
    E = min(R, 2)
    wy, wz = p.f_extent(block, rows)
    ty, tz = p.f_tile(k, block, rows)
    P = p.f_pad(k)
    tiles_z, tiles_y = -(-nz // tz), -(-ny // ty)
    out = np.full(u.shape, np.nan, dtype=f32)
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
        ring = np.full((slots, wy + 2, wz), np.nan, dtype=f32)
        lev = np.full((max(k - 1, 0), 2, E * W + 2, wz), np.nan, dtype=f32)
        ys, zs = np.arange(y0, y0 + wy), np.arange(z0, z0 + wz)
        yy, zz = (ys >= 0) & (ys < ny), (zs >= 0) & (zs < nz)

        def fetch(slot, t):
            tile = np.zeros((wy, wz), dtype=f32)
            if 0 <= t < nx:
                tile[np.ix_(yy, zz)] = u[t][np.ix_(ys[yy], zs[zz])]
            ring[slot, 1:wy + 1] = tile

        regs = [np.zeros((k, W, R, LANES, 4), dtype=f32) for _ in range(3)]
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
                    pr = ring[prev].reshape(wy + 2, LANES, 4)
                    yu, yd = pr[w_idx * R], pr[w_idx * R + R + 1]
                else:
                    nb = lev[s - 2, par ^ 1].reshape(E * W + 2, LANES, 4)
                    yu, yd = nb[E * w_idx], nb[1 + E * (w_idx + 1)]
                x_in = (not check) or (1 <= t - s <= nx - 2)
                v = np.empty((W, R, LANES, 4), dtype=f32)
                with np.errstate(all="ignore"):
                    for r in range(R):
                        c = M[s - 1][:, r]
                        ym = M[s - 1][:, r - 1] if r > 0 else yu
                        yp = M[s - 1][:, r + 1] if r + 1 < R else yd
                        zl = np.concatenate([c[:, :1, 3], c[:, :-1, 3]], 1)
                        zr = np.concatenate([c[:, 1:, 0], c[:, -1:, 0]], 1)
                        zm = np.stack([zl, c[..., 0], c[..., 1], c[..., 2]],
                                      -1)
                        zp = np.stack([c[..., 1], c[..., 2], c[..., 3], zr],
                                      -1)
                        new = _combine3(c, U[s - 1][:, r], D[s - 1][:, r],
                                        ym, yp, zm, zp, a0, cx, cy, cz)
                        if check:
                            sel = (x_in & yin[:, r])[:, None, None] & zin
                            new = np.where(sel, new, c)
                        v[:, r] = new
                if s < k:
                    dst = lev[s - 1, par].reshape(E * W + 2, LANES, 4)
                    dst[1 + E * w_idx] = v[:, 0]
                    dst[1 + E * w_idx + E - 1] = v[:, R - 1]
                    D[s] = v
                elif x0 <= t - k < x1:
                    for w in range(W):
                        for r in range(R):
                            if not yout[w, r]:
                                continue
                            inm = zout & (zin & bool(x_in and yin[w, r])
                                          if check else True)
                            with np.errstate(all="ignore"):
                                diff = np.abs(v[w, r] - M[k - 1][w, r])
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
