"""Kernels I and I-uni's band stream, emulated in numpy.

The CUDA kernels ``heat_i_tile_temporal`` and ``heat_i_uni_tile_temporal``
(csrc/heat_i_tile_temporal.cu, heat_i_uni_tile_temporal.cu; their loop
``HeatIBand`` in csrc/heat_i_loop.cuh) run only on the card. This file
replays their schedule on the CPU, one segment at a time with all of its
warps at once: blocks of ``i_warps`` bands side by side, a band of 32
lanes of 4 columns (``i_pad``, ``i_tile_x``), the segments of
``i_launch``, each warp's ring of ``i_stages`` stages of ``i_rows`` input
rows filled ahead and refilled once a stage's last row has been read for
the last time (zeros outside the grid; I's per-lane copies, 16 bytes
where a lane's cells lie inside the grid on a 16-byte boundary, or
I-uni's box), level 0 read from the ring three rows at a time, the three
register rows of each level above it renamed row by row, the cells left and right
of a lane's group by shuffle, the checked step outside the rows and
bands that the kernels step test-free. The
shuffle hands lanes 0 and 31 NaN for their missing outer neighbour, and
every register and ring cell starts as NaN, so a value from outside the
K-step cone that reached an output would show. Each case is held bitwise,
grid and residual, to the port's plain version, whose arithmetic the
kernels repeat operation for operation (every operation rounded to
float32 in both), and every output cell must be written exactly once.
The emulation is also held to the JAX package's ``heat_i_tile_temporal``
in interpret mode, within the few-ulp contract of
``tests/test_torch_kernels.py``. The bfloat16 forms
(``heat_i_tile_temporal_bf16``, ``heat_i_uni_tile_temporal_bf16``) are
emulated too: their ring of 136-cell rows from 16 bytes of the grid's row
(NaN in every cell no lane or box fills), the levels rounded in storage
mode, the output rounded where it is bfloat16, each held bitwise to the
plain version of its form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

f32 = np.float32
LANES = 32
CX, CY = 0.1, 0.2
# The main path's coefficients, and unequal ones so that a swap of the
# axes cannot pass.
COEFFS = [(0.1, 0.1), (CX, CY)]
# Width not a multiple of 4 (I only) over three bands; narrower than one
# band; 3 x 8; m = 3; several segments; I-uni's widths over three bands.
SHAPES = [(37, 257), (40, 50), (3, 8), (3, 300), (200, 132), (130, 244)]


def _combine(c, up, dn, left, right, a0, cx, cy):
    return ((a0 * c) + (cx * (up + dn))) + (cy * (left + right))


def _bf16(x):
    """float32 values rounded to bfloat16 (round to nearest even, as the
    plain versions' ``.to(torch.bfloat16)``), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=f32)).to(
        torch.bfloat16).float().numpy()


def _emulate(u, k, *, seg_rows=None, warps=None, rows=None, stages=None,
             coeffs=(CX, CY), uni=None, form=None):
    """The kernels' output grid, residual (float32), write count per cell
    and what each band did, for ``u`` under the launch ``i_launch`` and
    the ``i_*`` defaults give (or the arguments). With ``form`` a
    bfloat16 form's (``stencil_kernels.PRECISION_FORMS``; ``u`` holds the
    input's values as float32, the output is returned so): a bfloat16
    input's ring rows of 136 cells from the band's first cell rounded
    down to 8 (I-uni's box fills the whole row, I's lanes their own 4
    cells; every other cell stays NaN), read from the shift on; in storage
    mode each level below K rounded before the copied cells are restored;
    a bfloat16 output's updated cells rounded, its copied ones kept."""
    p = params()
    (_, dout, _), = ([key for key, f in sk.PRECISION_FORMS.items()
                        if f == form] if form is not None
                       else [(None, torch.float32, True)])
    ring_bf16 = form in (0, 1, 2)
    rnd_levels = form == 0
    a0, cx, cy = (f32(c) for c in coeffs_f32(*coeffs))
    m, n = u.shape
    uni = n % 4 == 0 if uni is None else uni
    W = warps or p.i_warps
    R = rows or p.i_rows
    S = stages or p.i_stages
    P, TX = p.i_pad(k), p.i_tile_x(k)
    seg_rows = seg_rows or p.i_launch((m, n), k, W)[1]
    n_bands = -(-n // TX)
    col_blocks = -(-n_bands // W)
    out = np.full((m, n), np.nan, dtype=f32)
    writes = np.zeros((m, n), dtype=np.int64)
    rmax = np.uint32(0)
    seen = {"interior": 0, "first": 0, "last": 0, "partial": 0,
            "unaligned": 0, "idle": 0, "free_rows": 0, "edge_rows": 0}
    lane = np.arange(LANES)
    for seg in range(-(-m // seg_rows)):
        # The blocks of this segment, their warps side by side.
        bands = np.array([cb * W + w for cb in range(col_blocks)
                          for w in range(W)])
        if seg == 0:
            seen["idle"] += int((bands >= n_bands).sum())
        bands = bands[bands < n_bands]
        B = len(bands)
        gx0 = bands * TX - P
        gx = gx0[:, None, None] + 4 * lane[None, :, None] + np.arange(4)
        r0, r1 = seg * seg_rows, min(seg * seg_rows + seg_rows, m)
        t0 = r0 - k
        n_iter = (r1 - r0) + 2 * k
        n_stages = -(-n_iter // R)
        cin = (gx >= 1) & (gx <= n - 2)
        out_lane = (4 * lane >= P) & (4 * lane < P + TX)
        sout = out_lane[None, :, None] & (gx < n)
        edge_band = (gx0 < 1) | (gx0 + 128 > n - 1)
        i_a = min(max(k + 1 - t0, 0), n_iter)
        i_b = min(max(m - t0, i_a), n_iter)
        seen["free_rows"] += int(i_b > i_a)
        seen["edge_rows"] += int(i_a > 0 or i_b < n_iter)
        if seg == 0:
            seen["interior"] += int((~edge_band).sum())
            seen["first"] += int((gx0 < 1).sum())
            seen["last"] += int((gx0 + 128 > n - 1).sum())
            seen["partial"] += int(
                (np.minimum(bands * TX + TX, n) - bands * TX < TX).sum())
        ring = np.full((B, S, R, LANES, 4), np.nan, dtype=f32)
        filled = [None] * S          # the stage each slot holds
        unaligned = np.zeros(B, dtype=bool)
        if ring_bf16:
            # Rows of 136 cells from gx0 - shift (shift = gx0 mod 8).
            shift = gx0 % 8
            cells = (shift[:, None, None] + 4 * lane[None, :, None]
                     + np.arange(4))
            wide = np.full((B, S, R, 136), np.nan, dtype=f32)
            col = (gx0 - shift)[:, None] + np.arange(136)

        def fill_bf16(q, slot):
            filled[slot] = q
            for r in range(R):
                t = t0 + q * R + r
                row = np.zeros((B, 136), dtype=f32)
                if 0 <= t < m:
                    ok = (col >= 0) & (col < n)
                    row[ok] = u[t, col[ok]]
                    g = gx[:, :, 0]
                    whole = (g >= 0) & (g + 4 <= n) & ((t * n + g) % 4 == 0)
                    unaligned[:] |= ((g >= 0) & (g + 4 <= n)
                                     & ~whole).any(axis=1)
                if uni:
                    wide[:, slot, r] = row
                else:
                    # Each lane its own 4 cells (the 8-byte copy, or 2-byte
                    # loads and zeros: the same values); the rest of the
                    # row is never written.
                    wide[:, slot, r] = np.nan
                    for b in range(B):
                        wide[b, slot, r, cells[b].ravel()] = row[
                            b, cells[b].ravel()]
            ring[:, slot] = np.take_along_axis(
                wide[:, slot].reshape(B, R, 136),
                np.broadcast_to(cells.reshape(B, 1, LANES * 4),
                                (B, R, LANES * 4)), axis=2).reshape(
                B, R, LANES, 4)

        def fill(q, slot):
            if ring_bf16:
                return fill_bf16(q, slot)
            filled[slot] = q
            for r in range(R):
                t = t0 + q * R + r
                vals = np.zeros((B, LANES, 4), dtype=f32)
                inside = (gx >= 0) & (gx < n)
                if 0 <= t < m:
                    vals[inside] = u[t, gx[inside]]
                    if not uni:
                        # A lane's copy: 16 bytes where its cells lie
                        # inside on a 16-byte boundary, else 4 a cell.
                        g = gx[:, :, 0]
                        whole = (g >= 0) & (g + 4 <= n) & ((t * n + g) % 4
                                                           == 0)
                        unaligned[:] |= ((g >= 0) & (g + 4 <= n)
                                         & ~whole).any(axis=1)
                ring[:, slot, r] = vals

        def step(up, c, dn, q_row, free, rnd=False):
            # The cells left and right of each lane's group: the
            # neighbouring lanes' by shuffle, NaN past lanes 0 and 31.
            lf = np.full((B, LANES), np.nan, dtype=f32)
            rt = np.full((B, LANES), np.nan, dtype=f32)
            lf[:, 1:] = c[:, :-1, 3]
            rt[:, :-1] = c[:, 1:, 0]
            left = np.concatenate([lf[..., None], c[..., :3]], axis=-1)
            right = np.concatenate([c[..., 1:], rt[..., None]], axis=-1)
            v = _combine(c, up, dn, left, right, a0, cx, cy)
            if rnd:
                v = _bf16(v)
            checked = np.where((1 <= q_row <= m - 2) & cin, v, c)
            return np.where(free[:, None, None], v, checked)

        def emit(v, c, q_row, free):
            nonlocal rmax
            if not r0 <= q_row < r1:
                return
            fold = sout & (free[:, None, None]
                           | ((1 <= q_row <= m - 2) & cin))
            if fold.any():
                bits = np.abs(v - c)[fold].view(np.uint32)
                rmax = max(rmax, bits.max())
            if dout == torch.bfloat16:
                # Updated cells rounded; copied ones are bfloat16 already.
                v = _bf16(v)
            out[q_row, gx[sout]] = v[sout]
            np.add.at(writes[q_row], gx[sout], 1)

        # Levels 1 .. k-1 in registers (index s for level s); level 0 in
        # the ring, read at the rows i - 2 .. i, the window all row 0 at
        # first.
        U = np.full((k, B, LANES, 4), np.nan, dtype=f32)
        M, D = U.copy(), U.copy()
        q = slot = j = 0
        rd = p1 = p2 = 0               # ring rows, slot * R + row
        for s in range(min(S, n_stages)):
            fill(s, s)
        for i in range(n_iter):
            t = t0 + i
            if j == 0:
                assert filled[slot] == q, "read before its stage landed"
            up0, c0, dn0 = (ring[:, w // R, w % R].copy()
                            for w in (p2, p1, rd))
            if j == 1 and q > 0 and q - 1 + S < n_stages:
                fill(q - 1 + S, (slot - 1) % S)
            p2, p1 = p1, rd
            rd += 1
            j += 1
            if j == R:
                j = 0
                q += 1
                slot += 1
                if slot == S:
                    slot = 0
                    rd = 0
            free = ~edge_band & (i_a <= i < i_b)
            for s in range(1, k + 1):
                up, c, dn = ((up0, c0, dn0) if s == 1
                             else (U[s - 1], M[s - 1], D[s - 1]))
                v = step(up, c, dn, t - s, free, rnd_levels and s < k)
                if s == k:
                    emit(v, c, t - k, free)
                if s > 1:
                    U[s - 1] = M[s - 1]
                    M[s - 1] = D[s - 1]
                if s < k:
                    D[s] = v
        if seg == 0:
            seen["unaligned"] += int(unaligned.sum())
    return out, rmax.view(f32), writes, seen


def _plain(u, k, coeffs=(CX, CY)):
    out = torch.empty(u.shape, dtype=torch.float32)
    res = sk.tile_temporal_steps_plain(torch.from_numpy(u), out, k, True,
                                       cx=coeffs[0], cy=coeffs[1])
    return out.numpy(), f32(float(res))


def _same_float(a, b):
    return (np.isnan(a) and np.isnan(b)) or a == b


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10).astype(f32)


@pytest.mark.parametrize("coeffs", COEFFS, ids=str)
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_band_stream_emulation_is_the_plain_version(shape, k, coeffs):
    u = _rand(shape, seed=k)
    got, res, writes, _ = _emulate(u, k, coeffs=coeffs)
    want, wres = _plain(u, k, coeffs)
    np.testing.assert_array_equal(writes, 1)
    assert np.array_equal(got, want), np.nanmax(np.abs(got - want))
    assert _same_float(res, wres), (res, wres)


def _plain_form(u, k, form, coeffs=(CX, CY)):
    (din, dout, acc), = [key for key, f in sk.PRECISION_FORMS.items()
                         if f == form]
    out = torch.empty(u.shape, dtype=dout)
    res = sk.tile_temporal_steps_plain(torch.from_numpy(u).to(din), out, k,
                                       True, cx=coeffs[0], cy=coeffs[1],
                                       acc_f32=acc)
    return out.float().numpy(), f32(float(res))


@pytest.mark.parametrize("form", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [2, 4, 5, 8])
@pytest.mark.parametrize("shape", SHAPES + [(37, 250)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_band_stream_emulation_of_the_bf16_forms_is_the_plain_version(
        shape, k, form):
    # heat_i_loop.cuh's precision forms: the bfloat16 ring (rows of 136
    # cells from 16 bytes of the grid's row, I-uni's box shifted 4 cells
    # left at K <= 4), the levels rounded in storage mode, the output
    # rounded where it is bfloat16; I and, where its rows are 16-byte
    # multiples, I-uni. A width of 4k + 2 takes I's 8-byte copy on every
    # other row.
    u = _bf16(_rand(shape, seed=60 + k))
    want, wres = _plain_form(u, k, form)
    for uni in (False, shape[1] % (4 if form == 3 else 8) == 0):
        got, res, writes, _ = _emulate(u, k, form=form, uni=uni)
        np.testing.assert_array_equal(writes, 1)
        assert np.array_equal(got, want), (uni, np.nanmax(np.abs(got - want)))
        assert _same_float(res, wres), (uni, res, wres)


# Launches the defaults do not take: several bands a block and idle
# warps, rings that wrap many laps (2 stages of 3 or 4 rows), stages of
# more rows than a segment streams, short segments.
LAUNCHES = [dict(seg_rows=7, warps=2, rows=3, stages=2),
            dict(seg_rows=5, warps=3, rows=4, stages=2),
            dict(seg_rows=64, warps=1, rows=32, stages=8),
            dict(seg_rows=11, warps=8, rows=5, stages=3)]


@pytest.mark.parametrize("shape", [(60, 257), (41, 248)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k", [1, 4, 5, 8])
@pytest.mark.parametrize("launch", LAUNCHES, ids=str)
def test_band_stream_under_other_launches(launch, k, shape):
    u = _rand(shape, seed=30 + k)
    got, res, writes, _ = _emulate(u, k, **launch)
    want, wres = _plain(u, k)
    np.testing.assert_array_equal(writes, 1)
    assert np.array_equal(got, want), (shape, launch)
    assert _same_float(res, wres), (shape, res, wres)


def test_band_stream_reaches_the_nan():
    u = _rand((90, 257), seed=7)
    u[44, 130] = np.nan
    got, res, _, _ = _emulate(u, 8, seg_rows=30)
    want, wres = _plain(u, 8)
    assert np.isnan(res) and np.isnan(wres)
    assert np.array_equal(got, want, equal_nan=True)
    for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got[sl], u[sl])


@pytest.mark.parametrize("k", range(1, 9))
def test_band_kinds_are_the_emulated_ones_and_all_present(k):
    # The listed shapes together run every band and segment kind at every
    # K: interior, first, last and partial bands, I's 16-byte copy refused
    # on a row (unaligned), idle warps, segments with rows stepped
    # test-free and segments reaching the grid's first or last row.
    p = params()
    total = {}
    for shape in SHAPES + [(1000, 1000)]:
        u = np.zeros(shape, dtype=f32)
        kinds = p.i_band_kinds(shape, k)
        if shape[0] * shape[1] <= 256 * 256:
            _, _, _, seen = _emulate(u, k, uni=False)
            assert {key: kinds[key] for key in seen} == seen, shape
        for key, count in kinds.items():
            total[key] = total.get(key, 0) + count
    assert all(total[key] for key in ("interior", "first", "last",
                                      "partial", "unaligned", "idle",
                                      "free_rows", "edge_rows")), total


@pytest.mark.parametrize("shape", [(16384, 16384), (4096, 4096),
                                   (1000, 1000), (20, 20), (3, 8)])
@pytest.mark.parametrize("k", [1, 4, 5, 8])
def test_i_launch_is_waves_of_whole_bands(shape, k):
    p = params()
    tile_x, seg = p.i_launch(shape, k)
    assert tile_x == 128 - 2 * p.i_pad(k) and tile_x % 4 == 0
    assert p.i_pad(k) % 4 == 0 and p.i_pad(k) >= k
    bands = -(-shape[1] // tile_x)
    blocks = -(-bands // p.i_warps) * -(-shape[0] // seg)
    assert seg >= p.i_seg_rows_min
    # At most i_waves waves where segments of the minimum height would
    # make more.
    wave = p.sm_count * p.i_blocks_per_sm
    if -(-shape[0] // p.i_seg_rows_min) * -(-bands // p.i_warps) \
            > wave * p.i_waves:
        assert wave * (p.i_waves - 1) < blocks <= wave * p.i_waves
    smem = p.i_smem_bytes(p.i_warps, p.i_rows, p.i_stages)
    assert smem == 4 * p.i_warps * p.i_stages * p.i_rows * 128 + 128 \
        + 8 * p.i_warps * p.i_stages
    assert p.i_blocks_per_sm * (smem + p.smem_reserved_per_block
                                + p.static_smem_bytes) <= p.smem_per_sm


@pytest.mark.parametrize("bad", [dict(k=9), dict(k=0), dict(warps=9),
                                 dict(rows=2), dict(rows=33),
                                 dict(stages=1), dict(stages=9)], ids=str)
def test_launch_i_refuses_what_the_launcher_refuses(bad):
    # Refused before the library is loaded (no nvcc here: a load would
    # raise BuildError, not ValueError).
    u = torch.zeros((16, 16))
    kw = dict(k=3, warps=None, rows=None, stages=None)
    kw.update(bad)
    p = params()
    assert not p.i_takes(kw["k"], kw["warps"] or p.i_warps,
                         kw["rows"] or p.i_rows, kw["stages"] or p.i_stages)
    with pytest.raises(ValueError, match="does not take"):
        sk._launch_i(u, torch.empty_like(u), kw["k"], None, CX, CY, 8,
                     warps=kw["warps"], rows=kw["rows"],
                     stages=kw["stages"])


def test_defaults_are_a_launch_the_launcher_takes():
    p = params()
    assert p.i_takes(p.i_k_default, p.i_warps, p.i_rows, p.i_stages)
    assert p.i_k_default == p.i_k_max == 8


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("k", [2, 8])
def test_band_stream_emulation_matches_heat_i_tile_temporal(k, uniform):
    shape = (64, 256)
    u = _rand(shape, seed=11)
    build = (ps._build_tile_temporal_2d_uniform if uniform
             else ps._build_tile_temporal_2d)
    want, wres = build(shape, "float32", CX, CY, k)(jnp.asarray(u))
    got, res, _, _ = _emulate(u, k, uni=uniform)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(res), float(wres), rtol=1e-4)
