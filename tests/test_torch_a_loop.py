"""Kernels A and M on the register-blocked tile loop, emulated in numpy;
their pickers on that loop's launch shapes.

The CUDA kernels ``heat_a_resident`` and ``heat_m_ensemble``
(csrc/heat_a_resident.cu, csrc/heat_m_ensemble.cu, their step phase
``heat_a_steps`` in csrc/heat_a.cuh) run only on the card. This file
replays their schedule on the CPU, one thread block at a time: the tile
and its d-deep frame in two shared buffers of the loop's padded rows
(``hopper_params.row_floats``), steps in groups of at most d on the
shrinking frame, each step over the whole 4-column groups that cover its
region (a cell left or right of a row read across the row's end, as the
loop's end lanes do), the copy branch where a framed tile reaches past
the interior, the edge band written to one of two exchange planes and
the frame read back after every block has written (the grid barrier),
the last step's store of the tile's cells alone with the residual, and
kernel M's groups of blocks walking the members in rounds with their
planes alternating over the whole launch. Every shared and plane cell
that the kernels' loads and writes leave alone is NaN, so a value from
outside a group's cone that reached an output would show. Each case is
held bitwise, grid and residual, to the port's plain versions, whose
arithmetic the kernels repeat operation for operation (every operation
rounded to float32 in both).
"""

import numpy as np
import pytest
import torch

from parallel_heat_tpu_torch.ops import batched
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

f32 = np.float32
CX, CY = 0.1, 0.2


def _step(src, dst, rows, g0, g1, pad, edge, lo_hi, coeffs):
    """One step of the tile loop over ``rows`` and the groups [g0, g1):
    the new values of those cells (also written to ``dst`` unless None)
    and the old ones."""
    a0, cx, cy = coeffs
    sx = src.shape[1]
    flat = src.reshape(-1)
    f = np.arange(4 * g0, 4 * g1)
    r = np.asarray(rows)[:, None]
    at = r * sx + f[None, :]
    # The cells beyond a row's ends are garbage to the loop (never in a
    # valid region), so NaN here.
    left = np.where(f == 0, np.nan, flat[np.maximum(at - 1, 0)])
    right = np.where(f == sx - 1, np.nan, flat[np.minimum(at + 1,
                                                          flat.size - 1)])
    cc = src[r, f]
    with np.errstate(all="ignore"):
        new = ((a0 * cc) + (cx * (src[r - 1, f] + src[r + 1, f]))) \
            + (cy * (left + right))
    if edge:
        r_lo, r_hi, c_lo, c_hi = lo_hi
        c = f[None, :] - pad
        inside = (r >= r_lo) & (r <= r_hi) & (c >= c_lo) & (c <= c_hi)
        new = np.where(inside, new, cc).astype(f32)
    if dst is not None:
        dst[r, f] = new
    return new, cc


class _Block:
    """One block of an A (or M) launch on an m x n grid: its tile, frame
    and two NaN-filled buffers."""

    def __init__(self, m, n, i0, j0, tile, d):
        p = params()
        ty, tx = tile
        self.m, self.n, self.d = m, n, d
        self.i0, self.j0 = i0, j0
        self.h, self.w = min(ty, m - i0), min(tx, n - j0)
        self.pad = (4 - d % 4) % 4
        self.sx = p.row_floats(d, tx)
        self.sh, self.sw = self.h + 2 * d, self.w + 2 * d
        self.gy0, self.gx0 = i0 - d, j0 - d
        self.src = np.full((ty + 2 * d, self.sx), np.nan, dtype=f32)
        self.dst = np.full_like(self.src, np.nan)

        def clamp(v, lo, hi):
            return max(lo, min(hi, v))

        self.lo_hi = (clamp(1 - self.gy0, 0, self.sh),
                      clamp(m - 2 - self.gy0, -1, self.sh - 1),
                      clamp(1 - self.gx0, 0, self.sw),
                      clamp(n - 2 - self.gx0, -1, self.sw - 1))
        r_lo, r_hi, c_lo, c_hi = self.lo_hi
        self.edge = (r_lo > 0 or r_hi < self.sh - 1 or c_lo > 0
                     or c_hi < self.sw - 1)

    def load(self, u):
        for r in range(self.sh):
            for c in range(self.sw):
                gi, gj = self.gy0 + r, self.gx0 + c
                inside = 0 <= gi < self.m and 0 <= gj < self.n
                self.src[r, self.pad + c] = u[gi, gj] if inside else 0.0

    def steps(self, j, last, out, coeffs):
        """A group of j steps; the last one stores (with ``last``).
        Returns the residual's bits of the stored cells."""
        d, pad = self.d, self.pad
        for s in range(1, j + 1):
            e = d - (j - s)
            if last and s == j:
                new, cc = _step(self.src, None, range(d, d + self.h),
                                (pad + d) // 4, (pad + d + self.w + 3) // 4,
                                pad, self.edge, self.lo_hi, coeffs)
                c = np.arange(4 * ((pad + d) // 4), new.shape[1]
                              + 4 * ((pad + d) // 4)) - pad
                keep = (c >= d) & (c < d + self.w)
                gi = self.gy0 + np.arange(d, d + self.h)
                out[np.ix_(gi, self.gx0 + c[keep])] = new[:, keep]
                r_lo, r_hi, c_lo, c_hi = self.lo_hi
                rr = np.arange(d, d + self.h)[:, None]
                inside = ((rr >= r_lo) & (rr <= r_hi) & (c[keep] >= c_lo)
                          & (c[keep] <= c_hi))
                with np.errstate(all="ignore"):
                    diff = np.abs(new[:, keep] - cc[:, keep]).astype(f32)
                bits = diff.view(np.uint32)[inside]
                return int(bits.max()) if bits.size else 0
            _step(self.src, self.dst, range(e, self.sh - e), (pad + e) // 4,
                  (pad + self.sw - e + 3) // 4, pad, self.edge, self.lo_hi,
                  coeffs)
            self.src, self.dst = self.dst, self.src
        return 0

    def band_out(self, plane):
        d, h, w = self.d, self.h, self.w
        for r in range(h):
            for c in range(w):
                if r < d or r >= h - d or c < d or c >= w - d:
                    plane[self.i0 + r, self.j0 + c] = \
                        self.src[d + r, self.pad + d + c]

    def frame_in(self, plane):
        d = self.d
        for r in range(self.sh):
            for c in range(self.sw):
                if d <= r < d + self.h and d <= c < d + self.w:
                    continue
                gi, gj = self.gy0 + r, self.gx0 + c
                if 0 <= gi < self.m and 0 <= gj < self.n:
                    self.src[r, self.pad + c] = plane[gi, gj]


def _emulate(u, k, tile, d, coeffs, planes=None, exchanges=0,
             exchange=True):
    """One grid (a launch of A, or a member of a launch of M) through the
    kernels' schedule: ``(out, residual, exchanges after)``. ``planes``
    (two planes of u's shape, NaN by default) and ``exchanges`` carry
    kernel M's planes from member to member; without ``exchange`` (M's
    one block a member) nothing passes between groups."""
    m, n = u.shape
    ty, tx = tile
    if planes is None:
        planes = np.full((2, m, n), np.nan, dtype=f32)
    blocks = [_Block(m, n, i0, j0, tile, d)
              for i0 in range(0, m, ty) for j0 in range(0, n, tx)]
    for b in blocks:
        b.load(u)
    out = np.full((m, n), np.nan, dtype=f32)
    rmax, done = 0, 0
    while True:
        j = min(d, k - done)
        last = done + j == k
        for b in blocks:
            rmax = max(rmax, b.steps(j, last, out, coeffs))
        done += j
        if last:
            break
        if not exchange:
            continue
        plane = planes[exchanges & 1]
        exchanges += 1
        for b in blocks:          # every block writes its band ...
            b.band_out(plane)
        for b in blocks:          # ... before any reads its frame
            b.frame_in(plane)
    return out, np.array([rmax], dtype=np.uint32).view(f32)[0], exchanges


def _plain(u, k):
    want = torch.empty(u.shape, dtype=torch.float32)
    res = sk.resident_steps_plain(torch.from_numpy(u), want, k, True, cx=CX,
                                  cy=CY)
    return want.numpy(), float(res)


def _grid(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 10
            ).astype(f32)


# (grid, tile, depth): ragged last row and column tiles, tiles at most 2d
# tall or wide (their bands written whole), widths not a multiple of 4,
# every pad of the rows (d = 1 .. 4), one tile, and one column of tiles as
# wide as the grid (a_takes' other rule).
CASES = [
    ((45, 50), (12, 16), 4),
    ((37, 29), (8, 12), 3),
    ((30, 41), (9, 20), 2),
    ((23, 26), (7, 8), 1),
    ((20, 24), (20, 24), 4),
    ((19, 13), (6, 13), 4),
]


@pytest.mark.parametrize("k", [1, 4, 6, 9])
@pytest.mark.parametrize("shape,tile,d", CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_a_schedule_emulation_is_the_plain_version(shape, tile, d, k):
    p = params()
    assert p.a_takes(shape, tile, p.a_block)
    u = _grid(shape, sum(shape) + k)
    got, res, _ = _emulate(u, k, tile, d, coeffs_f32(CX, CY))
    want, rp = _plain(u, k)
    np.testing.assert_array_equal(got, want)
    assert float(res) == rp


@pytest.mark.parametrize("shape", [(20, 24), (45, 50), (61, 37), (96, 130),
                                   (300, 7)])
def test_a_schedule_emulation_at_the_picked_tile(shape):
    p = params()
    tile = p.a_tile(shape)
    u = _grid(shape, shape[0])
    got, res, _ = _emulate(u, 11, tile, p.a_depth, coeffs_f32(CX, CY))
    want, rp = _plain(u, 11)
    np.testing.assert_array_equal(got, want)
    assert float(res) == rp


def test_a_schedule_emulation_reaches_the_nan():
    u = _grid((45, 50), 3)
    u[20, 30] = np.nan
    got, res, _ = _emulate(u, 9, (12, 16), 4, coeffs_f32(CX, CY))
    assert np.isnan(res)
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got[sl], u[sl])


def _emulate_m(u, k, plan):
    """A launch of M under ``plan``: each group of blocks walks the
    members g, g + G, ... with its two planes alternating over the whole
    launch; an inactive group only counts the exchanges."""
    batch = u.shape[0]
    groups, d = plan["groups"], plan["depth"]
    out = np.empty_like(u)
    res = np.empty(batch, dtype=f32)
    per_member = (k - 1) // d if plan["tiles"] > 1 else 0
    for g in range(groups):
        planes = np.full((2,) + u.shape[1:], np.nan, dtype=f32)
        exchanges = 0
        for b in range(g, batch, groups):
            out[b], res[b], after = _emulate(u[b], k, plan["tile"], d,
                                             coeffs_f32(CX, CY), planes,
                                             exchanges, plan["tiles"] > 1)
            assert after - exchanges == per_member
            exchanges = after
    return out, res


@pytest.mark.parametrize("k", [1, 6, 9])
@pytest.mark.parametrize("shape,plan", [
    # five members on two groups of nine tiles: three rounds, the last
    # with an inactive group; tiles ragged both ways
    ((26, 30), {"tile": (9, 12), "depth": 4, "tiles": 9, "groups": 2}),
    ((26, 30), {"tile": (13, 8), "depth": 3, "tiles": 8, "groups": 3}),
    # one block a member: a one-cell frame, one step a group
    ((20, 21), {"tile": (20, 21), "depth": 1, "tiles": 1, "groups": 5}),
], ids=["coop-d4", "coop-d3", "solo"])
def test_m_schedule_emulation_is_the_plain_version_and_a(shape, plan, k):
    p = params()
    assert p.a_takes(shape, plan["tile"], p.a_block)
    u = np.stack([_grid(shape, 10 * b + k) for b in range(5)])
    got, res = _emulate_m(u, k, plan)
    want = torch.empty(u.shape, dtype=torch.float32)
    rp = batched.ensemble_steps_plain(torch.from_numpy(u), want, k, True,
                                      cx=CX, cy=CY)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(res, rp.numpy())
    for b in (0, 4):
        one, r1, _ = _emulate(u[b], k, p.a_tile(shape), p.a_depth,
                              coeffs_f32(CX, CY))
        np.testing.assert_array_equal(one, got[b])
        assert float(r1) == float(res[b])


# --- the pickers on the loop's launch shapes ------------------------------

A_GRIDS = [(3, 3), (20, 24), (107, 210), (1000, 1000), (1001, 999),
           (1800, 1800), (1859, 1859), (5, 4099), (318384, 3)]


@pytest.mark.parametrize("shape", A_GRIDS)
def test_a_tile_is_a_launch_shape_of_the_loop(shape):
    p = params()
    ty, tx = p.a_tile(shape)
    assert p.a_takes(shape, (ty, tx), p.a_block)
    assert p.loop_takes((ty, -(-tx // 4) * 4), p.a_block)
    assert tx % 4 == 0 or tx == shape[1]
    assert (p.a_smem_bytes((ty, tx)) + p.static_smem_bytes
            <= p.smem_per_block_max)


@pytest.mark.parametrize("batch,shape", [(64, (512, 512)), (8, (20, 20)),
                                         (8, (256, 256)), (3, (107, 210)),
                                         (64, (24, 20)), (3, (1000, 1000)),
                                         (8, (166, 166)), (8, (167, 167))])
def test_m_plan_is_a_launch_shape_of_the_loop(batch, shape):
    p = params()
    plan = p.m_plan(batch, shape)
    assert p.a_takes(shape, plan["tile"], plan["block"])
    assert (plan["tiles"] == 1) == (shape[0] <= 166)
    assert (p.m_smem_bytes(plan["tile"], plan["depth"]) + p.static_smem_bytes
            <= p.smem_per_block_max)
    ty, tx = plan["tile"]
    assert -(-shape[0] // ty) * -(-shape[1] // tx) == plan["tiles"]
    assert plan["groups"] * plan["tiles"] <= p.sm_count


# The grids chip_smoke.py checks A on: between them they run every branch
# of the step phase and the exchange.
A_CHECK_GRIDS = [(1000, 1000), (1001, 999), (20, 24), (107, 210), (4099, 7),
                 (1859, 1859)]


def test_a_tile_kinds_are_all_present_on_the_check_grids():
    p = params()
    kinds = {}
    for shape in A_CHECK_GRIDS:
        for kind, count in p.a_tile_kinds(shape).items():
            kinds[kind] = kinds.get(kind, 0) + count
    assert all(kinds.values()), kinds
    one = p.a_tile_kinds((20, 24))
    assert one["tiles"] == 1 and one["copies"] == 1


def _a_tile_before(shape, depth=4):
    """Whether the column walk's picker (the parent design: any tile
    width, rows of tile_x + 2D floats, thread blocks of 32 x 32) found a
    tile for ``shape``: its rule, kept here to hold the domain."""
    p = params()
    m, n = shape
    d, bx, by = depth, 32, 32
    budget = p.smem_per_block_max - p.static_smem_bytes
    if m * n * 8 > p.sm_count * budget:
        return False
    widths = {n} | {w for q in range(1, n // bx + 2)
                    for w in (q * bx, q * bx - 2 * (d - 1)) if 0 < w < n}
    for tx in widths:
        rows_max = p.sm_count // -(-n // tx)
        if rows_max == 0:
            continue
        lo = -(-m // rows_max)
        for ty in {lo, -(-lo // by) * by,
                   -(-(lo + 2 * (d - 1)) // by) * by - 2 * (d - 1)}:
            ty = min(ty, m)
            if ty >= lo and 2 * (ty + 2 * d) * (tx + 2 * d) * 4 <= budget:
                return True
    return False


def test_a_domain_holds_but_for_narrow_widths_padded_to_4():
    # Every grid the column walk's picker took, the loop's takes, except
    # a narrow grid whose width is not a multiple of 4 near the shared
    # memory's end: it now fits as the grid of its width rounded up to 4
    # fitted before. Sampled around the boundary.
    p = params()
    shapes = [(s, s) for s in range(1830, 1870)]
    shapes += [(m, n) for m in (3, 7, 100, 1000, 5000)
               for n in (3, 4, 5, 9, 33, 99, 100, 1001)]
    shapes += [(n, m) for m, n in shapes]
    shapes += [(m, 1800 * 1800 // m) for m in range(1000, 3400, 97)]
    shapes += [(m, n) for n in (3, 5, 7, 21, 101)
               for m in range(10000, 360001, 35000)]
    for m, n in shapes:
        if _a_tile_before((m, n)) and p.a_tile((m, n)) is None:
            assert n % 4 and not _a_tile_before((m, -(-n // 4) * 4)), (m, n)


@pytest.mark.parametrize("shape,takes", [
    ((318384, 3), True), ((318385, 3), False),     # was 347424 rows
    ((33132, 101), True), ((33133, 101), False),   # was 34056 rows
    ((1859, 1859), True), ((1860, 1860), False),   # was 1848^2
    ((1845, 1845), True)])
def test_a_domain_boundary_on_both_sides(shape, takes):
    p = params()
    assert (p.a_tile(shape) is not None) is takes
    kind = sk.pick_single_2d(shape)[0]
    assert kind == ("A" if takes else ("E-uni" if shape[1] % 4 == 0
                                       else "E"))
