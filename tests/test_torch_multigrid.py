"""The port's multigrid level operations against the JAX package.

Everything runs on the CPU: the transfer wrappers take their plain
versions there, and the JAX transfer kernels (``_build_restrict_kernel``,
``_build_prolong_kernel``) run in Pallas interpret mode.

Tolerances:

- restriction and prolongation: **bitwise** against both the JAX kernels
  and the jnp spellings. Every multiply is by a power of two (exact, so
  an FMA contraction in XLA:CPU cannot change a bit) and the additions
  associate as in the JAX spelling, ``(a + 2b) + c``;
- smoother, residual and operator: ``rtol=1e-5`` with an ``atol`` of 1e-5
  of the data's scale. XLA:CPU contracts the single multiply of each
  axis term into an FMA where eager PyTorch rounds it first;
- within the port, the ``cuda`` and ``torch`` transfer spellings, and a
  member of a stack against the member alone: bitwise;
- the transfer kernels' thread mappings (``csrc/heat_mg_restrict.cu``,
  ``csrc/heat_mg_prolong.cu``) emulated in numpy, float32 operation for
  float32 operation, into NaN-filled outputs: bitwise the plain versions,
  every output cell written by exactly one thread.

The launch records are built here without a card, on fake CUDA tensors
(``FakeTensorMode``) with the launch itself stubbed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu.ops import multigrid as jmg
from parallel_heat_tpu_torch import HeatConfig
from parallel_heat_tpu_torch.config import multigrid_level_shapes
from parallel_heat_tpu_torch.ops import multigrid as mg
from parallel_heat_tpu_torch.ops import stencil_kernels as sk

# Fine full shapes: even and odd interiors on each axis, and the
# smallest hierarchy step (a 3 x 2 interior onto 1 x 1).
FINE = [(34, 34), (35, 33), (66, 41), (5, 4), (20, 19)]
# Every pair of neighbouring levels of a 512^2 implicit run (the main
# path's: 512 -> 257 -> ... -> 5).
PATH = multigrid_level_shapes((512, 512))
PATH_PAIRS = list(zip(PATH[:-1], PATH[1:]))
# The kernels' launch shapes the emulation runs: (block, cells) for
# restrict (every compiled cells choice), block for prolong.
RESTRICT_GEOMETRIES = [((32, 8), (1, 1)), ((32, 8), (1, 2)),
                       ((64, 4), (2, 2)), ((128, 2), (1, 2))]
PROLONG_BLOCKS = [(32, 8), (64, 4), (128, 2)]


def _rand(shape, seed, ring=True):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 10).astype(np.float32)
    if not ring:
        a[..., 0, :] = a[..., -1, :] = 0
        a[..., :, 0] = a[..., :, -1] = 0
    return a


def _coarse(fine):
    return ((fine[0] - 2) // 2 + 2, (fine[1] - 2) // 2 + 2)


def _ring_is_zero(a):
    return not (a[..., 0, :].any() or a[..., -1, :].any()
                or a[..., :, 0].any() or a[..., :, -1].any())


def test_level_shapes_are_the_jax_packages():
    from parallel_heat_tpu.config import multigrid_level_shapes as jshapes

    for shape in [(66, 66), (20, 20), (513, 300), (5, 5), (34, 35)]:
        for levels in (None, 1, 3):
            assert (multigrid_level_shapes(shape, levels)
                    == jshapes(shape, levels))


@pytest.mark.parametrize("fine", FINE)
def test_restrict_is_bitwise_the_jax_kernel_and_jnp(fine):
    r = _rand(fine, seed=1)
    cs = _coarse(fine)
    got = mg.restrict(torch.from_numpy(r), cs).numpy()
    assert got.shape == cs and _ring_is_zero(got)
    kernel = np.asarray(jmg._build_restrict_kernel(fine, cs)(r))
    plain = np.asarray(jmg.restrict_full_weighting(r, cs))
    assert np.array_equal(got, kernel)
    assert np.array_equal(got, plain)
    assert np.array_equal(
        got, mg.restrict_full_weighting(torch.from_numpy(r), cs).numpy())


@pytest.mark.parametrize("fine", FINE)
def test_prolong_is_bitwise_the_jax_kernel_and_jnp(fine):
    cs = _coarse(fine)
    c = _rand(cs, seed=2, ring=False)
    got = mg.prolong(torch.from_numpy(c), fine).numpy()
    assert got.shape == fine and _ring_is_zero(got)
    kernel = np.asarray(jmg._build_prolong_kernel(cs, fine)(c))
    plain = np.asarray(jmg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2)))
    assert np.array_equal(got, kernel)
    assert np.array_equal(got, plain)


def test_transfers_of_a_constant_and_of_a_stack():
    # Full weighting of a constant interior is the constant away from the
    # ring; bilinear prolongation of it likewise.
    r = torch.zeros((18, 18))
    r[1:-1, 1:-1] = 3.0
    c = mg.restrict(r, (10, 10))
    assert torch.equal(c[2:-2, 2:-2], torch.full((6, 6), 3.0))
    f = mg.prolong(c, (18, 18))
    assert torch.equal(f[4:-4, 4:-4], torch.full((10, 10), 3.0))
    # A stack of members is each member alone.
    stack = torch.from_numpy(_rand((3, 35, 33), seed=3))
    cs = _coarse((35, 33))
    got = mg.restrict(stack, cs)
    back = mg.prolong(got, (35, 33))
    assert got.shape == (3,) + cs and back.shape == (3, 35, 33)
    for b in range(3):
        assert torch.equal(got[b], mg.restrict(stack[b], cs))
        assert torch.equal(back[b], mg.prolong(got[b], (35, 33)))


@pytest.mark.parametrize("case", ["dtype", "tiny", "coarse_too_large",
                                  "fine_not_double"])
def test_transfers_reject_bad_inputs(case):
    if case == "dtype":
        with pytest.raises(TypeError):
            mg.restrict(torch.zeros((10, 10), dtype=torch.float64), (6, 6))
    elif case == "tiny":
        with pytest.raises(ValueError):
            mg.restrict(torch.zeros((10, 10)), (2, 6))
    elif case == "coarse_too_large":
        with pytest.raises(ValueError, match="more than half"):
            mg.restrict(torch.zeros((10, 10)), (7, 6))
    else:
        with pytest.raises(ValueError, match="not twice"):
            mg.prolong(torch.zeros((6, 6)), (12, 10))


def test_transfer_ops_picks_by_backend_and_counts():
    r = torch.from_numpy(_rand((34, 34), seed=4))
    sk.reset_counts()
    out = {}
    for backend in ("cuda", "torch"):
        restrict, prolong = mg.transfer_ops(backend)
        c = restrict(r, (18, 18))
        out[backend] = (c, prolong(c, (34, 34)))
    # On the CPU both spellings end in the plain versions, and no kernel
    # launches.
    assert torch.equal(out["cuda"][0], out["torch"][0])
    assert torch.equal(out["cuda"][1], out["torch"][1])
    assert sk.counts["restrict_full_weighting"] == 2
    assert sk.counts["prolong_bilinear"] == 2
    assert sk.counts["heat_mg_restrict"] == sk.counts["heat_mg_prolong"] == 0


@pytest.mark.parametrize("shape", [(34, 34), (21, 40)])
@pytest.mark.parametrize("ax,ay", [(22.5, 22.5), (1.4, 5.6)])
def test_level_operations_match_jax(shape, ax, ay):
    u, b = _rand(shape, seed=5), _rand(shape, seed=6)
    tu, tb = torch.from_numpy(u), torch.from_numpy(b)
    scale = 10.0 * (1 + 4 * (ax + ay))
    tol = dict(rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(mg.apply_A_interior(tu, ax, ay).numpy(),
                               np.asarray(jmg.apply_A_interior(u, ax, ay)),
                               **tol)
    np.testing.assert_allclose(
        mg.residual_interior(tu, tb, ax, ay).numpy(),
        np.asarray(jmg.residual_interior(u, b, ax, ay)), **tol)
    np.testing.assert_allclose(float(mg.residual_norm(tu, tb, ax, ay)),
                               float(jmg.residual_norm(u, b, ax, ay)),
                               rtol=1e-5)
    got = mg.smooth(tu, tb, ax, ay).numpy()
    want = jmg.smooth(jnp.asarray(u), jnp.asarray(b), ax, ay)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    # The ring is carried over, bit for bit.
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert np.array_equal(got[sl], u[sl])


def test_hierarchy_matches_jax():
    kw = dict(nx=66, ny=50, cx=22.5, cy=11.0, scheme="crank_nicolson",
              mg_levels=3)
    got = mg.level_coefficients(HeatConfig(device="cpu", **kw))
    want = jmg.level_coefficients(jx.HeatConfig(**kw))
    assert got == want
    assert mg.scheme_theta("crank_nicolson") == 0.5
    assert mg.scheme_theta("backward_euler") == 1.0
    assert (mg._OMEGA, mg._COARSE_SWEEPS) == (jmg._OMEGA, jmg._COARSE_SWEEPS)


# ---------------------------------------------------------------------------
# The transfer kernels' thread mappings, emulated
# ---------------------------------------------------------------------------

def _f32(x):
    return np.float32(x)


def _emulate_restrict(r, coarse, block, cells):
    """``heat_mg_restrict_kernel<cells>`` over the launch's grid, in numpy:
    each thread's clamped fine window, row pass, column pass and ring
    select, vectorised over the threads. Returns the output (NaN where no
    thread wrote) and the writes per cell."""
    _, _, grid = mg.transfer_geometry(mg.RESTRICT, coarse, (block, cells))
    b_, (mf2, nf2) = r.shape[0], r.shape[-2:]
    mc2, nc2 = coarse
    cy, cx = cells
    i0 = np.arange(grid[1] * block[1]) * cy
    j0 = np.arange(grid[0] * block[0]) * cx
    i0, j0 = np.meshgrid(i0[i0 < mc2], j0[j0 < nc2], indexing="ij")
    col = [np.clip(2 * j0 - 1 + b, 0, nf2 - 1) for b in range(2 * cx + 1)]
    w = [[r[:, np.clip(2 * i0 - 1 + a, 0, mf2 - 1), col[b]]
          for b in range(2 * cx + 1)] for a in range(2 * cy + 1)]

    def c121(a, b, c):
        return _f32(0.25) * ((a + _f32(2.0) * b) + c)

    out = np.full((b_, mc2, nc2), np.nan, np.float32)
    writes = np.zeros((mc2, nc2), np.int64)
    for y in range(cy):
        i = i0 + y
        rows = [c121(w[2 * y][b], w[2 * y + 1][b], w[2 * y + 2][b])
                for b in range(2 * cx + 1)]
        for x in range(cx):
            j = j0 + x
            v = c121(rows[2 * x], rows[2 * x + 1], rows[2 * x + 2])
            ring = (i == 0) | (i == mc2 - 1) | (j == 0) | (j == nc2 - 1)
            v = np.where(ring, _f32(0.0), v)
            ok = (i < mc2) & (j < nc2)
            out[:, i[ok], j[ok]] = v[:, ok]
            np.add.at(writes, (i[ok], j[ok]), 1)
    return out, writes


def _emulate_prolong(c, fine, block):
    """``heat_mg_prolong_kernel`` over the launch's grid, in numpy: a
    thread a coarse cell (t, s), its four clamped loads and the 2 x 2
    fine block it writes, ring selected to 0, clipped to the fine array.
    Returns the output (NaN where no thread wrote) and the writes per
    cell."""
    _, _, grid = mg.transfer_geometry(mg.PROLONG, fine, (block, (1, 1)))
    b_, (mc2, nc2) = c.shape[0], c.shape[-2:]
    mf2, nf2 = fine
    t = np.arange(grid[1] * block[1])
    s = np.arange(grid[0] * block[0])
    t, s = np.meshgrid(t[2 * t < mf2], s[2 * s < nf2], indexing="ij")
    t1, s1 = np.minimum(t + 1, mc2 - 1), np.minimum(s + 1, nc2 - 1)
    a, b = c[:, t, s], c[:, t, s1]
    d, e = c[:, t1, s], c[:, t1, s1]

    def half(x, y):
        return _f32(0.5) * (x + y)

    ad = half(a, d)
    r0, c0 = 2 * t, 2 * s
    ring_r = [(r0 == 0) | (r0 == mf2 - 1), r0 + 1 == mf2 - 1]
    ring_c = [(c0 == 0) | (c0 == nf2 - 1), c0 + 1 == nf2 - 1]
    vals = [[a, half(a, b)], [ad, half(ad, half(b, e))]]
    out = np.full((b_, mf2, nf2), np.nan, np.float32)
    writes = np.zeros((mf2, nf2), np.int64)
    for dy in range(2):
        for dx in range(2):
            v = np.where(ring_r[dy] | ring_c[dx], _f32(0.0), vals[dy][dx])
            i, j = r0 + dy, c0 + dx
            ok = (i < mf2) & (j < nf2)
            out[:, i[ok], j[ok]] = v[:, ok]
            np.add.at(writes, (i[ok], j[ok]), 1)
    return out, writes


TRANSFER_PAIRS = PATH_PAIRS + [(f, _coarse(f)) for f in FINE]


@pytest.mark.parametrize("lead", [(1,), (3,)])
@pytest.mark.parametrize("fine,coarse", TRANSFER_PAIRS)
def test_restrict_threads_emulated_are_bitwise_the_plain_version(fine,
                                                                 coarse,
                                                                 lead):
    r = _rand(lead + tuple(fine), seed=fine[0])
    want = mg.restrict_full_weighting(torch.from_numpy(r), coarse).numpy()
    for block, cells in RESTRICT_GEOMETRIES:
        got, writes = _emulate_restrict(r, coarse, block, cells)
        assert (writes == 1).all(), (block, cells)
        assert np.array_equal(got, want), (block, cells)


@pytest.mark.parametrize("lead", [(1,), (3,)])
@pytest.mark.parametrize("fine,coarse", TRANSFER_PAIRS)
def test_prolong_threads_emulated_are_bitwise_the_plain_version(fine,
                                                                coarse,
                                                                lead):
    # A coarse ring of random values, not zeros: the kernel reads it as
    # the plain version does.
    c = _rand(lead + tuple(coarse), seed=fine[1])
    want = mg.prolong_bilinear(torch.from_numpy(c),
                               (fine[0] - 2, fine[1] - 2)).numpy()
    for block in PROLONG_BLOCKS:
        got, writes = _emulate_prolong(c, fine, block)
        assert (writes == 1).all(), block
        assert np.array_equal(got, want), block


@pytest.mark.parametrize("fine,coarse", PATH_PAIRS)
def test_restrict_on_the_512_hierarchy_is_bitwise_the_jax_kernel(fine,
                                                                 coarse):
    stack = _rand((3,) + fine, seed=7)
    got = mg.restrict(torch.from_numpy(stack), coarse).numpy()
    assert got.shape == (3,) + coarse and _ring_is_zero(got)
    assert np.array_equal(
        got[1], np.asarray(jmg._build_restrict_kernel(fine, coarse)(
            stack[1])))
    for b in range(3):
        assert np.array_equal(
            got[b], np.asarray(jmg.restrict_full_weighting(stack[b],
                                                           coarse)))


@pytest.mark.parametrize("fine,coarse", PATH_PAIRS)
def test_prolong_on_the_512_hierarchy_is_bitwise_the_jax_kernel(fine,
                                                                coarse):
    stack = _rand((3,) + coarse, seed=8, ring=False)
    got = mg.prolong(torch.from_numpy(stack), fine).numpy()
    assert got.shape == (3,) + fine and _ring_is_zero(got)
    interior = (fine[0] - 2, fine[1] - 2)
    assert np.array_equal(
        got[1], np.asarray(jmg._build_prolong_kernel(coarse, fine)(
            stack[1])))
    for b in range(3):
        assert np.array_equal(
            got[b], np.asarray(jmg.prolong_bilinear(stack[b], interior)))


# ---------------------------------------------------------------------------
# The launch records, without a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fine,coarse", TRANSFER_PAIRS + [((21, 23),
                                                           (11, 12))])
def test_launch_record_geometry_is_the_launchers(fine, coarse):
    p = mg.params()
    for name, src, dst in ((mg.RESTRICT, fine, coarse),
                           (mg.PROLONG, coarse, fine)):
        rec = mg.TransferLaunch(name, (3,), src, dst, "cuda:0")
        cells = (p.mg_restrict_cells(coarse) if name == mg.RESTRICT
                 else (1, 1))
        block = (p.mg_restrict_block if name == mg.RESTRICT
                 else p.mg_prolong_block)
        assert (rec.block, rec.cells) == (tuple(block), tuple(cells))
        assert rec.out_shape == (3,) + tuple(dst)
        # The grid covers the output once over: restrict's threads a few
        # coarse cells each, prolong's a coarse cell, 2 x 2 fine cells.
        span = (2, 2) if name == mg.PROLONG else cells
        gx, gy = rec.grid
        assert gx * block[0] * span[1] >= dst[1] > (gx - 1) * block[0] * span[1]
        assert gy * block[1] * span[0] >= dst[0] > (gy - 1) * block[1] * span[0]
        a = rec._args
        assert (a.batch, a.src_rows, a.src_cols, a.dst_rows, a.dst_cols,
                a.block_x, a.block_y, a.cells_y, a.cells_x) == (
            3, *src, *dst, *block, *cells)


def test_restrict_takes_more_cells_a_thread_only_on_large_levels():
    p = mg.params()
    wave = p.sm_count * 2048
    assert p.mg_restrict_cells((257, 257)) == (1, 1)
    assert p.mg_restrict_cells((1, wave - 1)) == (1, 1)
    assert p.mg_restrict_cells((1, wave)) == (2, 2)
    assert p.mg_restrict_cells((1025, 1025)) == (2, 2)
    rec = mg.TransferLaunch(mg.RESTRICT, (), (4098, 4098), (2050, 2050),
                            "cuda:0")
    assert rec.cells == (2, 2)
    assert rec.grid == (-(-1025 // p.mg_restrict_block[0]),
                        -(-1025 // p.mg_restrict_block[1]))
    # The hierarchy of a 512^2 run takes 1 x 1 at every level.
    assert {mg.TransferLaunch(mg.RESTRICT, (), f, c, "cuda:0").cells
            for f, c in PATH_PAIRS} == {(1, 1)}


def test_launch_record_refuses_what_the_launchers_refuse():
    with pytest.raises(ValueError, match="cells a thread"):
        mg.TransferLaunch(mg.PROLONG, (), (5, 5), (9, 9), "cuda:0",
                          ((32, 8), (1, 2)))
    with pytest.raises(ValueError, match="cells a thread"):
        mg.TransferLaunch(mg.RESTRICT, (), (9, 9), (5, 5), "cuda:0",
                          ((32, 8), (2, 1)))
    with pytest.raises(ValueError, match="limits"):
        mg.TransferLaunch(mg.RESTRICT, (), (9, 9), (5, 5), "cuda:0",
                          ((64, 32), (1, 1)))
    with pytest.raises(ValueError, match="limits"):
        mg.TransferLaunch(mg.PROLONG, (65536,), (5, 5), (9, 9), "cuda:0")


@pytest.fixture
def fake_card(monkeypatch):
    """Fake CUDA tensors on cuda:0, the current device, with every launch
    stubbed to record (kernel, source shape, output shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    launched = []

    def launch(self, src, dst):
        launched.append((self.name, tuple(src.shape), tuple(dst.shape)))

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(mg.TransferLaunch, "launch", launch)
    monkeypatch.setattr(mg, "_records", {})
    with FakeTensorMode():
        yield launched


def test_launch_records_are_built_once_per_shapes(fake_card):
    # The V-cycle's transfers of a 512^2 run, in its order: restrict down
    # the hierarchy, prolong back up. (The level operations' arithmetic
    # does not run on fake CUDA tensors of this CPU build.)
    sk.reset_counts()
    for n in (1, 2, 3):
        for fine, coarse in PATH_PAIRS:
            got = mg.restrict(torch.empty(fine, device="cuda"), coarse)
            assert tuple(got.shape) == coarse and got.device.type == "cuda"
        for fine, coarse in reversed(PATH_PAIRS):
            got = mg.prolong(torch.empty(coarse, device="cuda"), fine)
            assert tuple(got.shape) == fine
        # Each cycle launches each kernel once a level pair; the records
        # are built in the first.
        assert sk.counts[mg.RESTRICT] == sk.counts[mg.PROLONG] == 7 * n
        assert len(mg._records) == 14
    assert fake_card[:2] == [(mg.RESTRICT, (512, 512), (257, 257)),
                             (mg.RESTRICT, (257, 257), (129, 129))]
    assert (mg.PROLONG, (5, 5), (9, 9)) in fake_card
    assert sk.counts["restrict_full_weighting"] == 0
    # A stack of three members is a shape of its own.
    stack = torch.zeros((3, 512, 512), device="cuda")
    rec = mg.transfer_record(mg.RESTRICT, stack, (257, 257))
    assert rec is mg.transfer_record(mg.RESTRICT, stack, [257, 257])
    assert rec.out_shape == (3, 257, 257) and rec._args.batch == 3
    assert len(mg._records) == 15


def test_launch_records_keep_the_wrappers_checks(fake_card, monkeypatch):
    r = torch.zeros((34, 34), device="cuda")
    assert mg.restrict(r, (18, 18)).shape == (18, 18)
    # A cached shape on another current device, then bad inputs: each
    # raises as before, and none is cached.
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(ValueError, match="current device"):
        mg.restrict(r, (18, 18))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    n = len(mg._records)
    with pytest.raises(TypeError):
        mg.restrict(r.double(), (18, 18))
    with pytest.raises(ValueError, match="more than half"):
        mg.restrict(r, (19, 18))
    with pytest.raises(ValueError, match="not twice"):
        mg.prolong(torch.zeros((6, 6), device="cuda"), (12, 10))
    assert len(mg._records) == n
    # A CPU tensor takes the plain version and builds no record.
    assert mg.transfer_record(mg.RESTRICT, torch.zeros((34, 34),
                                                       device="cpu"),
                              (18, 18)) is None
    assert len(mg._records) == n
