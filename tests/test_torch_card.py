"""The CUDA kernels of the PyTorch port on the card.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda``
marker and skips elsewhere. The file imports nothing of JAX, so it runs
on a machine that has only PyTorch, without the repository's conftest
(which sets JAX up)::

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

Tolerance: none. On the card each kernel is bitwise equal to its plain
PyTorch version (both round every float32 operation in the same order),
A(K), E(K), E-uni(K), I(K) and I-uni(K) bitwise equal to K launches of
B, C bitwise equal to B, and in 3D F(K) bitwise equal to K launches of
D. Every kernel is also run with unequal coefficients, so a swap of two
axes cannot pass. Each member of a launch of M is bitwise a launch of A
on that member alone; restriction and prolongation are bitwise their
plain versions, so an implicit run under ``backend="cuda"`` is bitwise
the one under ``backend="torch"``. Each sharded block kernel (G-uni,
G-fuse, G-circ, G, the band fix) is bitwise its plain version, the
others, and kernel E's K steps on the same cells of the global grid; so
is each 3D one (H-fused, H, the deferred bulk with the band fix, the
band's one launch over every block under each of its loads) against
kernel F's; a sharded ``solve()``, 2D or 3D, is bitwise the one-block
run on the card and the plain versions' run on the CPU.

D's and F's bfloat16 forms are bitwise their plain versions at every K
and load, NaN-seeded grids included (faces bit for bit), F(K) bitwise K
launches of D's; a 3D bfloat16 ``solve()`` under either is bitwise the
CPU's, and 3D bfloat16 and float64 ensembles (the vmap route) are
bitwise their members' solo torch-route runs.

The bfloat16 forms of A, E and E-uni (storage, and E's and E-uni's
``acc_f32`` in one launch or a chunk of 16 across a float32 level) are
bitwise their plain versions, which round at the same points, on random
grids at every depth each form takes, on widths that are no multiple of 8 (E) and on
NaN-seeded grids, whose ring keeps its bits, NaN payloads included; E
and E-uni bitwise each other; a bfloat16 ``solve()`` bitwise the CPU's.
So are the bfloat16 forms of B, C and M, and the chains hold at
bfloat16: C is B, A(K) and E's and E-uni's storage form (K) are K
launches of B, a member of M is A on that member alone. bfloat16 and
float64 ensembles and implicit runs are bitwise their solo runs and the
CPU's, and an implicit run under ``backend="cuda"`` is the one under
``backend="torch"`` at every dtype.

The bfloat16 forms of G-uni, G-fuse, G-circ, G and the band are bitwise
their plain versions, each other and E's bfloat16 K steps on the same
cells, NaN-seeded blocks included, the band under each load; a sharded
bfloat16 ``solve()`` is bitwise the one-block run and the CPU's, and a
sharded float64 run (the torch rounds, 2D and 3D) the one-block run. In
3D the bfloat16 forms of H-fused, H and the 3D band likewise, against K
launches of D's bfloat16 form, and a sharded 3D bfloat16 ``solve()``
under each kind.
"""

import functools
import math

import numpy as np
import pytest
import torch

from parallel_heat_tpu_torch import (EnsembleConfig, EnsembleSolver,
                                     HeatConfig, solve, tune)
from parallel_heat_tpu_torch.kernels import build
from parallel_heat_tpu_torch.ops import batched
from parallel_heat_tpu_torch.ops import multigrid as mg
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
from parallel_heat_tpu_torch.ops.hopper_params import params

pytestmark = pytest.mark.cuda
CX = CY = 0.1
COEFFS = [(0.1, 0.1), (0.1, 0.2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    try:
        build.nvcc()
    except build.BuildError as e:
        pytest.skip(f"needs nvcc to build the kernels: {e}")
    return torch.device("cuda", 0)


def _rand(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)


def _b_launches(u, k, cx, cy):
    src, dst = u.clone(), torch.empty_like(u)
    for _ in range(k):
        rb = sk.strip_step(src, dst, cx=cx, cy=cy)
        src, dst = dst, src
    return src, rb


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", [(1001, 999), (3, 3), (5, 4099)])
def test_b_bitwise_equal_to_plain(card, shape, cx, cy):
    u = _rand(shape, 0, card)
    got, want = torch.empty_like(u), torch.empty_like(u)
    r = sk.strip_step(u, got, cx=cx, cy=cy)
    rp = sk.strip_step_plain(u, want, cx=cx, cy=cy)
    assert torch.equal(got, want) and torch.equal(r, rp)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("shape", [(1001, 999), (3, 3), (5, 4099),
                                   (300, 4096)])
def test_c_bitwise_equal_to_b_and_plain(card, shape, cx, cy):
    u = _rand(shape, 4, card)
    got, want, b = (torch.empty_like(u) for _ in range(3))
    r = sk.tiled_step(u, got, cx=cx, cy=cy)
    rp = sk.tiled_step_plain(u, want, cx=cx, cy=cy)
    rb = sk.strip_step(u, b, cx=cx, cy=cy)
    assert torch.equal(got, want) and torch.equal(r, rp)
    assert torch.equal(got, b) and torch.equal(r, rb)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [1, 2, 3, 5, None])
@pytest.mark.parametrize("shape", [(1001, 1000), (70, 300), (300, 4096),
                                   (20, 24)])
def test_e_uni_bitwise_equal_to_e_and_plain(card, shape, k, cx, cy):
    k = k or params().e_k_default
    u = _rand(shape, 5, card)
    got, e, want = (torch.empty_like(u) for _ in range(3))
    r = sk.temporal_steps_uni(u, got, k, cx=cx, cy=cy)
    re_ = sk.temporal_steps(u, e, k, cx=cx, cy=cy)
    rp = sk.temporal_steps_uni_plain(u, want, k, cx=cx, cy=cy)
    src, rb = _b_launches(u, k, cx, cy)
    assert torch.equal(got, e) and torch.equal(r, re_)
    assert torch.equal(got, src) and torch.equal(r, rb)
    assert torch.equal(got, want) and torch.equal(r, rp)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [1, 2, 5, None])
@pytest.mark.parametrize("shape", [(1001, 999), (70, 300), (21, 23)])
def test_e_bitwise_equal_to_k_b_launches_and_plain(card, shape, k, cx, cy):
    k = k or params().e_k_default
    u = _rand(shape, 1, card)
    got = torch.empty_like(u)
    r = sk.temporal_steps(u, got, k, cx=cx, cy=cy)
    src, rb = _b_launches(u, k, cx, cy)
    want = torch.empty_like(u)
    rp = sk.temporal_steps_plain(u, want, k, cx=cx, cy=cy)
    assert torch.equal(got, src) and torch.equal(r, rb)
    assert torch.equal(got, want) and torch.equal(r, rp)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [1, 2, 7, 20])
@pytest.mark.parametrize("shape", [(1001, 999), (70, 300), (20, 20),
                                   (1800, 1800), (107, 210), (5, 4099)])
def test_a_bitwise_equal_to_k_b_launches_and_plain(card, shape, k, cx, cy):
    u = _rand(shape, 3, card)
    got = torch.empty_like(u)
    r = sk.resident_steps(u, got, k, cx=cx, cy=cy)
    src, rb = _b_launches(u, k, cx, cy)
    want = torch.empty_like(u)
    rp = sk.resident_steps_plain(u, want, k, cx=cx, cy=cy)
    assert torch.equal(got, src) and torch.equal(r, rb)
    assert torch.equal(got, want) and torch.equal(r, rp)
    nores = torch.empty_like(u)
    assert sk.resident_steps(u, nores, k, False, cx=cx, cy=cy) is None
    assert torch.equal(got, nores)


def test_probe_full_is_a_and_every_variant_launches(card):
    from parallel_heat_tpu_torch.tools import kernel_probe as kp

    u = _rand((1000, 1000), 4, card)
    want, got = torch.empty_like(u), torch.empty_like(u)
    ra = sk.resident_steps(u, want, 20, cx=0.1, cy=0.2)
    r = kp.probe_steps("full", u, got, 20, cx=0.1, cy=0.2)
    assert torch.equal(got, want) and torch.equal(r, ra)
    for variant in kp.VARIANTS[1:]:
        out = torch.empty_like(u)
        res = kp.probe_steps(variant, u, out, 20, cx=0.1, cy=0.2)
        torch.cuda.synchronize()
        assert res is not None and out.shape == u.shape


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("shape", [(1001, 1000), (70, 300), (300, 4096),
                                   (3, 8), (517, 1028), (37, 257), (40, 50),
                                   (3, 300), (200, 132)])
def test_i_bitwise_equal_to_e_and_plain(card, shape, k, cx, cy, uniform):
    u = _rand(shape, 6, card)
    got, e, want = (torch.empty_like(u) for _ in range(3))
    if uniform:
        launch, plain = sk.tile_temporal_steps_uni, \
            sk.tile_temporal_steps_uni_plain
    else:
        launch, plain = sk.tile_temporal_steps, sk.tile_temporal_steps_plain
    if uniform and shape[1] % 4:
        with pytest.raises(ValueError, match="multiple of 4"):
            launch(u, got, k, cx=cx, cy=cy)
        return
    r = launch(u, got, k, cx=cx, cy=cy)
    re_ = sk.temporal_steps(u, e, k, cx=cx, cy=cy)
    rp = plain(u, want, k, cx=cx, cy=cy)
    src, rb = _b_launches(u, k, cx, cy)
    assert torch.equal(got, src) and torch.equal(r, rb)
    assert torch.equal(got, e) and torch.equal(r, re_)
    assert torch.equal(got, want) and torch.equal(r, rp)


# Launches of I's stream that the defaults do not take: several bands a
# block and idle warps, rings that wrap many laps, stages of more rows
# than a segment streams, short segments; both level schedules.
I_LAUNCHES = [dict(seg_rows=7, warps=2, rows=3, stages=2),
              dict(seg_rows=5, warps=3, rows=4, stages=2),
              dict(seg_rows=64, warps=1, rows=32, stages=8),
              dict(seg_rows=11, warps=8, rows=5, stages=3)]


@pytest.mark.parametrize("name, shape",
                         [("heat_i_tile_temporal", (300, 257)),
                          ("heat_i_uni_tile_temporal", (300, 256))])
@pytest.mark.parametrize("k", [1, 4, 5, 8])
@pytest.mark.parametrize("launch", I_LAUNCHES, ids=str)
def test_i_launches_bitwise_equal_to_plain(card, launch, k, name, shape):
    u = _rand(shape, 9, card)
    want = torch.empty_like(u)
    rp = sk.tile_temporal_steps_plain(u, want, k, cx=0.1, cy=0.2)
    got = torch.full_like(u, float("nan"))
    bits = torch.zeros(1, dtype=torch.int32, device=card)
    sk._launch_i(u, got, k, bits, 0.1, 0.2, name=name, **launch)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (name, shape)
    assert torch.equal(sk._residual_view(bits), rp), (name, shape)


def test_nan_reaches_every_residual(card):
    u = _rand((300, 500), 2, card)
    u[100, 200] = float("nan")
    for launch in (lambda o: sk.strip_step(u, o, cx=CX, cy=CY),
                   lambda o: sk.tiled_step(u, o, cx=CX, cy=CY),
                   lambda o: sk.temporal_steps(u, o, 4, cx=CX, cy=CY),
                   lambda o: sk.temporal_steps_uni(u, o, 4, cx=CX, cy=CY),
                   lambda o: sk.tile_temporal_steps(u, o, 4, cx=CX, cy=CY),
                   lambda o: sk.tile_temporal_steps_uni(u, o, 4, cx=CX,
                                                        cy=CY),
                   lambda o: sk.resident_steps(u, o, 4, cx=CX, cy=CY)):
        out = torch.empty_like(u)
        assert math.isnan(float(launch(out)))
        assert torch.equal(out[0], u[0]) and torch.equal(out[:, -1], u[:, -1])


_COUNTER = {"A": "heat_a_resident", "E": "heat_e_temporal",
            "E-uni": "heat_e_uni_temporal", "I": "heat_i_tile_temporal",
            "I-uni": "heat_i_uni_tile_temporal", "B": "heat_b_step",
            "C": "heat_c_tiled"}


@pytest.mark.parametrize("cfg", [
    # Runs all 57 steps (eps below any residual), tail included.
    HeatConfig(nx=300, ny=200, steps=57, converge=True, eps=1e-9),
    # Converges at step 1980, leaving the loop through res < eps.
    HeatConfig(nx=20, ny=20, steps=10000, converge=True, eps=1e-3),
    HeatConfig(nx=64, ny=48, cx=0.1, cy=0.2, steps=100),
], ids=["tail", "converges", "unequal"])
def test_solve_on_the_card_matches_the_cpu_bitwise(card, cfg):
    cpu = solve(cfg.replace(backend="cuda"), device="cpu")
    if cfg.converge and cfg.eps == 1e-3:
        assert cpu.converged and cpu.steps_run == 1980
    for choice in _COUNTER:
        sk.reset_counts()
        with tune.force("single_2d", choice):
            res = solve(cfg)
        assert res.grid.device.type == "cuda"
        assert all(n == 0 for name, n in sk.counts.items()
                   if name.endswith("_plain"))
        assert sk.counts[_COUNTER[choice]] > 0
        assert (res.steps_run, res.converged) == (cpu.steps_run,
                                                 cpu.converged)
        assert res.residual == cpu.residual
        assert np.array_equal(res.to_numpy(), cpu.to_numpy())


COEFFS_3D = [(0.1, 0.1, 0.1), (0.1, 0.15, 0.05)]
SHAPES_3D = [(67, 130, 201), (5, 3, 300), (3, 3, 3), (40, 37, 70),
             (130, 9, 33)]


def _kw3(coeffs):
    return dict(zip(("cx", "cy", "cz"), coeffs))


def _d_launches(u, k, kw):
    src, dst = u.clone(), torch.empty_like(u)
    for _ in range(k):
        rd = sk3.slab_step_3d(src, dst, **kw)
        src, dst = dst, src
    return src, rd


@pytest.mark.parametrize("coeffs", COEFFS_3D)
@pytest.mark.parametrize("shape", SHAPES_3D)
def test_d_bitwise_equal_to_plain(card, shape, coeffs):
    u = _rand(shape, 7, card)
    got, want = torch.empty_like(u), torch.empty_like(u)
    r = sk3.slab_step_3d(u, got, **_kw3(coeffs))
    rp = sk3.slab_step_3d_plain(u, want, **_kw3(coeffs))
    assert torch.equal(got, want) and torch.equal(r, rp)


@pytest.mark.parametrize("coeffs", COEFFS_3D)
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, None])
@pytest.mark.parametrize("shape", SHAPES_3D + [(67, 130, 204), (9, 70, 252)])
def test_f_bitwise_equal_to_k_d_launches_and_plain(card, shape, k, coeffs):
    k = k or params().f_k_default
    kw = _kw3(coeffs)
    u = _rand(shape, 8, card)
    for load in ["cp.async"] + (["tma"] if shape[2] % 4 == 0 else []):
        got, want, nores = (torch.empty_like(u) for _ in range(3))
        r = sk3.xslab_steps_3d(u, got, k, load=load, **kw)
        src, rd = _d_launches(u, k, kw)
        rp = sk3.xslab_steps_3d_plain(u, want, k, **kw)
        assert torch.equal(got, src) and torch.equal(r, rd)
        assert torch.equal(got, want) and torch.equal(r, rp)
        assert sk3.xslab_steps_3d(u, nores, k, False, load=load,
                                  **kw) is None
        assert torch.equal(got, nores)


def test_nan_reaches_the_3d_residuals(card):
    u = _rand((60, 70, 90), 9, card)
    u[30, 30, 30] = float("nan")
    kw = dict(cx=0.1, cy=0.1, cz=0.1)
    for launch in (lambda o: sk3.slab_step_3d(u, o, **kw),
                   lambda o: sk3.xslab_steps_3d(u, o, 1, **kw),
                   lambda o: sk3.xslab_steps_3d(u, o, 4, **kw)):
        out = torch.empty_like(u)
        assert math.isnan(float(launch(out)))
        for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                   np.s_[:, :, 0], np.s_[:, :, -1]):
            assert torch.equal(out[sl], u[sl])


_COUNTER_3D = {"F": "heat_f_temporal3d", "D": "heat_d_step3d"}


@pytest.mark.parametrize("cfg", [
    # Runs all 57 steps (eps below any residual), tail included.
    HeatConfig(nx=30, ny=20, nz=40, steps=57, converge=True, eps=1e-9),
    # Converges at step 360, leaving the loop through res < eps.
    HeatConfig(nx=10, ny=10, nz=10, steps=5000, converge=True, eps=1e-3),
    HeatConfig(nx=40, ny=33, nz=71, cx=0.1, cy=0.15, cz=0.05, steps=50),
], ids=["tail", "converges", "unequal"])
def test_solve_3d_on_the_card_matches_the_cpu_bitwise(card, cfg):
    cpu = solve(cfg.replace(backend="cuda"), device="cpu")
    if cfg.converge and cfg.eps == 1e-3:
        assert cpu.converged and cpu.steps_run == 360
    for choice, kernel in _COUNTER_3D.items():
        sk.reset_counts()
        with tune.force("single_3d", choice):
            res = solve(cfg)
        assert res.grid.device.type == "cuda"
        assert sk.counts[kernel] > 0
        assert all(n == 0 for name, n in sk.counts.items() if name != kernel)
        assert (res.steps_run, res.converged) == (cpu.steps_run,
                                                 cpu.converged)
        assert res.residual == cpu.residual
        assert np.array_equal(res.to_numpy(), cpu.to_numpy())


# ---------------------------------------------------------------------------
# Kernel M and the ensemble engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [1, 4, 7, 20])
@pytest.mark.parametrize("batch,shape", [
    (1, (512, 512)), (3, (512, 512)), (64, (512, 512)), (3, (107, 210)),
    (3, (1000, 1000)), (64, (24, 20)), (13, (170, 170)), (200, (128, 128)),
    (5, (3, 3))])
def test_m_bitwise_equal_to_plain_and_to_a_per_member(card, batch, shape, k,
                                                      cx, cy):
    u = _rand((batch,) + shape, 10, card)
    got, want, nores = (torch.empty_like(u) for _ in range(3))
    r = batched.ensemble_steps(u, got, k, cx=cx, cy=cy)
    rp = batched.ensemble_steps_plain(u, want, k, cx=cx, cy=cy)
    assert torch.equal(got, want) and torch.equal(r, rp)
    assert batched.ensemble_steps(u, nores, k, False, cx=cx, cy=cy) is None
    assert torch.equal(got, nores)
    for b in {0, batch // 2, batch - 1}:
        one = torch.empty_like(u[b])
        ra = sk.resident_steps(u[b].contiguous(), one, k, cx=cx, cy=cy)
        assert torch.equal(one, got[b]) and torch.equal(ra, r[b])


def test_m_nan_reaches_only_its_members_residual(card):
    u = _rand((5, 512, 512), 11, card)
    clean = torch.empty_like(u)
    batched.ensemble_steps(u, clean, 7, cx=CX, cy=CY)
    u[2, 100, 100] = float("nan")
    out = torch.empty_like(u)
    r = batched.ensemble_steps(u, out, 7, cx=CX, cy=CY)
    assert torch.isnan(r).tolist() == [False, False, True, False, False]
    for b in (0, 1, 3, 4):
        assert torch.equal(out[b], clean[b])


@pytest.mark.parametrize("cfg,scales", [
    (HeatConfig(nx=20, ny=20, steps=3000, converge=True, eps=1e-3),
     (1, 0.5, 0.01, 2, 0.001, 1e-4, 3, 1e-5)),
    (HeatConfig(nx=200, ny=180, steps=53, converge=True, eps=1e-9),
     (1, 2, 3)),
    (HeatConfig(nx=300, ny=300, cx=0.1, cy=0.2, steps=90), (1, 2, 3, 4)),
], ids=["converges", "tail", "fixed"])
def test_ensemble_on_the_card_matches_solo_and_the_cpu_bitwise(card, cfg,
                                                               scales):
    base = solve(cfg.replace(steps=0, converge=False)).grid
    inits = torch.stack([base * s for s in scales])
    ens = EnsembleConfig(members=len(scales), window_rounds=3)
    sk.reset_counts()
    es = EnsembleSolver(cfg, ens)
    assert es.path == "M"
    got = es.solve(initials=inits)
    assert sk.counts["heat_m_ensemble"] > 0
    assert sk.counts["ensemble_steps_plain"] == 0
    cpu = EnsembleSolver(cfg.replace(backend="cuda"), ens,
                         device="cpu").solve(initials=inits.cpu())
    assert np.array_equal(got.to_numpy(), cpu.to_numpy())
    assert got.steps_run.tolist() == cpu.steps_run.tolist()
    assert got.compactions == cpu.compactions
    for i in range(len(scales)):
        solo = solve(cfg, initial=inits[i])
        assert torch.equal(got.grids[i], solo.grid)
        assert int(got.steps_run[i]) == solo.steps_run
        if cfg.converge:
            assert bool(got.converged[i]) == solo.converged
            assert float(got.residual[i]) == solo.residual


# ---------------------------------------------------------------------------
# The multigrid transfer kernels and implicit stepping
# ---------------------------------------------------------------------------

# Even and odd fine interiors on each axis, and every level of a 512^2
# implicit run but its coarsest (512 -> 257 -> ... -> 9 -> 5).
FINE = [(4098, 4098), (1001, 999), (34, 34), (5, 4), (4099, 4097),
        (514, 514), (35, 1030), (512, 512), (257, 257), (129, 129),
        (65, 65), (33, 33), (17, 17), (9, 9)]
# Every shape alone, and the smaller ones as a stack of three.
FINE_AND_LEAD = ([(fine, ()) for fine in FINE]
                 + [(fine, (3,)) for fine in FINE if fine[0] < 2000])


@pytest.mark.parametrize("fine,lead", FINE_AND_LEAD)
def test_restrict_and_prolong_bitwise_equal_to_plain(card, fine, lead):
    coarse = ((fine[0] - 2) // 2 + 2, (fine[1] - 2) // 2 + 2)
    r = _rand(lead + fine, 12, card)
    got = mg.restrict(r, coarse)
    want = mg.restrict_full_weighting(r, coarse)
    assert torch.equal(got, want)
    c = _rand(lead + coarse, 13, card)
    c[..., 0, :] = c[..., -1, :] = 0
    c[..., :, 0] = c[..., :, -1] = 0
    back = mg.prolong(c, fine)
    back_want = mg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2))
    assert torch.equal(back, back_want)
    for t in (got, back):
        assert not (t[..., 0, :].any() or t[..., -1, :].any()
                    or t[..., :, 0].any() or t[..., :, -1].any())
    # Every output cell written: a launch into a NaN-filled output.
    for name, src, want_ in ((mg.RESTRICT, r, want),
                             (mg.PROLONG, c, back_want)):
        dst = torch.full_like(want_, float("nan"))
        mg._launch_transfer(name, src, dst)
        assert torch.equal(dst, want_), name


@pytest.mark.parametrize("fine", [(512, 512), (35, 1030), (21, 23),
                                  (9, 9)])
def test_transfer_launch_shapes_write_every_cell(card, fine):
    """Every compiled restrict instance (1 x 1, 1 x 2, 2 x 2 coarse cells
    a thread) and prolong's both stores (8-byte pairs, and single floats
    into an output that is not 8-byte aligned), at thread blocks that
    leave ragged edges, into NaN-filled outputs of a stack of three."""
    coarse = ((fine[0] - 2) // 2 + 2, (fine[1] - 2) // 2 + 2)
    r = _rand((3,) + fine, 14, card)
    c = _rand((3,) + coarse, 15, card)      # the ring too: data like any
    want = mg.restrict_full_weighting(r, coarse)
    back_want = mg.prolong_bilinear(c, (fine[0] - 2, fine[1] - 2))
    for block in ((32, 8), (64, 4), (128, 2)):
        for cells in ((1, 1), (1, 2), (2, 2)):
            dst = torch.full_like(want, float("nan"))
            mg._launch_transfer(mg.RESTRICT, r, dst, (block, cells))
            assert torch.equal(dst, want), (block, cells)
        dst = torch.full_like(back_want, float("nan"))
        mg._launch_transfer(mg.PROLONG, c, dst, (block, (1, 1)))
        assert torch.equal(dst, back_want), block
        # 4 bytes past an aligned base: the single-float stores.
        flat = torch.full((back_want.numel() + 1,), float("nan"),
                          device=card)
        odd = flat[1:].view(back_want.shape)
        mg._launch_transfer(mg.PROLONG, c, odd, (block, (1, 1)))
        assert torch.equal(odd, back_want), block


@pytest.mark.parametrize("scheme", ["backward_euler", "crank_nicolson"])
def test_implicit_on_the_card_cuda_equals_torch_bitwise(card, scheme):
    cfg = HeatConfig(nx=130, ny=97, cx=22.5, cy=22.5, steps=4, scheme=scheme)
    sk.reset_counts()
    a = solve(cfg.replace(backend="cuda"))
    assert sk.counts["heat_mg_restrict"] > 0
    assert sk.counts["heat_mg_restrict"] == sk.counts["heat_mg_prolong"]
    assert sk.counts["restrict_full_weighting"] == 0
    b = solve(cfg.replace(backend="torch"))
    assert torch.equal(a.grid, b.grid)
    inits = torch.stack([a.grid, b.grid * 3, torch.zeros_like(a.grid)])
    ens = EnsembleSolver(cfg, 3).solve(initials=inits)
    for i in range(3):
        assert torch.equal(ens.grids[i], solve(cfg, initial=inits[i]).grid)


# ---------------------------------------------------------------------------
# The sharded block kernels (G family) and the sharded path
# ---------------------------------------------------------------------------

G_CASES = [((32, 48), (2, 2), 8), ((1000, 1000), (2, 4), 3),
           ((1001, 998), (7, 2), 1), ((48, 72), (3, 3), 8)]


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("grid,mesh_shape,k", G_CASES)
def test_g_kernels_bitwise_plain_each_other_and_e(card, grid, mesh_shape, k,
                                                  cx, cy):
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    g = _rand(grid, 13, card)
    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(g)
    bs = mesh.block_shape(grid)
    pieces = temporal.exchange_halos_fused_2d(mesh, us, k)
    exts = {"G-circ": temporal.exchange_halos_circular_2d(mesh, us, k),
            "G": temporal.exchange_halos_deep_2d(mesh, us, k)}
    e_out = torch.empty_like(g)
    sk.temporal_steps(g, e_out, k, cx=cx, cy=cy)
    plain = {"G-uni": skb.block_uniform_plain, "G-fuse": skb.block_fused_plain,
             "G-circ": skb.block_circular_plain, "G": skb.block_padded_plain}
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        kw = dict(origin=o, grid_shape=grid, cx=cx, cy=cy)
        want = e_out[o[0]:o[0] + bs[0], o[1]:o[1] + bs[1]]
        res = None
        for kind in skb.KERNEL_OF:
            if kind == "G-uni" and bs[1] % 4:
                continue
            args = (exts[kind][b],) if kind in exts else (us[b], *pieces[b])
            got, ref = torch.empty(bs, device=card), torch.empty(bs,
                                                                 device=card)
            r = skb.LAUNCH[kind](*args, got, k, **kw)
            rp = plain[kind](*args, ref, k, **kw)
            assert torch.equal(got, ref) and torch.equal(r, rp), kind
            assert torch.equal(got, want), kind
            res = r if res is None else res
            assert torch.equal(r, res), kind
            if kind in ("G-uni", "G-fuse") and bs[0] >= 2 * k:
                split = torch.full(bs, float("nan"), device=card)
                rb = skb.LAUNCH[kind](us[b], pieces[b][0], None, None, split,
                                      k, **kw)
                rf = skb.band_fix(us[b], *pieces[b], split, k, **kw)
                assert torch.equal(split, got)
                assert torch.equal(torch.maximum(rb, rf), r)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("grid,mesh_shape,k", G_CASES)
def test_band_blocks_bitwise_plain_and_per_block(card, grid, mesh_shape, k,
                                                 cx, cy):
    """Every block's bands in one launch: bitwise the batched plain
    version and one launch a block, grids and residual; the rows between
    the bands untouched."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(_rand(grid, 17, card))
    bs = mesh.block_shape(grid)
    tails, hns, hss = zip(*temporal.exchange_halos_fused_2d(mesh, us, k))
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    kw = dict(origins=origins, grid_shape=grid, cx=cx, cy=cy)
    got, plain, one = ([torch.full(bs, float("nan"), device=card)
                        for _ in us] for _ in range(3))
    sk.reset_counts()
    r = skb.band_fix_blocks(us, tails, hns, hss, got, k, **kw)
    assert sk.counts["heat_g_band_fix"] == 1
    rp = skb.band_fix_blocks_plain(us, tails, hns, hss, plain, k, **kw)
    rs = [skb.band_fix(us[b], tails[b], hns[b], hss[b], one[b], k,
                       origin=origins[b], grid_shape=grid, cx=cx, cy=cy)
          for b in range(mesh.size)]
    for a, b_, c in zip(got, plain, one):
        assert torch.equal(a.nan_to_num(7.0), b_.nan_to_num(7.0))
        assert torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
        assert a[k:bs[0] - k].isnan().all()
    assert torch.equal(r, rp) and torch.equal(r, torch.stack(rs).amax())
    # The per-cell load, pinned, gives the same bits as the load picked.
    cells = [torch.full(bs, float("nan"), device=card) for _ in us]
    rc = skb.BandLaunch(us, tails, hns, hss, cells, k, load="cells",
                        **kw)(True)
    for a, c in zip(got, cells):
        assert torch.equal(a.nan_to_num(7.0), c.nan_to_num(7.0))
    assert torch.equal(rc, r)


@pytest.mark.parametrize("cfg", [
    dict(nx=1000, ny=1000, steps=101, mesh_shape=(2, 4)),
    dict(nx=512, ny=512, steps=200, mesh_shape=(2, 2), halo_overlap="phase"),
    dict(nx=256, ny=256, steps=50, mesh_shape=(2, 2), halo_depth=1),
    dict(nx=20, ny=20, steps=10_000, converge=True, mesh_shape=(2, 2)),
    dict(nx=1000, ny=1000, steps=400, converge=True, check_interval=20,
         eps=1e-9, mesh_shape=(2, 4))])
def test_sharded_solve_on_the_card_matches_one_block_bitwise(card, cfg):
    sk.reset_counts()
    got = solve(HeatConfig(**cfg))
    assert sum(n for name, n in sk.counts.items()
               if name.startswith("heat_g_")) > 0
    assert not any(n for name, n in sk.counts.items()
                   if name.endswith("_plain"))
    one = solve(HeatConfig(**{**cfg, "mesh_shape": None,
                              "halo_overlap": None, "halo_depth": None}))
    cpu = solve(HeatConfig(**cfg, backend="cuda"), device="cpu")
    assert torch.equal(got.grid, one.grid)
    assert np.array_equal(got.to_numpy(), cpu.to_numpy())
    assert (got.steps_run, got.converged) == (one.steps_run, one.converged)
    if cfg.get("converge"):
        assert got.residual == one.residual == cpu.residual


# ---------------------------------------------------------------------------
# The sharded 3D block kernels (H family) and the sharded 3D path
# ---------------------------------------------------------------------------

# (40, 128, 128) holds tiles inside it (H-fused's TMA load) at every K;
# H's boxed tiles run on it, on (20, 128, 252) and on the z-free mesh.
H_CASES = [((2, 2, 2), (64, 64, 64), 3), ((3, 3, 3), (37, 45, 80), 8),
           ((2, 4, 1), (40, 33, 97), 1), ((1, 2, 2), (50, 30, 40), 5),
           ((2, 2, 2), (6, 50, 70), 3), ((2, 2, 2), (40, 128, 128), 3),
           ((2, 2, 2), (40, 128, 128), 1), ((3, 3, 3), (20, 128, 252), 8),
           ((2, 4, 1), (40, 128, 96), 5)]


@pytest.mark.parametrize("coeffs", [(0.1, 0.1, 0.1), (0.1, 0.15, 0.05)])
@pytest.mark.parametrize("mesh_shape,block,k", H_CASES)
def test_h_kernels_bitwise_plain_each_other_and_f(card, mesh_shape, block, k,
                                                  coeffs):
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    g = _rand(grid, 17, card)
    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(g)
    pieces = temporal3d.exchange_halos_fused_3d(mesh, us, k)
    circ = temporal3d.exchange_halos_circular_3d(mesh, us, k)
    xch = temporal3d.DeepExchange3D(mesh, block, k, card)
    xch.lead(us)
    xch.last(us)
    kw3 = dict(zip(("cx", "cy", "cz"), coeffs))
    f_out = torch.empty_like(g)
    sk3.xslab_steps_3d(g, f_out, k, **kw3)
    for b in range(mesh.size):
        o = mesh.origin(b, block)
        kw = dict(origin=o, grid_shape=grid, **kw3)
        want = f_out[tuple(slice(a, a + n) for a, n in zip(o, block))]
        ref = torch.empty(block, device=card)
        rp = skb3.h_block_fused_plain(us[b], *pieces[b], ref, k, **kw)
        # H-fused under each load the geometry takes (skb3.h_load).
        for load in dict.fromkeys(("cp.async",
                                   skb3.h_load(block, k, us[b]))):
            got = torch.empty(block, device=card)
            r = skb3.h_block_fused(us[b], *pieces[b], got, k, load=load,
                                   **kw)
            assert torch.equal(got, ref) and torch.equal(r, rp), load
            assert torch.equal(got, want), load
        # H on the contiguous circular block and on the padded one the
        # round assembles, under each load.
        padded = xch.new_circular()
        xch.assemble_circular(b, us[b], padded)
        hp = torch.empty(block, device=card)
        rhp = skb3.h_block_plain(circ[b], hp, k, **kw)
        for ext, load in ((circ[b], None), (padded, "cp.async"),
                          (padded, "tma")):
            h = torch.full(block, float("nan"), device=card)
            rh = skb3.h_block(ext, h, k, load=load, **kw)
            assert torch.equal(h, hp) and torch.equal(rh, rhp), load
            assert torch.equal(h, want) and torch.equal(rh, r), load
        if mesh_shape[0] > 1 and block[0] >= 2 * k:
            zt, yt, _, _ = pieces[b]
            split = torch.full(block, float("nan"), device=card)
            rb = skb3.h_block_fused(us[b], zt, yt, None, None, split, k,
                                    defer_x=True, **kw)
            rf = skb3.h_band_fix(us[b], *pieces[b], split, k, **kw)
            assert torch.equal(split, got)
            assert torch.equal(torch.maximum(rb, rf), r)


def test_h_cases_run_every_tile_kind(card):
    """The blocks of :data:`H_CASES`, which the test above runs under both
    loads, hold every kind of kernel H's tiles
    (``hopper_params.hc_tile_kinds``): boxed and wrapped, inside the
    global interior and at its edge, past each side of a block, ragged,
    and with a partial last group."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    seen = {}
    for mesh_shape, block, k in H_CASES:
        grid = tuple(m * b for m, b in zip(mesh_shape, block))
        mesh = HeatMesh(mesh_shape)
        halos = skb3.halos_of(block, grid, k)
        for b in range(mesh.size):
            for kind, n in params().hc_tile_kinds(
                    block, k, halos, mesh.origin(b, block), grid).items():
                seen[kind] = seen.get(kind, 0) + n
    assert seen and all(seen.values()), seen


# The 3D band's one launch over every block of a mesh: the main path's
# 512^3 blocks of 1024^3 on (2, 2, 2) (the 16-byte load), ragged blocks
# (bz % 4 != 0: a lane straddles the block and its z tail), blocks that
# span the grid along z or along y and z, and blocks of exactly 16 planes
# (2K at K = 8).
H_BAND_BLOCKS = [((2, 2, 2), (512, 512, 512)), ((3, 3, 3), (37, 45, 90)),
                 ((2, 4, 1), (40, 33, 97)), ((2, 1, 1), (20, 70, 132)),
                 ((2, 2, 2), (16, 128, 252))]


@pytest.mark.parametrize("mesh_shape,block", H_BAND_BLOCKS,
                         ids=lambda v: "x".join(map(str, v)))
def test_h_band_launch_bitwise_plain_at_every_k(card, mesh_shape, block):
    """The round's band launch over every block, at every compiled K from
    the deepest down (a fault that only deep K shows comes first), under
    each load the blocks take (``BAND_LOADS_3D``), into NaN-filled
    outputs: bitwise the batched plain version, its residual the same, one
    launch counted, nothing written between the bands, and the band
    planes kernel F's K steps of the global grid."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    p = params()
    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    g = _rand(grid, 23, card)
    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(g)
    origins = [mesh.origin(b, block) for b in range(mesh.size)]
    kw = dict(origins=origins, grid_shape=grid, cx=0.1, cy=0.15, cz=0.05)
    ran = set()
    for k in range(p.h_band_k_max(), 0, -1):
        if block[0] < 2 * k:
            continue
        xch = temporal3d.DeepExchange3D(mesh, block, k, card)
        xch.lead(us)
        xch.last(us)
        pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
        want = [torch.full(block, float("nan"), device=card) for _ in us]
        rp = skb3.band_fix_blocks_3d_plain(us, *pieces, want, k, **kw)
        f_out = torch.empty_like(g)
        sk3.xslab_steps_3d(g, f_out, k, cx=0.1, cy=0.15, cz=0.05)
        loads = {"cells", skb3.BandLaunch3D(
            us, *pieces, want, k, **kw).load}
        for load in sorted(loads):
            got = [torch.full(block, float("nan"), device=card) for _ in us]
            sk.reset_counts()
            r = skb3.BandLaunch3D(us, *pieces, got, k, load=load, **kw)()
            assert sk.counts["heat_h_band_fix_3d"] == 1, load
            assert torch.equal(r, rp), (k, load)
            for a, w, o in zip(got, want, origins):
                assert torch.equal(a.nan_to_num(7.0), w.nan_to_num(7.0)), (
                    k, load, o)
                assert a[k:block[0] - k].isnan().all()
                f = f_out[tuple(slice(c, c + n) for c, n in zip(o, block))]
                assert torch.equal(a[:k], f[:k])
                assert torch.equal(a[block[0] - k:], f[block[0] - k:])
            ran.add(load)
        del xch, f_out
    assert "cells" in ran
    if p.h_band_vec_fits(block):
        assert "vec" in ran


@pytest.mark.parametrize("mesh_shape,block,k", [
    ((2, 2, 2), (64, 64, 64), 3), ((3, 3, 3), (37, 45, 80), 8),
    ((2, 4, 1), (40, 33, 97), 1), ((49, 1, 1), (6, 20, 24), 3)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_h_bulk_and_band_launch_bitwise_monolithic(card, mesh_shape, block,
                                                   k):
    """A round's deferred bulks plus its one band launch (in chunks past
    BAND_TABLE_3D blocks: the 49 blocks of (49, 1, 1) take two) are
    bitwise the monolithic H-fused round, and max(bulk, band) is its
    residual."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(_rand(grid, 29, card))
    xch = temporal3d.DeepExchange3D(mesh, block, k, card)
    xch.lead(us)
    xch.last(us)
    origins = [mesh.origin(b, block) for b in range(mesh.size)]
    kw = dict(grid_shape=grid, cx=0.1, cy=0.15, cz=0.05)
    split = [torch.full(block, float("nan"), device=card) for _ in us]
    res = [skb3.h_block_fused(us[b], xch.ztail[b], xch.ytail[b], None, None,
                              split[b], k, defer_x=True, origin=origins[b],
                              **kw) for b in range(mesh.size)]
    sk.reset_counts()
    res.append(skb3.band_fix_blocks_3d(us, xch.ztail, xch.ytail, xch.xlo,
                                       xch.xhi, split, k, origins=origins,
                                       **kw))
    assert sk.counts["heat_h_band_fix_3d"] == -(-mesh.size
                                                // skb3.BAND_TABLE_3D)
    mono = []
    for b in range(mesh.size):
        want = torch.empty(block, device=card)
        mono.append(skb3.h_block_fused(us[b], *xch.pieces(b), want, k,
                                       origin=origins[b], **kw))
        assert torch.equal(split[b], want), b
    assert torch.equal(torch.stack(res).amax(), torch.stack(mono).amax())


@pytest.mark.parametrize("cfg,force", [
    (dict(nx=256, ny=256, nz=256, steps=101, mesh_shape=(2, 2, 2)), None),
    (dict(nx=128, ny=128, nz=96, steps=50, mesh_shape=(2, 4, 1),
          halo_overlap="phase"), None),
    (dict(nx=128, ny=128, nz=128, steps=41, mesh_shape=(2, 2, 2)), "H"),
    (dict(nx=96, ny=256, nz=132, steps=23, mesh_shape=(2, 4, 1)), "H"),
    (dict(nx=128, ny=128, nz=128, steps=41, mesh_shape=(2, 2, 2)),
     "H-defer"),
    (dict(nx=64, ny=64, nz=64, steps=30, mesh_shape=(2, 2, 2),
          halo_depth=1), None),
    (dict(nx=10, ny=10, nz=10, steps=5000, converge=True,
          mesh_shape=(2, 2, 2)), None)])
def test_sharded_3d_solve_on_the_card_matches_one_block_bitwise(card, cfg,
                                                                force):
    sk.reset_counts()
    if force is None:
        got = solve(HeatConfig(**cfg))
    else:
        with tune.force("block_temporal_3d", force):
            got = solve(HeatConfig(**cfg))
    assert sum(n for name, n in sk.counts.items()
               if name.startswith("heat_h_")) > 0
    assert not any(n for name, n in sk.counts.items()
                   if name.endswith("_plain"))
    one = solve(HeatConfig(**{**cfg, "mesh_shape": None,
                              "halo_overlap": None, "halo_depth": None}))
    cpu = solve(HeatConfig(**cfg, backend="cuda"), device="cpu")
    assert torch.equal(got.grid, one.grid)
    assert np.array_equal(got.to_numpy(), cpu.to_numpy())
    assert (got.steps_run, got.converged) == (one.steps_run, one.converged)
    if cfg.get("converge"):
        assert got.residual == one.residual == cpu.residual


# ---------------------------------------------------------------------------
# The device loop: graphs with the stop test on the card
# ---------------------------------------------------------------------------

def _loop_run(cfg, eager, force=None):
    """``solve(cfg)`` on the card through the graphs, or with the eager
    executor (``eager``); the result, the launch counts, the multigrid
    stats and the device loop's stats of the run."""
    import contextlib

    from parallel_heat_tpu_torch.utils import device_loop as dl

    sk.reset_counts()
    mg.reset_stats()
    dl.reset_stats()
    with (dl.eager() if eager else contextlib.nullcontext()), (
            tune.force("single_2d", force) if force
            else contextlib.nullcontext()):
        res = solve(cfg)
    return res, dict(sk.counts), dict(mg.stats), dict(dl.stats)


def _bitwise(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cfg,force", [
    (dict(nx=20, ny=20, steps=10000, converge=True, eps=1e-3), None),
    (dict(nx=20, ny=20, steps=10000, converge=True, eps=1e-3), "E-uni"),
    (dict(nx=20, ny=20, steps=10000, converge=True, eps=1e-3), "B"),
    (dict(nx=20, ny=20, steps=1990, converge=True, eps=1e-6), "E"),
    (dict(nx=1000, ny=1000, steps=10000, converge=True, eps=1e-3), None),
    (dict(nx=16, ny=16, cx=0.4, cy=0.4, steps=200, converge=True), None),
    (dict(nx=1000, ny=1000, steps=10000, converge=True, eps=1e-3,
          mesh_shape=(2, 4)), None),
    (dict(nx=10, ny=10, nz=10, steps=2000, converge=True, eps=1e-3,
          mesh_shape=(2, 2, 2)), None),
    (dict(nx=34, ny=34, steps=60, converge=True, eps=50.0, check_interval=5,
          scheme="backward_euler", cx=22.5, cy=22.5), None),
], ids=["A", "E-uni", "B", "E-tail", "A-1000", "nan", "2x4", "2x2x2",
        "implicit"])
def test_device_loop_converge_graph_bitwise_eager(card, cfg, force):
    from parallel_heat_tpu_torch.utils import device_loop as dl

    cfg = HeatConfig(**cfg)
    g, gc, gm, gd = _loop_run(cfg, False, force)
    e, ec, em, _ = _loop_run(cfg, True, force)
    assert (g.steps_run, g.converged) == (e.steps_run, e.converged)
    assert g.residual == e.residual or (math.isnan(g.residual)
                                        and math.isnan(e.residual))
    assert _bitwise(g.grid, e.grid)
    assert gc == ec and gm["cycles"] == em["cycles"]
    assert gm["steps"] == em["steps"] and gm["host_syncs"] == 0
    assert gd["graphs"] >= 1 and gd["launches"] >= 1
    windows = min(g.steps_run, cfg.steps // cfg.check_interval
                  * cfg.check_interval) // cfg.check_interval
    copies = dl.WINDOW_COPIES if cfg.scheme == "explicit" else 2
    assert gd["reads"] <= -(-windows // copies) + 1


@pytest.mark.parametrize("cfg", [
    dict(nx=512, ny=512, steps=20, scheme="backward_euler", cx=22.5, cy=22.5),
    dict(nx=512, ny=512, steps=7, scheme="crank_nicolson", cx=22.5,
         cy=22.5),
    dict(nx=1024, ny=1024, steps=50, mesh_shape=(2, 4)),
    dict(nx=64, ny=64, nz=64, steps=30, mesh_shape=(2, 2, 2)),
], ids=["be", "cn", "2x4", "2x2x2"])
def test_device_loop_fixed_reads_nothing_a_step(card, cfg):
    cfg = HeatConfig(**cfg)
    g, gc, gm, gd = _loop_run(cfg, False)
    e, ec, em, _ = _loop_run(cfg, True)
    assert _bitwise(g.grid, e.grid) and gc == ec
    assert gm["cycles"] == em["cycles"] and gm["host_syncs"] == 0
    # One read at most a run (the cycle counters), none a step.
    assert gd["reads"] <= 1 and gd["graphs"] >= 1
    # The period graph once a period, and the rest once.
    from parallel_heat_tpu_torch import solver

    period = solver._period(solver._resolved(cfg, "cuda"), card)
    full, rem = divmod(cfg.steps, period)
    assert gd["launches"] == full + (rem > 0)


def _stream_rows(cfg, **kw):
    """Each yield of a stream on the card: its fields and a copy of its
    grid made before the generator advances."""
    from parallel_heat_tpu_torch.solver import solve_stream

    return [(r.steps_run, r.converged, r.residual, r.finite, r.diagnostics,
             r.grid.clone()) for r in solve_stream(cfg, **kw)]


@pytest.mark.parametrize("cfg,chunk", [
    (dict(nx=1000, ny=1000, steps=100, guard_interval=20,
          diag_interval=40), 20),
    (dict(nx=4096, ny=4096, steps=40, guard_interval=8, diag_interval=8), 8),
    (dict(nx=512, ny=512, steps=60, mesh_shape=(2, 2), guard_interval=20,
          diag_interval=20), 20),
    (dict(nx=512, ny=512, steps=48, mesh_shape=(2, 4), guard_interval=8,
          diag_interval=16), 8),
    (dict(nx=128, ny=128, steps=9, scheme="backward_euler", cx=22.5,
          cy=22.5, guard_interval=3, diag_interval=3), 3),
], ids=["A", "E-uni", "2x2", "2x4-flips", "implicit"])
def test_stream_depth_two_bitwise_depth_one(card, cfg, chunk):
    # Dispatch order only: the grids, verdicts and samples of a pipelined
    # stream are the synchronous stream's, and both are solve()'s.
    cfg = HeatConfig(**cfg)
    one = _stream_rows(cfg, chunk_steps=chunk, pipeline_depth=1)
    two = _stream_rows(cfg, chunk_steps=chunk, pipeline_depth=2)
    assert len(one) == len(two) == -(-cfg.steps // chunk)
    for a, b in zip(one, two):
        assert a[:4] == b[:4]
        da = dict(a[4]) if a[4] is not None else None
        if da is not None:
            da.pop("vcycle", None)  # sampled at depth 1 only
        assert da == b[4]
        assert _bitwise(a[5], b[5])
    ref = solve(cfg.replace(guard_interval=None, diag_interval=None))
    assert _bitwise(one[-1][5], ref.grid)
    assert all(r[3] is True for r in one if r[3] is not None)


@pytest.mark.parametrize("cfg,chunk", [
    (dict(nx=1000, ny=1000, steps=10000, converge=True, eps=1e-3), 1000),
    (dict(nx=1000, ny=1000, steps=10000, converge=True, eps=1e-3), 300),
    (dict(nx=20, ny=20, steps=1990, converge=True, eps=1e-6), 70),
    (dict(nx=16, ny=16, cx=0.4, cy=0.4, steps=200, converge=True), 40),
    (dict(nx=1000, ny=1000, steps=10000, converge=True, eps=1e-3,
          mesh_shape=(2, 4)), 1000),
    (dict(nx=34, ny=34, steps=60, converge=True, eps=50.0, check_interval=5,
          scheme="backward_euler", cx=22.5, cy=22.5), 15),
], ids=["A-1000", "A-300-flips", "20-tail", "nan", "2x4", "implicit"])
def test_stream_converge_bitwise_solve(card, cfg, chunk):
    # Chunks of whole check windows replay the graphs solve() replays:
    # steps, verdict, residual and grid are solve()'s, bit for bit; no
    # capture happens once the first chunk's clock has started.
    from parallel_heat_tpu_torch.utils import device_loop as dl

    cfg = HeatConfig(**cfg)
    ref = solve(cfg)
    dl.reset_stats()
    rows = []
    from parallel_heat_tpu_torch.solver import solve_stream

    for r in solve_stream(cfg, chunk_steps=chunk):
        rows.append((r.steps_run, r.converged, r.residual, r.grid.clone()))
        if len(rows) == 1:
            graphs = dl.stats["graphs"]
    assert dl.stats["graphs"] == graphs
    steps, conv, res, grid = rows[-1]
    assert (steps, conv) == (ref.steps_run, ref.converged)
    assert res == ref.residual or (math.isnan(res)
                                   and math.isnan(ref.residual))
    assert _bitwise(grid, ref.grid)


# ---------------------------------------------------------------------------
# The bfloat16 forms of A, E and E-uni
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def _rand_bf16(shape, seed, dev, nan=False):
    """A random bfloat16 grid (values of either sign, magnitudes to 40);
    with ``nan``, NaNs of three payloads in the interior and on the ring
    (0x7FC1 and 0xFFC0 are no NaN that a conversion makes)."""
    u = _rand(shape, seed, dev).to(BF16)
    if nan:
        bits = u.view(torch.int16)
        for (i, j), b in (((shape[0] // 2, shape[1] // 3), 0x7FC1),
                          ((0, shape[1] // 2), 0x7FC1),
                          ((shape[0] - 1, 1), -64),    # 0xFFC0
                          ((shape[0] // 3, shape[1] - 1), 0x7F81)):
            bits[i, j] = b
    return u


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


def _same_res(a, b):
    a, b = float(a), float(b)
    return a == b or (math.isnan(a) and math.isnan(b))


def _ring(t):
    return [t[0], t[-1], t[:, 0], t[:, -1]]


E_BF16 = ((sk.temporal_steps, sk.temporal_steps_plain, False),
          (sk.temporal_steps_uni, sk.temporal_steps_uni_plain, True))


def _carry(launch):
    """A carry chunk of E or E-uni (``launch``) as the main path runs it,
    across a float32 level (``stencil_kernels._carry_chunks``), called as
    its wrapper is."""
    def run(u, out, k, with_residual, *, cx, cy, acc_f32):
        assert acc_f32
        return sk._carry_chunks(functools.partial(launch, cx=cx, cy=cy))(
            u, out, k, with_residual)
    return run


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("acc", [False, True], ids=["storage", "acc_f32"])
@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("shape", [(1001, 1000), (1001, 999), (70, 304),
                                   (21, 23), (20, 24)])
def test_e_bf16_forms_bitwise_plain_and_each_other(card, shape, k, acc, cx,
                                                   cy):
    u = _rand_bf16(shape, k, card)
    grids = []
    for launch, plain, uni in E_BF16:
        if uni and not params().uni_fits(shape, "bfloat16"):
            continue
        got = torch.full_like(u, float("nan"))
        want = torch.full_like(u, float("nan"))
        r = launch(u, got, k, True, cx=cx, cy=cy, acc_f32=acc)
        rp = plain(u, want, k, True, cx=cx, cy=cy, acc_f32=acc)
        nores = torch.empty_like(u)
        launch(u, nores, k, False, cx=cx, cy=cy, acc_f32=acc)
        torch.cuda.synchronize()
        assert _same_bits(got, want) and _same_res(r, rp)
        assert _same_bits(got, nores)
        grids.append((got, r))
    if len(grids) == 2:
        assert _same_bits(grids[0][0], grids[1][0])
        assert _same_res(grids[0][1], grids[1][1])


@pytest.mark.parametrize("k", [9, 16])
@pytest.mark.parametrize("shape", [(1001, 1000), (70, 304), (20, 24)])
def test_e_bf16_chunk_across_a_float32_level_is_one_launch(card, shape, k):
    # A carry chunk in two launches (bfloat16 -> float32 level -> bfloat16,
    # stencil_kernels._carry_chunks) is bitwise the plain chunk, carried
    # in one pass, and its level bitwise the plain version's.
    u = _rand_bf16(shape, 5, card)
    for launch, plain, uni in E_BF16:
        if uni and not params().uni_fits(shape, "bfloat16"):
            continue
        want = torch.empty_like(u)
        rp = plain(u, want, k, True, cx=0.1, cy=0.2, acc_f32=True)
        mid = torch.full(u.shape, float("nan"), device=card)
        two = torch.empty_like(u)
        launch(u, mid, 8, False, cx=0.1, cy=0.2, acc_f32=True)
        r2 = launch(mid, two, k - 8, True, cx=0.1, cy=0.2, acc_f32=True)
        want_mid = torch.empty_like(mid)
        plain(u, want_mid, 8, False, cx=0.1, cy=0.2, acc_f32=True)
        chunk = torch.empty_like(u)
        r3 = _carry(launch)(u, chunk, k, True, cx=0.1, cy=0.2, acc_f32=True)
        torch.cuda.synchronize()
        assert _same_bits(want, two) and _same_res(rp, r2)
        assert _same_bits(mid, want_mid)
        assert _same_bits(chunk, two) and _same_res(r3, r2)


@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [1, 4, 7, 20])
@pytest.mark.parametrize("shape", [(1001, 999), (70, 300), (20, 20),
                                   (107, 210), (1000, 1000)])
def test_a_bf16_bitwise_equal_to_plain(card, shape, k, cx, cy):
    u = _rand_bf16(shape, 7, card)
    got, want = torch.empty_like(u), torch.empty_like(u)
    r = sk.resident_steps(u, got, k, True, cx=cx, cy=cy)
    rp = sk.resident_steps_plain(u, want, k, True, cx=cx, cy=cy)
    torch.cuda.synchronize()
    assert _same_bits(got, want) and _same_res(r, rp)


def test_bf16_nan_keeps_the_ring_and_reaches_every_residual(card):
    u = _rand_bf16((515, 776), 3, card, nan=True)
    runs = [(sk.resident_steps, sk.resident_steps_plain, 20, {})]
    for launch, plain, _ in E_BF16:
        runs += [(launch, plain, 8, {"acc_f32": False}),
                 (_carry(launch), plain, 16, {"acc_f32": True})]
    for launch, plain, k, kw in runs:
        got, want = torch.empty_like(u), torch.empty_like(u)
        r = launch(u, got, k, True, cx=0.1, cy=0.1, **kw)
        rp = plain(u, want, k, True, cx=0.1, cy=0.1, **kw)
        torch.cuda.synchronize()
        assert math.isnan(float(r)) and _same_bits(got, want)
        assert all(_same_bits(a, b) for a, b in zip(_ring(got), _ring(u)))


@pytest.mark.parametrize("cfg", [
    dict(nx=256, ny=256, steps=300, dtype="bfloat16"),
    dict(nx=2000, ny=1000, steps=37, dtype="bfloat16"),
    dict(nx=2000, ny=1001, steps=37, dtype="bfloat16"),
    dict(nx=256, ny=256, steps=37, dtype="bfloat16", accumulate="f32chunk"),
    dict(nx=20, ny=20, steps=10000, converge=True, eps=1e-3,
         dtype="bfloat16"),
    dict(nx=40, ny=48, steps=4000, converge=True, eps=1e-2,
         dtype="bfloat16", accumulate="f32chunk"),
    dict(nx=64, ny=64, steps=50, dtype="float64"),
], ids=["A", "E-uni", "E", "f32chunk", "A-converge", "f32chunk-converge",
        "float64"])
def test_precision_solve_on_the_card_matches_the_cpu_bitwise(card, cfg):
    cfg = HeatConfig(**cfg)
    gpu = solve(cfg)
    cpu = solve(cfg.replace(backend="cuda" if cfg.dtype == "bfloat16"
                            else "auto"), device="cpu")
    assert (gpu.steps_run, gpu.converged) == (cpu.steps_run, cpu.converged)
    assert gpu.grid.dtype == cpu.grid.dtype
    assert _same_bits(gpu.grid.cpu(), cpu.grid)
    if cfg.converge:
        assert _same_res(gpu.residual, cpu.residual)


# ---------------------------------------------------------------------------
# The bfloat16 forms of B, C and M; the chains; ensembles and the implicit
# schemes at bfloat16 and float64
# ---------------------------------------------------------------------------

def _b_bf16_launches(u, k):
    src, dst = u.clone(), torch.empty_like(u)
    for _ in range(k):
        rb = sk.strip_step(src, dst, cx=0.1, cy=0.2)
        src, dst = dst, src
    return src, rb


@pytest.mark.parametrize("nan", [False, True], ids=["random", "nan"])
@pytest.mark.parametrize("shape", [(1001, 999), (20, 24), (3, 3),
                                   (300, 4096)])
def test_b_and_c_bf16_bitwise_plain_and_each_other(card, shape, nan):
    u = _rand_bf16(shape, 8, card, nan=nan and min(shape) > 3)
    grids = []
    for launch, plain in ((sk.strip_step, sk.strip_step_plain),
                          (sk.tiled_step, sk.tiled_step_plain)):
        got = torch.full_like(u, float("nan"))
        want = torch.full_like(u, float("nan"))
        r = launch(u, got, cx=0.1, cy=0.2)
        rp = plain(u, want, cx=0.1, cy=0.2)
        torch.cuda.synchronize()
        assert _same_bits(got, want) and _same_res(r, rp)
        assert all(_same_bits(a, b) for a, b in zip(_ring(got), _ring(u)))
        grids.append((got, r))
    assert _same_bits(grids[0][0], grids[1][0])
    assert _same_res(grids[0][1], grids[1][1])


@pytest.mark.parametrize("k", [1, 7, 20])
@pytest.mark.parametrize("batch,shape", [
    (3, (107, 210)), (8, (20, 20)), (8, (166, 166)), (3, (512, 512)),
    (2, (1000, 1000)), (64, (512, 512))])
def test_m_bf16_bitwise_plain_and_a_bf16_per_member(card, batch, shape, k):
    u = torch.stack([_rand_bf16(shape, b, card) for b in range(batch)])
    got, want, nores = (torch.empty_like(u) for _ in range(3))
    r = batched.ensemble_steps(u, got, k, cx=0.1, cy=0.2)
    rp = batched.ensemble_steps_plain(u, want, k, cx=0.1, cy=0.2)
    batched.ensemble_steps(u, nores, k, False, cx=0.1, cy=0.2)
    torch.cuda.synchronize()
    assert _same_bits(got, want) and torch.equal(r, rp)
    assert _same_bits(got, nores)
    for b in {0, batch // 2, batch - 1}:
        one = torch.empty_like(u[b])
        ra = sk.resident_steps(u[b].contiguous(), one, k, cx=0.1, cy=0.2)
        assert _same_bits(one, got[b]) and _same_res(ra, r[b])


def test_bf16_chains_are_k_launches_of_b(card):
    # A (K = 20 on 1000^2), E and E-uni in storage form (K = 8) are K
    # launches of B, bit for bit; C is B (the test above).
    u = _rand_bf16((1000, 1000), 9, card)
    for launch, k, kw in ((sk.resident_steps, 20, {}),
                          (sk.temporal_steps, 8, {"acc_f32": False}),
                          (sk.temporal_steps_uni, 8, {"acc_f32": False})):
        got = torch.empty_like(u)
        r = launch(u, got, k, True, cx=0.1, cy=0.2, **kw)
        want, rb = _b_bf16_launches(u, k)
        torch.cuda.synchronize()
        assert _same_bits(got, want) and _same_res(r, rb)


@pytest.mark.parametrize("cfg", [
    HeatConfig(nx=512, ny=512, steps=40, dtype="bfloat16"),
    HeatConfig(nx=100, ny=120, steps=2000, converge=True, eps=1e-2,
               dtype="bfloat16"),
    HeatConfig(nx=256, ny=256, steps=40, dtype="bfloat16",
               accumulate="f32chunk"),
    HeatConfig(nx=64, ny=64, steps=40, dtype="float64"),
], ids=["M", "M-converge", "f32chunk", "float64"])
def test_precision_ensembles_match_solo_and_the_cpu_bitwise(card, cfg):
    base = solve(cfg.replace(steps=0, converge=False)).grid
    inits = torch.stack([base * s for s in (1, 0.5, 0.01)])
    es = EnsembleSolver(cfg, 3)
    assert es.path == ("M" if cfg.dtype == "bfloat16"
                       and cfg.accumulate == "storage" else "vmap")
    sk.reset_counts()
    got = es.solve(initials=inits)
    if es.path == "M":
        assert sk.counts["heat_m_ensemble_bf16"] > 0
    assert sk.counts["ensemble_steps_plain"] == 0
    cpu = EnsembleSolver(cfg.replace(
        backend="torch" if cfg.dtype == "float64" else "cuda"), 3,
        device="cpu").solve(initials=inits.cpu())
    assert _same_bits(got.grids.cpu(), cpu.grids)
    assert got.steps_run.tolist() == cpu.steps_run.tolist()
    solo_cfg = cfg if es.path == "M" else cfg.replace(backend="torch")
    for i in range(3):
        solo = solve(solo_cfg, initial=inits[i])
        assert _same_bits(got.grids[i], solo.grid)
        assert int(got.steps_run[i]) == solo.steps_run


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
@pytest.mark.parametrize("scheme", ["backward_euler", "crank_nicolson"])
def test_implicit_precision_cuda_equals_torch_and_the_cpu(card, scheme,
                                                          dtype):
    cfg = HeatConfig(nx=130, ny=97, cx=22.5, cy=22.5, steps=4, scheme=scheme,
                     dtype=dtype)
    sk.reset_counts()
    a = solve(cfg.replace(backend="cuda"))
    assert sk.counts["heat_mg_restrict"] > 0
    assert sk.counts["restrict_full_weighting"] == 0
    b = solve(cfg.replace(backend="torch"))
    cpu = solve(cfg.replace(backend="torch"), device="cpu")
    assert a.grid.dtype == b.grid.dtype == cpu.grid.dtype
    assert _same_bits(a.grid, b.grid)
    assert _same_bits(a.grid.cpu(), cpu.grid)



# ---------------------------------------------------------------------------
# D's and F's bfloat16 forms; 3D runs and ensembles at bfloat16 and float64
# ---------------------------------------------------------------------------

def _rand_bf16_3d(shape, seed, dev, nan=False):
    """A random bfloat16 grid of ``shape``; with ``nan``, NaNs of three
    payloads inside and on the faces."""
    u = _rand(shape, seed, dev).to(BF16)
    if nan:
        bits = u.view(torch.int16)
        nx, ny, nz = shape
        for at, b in (((nx // 2, ny // 2, nz // 3), 0x7FC1),
                      ((0, ny // 2, nz // 2), -64),      # 0xFFC0
                      ((nx // 2, ny - 1, 1), 0x7F81)):
            bits[at] = b
    return u


_FACES = (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0],
          np.s_[:, :, -1])


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("shape", [(67, 130, 204), (67, 130, 200),
                                   (5, 3, 300), (24, 20, 28)])
def test_d_and_f_bf16_bitwise_plain_and_k_launches_of_d(card, shape, k,
                                                        nan):
    kw = dict(cx=0.1, cy=0.15, cz=0.05)
    u = _rand_bf16_3d(shape, k, card, nan=nan)
    def same_res(a, b):
        return (math.isnan(a) and math.isnan(b)) or a == b

    got, want = torch.empty_like(u), torch.empty_like(u)
    r = sk3.slab_step_3d(u, got, **kw)
    rp = sk3.slab_step_3d_plain(u, want, **kw)
    assert _same_bits(got, want) and same_res(float(r), float(rp))
    chain, rd = _d_launches(u, k, kw)
    loads = ["cp.async"] + (["tma"] if sk3.f_load(shape, u) == "tma"
                            else [])
    for load in loads:
        got = torch.full_like(u, float("nan"))
        want = torch.full_like(u, float("nan"))
        r = sk3.xslab_steps_3d(u, got, k, load=load, **kw)
        rp = sk3.xslab_steps_3d_plain(u, want, k, **kw)
        assert _same_bits(got, want) and same_res(float(r), float(rp))
        assert _same_bits(got, chain) and same_res(float(r), float(rd))
        for sl in _FACES:
            assert _same_bits(got[sl].contiguous(), u[sl].contiguous())
        assert math.isnan(float(r)) == nan


def test_3d_bf16_main_path_launch_counts(card):
    # BASELINE config 5 at bfloat16: 200 steps are 67 launches of F's
    # bfloat16 form (K = 3), or 200 of D's pinned, bitwise the same grid.
    cfg = HeatConfig(nx=512, ny=512, nz=512, steps=200, dtype="bfloat16")
    runs = {}
    for choice, kernel, launches in (("F", "heat_f_temporal3d_bf16", 67),
                                     ("D", "heat_d_step3d_bf16", 200)):
        sk.reset_counts()
        with tune.force("single_3d", choice):
            runs[choice] = solve(cfg).grid
        ran = {k: n for k, n in sk.counts.items() if n}
        assert ran == {kernel: launches}
    assert _same_bits(runs["F"], runs["D"])


@pytest.mark.parametrize("cfg", [
    HeatConfig(nx=30, ny=20, nz=40, steps=57, converge=True, eps=1e-9,
               dtype="bfloat16"),
    HeatConfig(nx=40, ny=33, nz=72, cx=0.1, cy=0.15, cz=0.05, steps=50,
               dtype="bfloat16"),
    HeatConfig(nx=40, ny=33, nz=71, steps=50, dtype="float64"),
], ids=["bf16-tail", "bf16-unequal", "f64"])
def test_solve_3d_precision_on_the_card_matches_the_cpu_bitwise(card, cfg):
    bf16 = cfg.dtype == "bfloat16"
    cpu = solve(cfg.replace(backend="cuda" if bf16 else "torch"),
                device="cpu")
    for choice in (("F", "D") if bf16 else (None,)):
        sk.reset_counts()
        if choice:
            with tune.force("single_3d", choice):
                res = solve(cfg)
        else:
            res = solve(cfg)
        kernel = sk.kernel_entry(choice, cfg.dtype) if choice else None
        ran = {k for k, n in sk.counts.items() if n}
        assert ran == ({kernel} if kernel else set())
        assert (res.steps_run, res.converged) == (cpu.steps_run,
                                                 cpu.converged)
        assert res.residual == cpu.residual
        assert _same_bits(res.grid.cpu(), cpu.grid)


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
def test_3d_precision_ensembles_bitwise_their_solo_torch_runs(card, dtype):
    cfg = HeatConfig(nx=20, ny=24, nz=28, steps=33, dtype=dtype)
    inits = torch.stack([_rand((20, 24, 28), b, card).abs()
                         for b in range(3)]).to(BF16 if dtype == "bfloat16"
                                                else torch.float64)
    es = EnsembleSolver(cfg, 3)
    assert es.path == "vmap"
    sk.reset_counts()
    got = es.solve(initials=inits)
    assert not {k for k, n in sk.counts.items() if n and k.startswith("heat_")}
    for i in range(3):
        solo = solve(cfg.replace(backend="torch"), initial=inits[i])
        assert _same_bits(got.grids[i], solo.grid)


# ---------------------------------------------------------------------------
# The G family's bfloat16 forms and bfloat16 / float64 meshes
# ---------------------------------------------------------------------------

# Blocks 16 x 24 (exactly 2K rows at K = 8), 500 x 256 (G-uni's bfloat16
# form), 500 x 252 (a width of 4k: G-uni's form refused) and 333 x 143.
G_BF16_CASES = [((32, 48), (2, 2), 8), ((1000, 1024), (2, 4), 3),
                ((1000, 1008), (2, 4), 8), ((999, 286), (3, 2), 5)]


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("grid,mesh_shape,k", G_BF16_CASES)
def test_g_bf16_forms_bitwise_plain_each_other_and_e(card, grid, mesh_shape,
                                                     k, nan):
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    cx, cy = COEFFS[1]
    g = _rand_bf16(grid, 41, card, nan=nan)
    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(g)
    bs = mesh.block_shape(grid)
    pieces = temporal.exchange_halos_fused_2d(mesh, us, k)
    exts = {"G-circ": temporal.exchange_halos_circular_2d(mesh, us, k),
            "G": temporal.exchange_halos_deep_2d(mesh, us, k)}
    assert pieces[0][0].dtype == exts["G"][0].dtype == BF16
    e_out = torch.empty_like(g)
    sk.temporal_steps(g, e_out, k, cx=cx, cy=cy)
    plain = {"G-uni": skb.block_uniform_plain, "G-fuse": skb.block_fused_plain,
             "G-circ": skb.block_circular_plain, "G": skb.block_padded_plain}
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        kw = dict(origin=o, grid_shape=grid, cx=cx, cy=cy)
        want = e_out[o[0]:o[0] + bs[0], o[1]:o[1] + bs[1]].contiguous()
        res = None
        for kind, name in skb.KERNEL_OF_BF16.items():
            if kind == "G-uni" and bs[1] % 8:
                continue
            args = (exts[kind][b],) if kind in exts else (us[b], *pieces[b])
            got, ref = (torch.full(bs, float("nan"), dtype=BF16,
                                   device=card) for _ in range(2))
            sk.reset_counts()
            r = skb.LAUNCH[kind](*args, got, k, **kw)
            assert sk.counts[name] == 1
            rp = plain[kind](*args, ref, k, **kw)
            assert _same_bits(got, ref) and _same_res(r, rp), kind
            assert _same_bits(got, want), kind
            res = r if res is None else res
            assert _same_res(r, res), kind
            if kind in ("G-uni", "G-fuse") and bs[0] >= 2 * k:
                split = torch.full(bs, float("nan"), dtype=BF16, device=card)
                rb = skb.LAUNCH[kind](us[b], pieces[b][0], None, None, split,
                                      k, **kw)
                rf = skb.band_fix(us[b], *pieces[b], split, k, **kw)
                assert _same_bits(split, got)
                assert _same_res(torch.maximum(rb, rf), r)


@pytest.mark.parametrize("grid,mesh_shape,k", G_BF16_CASES)
def test_band_bf16_blocks_bitwise_plain_under_each_load(card, grid,
                                                        mesh_shape, k):
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
    from parallel_heat_tpu_torch.parallel import temporal
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(_rand_bf16(grid, 43, card, nan=True))
    bs = mesh.block_shape(grid)
    if bs[0] < 2 * k:
        pytest.skip(f"blocks of {bs[0]} rows have no band at K={k}")
    tails, hns, hss = zip(*temporal.exchange_halos_fused_2d(mesh, us, k))
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    kw = dict(origins=origins, grid_shape=grid, cx=0.1, cy=0.2)
    plain = [torch.full(bs, float("nan"), dtype=BF16, device=card)
             for _ in us]
    rp = skb.band_fix_blocks_plain(us, tails, hns, hss, plain, k, **kw)
    picked = skb.BandLaunch(us, tails, hns, hss, plain, k, **kw).load
    for load in sorted({"cells", picked}):
        got = [torch.full(bs, float("nan"), dtype=BF16, device=card)
               for _ in us]
        sk.reset_counts()
        r = skb.BandLaunch(us, tails, hns, hss, got, k, load=load,
                           **kw)(True)
        assert sk.counts["heat_g_band_fix_bf16"] == 1
        for a, c in zip(got, plain):
            assert _same_bits(a, c)
            assert a[k:bs[0] - k].isnan().all()
        assert _same_res(r, rp)


@pytest.mark.parametrize("cfg", [
    dict(nx=1000, ny=1024, steps=101, mesh_shape=(2, 4)),
    dict(nx=512, ny=512, steps=200, mesh_shape=(2, 2), halo_overlap="phase"),
    dict(nx=1000, ny=1000, steps=400, converge=True, check_interval=20,
         eps=1e-9, mesh_shape=(2, 4)),
    dict(nx=256, ny=256, steps=50, mesh_shape=(2, 2), halo_depth=1)])
def test_sharded_bf16_solve_on_the_card_matches_one_block_bitwise(card, cfg):
    cfg = dict(cfg, dtype="bfloat16")
    sk.reset_counts()
    got = solve(HeatConfig(**cfg))
    ran = {name for name, n in sk.counts.items() if n}
    assert ran and all(name.startswith("heat_g_") and name.endswith("_bf16")
                       for name in ran), ran
    one = solve(HeatConfig(**{**cfg, "mesh_shape": None,
                              "halo_overlap": None, "halo_depth": None}))
    cpu = solve(HeatConfig(**cfg, backend="cuda"), device="cpu")
    assert _same_bits(got.grid, one.grid)
    assert _same_bits(got.grid.cpu(), cpu.grid)
    assert (got.steps_run, got.converged) == (one.steps_run, one.converged)
    if cfg.get("converge"):
        assert got.residual == one.residual == cpu.residual


@pytest.mark.parametrize("dims", [dict(nx=256, ny=256, mesh_shape=(2, 4)),
                                  dict(nx=32, ny=32, nz=32,
                                       mesh_shape=(2, 2, 2))])
@pytest.mark.parametrize("depth", [1, 4])
def test_sharded_float64_on_the_card_is_one_block_bitwise(card, dims, depth):
    cfg = HeatConfig(steps=37, dtype="float64", halo_depth=depth, **dims)
    sk.reset_counts()
    got = solve(cfg)
    assert not any(sk.counts.values())
    one = solve(cfg.replace(mesh_shape=None, halo_depth=None))
    assert got.grid.dtype == torch.float64
    assert torch.equal(got.grid.view(torch.int64), one.grid.view(torch.int64))


# ---------------------------------------------------------------------------
# The H family's bfloat16 forms and bfloat16 3D meshes
# ---------------------------------------------------------------------------

# Blocks 6 x 50 x 70 (lanes straddling the z tail), 20 x 128 x 136 (the
# band's vector load, TMA boxes inside), 20 x 128 x 252 on (3, 3, 3) and
# z-free 40 x 128 x 96.
H_BF16_CASES = [((12, 100, 140), (2, 2, 2), 3), ((40, 256, 272), (2, 2, 2),
                                                  8),
                ((60, 384, 756), (3, 3, 3), 5), ((80, 512, 96), (2, 4, 1),
                                                 4)]


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("grid,mesh_shape,k", H_BF16_CASES)
def test_h_bf16_forms_bitwise_plain_each_other_and_d(card, grid, mesh_shape,
                                                     k, nan):
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    kw3 = dict(cx=0.1, cy=0.15, cz=0.05)
    g = _rand_bf16_3d(grid, 47, card, nan=nan)
    want = g
    for _ in range(k):
        out = torch.empty_like(want)
        sk3.slab_step_3d(want, out, **kw3)
        want = out
    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(g)
    bs = mesh.block_shape(grid)
    xch = temporal3d.DeepExchange3D(mesh, bs, k, card, BF16)
    xch.lead(us)
    xch.last(us)
    for b in range(mesh.size):
        o = mesh.origin(b, bs)
        kw = dict(origin=o, grid_shape=grid, **kw3)
        cell = want[tuple(slice(a, a + n) for a, n in zip(o, bs))]
        ext = xch.new_circular()
        xch.assemble_circular(b, us[b], ext)
        runs = {"heat_h_block_3d_fused_bf16": (
                    lambda out: skb3.h_block_fused(us[b], *xch.pieces(b),
                                                   out, k, **kw),
                    lambda out: skb3.h_block_fused_plain(
                        us[b], *xch.pieces(b), out, k, **kw)),
                "heat_h_block_3d_bf16": (
                    lambda out: skb3.h_block(ext, out, k, **kw),
                    lambda out: skb3.h_block_plain(ext, out, k, **kw))}
        res = None
        for name, (launch, plain) in runs.items():
            got, ref = (torch.full(bs, float("nan"), dtype=BF16,
                                   device=card) for _ in range(2))
            sk.reset_counts()
            r = launch(got)
            assert sk.counts[name] == 1
            rp = plain(ref)
            assert _same_bits(got, ref) and _same_res(r, rp), name
            assert _same_bits(got, cell), name
            res = r if res is None else res
            assert _same_res(r, res), name
        if bs[0] >= 2 * k and xch.halos[0]:
            zt, yt, _, _ = xch.pieces(b)
            split = torch.full(bs, float("nan"), dtype=BF16, device=card)
            rb = skb3.h_block_fused(us[b], zt, yt, None, None, split, k,
                                    defer_x=True, **kw)
            rf = skb3.h_band_fix(us[b], *xch.pieces(b), split, k, **kw)
            assert _same_bits(split, cell)
            assert _same_res(torch.maximum(rb, rf), res)


@pytest.mark.parametrize("grid,mesh_shape,k", H_BF16_CASES)
def test_h_band_bf16_blocks_bitwise_plain_under_each_load(card, grid,
                                                          mesh_shape, k):
    from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
    from parallel_heat_tpu_torch.parallel import temporal3d
    from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

    mesh = HeatMesh(mesh_shape, card)
    us = mesh.split(_rand_bf16_3d(grid, 49, card, nan=True))
    bs = mesh.block_shape(grid)
    xch = temporal3d.DeepExchange3D(mesh, bs, k, card, BF16)
    xch.lead(us)
    xch.last(us)
    pieces = (xch.ztail, xch.ytail, xch.xlo, xch.xhi)
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    kw = dict(origins=origins, grid_shape=grid, cx=0.1, cy=0.15, cz=0.05)
    plain = [torch.full(bs, float("nan"), dtype=BF16, device=card)
             for _ in us]
    rp = skb3.band_fix_blocks_3d_plain(us, *pieces, plain, k, **kw)
    picked = skb3.BandLaunch3D(us, *pieces, plain, k, **kw).load
    for load in sorted({"cells", picked}):
        got = [torch.full(bs, float("nan"), dtype=BF16, device=card)
               for _ in us]
        sk.reset_counts()
        r = skb3.BandLaunch3D(us, *pieces, got, k, load=load, **kw)(True)
        assert sk.counts["heat_h_band_fix_3d_bf16"] == 1
        for a, c in zip(got, plain):
            assert _same_bits(a, c)
            assert a[k:bs[0] - k].isnan().all()
        assert _same_res(r, rp)


@pytest.mark.parametrize("kind", ["H-fused", "H", "H-defer"])
@pytest.mark.parametrize("cfg", [
    dict(nx=128, ny=128, nz=136, steps=50, mesh_shape=(2, 2, 2)),
    dict(nx=64, ny=64, nz=64, steps=400, converge=True, check_interval=20,
         eps=1e-9, mesh_shape=(2, 2, 2)),
    dict(nx=96, ny=160, nz=100, steps=31, mesh_shape=(2, 4, 1))])
def test_sharded_3d_bf16_solve_on_the_card_matches_one_block_bitwise(
        card, cfg, kind):
    cfg = dict(cfg, dtype="bfloat16", halo_overlap="overlap")
    with tune.force("block_temporal_3d", kind):
        sk.reset_counts()
        got = solve(HeatConfig(**cfg))
        ran = {name for name, n in sk.counts.items() if n}
        cpu = solve(HeatConfig(**cfg, backend="cuda"), device="cpu")
    assert ran and all(name.startswith("heat_h_") and name.endswith("_bf16")
                       for name in ran), ran
    one = solve(HeatConfig(**{**cfg, "mesh_shape": None,
                              "halo_overlap": None}))
    assert _same_bits(got.grid, one.grid)
    assert _same_bits(got.grid.cpu(), cpu.grid)
    assert (got.steps_run, got.converged) == (one.steps_run, one.converged)
    if cfg.get("converge"):
        assert got.residual == one.residual == cpu.residual
