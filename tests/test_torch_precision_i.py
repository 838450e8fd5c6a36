"""The precision forms of kernels I and I-uni against the JAX package:
bfloat16 storage and the ``accumulate="f32chunk"`` carry
(``SEMANTICS.md`` "Precision").

On the CPU the wrappers of ``heat_i_tile_temporal_bf16`` and
``heat_i_uni_tile_temporal_bf16`` run their plain versions, which round
where the kernels round (``chip_smoke.py`` holds the kernels bitwise to
them on the card). Inputs are made with numpy from a seed and handed to
both packages as the same bfloat16 bits. The tolerances are
``tests/test_torch_precision.py``'s, in bfloat16 ulps of each cell:
the plain versions against the JAX Pallas builders in interpret mode
**3 ulps** in storage mode (every level rounds, and XLA:CPU may contract
a multiply and an add where eager PyTorch rounds each) and **1 ulp** for
a carried chunk (one rounding); a residual ``rtol=1e-4`` for a carried
level and 2 ulps of the grid's largest value for a stored one; the
Dirichlet ring bit for bit. Runs pinned to I or I-uni are held bitwise to
the run pinned to E-uni (the same rounding points), and their
``steps_run``, ``converged`` and stop window to the JAX package's.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

import parallel_heat_tpu as jx
from parallel_heat_tpu.ops import pallas_stencil as ps
from parallel_heat_tpu_torch import HeatConfig, solve, tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import F32CHUNK_DEPTH
from parallel_heat_tpu_torch.solver import solve_stream

from test_torch_precision import (BF16, CARRY_ULPS, COEFFS, RAGGED,
                                  RAGGED_UNI, SHAPE, STORAGE_ULPS,
                                  _assert_ring, _bits, _close_res, _pair,
                                  _rand, _ulps)

KERNELS = {"I": (sk.tile_temporal_steps, sk.tile_temporal_steps_plain,
                 ps._build_tile_temporal_2d),
           "I-uni": (sk.tile_temporal_steps_uni,
                     sk.tile_temporal_steps_uni_plain,
                     ps._build_tile_temporal_2d_uniform)}


def _depth(fn, k, acc, cx, cy):
    """``fn(u, out, k, want_res)`` for any ``k``, as a run launches a
    kernel: up to ``i_k_default`` steps in one call, a deeper storage
    chunk as launches of ``i_k_default`` (the chunked multistep), a
    deeper carry chunk across a float32 level (``_carry_chunks``)."""
    launch = functools.partial(fn, cx=cx, cy=cy)
    k_launch = params().i_k_default
    if acc:
        return sk._carry_chunks(launch, k_launch)
    if k <= k_launch:
        return launch

    def steps(u, out, kk, want_res):
        _, multi = sk._chunked_multistep(launch, k_launch)
        v = torch.empty_like(u)
        last, _, res = multi(u.clone(), v, kk)
        out.copy_(last)
        return res
    return steps


# ---------------------------------------------------------------------------
# Each form's plain version and wrapper against the JAX builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cx,cy", COEFFS)
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("acc", [False, True], ids=["storage", "acc_f32"])
@pytest.mark.parametrize("kind", ["I", "I-uni"])
def test_i_bf16_matches_the_tile_temporal_builders(kind, acc, k, cx, cy):
    # I (_build_tile_temporal_2d :3294) and I-uni (:3456) at bfloat16,
    # storage and acc_f32; K = 16 as a run takes it, in launches of
    # i_k_default.
    launch, plain, build = KERNELS[kind]
    u32 = _rand(SHAPE, 30 + k)
    uj, ut = _pair(u32)
    want, wres = build(SHAPE, "bfloat16", cx, cy, k, acc_f32=acc)(uj)
    out = torch.full(SHAPE, float("nan"), dtype=BF16)
    res = _depth(plain, k, acc, cx, cy)(ut, out, k, True)
    assert out.dtype == BF16
    assert _ulps(out, want) <= (CARRY_ULPS if acc else STORAGE_ULPS)
    _close_res(res, wres, acc, u32)
    _assert_ring(out, ut)
    # The wrapper on the CPU is its plain version, bit for bit.
    again = torch.full_like(out, float("nan"))
    r2 = _depth(launch, k, acc, cx, cy)(ut, again, k, True)
    np.testing.assert_array_equal(_bits(again), _bits(out))
    assert float(r2) == float(res)


@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("acc", [False, True], ids=["storage", "acc_f32"])
@pytest.mark.parametrize("kind", ["I", "I-uni"])
def test_i_bf16_on_a_ragged_grid(kind, acc, k):
    # The JAX I declines 37 rows; A's builder takes the grid at the
    # storage form's rounding points, and f32chunk_jnp_multistep's chunk
    # at the carry's (the textbook tree: a carried chunk may differ by its
    # one rounding).
    shape = RAGGED_UNI if kind == "I-uni" else RAGGED
    cx, cy = 0.1, 0.2
    launch, plain, build = KERNELS[kind]
    assert build(shape, "bfloat16", cx, cy, k, acc_f32=acc) is None
    u32 = _rand(shape, 40 + k)
    uj, ut = _pair(u32)
    if acc:
        want, wres = ps.f32chunk_jnp_multistep(shape, "bfloat16", cx,
                                               cy)[1](uj, k)
    else:
        want, wres = ps._build_vmem_multistep(shape, "bfloat16", cx, cy,
                                              k)(uj)
    out = torch.empty_like(ut)
    res = _depth(plain, k, acc, cx, cy)(ut, out, k, True)
    assert _ulps(out, want) <= (CARRY_ULPS if acc else STORAGE_ULPS)
    _close_res(res, wres, acc, u32)
    _assert_ring(out, ut)
    again = torch.empty_like(ut)
    r2 = _depth(launch, k, acc, cx, cy)(ut, again, k, True)
    np.testing.assert_array_equal(_bits(again), _bits(out))
    assert float(r2) == float(res)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("form", [0, 1, 2, 3])
def test_i_forms_are_e_forms_on_the_cpu(form, k):
    # Each form of I and I-uni, in one launch, is E's form of the same
    # depth bit for bit (the grid's dtypes in and out as PRECISION_FORMS
    # gives them), and counts under its plain version.
    (din, dout, acc), = [key for key, f in sk.PRECISION_FORMS.items()
                         if f == form]
    u = torch.from_numpy(_rand((40, 136), 50 + k)).to(BF16).to(din)
    want = torch.empty(u.shape, dtype=dout)
    rw = sk.temporal_steps(u, want, k, True, cx=0.1, cy=0.2, acc_f32=acc)
    for kind, (launch, _, _) in KERNELS.items():
        sk.reset_counts()
        got = torch.empty_like(want)
        r = launch(u, got, k, True, cx=0.1, cy=0.2, acc_f32=acc)
        assert got.dtype == dout
        assert torch.equal(got.view(torch.int16 if dout == BF16
                                    else torch.int32),
                           want.view(torch.int16 if dout == BF16
                                     else torch.int32))
        assert float(r) == float(rw)
        plain = ("tile_temporal_steps_uni_plain" if kind == "I-uni"
                 else "tile_temporal_steps_plain")
        assert {n for n, c in sk.counts.items() if c} == {plain}


def test_i_forms_refuse_what_they_do_not_take():
    ut = torch.from_numpy(_rand((20, 24), 1)).to(BF16)
    f32 = ut.float()
    for launch, _, _ in KERNELS.values():
        # float32 in and out takes the float32 kernel in either mode.
        a, b = torch.empty_like(f32), torch.empty_like(f32)
        ra = launch(f32, a, 3, True, cx=0.1, cy=0.1)
        rb = launch(f32, b, 3, True, cx=0.1, cy=0.1, acc_f32=True)
        assert torch.equal(a, b) and float(ra) == float(rb)
        with pytest.raises(TypeError):        # float64: no kernel form
            launch(ut.double(), torch.empty(20, 24, dtype=torch.float64), 3,
                   cx=0.1, cy=0.1)
        with pytest.raises(TypeError):        # a carry pair in storage
            launch(ut, torch.empty(20, 24), 3, cx=0.1, cy=0.1)
        with pytest.raises(TypeError):        # bf16 -> bf16 only
            launch(f32, torch.empty_like(ut), 3, cx=0.1, cy=0.1)
        with pytest.raises(ValueError, match="k must be in"):
            launch(ut, torch.empty_like(ut), 9, cx=0.1, cy=0.1,
                   acc_f32=True)
    # I-uni's rows must be 16-byte multiples: a width of 4k is one at
    # float32, not at bfloat16.
    narrow = torch.from_numpy(_rand((20, 20), 2)).to(BF16)
    with pytest.raises(ValueError, match="multiple of 8"):
        sk.tile_temporal_steps_uni(narrow, torch.empty_like(narrow), 4,
                                   cx=0.1, cy=0.1)
    sk.tile_temporal_steps_uni(narrow.float(), torch.empty(20, 20), 4,
                               cx=0.1, cy=0.1)
    with tune.force("single_2d", "I-uni"), pytest.warns(
            RuntimeWarning, match="infeasible"):
        assert sk.pick_single_2d((20, 20), "bfloat16")[0] == "A"
    with tune.force("single_2d", "I"):
        assert sk.pick_single_2d((20, 20), "bfloat16")[0] == "I"


def test_the_ring_of_a_bf16_form_is_the_kernels():
    # heat_i_loop.cuh: a bfloat16 ring row holds 136 cells (from the
    # band's first cell rounded down to 16 bytes), a stage is rounded up
    # to 128 bytes (a box's alignment), and the launcher refuses a ring
    # past a block's shared memory at the grid's cell size.
    p = params()
    assert (p.i_row_cells(4), p.i_row_cells(2)) == (128, 136)
    for rows in range(3, 33):
        assert p.i_stage_bytes(rows, 4) == 512 * rows
        assert p.i_stage_bytes(rows, 2) % 128 == 0
        assert 0 <= p.i_stage_bytes(rows, 2) - 272 * rows < 128
    w, r, st = p.i_warps, p.i_rows, p.i_stages
    assert p.i_smem_bytes(w, r, st) == 4 * w * st * r * 128 + 128 + 8 * w * st
    assert p.i_smem_bytes(w, r, st, 2) < p.i_smem_bytes(w, r, st)
    # 8 warps of 4 stages of 16 rows: 256 KiB of float32 rows, 136 KiB of
    # bfloat16 ones.
    assert not p.i_takes(3, 8, 16, 4) and p.i_takes(3, 8, 16, 4, elem=2)
    u = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="shared"):
        sk._launch_i(u, torch.empty_like(u), 3, None, 0.1, 0.1, 8, warps=8,
                     rows=16, stages=4)


# ---------------------------------------------------------------------------
# Whole runs pinned to I and I-uni
# ---------------------------------------------------------------------------

def _pinned(cfg, pin, plain, initial):
    """solve(cfg, initial) pinned to ``pin``, the counts set to 0 just
    before and read just after (``plain`` called, nothing else)."""
    with tune.force("single_2d", pin):
        sk.reset_counts()
        res = solve(cfg, initial=initial)
        ran = {n for n, c in sk.counts.items() if c}
    assert ran == {plain}, ran
    return res


# A converge run's tolerance in each mode, from a grid of values in
# [0, 1) whose bfloat16 ulps lie below it: E-uni's run stops after 2
# windows of 16 (storage) and 5 (f32chunk), where the JAX package's
# Pallas run stops. A residual within an ulp of eps may stop a window
# apart across the two packages (the module's docstring: XLA:CPU
# contracts where eager PyTorch rounds); the pinned runs are held to
# E-uni's bit for bit at any eps.
CONVERGE_EPS = {"storage": 5e-3, "f32chunk": 1e-3}


@pytest.mark.parametrize("converge", [False, True], ids=["fixed", "converge"])
@pytest.mark.parametrize("accumulate", ["storage", "f32chunk"])
def test_pinned_runs_are_e_unis_and_stop_where_the_jax_package_stops(
        accumulate, converge):
    kw = dict(nx=64, ny=256, steps=200, dtype="bfloat16",
              accumulate=accumulate)
    if converge:
        kw.update(converge=True, eps=CONVERGE_EPS[accumulate],
                  check_interval=16)
    u32 = np.random.default_rng(5).uniform(0, 1, SHAPE).astype(np.float32)
    uj, ut = _pair(u32)
    cfg = HeatConfig(backend="cuda", device="cpu", **kw)
    base = _pinned(cfg, "E-uni", "temporal_steps_uni_plain", ut)
    theirs = jx.solve(jx.HeatConfig(backend="pallas", **kw), initial=uj)
    assert (base.steps_run, base.converged) == (theirs.steps_run,
                                                theirs.converged)
    assert bool(base.converged) == converge
    assert (base.steps_run < 200) == converge
    for pin, plain in (("I", "tile_temporal_steps_plain"),
                       ("I-uni", "tile_temporal_steps_uni_plain")):
        res = _pinned(cfg, pin, plain, ut)
        np.testing.assert_array_equal(_bits(res.grid), _bits(base.grid))
        assert (res.steps_run, res.converged, res.residual) == (
            base.steps_run, base.converged, base.residual)


def test_pinned_f32chunk_stream_is_bitwise_solve():
    kw = dict(nx=64, ny=256, steps=96, dtype="bfloat16",
              accumulate="f32chunk")
    cfg = HeatConfig(backend="cuda", device="cpu", **kw)
    with tune.force("single_2d", "I-uni"):
        whole = solve(cfg).grid
        seen = [r.steps_run for r in solve_stream(cfg, chunk_steps=32)]
        last = list(solve_stream(cfg, chunk_steps=32))[-1].grid
    assert seen == [32, 64, 96]
    np.testing.assert_array_equal(_bits(last), _bits(whole))


def test_default_pick_is_unchanged_at_every_dtype_and_mode():
    # The JAX picker takes I at 32768^2 bfloat16 in both modes; the port's
    # default stays E-uni until a benchmark says otherwise.
    for dtype, acc, want in (("float32", "storage", "E-uni"),
                             ("bfloat16", "storage", "E-uni"),
                             ("bfloat16", "f32chunk", "E-uni")):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert sk.pick_single_2d((32768, 32768), dtype, acc)[0] == want
    assert sk.pick_single_2d((32768, 32770), "bfloat16")[0] == "E"
    assert F32CHUNK_DEPTH == 16
