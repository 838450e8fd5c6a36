"""The port's static-analysis path against the JAX package's.

``parallel_heat_tpu_torch.analysis`` (heatlint's ast and kernels layers)
held to ``parallel_heat_tpu.analysis``: one port test for each JAX kernel
fixture test of ``tests/test_analysis.py`` (the same rule id and message
phrase; where the JAX audit runs on this jax, its fixture runs in the
same test and the rule sets compare), the Hopper-only fixtures, the gate
over the real plans, parity of the shared pieces (baseline, rendering,
the AST rules, the CLIs), and the fixture kernel's path on the CPU.
Small shapes: the fixture is 16 x 128.
"""

import ast
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from parallel_heat_tpu.analysis import astlint as jast
from parallel_heat_tpu.analysis import findings as jfind
from parallel_heat_tpu.analysis.kernels import (KernelTarget,
                                                _source_kernel_names, _traced,
                                                audit_kernels as jaudit)
from parallel_heat_tpu_torch.analysis import (ALL_RULES, LAYERS, astlint,
                                              findings, layer_of)
from parallel_heat_tpu_torch.analysis import kernels as pk
from parallel_heat_tpu_torch.analysis import plans as pp
from parallel_heat_tpu_torch.tools import analysis_fixture as af

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_N = 128


def _fixture(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


def _msgs(plans, **kw):
    return [(f.rule, f.message) for f in pk.audit_kernels(plans, **kw)]


def _has(msgs, rule, phrase):
    return any(r == rule and phrase in m for r, m in msgs)


# ---------------------------------------------------------------------------
# The JAX fixtures (re-declared: tests/test_analysis.py's _strip_call)
# ---------------------------------------------------------------------------

def _sds(shape, dt="float32"):
    return jax.ShapeDtypeStruct(shape, dt)


def _strip_call(kernel, n_strips=2, rows=16, scratch_rows=8,
                interpret=False):
    return pl.pallas_call(
        kernel,
        out_shape=_sds((rows, _N)),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(n_strips,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((rows // n_strips, _N),
                                   lambda s: (s, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[
                pltpu.VMEM((2, scratch_rows, _N), jnp.float32),
                pltpu.SemaphoreType.DMA((2,)),
            ],
        ),
        name="heat_probe_fixture", interpret=interpret,
    )


@functools.lru_cache(maxsize=None)
def _jax_audit_gaps():
    """The known reasons the JAX audit cannot run on this jax build
    (ROADMAP queue 3), each checked once, on what the audit reads: its
    schedule evaluator reads ``jax.core.Literal``, and its grid-coverage
    pass takes ``int()`` of each block dimension of a pallas_call's grid
    mapping (newer Pallas holds them as ``Blocked`` objects)."""
    gaps = []
    if not hasattr(jax.core, "Literal"):
        gaps.append("jax.core.Literal is gone (the schedule evaluator)")
    target = KernelTarget("gaps", _plain_call(), [_sds((8, _N))])
    for _, eqn in _traced([target]):
        for bm in eqn.params["grid_mapping"].block_mappings:
            for b in bm.block_shape:
                if b is not None and not (hasattr(b, "__index__") or
                                          hasattr(b, "__int__")):
                    gaps.append(f"block dimensions are "
                                f"{type(b).__name__}, not ints (the "
                                f"grid-coverage pass)")
    return tuple(dict.fromkeys(gaps))


def _jax_rules(call, args, **kw):
    """The rules the JAX audit reports on its fixture, or None where a
    known gap (:func:`_jax_audit_gaps`) keeps the audit from running on
    this jax; then the port is held to the JAX test's rule and phrase
    alone. Any other failure of the JAX audit fails the test."""
    if _jax_audit_gaps():
        return None
    return {f.rule for f in jaudit(
        targets=[KernelTarget("fixture", call, args)], **kw)}


def _same_rules(jax_rules, port_rules):
    return jax_rules is None or jax_rules == set(port_rules)


def _clean_kernel(u_hbm, out_ref, scratch, sems):
    s = pl.program_id(0)
    cp = pltpu.make_async_copy(u_hbm.at[pl.ds(s * 8, 8), :],
                               scratch.at[s % 2], sems.at[s % 2])
    cp.start()
    cp.wait()
    out_ref[:] = scratch[s % 2] * 2.0


def _plain_call():
    def k(u_ref, out_ref):
        out_ref[:] = u_ref[:] * 2.0

    return pl.pallas_call(
        k, out_shape=_sds((8, _N)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        name="heat_probe_fixture")


# ---------------------------------------------------------------------------
# HL401 (JAX :1081, :1093, :1108, :1156)
# ---------------------------------------------------------------------------

def test_hl401_clean_schedule_passes():
    assert _msgs([pp.plan_fixture("clean")]) == []
    assert _msgs([pp.plan_fixture("clean_tma")]) == []
    assert _same_rules(_jax_rules(_strip_call(_clean_kernel),
                                  [_sds((16, _N))]), set())


def test_hl401_out_of_bounds_window_caught():
    msgs = _msgs([pp.plan_fixture("oob_window")])
    assert _has(msgs, "HL401", "out of bounds")

    def k(u_hbm, out_ref, scratch, sems):
        s = pl.program_id(0)
        cp = pltpu.make_async_copy(u_hbm.at[pl.ds(s * 16, 16), :],
                                   scratch.at[s % 2, pl.ds(0, 16), :],
                                   sems.at[s % 2])
        cp.start()
        cp.wait()
        out_ref[:] = scratch[s % 2, 0:8, :] * 2.0

    jr = _jax_rules(_strip_call(k, scratch_rows=16), [_sds((16, _N))])
    assert {r for r, _ in msgs} == {"HL401"} and _same_rules(jr, {"HL401"})


def test_hl401_data_dependent_window_unprovable():
    out = pk.audit_kernels([pp.plan_fixture("runtime_window")])
    assert any(f.rule == "HL401" and "not statically derivable" in f.message
               and f.soundness for f in out)

    def k(u_hbm, off_ref, out_ref, scratch, sems):
        s = pl.program_id(0)
        off = off_ref[0]
        cp = pltpu.make_async_copy(u_hbm.at[pl.ds(off, 8), :],
                                   scratch.at[s % 2], sems.at[s % 2])
        cp.start()
        cp.wait()
        out_ref[:] = scratch[s % 2] * 2.0

    call = pl.pallas_call(
        k, out_shape=_sds((16, _N)),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(2,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                      pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((8, _N), lambda s: (s, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((2, 8, _N), jnp.float32),
                            pltpu.SemaphoreType.DMA((2,))]),
        name="heat_probe_fixture")
    jr = _jax_rules(call, [_sds((16, _N)), _sds((1,), "int32")])
    assert {f.rule for f in out} == {"HL401"} and _same_rules(jr, {"HL401"})


def test_hl401_uncovered_site_mechanism():
    out = pk.audit_kernels([pp.plan_fixture("clean")], check_coverage=True)
    uncovered = {f.symbol for f in out
                 if "not covered by any kernel-audit target" in f.message}
    names = set(pk.source_kernel_names())
    assert uncovered == names - {"heat_probe_fixture_kernel"}
    assert all(f.soundness for f in out)

    def k(u_ref, out_ref):
        out_ref[:] = u_ref[:] * 2.0

    call = pl.pallas_call(k, out_shape=_sds((8, _N)),
                          in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                          out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                          name="heat_probe_fixture")
    assert {f.rule for f in out} == {"HL401"}
    if _jax_audit_gaps():  # see _jax_rules
        return
    jout = jaudit(targets=[KernelTarget("fixture", call, [_sds((8, _N))])],
                  check_coverage=True)
    assert {f.symbol for f in jout} == set(_source_kernel_names())
    assert {f.rule for f in jout} == {"HL401"}


# ---------------------------------------------------------------------------
# HL402 (JAX :1189, :1194)
# ---------------------------------------------------------------------------

def test_jax_audit_gaps_are_real():
    """The comparison with the JAX audit is skipped only for a gap that
    holds: where one is named, the JAX audit fails on the fixture; where
    none is, it runs."""
    target = [KernelTarget("fixture", _strip_call(_clean_kernel),
                           [_sds((16, _N))])]
    if not _jax_audit_gaps():
        assert jaudit(targets=target) == []
        return
    with pytest.raises((AttributeError, TypeError)):
        jaudit(targets=target)


def test_hl402_over_budget_caught():
    msgs = _msgs([pp.plan_fixture("clean", limit_bytes=1024)])
    assert _has(msgs, "HL402", "exceeds")
    jr = _jax_rules(_plain_call(), [_sds((8, _N))], limit_bytes=1024)
    assert {r for r, _ in msgs} == {"HL402"} and _same_rules(jr, {"HL402"})


def test_hl402_within_budget_clean():
    assert _msgs([pp.plan_fixture("clean")]) == []
    assert _same_rules(_jax_rules(_plain_call(), [_sds((8, _N))]), set())


# ---------------------------------------------------------------------------
# HL403 (JAX :1202, :1214, :1225; the JAX audit fails on this jax, so the
# port is held to the rule and phrase the JAX test asserts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,phrase", [
    ("wait_without_issue", "NO outstanding copy"),
    ("leaked_issue", "never waited"),
    ("slot_reuse", "double-buffer slot reused"),
])
def test_hl403_seeded_schedule_caught(variant, phrase):
    msgs = _msgs([pp.plan_fixture(variant)])
    assert _has(msgs, "HL403", phrase), msgs
    assert {r for r, _ in msgs} == {"HL403"}


# ---------------------------------------------------------------------------
# HL404 (JAX :1250, :1261, :1271, :1281)
# ---------------------------------------------------------------------------

def test_hl404_ragged_block_caught():
    msgs = _msgs([pp.plan_fixture("clean", rows=8, in_rows=3)])
    assert _has(msgs, "HL404", "does not divide ref shape")


def test_hl404_index_map_out_of_range_caught():
    msgs = _msgs([pp.plan_fixture("clean", rows=8, in_rows=4, in_shift=1)])
    assert _has(msgs, "HL404", "outside the")


def test_hl404_uncovered_output_blocks_caught():
    msgs = _msgs([pp.plan_fixture("clean", rows=8, grid=1)])
    assert _has(msgs, "HL404", "never visited")


def test_hl404_exact_tiling_clean():
    assert _msgs([pp.plan_fixture("clean", rows=8, in_rows=4)]) == []


def test_hl404_output_tile_outside_the_array_caught():
    # Three blocks of 4-row strips over an 8-row output: the third writes
    # rows [8, 12).
    msgs = _msgs([pp.plan_fixture("clean", rows=8, grid=3)])
    assert _has(msgs, "HL404", "outside the")


# ---------------------------------------------------------------------------
# The Hopper-only fixtures
# ---------------------------------------------------------------------------

def test_hl403_expect_mismatch_caught():
    msgs = _msgs([pp.plan_fixture("expect_mismatch")])
    assert _has(msgs, "HL403", "expect_tx of")
    assert _has(msgs, "HL403", "differs from the")


def test_hl401_box_over_256_rows_caught():
    msgs = _msgs([pp.plan_fixture("clean_tma", rows=1024, n_strips=2)])
    assert _has(msgs, "HL401", "exceeds 256 cells")


def test_hl402_cooperative_grid_too_large_caught():
    fits = pk.blocks_per_sm(pp.plan_fixture("clean")) * 132
    ok = pp.plan_fixture("clean", rows=8 * fits, n_strips=fits,
                         cooperative=True)
    assert _msgs([ok]) == []
    big = pp.plan_fixture("clean", rows=8 * (fits + 1), n_strips=fits + 1,
                          cooperative=True)
    assert _has(_msgs([big]), "HL402", "does not fit the card at once")


def _sim(events):
    out = []
    pk.simulate(events, lambda rule, msg, soundness=False:
                out.append((rule, msg)))
    return out


def test_simulator_expect_tx_is_an_arrival():
    # Count 1: the expect_tx arrival and the box's bytes complete the
    # phase; one more arrival over-arrives.
    ok = [("mbar_init", "b", 1), ("expect_tx", "b", 64),
          ("tma", "s", "b", 64, (0, 0), 0), ("wait", "b", 0), ("read", "s")]
    assert _sim(ok) == []
    extra = ok[:2] + [("arrive", "b")] + ok[2:]
    assert any("more arrivals" in m for _, m in _sim(extra))


def test_simulator_noinc_arrivals_count_against_init():
    # F's cp.async load: 512 threads each arrive once their copies land,
    # against an init count of 512; a count of 513 never completes.
    fill = [("cp_async", "r0", 4096), ("cp_async_arrive_noinc", "b", 512)]
    ok = [("mbar_init", "b", 512)] + fill + [("wait", "b", 0), ("read", "r0")]
    assert _sim(ok) == []
    hang = [("mbar_init", "b", 513)] + ok[1:]
    assert any("never completes" in m for _, m in _sim(hang))


def test_simulator_box_counts_whole_bytes_and_parity():
    # A box's bytes are its whole extent; the second use of a slot waits
    # on parity 1, and parity 0 there would read before the data lands.
    def use(par):
        return [("expect_tx", "b", 64), ("tma", "s", "b", 64, (0, 0), 0),
                ("wait", "b", par), ("read", "s")]
    assert _sim([("mbar_init", "b", 1)] + use(0) + use(1)) == []
    bad = _sim([("mbar_init", "b", 1)] + use(0) + use(0))
    assert any("before its phase completed" in m for _, m in bad)


def test_simulator_wait_prior_leaves_group_in_flight():
    ev = [("cp_async", "a", 16), ("commit",), ("cp_async", "b", 16),
          ("commit",), ("wait_prior", 1), ("read", "b")]
    assert any("wait_prior leaves" in m for _, m in _sim(ev))
    assert _sim(ev[:4] + [("wait_prior", 0), ("read", "a"),
                          ("read", "b")]) == []


# ---------------------------------------------------------------------------
# The gate: every real plan clean, every kernel accounted for
# ---------------------------------------------------------------------------

def test_hl4xx_real_plans_clean_and_all_kernels_covered():
    plans = pp.default_plans()
    assert pk.audit_kernels(plans, check_coverage=False) == []
    active, stale = findings.apply_baseline(pk.audit_kernels(),
                                            findings.load_baseline())
    assert active == [] and stale == []
    names = pk.source_kernel_names()
    # 31 kernels, the bfloat16 forms of A, B, C, D, E, E-uni, F, I, I-uni,
    # M, G, G-circ, G-fuse, G-uni, the 2D band, H, H-fused and the 3D band
    # (a __global__ each), and the device loop's two one-thread helpers
    # (csrc/heat_graph_loop.cu, baselined).
    assert len(names) == 51 and "heat_probe_fixture_kernel" in names
    g_bf16 = {"heat_g_block_padded_bf16_kernel",
              "heat_g_block_circular_bf16_kernel",
              "heat_g_block_fused_bf16_kernel",
              "heat_g_block_uniform_bf16_kernel",
              "heat_g_band_fix_bf16_kernel",
              "heat_h_block_3d_bf16_kernel",
              "heat_h_block_3d_fused_bf16_kernel",
              "heat_h_band_fix_3d_bf16_kernel"}
    assert {"heat_a_resident_bf16_kernel", "heat_e_temporal_bf16_kernel",
            "heat_e_uni_temporal_bf16_kernel", "heat_b_step_bf16_kernel",
            "heat_c_tiled_bf16_kernel", "heat_i_tile_temporal_bf16_kernel",
            "heat_i_uni_tile_temporal_bf16_kernel",
            "heat_m_ensemble_bf16_kernel", "heat_d_step3d_bf16_kernel",
            "heat_f_temporal3d_bf16_kernel"} | g_bf16 <= set(names)
    assert g_bf16 <= {p.kernel for p in plans}
    assert {"heat_graph_set_cond_kernel", "heat_graph_window_kernel"} <= set(
        names)
    from parallel_heat_tpu_torch.kernels.build import KERNELS

    assert set(KERNELS) <= {p.entry for p in plans}


def test_plans_cover_every_k_the_pickers_admit():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    plans = pp.default_plans()
    ks = {e: {int(pl_.label.split("K=")[1].split()[0]) for pl_ in plans
              if pl_.entry == e and "K=" in pl_.label}
          for e in ("heat_e_temporal", "heat_e_uni_temporal",
                    "heat_g_block_fused", "heat_f_temporal3d")}
    assert ks["heat_e_temporal"] >= set(range(1, p.e_k_max() + 1))
    assert ks["heat_e_uni_temporal"] >= set(range(1, p.e_k_max() + 1))
    assert ks["heat_g_block_fused"] >= set(range(1, p.g_k_max() + 1))
    assert ks["heat_f_temporal3d"] >= {k for k in range(1, 9)
                                       if p.f_shape(k) is not None}
    bf16 = {int(pl_.label.split("K=")[1].split()[0]) for pl_ in plans
            if pl_.entry == "heat_f_temporal3d_bf16"}
    assert bf16 >= {k for k in range(1, 9) if p.f_shape(k, 2) is not None}
    h_bf16 = {e: {int(pl_.label.split("K=")[1].split()[0]) for pl_ in plans
                  if pl_.entry == e}
              for e in ("heat_h_block_3d_fused_bf16", "heat_h_block_3d_bf16",
                        "heat_h_band_fix_3d_bf16")}
    assert h_bf16["heat_h_block_3d_fused_bf16"] >= set(
        range(1, p.h_k_max() + 1))
    assert h_bf16["heat_h_block_3d_bf16"] >= set(range(1, p.hc_k_max(2) + 1))
    assert h_bf16["heat_h_band_fix_3d_bf16"] >= set(
        range(1, p.h_band_k_max(2) + 1))


def test_unproved_tile_class_is_a_soundness_finding():
    plan = pp.plan_e((1001, 999), 3)
    plan.kinds = dict(plan.kinds, imaginary=1)
    out = pk.audit_kernels([plan])
    assert any(f.soundness and "'imaginary'" in f.message for f in out)


def test_bulk_and_band_cover_the_block_once():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    k = params().g_k_default
    bulk = pp.plan_g("G-uni", (500, 252), k, defer=True)
    band = pp.plan_g("band", (500, 252), k)
    assert pk.audit_kernels([bulk, band]) == []
    # The bulk alone leaves the band's rows: fine for it, but a round of
    # bulk and bulk writes them never and the rest twice.
    twice = pp.plan_g("G-uni", (500, 252), k, defer=True)
    out = pk.audit_kernels([bulk, twice])
    assert any("written by 2 blocks" in f.message for f in out)


@pytest.mark.parametrize("grid,mesh,k", [((32768, 32768), (2, 4), 8),
                                         ((1000, 1000), (2, 4), 8),
                                         ((1000, 1000), (2, 4), 3),
                                         ((32, 48), (2, 2), 8),
                                         ((32, 48), (2, 2), 3)])
def test_batched_band_plan_covers_every_block_once(grid, mesh, k):
    """The band kernel's launch over a round's blocks: with each block's
    deferred bulk every output cell once (a 16 x 24 block at K = 8 is all
    bands), its grid (column tiles, 2 regions, blocks) and shared memory
    a block; an entry given twice writes its bands twice."""
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    origins = pp.mesh_block_origins(grid, mesh)
    block = tuple(n // d for n, d in zip(grid, mesh))
    kind = "G-uni" if block[1] % 4 == 0 else "G-fuse"
    bulks = [pp.plan_g(kind, block, k, o, grid, defer=True) for o in origins]
    band = pp.plan_g_band(block, k, origins, grid)
    assert pk.audit_kernels(bulks + [band]) == []
    assert len(pp.coverage_groups(bulks + [band])) == len(origins)
    col_tiles = -(-block[1] // p.g_band_tile_x)
    assert [a.count for a in band.axes] == [len(origins), 2, col_tiles]
    assert band.grid == len(origins) * 2 * col_tiles
    assert band.threads == p.g_band_block[0] * p.g_band_block[1]
    assert band.dyn_smem == p.g_smem_bytes(k, (k, p.g_band_tile_x))
    assert band.arrays["out"].shape == (len(origins),) + block
    twice = pp.plan_g_band(block, k, origins + origins[:1], grid)
    out = pk.audit_kernels(bulks + [twice])
    assert any("written by 2 blocks" in f.message for f in out)
    # The 16-byte row load where the geometry takes it (K even, widths a
    # multiple of 4), else the per-cell load alone.
    assert ("rows" in band.loads) == (block[1] % 4 == 0 and k % 2 == 0)


def test_band_row_load_plan_catches_a_misaligned_piece_row():
    """The row load's 16-byte copies need piece rows of a multiple of 4
    floats: the audit flags halo rows of by + 2k = 30 floats."""
    import dataclasses

    origins = pp.mesh_block_origins((32, 48), (2, 2))
    band = pp.plan_g_band((16, 24), 8, origins, (32, 48))
    assert band.loads["rows"].kind == "cp16"
    assert pk.audit_kernels([band]) == []
    bad = dataclasses.replace(band, arrays={
        **band.arrays, "pieces": pp.Array((4, 32, 30))})
    out = pk.audit_kernels([bad])
    assert any(f.rule == "HL401" and "16-byte" in f.message for f in out)


def test_kernels_layer_runs_in_under_30_s():
    import time

    t0 = time.perf_counter()
    pk.run_kernels()
    assert time.perf_counter() - t0 < 30


# ---------------------------------------------------------------------------
# Plans agree with the wrappers (their factored geometry, not a launch)
# ---------------------------------------------------------------------------

def _grid_2d(m, n, tile):
    return -(-m // tile[0]) * -(-n // tile[1])


def test_plan_e_uni_main_path_is_the_wrappers():
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    plan = pp.plan_e((16384, 16384), p.e_k_default, uni=True)
    # heat_e_uni_launch: 4 (2 sy sx) + 128 + 8 bytes; heat_e_geometry's
    # grid; a (TY + 2K) x row_floats box.
    ty, tx = p.e_tile
    sy, sx = ty + 16, p.row_floats(8, tx)
    assert plan.dyn_smem == 4 * 2 * sy * sx + 136
    assert plan.grid == _grid_2d(16384, 16384, p.e_tile)
    assert plan.loads["box"].box == (sy, sx) == (112, 128)
    assert plan.threads == p.e_block[0] * p.e_block[1]


def test_plan_a_main_path_is_the_wrappers():
    from parallel_heat_tpu_torch.ops.stencil_kernels import a_launch
    from parallel_heat_tpu_torch.ops.hopper_params import params

    launch = a_launch((1000, 1000))
    plan = pp.plan_a((1000, 1000))
    d, (ty, tx) = launch["depth"], launch["tile"]
    assert plan.dyn_smem == 8 * (ty + 2 * d) * params().row_floats(d, tx)
    assert plan.grid == _grid_2d(1000, 1000, (ty, tx)) <= 132
    assert plan.cooperative


@pytest.mark.parametrize("load", ["tma", "cp.async"])
def test_plan_f_main_path_is_the_wrappers(load):
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil_kernels_3d import f_geometry

    p = params()
    block, rows, prefetch, seg = f_geometry((512, 512, 512), 3)
    plan = pp.plan_f((512, 512, 512), 3, load)
    wy = block[1] * rows
    # heat_f_launch: tiles along Z of 128 - 2 pad(K), along Y of wy - 2K,
    # segments of seg planes; heat_f_smem_bytes.
    grid = (-(-512 // (128 - 2 * p.f_pad(3))) * -(-512 // (wy - 6))
            * -(-512 // seg))
    assert plan.grid == grid
    assert plan.dyn_smem == (4 * ((prefetch + 2) * (wy + 2) * 128
                                  + 2 * 2 * ((min(rows, 2) * block[1] + 2)
                                             * 128))
                             + 128 + 8 * (prefetch + 2))
    assert plan.threads == 32 * block[1]


def test_plan_m_and_g_and_h_main_paths_are_the_wrappers():
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil_kernels_block import (
        _block_geometry)
    from parallel_heat_tpu_torch.ops.stencil_kernels_block_3d import (
        _geometry)

    p = params()
    mp = p.m_plan(64, (512, 512))
    m = pp.plan_m(64, (512, 512), 400)
    assert m.grid == mp["groups"] * mp["tiles"]
    assert m.dyn_smem == p.loop_smem_bytes(mp["depth"], mp["tile"])
    ty, tx, bx, by = _block_geometry()
    g = pp.plan_g("G-uni", (16384, 8192), 8, defer=True)
    assert g.grid == -(-(16384 - 16) // ty) * -(-8192 // tx)
    assert g.threads == bx * by
    bz, byt, rows, seg = _geometry((512, 512, 512), 3, 512)
    h = pp.plan_h("H-fuse", (512, 512, 512), 3, load="tma")
    wy = byt * rows
    assert h.grid == (-(-512 // seg) * -(-512 // (wy - 6))
                      * -(-512 // (bz - 6)))
    assert h.dyn_smem == max(p.h_smem_bytes(3), p.h_tma_smem_bytes(3))


@pytest.mark.parametrize("uni", [False, True])
@pytest.mark.parametrize("form", [0, 1, 2, 3])
def test_plan_i_forms_are_the_wrappers(form, uni):
    # BASELINE config 4's 32768^2 at the pinned runs' depth: the entry and
    # __global__ of the form, the ring of the input's cells (136 bfloat16
    # a row from 16 bytes of the grid's row, stages on 128 bytes), I-uni's
    # box of the whole row, I's tested loads, the dtypes in and out.
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    plan = pp.plan_i((32768, 32768), p.i_k_default, uni, form=form)
    elem_in, elem_out = (4 if form == 3 else 2), (4 if form == 2 else 2)
    entry = ("heat_i_uni_tile_temporal_bf16" if uni
             else "heat_i_tile_temporal_bf16")
    assert (plan.entry, plan.kernel) == (entry, entry + "_kernel")
    assert plan.dyn_smem == p.i_smem_bytes(p.i_warps, p.i_rows,
                                           p.i_stages, elem_in)
    assert (plan.arrays["u"].elem, plan.arrays["out"].elem) == (elem_in,
                                                               elem_out)
    load = plan.loads["row"]
    cols = 136 if elem_in == 2 else 128
    assert load.cell_bytes == elem_in and load.pitch == (cols,)
    if uni:
        assert load.kind == "tma" and load.box == (p.i_rows, cols)
    else:
        assert load.kind == ("ld" if elem_in == 2 else "cp4")
    assert p.i_stage_bytes(p.i_rows, elem_in) % 128 == 0
    assert pk.audit_kernels([plan], check_coverage=False) == []


@pytest.mark.parametrize("fault", ["unshifted box", "256-byte rows"])
def test_plan_i_bf16_audit_catches_a_box_off_16_bytes_or_past_its_stage(
        fault):
    # At K <= 4 a band starts 4 cells past 16 bytes: a box from the band's
    # own first cell faults on the card, and a ring of 128-cell rows is
    # too short for the 136-cell box.
    import dataclasses

    plan = pp.plan_i((200, 136), 3, True, form=0)
    assert pk.audit_kernels([plan], check_coverage=False) == []
    if fault == "unshifted box":
        bands = plan.axes[1]

        def unshifted(b, span=bands.span):
            s = span(b)
            start, ext, guard = s.reads["row"]
            return dataclasses.replace(s, reads={"row": (start + 4, ext,
                                                         guard)})

        plan.axes[1] = pp.Axis(bands.name, bands.count, unshifted)
        phrase = "not on 16"
    else:
        rows = plan.loads["row"].box[0]
        plan.slots = {name: ((off, rows * 256) if name.startswith("ring")
                             else (off, size))
                      for name, (off, size) in plan.slots.items()}
        phrase = "past its shared buffer"
    assert any(phrase in f.message
               for f in pk.audit_kernels([plan], check_coverage=False))


@pytest.mark.parametrize("load", ["cp.async", "tma"])
def test_plan_h_bf16_loads_are_the_wrappers(load):
    # H-fused's bfloat16 form at the main path's 512^3 block, K = 3, under
    # each load: its own loop's shared memory (staging slots, three ring
    # planes, the levels, an mbarrier a slot), a bfloat16 box 8 cells
    # wider than the extended tile under "tma", each cell's 4-byte word by
    # cp.async into the staging slots; clean, and a schedule without its
    # commit-group wait caught.
    import dataclasses

    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    plan = pp.plan_h("H-fuse", (512, 512, 512), 3, (512, 512, 512),
                     (1024,) * 3, load=load, bf16=True)
    assert (plan.entry, plan.kernel) == ("heat_h_block_3d_fused_bf16",
                                         "heat_h_block_3d_fused_bf16_kernel")
    assert plan.dyn_smem == p.h_bf16_smem_bytes(3)
    assert p.h_bf16_smem_bytes(3) < min(p.h_smem_bytes(3),
                                        p.h_tma_smem_bytes(3))
    box = plan.loads.get("box")
    assert (box is not None) == (load == "tma")
    if box is not None:
        assert (box.kind, box.box, box.cell_bytes) == ("tma", (1, 64, 40), 2)
    cells = plan.loads["plane"]
    assert (cells.kind, cells.slot, cells.cell_bytes) == ("cp4", "stage", 4)
    assert sorted(n for n in plan.slots if n.startswith("stage")) == [
        f"stage{i}" for i in range(p.h_tma_prefetch)]
    assert pk.audit_kernels([plan], check_coverage=False) == []
    inner = plan.schedule
    plan = dataclasses.replace(plan, schedule=lambda spans: [
        e for e in inner(spans) if e[0] != "wait_prior"])
    assert any(f.rule == "HL403"
               for f in pk.audit_kernels([plan], check_coverage=False))


# The transfer plans: the 512^2 hierarchy's top and bottom pairs, a
# ragged (odd x odd) fine interior with an odd fine pitch in a stack of
# three, and an even x odd one.
MG_PLAN_CASES = [((512, 512), (257, 257), 1), ((9, 9), (5, 5), 1),
                 ((21, 23), (11, 12), 3), ((35, 1030), (18, 516), 3),
                 ((4098, 4098), (2050, 2050), 1)]


def test_transfer_plans_take_the_whole_512_hierarchy():
    from parallel_heat_tpu_torch.config import multigrid_level_shapes

    path = multigrid_level_shapes((512, 512))
    assert tuple(map(tuple, path)) == pp.MG_PATH
    labels = {p_.label for p_ in pp.default_plans()}
    for fine, coarse in zip(path[:-1], path[1:]):
        f, c = "x".join(map(str, fine)), "x".join(map(str, coarse))
        assert f"restrict {f} -> {c}" in labels
        assert f"prolong {c} -> {f}" in labels


@pytest.mark.parametrize("fine,coarse,batch", MG_PLAN_CASES)
def test_transfer_plans_are_the_launch_records(fine, coarse, batch):
    """Each plan's grid, threads, cover, windows and 32-bit indices are
    the launch record's (``ops/multigrid.py`` ``TransferLaunch``) and the
    kernel's: restrict ``mg_restrict_cells`` coarse cells a thread, each
    reading its clamped fine window; prolong a coarse cell a thread,
    writing 2 x 2 fine cells from coarse lines t, t + 1."""
    from parallel_heat_tpu_torch.ops import multigrid as mg
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    cy, cx = p.mg_restrict_cells(coarse)
    for name, plan, src, dst in (
            (mg.RESTRICT, pp.plan_restrict(fine, coarse, batch), fine,
             coarse),
            (mg.PROLONG, pp.plan_prolong(coarse, fine, batch), coarse,
             fine)):
        rec = mg.TransferLaunch(name, (batch,), src, dst, "cuda:0")
        gx, gy = rec.grid
        assert plan.grid == batch * gx * gy
        assert plan.threads == rec.block[0] * rec.block[1]
        assert [a.count for a in plan.axes] == [batch, gy, gx]
        assert plan.arrays["out"].shape == (batch,) + tuple(dst)
        assert plan.cover == [((0, batch), (0, dst[0]), (0, dst[1]))]
        rows, cols = plan.axes[1], plan.axes[2]
        last_r, last_c = rows.span(gy - 1), cols.span(gx - 1)
        assert last_r.write[1] == dst[0] and last_c.write[1] == dst[1]
        if name == mg.RESTRICT:
            tile = (rec.block[1] * cy, rec.block[0] * cx)
            assert rows.span(0).write == (0, min(tile[0], dst[0]))
            # Coarse cells [lo, hi) read fine lines 2 lo - 1 .. 2 hi - 1,
            # clamped into the fine array.
            assert rows.span(0).reads["src"] == (
                -1, 2 * min(tile[0], dst[0]) + 1, (0, src[0]))
            assert last_c.reads["src"][0] == 2 * last_c.write[0] - 1
            assert dict(plan.int32)["fine row 2 i0 + 2 cy - 1"] == (
                2 * (dst[0] - 1) + 2 * cy - 1)
        else:
            tile = (2 * rec.block[1], 2 * rec.block[0])
            assert rows.span(0).write == (0, min(tile[0], dst[0]))
            # Fine lines [lo, hi) come from coarse lines lo / 2 ..
            # (hi - 1) / 2 + 1, the last clamped to the coarse ring.
            lo, hi = last_r.write
            assert last_r.reads["src"] == (lo // 2, (hi - 1) // 2 - lo // 2
                                           + 2, (0, src[0]))
            assert dict(plan.int32)["fine row 2t + 1"] == (
                2 * gy * rec.block[1] - 1)
        assert pk.audit_kernels([plan]) == []


def test_transfer_plan_audit_catches_a_short_grid_and_an_unclamped_read():
    import dataclasses

    plan = pp.plan_prolong((11, 12), (21, 23), batch=3)
    short = dataclasses.replace(plan, axes=[
        plan.axes[0], plan.axes[1],
        pp.Axis("cols", plan.axes[2].count - 1, plan.axes[2].span)])
    assert _has(_msgs([short]), "HL404", "never visited")
    rows = plan.axes[1]

    def unclamped(i):
        s_ = rows.span(i)
        return pp.Span(s_.write, {"src": s_.reads["src"][:2] + (None,)})
    bad = dataclasses.replace(plan, axes=[
        plan.axes[0], pp.Axis("rows", rows.count, unclamped), plan.axes[2]])
    assert _has(_msgs([bad]), "HL401", "out of bounds")


def test_load_records_of_f_follow_the_ring():
    plan = pp.plan_f((24, 20, 28), 3, "tma")
    recs = pk.load_records(plan, (0, 0, 0))
    slots = plan.loads["plane"]
    assert slots.kind == "tma"
    n_slots = sum(1 for s in plan.slots if s.startswith("ring"))
    assert [r[2] for r in recs] == list(range(-3, 24 + 3))
    assert [r[5] for r in recs] == [i % n_slots for i in range(len(recs))]
    assert [r[6] for r in recs] == [(i // n_slots) & 1
                                    for i in range(len(recs))]
    assert all(r[3] == r[4] for r in recs)
    cp = pk.load_records(pp.plan_f((24, 20, 28), 3, "cp.async"), (0, 0, 0))
    assert [r[:4] + r[5:] for r in cp] == [r[:4] + r[5:] for r in recs]
    assert all(r[4] == 0 for r in cp)


def _chip_smoke():
    import importlib

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("chip_smoke")


def _card_record(expect_recs, tma, expect_delta=0):
    """A record buffer as a record variant writes it for ``expect_recs``
    (load_records' tuples): the bytes the block's own copies move (0 for
    a TMA box) and the kernel's expect_tx, off by ``expect_delta``."""
    words = [0]
    for c0, c1, c2, nbytes, exp, slot, parity in expect_recs:
        words += [c0, c1, c2, 0 if tma else nbytes,
                  exp + expect_delta if tma else exp, slot, parity, 1]
    return torch.tensor(words, dtype=torch.int32)


@pytest.mark.parametrize("kernel", ["E-uni", "F tma", "F cp.async"])
def test_record_check_holds_expect_tx_to_the_encoded_box(kernel):
    """chip_smoke's record check: the bytes a TMA load lands are the box
    its launch encodes, not the kernel's expect_tx again; so an expect_tx
    that differs from the box, or a box that differs from the plan's,
    fails the comparison."""
    cs = _chip_smoke()
    if kernel == "E-uni":
        plan = pp.plan_e((1001, 999), 4, uni=True)
        box = tuple(reversed(plan.loads["box"].box)) + (1,)
    else:
        load = kernel.split()[1]
        plan = pp.plan_f((24, 20, 28), 3, load)
        box = tuple(reversed(plan.loads["plane"].box))
    tma = kernel != "F cp.async"
    idx = tuple(a.count - 1 for a in plan.axes)
    want = pk.load_records(plan, idx)
    n = len(want)
    enc = box if tma else None
    got, m = cs._records_of(_card_record(want, tma), 0, n, enc)
    assert got == want and m == n
    if tma:
        off, _ = cs._records_of(_card_record(want, tma, 16), 0, n, enc)
        assert off != want
        short = (box[0], box[1] - 1) + box[2:]
        wrong, _ = cs._records_of(_card_record(want, tma), 0, n, short)
        assert wrong != want


# ---------------------------------------------------------------------------
# The fixture kernel's path on the CPU
# ---------------------------------------------------------------------------

def test_fixture_matches_the_jax_strip_call_bitwise():
    u = np.random.default_rng(5).standard_normal((16, _N)).astype(
        np.float32)
    want = np.asarray(_strip_call(_clean_kernel, interpret=True)(
        jnp.asarray(u)))
    t = torch.from_numpy(u)
    plain = af.strip_double_plain(t).numpy()
    for variant in ("clean", "clean_tma"):
        got = af.strip_double(t, variant).numpy()
        assert np.array_equal(got, want)
    assert np.array_equal(plain, want)


def test_fixture_runtime_window_doubles_one_window():
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (16, _N)).astype(np.float32))
    got = af.strip_double(u, "runtime_window", off=5)
    assert torch.equal(got[:8], u[5:13] * 2) and torch.equal(got[8:],
                                                              u[5:13] * 2)


@pytest.mark.parametrize("variant", [v for v in pp.FIXTURE_VARIANTS
                                     if v not in af.LAUNCHED])
def test_fixture_refuses_seeded_variants(variant):
    with pytest.raises(ValueError, match="never launched"):
        af.strip_double(torch.zeros(16, _N), variant)


def test_fixture_smem_is_the_plans():
    plan = pp.plan_fixture("clean_tma", 262144, n_strips=32768)
    assert plan.dyn_smem == pp.fixture_smem_bytes(8) == 2 * 4 * 8 * 128 + 136
    assert plan.grid == 32768 and _msgs([plan]) == []


# ---------------------------------------------------------------------------
# Parity with JAX: baseline, rendering, the AST rules
# ---------------------------------------------------------------------------

def _pair(mod, rule="HL205", file="pkg/m.py", symbol="<module>"):
    return mod.Finding(rule, "error", file, 3, symbol, "msg")


def test_baseline_and_render_parity(tmp_path):
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "HL205", "file": "pkg/m.py", "symbol": "<module>",
         "justification": "kept: re-export"},
        {"rule": "HL203", "file": "pkg/gone.py", "symbol": "build",
         "justification": "kept: historical"}]}))
    out = []
    for mod in (jfind, findings):
        fs = [_pair(mod), _pair(mod, file="pkg/n.py"),
              _pair(mod, "HL401", "pkg/k.py", "A/heat_a")]
        active, stale = mod.apply_baseline(fs, mod.load_baseline(str(bl)))
        out.append(([f.to_dict() for f in active], stale,
                    mod.render_findings(active, stale)))
    assert out[0] == out[1]


def test_jax_baseline_file_loads_in_the_port():
    path = os.path.join(ROOT, "heatlint.baseline.json")
    assert (findings.load_baseline(path).entries
            == jfind.load_baseline(path).entries)


_AST_FIXTURES = {
    "hl201_region": """
        import jax

        def loop(step, u):
            def _dispatch():  # heatlint: dispatch-region
                v = step(u)
                jax.block_until_ready(v)     # serializes the pipeline
                r = float(v[0, 0])           # host scalar read
                return v, r
            return _dispatch()
    """,
    "hl201_markers": """
        import time

        def run(step, u):
            u = step(u)
            # heatlint: begin dispatch-region
            time.sleep(0.1)
            # heatlint: end dispatch-region
            time.sleep(0.2)   # outside: fine
    """,
    "hl201_dangling": """
        import jax

        def run(step, u):
            # heatlint: begin dispatch-region
            u = step(u)
            jax.block_until_ready(u)
            return u
    """,
    "hl201_outside": """
        import jax

        def loop(step, u):
            v = step(u)
            jax.block_until_ready(v)   # no dispatch region here
            return float(v[0, 0])
    """,
    "hl201_async": """
        def loop(step, u, pending):
            def _dispatch():  # heatlint: dispatch-region
                v = step(u)
                v.copy_to_host_async()
                pending.append(v)
                return v
            return _dispatch()
    """,
    "hl204_unlocked": """
        import threading

        class Sink:
            def __init__(self):
                self._lock = threading.Lock()
                self.events = []
                self.dead = False

            def emit(self, rec):
                with self._lock:
                    self.events.append(rec)
                    self.dead = False

            def kill(self):
                self.dead = True
    """,
    "hl204_locked": """
        import threading

        class Sink:
            def __init__(self):
                self._lock = threading.Lock()
                self.events = []

            def emit(self, rec):
                with self._lock:
                    self.events.append(rec)

            def snapshot(self):
                return list(self.events)
    """,
    "hl204_lockless": """
        class Stats:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
    """,
    "hl205_unused": """
        import os
        import json

        def dump(x):
            return json.dumps(x)
    """,
    "hl205_noqa": """
        import os  # noqa: F401 — re-exported for callers
    """,
    "hl203_bad_names": """
        import jax
        from jax.experimental import pallas as pl

        def build_anon(kernel, shape):
            return pl.pallas_call(
                kernel, out_shape=jax.ShapeDtypeStruct(shape, "float32"))

        def build_misnamed(kernel, shape):
            return pl.pallas_call(
                kernel, name="stencil_2d",
                out_shape=jax.ShapeDtypeStruct(shape, "float32"))
    """,
    "hl203_heat_name": """
        import jax
        from jax.experimental import pallas as pl

        def build(kernel, shape):
            return pl.pallas_call(
                kernel, name="heat_tile_2d",
                out_shape=jax.ShapeDtypeStruct(shape, "float32"))
    """,
}


@pytest.mark.parametrize("name", sorted(_AST_FIXTURES))
def test_lint_file_parity_with_jax(tmp_path, name):
    path = _fixture(tmp_path, name + ".py", _AST_FIXTURES[name])
    rule = name[:5].upper()
    mine = [(f.rule, f.line, f.symbol) for f in astlint.lint_file(path)
            if f.rule == rule]
    theirs = [(f.rule, f.line, f.symbol) for f in jast.lint_file(path)
              if f.rule == rule]
    assert mine == theirs
    expect_hits = name not in ("hl201_outside", "hl201_async",
                               "hl204_locked", "hl204_lockless",
                               "hl205_noqa", "hl203_heat_name")
    assert bool(mine) == expect_hits


def test_hl201_torch_blocking_calls(tmp_path):
    path = _fixture(tmp_path, "t201.py", """
        import torch

        def timed(fn, reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            # heatlint: begin dispatch-region
            for _ in range(reps):
                r = fn()
                r.item()
                r.cpu()
                r.tolist()
                torch.cuda.synchronize()
                torch.cuda.current_stream().synchronize()
                bool(r)
            end.record()
            # heatlint: end dispatch-region
            end.synchronize()
            return start.elapsed_time(end)
    """)
    lines = sorted(f.line for f in astlint.lint_file(path)
                   if f.rule == "HL201")
    assert lines == [11, 12, 13, 14, 15, 16]


@pytest.mark.parametrize("call,hits", [
    ("r.to('cpu')", 1),
    ("r.to('cpu:0')", 1),
    ("r.to(torch.device('cpu'))", 1),
    ("r.to(device='cpu')", 1),
    ("r.to(cpu)", 1),
    ("r.to(self_cpu, torch.float64)", 1),
    ("r.to('cpu', non_blocking=True)", 0),
    ("r.to(torch.device('cpu'), non_blocking=True)", 0),
    ("r.to('cuda')", 0),
    ("r.to(torch.float64)", 0),
    ("synchronize()", 1),
    ("done.synchronize()", 1),
    ("done.query()", 0),
])
def test_hl201_torch_host_copies_and_bare_waits(tmp_path, call, hits):
    # A copy to the host waits for the device unless it is non-blocking;
    # an event's wait, imported or bound to a bare name, waits too.
    path = _fixture(tmp_path, "t201c.py", f"""
        import torch

        def dispatch(fn, done, cpu, self_cpu, synchronize):
            # heatlint: begin dispatch-region
            r = fn()
            {call}
            # heatlint: end dispatch-region
            return r
    """)
    lines = [f.line for f in astlint.lint_file(path) if f.rule == "HL201"]
    assert lines == [7] * hits


def test_hl201_repo_timers_marked_and_clean():
    # The timed loops carry dispatch-region markers; their timers'
    # closing syncs lie outside them.
    for rel in ("parallel_heat_tpu_torch/bench_kernels.py",
                "parallel_heat_tpu_torch/tools/probing.py",
                "parallel_heat_tpu_torch/solver.py"):
        path = os.path.join(ROOT, rel)
        with open(path) as f:
            src = f.read()
        regions, _ = astlint._dispatch_regions(ast.parse(src),
                                               src.splitlines(), path)
        assert regions
        assert [f for f in astlint.lint_file(path) if f.rule == "HL201"] == []


@pytest.mark.parametrize("src,hits", [
    ("""
        import time
        import torch

        @torch.compile
        def step(u):
            t0 = time.perf_counter()
            return u * 2.0
    """, 1),
    ("""
        import random
        import torch

        def run(u, g):
            with torch.cuda.graph(g):
                v = u * random.random()
            return v
    """, 1),
    ("""
        import time
        import torch

        def run(u):
            t0 = time.perf_counter()
            return torch.jit.script(lambda x: x * 2.0)(u), t0
    """, 0),
])
def test_hl202_traced_torch_code(tmp_path, src, hits):
    path = _fixture(tmp_path, "t202.py", src)
    assert len([f for f in astlint.lint_file(path)
                if f.rule == "HL202"]) == hits


def test_hl203_hopper_kernel_names(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text(textwrap.dedent("""
        // __global__ void comment_only(int x);
        template <int K>
        __global__ void __launch_bounds__(kLanes * f(K))
        stencil_kernel(const float* u) {}
        __global__ void heat_good_kernel(const float* u) {}
        extern "C" int heat_good(const float* u) { return 0; }
        extern "C" const char* heat_good_error_string(int code);
    """))
    out = astlint.lint_file(str(csrc / "k.cu"))
    assert [(f.rule, f.symbol) for f in out] == [("HL203",
                                                  "stencil_kernel")]
    assert astlint.cuda_extern_c(str(csrc / "k.cu")) == {"heat_good": 7}
    kern = tmp_path / "kernels"
    kern.mkdir()
    build_py = kern / "build.py"
    build_py.write_text(textwrap.dedent("""
        KERNELS = {"heat_good": ("k.cu", []),
                   "heat_missing": ("k.cu", []),
                   "heat_nofile": ("nowhere.cu", [])}
        TOOLS = {}
    """))
    bad = {f.message.split("'")[1] for f in astlint.lint_file(str(build_py))
           if f.rule == "HL203"}
    assert bad == {"heat_missing", "heat_nofile"}


def test_hl203_every_port_kernel_named_and_bound():
    paths = [os.path.join(ROOT, "parallel_heat_tpu_torch", p)
             for p in ("csrc", "kernels/build.py")]
    assert astlint.lint_paths(paths, rules={"HL203"}) == []


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _port_cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "parallel_heat_tpu_torch.tools.heatlint",
         *args], capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "PYTHONPATH": ROOT})


def _jax_cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "heatlint.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def _rows(doc):
    return sorted((f["rule"], f["file"], f["line"], f["symbol"],
                   f["message"]) for f in json.loads(doc)["findings"])


def test_cli_seeded_directory_parity_with_jax(tmp_path):
    _fixture(tmp_path, "seeded.py", """
        import os

        def build(kernel, pl, jax):
            return pl.pallas_call(
                kernel, out_shape=jax.ShapeDtypeStruct((8, 8), "float32"))
    """)
    args = ("--layer", "ast", "--no-baseline", "--json", str(tmp_path))
    mine, theirs = _port_cli(*args), _jax_cli(*args)
    assert mine.returncode == theirs.returncode == 2
    assert _rows(mine.stdout) == _rows(theirs.stdout)
    assert {r[0] for r in _rows(mine.stdout)} == {"HL203", "HL205"}
    rel = str(tmp_path / "seeded.py")
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "HL203", "file": rel, "symbol": "build",
         "justification": "probe kernel, profiler name irrelevant"},
        {"rule": "HL205", "file": rel, "symbol": "<module>",
         "justification": "kept for doctest"}]}))
    args = ("--layer", "ast", "--baseline", str(bl), str(tmp_path))
    assert _port_cli(*args).returncode == _jax_cli(*args).returncode == 0
    (tmp_path / "seeded.py").write_text("x = 1\n")
    mine, theirs = _port_cli(*args), _jax_cli(*args)
    assert mine.returncode == theirs.returncode == 0
    assert (mine.stdout.count("stale baseline entry")
            == theirs.stdout.count("stale baseline entry") == 2)


def test_cli_gate_is_clean_and_runs_both_layers():
    out = _port_cli("--fail-on", "error", "--json")
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["schema_version"] == 2 and doc["findings"] == []
    assert doc["layers"] == ["ast", "kernels"]
    assert doc["timings"]["kernels"] < 30


def test_cli_refuses_jaxpr_layers():
    for layer in ("trace", "spmd", "ast,spmd"):
        out = _port_cli("--layer", layer)
        assert out.returncode == 1
        assert "queue 1 item 14" in out.stderr


def test_cli_list_rules_and_unknown_rule():
    out = _port_cli("--list-rules")
    assert out.returncode == 0
    assert all(rid in out.stdout for rid in ALL_RULES)
    bad = _port_cli("--rules", "HL999")
    assert bad.returncode == 1 and "unknown rule" in bad.stderr


def test_cli_sarif_and_strict_baseline(tmp_path):
    _fixture(tmp_path, "seeded.py", "import os\n")
    out = _port_cli("--layer", "ast", "--no-baseline", "--format", "sarif",
                    str(tmp_path))
    assert out.returncode == 2
    doc = json.loads(out.stdout)
    assert doc["runs"][0]["results"][0]["ruleId"] == "HL205"
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "HL204", "file": str(tmp_path / "seeded.py"),
         "symbol": "X.y", "justification": "kept"}]}))
    out = _port_cli("--layer", "ast", "--baseline", str(bl), "--rules",
                    "HL204", "--strict-baseline", str(tmp_path))
    assert out.returncode == 2


def test_cli_works_from_any_cwd(tmp_path):
    paths = astlint.default_scan_paths()
    assert paths and all(p.startswith(astlint.REPO_ROOT) for p in paths)
    out = _port_cli("--layer", "ast", "--fail-on", "error", cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "heatlint.baseline.json" in out.stdout


def test_layer_registry_partitions_all_rules():
    seen = {}
    for name, (table, _run) in LAYERS.items():
        for rid in table:
            assert rid not in seen
            seen[rid] = name
    assert set(seen) == set(ALL_RULES)
    assert layer_of("HL205") == "ast" and layer_of("HL404") == "kernels"
    assert layer_of("HL101") == "?"
