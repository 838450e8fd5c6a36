#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX and nothing of ``parallel_heat_tpu``. It
prints the card's name and power limit, then one JSON line per phase:

1. build — every kernel of the main path is built from ``csrc/`` with
   nvcc for sm_90a (one nvcc per source, started together), timed, with
   the ptxas register/shared-memory report;
2. kernels — each kernel against its plain PyTorch version on the card,
   bitwise, with cx = cy = 0.1 and, where marked, also cx=0.1, cy=0.2
   (so a swap of the axes cannot pass). The one-step kernels B
   (``heat_b_step``) and C (``heat_c_tiled``, also against B) at 4096^2,
   a ragged 1001x999 (both pairs), the converge path's 1000^2 (both)
   and the main path's 16384^2. The K-step kernels E
   (``heat_e_temporal``), E-uni (``heat_e_uni_temporal``), I
   (``heat_i_tile_temporal``) and I-uni (``heat_i_uni_tile_temporal``;
   the uniform ones on the widths that are multiples of 4) against K
   launches of B and their plain versions: K in {1, 3, K_default} on
   4096^2 and 1001x999, K in {4, K_default} with the residual on 1000^2
   (the launches of a 20-step converge window) and K_default on
   16384^2. A (``heat_a_resident``)
   likewise at K in {1, 4, 7, 20} on 1000^2 (20 = one converge window,
   its launch on the main path; 7 ends in a part group of steps), K = 20
   on 1001x999 and on 1800^2 (near the largest grid it takes), and K in
   {1, 7, 20} on 107x210, whose last tiles are narrower than two halo
   depths (both pairs). Last a NaN-seeded grid, which must give a NaN
   residual from every kernel with the boundary intact;
2b. kernels_3d — D (``heat_d_step3d``) against its plain version and F
   (``heat_f_temporal3d``) at K in {1, 3, K_default, K_max}, with and
   without the residual, against K launches of D and its plain version,
   all bitwise, on the main path's 512^3, a ragged 67x130x201 and a
   5x3x300 slab thinner than one tile (these two also with cx, cy, cz =
   0.1, 0.15, 0.05); a NaN-seeded grid (NaN residual, faces intact); and
   1291x1299x1301, past 2^31 cells, F(K_default) against K_default
   launches of D only;
3. main path — ``solve(HeatConfig(nx=16384, ny=16384, steps=200))``
   with the default pick (kernel E-uni) and again under
   ``tune.force("single_2d", ...)`` for E, I, I-uni, B and C: launch
   counts reset just before each run and read just after (the run's
   kernel > 0, the other kernels and every plain version 0), all six
   grids bitwise equal; and a 256^2 run under A (its default) and each
   other kernel, held against a float64 reference and bitwise against
   the CPU's plain versions;
3b. main_path_3d — ``solve(HeatConfig(nx=512, ny=512, nz=512,
   steps=200))`` under the default pick (kernel F) and forced D
   (``tune.force("single_3d", "D")``), counted as in phase 3, the two
   grids bitwise equal; and 64^3 under each, bitwise against the CPU's
   plain versions and within the few-ulp contract of a float64
   reference;
4. converge — 1000^2, steps=10000, check_interval=20, eps=1e-3 under the
   default pick (kernel A) and each other kernel forced: steps_run,
   converged, the residual and the grid identical; the same grid in
   fixed mode (10000 steps, one launch of A) under A and E-uni; and 20^2
   with eps=1e-3, which converges at step 1980, under each kernel
   against the CPU's plain versions. The default runs of this phase and
   of the main path are repeated once under ``torch.profiler`` for the
   card's busy time, and so its idle share;
4b. converge_3d — 10^3 with eps=1e-3, which converges at step 360 on
   the CPU, under F and D: steps_run, converged, the residual and the
   grid equal to the CPU's plain run;
5. cli — ``python -m parallel_heat_tpu_torch --nx 256 --ny 256 --steps
   500 --out <tmp>.dat``, whose file must read back to the solver's
   grid, and ``--nx 64 --ny 64 --nz 64 --steps 100 --out <tmp>.npy``,
   whose array must equal the solver's grid;
6. timing — each kernel, its plain version and a PyTorch yardstick
   (``conv2d`` with the 5-point weights, TF32 off; it computes the
   interior update only) with CUDA events, at the shape and depth of the
   kernel's launch on the main path: B, C, E, E-uni, I and I-uni at
   16384^2, A at 1000^2 with K = 20, D and F (K_default) at 512^3 with
   ``conv3d`` and its 7-point weights as the yardstick. Events around
   back-to-back
   launches time the host when it is the slower side (A's 20-step launch
   at 1000^2 takes about as long on the card as its wrapper on the
   host), so each kernel's own device time is also read from
   ``torch.profiler`` (``device_ms``); that is the ``ms`` of the
   ``kernels`` line.

Then a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Any failure exits non-zero
before the last line; without a CUDA device it exits 2 at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CX = CY = 0.1
UNEQUAL = (0.1, 0.2)
BIG = 16384              # BASELINE's "16k^2" grid: the main-path size
MAIN_STEPS = 200
CONV = 1000              # BASELINE Table 7's grid: the converge path
WINDOW = 20              # its check_interval: steps per launch of A
CUBE = 512               # BASELINE config 5's 512^3: the 3D main path
UNEQUAL_3D = (0.1, 0.15, 0.05)
PAST_2_31 = (1291, 1299, 1301)   # 2.18e9 cells: int64 offsets needed
OPS_PER_CELL_STEP = 7       # 3 multiplies + 4 adds of combine_2d
OPS_PER_CELL_STEP_3D = 10   # 4 multiplies + 6 adds of combine_3d
OPS_PER_RESIDUAL_CELL = 2   # subtract + max (the abs is a bit clear)
TPU = "parallel_heat_tpu/ops/pallas_stencil.py"
# Kernel -> (its tune.force choice, the TPU kernel's builder it replaces),
# at site single_2d for KERNELS_2D and single_3d for KERNELS_3D.
KERNELS_2D = {
    "heat_a_resident": ("A", TPU + ":117"),
    "heat_b_step": ("B", TPU + ":294"),
    "heat_c_tiled": ("C", TPU + ":3059"),
    "heat_e_temporal": ("E", TPU + ":607"),
    "heat_e_uni_temporal": ("E-uni", TPU + ":832"),
    "heat_i_tile_temporal": ("I", TPU + ":3294"),
    "heat_i_uni_tile_temporal": ("I-uni", TPU + ":3456"),
}
KERNELS_3D = {
    "heat_f_temporal3d": ("F", TPU + ":3932"),
    "heat_d_step3d": ("D", TPU + ":3708"),
}
KERNELS = {**KERNELS_2D, **KERNELS_3D}
TEMPORAL = ("heat_e_temporal", "heat_e_uni_temporal", "heat_i_tile_temporal",
            "heat_i_uni_tile_temporal")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def same_float(a, b) -> bool:
    a, b = float(a), float(b)
    return (math.isnan(a) and math.isnan(b)) or a == b


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from parallel_heat_tpu_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build(*build.KERNELS)
    seconds = time.perf_counter() - t0
    for name in build.KERNELS:
        build.load(name)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, log in build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: os.path.relpath(str(p), ROOT)
                        for n, p in paths.items()},
          "ptxas": ptxas})


def _launchers(sk):
    """Kernel -> (wrapper, plain version)."""
    return {
        "heat_a_resident": (sk.resident_steps, sk.resident_steps_plain),
        "heat_b_step": (sk.strip_step, sk.strip_step_plain),
        "heat_c_tiled": (sk.tiled_step, sk.tiled_step_plain),
        "heat_e_temporal": (sk.temporal_steps, sk.temporal_steps_plain),
        "heat_e_uni_temporal": (sk.temporal_steps_uni,
                                sk.temporal_steps_uni_plain),
        "heat_i_tile_temporal": (sk.tile_temporal_steps,
                                 sk.tile_temporal_steps_plain),
        "heat_i_uni_tile_temporal": (sk.tile_temporal_steps_uni,
                                     sk.tile_temporal_steps_uni_plain),
    }


def _b_launches(sk, u, k, kw):
    src, dst = u.clone(), u.new_empty(u.shape)
    for _ in range(k):
        rb = sk.strip_step(src, dst, **kw)
        src, dst = dst, src
    return src, rb


def _check_one_step(sk, name, u, kw, err):
    """One-step kernel ``name`` (B or C) against its plain version, and
    C against B."""
    import torch

    launch, plain = _launchers(sk)[name]
    ok, pk, bk = (torch.empty_like(u) for _ in range(3))
    rk = launch(u, ok, **kw)
    rp = plain(u, pk, **kw)
    rb = sk.strip_step(u, bk, **kw)
    torch.cuda.synchronize()
    d = max(float((ok - pk).abs().max()), float((ok - bk).abs().max()))
    err[name] = max(err[name], d)
    where = f"{name} at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}, residual "
          f"{float(rk)} vs {float(rp)}")
    check(torch.equal(ok, bk) and same_float(rk, rb),
          f"{where} != heat_b_step: max diff {d}")
    check(torch.equal(ok[0], u[0]) and torch.equal(ok[-1], u[-1])
          and torch.equal(ok[:, 0], u[:, 0])
          and torch.equal(ok[:, -1], u[:, -1]),
          f"{where} moved the Dirichlet boundary")


def _check_multi(sk, name, u, k, kw, err):
    """K-step kernel ``name`` (A, E, E-uni, I or I-uni) at depth ``k``
    against k
    launches of B and its plain version, with and without the residual."""
    import torch

    launch, plain = _launchers(sk)[name]
    ok = torch.empty_like(u)
    rk = launch(u, ok, k, True, **kw)
    nores = torch.empty_like(u)
    launch(u, nores, k, False, **kw)
    src, rb = _b_launches(sk, u, k, kw)
    pk = torch.empty_like(u)
    rp = plain(u, pk, k, True, **kw)
    torch.cuda.synchronize()
    d = max(float((ok - pk).abs().max()), float((ok - src).abs().max()))
    err[name] = max(err[name], d)
    where = f"{name}(K={k}) at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, src) and same_float(rk, rb),
          f"{where} != {k} launches of heat_b_step: max diff {d}")
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}")
    check(torch.equal(ok, nores), f"{where}: grid depends on with_residual")


def phase_kernels(dev):
    """Kernels against their plain versions; returns max |diff| each."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params

    k_default = params().e_k_default
    rng = np.random.default_rng(0)
    err = {name: 0.0 for name in KERNELS_2D}
    equal = dict(cx=CX, cy=CY)
    unequal = dict(cx=UNEQUAL[0], cy=UNEQUAL[1])
    e_ks = sorted({1, 3, k_default})
    # (shape, coefficient pairs, one-step?, depths of E, E-uni, I and
    # I-uni, depths of A)
    plan = [
        ((4096, 4096), [equal], True, e_ks, []),
        ((1001, 999), [equal, unequal], True, e_ks, [WINDOW]),
        ((CONV, CONV), [equal, unequal], True, sorted({4, k_default}),
         [1, 4, 7, WINDOW]),
        ((1800, 1800), [equal], False, [], [WINDOW]),
        ((107, 210), [equal, unequal], False, [], [1, 7, WINDOW]),
        ((BIG, BIG), [equal], True, [k_default], []),
    ]
    report = []
    for shape, coeffs, one_step, ks, a_ks in plan:
        u = torch.from_numpy(
            (rng.standard_normal(shape) * 10).astype(np.float32)).to(dev)
        temporal = [name for name in TEMPORAL
                    if "uni" not in name or params().uni_fits(shape)]
        for kw in coeffs:
            if one_step:
                for name in ("heat_b_step", "heat_c_tiled"):
                    _check_one_step(sk, name, u, kw, err)
            for k in ks:
                for name in temporal:
                    _check_multi(sk, name, u, k, kw, err)
            for k in a_ks:
                _check_multi(sk, "heat_a_resident", u, k, kw, err)
        report.append({"shape": list(shape), "coeffs": coeffs,
                       "one_step": one_step,
                       "temporal": temporal if ks else [], "k": ks,
                       "a_k": a_ks, "bitwise": True})
        del u
        torch.cuda.empty_cache()
    # A diverging grid: one NaN in the interior.
    u = torch.from_numpy(
        (rng.standard_normal((515, 776)) * 10).astype(np.float32)).to(dev)
    u[200, 300] = float("nan")
    nan_res = {}
    for name, (launch, _) in _launchers(sk).items():
        o = torch.empty_like(u)
        if name in ("heat_b_step", "heat_c_tiled"):
            r = launch(u, o, **equal)
        else:
            r = launch(u, o, k_default, True, **equal)
        nan_res[name] = float(r)
        check(math.isnan(nan_res[name]),
              f"NaN-seeded grid gave {name} residual {nan_res[name]}, "
              f"not NaN")
        check(torch.equal(o[0], u[0]) and torch.equal(o[:, -1], u[:, -1]),
              f"a diverging grid moved the Dirichlet boundary ({name})")
    emit({"phase": "kernels", "ok": True, "checks": report,
          "nan_residual": nan_res, "max_abs_err": err})
    return err


def _reference_f64(nx, ny, steps):
    """Independent float64 NumPy reference of the update rule."""
    ix = np.arange(nx, dtype=np.float64)[:, None]
    iy = np.arange(ny, dtype=np.float64)[None, :]
    u = ix * (nx - ix - 1) * iy * (ny - iy - 1)
    for _ in range(steps):
        c = u[1:-1, 1:-1]
        v = u.copy()
        v[1:-1, 1:-1] = (c + CX * (u[2:, 1:-1] + u[:-2, 1:-1] - 2 * c)
                         + CY * (u[1:-1, 2:] + u[1:-1, :-2] - 2 * c))
        u = v
    return u


def _profiled(fn):
    """Run ``fn()`` once under torch.profiler, recording the card only.
    Returns the wall seconds and the device milliseconds of each event
    name (kernels, memsets, copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.key_averages():
        per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return wall, per


def _busy(solve_once, label):
    """The card's busy share of one profiled run of ``solve_once``."""
    wall, per = _profiled(solve_once)
    busy_ms = sum(per.values())
    check(busy_ms > 0, f"{label}: the profiler saw no device time")
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / 1e3 / wall}


def _run_counted(cfg, kernel, default, label):
    """solve() under ``kernel``: the default pick (which must be
    ``kernel``) or the kernel's forced choice. The counts are set to 0
    just before and read just after; the run's kernel must have launched,
    and no other kernel or plain version."""
    from parallel_heat_tpu_torch import solve, tune
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk

    site = "single_3d" if kernel in KERNELS_3D else "single_2d"
    sk.reset_counts()
    if default:
        res = solve(cfg)
    else:
        with tune.force(site, KERNELS[kernel][0]):
            res = solve(cfg)
    counts = dict(sk.counts)
    check(counts[kernel] > 0, f"{label}: {kernel} was never launched")
    for name, n in counts.items():
        check(name == kernel or n == 0,
              f"{label}: {name} ran {n} times off the path of {kernel}")
    return res, counts


def phase_main_path():
    """16384^2 under E-uni (the default pick) and every other kernel but
    A (the grid is far too large for it); returns each kernel's launches
    in its run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=BIG, ny=BIG, steps=MAIN_STEPS)
    cells = BIG * BIG * MAIN_STEPS / 1e6
    runs, out = {}, {}
    for kernel in ("heat_e_uni_temporal", "heat_e_temporal",
                   "heat_i_tile_temporal", "heat_i_uni_tile_temporal",
                   "heat_b_step", "heat_c_tiled"):
        res, counts = _run_counted(cfg, kernel,
                                   kernel == "heat_e_uni_temporal",
                                   f"16384^2 {kernel}")
        check(res.steps_run == MAIN_STEPS, f"steps_run {res.steps_run}")
        if not runs:
            check(tuple(res.grid.shape) == (BIG, BIG), "wrong grid shape")
            check(bool(torch.isfinite(res.grid).all()), "non-finite grid")
            first = res.grid
        else:
            check(torch.equal(res.grid, first),
                  f"16384^2 grids differ, {kernel} vs the default pick")
        runs[kernel] = counts[kernel]
        out[kernel] = {"elapsed_s": res.elapsed_s,
                       "mcells_steps_per_s": cells / res.elapsed_s,
                       "launches": counts[kernel]}
        del res
    del first
    torch.cuda.empty_cache()
    # A small input against an independent float64 reference (the
    # factored combine drifts ~1e-5 relative in 300 steps; the JAX
    # package holds its own kernels to rtol 1e-4 there).
    small = HeatConfig(nx=256, ny=256, steps=300)
    want = _reference_f64(256, 256, 300)
    cpu = solve(small.replace(backend="cuda"), device="cpu").to_numpy()
    small_ok = {}
    for kernel in KERNELS_2D:
        label = f"256^2 {kernel}"
        res, _ = _run_counted(small, kernel, kernel == "heat_a_resident",
                              label)
        got = res.to_numpy().astype(np.float64)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1)))
        check(np.allclose(got, want, rtol=1e-4, atol=1e-3),
              f"{label} off the float64 reference: {rel}")
        check(np.array_equal(res.to_numpy(), cpu),
              f"{label} differs from the CPU's plain versions")
        small_ok[kernel] = {"max_rel_err_vs_f64": rel,
                            "bitwise_vs_cpu_plain": True}
    busy = _busy(lambda: solve(cfg), "16384^2 profiled")
    emit({"phase": "main_path", "ok": True, "shape": [BIG, BIG],
          "steps": MAIN_STEPS, "runs": out, "bitwise_across_kernels": True,
          "profiled_default": busy, "small_256": small_ok})
    return runs


def phase_converge():
    """1000^2 to eps under A (the default pick) and the other kernels; and
    20^2, which converges, under each against the CPU's plain versions.
    Returns A's launches in the default 1000^2 run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=CONV, ny=CONV, steps=10000, converge=True,
                     check_interval=WINDOW, eps=1e-3)
    runs, out = {}, {}
    for kernel in KERNELS_2D:
        r, c = _run_counted(cfg, kernel, kernel == "heat_a_resident",
                            f"converge {kernel}")
        runs[kernel] = r
        out[kernel] = {"steps_run": r.steps_run, "converged": r.converged,
                       "residual": r.residual, "elapsed_s": r.elapsed_s,
                       "mcells_steps_per_s":
                       CONV * CONV * r.steps_run / r.elapsed_s / 1e6,
                       "launches": c[kernel]}
    r_a = runs["heat_a_resident"]
    for kernel, r in runs.items():
        check(r.steps_run == r_a.steps_run and r.converged == r_a.converged
              and same_float(r.residual, r_a.residual),
              f"converge {kernel} vs heat_a_resident disagree: {out}")
        check(torch.equal(r.grid, r_a.grid),
              f"converge grids differ, {kernel} vs heat_a_resident")
    check(math.isfinite(r_a.residual), "converge residual not finite")
    check(r_a.steps_run == 10000 and not r_a.converged,
          f"1000^2 converge ran {r_a.steps_run} steps (10000 expected)")
    busy = _busy(lambda: solve(cfg), "1000^2 converge profiled")
    # The same grid in fixed mode: A runs all 10000 steps in one launch.
    fixed = cfg.replace(converge=False)
    fixed_out = {}
    for kernel in ("heat_a_resident", "heat_e_uni_temporal"):
        r, c = _run_counted(fixed, kernel, kernel == "heat_a_resident",
                            f"1000^2 fixed {kernel}")
        check(torch.equal(r.grid, r_a.grid),
              f"1000^2 fixed {kernel} differs from the converge run")
        fixed_out[kernel] = {"elapsed_s": r.elapsed_s,
                             "mcells_steps_per_s":
                             CONV * CONV * 10000 / r.elapsed_s / 1e6,
                             "launches": c[kernel]}
    # A run that leaves the loop through res < eps.
    small = HeatConfig(nx=20, ny=20, steps=10000, converge=True,
                       check_interval=WINDOW, eps=1e-3)
    cpu = solve(small.replace(backend="cuda"), device="cpu")
    check(cpu.converged and cpu.steps_run == 1980,
          f"20^2 on the CPU: {cpu.steps_run} steps, converged "
          f"{cpu.converged} (1980, True expected)")
    small_out = {}
    for kernel in KERNELS_2D:
        r, _ = _run_counted(small, kernel, False, f"20^2 converge {kernel}")
        check((r.steps_run, r.converged) == (cpu.steps_run, cpu.converged)
              and same_float(r.residual, cpu.residual)
              and np.array_equal(r.to_numpy(), cpu.to_numpy()),
              f"20^2 converge under {kernel}: {r.steps_run} steps, "
              f"converged {r.converged}, residual {r.residual}; the CPU: "
              f"{cpu.steps_run}, {cpu.converged}, {cpu.residual}")
        small_out[kernel] = {"steps_run": r.steps_run,
                             "converged": r.converged,
                             "residual": r.residual}
    emit({"phase": "converge", "ok": True, "shape": [CONV, CONV], **out,
          "profiled_default": busy, "fixed_10000": fixed_out,
          "converges_20": small_out})
    return out["heat_a_resident"]["launches"]


# ---------------------------------------------------------------------------
# 3D: kernels D and F
# ---------------------------------------------------------------------------

def _d_launches(sk3, u, k, kw):
    src, dst = u.clone(), u.new_empty(u.shape)
    for _ in range(k):
        rd = sk3.slab_step_3d(src, dst, **kw)
        src, dst = dst, src
    return src, rd


def _faces_intact(out, u):
    import torch

    return all(torch.equal(out[sl], u[sl])
               for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                          np.s_[:, :, 0], np.s_[:, :, -1]))


def _check_d(sk3, u, kw, err):
    """Kernel D against its plain version."""
    import torch

    ok, pk = torch.empty_like(u), torch.empty_like(u)
    rk = sk3.slab_step_3d(u, ok, **kw)
    rp = sk3.slab_step_3d_plain(u, pk, **kw)
    torch.cuda.synchronize()
    d = float((ok - pk).abs().max())
    err["heat_d_step3d"] = max(err["heat_d_step3d"], d)
    where = f"heat_d_step3d at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}, residual "
          f"{float(rk)} vs {float(rp)}")
    check(_faces_intact(ok, u), f"{where} moved a Dirichlet face")


def _check_f(sk3, u, k, kw, err):
    """Kernel F at depth ``k`` against k launches of D and its plain
    version, with and without the residual."""
    import torch

    ok, nores = torch.empty_like(u), torch.empty_like(u)
    rk = sk3.xslab_steps_3d(u, ok, k, True, **kw)
    sk3.xslab_steps_3d(u, nores, k, False, **kw)
    src, rd = _d_launches(sk3, u, k, kw)
    pk = torch.empty_like(u)
    rp = sk3.xslab_steps_3d_plain(u, pk, k, True, **kw)
    torch.cuda.synchronize()
    d = max(float((ok - pk).abs().max()), float((ok - src).abs().max()))
    err["heat_f_temporal3d"] = max(err["heat_f_temporal3d"], d)
    where = f"heat_f_temporal3d(K={k}) at {tuple(u.shape)} {kw}"
    check(torch.equal(ok, src) and same_float(rk, rd),
          f"{where} != {k} launches of heat_d_step3d: max diff {d}")
    check(torch.equal(ok, pk) and same_float(rk, rp),
          f"{where} != its plain version: max diff {d}")
    check(torch.equal(ok, nores), f"{where}: grid depends on with_residual")


def phase_kernels_3d(dev):
    """D and F against their plain versions and F(K) against K launches
    of D; returns max |diff| each."""
    import torch

    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    ks = sorted({1, 3, p.f_k_default, p.f_k_max()})
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {name: 0.0 for name in KERNELS_3D}
    equal = dict(cx=CX, cy=CY, cz=CX)
    unequal = dict(zip(("cx", "cy", "cz"), UNEQUAL_3D))
    plan = [((CUBE, CUBE, CUBE), [equal]),
            ((67, 130, 201), [equal, unequal]),
            ((5, 3, 300), [equal, unequal])]
    report = []
    for shape, coeffs in plan:
        u = torch.randn(shape, generator=gen, device=dev) * 10
        for kw in coeffs:
            _check_d(sk3, u, kw, err)
            for k in ks:
                _check_f(sk3, u, k, kw, err)
        report.append({"shape": list(shape), "coeffs": coeffs, "k": ks,
                       "bitwise": True})
        del u
        torch.cuda.empty_cache()
    # A diverging grid: one NaN in the interior.
    u = torch.randn((60, 70, 90), generator=gen, device=dev) * 10
    u[30, 30, 30] = float("nan")
    nan_res = {}
    for name, launch in (
            ("heat_d_step3d", lambda o: sk3.slab_step_3d(u, o, **equal)),
            ("heat_f_temporal3d", lambda o: sk3.xslab_steps_3d(
                u, o, p.f_k_default, True, **equal))):
        o = torch.empty_like(u)
        nan_res[name] = float(launch(o))
        check(math.isnan(nan_res[name]),
              f"NaN-seeded grid gave {name} residual {nan_res[name]}, "
              f"not NaN")
        check(_faces_intact(o, u),
              f"a diverging grid moved a Dirichlet face ({name})")
    del u
    # Past 2^31 cells: F(K_default) against K_default launches of D (four
    # grids of 8.7 GB; no plain version, for memory).
    big = PAST_2_31
    k = p.f_k_default
    u = torch.randn(big, generator=gen, device=dev)
    ok = torch.empty_like(u)
    rk = sk3.xslab_steps_3d(u, ok, k, True, **equal)
    src, rd = _d_launches(sk3, u, k, equal)
    torch.cuda.synchronize()
    d = float((ok - src).abs().max())
    err["heat_f_temporal3d"] = max(err["heat_f_temporal3d"], d)
    check(torch.equal(ok, src) and same_float(rk, rd),
          f"heat_f_temporal3d(K={k}) at {big} != {k} launches of "
          f"heat_d_step3d: max diff {d}, residual {float(rk)} vs "
          f"{float(rd)}")
    report.append({"shape": list(big), "cells": math.prod(big), "k": [k],
                   "against": "heat_d_step3d launches", "bitwise": True})
    del u, ok, src
    torch.cuda.empty_cache()
    emit({"phase": "kernels_3d", "ok": True, "checks": report,
          "nan_residual": nan_res, "max_abs_err": err})
    return err


def _reference_f64_3d(n, steps):
    """Independent float64 NumPy reference of the 7-point rule."""
    ix = np.arange(n, dtype=np.float64)
    f = ix * (n - ix - 1)
    u = f[:, None, None] * f[None, :, None] * f[None, None, :]
    for _ in range(steps):
        c = u[1:-1, 1:-1, 1:-1]
        v = u.copy()
        v[1:-1, 1:-1, 1:-1] = (
            c + CX * (u[2:, 1:-1, 1:-1] + u[:-2, 1:-1, 1:-1] - 2 * c)
            + CY * (u[1:-1, 2:, 1:-1] + u[1:-1, :-2, 1:-1] - 2 * c)
            + CX * (u[1:-1, 1:-1, 2:] + u[1:-1, 1:-1, :-2] - 2 * c))
        u = v
    return u


def phase_main_path_3d():
    """512^3 under F (the default pick) and forced D; 64^3 under each
    against the CPU and a float64 reference. Returns each kernel's
    launches in its 512^3 run."""
    import torch

    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=CUBE, ny=CUBE, nz=CUBE, steps=MAIN_STEPS)
    cells = CUBE ** 3 * MAIN_STEPS / 1e6
    runs, out = {}, {}
    for kernel in KERNELS_3D:
        res, counts = _run_counted(cfg, kernel,
                                   kernel == "heat_f_temporal3d",
                                   f"512^3 {kernel}")
        check(res.steps_run == MAIN_STEPS, f"steps_run {res.steps_run}")
        if not runs:
            check(tuple(res.grid.shape) == (CUBE,) * 3, "wrong grid shape")
            check(bool(torch.isfinite(res.grid).all()), "non-finite grid")
            first = res.grid
        else:
            check(torch.equal(res.grid, first),
                  f"512^3 grids differ, {kernel} vs the default pick")
        runs[kernel] = counts[kernel]
        out[kernel] = {"elapsed_s": res.elapsed_s,
                       "mcells_steps_per_s": cells / res.elapsed_s,
                       "launches": counts[kernel]}
        del res
    del first
    torch.cuda.empty_cache()
    # 64^3 against the CPU's plain versions (bitwise) and a float64
    # reference (few-ulp: rtol 1e-4, the JAX package's own contract for
    # its 3D kernels; atol scaled to the grid, whose values reach 1e10).
    small = HeatConfig(nx=64, ny=64, nz=64, steps=100)
    want = _reference_f64_3d(64, 100)
    cpu = solve(small.replace(backend="cuda"), device="cpu").to_numpy()
    atol = 1e-6 * float(np.abs(want).max())
    small_ok = {}
    for kernel in KERNELS_3D:
        label = f"64^3 {kernel}"
        res, _ = _run_counted(small, kernel, kernel == "heat_f_temporal3d",
                              label)
        got = res.to_numpy().astype(np.float64)
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1)))
        check(np.allclose(got, want, rtol=1e-4, atol=atol),
              f"{label} off the float64 reference: {rel}")
        check(np.array_equal(res.to_numpy(), cpu),
              f"{label} differs from the CPU's plain versions")
        small_ok[kernel] = {"max_rel_err_vs_f64": rel,
                            "bitwise_vs_cpu_plain": True}
    busy = _busy(lambda: solve(cfg), "512^3 profiled")
    emit({"phase": "main_path_3d", "ok": True, "shape": [CUBE] * 3,
          "steps": MAIN_STEPS, "runs": out, "bitwise_across_kernels": True,
          "profiled_default": busy, "small_64": small_ok})
    return runs


def phase_converge_3d():
    """10^3 to eps=1e-3 (converges at step 360 on the CPU) under F and D,
    each equal to the CPU's plain run."""
    from parallel_heat_tpu_torch import HeatConfig, solve

    cfg = HeatConfig(nx=10, ny=10, nz=10, steps=5000, converge=True,
                     check_interval=WINDOW, eps=1e-3)
    cpu = solve(cfg.replace(backend="cuda"), device="cpu")
    check(cpu.converged and cpu.steps_run == 360,
          f"10^3 on the CPU: {cpu.steps_run} steps, converged "
          f"{cpu.converged} (360, True expected)")
    out = {}
    for kernel in KERNELS_3D:
        r, c = _run_counted(cfg, kernel, kernel == "heat_f_temporal3d",
                            f"10^3 converge {kernel}")
        check((r.steps_run, r.converged) == (cpu.steps_run, cpu.converged)
              and same_float(r.residual, cpu.residual)
              and np.array_equal(r.to_numpy(), cpu.to_numpy()),
              f"10^3 converge under {kernel}: {r.steps_run} steps, "
              f"converged {r.converged}, residual {r.residual}; the CPU: "
              f"{cpu.steps_run}, {cpu.converged}, {cpu.residual}")
        out[kernel] = {"steps_run": r.steps_run, "converged": r.converged,
                       "residual": r.residual, "elapsed_s": r.elapsed_s,
                       "launches": c[kernel]}
    emit({"phase": "converge_3d", "ok": True, "shape": [10, 10, 10], **out})


def phase_cli():
    from parallel_heat_tpu_torch import HeatConfig, solve
    from parallel_heat_tpu_torch.utils.io import read_dat, write_dat

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "final.dat")
        cmd = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "256",
               "--ny", "256", "--steps", "500", "--out", path]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        grid = solve(HeatConfig(nx=256, ny=256, steps=500)).to_numpy()
        back = read_dat(path)
        check(back.shape == grid.shape, f"read_dat shape {back.shape}")
        check(np.max(np.abs(back - grid)) <= 0.05 + 1e-6 * np.abs(grid).max(),
              "read_dat does not round-trip the solver's grid")
        ref = os.path.join(tmp, "ref.dat")
        write_dat(ref, grid)
        with open(path, "rb") as a, open(ref, "rb") as b:
            check(a.read() == b.read(), "CLI .dat differs from write_dat")
        path3 = os.path.join(tmp, "final3d.npy")
        cmd3 = [sys.executable, "-m", "parallel_heat_tpu_torch", "--nx", "64",
                "--ny", "64", "--nz", "64", "--steps", "100", "--out", path3]
        proc3 = subprocess.run(cmd3, cwd=ROOT, capture_output=True,
                               text=True, timeout=300)
        check(proc3.returncode == 0,
              f"3D CLI exited {proc3.returncode}: {proc3.stderr[-2000:]}")
        grid3 = solve(HeatConfig(nx=64, ny=64, nz=64, steps=100)).to_numpy()
        check(np.array_equal(np.load(path3), grid3),
              "the 3D CLI's .npy differs from the solver's grid")
    emit({"phase": "cli", "ok": True,
          "stdout": proc.stdout.strip().splitlines(),
          "stdout_3d": proc3.stdout.strip().splitlines()})


def _time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes, ops):
    """The least time the card could take: bytes over HBM's rate or
    float32 operations over its peak, whichever is larger (data sheet,
    ops/hopper_params.py)."""
    from parallel_heat_tpu_torch.ops.hopper_params import params

    card = params()
    t_bytes = nbytes / card.hbm_bytes_per_s * 1e3
    t_ops = ops / card.fp32_flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_timing(dev):
    """ms per launch of each kernel, its plain version and the conv2d
    yardstick, at the shape and depth of the kernel's main-path launch."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate2D
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs_f32

    k = params().e_k_default
    kw = dict(cx=CX, cy=CY)
    a0, cx, cy = coeffs_f32(CX, CY)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.tensor([[0.0, cx, 0.0], [cy, a0, cy], [0.0, cx, 0.0]],
                     dtype=torch.float32, device=dev).view(1, 1, 3, 3)
    launchers = _launchers(sk)

    def conv_steps(x, n):
        y = x
        for _ in range(n):
            y = F.conv2d(y, w)
        return y

    rows = {}
    # B, C, E, E-uni, I and I-uni at the main path's 16384^2.
    u = HeatPlate2D(BIG, BIG).init_grid(dev)
    v = torch.empty_like(u)
    x = u.view(1, 1, BIG, BIG)
    interior = (BIG - 2) * (BIG - 2)
    library_1 = _time_ms(lambda: conv_steps(x, 1), 10, 2)
    library_k = _time_ms(lambda: conv_steps(x, k), 3)
    for name in ("heat_b_step", "heat_c_tiled"):
        launch, plain = launchers[name]
        rows[name] = {
            "shape": [BIG, BIG], "k": 1,
            "ms": _time_ms(lambda: launch(u, v, **kw), 20, 3),
            "plain_ms": _time_ms(lambda: plain(u, v, **kw), 3),
            "library_ms": library_1,
            **_bound(8 * BIG * BIG,
                     (OPS_PER_CELL_STEP + OPS_PER_RESIDUAL_CELL) * interior)}
    for name in TEMPORAL:
        launch, plain = launchers[name]
        rows[name] = {
            "shape": [BIG, BIG], "k": k,
            "ms": _time_ms(lambda: launch(u, v, k, False, **kw), 20, 3),
            "plain_ms": _time_ms(lambda: plain(u, v, k, False, **kw), 2),
            "library_ms": library_k,
            **_bound(8 * BIG * BIG, OPS_PER_CELL_STEP * k * interior)}
    del u, v, x
    torch.cuda.empty_cache()
    # A at the converge path's 1000^2, one 20-step window with the
    # residual: its launch on the main path.
    u = HeatPlate2D(CONV, CONV).init_grid(dev)
    v = torch.empty_like(u)
    x = u.view(1, 1, CONV, CONV)
    interior = (CONV - 2) * (CONV - 2)
    rows["heat_a_resident"] = {
        "shape": [CONV, CONV], "k": WINDOW,
        "ms": _time_ms(lambda: sk.resident_steps(u, v, WINDOW, True, **kw),
                       50, 5),
        "plain_ms": _time_ms(
            lambda: sk.resident_steps_plain(u, v, WINDOW, True, **kw), 5, 1),
        "library_ms": _time_ms(lambda: conv_steps(x, WINDOW), 20, 2),
        **_bound(8 * CONV * CONV,
                 (OPS_PER_CELL_STEP * WINDOW + OPS_PER_RESIDUAL_CELL)
                 * interior)}
    # Each kernel's own device time, from the profiler.
    runs = {"heat_a_resident": (CONV, lambda u, v: sk.resident_steps(
        u, v, WINDOW, True, **kw))}
    for name in ("heat_b_step", "heat_c_tiled"):
        runs[name] = (BIG, lambda u, v, f=launchers[name][0]: f(u, v, **kw))
    for name in TEMPORAL:
        runs[name] = (BIG, lambda u, v, f=launchers[name][0]: f(
            u, v, k, False, **kw))
    reps = 10
    for name, (size, launch) in runs.items():
        u = HeatPlate2D(size, size).init_grid(dev)
        v = torch.empty_like(u)
        launch(u, v)
        _, per = _profiled(lambda: [launch(u, v) for _ in range(reps)])
        rows[name]["device_ms"] = sum(
            t for key, t in per.items()
            if re.search(rf"(^|\W){name}_kernel\b", key)) / reps
        check(rows[name]["device_ms"] > 0,
              f"the profiler saw no {name} launch")
        del u, v
    emit({"phase": "timing", "kernels": rows})
    return rows


def phase_timing_3d(dev):
    """ms per launch of D and F (K_default), their plain versions and the
    conv3d yardstick at the 3D main path's 512^3."""
    import torch
    import torch.nn.functional as F

    from parallel_heat_tpu_torch.models import HeatPlate3D
    from parallel_heat_tpu_torch.ops import stencil_kernels_3d as sk3
    from parallel_heat_tpu_torch.ops.hopper_params import params
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32

    k = params().f_k_default
    kw = dict(cx=CX, cy=CY, cz=CX)
    a0, cx, cy, cz = coeffs3_f32(CX, CY, CX)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.zeros((3, 3, 3), dtype=torch.float32, device=dev)
    w[1, 1, 1] = a0
    w[0, 1, 1] = w[2, 1, 1] = cx
    w[1, 0, 1] = w[1, 2, 1] = cy
    w[1, 1, 0] = w[1, 1, 2] = cz
    w = w.view(1, 1, 3, 3, 3)

    def conv_steps(x, n):
        y = x
        for _ in range(n):
            y = F.conv3d(y, w)
        return y

    u = HeatPlate3D(CUBE, CUBE, CUBE).init_grid(dev)
    v = torch.empty_like(u)
    x = u.view(1, 1, CUBE, CUBE, CUBE)
    interior = (CUBE - 2) ** 3
    launch = {
        "heat_d_step3d": (1, lambda: sk3.slab_step_3d(u, v, **kw),
                          lambda: sk3.slab_step_3d_plain(u, v, **kw),
                          (OPS_PER_CELL_STEP_3D + OPS_PER_RESIDUAL_CELL)
                          * interior),
        "heat_f_temporal3d": (k, lambda: sk3.xslab_steps_3d(
            u, v, k, False, **kw), lambda: sk3.xslab_steps_3d_plain(
                u, v, k, False, **kw), OPS_PER_CELL_STEP_3D * k * interior),
    }
    rows = {}
    for name, (steps, kernel, plain, ops) in launch.items():
        rows[name] = {
            "shape": [CUBE] * 3, "k": steps,
            "ms": _time_ms(kernel, 20, 3),
            "plain_ms": _time_ms(plain, 3),
            "library_ms": _time_ms(lambda: conv_steps(x, steps), 5, 1),
            **_bound(8 * CUBE ** 3, ops)}
        _, per = _profiled(lambda: [kernel() for _ in range(10)])
        rows[name]["device_ms"] = sum(
            t for key, t in per.items()
            if re.search(rf"(^|\W){name}_kernel\b", key)) / 10
        check(rows[name]["device_ms"] > 0,
              f"the profiler saw no {name} launch")
    del u, v, x
    torch.cuda.empty_cache()
    emit({"phase": "timing_3d", "kernels": rows})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import parallel_heat_tpu_torch  # noqa: F401 — fails outside the repo

    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        phase_build()
        err = phase_kernels(dev)
        err.update(phase_kernels_3d(dev))
        launches = phase_main_path()
        launches["heat_a_resident"] = phase_converge()
        launches.update(phase_main_path_3d())
        phase_converge_3d()
        phase_cli()
        t = phase_timing(dev)
        t.update(phase_timing_3d(dev))
    except Exception as e:  # report, then fail: no phase passes on error
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    src = "parallel_heat_tpu_torch/csrc/"
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src + name + ".cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": err[name], "ms": t[name]["device_ms"],
         "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
         "bound_by": t[name]["bound_by"],
         "library_ms": t[name]["library_ms"]}
        for name, (_, replaces) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
