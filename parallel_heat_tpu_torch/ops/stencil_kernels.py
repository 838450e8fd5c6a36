"""Kernels A, B, C, E, E-uni, I and I-uni: wrappers, plain versions,
picker and multistep.

The port of the 2D single-device part of
``parallel_heat_tpu/ops/pallas_stencil.py``:

- :func:`resident_steps` launches ``heat_a_resident``
  (csrc/heat_a_resident.cu), the counterpart of
  ``heat_a_vmem_multistep``: any number of steps in one launch with the
  whole grid resident in shared memory, residual of the last step
  optional;
- :func:`strip_step` launches ``heat_b_step`` (csrc/heat_b_step.cu), the
  counterpart of ``heat_b_strip``: one step plus the residual;
- :func:`tiled_step` launches ``heat_c_tiled`` (csrc/heat_c_tiled.cu),
  the counterpart of ``heat_c_tiled``: the same step through 2D tiles
  staged in shared memory;
- :func:`temporal_steps` launches ``heat_e_temporal``
  (csrc/heat_e_temporal.cu), the counterpart of ``heat_e_temporal_strip``:
  K steps per pass, residual of the last step optional;
- :func:`temporal_steps_uni` launches ``heat_e_uni_temporal``
  (csrc/heat_e_uni_temporal.cu), the counterpart of
  ``heat_e_uni_temporal_strip``: E with a uniform load, each tile one TMA
  box of the grid; E and E-uni step with the register-blocked tile loop
  of csrc/heat_temporal.cuh, whose launch shapes are
  :meth:`~.hopper_params.HopperParams.loop_takes`;
- :func:`tile_temporal_steps` launches ``heat_i_tile_temporal``
  (csrc/heat_i_tile_temporal.cu), the counterpart of
  ``heat_i_tile_temporal``: K steps per pass over column bands streamed
  down the grid by one warp each (csrc/heat_i_loop.cuh), and
  :func:`tile_temporal_steps_uni` launches its uniform-load form
  ``heat_i_uni_tile_temporal``, its rows by TMA;
- the ``*_plain`` functions compute the same functions in plain PyTorch,
  with :func:`~.stencil.combine_2d` in the kernels' operation order, so a
  kernel and its plain version agree bitwise on the card.

A wrapper takes its plain version only because the tensor it was given
lies on the CPU. For a CUDA tensor it launches the kernel or raises:
there is no fallback. Each wrapper counts its launches in
:data:`counts` (and each plain version its calls), so a run can show
which path carried it.

Every wrapper writes into a caller-allocated ``out`` (distinct from
``u``): the solver ping-pongs two device buffers instead of allocating
a grid per step.

Storage precision. Every kernel here also takes bfloat16 grids, as the
JAX builders take ``dtype_name`` (``heat_a_resident_bf16``,
``heat_b_step_bf16``, ``heat_c_tiled_bf16``, ``heat_e_temporal_bf16``,
``heat_e_uni_temporal_bf16``, ``heat_i_tile_temporal_bf16``,
``heat_i_uni_tile_temporal_bf16``): arithmetic is float32, and in storage
mode every level rounds to bfloat16; E, E-uni, I and I-uni also take
``acc_f32`` (the JAX builders' ``acc_f32``, the f32chunk mode), which
carries the levels in float32 and rounds the last one, and may then take
a float32 grid in or out (:data:`PRECISION_FORMS`). Their counts are by
form: ``<kernel>_bf16`` and ``<kernel>_bf16_acc``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops.hopper_params import (
    I_MAX_STAGES, I_MAX_ROWS, I_MAX_WARPS, I_MIN_ROWS, params)
from parallel_heat_tpu_torch.ops.stencil import (F32CHUNK_DEPTH, coeffs_f32,
                                                 combine_2d, ring_exact,
                                                 widen_bits)
from parallel_heat_tpu_torch.utils import device_loop

# Launches of each kernel and calls of each plain version, since the
# last reset_counts(); the 3D kernels of stencil_kernels_3d, kernel M of
# ops/batched.py, the transfer kernels of ops/multigrid.py and the
# sharded block kernels of ops/stencil_kernels_block.py (2D) and
# ops/stencil_kernels_block_3d.py (3D) count here too, so one registry
# covers every kernel of the port.
counts = {"heat_a_resident": 0, "heat_b_step": 0, "heat_c_tiled": 0,
          "heat_a_resident_bf16": 0, "heat_b_step_bf16": 0,
          "heat_c_tiled_bf16": 0, "heat_e_temporal_bf16": 0,
          "heat_e_temporal_bf16_acc": 0, "heat_e_uni_temporal_bf16": 0,
          "heat_e_uni_temporal_bf16_acc": 0,
          "heat_e_temporal": 0, "heat_e_uni_temporal": 0,
          "heat_i_tile_temporal": 0, "heat_i_uni_tile_temporal": 0,
          "heat_i_tile_temporal_bf16": 0, "heat_i_tile_temporal_bf16_acc": 0,
          "heat_i_uni_tile_temporal_bf16": 0,
          "heat_i_uni_tile_temporal_bf16_acc": 0,
          "heat_d_step3d": 0, "heat_f_temporal3d": 0,
          "heat_d_step3d_bf16": 0, "heat_f_temporal3d_bf16": 0,
          "heat_m_ensemble": 0, "heat_m_ensemble_bf16": 0,
          "heat_mg_restrict": 0, "heat_mg_prolong": 0,
          "heat_g_block_padded": 0, "heat_g_block_circular": 0,
          "heat_g_block_fused": 0, "heat_g_block_uniform": 0,
          "heat_g_band_fix": 0, "heat_g_block_padded_bf16": 0,
          "heat_g_block_circular_bf16": 0, "heat_g_block_fused_bf16": 0,
          "heat_g_block_uniform_bf16": 0, "heat_g_band_fix_bf16": 0,
          "heat_h_block_3d": 0,
          "heat_h_block_3d_fused": 0, "heat_h_band_fix_3d": 0,
          "resident_steps_plain": 0,
          "strip_step_plain": 0,
          "tiled_step_plain": 0, "temporal_steps_plain": 0,
          "temporal_steps_uni_plain": 0, "tile_temporal_steps_plain": 0,
          "tile_temporal_steps_uni_plain": 0, "slab_step_3d_plain": 0,
          "xslab_steps_3d_plain": 0, "ensemble_steps_plain": 0,
          "restrict_full_weighting": 0, "prolong_bilinear": 0,
          "block_padded_plain": 0, "block_circular_plain": 0,
          "block_fused_plain": 0, "block_uniform_plain": 0,
          "band_fix_plain": 0, "h_block_plain": 0,
          "h_block_fused_plain": 0, "h_band_fix_plain": 0}


device_loop.register_tally(counts)


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


_F32, _BF16 = torch.float32, torch.bfloat16
_FLOAT32_ONLY = ((_F32, _F32),)
# Storage forms: a float32 or a bfloat16 grid in and out.
STORAGE_PAIRS = ((_F32, _F32), (_BF16, _BF16))

# The precision forms of E, E-uni, I and I-uni (csrc/heat_temporal.cuh
# kHeatForm*):
# (input dtype, output dtype, acc_f32) -> the form code their bfloat16
# entry points take. A float32 grid in and out takes the float32 kernel
# in either mode: its levels are float32 already.
PRECISION_FORMS = {(_BF16, _BF16, False): 0, (_BF16, _BF16, True): 1,
                   (_BF16, _F32, True): 2, (_F32, _BF16, True): 3}


def _check(u: torch.Tensor, out: torch.Tensor, ndim: int = 2,
           dtypes=_FLOAT32_ONLY) -> None:
    """The checks every wrapper makes: device, ``(u.dtype, out.dtype)``
    one of ``dtypes`` (TypeError otherwise), shape, contiguity, distinct
    buffers, current device."""
    if u.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {u.device}")
    if (u.dtype, out.dtype) not in dtypes:
        raise TypeError(f"grids of {u.dtype} -> {out.dtype} are not taken "
                        f"here; the pairs taken: {list(dtypes)} (the other "
                        f"forms: ROADMAP.md queue 2 item 24)")
    if u.dim() != ndim or min(u.shape) < 3:
        raise ValueError(f"need a {ndim}D grid of at least 3 cells per "
                         f"axis, got {tuple(u.shape)}")
    if out.shape != u.shape:
        raise ValueError(f"out shape {tuple(out.shape)} != grid shape "
                         f"{tuple(u.shape)}")
    if u.device != out.device:
        raise ValueError(f"u on {u.device}, out on {out.device}")
    if not (u.is_contiguous() and out.is_contiguous()):
        raise ValueError("u and out must be contiguous")
    if u.data_ptr() == out.data_ptr():
        raise ValueError("out must be a different buffer from u")
    if (u.device.type == "cuda"
            and u.device.index != torch.cuda.current_device()):
        raise ValueError(f"grid on {u.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _raise_on_error(lib, name: str, code: int) -> None:
    if code != 0:
        reason = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {code} "
                           f"({reason})")


def _residual_view(bits: torch.Tensor) -> torch.Tensor:
    """The kernel's residual bit pattern as a 0-d float32 tensor."""
    return bits.view(torch.float32).reshape(())


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_step(u, out, a0, cx, cy) -> torch.Tensor:
    c = u[1:-1, 1:-1]
    new = combine_2d(c, u[:-2, 1:-1], u[2:, 1:-1], u[1:-1, :-2],
                     u[1:-1, 2:], a0, cx, cy)
    out.copy_(u)
    out[1:-1, 1:-1] = new
    return (new - c).abs().max()


def strip_step_plain(u: torch.Tensor, out: torch.Tensor, *, cx: float,
                     cy: float) -> torch.Tensor:
    """Plain version of :func:`strip_step`: one step of ``u`` into
    ``out``; returns the interior max-norm residual (0-d, NaN-propagating).
    A bfloat16 grid steps in float32, its interior rounded once and its
    ring copied bit for bit; the residual is the float32 update against
    the widened cell, before rounding."""
    counts["strip_step_plain"] += 1
    return _plain_steps_2d(u, out, 1, True, cx, cy)


def tiled_step_plain(u: torch.Tensor, out: torch.Tensor, *, cx: float,
                     cy: float) -> torch.Tensor:
    """Plain version of :func:`tiled_step`: as :func:`strip_step_plain`."""
    counts["tiled_step_plain"] += 1
    return _plain_steps_2d(u, out, 1, True, cx, cy)


def _plain_steps(u, out, k, with_residual, step):
    """``k`` plain steps ``step(src, dst) -> res`` of ``u``, the last one
    landing in ``out``; the last step's residual, or None without
    ``with_residual``."""
    tmp = torch.empty_like(u) if k > 1 else None
    src = u
    for s in range(k):
        dst = out if (k - 1 - s) % 2 == 0 else tmp
        res = step(src, dst)
        src = dst
    return res if with_residual else None


def _plain_steps_precision(u, out, k, with_residual, cx, cy, acc_f32):
    """``k`` plain steps of a bfloat16 form (:data:`PRECISION_FORMS`) at
    the kernels' rounding points: the levels float32, each rounded to
    bfloat16 before the next step reads it in storage mode, none in the
    carry; the last one stored in ``out``'s dtype (rounded once where that
    is bfloat16); the residual the last step's float32 update against the
    float32 level it read. The ring is copied exactly. Leading member axes
    are taken: a ``(B, M, N)`` stack gives ``(B,)`` residuals."""
    a0, cxf, cyf = coeffs_f32(cx, cy)
    v = widen_bits(u) if u.dtype == _BF16 else u.clone()
    res = None
    for s in range(k):
        c = v[..., 1:-1, 1:-1]
        new = combine_2d(c, v[..., :-2, 1:-1], v[..., 2:, 1:-1],
                         v[..., 1:-1, :-2], v[..., 1:-1, 2:], a0, cxf, cyf)
        if with_residual and s == k - 1:
            res = (new - c).abs().amax(dim=(-2, -1))
        if not acc_f32 and s < k - 1:
            new = widen_bits(new.to(_BF16))
        v[..., 1:-1, 1:-1] = new
    out[..., 1:-1, 1:-1] = v[..., 1:-1, 1:-1]
    ring_exact(out, u)
    return res


def _plain_steps_2d(u, out, k, with_residual, cx, cy, acc_f32=False):
    if u.dtype != _F32 or out.dtype != _F32:
        return _plain_steps_precision(u, out, k, with_residual, cx, cy,
                                      acc_f32)
    coeffs = coeffs_f32(cx, cy)
    return _plain_steps(u, out, k, with_residual,
                        lambda src, dst: _plain_step(src, dst, *coeffs))


def temporal_steps_plain(u: torch.Tensor, out: torch.Tensor, k: int,
                         with_residual: bool = True, *, cx: float,
                         cy: float,
                         acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Plain version of :func:`temporal_steps`: ``k`` plain steps of
    ``u``, the last one landing in ``out``, at the rounding points of the
    grids' dtypes and ``acc_f32``; the last step's residual, or None
    without ``with_residual``."""
    counts["temporal_steps_plain"] += 1
    return _plain_steps_2d(u, out, k, with_residual, cx, cy, acc_f32)


def temporal_steps_uni_plain(u: torch.Tensor, out: torch.Tensor, k: int,
                             with_residual: bool = True, *, cx: float,
                             cy: float,
                             acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Plain version of :func:`temporal_steps_uni`: as
    :func:`temporal_steps_plain`."""
    counts["temporal_steps_uni_plain"] += 1
    return _plain_steps_2d(u, out, k, with_residual, cx, cy, acc_f32)


def tile_temporal_steps_plain(u: torch.Tensor, out: torch.Tensor, k: int,
                              with_residual: bool = True, *, cx: float,
                              cy: float,
                              acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Plain version of :func:`tile_temporal_steps`: as
    :func:`temporal_steps_plain`."""
    counts["tile_temporal_steps_plain"] += 1
    return _plain_steps_2d(u, out, k, with_residual, cx, cy, acc_f32)


def tile_temporal_steps_uni_plain(u: torch.Tensor, out: torch.Tensor,
                                  k: int, with_residual: bool = True, *,
                                  cx: float, cy: float,
                                  acc_f32: bool = False
                                  ) -> Optional[torch.Tensor]:
    """Plain version of :func:`tile_temporal_steps_uni`: as
    :func:`temporal_steps_plain`."""
    counts["tile_temporal_steps_uni_plain"] += 1
    return _plain_steps_2d(u, out, k, with_residual, cx, cy, acc_f32)


def resident_steps_plain(u: torch.Tensor, out: torch.Tensor, k: int,
                         with_residual: bool = True, *, cx: float,
                         cy: float) -> Optional[torch.Tensor]:
    """Plain version of :func:`resident_steps`: as
    :func:`temporal_steps_plain` (storage mode), for any ``k >= 1``."""
    counts["resident_steps_plain"] += 1
    return _plain_steps_2d(u, out, k, with_residual, cx, cy)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _stream(u: torch.Tensor) -> int:
    return torch.cuda.current_stream(u.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch_a(u, out, k, xch, bits, cx, cy, depth, tile, block) -> None:
    """One cooperative launch of ``heat_a_resident`` at the given halo
    depth, tile and thread block (``bits`` None: no residual; ``xch`` the
    exchange planes, None when ``k <= depth``); raises if the launch is
    refused. Checks nothing and counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    name = kernel_entry("A", u.dtype)
    lib = load(name)
    code = getattr(lib, name)(
        u.data_ptr(), out.data_ptr(), _ptr(xch), _ptr(bits), u.shape[0],
        u.shape[1], k, depth, tile[0], tile[1], block[0], block[1],
        *coeffs_f32(cx, cy), _stream(u))
    _raise_on_error(lib, "heat_a_resident", code)


def _launch_b(u, out, bits, cx, cy, block, rows_per_thread) -> None:
    """One launch of ``heat_b_step`` (``heat_b_step_bf16`` on a bfloat16
    grid) at the given thread block; raises if the launch is refused.
    Checks nothing and counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    name = kernel_entry("B", u.dtype)
    lib = load(name)
    code = getattr(lib, name)(
        u.data_ptr(), out.data_ptr(), bits.data_ptr(), u.shape[0],
        u.shape[1], block[0], block[1], rows_per_thread,
        *coeffs_f32(cx, cy), _stream(u))
    _raise_on_error(lib, "heat_b_step", code)


def _launch_c(u, out, bits, cx, cy, tile, block) -> None:
    """One launch of ``heat_c_tiled`` (``heat_c_tiled_bf16`` on a bfloat16
    grid) at the given tile and thread block; raises if the launch is
    refused. Checks nothing and counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    name = kernel_entry("C", u.dtype)
    lib = load(name)
    code = getattr(lib, name)(
        u.data_ptr(), out.data_ptr(), bits.data_ptr(), u.shape[0],
        u.shape[1], tile[0], tile[1], block[0], block[1],
        *coeffs_f32(cx, cy), _stream(u))
    _raise_on_error(lib, "heat_c_tiled", code)


def _launch_e(u, out, k, bits, cx, cy, tile, block,
              name="heat_e_temporal", variant=None, form=None) -> None:
    """One launch of ``heat_e_temporal`` (or, by ``name``, of
    ``heat_e_uni_temporal``, which takes the same arguments, or of a
    probe's variant of E-uni's launch, ``heat_probe_temporal``,
    ``heat_probe_ab_temporal`` or ``heat_probe_split_copy``, which take
    the ``variant`` code first) at
    the given tile and thread block (``bits`` None: no residual); with
    ``form`` (:data:`PRECISION_FORMS`) the kernel's bfloat16 entry point
    under that form. Raises if the launch is refused. Checks only the
    launch shape (:meth:`~.hopper_params.HopperParams.loop_takes`, the
    launchers' own rule) and E-uni's TMA box; counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    p = params()
    if not p.loop_takes(tuple(tile), tuple(block)):
        raise ValueError(f"{name}: the step loop does not take tiles of "
                         f"{tuple(tile)} under thread blocks of "
                         f"{tuple(block)} (32 lanes by 1 to "
                         f"{p.loop_max_warps} warps, a tile width that is "
                         f"a multiple of 4)")
    elem = u.element_size()
    if name != "heat_e_temporal" and not p.e_box_fits(k, tuple(tile), elem):
        raise ValueError(f"{name}: the TMA box of a {tuple(tile)} tile at "
                         f"K={k}, {p.e_box(k, tile=tuple(tile), elem=elem)[2:]}"
                         f" cells, exceeds 256 cells a dimension")
    entry = name if form is None else name + "_bf16"
    lib = load(entry)
    lead = () if variant is None else (variant,)
    tail = () if form is None else (form,)
    code = getattr(lib, entry)(
        *lead, u.data_ptr(), out.data_ptr(), _ptr(bits), u.shape[0],
        u.shape[1], k, tile[0], tile[1], block[0], block[1], *tail,
        *coeffs_f32(cx, cy), _stream(u))
    _raise_on_error(lib, name, code)


def loop_occupancy(name: str, k: int, tile, block) -> int:
    """Thread blocks of kernel ``name``, one on the register-blocked tile
    loop with an occupancy entry point (``heat_e_temporal``,
    ``heat_e_uni_temporal``, ``heat_g_block_uniform``,
    ``heat_g_block_fused``), that one SM of the current card holds at once
    at depth ``k``, ``tile`` and ``block``: the CUDA occupancy calculator
    at the launch's shared memory, registers included. Builds the kernel
    if needed."""
    import ctypes

    from parallel_heat_tpu_torch.kernels.build import load

    lib = load(name)
    fn = getattr(lib, f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    code = fn(k, tile[0], tile[1], block[0], block[1], ctypes.byref(blocks))
    _raise_on_error(lib, name, code)
    return blocks.value


def _launch_i(u, out, k, bits, cx, cy, seg_rows, warps=None, rows=None,
              stages=None, name="heat_i_tile_temporal", form=None) -> None:
    """One launch of ``heat_i_tile_temporal`` (or, by ``name``, of
    ``heat_i_uni_tile_temporal``, which takes the same arguments) over
    bands of ``hopper_params.i_tile_x(k)`` columns, a warp each,
    ``warps`` to a block, and segments of ``seg_rows`` rows, each warp's
    rows in a ring of ``stages`` stages of ``rows`` rows (each
    ``hopper_params``' ``i_*`` default where None; ``bits`` None: no
    residual); with ``form`` (:data:`PRECISION_FORMS`) the kernel's
    bfloat16 entry point under that form. Raises if the launch is
    refused. Checks only the launch shape
    (:meth:`~.hopper_params.HopperParams.i_takes`, the launcher's own
    rule); counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    p = params()
    warps = warps or p.i_warps
    rows = rows or p.i_rows
    stages = stages or p.i_stages
    if not p.i_takes(k, warps, rows, stages, u.element_size()):
        raise ValueError(f"{name}: the launcher does not take K={k}, "
                         f"{warps} warps a block and a ring of {stages} "
                         f"stages of {rows} rows (K 1 to {p.i_k_max}, 1 to "
                         f"{I_MAX_WARPS} warps, {I_MIN_ROWS} to "
                         f"{I_MAX_ROWS} rows, 2 to {I_MAX_STAGES} stages, "
                         f"within {p.smem_per_block_max} bytes of shared "
                         f"memory)")
    entry = name if form is None else name + "_bf16"
    tail = () if form is None else (form,)
    lib = load(entry)
    code = getattr(lib, entry)(
        u.data_ptr(), out.data_ptr(), _ptr(bits), u.shape[0], u.shape[1],
        k, seg_rows, warps, rows, stages, *tail, *coeffs_f32(cx, cy),
        _stream(u))
    _raise_on_error(lib, entry, code)


def i_occupancy(name: str, k: int, warps=None, rows=None,
                stages=None, form=None) -> int:
    """Thread blocks of kernel ``name`` (``heat_i_tile_temporal`` or
    ``heat_i_uni_tile_temporal``; with ``form`` its bfloat16 entry's
    instance of that form) that one SM of the current card holds
    at once at depth ``k`` and the launch's warps and ring (the
    ``hopper_params`` ``i_*`` defaults where None): the CUDA occupancy
    calculator at the launch's shared memory, registers included. Builds
    the kernel if needed."""
    import ctypes

    from parallel_heat_tpu_torch.kernels.build import load

    p = params()
    entry = name if form is None else name + "_bf16"
    lead = () if form is None else (form,)
    lib = load(entry)
    fn = getattr(lib, f"{entry}_occupancy")
    fn.argtypes = [ctypes.c_int] * (4 + len(lead)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    code = fn(*lead, k, warps or p.i_warps, rows or p.i_rows,
              stages or p.i_stages, ctypes.byref(blocks))
    _raise_on_error(lib, entry, code)
    return blocks.value


def resident_steps(u: torch.Tensor, out: torch.Tensor, k: int,
                   with_residual: bool = True, *, cx: float,
                   cy: float) -> Optional[torch.Tensor]:
    """Kernel A: ``k`` steps of ``u`` into ``out`` in one launch, the
    whole grid resident in shared memory; returns the last step's
    residual (0-d float32 tensor) or None without ``with_residual``.
    Takes float32 and bfloat16 grids (``out`` of ``u``'s dtype; storage
    mode: every level rounds). Raises ValueError for a grid that does not
    fit resident on the card (:meth:`~.hopper_params.HopperParams.a_tile`:
    the same grids at both dtypes, the shared buffers holding float32)."""
    launch = _a_checked(u, out, k)
    if u.device.type == "cpu":
        return resident_steps_plain(u, out, k, with_residual, cx=cx, cy=cy)
    xch, bits = a_scratch(u, k, launch, with_residual)
    _launch_a(u, out, k, xch, bits, cx, cy, launch["depth"], launch["tile"],
              launch["block"])
    counts[kernel_entry("A", u.dtype)] += 1
    return _residual_view(bits) if bits is not None else None


def a_launch(shape):
    """Kernel A's launch for an ``(m, n)`` grid: ``{"tile", "depth",
    "block"}``, or None when the grid does not fit resident on the card
    (:meth:`~.hopper_params.HopperParams.a_tile`)."""
    p = params()
    tile = p.a_tile(tuple(shape))
    return ({"tile": tile, "depth": p.a_depth, "block": p.a_block}
            if tile else None)


def _a_checked(u, out, k):
    """The checks of a launch of A (or of its anatomy probe's variants)
    on ``u`` into ``out`` at depth ``k``; returns :func:`a_launch`."""
    _check(u, out, dtypes=STORAGE_PAIRS)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    launch = a_launch(tuple(u.shape))
    if launch is None:
        raise ValueError(f"grid {tuple(u.shape)} does not fit resident in "
                         f"the card's shared memory (kernel A)")
    return launch


def a_scratch(u, k, launch, with_residual):
    """``(xch, bits)``: the exchange planes of a launch of A (None when
    ``k`` is within one halo depth) and its residual's bits (None without
    ``with_residual``). The planes are freed when the caller returns,
    before the kernel ends: the caching allocator reuses them only in the
    order of the current stream, which the kernel runs on."""
    xch = (torch.empty((2,) + tuple(u.shape), dtype=torch.float32,
                       device=u.device) if k > launch["depth"] else None)
    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual else None)
    return xch, bits


def strip_step(u: torch.Tensor, out: torch.Tensor, *, cx: float,
               cy: float) -> torch.Tensor:
    """Kernel B: one step of ``u`` into ``out`` plus the interior
    max-norm residual, a 0-d float32 tensor on ``u``'s device. Takes
    float32 and bfloat16 grids (``out`` of ``u``'s dtype; the updated
    cells round to bfloat16, the residual is taken before)."""
    _check(u, out, dtypes=STORAGE_PAIRS)
    if u.device.type == "cpu":
        return strip_step_plain(u, out, cx=cx, cy=cy)
    p = params()
    bits = torch.empty(1, dtype=torch.int32, device=u.device)
    _launch_b(u, out, bits, cx, cy, p.b_block, p.b_rows_per_thread)
    counts[kernel_entry("B", u.dtype)] += 1
    return _residual_view(bits)


def tiled_step(u: torch.Tensor, out: torch.Tensor, *, cx: float,
               cy: float) -> torch.Tensor:
    """Kernel C: one step of ``u`` into ``out`` through 2D tiles staged
    in shared memory, plus the interior max-norm residual, a 0-d float32
    tensor on ``u``'s device. Takes float32 and bfloat16 grids, as
    :func:`strip_step`, and is bitwise it at both."""
    _check(u, out, dtypes=STORAGE_PAIRS)
    if u.device.type == "cpu":
        return tiled_step_plain(u, out, cx=cx, cy=cy)
    p = params()
    bits = torch.empty(1, dtype=torch.int32, device=u.device)
    _launch_c(u, out, bits, cx, cy, p.c_tile, p.c_block)
    counts[kernel_entry("C", u.dtype)] += 1
    return _residual_view(bits)


def _form_checked(u, out, acc_f32):
    """The dtype checks of a kernel with precision forms: float32 in and
    out, or a pair of :data:`PRECISION_FORMS` in ``acc_f32``'s mode;
    returns the form (None for float32 in and out)."""
    _check(u, out, dtypes=((_F32, _F32),) + tuple(
        (a, b) for a, b, acc in PRECISION_FORMS if acc == bool(acc_f32)))
    return PRECISION_FORMS.get((u.dtype, out.dtype, bool(acc_f32)))


def _e_checked(name, u, out, k, acc_f32=False):
    """The checks of a launch of E or E-uni (or of a probe's variant of
    E-uni's launch, ``name`` not ``"heat_e_temporal"``) on ``u`` into
    ``out`` at depth ``k``; returns the precision form (None for float32
    in and out)."""
    form = _form_checked(u, out, acc_f32)
    p = params()
    deepest = p.e_k_max(elem=u.element_size())
    if not 1 <= k <= deepest:
        raise ValueError(f"k must be in [1, {deepest}] (shared-memory "
                         f"budget at tile {p.e_tile}), got {k}")
    uni = name != "heat_e_temporal"
    if uni and not p.uni_fits(tuple(u.shape), u.dtype):
        raise ValueError(f"kernel E-uni needs a grid whose rows are 16-byte "
                         f"multiples (a width that is a multiple of "
                         f"{16 // u.element_size()} at {u.dtype}), got "
                         f"{tuple(u.shape)}")
    if uni and u.device.type == "cuda" and u.data_ptr() % 16:
        raise ValueError("kernel E-uni needs a 16-byte aligned grid")
    return form


def _form_count(name, form) -> str:
    """The count a launch of kernel ``name`` under ``form`` adds to."""
    if form is None:
        return name
    return name + ("_bf16" if form == 0 else "_bf16_acc")


def _temporal(name, plain, u, out, k, with_residual, cx, cy, acc_f32=False):
    form = _e_checked(name, u, out, k, acc_f32)
    if u.device.type == "cpu":
        return plain(u, out, k, with_residual, cx=cx, cy=cy, acc_f32=acc_f32)
    p = params()
    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual else None)
    _launch_e(u, out, k, bits, cx, cy, p.e_tile, p.e_block, name, form=form)
    counts[_form_count(name, form)] += 1
    return _residual_view(bits) if bits is not None else None


def temporal_steps(u: torch.Tensor, out: torch.Tensor, k: int,
                   with_residual: bool = True, *, cx: float, cy: float,
                   acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Kernel E: ``k`` steps of ``u`` into ``out`` in one pass through
    global memory; returns the last step's residual (0-d float32 tensor)
    or None without ``with_residual``. Float32 or bfloat16 grids; with
    ``acc_f32`` the levels carry float32 and only the last one rounds
    (the f32chunk mode), and ``u`` or ``out`` may be a float32 level of a
    bfloat16 run (:data:`PRECISION_FORMS`). ``k`` up to
    :meth:`~.hopper_params.HopperParams.e_k_max`: a deeper f32chunk chunk
    runs across a float32 level (:func:`_carry_chunks`)."""
    return _temporal("heat_e_temporal", temporal_steps_plain, u, out, k,
                     with_residual, cx, cy, acc_f32)


def temporal_steps_uni(u: torch.Tensor, out: torch.Tensor, k: int,
                       with_residual: bool = True, *, cx: float, cy: float,
                       acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Kernel E-uni: :func:`temporal_steps` with a uniform load, each tile
    one TMA box of the grid; bitwise the same grid and residual. Takes
    grids whose rows are 16-byte multiples: a width that is a multiple of
    4 at float32, of 8 at bfloat16 (ValueError otherwise)."""
    return _temporal("heat_e_uni_temporal", temporal_steps_uni_plain, u,
                     out, k, with_residual, cx, cy, acc_f32)


def _tile_temporal(name, plain, u, out, k, with_residual, cx, cy,
                   acc_f32=False):
    form = _form_checked(u, out, acc_f32)
    p = params()
    if not 1 <= k <= p.i_k_max:
        raise ValueError(f"k must be in [1, {p.i_k_max}], got {k}")
    uni = name == "heat_i_uni_tile_temporal"
    if uni and not p.uni_fits(tuple(u.shape), u.dtype):
        raise ValueError(f"kernel I-uni needs a grid whose rows are 16-byte "
                         f"multiples (a width that is a multiple of "
                         f"{16 // u.element_size()} at {u.dtype}), got "
                         f"{tuple(u.shape)}")
    if u.device.type == "cpu":
        return plain(u, out, k, with_residual, cx=cx, cy=cy, acc_f32=acc_f32)
    if uni and u.data_ptr() % 16:
        raise ValueError("kernel I-uni needs a 16-byte aligned grid")
    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual else None)
    _, seg_rows = p.i_launch(tuple(u.shape), k)
    _launch_i(u, out, k, bits, cx, cy, seg_rows, name=name, form=form)
    counts[_form_count(name, form)] += 1
    return _residual_view(bits) if bits is not None else None


def tile_temporal_steps(u: torch.Tensor, out: torch.Tensor, k: int,
                        with_residual: bool = True, *, cx: float,
                        cy: float,
                        acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Kernel I: ``k`` steps (at most 8) of ``u`` into ``out`` in one pass
    through global memory, over column bands of 128 columns each streamed
    down the grid by one warp; bitwise the grid and residual of
    :func:`temporal_steps`, at every precision form it takes (float32 or
    bfloat16 grids, ``acc_f32`` as :func:`temporal_steps`)."""
    return _tile_temporal("heat_i_tile_temporal", tile_temporal_steps_plain,
                          u, out, k, with_residual, cx, cy, acc_f32)


def tile_temporal_steps_uni(u: torch.Tensor, out: torch.Tensor, k: int,
                            with_residual: bool = True, *, cx: float,
                            cy: float,
                            acc_f32: bool = False) -> Optional[torch.Tensor]:
    """Kernel I-uni: :func:`tile_temporal_steps` with a uniform load, each
    stage of a band's rows one TMA box of the grid. Takes grids whose rows
    are 16-byte multiples: a width that is a multiple of 4 at float32, of
    8 at bfloat16 (ValueError otherwise)."""
    return _tile_temporal("heat_i_uni_tile_temporal",
                          tile_temporal_steps_uni_plain, u, out, k,
                          with_residual, cx, cy, acc_f32)


# ---------------------------------------------------------------------------
# The decision site and the multistep
# ---------------------------------------------------------------------------

def pick_single_2d(shape, dtype="float32", accumulate="storage"):
    """The 2D single-device kernel decision: ``(kind, detail)`` with kind
    in {"A", "E-uni", "E", "I-uni", "I", "B", "C", "torch"}, for a grid of
    storage ``dtype`` under ``accumulate``.

    The one decision site: :func:`single_grid_multistep` executes its
    result and ``solver.explain`` reports it. By default a grid that fits
    resident in the card's shared memory takes A (as the JAX package's
    takes A where the grid fits in VMEM), any other grid E-uni where its
    width allows, else E. Under ``accumulate="f32chunk"`` A, B and C are
    never taken (they round every step, as the JAX picker rules), so the
    default is E-uni, else E, each chunk of ``F32CHUNK_DEPTH`` steps
    carried in float32. A float64 grid takes the torch route (the kernels
    store float32 and bfloat16). A choice pinned with
    ``tune.force("single_2d", ...)`` wins when it is feasible for the
    geometry, dtype and mode; an infeasible pin (A on a grid too large,
    E-uni or I-uni on a width whose rows are not 16-byte multiples, A, B
    or C under f32chunk) warns and the default decides.
    """
    dtype = str(dtype).replace("torch.", "")
    if dtype == "float64":
        return "torch", None
    choice = tune.forced("single_2d")
    if choice is not None:
        resolved = _resolve_single_2d(choice, shape, dtype, accumulate)
        if resolved is not None:
            return resolved
        warnings.warn(f"tune[single_2d]: forced choice {choice!r} "
                      f"infeasible at {tuple(shape)} {dtype}/{accumulate}; "
                      f"using the default", RuntimeWarning, stacklevel=2)
    return next(filter(None, (
        _resolve_single_2d(kind, shape, dtype, accumulate)
        for kind in ("A", "E-uni", "E"))))


def _resolve_single_2d(choice, shape, dtype="float32", accumulate="storage"):
    p = params()
    acc = accumulate == "f32chunk"
    if choice == "torch":
        return "torch", None
    if acc and choice in ("A", "B", "C"):
        # Single-step kernels, and A, round every step: they can never
        # honour the chunked-f32 contract.
        return None
    if choice == "A":
        launch = a_launch(shape)
        return ("A", launch) if launch else None
    if choice in ("E-uni", "I-uni") and not p.uni_fits(tuple(shape), dtype):
        return None
    if choice in ("E", "E-uni"):
        # Under f32chunk K is the semantics' chunk, run by _carry_chunks.
        k = F32CHUNK_DEPTH if acc else p.e_k_default
        return choice, {"k": k, "tile": p.e_tile, "block": p.e_block}
    if choice in ("I", "I-uni"):
        tile_x, seg_rows = p.i_launch(tuple(shape), p.i_k_default)
        k = F32CHUNK_DEPTH if acc else p.i_k_default
        return choice, {"k": k, "band": tile_x,
                        "segment": seg_rows, "warps": p.i_warps,
                        "rows": p.i_rows, "stages": p.i_stages}
    if choice == "C":
        return "C", {"tile": p.c_tile, "block": p.c_block}
    return "B", {"block": p.b_block, "rows_per_thread": p.b_rows_per_thread}


def _carry_chunks(launch, launch_k=None):
    """``temporal(u, v, k, want_res)`` for a bfloat16 run under f32chunk:
    one chunk of ``k`` steps (at most ``2 * launch_k``) carried in
    float32 by ``launch`` (E, E-uni, I or I-uni with ``acc_f32``, whose
    default depth is ``launch_k``: ``e_k_default`` where None): in one
    launch up to ``launch_k`` steps, else in two, the first ``launch_k``
    steps into a float32 level and the rest from it, so the chunk rounds
    once, at its last launch, and only that launch computes the
    residual."""
    launch_k = launch_k or params().e_k_default

    def temporal(u, v, k, want_res):
        if k <= launch_k:
            return launch(u, v, k, want_res, acc_f32=True)
        level = torch.empty(u.shape, dtype=_F32, device=u.device)
        launch(u, level, launch_k, False, acc_f32=True)
        return launch(level, v, k - launch_k, want_res, acc_f32=True)

    return temporal


def _chunked_multistep(temporal, K: int):
    """Lift a k-step kernel ``temporal(u, out, k, with_residual) -> res``
    (any ``1 <= k <= K``) to ``(multi_step, multi_step_residual)``.

    An n-step advance runs ``n // kk`` passes of ``kk = min(K, n)``
    steps and one remainder pass; only the pass that executes the
    chunk's last step computes the residual.
    """

    def _run(u, v, n, want_res):
        kk = min(K, n)
        full, rem = divmod(n, kk)
        res = None
        for i in range(full):
            res = temporal(u, v, kk, want_res and rem == 0 and i == full - 1)
            u, v = v, u
        if rem:
            res = temporal(u, v, rem, want_res)
            u, v = v, u
        return u, v, res

    def multi_step(u, v, n):
        u, v, _ = _run(u, v, n, False)
        return u, v

    def multi_step_residual(u, v, n):
        return _run(u, v, n, True)

    return multi_step, multi_step_residual


_KERNEL_OF = {"A": "heat_a_resident", "B": "heat_b_step",
              "C": "heat_c_tiled", "E": "heat_e_temporal",
              "E-uni": "heat_e_uni_temporal", "I": "heat_i_tile_temporal",
              "I-uni": "heat_i_uni_tile_temporal", "M": "heat_m_ensemble",
              "D": "heat_d_step3d", "F": "heat_f_temporal3d"}


def kernel_entry(kind, dtype="float32"):
    """The entry point (``kernels/build.py`` name) a run of ``kind`` at
    storage ``dtype`` (a name or a torch dtype) launches: for a bfloat16
    run its bfloat16 entry point."""
    name = _KERNEL_OF[kind]
    return name + "_bf16" if dtype in ("bfloat16", _BF16) else name


def single_grid_multistep(config):
    """``(multi_step(u, v, n) -> (u, v), multi_step_residual(u, v, n) ->
    (u, v, res))`` for one device: ``u`` holds the state, ``v`` is the
    spare buffer, and each returns them swapped as the steps left them.

    The kernel comes from :func:`pick_single_2d`. The kernel library of
    a CUDA run is loaded here, before any clock starts.
    """
    from parallel_heat_tpu_torch.solver import steps_to_multistep

    kind, detail = pick_single_2d(config.shape, config.dtype,
                                  config.accumulate)
    cx, cy = float(config.cx), float(config.cy)
    if kind == "torch":
        from parallel_heat_tpu_torch.solver import torch_multistep

        return torch_multistep(cx, cy, accumulate=config.accumulate)
    if torch.device(config.device).type == "cuda":
        from parallel_heat_tpu_torch.kernels.build import load

        load(kernel_entry(kind, config.dtype))
    if kind == "A":
        # One launch per chunk, however many steps it holds.
        def multi_step(u, v, n):
            resident_steps(u, v, n, False, cx=cx, cy=cy)
            return v, u

        def multi_step_residual(u, v, n):
            res = resident_steps(u, v, n, True, cx=cx, cy=cy)
            return v, u, res

        return multi_step, multi_step_residual
    if kind in ("E", "E-uni", "I", "I-uni"):
        launch = {"E": temporal_steps, "E-uni": temporal_steps_uni,
                  "I": tile_temporal_steps,
                  "I-uni": tile_temporal_steps_uni}[kind]

        def temporal(u, v, k, want_res, **kw):
            return launch(u, v, k, want_res, cx=cx, cy=cy, **kw)

        if config.accumulate == "f32chunk":
            # K = F32CHUNK_DEPTH is the semantics' chunk: the launch depth
            # (e_k_default, i_k_default) never moves a rounding point.
            p = params()
            launch_k = (p.i_k_default if kind in ("I", "I-uni")
                        else p.e_k_default)
            return _chunked_multistep(_carry_chunks(temporal, launch_k),
                                      detail["k"])
        return _chunked_multistep(temporal, detail["k"])
    launch = strip_step if kind == "B" else tiled_step

    def step(u, v):
        return launch(u, v, cx=cx, cy=cy)

    return steps_to_multistep(step, step)
