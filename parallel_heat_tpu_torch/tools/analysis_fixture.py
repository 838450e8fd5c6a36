"""The kernel audit's fixture kernel: ``heat_probe_fixture``.

The counterpart of the ``_strip_call`` fixtures of
``tests/test_analysis.py`` (a B-shaped strip kernel that DMAs an 8-row
window into one of two VMEM slots, waits and writes ``out = 2 u``): one
block per output strip loads its window into one of two shared slots by
16-byte cp.async (``clean``) or as one TMA box on an mbarrier
(``clean_tma``), waits, and writes ``out = 2 u``
(``csrc/heat_probe_fixture.cu``). ``runtime_window`` reads every strip's
window start from a device int. The other variants of
:data:`~parallel_heat_tpu_torch.analysis.plans.FIXTURE_VARIANTS` seed
the faults the audit (:mod:`parallel_heat_tpu_torch.analysis.kernels`)
must catch; they are compiled but never launched (several would hang or
read past the array), and :func:`strip_double` refuses them.

:func:`record_e_uni` and :func:`record_f` launch the record variants of
E-uni's and F's loads (a defaulted template parameter of their blocks,
``kHeatLoopRecord`` and ``kHeatFRecord``), which write each load down,
so that ``chip_smoke.py`` can hold the audit's plans against the card.

On a CPU tensor :func:`strip_double` takes its plain version,
:func:`strip_double_plain`; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from parallel_heat_tpu_torch.analysis.plans import (FIXTURE_COLS,
                                                    FIXTURE_VARIANTS)

# The variants that run; the others are seeded faults.
LAUNCHED = ("clean", "clean_tma", "runtime_window")
STRIP_ROWS = 8

counts = {"heat_probe_fixture": 0, "strip_double_plain": 0}


def _check(u: torch.Tensor, variant: str, strip_rows: int,
           off: Optional[int]) -> None:
    if variant not in FIXTURE_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{FIXTURE_VARIANTS}")
    if variant not in LAUNCHED:
        raise ValueError(f"variant {variant!r} seeds a fault for the kernel "
                         f"audit and is never launched (only {LAUNCHED} "
                         f"run)")
    if u.dtype != torch.float32 or u.dim() != 2 or not u.is_contiguous():
        raise ValueError(f"need a contiguous 2D float32 array, got "
                         f"{u.dtype} {tuple(u.shape)}")
    rows, cols = u.shape
    if cols != FIXTURE_COLS or rows % strip_rows or not 1 <= strip_rows <= 256:
        raise ValueError(f"need rows x {FIXTURE_COLS} with rows a multiple "
                         f"of strip_rows (1 .. 256), got {tuple(u.shape)} "
                         f"and {strip_rows}")
    if variant == "runtime_window":
        if off is None or not 0 <= off <= rows - strip_rows:
            raise ValueError(f"runtime_window needs an offset in [0, "
                             f"{rows - strip_rows}], got {off}")


def strip_double_plain(u: torch.Tensor, variant: str = "clean",
                       strip_rows: int = STRIP_ROWS,
                       off: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`strip_double`: ``2 u``, or for
    ``runtime_window`` every strip ``2 u[off:off + strip_rows]``."""
    counts["strip_double_plain"] += 1
    if variant == "runtime_window":
        win = u[off:off + strip_rows]
        return (win * 2.0).repeat(u.shape[0] // strip_rows, 1)
    return u * 2.0


def strip_double(u: torch.Tensor, variant: str = "clean",
                 strip_rows: int = STRIP_ROWS,
                 off: Optional[int] = None) -> torch.Tensor:
    """``heat_probe_fixture`` under ``variant`` (one of :data:`LAUNCHED`)
    on a ``rows x 128`` float32 array, strips of ``strip_rows`` rows: a new
    array, ``2 u`` (``runtime_window``: every strip ``2 u[off:off +
    strip_rows]``)."""
    _check(u, variant, strip_rows, off)
    if u.device.type == "cpu":
        return strip_double_plain(u, variant, strip_rows, off)
    from parallel_heat_tpu_torch.kernels.build import load

    if u.data_ptr() % 16:
        raise ValueError("heat_probe_fixture needs a 16-byte aligned array")
    out = torch.empty_like(u)
    dev_off = (torch.tensor([off], dtype=torch.int32, device=u.device)
               if variant == "runtime_window" else None)
    lib = load("heat_probe_fixture")
    code = lib.heat_probe_fixture(
        FIXTURE_VARIANTS.index(variant), u.data_ptr(), out.data_ptr(),
        dev_off.data_ptr() if dev_off is not None else None, u.shape[0],
        strip_rows, torch.cuda.current_stream(u.device).cuda_stream)
    if code != 0:
        reason = lib.heat_probe_fixture_error_string(code).decode()
        raise RuntimeError(f"heat_probe_fixture launch failed: {code} "
                           f"({reason})")
    counts["heat_probe_fixture"] += 1
    return out


# ---------------------------------------------------------------------------
# The record variants: the kernels' loads written down on the card
# ---------------------------------------------------------------------------

RECORD_WORDS = 8   # csrc/heat_tma.cuh heat_record_load


def _box(lib, name: str, *args) -> tuple:
    """The box (innermost first) that a record library's launch encodes
    in its tensor map, from its ``<name>_box`` export."""
    import ctypes

    fn = getattr(lib, f"{name}_box")
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    box = (ctypes.c_uint32 * 3)()
    code = fn(*args, box)
    if code != 0:
        raise RuntimeError(f"{name}_box failed: {code}")
    return tuple(box)


def record_e_uni(u: torch.Tensor, k: int, *, cx: float, cy: float):
    """E-uni's launch at depth ``k`` on the card, its record variant
    (``heat_probe_temporal`` variant ``kHeatLoopRecord``): ``(out, rec,
    box)``, the grid it computed; after the residual's word, each block's
    load as :func:`parallel_heat_tpu_torch.analysis.kernels.load_records`
    gives it (8 int32 words a block: the window's first cell, the bytes
    the block's own copies move (0: a TMA box), the ``expect_tx`` bytes,
    slot, parity, 1); and the box the launch encodes in its tensor map
    (innermost first), whose bytes are those the box lands."""
    from parallel_heat_tpu_torch.analysis.plans import plan_e
    from parallel_heat_tpu_torch.kernels.build import load as load_lib
    from parallel_heat_tpu_torch.ops import stencil_kernels as sk
    from parallel_heat_tpu_torch.ops.hopper_params import params

    p = params()
    blocks = plan_e(tuple(u.shape), k, uni=True).grid
    out = torch.empty_like(u)
    rec = torch.zeros(1 + RECORD_WORDS * blocks, dtype=torch.int32,
                      device=u.device)
    sk._launch_e(u, out, k, rec, cx, cy, p.e_tile, p.e_block,
                 name="heat_probe_temporal", variant=12)
    box = _box(load_lib("heat_probe_temporal"), "heat_probe_temporal", k,
               *p.e_tile, p.e_block[1])
    return out, rec, box[:2]


def record_f(u: torch.Tensor, k: int, load: str, *, cx: float, cy: float,
             cz: float):
    """F's launch at depth ``k`` under ``load`` on the card, its record
    variant (``heat_probe_xslab_overlap`` variant ``kHeatFRecord``, F's
    block and ring at the default shape): ``(out, rec, box)``, the grid;
    after the residual's word, each plane's load of block ``b`` at record
    ``b (nx + 2k) + i`` (8 int32 words a record, as
    :func:`record_e_uni`'s; a cp.async fill's copied bytes nonzero); and
    under ``"tma"`` the box the launch encodes (innermost first), else
    None."""
    from parallel_heat_tpu_torch.analysis.plans import plan_f
    from parallel_heat_tpu_torch.kernels.build import load as load_lib
    from parallel_heat_tpu_torch.ops.stencil import coeffs3_f32
    from parallel_heat_tpu_torch.ops.stencil_kernels_3d import f_geometry

    nx, ny, nz = u.shape
    block, rows, prefetch, seg = f_geometry(tuple(u.shape), k)
    blocks = plan_f(tuple(u.shape), k, load).grid
    out = torch.empty_like(u)
    rec = torch.zeros(1 + RECORD_WORDS * blocks * (nx + 2 * k),
                      dtype=torch.int32, device=u.device)
    lib = load_lib("heat_probe_xslab_overlap")
    code = lib.heat_probe_xslab_overlap(
        3, u.data_ptr(), out.data_ptr(), rec.data_ptr(), nx, ny, nz, k,
        block[0], block[1], rows, seg, prefetch, int(load == "tma"),
        *coeffs3_f32(cx, cy, cz),
        torch.cuda.current_stream(u.device).cuda_stream)
    if code != 0:
        reason = lib.heat_probe_xslab_overlap_error_string(code).decode()
        raise RuntimeError(f"F's record variant failed: {code} ({reason})")
    box = (_box(lib, "heat_probe_xslab_overlap", block[1], rows)
           if load == "tma" else None)
    return out, rec, box
