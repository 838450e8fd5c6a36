"""Kernels D and F: wrappers, plain versions, picker and multistep.

The port of the 3D single-device part of
``parallel_heat_tpu/ops/pallas_stencil.py``:

- :func:`slab_step_3d` launches ``heat_d_step3d``
  (csrc/heat_d_step3d.cu), the counterpart of ``heat_d_slab_3d``: one
  7-point step plus the interior max-norm residual;
- :func:`xslab_steps_3d` launches ``heat_f_temporal3d``
  (csrc/heat_f_temporal3d.cu), the counterpart of ``heat_f_xslab_3d``:
  K steps per pass, residual of the last step optional, each plane's tile
  by TMA where the grid takes it, else by cp.async (:func:`f_load`);
- :func:`slab_step_3d_plain` and :func:`xslab_steps_3d_plain` compute the
  same functions in plain PyTorch, with :func:`~.stencil.combine_3d` in
  the kernels' operation order, so a kernel and its plain version agree
  bitwise on the card, and F(K) is bitwise K launches of D.

Storage precision. Both kernels also take bfloat16 grids, as the JAX
builders take ``dtype_name`` (``heat_d_step3d_bf16``,
``heat_f_temporal3d_bf16``): arithmetic is float32, every level rounds to
bfloat16 (storage mode, the only bfloat16 mode in 3D) and the six faces
are copied bit for bit. Their counts are ``<kernel>_bf16``. A float64
grid takes the torch route (:func:`pick_single_3d`).

As in :mod:`.stencil_kernels`, a wrapper takes its plain version only
because the tensor it was given lies on the CPU; a CUDA tensor goes
through the kernel or the call raises. Launches and plain calls count in
the same registry, :data:`.stencil_kernels.counts`.
"""

from __future__ import annotations

from typing import Optional

import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops import stencil_kernels as sk
from parallel_heat_tpu_torch.ops.hopper_params import elem_size, params
from parallel_heat_tpu_torch.ops.stencil import (coeffs3_f32, combine_3d,
                                                 faces_exact, widen_bits)

counts = sk.counts

LOADS = ("tma", "cp.async")
_BF16 = torch.bfloat16


def f_load(shape, u: Optional[torch.Tensor] = None,
           dtype="float32") -> str:
    """Kernel F's plane load for an ``(X, Y, Z)`` grid of ``dtype`` (of
    ``u`` and its dtype, when given): ``"tma"`` where
    :meth:`~.hopper_params.HopperParams.f_tma_fits` holds (``nz % 4 ==
    0`` at float32, ``nz % 8 == 0`` at bfloat16) and u's address is a
    multiple of 16 bytes, else ``"cp.async"``. Geometry alone decides; the
    launch refuses TMA elsewhere and nothing falls back."""
    fits = params().f_tma_fits(tuple(shape),
                               u.dtype if u is not None else dtype)
    return ("tma" if fits and (u is None or u.data_ptr() % 16 == 0)
            else "cp.async")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_step_3d(u, out, a0, cx, cy, cz) -> torch.Tensor:
    c = u[1:-1, 1:-1, 1:-1]
    new = combine_3d(c, u[:-2, 1:-1, 1:-1], u[2:, 1:-1, 1:-1],
                     u[1:-1, :-2, 1:-1], u[1:-1, 2:, 1:-1],
                     u[1:-1, 1:-1, :-2], u[1:-1, 1:-1, 2:], a0, cx, cy, cz)
    out.copy_(u)
    out[1:-1, 1:-1, 1:-1] = new
    return (new - c).abs().max()


def _plain_steps_bf16_3d(u, out, k, with_residual, a0, cx, cy, cz):
    """``k`` plain steps of a bfloat16 grid at the kernels' rounding
    points (storage mode): the cells widened exactly, each level float32
    and rounded to bfloat16 before the next step reads it, the last one
    stored rounded in ``out``; the residual the last step's float32
    update against the level it read. The faces are copied exactly."""
    v = widen_bits(u)
    res = None
    for s in range(k):
        c = v[1:-1, 1:-1, 1:-1]
        new = combine_3d(c, v[:-2, 1:-1, 1:-1], v[2:, 1:-1, 1:-1],
                         v[1:-1, :-2, 1:-1], v[1:-1, 2:, 1:-1],
                         v[1:-1, 1:-1, :-2], v[1:-1, 1:-1, 2:], a0, cx, cy,
                         cz)
        if with_residual and s == k - 1:
            res = (new - c).abs().max()
        if s < k - 1:
            new = widen_bits(new.to(_BF16))
        v[1:-1, 1:-1, 1:-1] = new
    out[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1]
    faces_exact(out, u)
    return res


def _plain_steps_3d(u, out, k, with_residual, cx, cy, cz):
    coeffs = coeffs3_f32(cx, cy, cz)
    if u.dtype == _BF16:
        return _plain_steps_bf16_3d(u, out, k, with_residual, *coeffs)
    return sk._plain_steps(u, out, k, with_residual,
                           lambda src, dst: _plain_step_3d(src, dst, *coeffs))


def slab_step_3d_plain(u: torch.Tensor, out: torch.Tensor, *, cx: float,
                       cy: float, cz: float) -> torch.Tensor:
    """Plain version of :func:`slab_step_3d`: one step of ``u`` into
    ``out``; returns the interior max-norm residual (0-d,
    NaN-propagating). A bfloat16 grid steps in float32, its interior
    rounded once and its faces copied bit for bit; the residual is the
    float32 update against the widened cell, before rounding."""
    counts["slab_step_3d_plain"] += 1
    return _plain_steps_3d(u, out, 1, True, cx, cy, cz)


def xslab_steps_3d_plain(u: torch.Tensor, out: torch.Tensor, k: int,
                         with_residual: bool = True, *, cx: float, cy: float,
                         cz: float) -> Optional[torch.Tensor]:
    """Plain version of :func:`xslab_steps_3d`: ``k`` plain steps of
    ``u``, the last one landing in ``out`` (at bfloat16 each level
    rounded, as :func:`slab_step_3d_plain` rounds it); the last step's
    residual, or None without ``with_residual``."""
    counts["xslab_steps_3d_plain"] += 1
    return _plain_steps_3d(u, out, k, with_residual, cx, cy, cz)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _launch_d(u, out, bits, cx, cy, cz, block, planes) -> None:
    """One launch of ``heat_d_step3d`` (``heat_d_step3d_bf16`` on a
    bfloat16 grid) with thread block ``block`` = (along Z, along Y), each
    thread walking ``planes`` X planes; raises if the launch is refused.
    Checks nothing and counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load

    name = sk.kernel_entry("D", u.dtype)
    lib = load(name)
    code = getattr(lib, name)(
        u.data_ptr(), out.data_ptr(), bits.data_ptr(), *u.shape, block[0],
        block[1], planes, *coeffs3_f32(cx, cy, cz), sk._stream(u))
    sk._raise_on_error(lib, "heat_d_step3d", code)


def _launch_f(u, out, k, bits, cx, cy, cz, block, rows, seg, load,
              prefetch=None) -> None:
    """One launch of ``heat_f_temporal3d`` (``heat_f_temporal3d_bf16`` on
    a bfloat16 grid) at depth ``k`` with thread blocks of ``block`` = (32
    lanes, warps), each thread ``rows`` rows deep, over segments of
    ``seg`` X planes, each plane's tile by ``load`` ("tma" or
    "cp.async"), ``prefetch`` planes in flight (``f_prefetch`` by
    default; ``bits`` None: no residual); raises if the launch is
    refused. Checks nothing and counts nothing."""
    from parallel_heat_tpu_torch.kernels.build import load as load_lib

    name = sk.kernel_entry("F", u.dtype)
    lib = load_lib(name)
    code = getattr(lib, name)(
        u.data_ptr(), out.data_ptr(), sk._ptr(bits), *u.shape, k, block[0],
        block[1], rows, seg, prefetch or params().f_prefetch,
        int(load == "tma"), *coeffs3_f32(cx, cy, cz), sk._stream(u))
    sk._raise_on_error(lib, name, code)


def f_occupancy(k: int, load: str, block=None, rows=None,
                prefetch=None, dtype="float32") -> int:
    """Thread blocks of F's ``(k, rows, load)`` instance at storage
    ``dtype`` that one SM of the current card holds at once (the CUDA
    occupancy calculator at the launch's shared memory, registers
    included); builds the kernel if needed."""
    import ctypes

    from parallel_heat_tpu_torch.kernels.build import load as load_lib

    p = params()
    (_, warps), rows = block or p.f_block, rows or p.f_rows
    name = sk.kernel_entry("F", dtype)
    lib = load_lib(name)
    fn = getattr(lib, f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    sk._raise_on_error(lib, name,
                       fn(k, warps, rows, int(load == "tma"),
                          prefetch or p.f_prefetch,
                          ctypes.addressof(blocks)))
    return blocks.value


def slab_step_3d(u: torch.Tensor, out: torch.Tensor, *, cx: float,
                 cy: float, cz: float) -> torch.Tensor:
    """Kernel D: one 7-point step of ``u`` into ``out`` plus the interior
    max-norm residual, a 0-d float32 tensor on ``u``'s device. Takes
    float32 and bfloat16 grids (``out`` of ``u``'s dtype; the updated
    cells round to bfloat16, the residual is taken before)."""
    sk._check(u, out, ndim=3, dtypes=sk.STORAGE_PAIRS)
    if u.device.type == "cpu":
        return slab_step_3d_plain(u, out, cx=cx, cy=cy, cz=cz)
    p = params()
    bits = torch.empty(1, dtype=torch.int32, device=u.device)
    _launch_d(u, out, bits, cx, cy, cz, p.d_block, p.d_planes)
    counts[sk.kernel_entry("D", u.dtype)] += 1
    return sk._residual_view(bits)


def f_geometry(shape, k: int, dtype="float32"):
    """``(block, rows, prefetch, segment planes)``: the launch of kernel F
    at depth ``k`` on an ``(X, Y, Z)`` grid of ``dtype``, as
    :func:`xslab_steps_3d` passes it (and the kernel audit's plans read
    it)."""
    p = params()
    elem = elem_size(dtype)
    block, rows, prefetch = p.f_shape(k, elem)
    _, _, seg = p.f_launch(tuple(shape), k, block, rows, elem)
    return block, rows, prefetch, seg


def xslab_steps_3d(u: torch.Tensor, out: torch.Tensor, k: int,
                   with_residual: bool = True, *, cx: float, cy: float,
                   cz: float, load: Optional[str] = None
                   ) -> Optional[torch.Tensor]:
    """Kernel F: ``k`` 7-point steps of ``u`` into ``out`` in one pass
    through global memory; returns the last step's residual (0-d float32
    tensor) or None without ``with_residual``. Bitwise ``k`` launches of
    :func:`slab_step_3d`, at float32 and at bfloat16 (every level rounded
    to bfloat16). ``load`` pins the plane load ("tma" or "cp.async"); by
    default :func:`f_load` picks it, and "tma" where the grid does not
    take it raises. Every compiled depth runs, at the launch shape
    :meth:`~.hopper_params.HopperParams.f_shape` gives it."""
    sk._check(u, out, ndim=3, dtypes=sk.STORAGE_PAIRS)
    p = params()
    if not 1 <= k <= p.f_k_compiled:
        raise ValueError(f"k must be in [1, {p.f_k_compiled}] (kernel F's "
                         f"compiled depths), got {k}")
    fits = f_load(u.shape, u)
    if load is None:
        load = fits
    elif load not in LOADS:
        raise ValueError(f"load must be one of {LOADS}, got {load!r}")
    elif load == "tma" and fits != "tma":
        raise ValueError(f"the TMA load needs nz % "
                         f"{16 // u.element_size()} == 0 at {u.dtype} and "
                         f"a 16-byte aligned grid; got {tuple(u.shape)}")
    if u.device.type == "cpu":
        return xslab_steps_3d_plain(u, out, k, with_residual, cx=cx, cy=cy,
                                    cz=cz)
    bits = (torch.empty(1, dtype=torch.int32, device=u.device)
            if with_residual else None)
    block, rows, prefetch, seg = f_geometry(tuple(u.shape), k, u.dtype)
    _launch_f(u, out, k, bits, cx, cy, cz, block, rows, seg, load, prefetch)
    counts[sk.kernel_entry("F", u.dtype)] += 1
    return sk._residual_view(bits) if bits is not None else None


# ---------------------------------------------------------------------------
# The decision site and the multistep
# ---------------------------------------------------------------------------

def pick_single_3d(shape, dtype="float32"):
    """The 3D single-device kernel decision: ``(kind, detail)`` with kind
    in {"F", "D", "torch"}, for a grid of storage ``dtype``.

    The one decision site: :func:`single_grid_multistep_3d` executes its
    result and ``solver.explain`` reports it. The default is F, the JAX
    package's first choice, at float32 and bfloat16 alike (its bfloat16
    form stores every level in bfloat16, as the JAX kernel does), its
    plane load :func:`f_load`'s (TMA where the rows are 16-byte
    multiples). A float64 grid takes the torch route, as the JAX package
    sends float64 to its jnp path (the kernels store float32 and
    bfloat16). Both kernels take every grid of at least 3 cells per axis
    (ValueError otherwise), so a choice pinned with
    ``tune.force("single_3d", ...)`` is always feasible at a dtype they
    store; that pin is how D runs at all.
    """
    if len(shape) != 3 or min(shape) < 3:
        raise ValueError(f"need a 3D grid of at least 3 cells per axis, "
                         f"got {tuple(shape)}")
    dtype = str(dtype).replace("torch.", "")
    if dtype == "float64":
        return "torch", None
    p = params()
    choice = tune.forced("single_3d") or "F"
    if choice == "torch":
        return "torch", None
    if choice == "F":
        k = p.f_k_default
        elem = elem_size(dtype)
        block, rows, _ = p.f_shape(k, elem)
        tile_y, tile_z, seg = p.f_launch(tuple(shape), k, elem=elem)
        return "F", {"k": k, "tile": (tile_y, tile_z), "block": block,
                     "rows": rows, "segment": seg,
                     "load": f_load(shape, dtype=dtype)}
    return "D", {"block": p.d_block, "planes": p.d_planes}


def single_grid_multistep_3d(config):
    """``(multi_step(u, v, n) -> (u, v), multi_step_residual(u, v, n) ->
    (u, v, res))`` for one device, 3D: the interface of
    :func:`.stencil_kernels.single_grid_multistep`.

    The kernel comes from :func:`pick_single_3d`; F is lifted to any
    number of steps by the same :func:`.stencil_kernels._chunked_multistep`
    as the 2D K-step kernels, as in the JAX package. The kernel library
    of a CUDA run is loaded here, before any clock starts.
    """
    from parallel_heat_tpu_torch.solver import (steps_to_multistep,
                                                torch_multistep)

    kind, detail = pick_single_3d(config.shape, config.dtype)
    cx, cy, cz = float(config.cx), float(config.cy), float(config.cz)
    if kind == "torch":
        return torch_multistep(cx, cy, cz)
    if torch.device(config.device).type == "cuda":
        from parallel_heat_tpu_torch.kernels.build import load

        load(sk.kernel_entry(kind, config.dtype))
    if kind == "F":
        def temporal(u, v, k, want_res):
            return xslab_steps_3d(u, v, k, want_res, cx=cx, cy=cy, cz=cz)

        return sk._chunked_multistep(temporal, detail["k"])

    def step(u, v):
        return slab_step_3d(u, v, cx=cx, cy=cy, cz=cz)

    return steps_to_multistep(step, step)
