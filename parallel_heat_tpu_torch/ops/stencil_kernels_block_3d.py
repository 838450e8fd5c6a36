"""Kernels H, H-fused and the 3D band fix: wrappers, plain versions and
the pickers of the sharded 3D round.

The port of the kernel-H family of ``parallel_heat_tpu/ops/pallas_stencil.py``
(csrc/heat_h.cuh has the design). Each advances one ``(bx, by, bz)``
block of an ``(nx, ny, nz)`` grid cut over a mesh by ``k`` steps, from
the block and the K-deep halo its neighbours sent
(``parallel/temporal3d.py``), and returns the residual of the last step
over the planes it writes. A halo exists only on the axes along which
the block does not span the grid (:func:`halos_of`), as in the JAX
package:

- :func:`h_block_fused` launches ``heat_h_block_3d_fused``, the
  counterpart of ``heat_h_block_3d_fused``: the block ``u``, its z tail
  ``[hi | lo]`` ``(bx, by, 2k)``, its y tail ``(bx, 2k, bz + 2hz)`` and
  the x slabs ``xlo``/``xhi`` ``(k, by + 2hy, bz + 2hz)`` (y and z in the
  circular order ``[u | hi | lo]``) as separate operands, None for an
  unsharded axis; with ``defer_x``, the deferred bulk of the overlapped
  round: planes ``[k, bx - k)`` only, no x slab read. Its tiles inside
  the block load u's planes by TMA where the geometry allows it
  (:func:`h_load`), by a cp.async per cell elsewhere;
- :func:`h_block` launches ``heat_h_block_3d``, the counterpart of
  ``heat_h_block_3d``: one assembled circular block ``(bx + 2hx,
  by + 2hy, bz + 2hz)``, x in the order ``[lo | u | hi]``, contiguous or
  with rows padded (:func:`pitched_ok`), stepped on kernel F's plane
  loop; its tiles that need no ``lo`` cell load by TMA where the rows
  are multiples of 16 bytes (:func:`h_block_load`), the others by a
  cp.async per cell;
- :class:`BandLaunch3D` launches ``heat_h_band_fix_3d``, the counterpart
  of ``heat_h_band_fix_3d``: planes ``[0, k)`` and ``[bx - k, bx)`` of
  the same K steps of every block of a round in one launch, written into
  the bulks' outputs in place, each tile stepped on kernel F's plane
  loop; :func:`h_band_fix` is that launch with one block;
- the ``*_plain`` functions compute the same in plain PyTorch: they
  assemble the padded frame ``(bx + 2k, by + 2k, bz + 2k)`` with zeros
  outside the global grid and take ``k`` masked steps of
  :func:`~.stencil.combine_3d`, cells outside the global interior copied,
  exactly the kernels' rounding, so a kernel and its plain version agree
  bitwise on the card, and a block's K steps are bitwise kernel F's on
  the same cells of the global grid;
- every kernel has a bfloat16 form (``<name>_bf16``, the TPU builders'
  ``dtype_name="bfloat16"``), taken when the operands are bfloat16: the
  cells widened to float32 exactly as they load, float32 arithmetic,
  every level rounded to bfloat16 before the next step reads it, the
  last store rounded, the copied cells (the six faces) narrowed exactly,
  the residual float32 against the float32 level the last step read.
  The plain versions step a bfloat16 frame the same way, so the bits
  still agree, and a block's K steps are bitwise K launches of kernel
  D's bfloat16 form on the same cells of the global grid. H-fused's
  bfloat16 form loads no cell that a thread waits for before the step of
  its plane, under the float32 form's two names (:data:`LOADS`): the
  tiles inside the block take a bfloat16 TMA box a plane where
  ``bz % 8 == 0`` and the block holds such a tile (``"tma"``), every
  other cell a 4-byte ``cp.async`` of the word that holds it
  (``"cp.async"``), each a few planes ahead.

``origin`` is the global ``(x, y, z)`` of the block's cell (0, 0, 0) for
every form. Each wrapper takes its plain version only for a tensor that
lies on the CPU; for a CUDA tensor it launches the kernel or raises.
Launches and plain calls count in :data:`~.stencil_kernels.counts`.

:func:`pick_block_temporal_3d` is the round's kernel decision and
:func:`pick_block_temporal_3d_deferred` says whether a round is split
into bulk and band.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Optional

import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb
from parallel_heat_tpu_torch.ops.hopper_params import elem_size, params
from parallel_heat_tpu_torch.ops.stencil import (coeffs3_f32, combine_3d,
                                                 narrow_bits, widen_bits)
from parallel_heat_tpu_torch.ops.stencil_kernels import (_ptr,
                                                         _raise_on_error,
                                                         _residual_view,
                                                         _stream, counts)

# The round's kernel vocabulary (tune site "block_temporal_3d"): the
# monolithic fused round, the assembled block, the deferred bulk plus the
# band pair; "torch" runs the textbook rounds of parallel/temporal3d.py.
H_KINDS = ("H-fused", "H", "H-defer", "torch")
KERNEL_OF = {"H-fused": "heat_h_block_3d_fused", "H": "heat_h_block_3d",
             "H-defer": "heat_h_block_3d_fused"}
BAND = "heat_h_band_fix_3d"
# The bfloat16 forms' entry points (kernels/build.py KERNELS: a library
# each, beside their float32 twins').
KERNEL_OF_BF16 = {kind: name + "_bf16" for kind, name in KERNEL_OF.items()}
BAND_BF16 = BAND + "_bf16"
LOADS = ("tma", "cp.async")
_F32, _BF16 = torch.float32, torch.bfloat16


def entry(name: str, dtype) -> str:
    """The entry point of kernel ``name`` (a float32 name of
    :data:`KERNEL_OF` or :data:`BAND`) for blocks of storage ``dtype``
    (a torch dtype or its name): its bfloat16 form's for bfloat16."""
    return name + "_bf16" if elem_size(dtype) == 2 else name


def h_load(block_shape, k: int, u: Optional[torch.Tensor] = None,
           dtype="float32") -> str:
    """The plane load of H-fused's tiles inside a ``block_shape`` block
    (of ``u``, when given, whose dtype then decides) of storage ``dtype``
    at depth ``k``: ``"tma"`` where
    :meth:`~.hopper_params.HopperParams.h_tma_fits` holds at the dtype's
    cell size and u's address is a multiple of 16 bytes, else
    ``"cp.async"``. Geometry alone decides; the launch refuses TMA
    elsewhere and nothing falls back."""
    if u is not None:
        dtype = u.dtype
    fits = params().h_tma_fits(tuple(block_shape), k, elem=elem_size(dtype))
    return ("tma" if fits and (u is None or u.data_ptr() % 16 == 0)
            else "cp.async")


def pitched_ok(t: torch.Tensor) -> bool:
    """Is ``t`` (3D) a circular block kernel H reads: z contiguous, rows
    of ``t.stride(1) >= t.shape[2]`` floats (padded, or not), planes of
    ``t.shape[1]`` such rows, as ``DeepExchange3D.new_circular`` makes
    it?"""
    x, y, z = t.shape
    return (t.stride(2) == 1 or z == 1) and t.stride(1) >= z and (
        t.stride(0) == y * t.stride(1) or x == 1)


def h_block_load(ext: torch.Tensor) -> str:
    """Kernel H's plane load of the circular block ``ext``: ``"tma"``
    where its row pitch is a multiple of 16 bytes (4 float32 cells, 8
    bfloat16 ones) and its address of 16 bytes (a tensor map can be
    encoded over it; the tiles that need no ``lo`` cell then take one box
    a plane), else ``"cp.async"``. Geometry alone decides; the launch
    refuses TMA elsewhere and nothing falls back."""
    cells = 16 // elem_size(ext.dtype)
    return ("tma" if ext.stride(1) % cells == 0 and ext.data_ptr() % 16 == 0
            else "cp.async")


def halos_of(block_shape, grid_shape, k: int):
    """``(hx, hy, hz)``: ``k`` on the axes along which the block does not
    span the grid (the sharded ones), 0 on the others."""
    return tuple(k if b < n else 0 for b, n in zip(block_shape, grid_shape))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _copy_padded(dst, src, parts) -> None:
    """``dst.copy_(src)`` with each axis ``a`` of ``parts`` (``{a: (b,
    h)}``, ``b`` cells of u and ``h`` of each halo) reordered from the
    circular order ``[u | hi | lo]`` to the padded ``[lo | u | hi]``: one
    copy per combination of the axes' three runs, nothing concatenated."""
    runs = []
    for axis in range(src.dim()):
        b, h = parts.get(axis, (0, 0))
        runs.append([(slice(None), slice(None))] if not h else
                    [(slice(b + h, b + 2 * h), slice(0, h)),
                     (slice(0, b), slice(h, h + b)),
                     (slice(b, b + h), slice(h + b, b + 2 * h))])
    for combo in itertools.product(*runs):
        dst[tuple(d for _, d in combo)].copy_(src[tuple(s for s, _ in combo)])


def padded_lead(f, u, ztail, ytail, k) -> None:
    """Write planes ``[k, k + bx)`` of the padded frame ``f`` ``(bx + 2k,
    by + 2k, bz + 2k)`` (every axis ``[lo | u | hi]``) from the block and
    its tails (None for an unsharded axis: those cells are not
    written)."""
    _padded_planes(f[k:k + u.shape[0]], u, ztail, ytail, k)


def _padded_planes(mid, u, ztail, ytail, k) -> None:
    """Write ``mid`` ``(n, by + 2k, bz + 2k)`` from ``n`` planes of the
    block and of its tails, as :func:`padded_lead` writes its planes."""
    bx, by, bz = u.shape
    hz = k if ztail is not None else 0
    mid[:, k:k + by, k:k + bz].copy_(u)
    if ztail is not None:
        mid[:, k:k + by, :k].copy_(ztail[..., k:])
        mid[:, k:k + by, k + bz:].copy_(ztail[..., :k])
    if ytail is not None:
        zs = slice(k - hz, k + bz + hz)
        _copy_padded(mid[:, k + by:, zs], ytail[:, :k], {2: (bz, hz)})
        _copy_padded(mid[:, :k, zs], ytail[:, k:], {2: (bz, hz)})


def padded_slabs(f, xlo, xhi, k) -> None:
    """Write planes ``[0, k)`` and ``[k + bx, bx + 2k)`` of the padded
    frame ``f`` from the x slabs (y and z circular)."""
    _padded_slab(f[:k], xlo, k)
    _padded_slab(f[f.shape[0] - k:], xhi, k)


def _padded_slab(dst, slab, k) -> None:
    """Write the ``k`` padded planes ``dst`` from an x slab (y and z
    circular)."""
    by, bz = dst.shape[1] - 2 * k, dst.shape[2] - 2 * k
    hy, hz = (slab.shape[1] - by) // 2, (slab.shape[2] - bz) // 2
    _copy_padded(dst[:, k - hy:k + by + hy, k - hz:k + bz + hz], slab,
                 {1: (by, hy), 2: (bz, hz)})


def _frame_of_pieces(u, ztail, ytail, xlo, xhi, k):
    """The padded frame of the pieces, zeros where no piece is given."""
    f = u.new_zeros(tuple(b + 2 * k for b in u.shape))
    padded_lead(f, u, ztail, ytail, k)
    if xlo is not None:
        padded_slabs(f, xlo, xhi, k)
    return f


def _pieces_of_circular(ext, block_shape, halos):
    """``(u, ztail, ytail, xlo, xhi)`` views of an assembled circular
    block, None for an unsharded axis."""
    bx, by, bz = block_shape
    hx, hy, hz = halos
    core = ext[hx:hx + bx]
    return (core[:, :by, :bz], core[:, :by, bz:] if hz else None,
            core[:, by:] if hy else None, ext[:hx] if hx else None,
            ext[hx + bx:] if hx else None)


def _steps_plain(frame, out, k, with_residual, origin, grid_shape, cx, cy,
                 cz, windows):
    """The 2D module's windowed plain steps (``_steps_plain``, any rank)
    with the 7-point combine."""
    return skb._steps_plain(frame, out, k, with_residual, origin, grid_shape,
                            windows, combine_3d, coeffs3_f32(cx, cy, cz))


def _block_planes(bx, k, defer):
    """The frame planes of the monolithic kernel or of the deferred bulk."""
    return [(k, k + bx)] if defer else [(0, bx + 2 * k)]


def h_block_fused_plain(u, ztail, ytail, xlo, xhi, out, k,
                        with_residual=True, *, defer_x=False, origin,
                        grid_shape, cx, cy, cz) -> Optional[torch.Tensor]:
    """Plain version of :func:`h_block_fused`."""
    counts["h_block_fused_plain"] += 1
    if defer_x and u.shape[0] == 2 * k:
        return (torch.zeros((), dtype=_F32, device=u.device)
                if with_residual else None)
    return _steps_plain(
        _frame_of_pieces(u, ztail, ytail, None if defer_x else xlo,
                         None if defer_x else xhi, k),
        out, k, with_residual, origin, grid_shape, cx, cy, cz,
        _block_planes(u.shape[0], k, defer_x))


def h_block_plain(ext, out, k, with_residual=True, *, origin, grid_shape,
                  cx, cy, cz) -> Optional[torch.Tensor]:
    """Plain version of :func:`h_block`."""
    counts["h_block_plain"] += 1
    halos = halos_of(out.shape, grid_shape, k)
    return _steps_plain(
        _frame_of_pieces(*_pieces_of_circular(ext, out.shape, halos), k),
        out, k, with_residual, origin, grid_shape, cx, cy, cz,
        _block_planes(out.shape[0], k, False))


def h_band_fix_plain(u, ztail, ytail, xlo, xhi, out, k, with_residual=True,
                     *, origin, grid_shape, cx, cy,
                     cz) -> Optional[torch.Tensor]:
    """Plain version of :func:`h_band_fix`: the two ``3k``-plane windows
    of the frame, each giving its middle ``k`` planes."""
    counts["h_band_fix_plain"] += 1
    bx = u.shape[0]
    return _steps_plain(_frame_of_pieces(u, ztail, ytail, xlo, xhi, k), out,
                        k, with_residual, origin, grid_shape, cx, cy, cz,
                        [(0, 3 * k), (bx - k, bx + 2 * k)])


def _band_windows_3d(u, ztail, ytail, xlo, xhi, k):
    """The two ``3k``-plane windows of a block's padded frame that the band
    steps, ``(2, 3k, by + 2k, bz + 2k)``: frame planes ``[0, 3k)`` and
    ``[bx - k, bx + 2k)``, built from the pieces without the frame (zeros
    where no piece is given)."""
    bx, by, bz = u.shape
    win = u.new_zeros((2, 3 * k, by + 2 * k, bz + 2 * k))
    lo, hi = slice(0, 2 * k), slice(bx - 2 * k, bx)
    _padded_slab(win[0, :k], xlo, k)
    _padded_planes(win[0, k:], u[lo], _planes(ztail, lo), _planes(ytail, lo),
                   k)
    _padded_planes(win[1, :2 * k], u[hi], _planes(ztail, hi),
                   _planes(ytail, hi), k)
    _padded_slab(win[1, 2 * k:], xhi, k)
    return win


def _planes(t, sl):
    return None if t is None else t[sl]


def band_fix_blocks_3d_plain(us, ztails, ytails, xlos, xhis, outs, k,
                             with_residual=True, *, origins, grid_shape, cx,
                             cy, cz) -> Optional[torch.Tensor]:
    """Plain version of :func:`band_fix_blocks_3d`: the two ``3k``-plane
    windows of every block's frame stacked into one batch and stepped
    together, each cell zeroed outside the global grid and masked by its
    own global position, as :func:`h_band_fix_plain` steps one block's;
    the max residual over all the bands. Bfloat16 blocks are widened
    exactly and stepped in float32, each level but the last rounded to
    bfloat16, the bands stored as the kernels store them (the global
    interior's cells rounded, the copied ones narrowed exactly)."""
    counts["h_band_fix_plain"] += 1
    bx, by, bz = outs[0].shape
    bf16 = outs[0].dtype == _BF16
    win = torch.cat([_band_windows_3d(*x, k) for x in zip(
        us, ztails, ytails, xlos, xhis)])
    if bf16:
        win = widen_bits(win)
    dev = win.device
    # The global index of each window's cell (0, 0, 0), axis by axis.
    starts = [[o[0] + w0 for o in origins for w0 in (-k, bx - 2 * k)],
              [o[1] - k for o in origins for _ in range(2)],
              [o[2] - k for o in origins for _ in range(2)]]

    def inside(margin):
        """The cells ``margin`` or more from the windows' edges that lie
        ``margin`` or more inside the grid (0: in the grid, 1: in its
        interior)."""
        m = None
        for axis, (s0, n) in enumerate(zip(starts, grid_shape)):
            size = win.shape[axis + 1] - 2 * margin
            idx = (torch.tensor(s0, device=dev)[:, None] + margin
                   + torch.arange(size, device=dev))
            shape = [len(s0), 1, 1, 1]
            shape[axis + 1] = size
            a = ((idx >= margin) & (idx <= n - 1 - margin)).view(shape)
            m = a if m is None else m & a
        return m

    win = torch.where(inside(0), win, torch.zeros((), device=dev))
    interior = inside(1)
    coeffs = coeffs3_f32(cx, cy, cz)
    inner = (slice(None),) + (slice(1, -1),) * 3
    diff = None
    for step in range(k):
        c = win[inner]
        new = combine_3d(
            c, win[:, :-2, 1:-1, 1:-1], win[:, 2:, 1:-1, 1:-1],
            win[:, 1:-1, :-2, 1:-1], win[:, 1:-1, 2:, 1:-1],
            win[:, 1:-1, 1:-1, :-2], win[:, 1:-1, 1:-1, 2:], *coeffs)
        if bf16 and step < k - 1:
            new = widen_bits(new.to(_BF16))
        new = torch.where(interior, new, c)
        if with_residual and step == k - 1:
            diff = torch.where(interior, (new - c).abs(),
                               torch.zeros((), device=dev))
        win[inner] = new
    band = win[:, k:2 * k, k:k + by, k:k + bz]
    if bf16:
        band = torch.where(
            interior[:, k - 1:2 * k - 1, k - 1:k - 1 + by, k - 1:k - 1 + bz],
            band.to(_BF16), narrow_bits(band.contiguous()))
    for i, out in enumerate(outs):
        out[:k] = band[2 * i]
        out[bx - k:] = band[2 * i + 1]
    if not with_residual:
        return None
    return diff[:, k - 1:2 * k - 1, k - 1:k - 1 + by, k - 1:k - 1 + bz].amax()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_block(out, k, origin, grid_shape, tensors, k_max=None,
                 pitched=()):
    """Shape, type, device and layout checks common to the three kernels;
    ``tensors`` maps a name to ``(tensor or None, expected shape or None
    when the tensor must be None)``; the names in ``pitched`` may have
    padded rows (:func:`pitched_ok`). Every operand float32, or every one
    bfloat16 (the bfloat16 forms). On the card ``k`` is at most ``k_max``
    (the H-fused family's :meth:`h_k_max` by default)."""
    if out.dim() != 3:
        raise ValueError(f"out must be a 3D block, got {tuple(out.shape)}")
    if len(grid_shape) != 3 or min(grid_shape) < 3:
        raise ValueError(f"need a 3D grid of at least 3 cells per axis, got "
                         f"{tuple(grid_shape)}")
    if not 1 <= k <= min(out.shape):
        raise ValueError(f"k must be in [1, min(block)] = [1, "
                         f"{min(out.shape)}], got {k}")
    if any(o < 0 or o + b > n
           for o, b, n in zip(origin, out.shape, grid_shape)):
        raise ValueError(f"block {tuple(out.shape)} at {tuple(origin)} does "
                         f"not lie in the grid {tuple(grid_shape)}")
    if out.dtype not in (_F32, _BF16):
        raise TypeError(f"float32 or bfloat16 blocks only, got out "
                        f"{out.dtype} (float64 runs the torch rounds)")
    for name, (t, shape) in {"out": (out, tuple(out.shape)),
                             **tensors}.items():
        if shape is None:
            if t is not None:
                raise ValueError(f"{name} must be None: the block spans the "
                                 f"grid along its axis (no halo there)")
            continue
        if t is None:
            raise ValueError(f"{name} {shape} is needed: the block does not "
                             f"span the grid along its axis")
        if t.dtype != out.dtype:
            raise TypeError(f"every operand of one launch at one dtype: "
                            f"{name} {t.dtype}, out {out.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.device != out.device:
            raise ValueError(f"{name} on {t.device}, out on {out.device}")
        if name in pitched:
            if not pitched_ok(t):
                raise ValueError(
                    f"{name} must have contiguous rows of at least "
                    f"{shape[2]} cells, packed into planes; got strides "
                    f"{t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "out" and t.data_ptr() == out.data_ptr():
            raise ValueError(f"out must be a different buffer from {name}")
    if out.device.type == "cuda":
        if out.device.index != torch.cuda.current_device():
            raise ValueError(f"block on {out.device} but the current device "
                             f"is cuda:{torch.cuda.current_device()}")
        k_max = k_max or params().h_k_max()
        if not 1 <= k <= k_max:
            raise ValueError(f"k must be in [1, {k_max}] (the H kernels' "
                             f"compiled depths and shared memory), got {k}")
    elif out.device.type != "cpu":
        raise ValueError(f"unsupported device {out.device}")


def _pieces(out, u, ztail, ytail, xlo, xhi, k, halos, with_x=True):
    """The pieces' expected shapes (None: the piece must be None)."""
    bx, by, bz = out.shape
    hx, hy, hz = halos
    ye, ze = by + 2 * hy, bz + 2 * hz
    slab = (k, ye, ze) if hx and with_x else None
    return {"u": (u, (bx, by, bz)),
            "ztail": (ztail, (bx, by, 2 * k) if hz else None),
            "ytail": (ytail, (bx, 2 * k, ze) if hy else None),
            "xlo": (xlo, slab), "xhi": (xhi, slab)}


def _launch(name, args, out, k, with_residual, *, origin, grid_shape, cx,
            cy, cz, mid, geometry):
    """Launch kernel ``name`` (H or H-fused; its bfloat16 form for
    bfloat16 blocks) on ``args`` (its leading pointers) into ``out``;
    ``mid`` the int arguments between the origin and k (halos, and defer_x
    and tma for the fused form), ``geometry`` those after k (thread block,
    rows per thread, X segment and, for H, prefetch and load). Checks
    nothing; counts the launch. Returns the residual view or None."""
    from parallel_heat_tpu_torch.kernels.build import load

    form = entry(name, out.dtype)
    lib = load(form)
    bits = (torch.empty(1, dtype=torch.int32, device=out.device)
            if with_residual else None)
    code = getattr(lib, form)(
        *[_ptr(t) for t in args], out.data_ptr(), _ptr(bits), *grid_shape,
        *out.shape, *origin, *mid, k, *geometry, *coeffs3_f32(cx, cy, cz),
        _stream(out))
    _raise_on_error(lib, form, code)
    counts[form] += 1
    return _residual_view(bits) if bits is not None else None


def h_fused_occupancy(k: int, load: str, block=None, rows=None,
                      dtype="float32") -> int:
    """Thread blocks of H-fused's ``(k, rows, load)`` instance (its
    bfloat16 form's at ``dtype`` bfloat16, compiled at ``h_rows`` only)
    that one SM of the current card holds at once (the CUDA occupancy
    calculator at the launch's shared memory); builds the kernel if
    needed."""
    from parallel_heat_tpu_torch.kernels.build import load as load_lib

    p = params()
    (bz, by), rows = block or p.h_block, rows or p.h_rows
    name = entry("heat_h_block_3d_fused", dtype)
    lib = load_lib(name)
    fn = getattr(lib, name + "_occupancy")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _raise_on_error(lib, name,
                    fn(k, rows, int(load == "tma"), bz, by,
                       ctypes.addressof(blocks)))
    return blocks.value


def h_occupancy(k: int, dtype="float32") -> int:
    """Thread blocks of kernel H's instance at depth ``k`` (its shape of
    :meth:`~.hopper_params.HopperParams.hc_shape`; its bfloat16 form's at
    ``dtype`` bfloat16) that one SM of the current card holds at once;
    builds the kernel if needed."""
    from parallel_heat_tpu_torch.kernels.build import load as load_lib

    (_, warps), rows, prefetch = params().hc_shape(k, elem_size(dtype))
    name = entry("heat_h_block_3d", dtype)
    lib = load_lib(name)
    fn = getattr(lib, name + "_occupancy")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _raise_on_error(lib, name,
                    fn(k, warps, rows, prefetch, ctypes.addressof(blocks)))
    return blocks.value


def _geometry(block_shape, k, planes):
    p = params()
    return (p.h_block[0], p.h_block[1], p.h_rows,
            p.h_launch(block_shape, k, planes))


def h_block(ext: torch.Tensor, out: torch.Tensor, k: int,
            with_residual: bool = True, *, load: Optional[str] = None,
            origin, grid_shape, cx: float, cy: float,
            cz: float) -> Optional[torch.Tensor]:
    """Kernel H: ``k`` steps of the block whose circular extended block
    ``ext`` (``(bx + 2hx, by + 2hy, bz + 2hz)``, :func:`halos_of`;
    contiguous or with padded rows, :func:`pitched_ok`) is given, into
    ``out`` ``(bx, by, bz)``; the block's residual (0-d float32) or None.
    ``load`` (one of :data:`LOADS`) pins the plane load, which
    :func:`h_block_load` chooses by default; ``"tma"`` where the layout
    refuses it raises. Both loads give the same bits. Bfloat16 blocks
    launch ``heat_h_block_3d_bf16`` (rows padded to 8 cells for TMA)."""
    p = params()
    halos = halos_of(out.shape, grid_shape, k)
    elem = elem_size(out.dtype)
    _check_block(out, k, origin, grid_shape, {
        "ext": (ext, tuple(b + 2 * h for b, h in zip(out.shape, halos)))},
        k_max=p.hc_k_max(elem), pitched=("ext",))
    fits = h_block_load(ext)
    if load is None:
        load = fits
    elif load not in LOADS:
        raise ValueError(f"load must be one of {LOADS}, got {load!r}")
    elif load == "tma" and fits != "tma":
        raise ValueError(
            f"the TMA load needs the circular block's rows padded to a "
            f"multiple of 16 bytes ({16 // elem} cells of {out.dtype}) and a "
            f"16-byte aligned block; got strides {ext.stride()} at an "
            f"address of {ext.data_ptr() % 16} mod 16")
    if out.device.type == "cpu":
        return h_block_plain(ext, out, k, with_residual, origin=origin,
                             grid_shape=grid_shape, cx=cx, cy=cy, cz=cz)
    return _launch_h(ext, out, k, with_residual, load,
                     p.hc_launch(out.shape, k, elem=elem), origin=origin,
                     grid_shape=grid_shape, cx=cx, cy=cy, cz=cz)


def _launch_h(ext, out, k, with_residual, load, launch, *, origin,
              grid_shape, cx, cy, cz) -> Optional[torch.Tensor]:
    """Kernel H's launch under ``load`` at ``launch`` ``(block, rows,
    prefetch, segment)`` (:meth:`~.hopper_params.HopperParams.hc_launch`;
    the sweep passes others). Checks nothing; counts the launch."""
    (lanes, warps), rows, prefetch, seg = launch
    return _launch("heat_h_block_3d", (ext,), out, k, with_residual,
                   origin=origin, grid_shape=grid_shape, cx=cx, cy=cy, cz=cz,
                   mid=halos_of(out.shape, grid_shape, k) + (ext.stride(1),),
                   geometry=(lanes, warps, rows, seg, prefetch,
                             int(load == "tma")))


def h_block_fused(u: torch.Tensor, ztail: Optional[torch.Tensor],
                  ytail: Optional[torch.Tensor], xlo: Optional[torch.Tensor],
                  xhi: Optional[torch.Tensor], out: torch.Tensor, k: int,
                  with_residual: bool = True, *, defer_x: bool = False,
                  load: Optional[str] = None, origin, grid_shape, cx: float,
                  cy: float, cz: float) -> Optional[torch.Tensor]:
    """Kernel H-fused: ``k`` steps of block ``u`` ``(bx, by, bz)`` into
    ``out`` from its pieces (a piece of an unsharded axis is None); the
    residual (0-d float32) or None. With ``defer_x``, the deferred bulk:
    planes ``[k, bx - k)`` of ``out`` and their residual only, reading no
    x slab (give None for both); ``bx`` must be at least ``2k``. ``load``
    (one of :data:`LOADS`) pins the plane load of the tiles inside the
    block, which :func:`h_load` chooses by default; ``"tma"`` where the
    geometry refuses it raises. Both loads give the same bits. Bfloat16
    blocks launch ``heat_h_block_3d_fused_bf16`` under the same two
    loads (its box ``"tma"`` needs ``bz % 8 == 0``)."""
    halos = halos_of(u.shape, grid_shape, k)
    _check_block(out, k, origin, grid_shape,
                 _pieces(out, u, ztail, ytail, xlo, xhi, k, halos,
                         with_x=not defer_x))
    bx = out.shape[0]
    if defer_x and bx < 2 * k:
        raise ValueError(f"the deferred bulk needs at least 2k = {2 * k} "
                         f"x-planes, got a block of {bx}")
    elem = elem_size(u.dtype)
    fits = h_load(u.shape, k, u)
    if load is None:
        load = fits
    elif load not in LOADS:
        raise ValueError(f"load must be one of {LOADS}, got {load!r}")
    elif load == "tma" and fits != "tma":
        p = params()
        raise ValueError(
            f"the TMA load needs bz % {16 // elem} == 0 ({u.dtype}), "
            f"{p.h_tma_rows} rows a thread, a tile inside the block at K={k} "
            f"(extended tile {p.h_extent()} (Y, Z)) and a 16-byte "
            f"aligned block; got a block of {tuple(u.shape)}")
    if out.device.type == "cpu":
        return h_block_fused_plain(u, ztail, ytail, xlo, xhi, out, k,
                                   with_residual, defer_x=defer_x,
                                   origin=origin, grid_shape=grid_shape,
                                   cx=cx, cy=cy, cz=cz)
    if defer_x and bx == 2 * k:
        # The bands are the whole block: the bulk has no plane to write.
        return (torch.zeros((), dtype=torch.float32, device=out.device)
                if with_residual else None)
    planes = bx - 2 * k if defer_x else bx
    return _launch("heat_h_block_3d_fused", (u, ztail, ytail, xlo, xhi), out,
                   k, with_residual, origin=origin, grid_shape=grid_shape,
                   cx=cx, cy=cy, cz=cz,
                   mid=halos + (int(defer_x), int(load == "tma")),
                   geometry=_geometry(out.shape, k, planes))


def h_band_fix(u: torch.Tensor, ztail: Optional[torch.Tensor],
               ytail: Optional[torch.Tensor], xlo: torch.Tensor,
               xhi: torch.Tensor, out: torch.Tensor, k: int,
               with_residual: bool = True, *, origin, grid_shape, cx: float,
               cy: float, cz: float) -> Optional[torch.Tensor]:
    """The band kernel on one block: planes ``[0, k)`` and ``[bx - k, bx)``
    of ``k`` steps of block ``u``, written into ``out`` in place (the
    other planes are left as they are); the residual of exactly those
    planes (0-d float32) or None. x must be sharded (the slabs given) and
    ``bx`` at least ``2k``. A launch of :class:`BandLaunch3D` with one
    entry."""
    launch = BandLaunch3D([u], [ztail], [ytail], [xlo], [xhi], [out], k,
                          origins=[origin], grid_shape=grid_shape, cx=cx,
                          cy=cy, cz=cz)
    if out.device.type == "cpu":
        return h_band_fix_plain(u, ztail, ytail, xlo, xhi, out, k,
                                with_residual, origin=origin,
                                grid_shape=grid_shape, cx=cx, cy=cy, cz=cz)
    return launch(with_residual)


# Blocks a launch of the band kernel takes (csrc/heat_h_band_fix_3d.cu
# kHeatHBandTable: 48 entries of 72 bytes keep its parameters under 4
# KB); a round of more blocks launches in chunks.
BAND_TABLE_3D = 48
# Its loads, by their code in csrc/heat_h_band_fix_3d.cu (HeatHBandLoad):
# a 4-byte cp.async a cell, or 16 bytes a lane where its cells are one
# aligned run of the block.
BAND_LOADS_3D = ("cells", "vec")


class _BandEntry3D(ctypes.Structure):
    """One block of the 3D band kernel's table
    (csrc/heat_h_band_fix_3d.cu ``HeatHBandEntry``)."""

    _fields_ = [("u", ctypes.c_void_p), ("ztail", ctypes.c_void_p),
                ("ytail", ctypes.c_void_p), ("xlo", ctypes.c_void_p),
                ("xhi", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ox", ctypes.c_int64), ("oy", ctypes.c_int64),
                ("oz", ctypes.c_int64)]


class BandLaunch3D:
    """Every block's bands in one launch of ``heat_h_band_fix_3d``: the
    blocks ``us`` (all of one shape, x sharded, each with at least ``2k``
    planes) with their tails (None along an unsharded axis) and x slabs,
    each block's bands written into ``outs`` in place, ``origins`` their
    places in the grid.

    The operands are checked and the launch's table is built once, here;
    each call launches it (or, for tensors on the CPU, runs
    :func:`band_fix_blocks_3d_plain`) and returns the residual of all the
    bands or None. A round keeps one for each of its two ping-pong
    buffers, so that it makes one host call for its bands. The table holds
    the tensors' addresses, not the tensors: the caller keeps them alive
    and unmoved. ``shape`` ``(block, rows, prefetch)`` overrides
    :meth:`~.hopper_params.HopperParams.h_band_shape` (the sweep's
    shapes).

    :attr:`load` is the load the launch takes: ``"vec"`` (16 bytes a lane
    where its four cells are one aligned run of the block; 8 at
    bfloat16) where :meth:`~.hopper_params.HopperParams.h_band_vec_fits`
    takes the blocks and every block is 16-byte aligned, else
    ``"cells"``; ``load`` pins one of :data:`BAND_LOADS_3D` (``"vec"``
    where it does not fit raises ValueError). Bfloat16 blocks launch
    :data:`BAND_BF16` on the same table (:attr:`name`)."""

    def __init__(self, us, ztails, ytails, xlos, xhis, outs, k: int, *,
                 origins, grid_shape, cx: float, cy: float, cz: float,
                 shape=None, load: Optional[str] = None):
        n = len(us)
        if not n or any(len(x) != n for x in (ztails, ytails, xlos, xhis,
                                              outs, origins)):
            raise ValueError("give one z tail, y tail, pair of x slabs, "
                             "output and origin for each of at least one "
                             "block")
        p = params()
        bs = tuple(outs[0].shape)
        elem = elem_size(outs[0].dtype)
        halos = halos_of(bs, grid_shape, k)
        if not halos[0]:
            raise ValueError("the band kernel needs the x slabs: the block "
                             "spans the grid along x")
        for u, zt, yt, lo, hi, out, o in zip(us, ztails, ytails, xlos, xhis,
                                             outs, origins):
            if tuple(out.shape) != bs or out.device != outs[0].device:
                raise ValueError(f"blocks of one shape on one device only: "
                                 f"{tuple(out.shape)} on {out.device}, {bs} "
                                 f"on {outs[0].device}")
            if out.dtype != outs[0].dtype:
                raise TypeError(f"blocks of one dtype only: {out.dtype} and "
                                f"{outs[0].dtype}")
            _check_block(out, k, tuple(o), grid_shape,
                         _pieces(out, u, zt, yt, lo, hi, k, halos),
                         k_max=p.h_band_k_max(elem))
        if bs[0] < 2 * k:
            raise ValueError(f"the band kernel needs at least 2k = {2 * k} "
                             f"x-planes, got blocks of {bs[0]}")
        self.shape = tuple(shape or p.h_band_shape(k, elem) or ())
        if not self.shape or not p.h_band_takes(*self.shape[:2], k, elem) or (
                k > p.f_k_max(*self.shape, elem)):
            raise ValueError(f"the band's plane loop does not take the shape "
                             f"{self.shape} (block, rows, prefetch) at K={k} "
                             f"on {outs[0].dtype} blocks")
        vec = p.h_band_vec_fits(bs, elem) and not any(u.data_ptr() % 16
                                                      for u in us)
        if load not in (None,) + BAND_LOADS_3D:
            raise ValueError(f"load must be one of {BAND_LOADS_3D}, got "
                             f"{load!r}")
        if load == "vec" and not vec:
            raise ValueError(f"the band's 16-byte load (8 bytes a lane at "
                             f"bfloat16) needs rows of a multiple of 16 "
                             f"bytes (bz % {16 // elem} == 0 at "
                             f"{outs[0].dtype}) and 16-byte aligned blocks: "
                             f"blocks {bs}")
        self.name = entry(BAND, outs[0].dtype)
        self.load = load or ("vec" if vec else "cells")
        self.k, self.grid_shape, self.blocks = k, tuple(grid_shape), n
        self.cx, self.cy, self.cz = cx, cy, cz
        self.device = outs[0].device
        if self.device.type == "cpu":
            self._operands = tuple(list(x) for x in (
                us, ztails, ytails, xlos, xhis, outs)) + (
                [tuple(o) for o in origins],)
            return
        self._table = (_BandEntry3D * n)(*[
            _BandEntry3D(u.data_ptr(), _ptr(zt), _ptr(yt), lo.data_ptr(),
                         hi.data_ptr(), out.data_ptr(), *o)
            for u, zt, yt, lo, hi, out, o in zip(us, ztails, ytails, xlos,
                                                 xhis, outs, origins)])
        (lanes, warps), rows, prefetch = self.shape
        self._args = (*self.grid_shape, *bs, *halos[1:], k, lanes, warps,
                      rows, prefetch, *coeffs3_f32(cx, cy, cz))

    def __call__(self, with_residual: bool = True) -> Optional[torch.Tensor]:
        if self.device.type == "cpu":
            us, zts, yts, los, his, outs, origins = self._operands
            return band_fix_blocks_3d_plain(
                us, zts, yts, los, his, outs, self.k, with_residual,
                origins=origins, grid_shape=self.grid_shape, cx=self.cx,
                cy=self.cy, cz=self.cz)
        from parallel_heat_tpu_torch.kernels.build import load

        lib = load(self.name)
        bits = (torch.empty(1, dtype=torch.int32, device=self.device)
                if with_residual else None)
        code = getattr(lib, self.name)(
            ctypes.addressof(self._table), self.blocks,
            BAND_LOADS_3D.index(self.load), _ptr(bits), *self._args,
            torch.cuda.current_stream(self.device).cuda_stream)
        _raise_on_error(lib, self.name, code)
        counts[self.name] += -(-self.blocks // BAND_TABLE_3D)  # one a chunk
        return _residual_view(bits) if bits is not None else None


def band_fix_blocks_3d(us, ztails, ytails, xlos, xhis, outs, k: int,
                       with_residual: bool = True, *, origins, grid_shape,
                       cx: float, cy: float,
                       cz: float) -> Optional[torch.Tensor]:
    """The band kernel on every block of a round in one launch
    (:class:`BandLaunch3D`, built and called once): planes ``[0, k)`` and
    ``[bx - k, bx)`` of ``k`` steps of each block ``us[i]`` into
    ``outs[i]`` in place; the residual of all the bands (0-d float32) or
    None."""
    return BandLaunch3D(us, ztails, ytails, xlos, xhis, outs, k,
                        origins=origins, grid_shape=grid_shape, cx=cx, cy=cy,
                        cz=cz)(with_residual)


# ---------------------------------------------------------------------------
# The decision sites
# ---------------------------------------------------------------------------

def pick_block_temporal_3d(block_shape, k: int, dtype="float32"):
    """The sharded 3D round's kernel decision at depth ``k`` for blocks of
    ``block_shape`` at storage ``dtype`` (float32 or bfloat16, a name or a
    torch dtype): ``(kind, detail)`` with kind in :data:`H_KINDS`;
    ``detail["kernel"]`` is the entry point the round launches (the
    bfloat16 form's for bfloat16) and, for H-fused and H-defer,
    ``detail["load"]`` the load of the tiles inside the block
    (:func:`h_load`).

    The one decision site: ``parallel/temporal3d.py`` executes its result
    and ``solver.explain`` reports it. By default H-fused, whose round is
    monolithic on one process (:func:`pick_block_temporal_3d_deferred`).
    H (the assembled block, one more full-block copy a round), H-defer
    (the deferred bulk plus the band pair) and the torch rounds run only
    when pinned with ``tune.force("block_temporal_3d", ...)``. A pinned
    choice that the geometry refuses raises ValueError.
    """
    choice = tune.forced("block_temporal_3d") or "H-fused"
    if choice == "torch":
        return "torch", None
    p = params()
    elem = elem_size(dtype)
    k_max = p.hc_k_max(elem) if choice == "H" else p.h_k_max()
    if not 1 <= k <= min(k_max, *block_shape):
        raise ValueError(
            f"tune[block_temporal_3d]: choice {choice!r} is infeasible for "
            f"blocks {tuple(block_shape)} of {dtype} at K={k} (K must be in "
            f"[1, {k_max}] and at most the smallest block extent)")
    if choice == "H":
        (lanes, warps), rows, _ = p.hc_shape(k, elem)
        return choice, {"k": k, "block": (lanes, warps), "rows": rows,
                        "kernel": entry(KERNEL_OF[choice], dtype)}
    detail = {"k": k, "block": p.h_block, "rows": p.h_rows,
              "kernel": entry(KERNEL_OF[choice], dtype),
              "load": h_load(block_shape, k, dtype=dtype)}
    return choice, detail


def pick_block_temporal_3d_deferred(kind: str, block_shape, mesh_shape,
                                    k: int, mode: str) -> bool:
    """Is a round of ``kind`` at depth ``k`` split into the deferred bulk
    and the band kernel?

    The JAX package's gate (``pick_block_temporal_3d_deferred``): only
    when x is sharded and the run spans several processes, because the 3D
    band pass costs a share of the round that pays only when the x hop is
    slow (there, ~11% of a round at the 256^3 block). This package runs
    one process, so the default H-fused round is monolithic under every
    schedule; the split runs only when pinned (``H-defer``), under the
    ``overlap`` schedule, with x sharded and at least ``2k`` x-planes a
    block (a block of exactly ``2k`` is deferred with an empty bulk);
    elsewhere the pinned kind runs the monolithic fused round."""
    return (kind == "H-defer" and mode == "overlap" and mesh_shape[0] > 1
            and block_shape[0] >= 2 * k)
