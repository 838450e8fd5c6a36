"""Kernels G, G-circ, G-fuse, G-uni and the band fix: wrappers, plain
versions and the pickers of the sharded 2D round.

The port of the kernel-G family of ``parallel_heat_tpu/ops/pallas_stencil.py``
(csrc/heat_g.cuh has the design). Each advances one ``(bx, by)`` block
of an ``(m, n)`` grid cut over a mesh by ``k`` steps, from the block and
the K-deep halo its neighbours sent (``parallel/temporal.py``), and
returns the residual of the last step over the rows it writes:

- :func:`block_fused` launches ``heat_g_block_fused``, the counterpart of
  ``heat_g_block_fused``: the block ``u``, its column tail ``[hi | lo]``
  ``(bx, 2k)`` and the halo rows ``halo_n``/``halo_s`` ``(k, by + 2k)``
  as separate operands; with both halos None, the deferred bulk of the
  overlapped round (``defer_ns``): rows ``[k, bx - k)`` only;
- :func:`block_uniform` launches ``heat_g_block_uniform``, the
  counterpart of ``heat_g_block_uniform``: the same with kernel E-uni's
  16-byte load, for blocks whose width is a multiple of 4;
- :func:`block_circular` launches ``heat_g_block_circular``, the
  counterpart of ``heat_g_block_circular``: one assembled
  ``(bx + 2k, by + 2k)`` block ``[halo_n ; u | hi | lo ; halo_s]``;
- :func:`block_padded` launches ``heat_g_block_padded``, the counterpart
  of ``heat_g_block_padded``: one assembled block in the padded layout
  ``[lo | u | hi]`` between the halo rows (the TPU's lane-rounded junk
  columns are not needed and not taken);
- :func:`band_fix` launches ``heat_g_band_fix``, the counterpart of
  ``heat_g_band_fix_2d``: rows ``[0, k)`` and ``[bx - k, bx)`` of the
  same K steps, written into the bulk's output in place (no splice copy);
- every kernel steps with the register-blocked tile loop it shares with
  kernels E and E-uni (``csrc/heat_temporal.cuh``): thread blocks of 32
  lanes by ``W`` warps, each lane 4 adjacent columns of its warp's run of
  rows; the launch shapes it takes are
  :meth:`~.hopper_params.HopperParams.loop_takes`, checked at every
  launch;
- the ``*_plain`` functions compute the same in plain PyTorch: they
  assemble the padded frame with zeros outside the global grid and take
  ``k`` masked steps of :func:`~.stencil.combine_2d`, cells outside the
  global interior copied, exactly the kernels' rounding, so a kernel and
  its plain version agree bitwise on the card, and a block's K steps are
  bitwise kernel E's on the same cells of the global grid;
- every kernel has a bfloat16 form (``<name>_bf16``, the TPU builders'
  ``dtype_name="bfloat16"``), taken when the operands are bfloat16: the
  cells widened to float32 exactly as they load, float32 arithmetic,
  every level rounded to bfloat16 before the next step reads it, the
  last store rounded, the copied cells (the Dirichlet ring) narrowed
  exactly, the residual float32 against the float32 level the last step
  read. The plain versions step a bfloat16 frame the same way, so the
  bits still agree, and a block's K steps are bitwise K launches of
  kernel B's bfloat16 form on the same cells of the global grid.

``origin`` is the global ``(row, col)`` of the block's cell (0, 0) for
every form (the JAX padded builder takes the padded origin instead).
Each wrapper takes its plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. Launches and
plain calls count in :data:`~.stencil_kernels.counts`.

:func:`pick_block_temporal_2d` is the round's kernel decision and
:func:`pick_block_temporal_2d_deferred` says whether a round is split
into bulk and band.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import (coeffs_f32, combine_2d,
                                                 narrow_bits, widen_bits)
from parallel_heat_tpu_torch.ops.stencil_kernels import (_ptr,
                                                         _raise_on_error,
                                                         _residual_view,
                                                         _stream, counts)

# The round's kernel vocabulary (tune site "block_temporal_2d"); "torch"
# runs the textbook rounds of parallel/temporal.py.
G_KINDS = ("G-uni", "G-fuse", "G-circ", "G", "torch")
KERNEL_OF = {"G-uni": "heat_g_block_uniform", "G-fuse": "heat_g_block_fused",
             "G-circ": "heat_g_block_circular", "G": "heat_g_block_padded"}
BAND = "heat_g_band_fix"
# The bfloat16 forms' entry points (kernels/build.py ENTRIES: each in its
# float32 kernel's library).
KERNEL_OF_BF16 = {kind: name + "_bf16" for kind, name in KERNEL_OF.items()}
BAND_BF16 = BAND + "_bf16"
_F32, _BF16 = torch.float32, torch.bfloat16


def entry(name: str, dtype) -> str:
    """The entry point of kernel ``name`` (a float32 name of
    :data:`KERNEL_OF` or :data:`BAND`) for blocks of storage ``dtype``
    (a torch dtype or its name): its bfloat16 form's for bfloat16."""
    return name + "_bf16" if dtype in (_BF16, "bfloat16") else name


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def padded_of_circular(rows: torch.Tensor, by: int, k: int) -> torch.Tensor:
    """Columns ``[u | hi | lo]`` (circular) reordered to ``[lo | u | hi]``
    (padded)."""
    return torch.cat([rows[:, by + k:], rows[:, :by], rows[:, by:by + k]],
                     dim=1)


def _frame_of_pieces(u, tail, halo_n, halo_s, k):
    """The padded ``(bx + 2k, by + 2k)`` frame of the pieces, zero halo
    rows where the halos are None."""
    bx, by = u.shape
    ext = u.new_zeros((bx + 2 * k, by + 2 * k))
    ext[k:k + bx, :k] = tail[:, k:]
    ext[k:k + bx, k:k + by] = u
    ext[k:k + bx, k + by:] = tail[:, :k]
    if halo_n is not None:
        ext[:k] = padded_of_circular(halo_n, by, k)
        ext[k + bx:] = padded_of_circular(halo_s, by, k)
    return ext


def _in_grid(ext, origin, grid_shape, k):
    """``ext`` with every cell outside the global grid set to 0 (the
    kernels load nothing there); ``origin - k`` is the global index of
    its cell (0, ...). Any rank: the 3D kernels' plain versions share
    it."""
    dev = ext.device
    inside = None
    for axis, (o, n) in enumerate(zip(origin, grid_shape)):
        idx = o - k + torch.arange(ext.shape[axis], device=dev)
        m = ((idx >= 0) & (idx < n)).view(
            [-1 if a == axis else 1 for a in range(ext.dim())])
        inside = m if inside is None else inside & m
    return torch.where(inside, ext, torch.zeros((), device=dev))


def _interior(shape, start, grid_shape, device):
    """Boolean mask of a region of ``shape`` whose cell (0, ...) is at
    global index ``start``: True on the global interior. Any rank."""
    mask = None
    for axis, (s, n) in enumerate(zip(start, grid_shape)):
        idx = s + torch.arange(shape[axis], device=device)
        m = ((idx >= 1) & (idx <= n - 2)).view(
            [-1 if a == axis else 1 for a in range(len(shape))])
        mask = m if mask is None else mask & m
    return mask


def _frontier(win, k, start, grid_shape, combine, coeffs, with_residual,
              round_levels=False):
    """``k`` steps of the window ``win`` in place, its outer shell never
    updated and cells outside the global interior copied (``start`` is
    the global index of its cell (0, ...)); ``combine(c, lo0, hi0, lo1,
    hi1, ..., *coeffs)`` is the update, its neighbours axis by axis. The
    last step's ``|new - old|`` over the window's inner region, 0 where
    copied, or None without ``with_residual``. With ``round_levels`` (a
    float32 window of widened bfloat16 cells) every level but the last
    rounds its updated cells to bfloat16 before the next step reads
    them, as the kernels' storage mode does."""
    dev = win.device
    nd = win.dim()
    inner = (slice(1, -1),) * nd
    mask = _interior([b - 2 for b in win.shape], [s + 1 for s in start],
                     grid_shape, dev)

    def shifted(axis, lo):
        sl = list(inner)
        sl[axis] = slice(None, -2) if lo else slice(2, None)
        return win[tuple(sl)]

    diff = None
    for s in range(k):
        c = win[inner]
        pairs = [shifted(a, lo) for a in range(nd) for lo in (True, False)]
        new = combine(c, *pairs, *coeffs)
        if round_levels and s < k - 1:
            new = widen_bits(new.to(_BF16))
        new = torch.where(mask, new, c)
        if with_residual and s == k - 1:
            diff = torch.where(mask, (new - c).abs(),
                               torch.zeros((), device=dev))
        win[inner] = new
    return diff


def _stored(values, start, grid_shape, dtype):
    """The last level's float32 ``values`` (a region whose cell (0, ...)
    is at global ``start``) stored at ``dtype``: float32 as they are; at
    bfloat16 the global interior's cells rounded and the copied ones
    narrowed exactly (NaN payloads kept), as the kernels' last store."""
    if dtype != _BF16:
        return values
    return torch.where(_interior(values.shape, start, grid_shape,
                                 values.device),
                       values.to(_BF16), narrow_bits(values.contiguous()))


def _steps_plain(ext, out, k, with_residual, origin, grid_shape, windows,
                 combine, coeffs):
    """Run ``k`` steps on each window ``(w0, w1)`` of the padded frame's
    leading axis (a copy) and write its slabs ``[w0 + k, w1 - k)``, block
    slabs ``[w0, w1 - 2k)``, into ``out``; the max residual over the
    written cells, or None. Any rank. A bfloat16 frame is widened exactly
    and stepped in float32, each level rounded to bfloat16 (storage
    mode), the slabs stored by :func:`_stored`."""
    bf16 = ext.dtype == _BF16
    ext = _in_grid(widen_bits(ext) if bf16 else ext, origin, grid_shape, k)
    core = tuple(slice(k, k + b) for b in out.shape[1:])
    inner = tuple(slice(k - 1, k - 1 + b) for b in out.shape[1:])
    res = []
    for w0, w1 in windows:
        win = ext[w0:w1].clone()
        diff = _frontier(win, k, (origin[0] - k + w0,)
                         + tuple(o - k for o in origin[1:]), grid_shape,
                         combine, coeffs, with_residual, bf16)
        out[w0:w1 - 2 * k] = _stored(
            win[(slice(k, w1 - w0 - k),) + core],
            (origin[0] + w0,) + tuple(origin[1:]), grid_shape, out.dtype)
        if with_residual:
            res.append(diff[(slice(k - 1, w1 - w0 - k - 1),) + inner].max())
    return torch.stack(res).amax() if with_residual else None


def _steps_plain_2d(ext, out, k, with_residual, origin, grid_shape, cx, cy,
                    windows):
    return _steps_plain(ext, out, k, with_residual, origin, grid_shape,
                        windows, combine_2d, coeffs_f32(cx, cy))


def _block_rows(bx, k, defer):
    """The frame rows of the monolithic kernel or of the deferred bulk."""
    return [(k, k + bx)] if defer else [(0, bx + 2 * k)]


def block_padded_plain(ext, out, k, with_residual=True, *, origin,
                       grid_shape, cx, cy) -> Optional[torch.Tensor]:
    """Plain version of :func:`block_padded`."""
    counts["block_padded_plain"] += 1
    return _steps_plain_2d(ext, out, k, with_residual, origin, grid_shape,
                           cx, cy, _block_rows(out.shape[0], k, False))


def block_circular_plain(ext, out, k, with_residual=True, *, origin,
                         grid_shape, cx, cy) -> Optional[torch.Tensor]:
    """Plain version of :func:`block_circular`."""
    counts["block_circular_plain"] += 1
    return _steps_plain_2d(padded_of_circular(ext, out.shape[1], k), out, k,
                           with_residual, origin, grid_shape, cx, cy,
                           _block_rows(out.shape[0], k, False))


def _pieces_plain(u, tail, halo_n, halo_s, out, k, with_residual, origin,
                  grid_shape, cx, cy):
    defer = halo_n is None
    if defer and u.shape[0] == 2 * k:
        return (torch.zeros((), dtype=_F32, device=u.device)
                if with_residual else None)
    return _steps_plain_2d(_frame_of_pieces(u, tail, halo_n, halo_s, k), out,
                           k, with_residual, origin, grid_shape, cx, cy,
                           _block_rows(u.shape[0], k, defer))


def block_fused_plain(u, tail, halo_n, halo_s, out, k, with_residual=True, *,
                      origin, grid_shape, cx, cy) -> Optional[torch.Tensor]:
    """Plain version of :func:`block_fused`."""
    counts["block_fused_plain"] += 1
    return _pieces_plain(u, tail, halo_n, halo_s, out, k, with_residual,
                         origin, grid_shape, cx, cy)


def block_uniform_plain(u, tail, halo_n, halo_s, out, k, with_residual=True,
                        *, origin, grid_shape, cx,
                        cy) -> Optional[torch.Tensor]:
    """Plain version of :func:`block_uniform`."""
    counts["block_uniform_plain"] += 1
    return _pieces_plain(u, tail, halo_n, halo_s, out, k, with_residual,
                         origin, grid_shape, cx, cy)


def band_fix_plain(u, tail, halo_n, halo_s, out, k, with_residual=True, *,
                   origin, grid_shape, cx, cy) -> Optional[torch.Tensor]:
    """Plain version of :func:`band_fix`: the two ``3k``-row windows of
    the frame, each giving its middle ``k`` rows."""
    counts["band_fix_plain"] += 1
    bx = u.shape[0]
    return _steps_plain_2d(_frame_of_pieces(u, tail, halo_n, halo_s, k), out,
                           k, with_residual, origin, grid_shape, cx, cy,
                           [(0, 3 * k), (bx - k, bx + 2 * k)])


def _band_windows(u, tail, halo_n, halo_s, k):
    """The two ``3k``-row windows of a block's padded frame that the band
    kernel steps, ``(2, 3k, by + 2k)``, rows ``[0, 3k)`` and ``[bx - k,
    bx + 2k)``, built from the pieces without the frame."""
    bx, by = u.shape
    win = u.new_empty((2, 3 * k, by + 2 * k))

    def middle(rows):  # block rows in the padded layout [lo | u | hi]
        return torch.cat([tail[rows, k:], u[rows], tail[rows, :k]], dim=1)

    win[0, :k] = padded_of_circular(halo_n, by, k)
    win[0, k:] = middle(slice(0, 2 * k))
    win[1, :2 * k] = middle(slice(bx - 2 * k, bx))
    win[1, 2 * k:] = padded_of_circular(halo_s, by, k)
    return win


def band_fix_blocks_plain(us, tails, halos_n, halos_s, outs, k,
                          with_residual=True, *, origins, grid_shape, cx,
                          cy) -> Optional[torch.Tensor]:
    """Plain version of :func:`band_fix_blocks`: the two ``3k``-row
    windows of every block's frame stacked into one batch and stepped
    together, each cell masked by its own global position; the max
    residual over all the bands."""
    counts["band_fix_plain"] += 1
    bx, by = outs[0].shape
    m, n = grid_shape
    bf16 = outs[0].dtype == _BF16
    win = torch.cat([_band_windows(*x, k) for x in zip(us, tails, halos_n,
                                                         halos_s)])
    if bf16:
        win = widen_bits(win)
    rows0 = [o[0] - k + w0 for o in origins for w0 in (0, bx - k)]
    cols0 = [o[1] - k for o in origins for _ in range(2)]
    dev = win.device
    rows = (torch.tensor(rows0, device=dev)[:, None]
            + torch.arange(3 * k, device=dev))
    cols = (torch.tensor(cols0, device=dev)[:, None]
            + torch.arange(by + 2 * k, device=dev))
    in_grid = (((rows >= 0) & (rows < m))[:, :, None]
               & ((cols >= 0) & (cols < n))[:, None, :])
    win = torch.where(in_grid, win, torch.zeros((), device=dev))
    r, c = rows[:, 1:-1], cols[:, 1:-1]
    interior = (((r >= 1) & (r <= m - 2))[:, :, None]
                & ((c >= 1) & (c <= n - 2))[:, None, :])
    coeffs = coeffs_f32(cx, cy)
    diff = None
    for step in range(k):
        cur = win[:, 1:-1, 1:-1]
        new = combine_2d(cur, win[:, :-2, 1:-1], win[:, 2:, 1:-1],
                         win[:, 1:-1, :-2], win[:, 1:-1, 2:], *coeffs)
        if bf16 and step < k - 1:
            new = widen_bits(new.to(_BF16))
        new = torch.where(interior, new, cur)
        if with_residual and step == k - 1:
            diff = torch.where(interior, (new - cur).abs(),
                               torch.zeros((), device=dev))
        win[:, 1:-1, 1:-1] = new
    band = win[:, k:2 * k, k:k + by]
    if bf16:
        band = torch.where(interior[:, k - 1:2 * k - 1, k - 1:k - 1 + by],
                           band.to(_BF16), narrow_bits(band.contiguous()))
    for i, out in enumerate(outs):
        out[:k] = band[2 * i]
        out[bx - k:] = band[2 * i + 1]
    if not with_residual:
        return None
    return diff[:, k - 1:2 * k - 1, k - 1:k - 1 + by].amax()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_block(out, k, origin, grid_shape, tensors):
    """Shape, type, device and layout checks common to the five kernels;
    ``tensors`` maps a name to ``(tensor or None, expected shape)``. Every
    operand float32, or every one bfloat16 (the bfloat16 forms)."""
    if out.dim() != 2:
        raise ValueError(f"out must be a 2D block, got {tuple(out.shape)}")
    bx, by = out.shape
    m, n = grid_shape
    if not 1 <= k <= min(bx, by):
        raise ValueError(f"k must be in [1, min(block)] = [1, {min(bx, by)}]"
                         f", got {k}")
    if (origin[0] < 0 or origin[1] < 0 or origin[0] + bx > m
            or origin[1] + by > n):
        raise ValueError(f"block {tuple(out.shape)} at {tuple(origin)} does "
                         f"not lie in the grid {tuple(grid_shape)}")
    if out.dtype not in (_F32, _BF16):
        raise TypeError(f"float32 or bfloat16 blocks only, got out "
                        f"{out.dtype} (float64 runs the torch rounds)")
    for name, (t, shape) in {"out": (out, (bx, by)), **tensors}.items():
        if t is None:
            continue
        if t.dtype != out.dtype:
            raise TypeError(f"every operand of one launch at one dtype: "
                            f"{name} {t.dtype}, out {out.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if t.device != out.device:
            raise ValueError(f"{name} on {t.device}, out on {out.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "out" and t.data_ptr() == out.data_ptr():
            raise ValueError(f"out must be a different buffer from {name}")
    if out.device.type == "cuda":
        if out.device.index != torch.cuda.current_device():
            raise ValueError(f"block on {out.device} but the current device "
                             f"is cuda:{torch.cuda.current_device()}")
        if not 1 <= k <= params().g_k_max():
            raise ValueError(f"k must be in [1, {params().g_k_max()}] "
                             f"(shared-memory budget at tile "
                             f"{params().g_tile}), got {k}")
    elif out.device.type != "cpu":
        raise ValueError(f"unsupported device {out.device}")


def _pieces(out, u, tail, halo_n, halo_s, k):
    """The pieces' expected shapes, from the block ``out`` writes."""
    bx, by = out.shape
    if (halo_n is None) != (halo_s is None):
        raise ValueError("give both halo rows, or neither (the deferred "
                         "bulk)")
    return {"u": (u, (bx, by)), "tail": (tail, (bx, 2 * k)),
            "halo_n": (halo_n, (k, by + 2 * k)),
            "halo_s": (halo_s, (k, by + 2 * k))}


def _check_loop_shape(name, tile, block):
    p = params()
    if not p.loop_takes(tile, block):
        raise ValueError(f"{name}: the step loop does not take tiles of "
                         f"{tile} under thread blocks of {block} (32 lanes "
                         f"by 1 to {p.loop_max_warps} warps, a tile width "
                         f"that is a multiple of 4)")


def _launch(name, args, out, k, with_residual, *, origin, grid_shape, cx,
            cy, geometry):
    """Launch kernel ``name`` (its bfloat16 form for bfloat16 blocks) on
    ``args`` (its leading pointers) into ``out``; ``geometry`` the
    launch's int arguments after k (tile and thread block; the band
    kernel's tile is k rows of its tile_x, launched as a one-entry table).
    Checks only the launch shape
    (:meth:`~.hopper_params.HopperParams.loop_takes`, the launcher's own
    rule); counts the launch. Returns the residual view or None."""
    from parallel_heat_tpu_torch.kernels.build import load

    tile = (k,) + tuple(geometry[:1]) if name == BAND else tuple(geometry[:2])
    _check_loop_shape(name, tile, tuple(geometry[-2:]))
    if name == BAND:
        return BandLaunch([args[0]], [args[1]], [args[2]], [args[3]], [out],
                          k, origins=[origin], grid_shape=grid_shape, cx=cx,
                          cy=cy, geometry=geometry)(with_residual)
    form = entry(name, out.dtype)
    lib = load(form)
    bits = (torch.empty(1, dtype=torch.int32, device=out.device)
            if with_residual else None)
    code = getattr(lib, form)(
        *[_ptr(t) for t in args], out.data_ptr(), _ptr(bits),
        grid_shape[0], grid_shape[1], out.shape[0], out.shape[1], origin[0],
        origin[1], k, *geometry, *coeffs_f32(cx, cy), _stream(out))
    _raise_on_error(lib, name, code)
    counts[form] += 1
    return _residual_view(bits) if bits is not None else None


def _block_geometry():
    p = params()
    return (p.g_tile[0], p.g_tile[1], p.g_block[0], p.g_block[1])


def _assembled(name, plain, ext, out, k, with_residual, origin, grid_shape,
               cx, cy):
    bx, by = out.shape
    _check_block(out, k, origin, grid_shape,
                 {"ext": (ext, (bx + 2 * k, by + 2 * k))})
    if out.device.type == "cpu":
        return plain(ext, out, k, with_residual, origin=origin,
                     grid_shape=grid_shape, cx=cx, cy=cy)
    return _launch(name, (ext,), out, k, with_residual, origin=origin,
                   grid_shape=grid_shape, cx=cx, cy=cy,
                   geometry=_block_geometry())


def block_padded(ext: torch.Tensor, out: torch.Tensor, k: int,
                 with_residual: bool = True, *, origin, grid_shape, cx: float,
                 cy: float) -> Optional[torch.Tensor]:
    """Kernel G: ``k`` steps of the block whose padded frame ``ext``
    (``(bx + 2k, by + 2k)``, ``[lo | u | hi]`` between the halo rows) is
    given, into ``out`` ``(bx, by)``; the block's residual (0-d float32)
    or None."""
    return _assembled("heat_g_block_padded", block_padded_plain, ext, out, k,
                      with_residual, origin, grid_shape, cx, cy)


def block_circular(ext: torch.Tensor, out: torch.Tensor, k: int,
                   with_residual: bool = True, *, origin, grid_shape,
                   cx: float, cy: float) -> Optional[torch.Tensor]:
    """Kernel G-circ: :func:`block_padded` from the circular frame
    ``[halo_n ; u | hi | lo ; halo_s]``; bitwise the same outputs."""
    return _assembled("heat_g_block_circular", block_circular_plain, ext, out,
                      k, with_residual, origin, grid_shape, cx, cy)


def _from_pieces(name, plain, u, tail, halo_n, halo_s, out, k, with_residual,
                 origin, grid_shape, cx, cy):
    _check_block(out, k, origin, grid_shape,
                 _pieces(out, u, tail, halo_n, halo_s, k))
    bx, by = out.shape
    if halo_n is None and bx < 2 * k:
        raise ValueError(f"the deferred bulk needs at least 2k = {2 * k} "
                         f"rows, got a block of {bx}")
    if name == "heat_g_block_uniform" and not params().uni_fits(
            (bx, by), out.dtype):
        raise ValueError(f"kernel G-uni needs a block width that is a "
                         f"multiple of 4 (8 at bfloat16), got {(bx, by)} "
                         f"at {out.dtype}")
    if out.device.type == "cpu":
        return plain(u, tail, halo_n, halo_s, out, k, with_residual,
                     origin=origin, grid_shape=grid_shape, cx=cx, cy=cy)
    if name == "heat_g_block_uniform" and u.data_ptr() % 16:
        raise ValueError("kernel G-uni needs a 16-byte aligned block")
    if halo_n is None and bx == 2 * k:
        # The bands are the whole block: the bulk has no row to write.
        return (torch.zeros((), dtype=_F32, device=out.device)
                if with_residual else None)
    return _launch(name, (u, tail, halo_n, halo_s), out, k, with_residual,
                   origin=origin, grid_shape=grid_shape, cx=cx, cy=cy,
                   geometry=_block_geometry())


def block_fused(u: torch.Tensor, tail: torch.Tensor,
                halo_n: Optional[torch.Tensor], halo_s: Optional[torch.Tensor],
                out: torch.Tensor, k: int, with_residual: bool = True, *,
                origin, grid_shape, cx: float,
                cy: float) -> Optional[torch.Tensor]:
    """Kernel G-fuse: ``k`` steps of block ``u`` ``(bx, by)`` into ``out``
    from its tail ``[hi | lo]`` ``(bx, 2k)`` and halo rows ``(k, by + 2k)``
    (circular columns); the residual (0-d float32) or None. With both
    halos None, the deferred bulk: rows ``[k, bx - k)`` of ``out`` and
    their residual only, reading nothing of the exchange's second
    phase."""
    return _from_pieces("heat_g_block_fused", block_fused_plain, u, tail,
                        halo_n, halo_s, out, k, with_residual, origin,
                        grid_shape, cx, cy)


def block_uniform(u: torch.Tensor, tail: torch.Tensor,
                  halo_n: Optional[torch.Tensor],
                  halo_s: Optional[torch.Tensor], out: torch.Tensor, k: int,
                  with_residual: bool = True, *, origin, grid_shape,
                  cx: float, cy: float) -> Optional[torch.Tensor]:
    """Kernel G-uni: :func:`block_fused` with a uniform, vectorised load;
    bitwise the same outputs. Takes blocks whose width is a multiple of 4
    float32 or 8 bfloat16 cells (ValueError otherwise)."""
    return _from_pieces("heat_g_block_uniform", block_uniform_plain, u, tail,
                        halo_n, halo_s, out, k, with_residual, origin,
                        grid_shape, cx, cy)


def band_fix(u: torch.Tensor, tail: torch.Tensor, halo_n: torch.Tensor,
             halo_s: torch.Tensor, out: torch.Tensor, k: int,
             with_residual: bool = True, *, origin, grid_shape, cx: float,
             cy: float) -> Optional[torch.Tensor]:
    """The band kernel on one block: rows ``[0, k)`` and ``[bx - k, bx)``
    of ``k`` steps of block ``u``, written into ``out`` in place (the
    other rows are left as they are); the residual of exactly those rows
    (0-d float32) or None. ``bx`` must be at least ``2k``. A launch of
    :class:`BandLaunch` with one entry."""
    launch = BandLaunch([u], [tail], [halo_n], [halo_s], [out], k,
                        origins=[origin], grid_shape=grid_shape, cx=cx, cy=cy)
    if out.device.type == "cpu":
        return band_fix_plain(u, tail, halo_n, halo_s, out, k, with_residual,
                              origin=origin, grid_shape=grid_shape, cx=cx,
                              cy=cy)
    return launch(with_residual)


# Blocks a launch of the band kernel takes (csrc/heat_g_band_fix.cu
# kHeatGBandTable: 64 entries of 56 bytes keep its parameters under 4 KB);
# a round of more blocks launches in chunks.
BAND_TABLE = 64
# Its loads, by their code in csrc/heat_g_band_fix.cu (HeatGBandLoad).
BAND_LOADS = ("cells", "rows", "none")


class _BandEntry(ctypes.Structure):
    """One block of the band kernel's table (csrc/heat_g_band_fix.cu
    ``HeatGBandEntry``)."""

    _fields_ = [("u", ctypes.c_void_p), ("tail", ctypes.c_void_p),
                ("halo_n", ctypes.c_void_p), ("halo_s", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("row_off", ctypes.c_int64),
                ("col_off", ctypes.c_int64)]


class BandLaunch:
    """Every block's bands in one launch of ``heat_g_band_fix``: the
    blocks ``us`` (all of one shape, each with at least ``2k`` rows) with
    their tails and halo rows, each block's bands written into ``outs`` in
    place, ``origins`` their places in the grid.

    The operands are checked and the launch's table is built once, here;
    each call launches it (or, for tensors on the CPU, runs
    :func:`band_fix_blocks_plain`) and returns the residual of all the
    bands or None. A round keeps one for each of its two ping-pong
    buffers, so that it makes one host call for its bands. The table
    holds the tensors' addresses, not the tensors: the caller keeps them
    alive and unmoved. ``geometry`` ``(tile_x, lanes, warps)`` overrides
    ``g_band_tile_x`` and ``g_band_block`` (the sweep's shapes).

    :attr:`load` is the load the launch takes: ``"rows"`` (each window
    row's core columns 16 bytes at a time from the piece that holds it)
    where :meth:`~.hopper_params.HopperParams.g_band_row_load` takes the
    blocks and the pieces are 16-byte aligned, else ``"cells"``; ``load``
    pins one of :data:`BAND_LOADS` (``"rows"`` where it does not fit
    raises ValueError; ``"none"`` issues no load, a measurement of the
    steps alone whose output is not the band, on the card only, float32
    only). Bfloat16 blocks launch :data:`BAND_BF16` on the same table
    (:attr:`name`)."""

    def __init__(self, us, tails, halos_n, halos_s, outs, k: int, *,
                 origins, grid_shape, cx: float, cy: float, geometry=None,
                 load: Optional[str] = None):
        n = len(us)
        if not n or any(len(x) != n for x in (tails, halos_n, halos_s, outs,
                                              origins)):
            raise ValueError("give one tail, pair of halo rows, output and "
                             "origin for each of at least one block")
        for u, tail, hn, hs, out, o in zip(us, tails, halos_n, halos_s, outs,
                                           origins):
            if out.shape != outs[0].shape or out.device != outs[0].device:
                raise ValueError(f"blocks of one shape on one device only: "
                                 f"{tuple(out.shape)} on {out.device}, "
                                 f"{tuple(outs[0].shape)} on "
                                 f"{outs[0].device}")
            _check_block(out, k, tuple(o), grid_shape,
                         _pieces(out, u, tail, hn, hs, k))
            if hn is None:
                raise ValueError("the band kernel needs both halo rows")
            if out.dtype != outs[0].dtype:
                raise TypeError(f"blocks of one dtype only: {out.dtype} and "
                                f"{outs[0].dtype}")
        if outs[0].shape[0] < 2 * k:
            raise ValueError(f"the band kernel needs at least 2k = {2 * k} "
                             f"rows, got blocks of {outs[0].shape[0]}")
        p = params()
        self.geometry = tuple(geometry or (p.g_band_tile_x,)
                              + tuple(p.g_band_block))
        _check_loop_shape(BAND, (k, self.geometry[0]), self.geometry[1:])
        self.name = entry(BAND, outs[0].dtype)
        self.k, self.grid_shape = k, tuple(grid_shape)
        self.cx, self.cy = cx, cy
        self.blocks = n
        self.device = outs[0].device
        self.shape = tuple(outs[0].shape)
        # The load the launcher takes (csrc/heat_g_band_fix.cu
        # heat_g_band_row_load): "rows" or "cells".
        elem = outs[0].element_size()
        rows = (p.g_band_row_load(self.shape, k, elem)
                and self.geometry[0] % (16 // elem) == 0
                and not any(t.data_ptr() % 16
                            for t in (*us, *halos_n, *halos_s)))
        if load not in (None,) + BAND_LOADS:
            raise ValueError(f"load must be one of {BAND_LOADS}, got "
                             f"{load!r}")
        if load == "rows" and not rows:
            raise ValueError(f"the band's row load needs blocks whose width "
                             f"and halo rows (by + 2k) are multiples of "
                             f"{16 // elem} cells (the tile's width too) "
                             f"and 16-byte aligned pieces: blocks "
                             f"{self.shape} of {outs[0].dtype} at K={k}")
        if load == "none" and (self.device.type == "cpu" or elem == 2):
            raise ValueError("load='none' is a measurement on the card, "
                             "of the float32 band")
        self.load = load or ("rows" if rows else "cells")
        if self.device.type == "cpu":
            self._operands = tuple(list(x) for x in (
                us, tails, halos_n, halos_s, outs)) + (
                [tuple(o) for o in origins],)
            return
        self._table = (_BandEntry * n)(*[
            _BandEntry(u.data_ptr(), tail.data_ptr(), hn.data_ptr(),
                       hs.data_ptr(), out.data_ptr(), o[0], o[1])
            for u, tail, hn, hs, out, o in zip(us, tails, halos_n, halos_s,
                                               outs, origins)])
        self._args = (*self.grid_shape, *self.shape, k, *self.geometry,
                      *coeffs_f32(cx, cy))

    def __call__(self, with_residual: bool = True) -> Optional[torch.Tensor]:
        if self.device.type == "cpu":
            us, tails, hns, hss, outs, origins = self._operands
            return band_fix_blocks_plain(
                us, tails, hns, hss, outs, self.k, with_residual,
                origins=origins, grid_shape=self.grid_shape, cx=self.cx,
                cy=self.cy)
        from parallel_heat_tpu_torch.kernels.build import load

        lib = load(self.name)
        bits = (torch.empty(1, dtype=torch.int32, device=self.device)
                if with_residual else None)
        code = getattr(lib, self.name)(
            ctypes.addressof(self._table), self.blocks,
            BAND_LOADS.index(self.load), _ptr(bits),
            *self._args, torch.cuda.current_stream(self.device).cuda_stream)
        _raise_on_error(lib, BAND, code)
        counts[self.name] += -(-self.blocks // BAND_TABLE)  # one a chunk
        return _residual_view(bits) if bits is not None else None


def band_fix_blocks(us, tails, halos_n, halos_s, outs, k: int,
                    with_residual: bool = True, *, origins, grid_shape,
                    cx: float, cy: float) -> Optional[torch.Tensor]:
    """The band kernel on every block of a round in one launch
    (:class:`BandLaunch`, built and called once): rows ``[0, k)`` and
    ``[bx - k, bx)`` of ``k`` steps of each block ``us[i]`` into
    ``outs[i]`` in place; the residual of all the bands (0-d float32) or
    None."""
    return BandLaunch(us, tails, halos_n, halos_s, outs, k, origins=origins,
                      grid_shape=grid_shape, cx=cx, cy=cy)(with_residual)


LAUNCH = {"G-uni": block_uniform, "G-fuse": block_fused,
          "G-circ": block_circular, "G": block_padded}


# ---------------------------------------------------------------------------
# The decision sites
# ---------------------------------------------------------------------------

def pick_block_temporal_2d(block_shape, k: int, dtype="float32"):
    """The sharded 2D round's kernel decision at depth ``k`` for blocks of
    ``block_shape`` at storage ``dtype`` (float32 or bfloat16, a name or
    a torch dtype): ``(kind, detail)`` with kind in :data:`G_KINDS`;
    ``detail["kernel"]`` is the entry point the round launches (the
    bfloat16 form's for bfloat16).

    The one decision site: ``parallel/temporal.py`` executes its result
    and ``solver.explain`` reports it. By default G-uni where the block's
    width is a multiple of 4 float32 or 8 bfloat16 cells (its 16-byte
    loads), else G-fuse. G-circ and G read a caller-assembled extended
    block, one more full-block copy a round, and run only when pinned
    with ``tune.force("block_temporal_2d", ...)``; so do the torch
    rounds. A pinned choice that the geometry refuses raises ValueError.
    """
    choice = tune.forced("block_temporal_2d")
    shape = tuple(block_shape)
    if choice is not None:
        resolved = _resolve_block_temporal_2d(choice, shape, k, dtype)
        if resolved is None:
            raise ValueError(
                f"tune[block_temporal_2d]: forced choice {choice!r} is "
                f"infeasible for blocks {shape} of {dtype} at K={k} (K "
                f"must be in [1, {params().g_k_max()}] and at most the "
                f"smallest block extent; G-uni needs a width that is a "
                f"multiple of 4, 8 at bfloat16)")
        return resolved
    return (_resolve_block_temporal_2d("G-uni", shape, k, dtype)
            or _resolve_block_temporal_2d("G-fuse", shape, k, dtype))


def _resolve_block_temporal_2d(choice, block_shape, k, dtype="float32"):
    p = params()
    if choice == "torch":
        return "torch", None
    if not 1 <= k <= min(p.g_k_max(), *block_shape):
        return None
    if choice == "G-uni" and not p.uni_fits(block_shape, dtype):
        return None
    return choice, {"k": k, "tile": p.g_tile, "block": p.g_block,
                    "rows_per_warp": p.g_run(k),
                    "kernel": entry(KERNEL_OF[choice], dtype)}


def pick_block_temporal_2d_deferred(kind: str, block_shape, k: int,
                                    mode: str) -> bool:
    """Is a round of ``kind`` at depth ``k`` split into the deferred bulk
    and the band kernel? Under the ``overlap`` schedule, for the pieces
    forms (G-uni, G-fuse), on blocks of at least ``2k`` rows (two
    disjoint k-row bands); otherwise the monolithic kernel runs. A block
    of exactly ``2k`` rows is deferred with an empty bulk."""
    return (mode == "overlap" and kind in ("G-uni", "G-fuse")
            and block_shape[0] >= 2 * k)
