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
  bitwise kernel E's on the same cells of the global grid.

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

from typing import Optional

import torch

from parallel_heat_tpu_torch import tune
from parallel_heat_tpu_torch.ops.hopper_params import params
from parallel_heat_tpu_torch.ops.stencil import coeffs_f32, combine_2d
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


def _frontier(win, k, start, grid_shape, combine, coeffs, with_residual):
    """``k`` steps of the window ``win`` in place, its outer shell never
    updated and cells outside the global interior copied (``start`` is
    the global index of its cell (0, ...)); ``combine(c, lo0, hi0, lo1,
    hi1, ..., *coeffs)`` is the update, its neighbours axis by axis. The
    last step's ``|new - old|`` over the window's inner region, 0 where
    copied, or None without ``with_residual``."""
    dev = win.device
    nd = win.dim()
    inner = (slice(1, -1),) * nd
    mask = None
    for axis, (s, n) in enumerate(zip(start, grid_shape)):
        idx = s + 1 + torch.arange(win.shape[axis] - 2, device=dev)
        m = ((idx >= 1) & (idx <= n - 2)).view(
            [-1 if a == axis else 1 for a in range(nd)])
        mask = m if mask is None else mask & m

    def shifted(axis, lo):
        sl = list(inner)
        sl[axis] = slice(None, -2) if lo else slice(2, None)
        return win[tuple(sl)]

    diff = None
    for s in range(k):
        c = win[inner]
        pairs = [shifted(a, lo) for a in range(nd) for lo in (True, False)]
        new = torch.where(mask, combine(c, *pairs, *coeffs), c)
        if with_residual and s == k - 1:
            diff = torch.where(mask, (new - c).abs(),
                               torch.zeros((), device=dev))
        win[inner] = new
    return diff


def _steps_plain(ext, out, k, with_residual, origin, grid_shape, windows,
                 combine, coeffs):
    """Run ``k`` steps on each window ``(w0, w1)`` of the padded frame's
    leading axis (a copy) and write its slabs ``[w0 + k, w1 - k)``, block
    slabs ``[w0, w1 - 2k)``, into ``out``; the max residual over the
    written cells, or None. Any rank."""
    ext = _in_grid(ext, origin, grid_shape, k)
    core = tuple(slice(k, k + b) for b in out.shape[1:])
    inner = tuple(slice(k - 1, k - 1 + b) for b in out.shape[1:])
    res = []
    for w0, w1 in windows:
        win = ext[w0:w1].clone()
        diff = _frontier(win, k, (origin[0] - k + w0,)
                         + tuple(o - k for o in origin[1:]), grid_shape,
                         combine, coeffs, with_residual)
        out[w0:w1 - 2 * k] = win[(slice(k, w1 - w0 - k),) + core]
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
        return u.new_zeros(()) if with_residual else None
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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_block(out, k, origin, grid_shape, tensors):
    """Shape, type, device and layout checks common to the five kernels;
    ``tensors`` maps a name to ``(tensor or None, expected shape)``."""
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
    for name, (t, shape) in {"out": (out, (bx, by)), **tensors}.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"float32 only, got {name} {t.dtype}")
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


def _launch(name, args, out, k, with_residual, *, origin, grid_shape, cx,
            cy, geometry):
    """Launch kernel ``name`` on ``args`` (its leading pointers) into
    ``out``; ``geometry`` the launch's int arguments after k (tile and
    thread block; the band kernel's tile is k rows of its tile_x). Checks
    only the launch shape (:meth:`~.hopper_params.HopperParams.loop_takes`,
    the launcher's own rule); counts the launch. Returns the residual
    view or None."""
    from parallel_heat_tpu_torch.kernels.build import load

    p = params()
    tile = (k,) + tuple(geometry[:1]) if name == BAND else tuple(geometry[:2])
    block = tuple(geometry[-2:])
    if not p.loop_takes(tile, block):
        raise ValueError(f"{name}: the step loop does not take tiles of "
                         f"{tile} under thread blocks of {block} (32 lanes "
                         f"by 1 to {p.loop_max_warps} warps, a tile width "
                         f"that is a multiple of 4)")
    lib = load(name)
    bits = (torch.empty(1, dtype=torch.int32, device=out.device)
            if with_residual else None)
    code = getattr(lib, name)(
        *[_ptr(t) for t in args], out.data_ptr(), _ptr(bits),
        grid_shape[0], grid_shape[1], out.shape[0], out.shape[1], origin[0],
        origin[1], k, *geometry, *coeffs_f32(cx, cy), _stream(out))
    _raise_on_error(lib, name, code)
    counts[name] += 1
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
    if name == "heat_g_block_uniform" and not params().uni_fits((bx, by)):
        raise ValueError(f"kernel G-uni needs a block width that is a "
                         f"multiple of 4, got {(bx, by)}")
    if out.device.type == "cpu":
        return plain(u, tail, halo_n, halo_s, out, k, with_residual,
                     origin=origin, grid_shape=grid_shape, cx=cx, cy=cy)
    if name == "heat_g_block_uniform" and u.data_ptr() % 16:
        raise ValueError("kernel G-uni needs a 16-byte aligned block")
    if halo_n is None and bx == 2 * k:
        # The bands are the whole block: the bulk has no row to write.
        return (torch.zeros((), dtype=torch.float32, device=out.device)
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
    (ValueError otherwise)."""
    return _from_pieces("heat_g_block_uniform", block_uniform_plain, u, tail,
                        halo_n, halo_s, out, k, with_residual, origin,
                        grid_shape, cx, cy)


def band_fix(u: torch.Tensor, tail: torch.Tensor, halo_n: torch.Tensor,
             halo_s: torch.Tensor, out: torch.Tensor, k: int,
             with_residual: bool = True, *, origin, grid_shape, cx: float,
             cy: float) -> Optional[torch.Tensor]:
    """The band kernel: rows ``[0, k)`` and ``[bx - k, bx)`` of ``k``
    steps of block ``u``, written into ``out`` in place (the other rows
    are left as they are); the residual of exactly those rows (0-d
    float32) or None. ``bx`` must be at least ``2k``."""
    _check_block(out, k, origin, grid_shape,
                 _pieces(out, u, tail, halo_n, halo_s, k))
    if halo_n is None:
        raise ValueError("the band kernel needs both halo rows")
    if out.shape[0] < 2 * k:
        raise ValueError(f"the band kernel needs at least 2k = {2 * k} rows, "
                         f"got a block of {out.shape[0]}")
    if out.device.type == "cpu":
        return band_fix_plain(u, tail, halo_n, halo_s, out, k, with_residual,
                              origin=origin, grid_shape=grid_shape, cx=cx,
                              cy=cy)
    p = params()
    return _launch(BAND, (u, tail, halo_n, halo_s), out, k, with_residual,
                   origin=origin, grid_shape=grid_shape, cx=cx, cy=cy,
                   geometry=(p.g_band_tile_x,) + tuple(p.g_band_block))


LAUNCH = {"G-uni": block_uniform, "G-fuse": block_fused,
          "G-circ": block_circular, "G": block_padded}


# ---------------------------------------------------------------------------
# The decision sites
# ---------------------------------------------------------------------------

def pick_block_temporal_2d(block_shape, k: int):
    """The sharded 2D round's kernel decision at depth ``k`` for blocks of
    ``block_shape``: ``(kind, detail)`` with kind in :data:`G_KINDS`.

    The one decision site: ``parallel/temporal.py`` executes its result
    and ``solver.explain`` reports it. By default G-uni where the block's
    width is a multiple of 4 (its 16-byte loads), else G-fuse. G-circ
    and G read a caller-assembled extended block, one more full-block
    copy a round, and run only when pinned with
    ``tune.force("block_temporal_2d", ...)``; so do the torch rounds. A
    pinned choice that the geometry refuses raises ValueError.
    """
    choice = tune.forced("block_temporal_2d")
    if choice is not None:
        resolved = _resolve_block_temporal_2d(choice, tuple(block_shape), k)
        if resolved is None:
            raise ValueError(
                f"tune[block_temporal_2d]: forced choice {choice!r} is "
                f"infeasible for blocks {tuple(block_shape)} at K={k} (K "
                f"must be in [1, {params().g_k_max()}] and at most the "
                f"smallest block extent; G-uni needs a width that is a "
                f"multiple of 4)")
        return resolved
    return (_resolve_block_temporal_2d("G-uni", tuple(block_shape), k)
            or _resolve_block_temporal_2d("G-fuse", tuple(block_shape), k))


def _resolve_block_temporal_2d(choice, block_shape, k):
    p = params()
    if choice == "torch":
        return "torch", None
    if not 1 <= k <= min(p.g_k_max(), *block_shape):
        return None
    if choice == "G-uni" and not p.uni_fits(block_shape):
        return None
    return choice, {"k": k, "tile": p.g_tile, "block": p.g_block,
                    "rows_per_warp": p.g_run(k), "kernel": KERNEL_OF[choice]}


def pick_block_temporal_2d_deferred(kind: str, block_shape, k: int,
                                    mode: str) -> bool:
    """Is a round of ``kind`` at depth ``k`` split into the deferred bulk
    and the band kernel? Under the ``overlap`` schedule, for the pieces
    forms (G-uni, G-fuse), on blocks of at least ``2k`` rows (two
    disjoint k-row bands); otherwise the monolithic kernel runs. A block
    of exactly ``2k`` rows is deferred with an empty bulk."""
    return (mode == "overlap" and kind in ("G-uni", "G-fuse")
            and block_shape[0] >= 2 * k)
