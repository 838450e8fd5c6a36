"""The 1-deep halo exchange and the per-step sharded update of the torch
backend: the port of ``parallel_heat_tpu/parallel/halo.py``.

Each step exchanges the four one-cell halos of every block
(:func:`exchange_halos_2d`; corners are not exchanged, the 5-point
stencil never reads them), updates every block with the textbook tree of
``ops/stencil.py``, and holds the cells outside the global interior at
their values (:func:`interior_mask_2d`). The two update forms of the JAX
package are both here: with ``overlap`` the block's own interior is
computed from the block alone and only the four edge strips read the
halos (the reference's interior-between-``MPI_Startall``-and-``Waitall``
split); without it the block is padded with its halos first. Both
evaluate the same expression per cell, so the grid is bitwise a
one-device torch run either way.

Arithmetic is float32 at every storage dtype, as in the JAX package
(``_ACC``): every operand is widened to float32 first, the updated cells
are rounded to the blocks' dtype once, as they are stored, the held
cells are kept bit for bit, and the residual is the float32
``|new - float32(old)|``.

This is the plain reference path of the torch backend: it allocates its
halos each step. Under ``backend="cuda"`` a depth-1 run takes kernel G
at K = 1 in the K-deep rounds of ``parallel/temporal.py``, whose
exchange writes into buffers allocated once per run.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from parallel_heat_tpu_torch.ops.stencil import stencil_interior_2d
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh


def exchange_halos_2d(mesh: HeatMesh, blocks: Sequence[torch.Tensor]):
    """The four 1-cell halos of every ``(bx, by)`` block: a list of
    ``(halo_n, halo_s, halo_w, halo_e)``, shaped ``(1, by), (1, by),
    (bx, 1), (bx, 1)``, from the north, south, west and east neighbours;
    zeros where a block has none."""
    halo_n = mesh.shift_down([u[-1:, :] for u in blocks], 0)
    halo_s = mesh.shift_up([u[:1, :] for u in blocks], 0)
    halo_w = mesh.shift_down([u[:, -1:] for u in blocks], 1)
    halo_e = mesh.shift_up([u[:, :1] for u in blocks], 1)
    return list(zip(halo_n, halo_s, halo_w, halo_e))


def interior_mask_2d(block_shape, grid_shape, origin,
                     device=None) -> torch.Tensor:
    """Boolean ``(bx, by)`` mask on ``device``, True where the block's
    cell is in the global interior (the Dirichlet ring is never
    written)."""
    bx, by = block_shape
    nx, ny = grid_shape
    row = origin[0] + torch.arange(bx, device=device)
    col = origin[1] + torch.arange(by, device=device)
    return (((row >= 1) & (row <= nx - 2))[:, None]
            & ((col >= 1) & (col <= ny - 2))[None, :])


def _pad_block(u, halos):
    """The ``(bx + 2, by + 2)`` halo-padded block (zero corners)."""
    halo_n, halo_s, halo_w, halo_e = halos
    z = u.new_zeros((1, 1))
    rows = torch.cat([halo_n, u, halo_s], dim=0)
    wcol = torch.cat([z, halo_w, z], dim=0)
    ecol = torch.cat([z, halo_e, z], dim=0)
    return torch.cat([wcol, rows, ecol], dim=1)


def _f32(t):
    return t.to(torch.float32)


def _row_update(center, up, down, lw, re, cx, cy):
    """Textbook update of one row, in float32; ``lw``/``re`` its outer
    neighbours."""
    center, up, down = _f32(center), _f32(up), _f32(down)
    left = torch.cat([_f32(lw).reshape(1), center[:-1]])
    right = torch.cat([center[1:], _f32(re).reshape(1)])
    return (center + cx * (up + down - 2.0 * center)
            + cy * (left + right - 2.0 * center))


def _col_update(center, left, right, up1, dn1, cx, cy):
    """Textbook update of one column's rows 1 .. bx-2, in float32."""
    center, left, right = _f32(center), _f32(left), _f32(right)
    up = torch.cat([_f32(up1).reshape(1), center[:-1]])
    down = torch.cat([center[1:], _f32(dn1).reshape(1)])
    return (center + cx * (up + down - 2.0 * center)
            + cy * (left + right - 2.0 * center))


def _block_update_overlap(u, halos, cx, cy):
    """The updated value of every cell: the block's interior from the
    block alone, then the four edge strips from the halos."""
    halo_n, halo_s, halo_w, halo_e = halos
    inner = stencil_interior_2d(u, cx, cy)
    top = _row_update(u[0], halo_n[0], u[1], halo_w[0, 0], halo_e[0, 0],
                      cx, cy)
    bot = _row_update(u[-1], u[-2], halo_s[0], halo_w[-1, 0],
                      halo_e[-1, 0], cx, cy)
    wcol = _col_update(u[1:-1, 0], halo_w[1:-1, 0], u[1:-1, 1], u[0, 0],
                       u[-1, 0], cx, cy)
    ecol = _col_update(u[1:-1, -1], u[1:-1, -2], halo_e[1:-1, 0], u[0, -1],
                       u[-1, -1], cx, cy)
    mid = torch.cat([wcol[:, None], inner, ecol[:, None]], dim=1)
    return torch.cat([top[None, :], mid, bot[None, :]], dim=0)


def _block_update_padded(u, halos, cx, cy):
    """The updated value of every cell, through the padded block."""
    return stencil_interior_2d(_pad_block(u, halos), cx, cy)


def _exchanged_update_2d(mesh, blocks, grid_shape, cx, cy, overlap):
    """``[(new, mask)]`` of every block: exchange, update."""
    out = []
    for b, (u, halos) in enumerate(zip(blocks,
                                       exchange_halos_2d(mesh, blocks))):
        # The split form needs two distinct rows and columns per block.
        form = (_block_update_overlap
                if overlap and min(u.shape) >= 2 else _block_update_padded)
        mask = interior_mask_2d(u.shape, grid_shape,
                                mesh.origin(b, u.shape), u.device)
        out.append((form(u, halos, cx, cy), mask))
    return out


def block_step_2d(mesh: HeatMesh, blocks, outs, *, grid_shape, cx, cy,
                  overlap=True) -> None:
    """One sharded step of every block into ``outs``: exchange, update,
    hold the cells outside the global interior."""
    for u, out, (new, mask) in zip(
            blocks, outs, _exchanged_update_2d(mesh, blocks, grid_shape,
                                               cx, cy, overlap)):
        out.copy_(torch.where(mask, new.to(u.dtype), u))


def block_step_2d_residual(mesh: HeatMesh, blocks, outs, *, grid_shape, cx,
                           cy, overlap=True) -> torch.Tensor:
    """:func:`block_step_2d` plus the global max-norm residual (0-d, the
    max over the blocks, NaN-propagating)."""
    res: List[torch.Tensor] = []
    for u, out, (new, mask) in zip(
            blocks, outs, _exchanged_update_2d(mesh, blocks, grid_shape,
                                               cx, cy, overlap)):
        res.append(torch.where(mask, (new - _f32(u)).abs(),
                               torch.zeros((), device=u.device)).max())
        out.copy_(torch.where(mask, new.to(u.dtype), u))
    return torch.stack(res).amax()
