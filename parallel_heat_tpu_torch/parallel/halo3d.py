"""The 1-deep halo exchange and the per-step sharded 3D update of the torch
backend: the port of ``parallel_heat_tpu/parallel/halo3d.py``.

Each step exchanges the six one-cell face halos of every block
(:func:`exchange_halos_3d`; edges and corners are not exchanged, the
7-point stencil never reads them), pads every block with them
(:func:`_pad_block_3d`), updates it with the textbook tree of
``ops/stencil.py`` and holds the cells outside the global interior at
their values (:func:`interior_mask_3d`), so the grid is bitwise a
one-device torch run. As in the JAX package, ``overlap`` is accepted and
ignored: the 3D update always takes the padded form.

This is the plain reference path of the torch backend at
``halo_depth=1``: it allocates its halos each step. Under
``backend="cuda"`` a depth-1 run takes kernel H-fused at K = 1 in the
K-deep rounds of ``parallel/temporal3d.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from parallel_heat_tpu_torch.ops.stencil import stencil_interior_3d
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh


def exchange_halos_3d(mesh: HeatMesh, blocks: Sequence[torch.Tensor]):
    """The six 1-cell face halos of every ``(bx, by, bz)`` block: a list of
    ``(lo_x, hi_x, lo_y, hi_y, lo_z, hi_z)`` from the lower and upper
    neighbour along each axis; zeros where a block has none."""
    faces = []
    for axis in range(3):
        last = [u.narrow(axis, u.shape[axis] - 1, 1) for u in blocks]
        first = [u.narrow(axis, 0, 1) for u in blocks]
        faces += [mesh.shift_down(last, axis), mesh.shift_up(first, axis)]
    return list(zip(*faces))


def interior_mask_3d(block_shape, grid_shape, origin,
                     device=None) -> torch.Tensor:
    """Boolean ``(bx, by, bz)`` mask on ``device``, True where the block's
    cell is in the global interior (the Dirichlet faces are never
    written)."""
    mask = None
    for axis, (b, n, o) in enumerate(zip(block_shape, grid_shape, origin)):
        idx = o + torch.arange(b, device=device)
        m = ((idx >= 1) & (idx <= n - 2)).view(
            [-1 if a == axis else 1 for a in range(3)])
        mask = m if mask is None else mask & m
    return mask


def _pad_block_3d(u, halos):
    """The ``(bx + 2, by + 2, bz + 2)`` halo-padded block (zero edges and
    corners)."""
    lo_x, hi_x, lo_y, hi_y, lo_z, hi_z = halos
    out = u.new_zeros(tuple(s + 2 for s in u.shape))
    out[1:-1, 1:-1, 1:-1] = u
    out[:1, 1:-1, 1:-1] = lo_x
    out[-1:, 1:-1, 1:-1] = hi_x
    out[1:-1, :1, 1:-1] = lo_y
    out[1:-1, -1:, 1:-1] = hi_y
    out[1:-1, 1:-1, :1] = lo_z
    out[1:-1, 1:-1, -1:] = hi_z
    return out


def _exchanged_update_3d(mesh, blocks, grid_shape, cx, cy, cz):
    """``[(new, mask)]`` of every block: exchange, pad, update."""
    out = []
    for b, (u, halos) in enumerate(zip(blocks,
                                       exchange_halos_3d(mesh, blocks))):
        mask = interior_mask_3d(u.shape, grid_shape,
                                mesh.origin(b, u.shape), u.device)
        new = stencil_interior_3d(_pad_block_3d(u, halos), cx, cy, cz)
        out.append((new, mask))
    return out


def block_step_3d(mesh: HeatMesh, blocks, outs, *, grid_shape, cx, cy, cz,
                  overlap=True) -> None:
    """One sharded 7-point step of every block into ``outs``: exchange,
    pad, update, hold the cells outside the global interior."""
    del overlap  # 3D takes the padded form (the module docstring)
    for u, out, (new, mask) in zip(
            blocks, outs, _exchanged_update_3d(mesh, blocks, grid_shape,
                                               cx, cy, cz)):
        out.copy_(torch.where(mask, new, u))


def block_step_3d_residual(mesh: HeatMesh, blocks, outs, *, grid_shape, cx,
                           cy, cz, overlap=True) -> torch.Tensor:
    """:func:`block_step_3d` plus the global max-norm residual (0-d, the
    max over the blocks, NaN-propagating)."""
    del overlap
    res: List[torch.Tensor] = []
    for u, out, (new, mask) in zip(
            blocks, outs, _exchanged_update_3d(mesh, blocks, grid_shape,
                                               cx, cy, cz)):
        res.append(torch.where(mask, (new - u).abs(),
                               torch.zeros((), device=u.device)).max())
        out.copy_(torch.where(mask, new, u))
    return torch.stack(res).amax()
