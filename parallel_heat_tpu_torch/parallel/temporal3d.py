"""K-deep halo exchange and the sharded 3D rounds: the port of the 3D
half of ``parallel_heat_tpu/parallel/temporal.py``.

A round exchanges K-deep face halos once and advances every block K
steps, as in 2D (``parallel/temporal.py``): after K steps a block's core
is exact, since each step consumes one shell of the halo (the 7-point
stencil's K-step cone is the L1 ball of radius K) and the cells outside
the global interior are held at their values every step.

**The exchange** (:class:`DeepExchange3D`) runs in three phases, z, then
y, then x, as the JAX package's ``exchange_halos_fused_3d`` does, each
later phase sending strips of the block already extended by the earlier
ones, so that six messages carry the edge and corner data too:

- phase z writes each block's z tail ``ztail`` ``(bx, by, 2K)``, ``[hi |
  lo]``: ``hi`` is the z+ neighbour's first K z-planes, ``lo`` the z-
  neighbour's last K;
- phase y writes the z-extended y tail ``ytail`` ``(bx, 2K, bz + 2hz)``:
  the y+ neighbour's first K rows of ``[u | ztail]``, then the y-
  neighbour's last K;
- phase x writes ``xlo``/``xhi`` ``(K, by + 2hy, bz + 2hz)``: the x-
  (x+) neighbour's last (first) K planes of its block extended along y
  and z, ``[[u | ztail] ; ytail]``; its corner and edge data ride in the
  neighbours' tails.

A block's y and z axes are in the circular order ``[u | hi | lo]``. An
axis the mesh does not cut (``hz`` = 0, ...) gets no buffer: the block
spans the grid along it. A neighbour that does not exist gives zeros, as
``ppermute`` does: the buffers are allocated zeroed, once per run and
depth, and the slots no neighbour fills are never written. Each round
writes the rest with ``copy_`` into slices; nothing in the round loop
concatenates. The circular block kernel H reads
(:meth:`DeepExchange3D.assemble_circular`, into a buffer whose rows are
padded to a multiple of 16 bytes, :meth:`DeepExchange3D.new_circular`,
so that its planes load by TMA) and the padded block of the
textbook rounds (:meth:`~DeepExchange3D.assemble_padded_lead`,
:meth:`~DeepExchange3D.assemble_padded_rows`) are assembled from these
pieces.

**The rounds.** ``backend="torch"``: the rank-generic textbook rounds of
``parallel/temporal.py`` (:func:`~.temporal.block_multistep`), bitwise a
one-block torch run. ``backend="cuda"`` (:func:`cuda_round_3d`, the
counterpart of ``_pallas_round_3d``): the kernel that
``ops/stencil_kernels_block_3d.pick_block_temporal_3d`` names, in its
bfloat16 form for a bfloat16 run (the exchange moves the blocks' dtype,
and the plain versions round each level as the kernels do). The
remainder round of an n-step advance runs the same kernel at depth
``n % K``, where the JAX package runs its jnp rounds
(``temporal.py:914-918``), so the whole run stays on the kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch

from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as skb3
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh


class DeepExchange3D:
    """The K-deep exchange's buffers for every block of a 3D ``mesh``,
    blocks of ``block_shape``: ``ztail[b]``, ``ytail[b]``, ``xlo[b]`` and
    ``xhi[b]`` (None on an axis the mesh does not cut), zeroed once and
    rewritten in place by :meth:`phase_z`, :meth:`phase_y` and
    :meth:`phase_x`."""

    def __init__(self, mesh: HeatMesh, block_shape, k: int, device,
                 dtype=torch.float32):
        bx, by, bz = block_shape
        if not 1 <= k <= min(block_shape):
            raise ValueError(f"halo depth {k} outside [1, min(block)] for "
                             f"blocks {tuple(block_shape)}")
        self.mesh, self.k = mesh, k
        self.block_shape = (bx, by, bz)
        self.halos = tuple(k if d > 1 else 0 for d in mesh.shape)
        hx, hy, hz = self.halos
        ye, ze = by + 2 * hy, bz + 2 * hz
        self.circular_shape = (bx + 2 * hx, ye, ze)
        self.device, self.dtype = device, dtype
        size = mesh.size

        def buffers(on, shape):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    if on else None for _ in range(size)]

        self.ztail = buffers(hz, (bx, by, 2 * k))
        self.ytail = buffers(hy, (bx, 2 * k, ze))
        self.xlo = buffers(hx, (k, ye, ze))
        self.xhi = buffers(hx, (k, ye, ze))
        nb = mesh.neighbour
        self._lo = [[nb(b, a, -1) for b in range(size)] for a in range(3)]
        self._hi = [[nb(b, a, 1) for b in range(size)] for a in range(3)]
        # copy_ calls of one whole exchange: a strip sent along x carries
        # u and the z and y tails, along y u and the z tail, along z u.
        per_strip = (1 + (hz > 0) + (hy > 0), 1 + (hz > 0), 1)
        self.copies = sum(per_strip[a] for a in range(3) if self.halos[a]
                          for side in (self._lo[a], self._hi[a])
                          for n in side if n is not None)

    def phase_z(self, us: Sequence[torch.Tensor]) -> None:
        """z tails: ``hi`` from the z+ neighbour's first k z-planes, ``lo``
        from the z- neighbour's last k."""
        if not self.halos[2]:
            return
        k = self.k
        for b in range(self.mesh.size):
            hi, lo = self._hi[2][b], self._lo[2][b]
            if hi is not None:
                self.ztail[b][..., :k].copy_(us[hi][..., :k])
            if lo is not None:
                self.ztail[b][..., k:].copy_(us[lo][..., -k:])

    def phase_y(self, us: Sequence[torch.Tensor]) -> None:
        """z-extended y tails: the y+ neighbour's first k rows of ``[u |
        ztail]`` and the y- neighbour's last k. Reads the neighbours' z
        tails, so it runs after :meth:`phase_z` of every block."""
        if not self.halos[1]:
            return
        k, bz = self.k, self.block_shape[2]
        for b in range(self.mesh.size):
            for nb, rows, dst in ((self._hi[1][b], slice(0, k), slice(0, k)),
                                  (self._lo[1][b], slice(-k, None),
                                   slice(k, 2 * k))):
                if nb is None:
                    continue
                self.ytail[b][:, dst, :bz].copy_(us[nb][:, rows])
                if self.halos[2]:
                    self.ytail[b][:, dst, bz:].copy_(self.ztail[nb][:, rows])

    def phase_x(self, us: Sequence[torch.Tensor]) -> None:
        """x slabs: the x- neighbour's last k planes of its block extended
        along y and z, and the x+ neighbour's first k. Reads the
        neighbours' tails, so it runs after :meth:`phase_y` of every
        block."""
        if not self.halos[0]:
            return
        k = self.k
        _, by, bz = self.block_shape
        for b in range(self.mesh.size):
            for nb, planes, dst in ((self._lo[0][b], slice(-k, None),
                                     self.xlo[b]),
                                    (self._hi[0][b], slice(0, k),
                                     self.xhi[b])):
                if nb is None:
                    continue
                dst[:, :by, :bz].copy_(us[nb][planes])
                if self.halos[2]:
                    dst[:, :by, bz:].copy_(self.ztail[nb][planes])
                if self.halos[1]:
                    dst[:, by:].copy_(self.ytail[nb][planes])

    def lead(self, us: Sequence[torch.Tensor]) -> None:
        """The phases the overlapped round runs before its bulk: z, y."""
        self.phase_z(us)
        self.phase_y(us)

    last = phase_x

    def pieces(self, b: int):
        """``(ztail, ytail, xlo, xhi)`` of block ``b``."""
        return self.ztail[b], self.ytail[b], self.xlo[b], self.xhi[b]

    def new_circular(self) -> torch.Tensor:
        """A zeroed buffer for one circular block: a view of
        :attr:`circular_shape` whose rows are padded to a multiple of 16
        bytes (4 float32 cells, 8 bfloat16 ones: ``hopper_params.hc_pitch``),
        so that kernel H can encode a tensor map over it; the pad cells are
        never read."""
        from parallel_heat_tpu_torch.ops.hopper_params import (elem_size,
                                                               params)

        x, y, z = self.circular_shape
        pitch = params().hc_pitch(z, elem_size(self.dtype))
        return torch.zeros((x, y, pitch), dtype=self.dtype,
                           device=self.device)[..., :z]

    def assemble_circular(self, b: int, u: torch.Tensor,
                          ext: torch.Tensor) -> None:
        """Write block ``b``'s circular block (x ``[lo | u | hi]``, y and z
        ``[u | hi | lo]``) into ``ext`` :attr:`circular_shape`."""
        hx = self.halos[0]
        bx, by, bz = self.block_shape
        core = ext[hx:hx + bx]
        core[:, :by, :bz].copy_(u)
        if self.halos[2]:
            core[:, :by, bz:].copy_(self.ztail[b])
        if self.halos[1]:
            core[:, by:].copy_(self.ytail[b])
        if hx:
            ext[:hx].copy_(self.xlo[b])
            ext[hx + bx:].copy_(self.xhi[b])

    def assemble_padded_lead(self, b: int, u: torch.Tensor,
                             ext: torch.Tensor) -> None:
        """Write the middle planes of block ``b``'s padded block ``(bx +
        2k, by + 2k, bz + 2k)`` (every axis ``[lo | u | hi]``, the JAX
        package's ``exchange_halos_deep_3d`` layout) into ``ext`` (the z
        and y phases' data only)."""
        skb3.padded_lead(ext, u, self.ztail[b], self.ytail[b], self.k)

    def assemble_padded_rows(self, b: int, ext: torch.Tensor) -> None:
        """Write the x slabs of block ``b``'s padded block into ``ext``."""
        if self.halos[0]:
            skb3.padded_slabs(ext, self.xlo[b], self.xhi[b], self.k)

    def assemble_padded(self, b: int, u: torch.Tensor,
                        ext: torch.Tensor) -> None:
        """Write block ``b``'s padded block into ``ext``."""
        self.assemble_padded_lead(b, u, ext)
        self.assemble_padded_rows(b, ext)


def _exchanged(mesh: HeatMesh, us, k: int) -> DeepExchange3D:
    xch = DeepExchange3D(mesh, tuple(us[0].shape), k, us[0].device,
                         us[0].dtype)
    xch.lead(us)
    xch.last(us)
    return xch


def exchange_halos_fused_3d(mesh: HeatMesh, us, k: int):
    """The three phases of the K-deep exchange on fresh buffers: ``(ztail,
    ytail, xlo, xhi)`` of every block."""
    xch = _exchanged(mesh, us, k)
    return [xch.pieces(b) for b in range(mesh.size)]


def exchange_halos_circular_3d(mesh: HeatMesh, us, k: int):
    """The circular extended block of every block, on fresh buffers."""
    xch = _exchanged(mesh, us, k)
    out = []
    for b, u in enumerate(us):
        ext = u.new_empty(xch.circular_shape)
        xch.assemble_circular(b, u, ext)
        out.append(ext)
    return out


def exchange_halos_deep_3d(mesh: HeatMesh, us, k: int):
    """The padded extended block of every block (zeros past an uncut
    axis), on fresh buffers."""
    xch = _exchanged(mesh, us, k)
    out = []
    for b, u in enumerate(us):
        ext = u.new_zeros(tuple(s + 2 * k for s in u.shape))
        xch.assemble_padded(b, u, ext)
        out.append(ext)
    return out


def cuda_round_3d(xch: DeepExchange3D, kind: str, mode: str, *, grid_shape,
                  cx, cy, cz):
    """The kernel round at depth ``xch.k`` (the counterpart of the JAX
    package's ``_pallas_round_3d``): ``fn(us, vs, want_res) -> residual or
    None``. H-fused reads the exchange's pieces; H a block assembled into
    a buffer of its own, one more full-block copy a round; H-defer under
    the overlap schedule runs the deferred bulk of every block between the
    y and the x phase, then the band kernel of every block in one launch
    (``stencil_kernels_block_3d.BandLaunch3D``), built on the first round
    over each pair of buffers ``(us, vs)`` and kept while the round sees
    no other."""
    k, mesh = xch.k, xch.mesh
    bs = xch.block_shape
    deferred = skb3.pick_block_temporal_3d_deferred(kind, bs, mesh.shape, k,
                                                    mode)
    origins = [mesh.origin(b, bs) for b in range(mesh.size)]
    kw = dict(grid_shape=grid_shape, cx=cx, cy=cy, cz=cz)
    exts = ([xch.new_circular() for _ in range(mesh.size)]
            if kind == "H" else None)
    bands = {}

    def bands_of(us, vs):
        # A launch holds its blocks' addresses, and was checked against
        # what the key holds besides: their shapes, strides, types and
        # devices. A run alternates the two orders of its two buffers, so
        # a third key means buffers the run no longer holds.
        key = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                     t.device) for t in (*us, *vs))
        if key not in bands:
            if len(bands) >= 2:
                bands.clear()
            bands[key] = skb3.BandLaunch3D(us, xch.ztail, xch.ytail, xch.xlo,
                                           xch.xhi, vs, k, origins=origins,
                                           **kw)
        return bands[key]

    def fn(us, vs, want_res):
        res = []
        xch.lead(us)
        if deferred:
            for b in range(mesh.size):
                zt, yt, _, _ = xch.pieces(b)
                res.append(skb3.h_block_fused(
                    us[b], zt, yt, None, None, vs[b], k, want_res,
                    defer_x=True, origin=origins[b], **kw))
            xch.last(us)
            res.append(bands_of(us, vs)(want_res))
            return torch.stack(res).amax() if want_res else None
        xch.last(us)
        for b in range(mesh.size):
            if exts is not None:
                xch.assemble_circular(b, us[b], exts[b])
                r = skb3.h_block(exts[b], vs[b], k, want_res,
                                 origin=origins[b], **kw)
            else:
                r = skb3.h_block_fused(us[b], *xch.pieces(b), vs[b], k,
                                       want_res, origin=origins[b], **kw)
            res.append(r)
        return torch.stack(res).amax() if want_res else None

    return fn
