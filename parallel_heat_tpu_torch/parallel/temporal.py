"""K-deep halo exchange and the sharded 2D rounds: the port of
``parallel_heat_tpu/parallel/temporal.py`` (2D).

A round exchanges K-deep halos once and advances every block K steps:
K times fewer exchanges than the 1-deep path of ``parallel/halo.py``, at
the price of ``2K(bx + by + 2K)`` cells a block recomputes that its
neighbours own. After K steps the block's core is exact: each step
consumes one ring of the halo (the 5-point stencil's K-step cone is the
L1 ball of radius K), and the cells outside the global interior are
held at their values every step, so the zeros a block at the domain's
edge receives never reach the interior.

**The exchange** (:class:`DeepExchange2D`) runs in two phases, as the
JAX package's ``_split_exchange_deep_2d`` does, so that four messages
carry all eight neighbours' data:

- phase 1 writes each block's column tail ``[hi | lo]`` ``(bx, 2K)``:
  ``hi`` is the east neighbour's first K columns, ``lo`` the west
  neighbour's last K columns;
- phase 2 writes each block's halo rows ``halo_n``/``halo_s``
  ``(K, by + 2K)``: the north (south) neighbour's last (first) K rows of
  its column-extended block ``[u | hi | lo]``, so the corners ride in
  that neighbour's tail. Phase 1 finishes for every block before phase
  2 starts.

These are the fused operands of ``exchange_halos_fused_2d``; the
circular block of ``exchange_halos_circular_2d`` and the padded block of
``exchange_halos_deep_2d`` are assembled from them
(:meth:`DeepExchange2D.assemble_circular`,
:meth:`~DeepExchange2D.assemble_padded`).
Neighbours that do not exist give zeros, as ``ppermute`` does: the
buffers are allocated zeroed, once per run and depth, and the slots no
neighbour fills are never written. Each round writes the rest with
``copy_`` into slices; nothing in the round loop concatenates.

**The rounds** (:func:`block_temporal_multistep`). An n-step advance is
``n // K`` rounds of depth K and one remainder round of depth ``n % K``;
only the last round computes the residual (the last full one only when
there is no remainder), and the global residual is the max over the
blocks on the card, read once per check window by the solver.

- ``backend="cuda"`` (:func:`_cuda_round_2d`): the kernel of
  ``ops/stencil_kernels_block.pick_block_temporal_2d``. The remainder
  round runs the same kernel at depth ``n % K``, where the JAX package
  runs its jnp rounds (``temporal.py:910-956``): the whole run stays on
  the kernel and is bitwise a one-device run. Under ``halo_overlap=
  "overlap"`` (the default) a round runs phase 1, the deferred bulk of
  every block (which reads ``u`` and the tail only, so no phase-2 buffer
  has a data path into it), phase 2, and the band kernel, one launch for
  every block's bands, which writes each block's first and last K rows
  into its bulk's output; under
  ``"phase"``, or where a block has fewer than 2K rows, the monolithic
  kernel runs after both phases. One CUDA stream carries all of it in
  this slice; side streams that overlap the phase-2 copies with the
  bulk are later work.
- ``backend="torch"`` (:func:`block_multistep`): the textbook rounds
  (``_block_multistep`` and ``_block_multistep_deferred``) on the padded
  block, bitwise a one-device torch run. They are rank-generic and serve
  the 3D rounds of ``parallel/temporal3d.py`` too.

The ``pipeline`` schedule (``_pallas_pipeline_2d``) is not ported yet
(ROADMAP.md queue 1 item 8); ``config.validate()`` refuses it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from parallel_heat_tpu_torch.ops.stencil import (stencil_interior_2d,
                                                 storage_dtype)
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh


class DeepExchange2D:
    """The K-deep exchange's buffers for every block of ``mesh``, blocks of
    ``block_shape``: ``tail[b]`` ``(bx, 2k)`` and ``halo_n[b]``,
    ``halo_s[b]`` ``(k, by + 2k)``, zeroed once and rewritten in place by
    :meth:`phase1` and :meth:`phase2`. The buffers are of the blocks'
    storage ``dtype``, so a bfloat16 run moves bfloat16 halos (the JAX
    package's ``.astype(dt)`` on every piece)."""

    def __init__(self, mesh: HeatMesh, block_shape, k: int, device,
                 dtype=torch.float32):
        bx, by = block_shape
        if not 1 <= k <= min(bx, by):
            raise ValueError(f"halo depth {k} outside [1, min(block)] for "
                             f"blocks {tuple(block_shape)}")
        self.mesh, self.k, self.bx, self.by = mesh, k, bx, by
        self.block_shape = (bx, by)
        self.dtype = dtype
        size = mesh.size
        self.tail = [torch.zeros((bx, 2 * k), dtype=dtype, device=device)
                     for _ in range(size)]
        self.halo_n = [torch.zeros((k, by + 2 * k), dtype=dtype,
                                   device=device) for _ in range(size)]
        self.halo_s = [torch.zeros((k, by + 2 * k), dtype=dtype,
                                   device=device) for _ in range(size)]
        nb = mesh.neighbour
        self._east = [nb(b, 1, 1) for b in range(size)]
        self._west = [nb(b, 1, -1) for b in range(size)]
        self._north = [nb(b, 0, -1) for b in range(size)]
        self._south = [nb(b, 0, 1) for b in range(size)]

    def phase1(self, us: Sequence[torch.Tensor]) -> None:
        """Column tails: ``hi`` from the east neighbour's first k columns,
        ``lo`` from the west neighbour's last k."""
        k = self.k
        for b in range(self.mesh.size):
            if self._east[b] is not None:
                self.tail[b][:, :k].copy_(us[self._east[b]][:, :k])
            if self._west[b] is not None:
                self.tail[b][:, k:].copy_(us[self._west[b]][:, -k:])

    def phase2(self, us: Sequence[torch.Tensor]) -> None:
        """Halo rows: the north neighbour's last k rows of ``[u | tail]``
        and the south neighbour's first k. Reads the neighbours' tails, so
        it runs after :meth:`phase1` of every block."""
        k, by = self.k, self.by
        for b in range(self.mesh.size):
            n, s = self._north[b], self._south[b]
            if n is not None:
                self.halo_n[b][:, :by].copy_(us[n][-k:])
                self.halo_n[b][:, by:].copy_(self.tail[n][-k:])
            if s is not None:
                self.halo_s[b][:, :by].copy_(us[s][:k])
                self.halo_s[b][:, by:].copy_(self.tail[s][:k])

    # The phases the overlapped round runs before its bulk, and after.
    lead, last = phase1, phase2

    def pieces(self, b: int):
        """``(tail, halo_n, halo_s)`` of block ``b``."""
        return self.tail[b], self.halo_n[b], self.halo_s[b]

    def assemble_circular(self, b: int, u: torch.Tensor,
                          ext: torch.Tensor) -> None:
        """Write block ``b``'s circular block ``[halo_n ; u | hi | lo ;
        halo_s]`` into ``ext`` ``(bx + 2k, by + 2k)``."""
        k, bx, by = self.k, self.bx, self.by
        ext[:k].copy_(self.halo_n[b])
        ext[k:k + bx, :by].copy_(u)
        ext[k:k + bx, by:].copy_(self.tail[b])
        ext[k + bx:].copy_(self.halo_s[b])

    def assemble_padded_lead(self, b: int, u: torch.Tensor,
                             ext: torch.Tensor) -> None:
        """Write the middle rows ``[lo | u | hi]`` of block ``b``'s padded
        block into ``ext`` (phase-1 data only)."""
        k, bx, by = self.k, self.bx, self.by
        ext[k:k + bx, :k].copy_(self.tail[b][:, k:])
        ext[k:k + bx, k:k + by].copy_(u)
        ext[k:k + bx, k + by:].copy_(self.tail[b][:, :k])

    def assemble_padded_rows(self, b: int, ext: torch.Tensor) -> None:
        """Write the halo rows of block ``b``'s padded block into ``ext``,
        their columns reordered from ``[u | hi | lo]`` to ``[lo | u |
        hi]``."""
        k, bx, by = self.k, self.bx, self.by
        for rows, dst in ((self.halo_n[b], ext[:k]),
                          (self.halo_s[b], ext[k + bx:])):
            dst[:, :k].copy_(rows[:, by + k:])
            dst[:, k:k + by].copy_(rows[:, :by])
            dst[:, k + by:].copy_(rows[:, by:by + k])

    def assemble_padded(self, b: int, u: torch.Tensor,
                        ext: torch.Tensor) -> None:
        """Write block ``b``'s padded block (the JAX package's
        ``exchange_halos_deep_2d`` layout) into ``ext``."""
        self.assemble_padded_lead(b, u, ext)
        self.assemble_padded_rows(b, ext)


def exchange_halos_fused_2d(mesh: HeatMesh, us, k: int):
    """Both phases of the K-deep exchange on fresh buffers: ``(tail,
    halo_n, halo_s)`` of every block."""
    xch = DeepExchange2D(mesh, tuple(us[0].shape), k, us[0].device,
                         us[0].dtype)
    xch.phase1(us)
    xch.phase2(us)
    return [xch.pieces(b) for b in range(mesh.size)]


def _assembled(mesh, us, k, how):
    bx, by = us[0].shape
    xch = DeepExchange2D(mesh, (bx, by), k, us[0].device, us[0].dtype)
    xch.phase1(us)
    xch.phase2(us)
    out = []
    for b, u in enumerate(us):
        ext = u.new_empty((bx + 2 * k, by + 2 * k))
        getattr(xch, how)(b, u, ext)
        out.append(ext)
    return out


def exchange_halos_circular_2d(mesh: HeatMesh, us, k: int):
    """The circular extended block of every block, on fresh buffers."""
    return _assembled(mesh, us, k, "assemble_circular")


def exchange_halos_deep_2d(mesh: HeatMesh, us, k: int):
    """The padded extended block of every block, on fresh buffers."""
    return _assembled(mesh, us, k, "assemble_padded")


# ---------------------------------------------------------------------------
# The textbook rounds (backend "torch"), any rank
# ---------------------------------------------------------------------------

def _region_inner_mask(shape, starts, grid_shape,
                       device=None) -> torch.Tensor:
    """Global-interior mask of a window's inner region ``win[1:-1, ...]``,
    the window's cell (0, ...) at global ``starts``, made on ``device``
    (nothing is copied from the host, so a capture takes it)."""
    mask = None
    for axis, (p, s, n) in enumerate(zip(shape, starts, grid_shape)):
        idx = s + 1 + torch.arange(p - 2, device=device)
        m = ((idx >= 1) & (idx <= n - 2)).view(
            [-1 if a == axis else 1 for a in range(len(shape))])
        mask = m if mask is None else mask & m
    return mask


def _frontier_steps(win, k, starts, grid_shape, stencil, need_diff):
    """``k`` masked textbook steps (``stencil(win)`` is the float32 update
    of the inner region) of the window ``win`` in place, only its inner
    region updated: cells within L1 distance ``k - j`` of the data it was
    seeded with stay exact through step j. Each level is stored at the
    window's dtype (the storage dtype: updated cells rounded, held cells
    kept bit for bit, as the JAX package's ``jnp.where(mask,
    new.astype(u.dtype), u)``). Returns the last step's masked float32
    ``|new - float32(old)|`` over the inner region with ``need_diff``."""
    mask = _region_inner_mask(win.shape, starts, grid_shape, win.device)
    inner = (slice(1, -1),) * win.dim()
    zero = torch.zeros((), device=win.device)
    diff = None
    for j in range(k):
        new = stencil(win)
        cur = win[inner]
        if need_diff and j == k - 1:
            diff = torch.where(mask, (new - cur.to(torch.float32)).abs(),
                               zero)
        win[inner] = torch.where(mask, new.to(win.dtype), cur)
    return diff


def _block_multistep(ext, out, k, origin, grid_shape, stencil,
                     with_residual):
    """The monolithic round on one block: ``k`` steps of its padded block
    ``ext`` (in place), the exact core into ``out``; the residual of the
    last step over the core, or None."""
    core = tuple(slice(k, k + b) for b in out.shape)
    diff = _frontier_steps(ext, k, tuple(o - k for o in origin), grid_shape,
                           stencil, with_residual)
    out.copy_(ext[core])
    return (diff[tuple(slice(k - 1, k - 1 + b) for b in out.shape)].max()
            if with_residual else None)


def _block_multistep_deferred(ext, out, k, origin, grid_shape, stencil,
                              with_residual, part):
    """One part of the overlapped round on one block, from copies of
    windows of its padded block ``ext``: ``part="bulk"`` steps the middle
    slabs along the leading axis (the lead phases' data alone) and writes
    output slabs ``[k, b0 - k)``; ``part="bands"`` steps the two
    ``3k``-slab windows at the two ends and writes slabs ``[0, k)`` and
    ``[b0 - k, b0)``. Every cell's value is the monolithic round's, so
    the two are bitwise equal, and so is the max of the parts'
    residuals."""
    b0 = out.shape[0]
    core = tuple(slice(k, k + b) for b in out.shape[1:])
    inner = tuple(slice(k - 1, k - 1 + b) for b in out.shape[1:])
    windows = ([(k, b0)] if part == "bulk"
               else [(0, 3 * k), (b0 - k, 3 * k)])
    res = []
    for w0, rows in windows:
        if rows == 2 * k:
            continue  # a block of 2k slabs: the bulk is empty
        win = ext[w0:w0 + rows].clone()
        diff = _frontier_steps(
            win, k, (origin[0] - k + w0,) + tuple(o - k for o in origin[1:]),
            grid_shape, stencil, with_residual)
        out[w0:w0 + rows - 2 * k] = win[(slice(k, rows - k),) + core]
        if with_residual:
            res.append(diff[(slice(k - 1, rows - k - 1),) + inner].max())
    return torch.stack(res).amax() if with_residual and res else None


def block_multistep(xch, exts, us, vs, *, grid_shape, stencil,
                    with_residual=False, overlap=False):
    """One textbook round of every block: ``k = xch.k`` steps of ``us``
    into ``vs``, through the padded blocks ``exts`` (buffers, rewritten),
    for the exchange ``xch`` of either rank (:class:`DeepExchange2D` or
    ``temporal3d.DeepExchange3D``). ``overlap`` runs the deferred round
    where a block has at least ``2k`` slabs along the leading axis: the
    bulk of every block between the lead phases and the last. Returns the
    global residual or None."""
    k, mesh = xch.k, xch.mesh
    shape = tuple(us[0].shape)
    deferred = overlap and shape[0] >= 2 * k
    res: List[torch.Tensor] = []

    def run(b, fn, *extra):
        r = fn(exts[b], vs[b], k, mesh.origin(b, shape), grid_shape,
               stencil, with_residual, *extra)
        if r is not None:
            res.append(r)

    xch.lead(us)
    for b in range(mesh.size):
        xch.assemble_padded_lead(b, us[b], exts[b])
        if deferred:
            run(b, _block_multistep_deferred, "bulk")
    xch.last(us)
    for b in range(mesh.size):
        xch.assemble_padded_rows(b, exts[b])
        if deferred:
            run(b, _block_multistep_deferred, "bands")
        else:
            run(b, _block_multistep)
    return torch.stack(res).amax() if with_residual else None


def _torch_round(xch, mode: str, *, grid_shape, stencil):
    """The textbook round at depth ``xch.k``: ``fn(us, vs, want_res) ->
    residual or None``, through padded blocks allocated here, once."""
    k, mesh = xch.k, xch.mesh
    exts = [torch.zeros(tuple(b + 2 * k for b in xch.block_shape),
                        dtype=xch.dtype, device=mesh.device)
            for _ in range(mesh.size)]

    def fn(us, vs, want_res):
        return block_multistep(xch, exts, us, vs, grid_shape=grid_shape,
                               stencil=stencil, with_residual=want_res,
                               overlap=mode == "overlap")

    return fn


# ---------------------------------------------------------------------------
# The kernel rounds (backend "cuda") and the multistep
# ---------------------------------------------------------------------------

def resolve_halo_overlap(config, backend: str) -> str:
    """``halo_overlap`` None/"auto" resolved to a schedule: "overlap",
    the JAX package's answer wherever its pipeline schedule is not
    priced in; explicit values win. The one decision site of the solver,
    the rounds and ``solver.explain``."""
    mode = config.halo_overlap
    return "overlap" if mode in (None, "auto") else mode


def _cuda_round_2d(xch: DeepExchange2D, kind: str, mode: str, *, grid_shape,
                   cx, cy):
    """The kernel round at depth ``xch.k`` (the counterpart of the JAX
    package's ``_pallas_round_2d``): ``fn(us, vs, want_res) -> residual or
    None``. G-uni and G-fuse read the exchange's pieces; G-circ and G a
    block assembled into a buffer of their own, one more full-block copy
    a round. The overlapped round fixes every block's bands in one launch
    (``stencil_kernels_block.BandLaunch``), built on the first round over
    each pair of buffers ``(us, vs)`` (a run alternates two) and kept.
    Blocks of bfloat16 (the exchange's dtype) launch the kernels'
    bfloat16 forms."""
    from parallel_heat_tpu_torch.ops import stencil_kernels_block as skb

    k, mesh = xch.k, xch.mesh
    bx, by = xch.bx, xch.by
    launch = skb.LAUNCH[kind]
    deferred = skb.pick_block_temporal_2d_deferred(kind, (bx, by), k, mode)
    origins = [mesh.origin(b, (bx, by)) for b in range(mesh.size)]
    kw = dict(grid_shape=grid_shape, cx=cx, cy=cy)
    exts = None
    if kind in ("G-circ", "G"):
        assemble = (xch.assemble_circular if kind == "G-circ"
                    else xch.assemble_padded)
        exts = [torch.zeros((bx + 2 * k, by + 2 * k), dtype=xch.dtype,
                            device=mesh.device) for _ in range(mesh.size)]
    bands = {}

    def bands_of(us, vs):
        key = tuple(t.data_ptr() for t in us) + tuple(t.data_ptr()
                                                      for t in vs)
        if key not in bands:
            if len(bands) >= 4:  # buffers the run no longer holds
                bands.clear()
            bands[key] = skb.BandLaunch(us, xch.tail, xch.halo_n, xch.halo_s,
                                        vs, k, origins=origins, **kw)
        return bands[key]

    def fn(us, vs, want_res):
        res = []
        xch.phase1(us)
        if deferred:
            for b in range(mesh.size):
                res.append(launch(us[b], xch.tail[b], None, None, vs[b], k,
                                  want_res, origin=origins[b], **kw))
            xch.phase2(us)
            res.append(bands_of(us, vs)(want_res))
            return torch.stack(res).amax() if want_res else None
        xch.phase2(us)
        for b in range(mesh.size):
            if exts is not None:
                assemble(b, us[b], exts[b])
                r = launch(exts[b], vs[b], k, want_res, origin=origins[b],
                           **kw)
            else:
                r = launch(us[b], *xch.pieces(b), vs[b], k, want_res,
                           origin=origins[b], **kw)
            res.append(r)
        return torch.stack(res).amax() if want_res else None

    return fn


def block_temporal_multistep(config, mesh: HeatMesh, backend: str):
    """``(multi_step(us, vs, n) -> (us, vs), multi_step_residual(us, vs, n)
    -> (us, vs, res))`` on the block lists ``us`` (the state) and ``vs``
    (spares), by K-deep rounds, ``K = config.halo_depth``, in 2D or in 3D
    (``parallel/temporal3d.py``) by ``config.ndim``.

    ``backend`` is resolved ("cuda" or "torch"). The blocks, the
    exchange's buffers and the padded blocks are of ``config.dtype``. The
    kernel is picked once; a round of each depth the run's chunks need
    (K, and the remainders) is built here with its exchange buffers and
    kept for the run (any other depth on its first use).
    """
    K = config.halo_depth
    mode = resolve_halo_overlap(config, backend)
    block_shape = mesh.block_shape(config.shape)
    dtype = storage_dtype(config.dtype)
    coeffs = tuple(float(c) for c in config.coefficients)
    kw = dict(zip(("cx", "cy", "cz"), coeffs), grid_shape=config.shape)
    if config.ndim == 3:
        from parallel_heat_tpu_torch.ops import stencil_kernels_block_3d as sk
        from parallel_heat_tpu_torch.ops.stencil import stencil_interior_3d
        from parallel_heat_tpu_torch.parallel import temporal3d

        exchange, cuda_round = (temporal3d.DeepExchange3D,
                                temporal3d.cuda_round_3d)
        pick, interior = sk.pick_block_temporal_3d, stencil_interior_3d
    else:
        from parallel_heat_tpu_torch.ops import stencil_kernels_block as sk

        exchange, cuda_round = DeepExchange2D, _cuda_round_2d
        pick, interior = sk.pick_block_temporal_2d, stencil_interior_2d
    kind = pick(block_shape, K, dtype)[0] if backend == "cuda" else "torch"
    rounds = {}

    def round_of(depth):
        if depth not in rounds:
            xch = exchange(mesh, block_shape, depth, mesh.device, dtype)
            rounds[depth] = (
                _torch_round(xch, mode, grid_shape=config.shape,
                             stencil=lambda w: interior(w, *coeffs))
                if kind == "torch"
                else cuda_round(xch, kind, mode, **kw))
        return rounds[depth]

    # The depths this run's chunks need, built (buffers allocated) now,
    # before any clock starts.
    chunks = ([config.check_interval, config.steps % config.check_interval]
              if config.converge else [config.steps])
    for c in chunks:
        if c >= K:
            round_of(K)
        if c % K:
            round_of(c % K)

    def _run(us, vs, n, want_res):
        full, rem = divmod(n, K)
        res = None
        for i in range(full):
            last = want_res and rem == 0 and i == full - 1
            r = round_of(K)(us, vs, last)
            us, vs = vs, us
            if last:
                res = r
        if rem:
            res = round_of(rem)(us, vs, want_res)
            us, vs = vs, us
        return us, vs, res

    def multi_step(us, vs, n):
        us, vs, _ = _run(us, vs, n, False)
        return us, vs

    def multi_step_residual(us, vs, n):
        return _run(us, vs, n, True)

    return multi_step, multi_step_residual
