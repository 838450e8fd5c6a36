"""The device mesh of a sharded run: the port of
``parallel_heat_tpu/parallel/mesh.py``.

The JAX package runs ``shard_map`` from one controller over a named
device mesh, and a neighbour's halo arrives by ``lax.ppermute``. Here one
process holds one block tensor per mesh position, in row-major order of
the mesh coordinates, and a shift is a copy between those tensors:
:meth:`HeatMesh.shift_down` hands block ``i`` what block ``i - 1`` along
an axis holds, :meth:`HeatMesh.shift_up` what block ``i + 1`` holds, and
a block with no such neighbour gets zeros, as ``ppermute`` gives. Every
block lives on the run's one device (``cuda:0`` unless the run asks for
the CPU); blocks on several GPUs over ``torch.distributed`` are the
counterpart of ``parallel/distributed.py``, a later slice (ROADMAP.md
queue 1 item 8).

:func:`pick_mesh_shape` and :func:`divisible_factorizations` are this
package's own copies of the JAX package's helpers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

AXIS_NAMES = ("x", "y", "z")


def pick_mesh_shape(n_devices: int, ndim: int = 2) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``ndim`` near-equal factors, largest
    first (``MPI_Dims_create``'s convention): the largest prime factor
    goes into the smallest dimension, repeatedly."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dims = [1] * ndim
    primes, n, f = [], n_devices, 2
    while f * f <= n:
        while n % f == 0:
            primes.append(f)
            n //= f
        f += 1
    if n > 1:
        primes.append(n)
    for p in sorted(primes, reverse=True):
        dims[dims.index(min(dims))] *= p
    return tuple(sorted(dims, reverse=True))


def _factorizations(n: int, ndim: int):
    """All ordered ``ndim``-tuples of positive ints with product n."""
    if ndim == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, ndim - 1):
                yield (d,) + rest


def divisible_factorizations(n_devices: int, shape) -> list:
    """The ordered ``len(shape)``-factorizations of ``n_devices`` whose
    factors divide the grid extents: the mesh shapes that device count
    can take on this grid (the hint of the divisibility error)."""
    return [mesh for mesh in _factorizations(n_devices, len(shape))
            if all(n % d == 0 for n, d in zip(shape, mesh))]


class HeatMesh:
    """A mesh of ``shape`` blocks, all on ``device``.

    Block ``b`` sits at mesh coordinates :meth:`coords` ``(b)``, row-major;
    for a grid of ``grid_shape`` its extent is :meth:`block_shape` and its
    cell (0, 0) lies at global :meth:`origin` ``(b, block_shape)``.
    """

    def __init__(self, shape: Sequence[int], device="cpu"):
        self.shape = tuple(int(d) for d in shape)
        if any(d < 1 for d in self.shape):
            raise ValueError(f"mesh entries must be >= 1, got {self.shape}")
        self.axis_names = AXIS_NAMES[:len(self.shape)]
        self.device = torch.device(device)
        self.size = 1
        for d in self.shape:
            self.size *= d

    def coords(self, b: int) -> Tuple[int, ...]:
        out = []
        for d in reversed(self.shape):
            out.append(b % d)
            b //= d
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        b = 0
        for c, d in zip(coords, self.shape):
            b = b * d + c
        return b

    def neighbour(self, b: int, axis: int, step: int) -> Optional[int]:
        """The block ``step`` positions from ``b`` along ``axis``, or None
        past the mesh's edge (the domain is not periodic)."""
        c = list(self.coords(b))
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return self.index(c)

    def block_shape(self, grid_shape) -> Tuple[int, ...]:
        return tuple(n // d for n, d in zip(grid_shape, self.shape))

    def origin(self, b: int, block_shape) -> Tuple[int, ...]:
        return tuple(c * s for c, s in zip(self.coords(b), block_shape))

    def split(self, grid: torch.Tensor) -> List[torch.Tensor]:
        """One contiguous copy of each block of ``grid``, on the mesh's
        device, in the grid's own dtype (its storage dtype: bit for bit)."""
        bs = self.block_shape(grid.shape)
        out = []
        for b in range(self.size):
            idx = tuple(slice(o, o + s)
                        for o, s in zip(self.origin(b, bs), bs))
            out.append(grid[idx].to(device=self.device,
                                    copy=True).contiguous())
        return out

    def assemble(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global grid of ``blocks`` (a new tensor)."""
        bs = tuple(blocks[0].shape)
        grid = blocks[0].new_empty(tuple(s * d for s, d in zip(bs,
                                                                self.shape)))
        for b, block in enumerate(blocks):
            idx = tuple(slice(o, o + s)
                        for o, s in zip(self.origin(b, bs), bs))
            grid[idx] = block
        return grid

    def shift_down(self, xs: Sequence[torch.Tensor],
                   axis: int) -> List[torch.Tensor]:
        """Each block receives ``xs`` of its lower-index neighbour along
        ``axis`` (i - 1 -> i); the first receives zeros."""
        return [xs[nb].clone() if nb is not None else torch.zeros_like(xs[b])
                for b, nb in ((b, self.neighbour(b, axis, -1))
                              for b in range(self.size))]

    def shift_up(self, xs: Sequence[torch.Tensor],
                 axis: int) -> List[torch.Tensor]:
        """Each block receives ``xs`` of its higher-index neighbour along
        ``axis`` (i + 1 -> i); the last receives zeros."""
        return [xs[nb].clone() if nb is not None else torch.zeros_like(xs[b])
                for b, nb in ((b, self.neighbour(b, axis, 1))
                              for b in range(self.size))]
