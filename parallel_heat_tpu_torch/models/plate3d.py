"""The 3D heated volume: the 7-point extension of the plate.

The initial condition generalises the 2D plate's separable polynomial to
three axes::

    u0(ix, iy, iz) = ix*(nx-ix-1) * iy*(ny-iy-1) * iz*(nz-iz-1)

zero on all six faces, which the stencil never writes (Dirichlet).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class HeatPlate3D:
    """3D volume with separable polynomial initial condition."""

    def __init__(self, nx: int, ny: int, nz: int, cx: float = 0.1,
                 cy: float = 0.1, cz: float = 0.1):
        self.nx = int(nx)
        self.ny = int(ny)
        self.nz = int(nz)
        self.cx = float(cx)
        self.cy = float(cy)
        self.cz = float(cz)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    def init_grid_np(self, dtype=np.float32) -> np.ndarray:
        """Host grid evaluated in float64, then cast (the oracle form)."""
        nx, ny, nz = self.shape
        ix = np.arange(nx, dtype=np.float64)[:, None, None]
        iy = np.arange(ny, dtype=np.float64)[None, :, None]
        iz = np.arange(nz, dtype=np.float64)[None, None, :]
        u = ix * (nx - ix - 1) * iy * (ny - iy - 1) * iz * (nz - iz - 1)
        return u.astype(dtype)

    def init_grid(self, device, dtype=torch.float32) -> torch.Tensor:
        """Grid built on ``device`` as ``(fx ⊗ fy) ⊗ fz`` of the float32
        per-axis factors ``fx = ix*(nx-ix-1)``.

        Every operation is one correctly rounded float32 operation in the
        same order as the JAX package's ``init_grid``, so the two grids
        are bitwise equal. The two products round, so a cell may differ
        from the float64 oracle by an ulp.
        """
        return self.init_block(device, (0, 0, 0), self.shape, dtype)

    def init_block(self, device, origin, shape,
                   dtype=torch.float32) -> torch.Tensor:
        """The ``shape`` block of :meth:`init_grid` whose cell (0, 0, 0) is
        global cell ``origin``, built alone (the counterpart of the JAX
        package's ``HeatPlate3D.init_block``): the same float32 operations
        on the same values (the global indices are exact in float32), so
        the blocks of a mesh are bitwise the slices of the full grid and
        no full-grid temporary is needed."""
        from parallel_heat_tpu_torch.ops.stencil import storage_dtype

        f = []
        for o, s, n in zip(origin, shape, self.shape):
            i = torch.arange(o, o + s, dtype=torch.float32, device=device)
            f.append(i * (n - i - 1))
        return (f[0][:, None, None] * f[1][None, :, None]
                * f[2][None, None, :]).to(storage_dtype(dtype))
