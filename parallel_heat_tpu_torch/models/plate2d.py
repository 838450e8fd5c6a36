"""The 2D heated plate: initial condition, boundary, coefficients.

Reference semantics (``inidat``)::

    u0(ix, iy) = ix * (nx - ix - 1) * iy * (ny - iy - 1)

zero on the whole boundary, which the stencil never writes (Dirichlet).
"""

from __future__ import annotations

import numpy as np
import torch


class HeatPlate2D:
    """2D plate with polynomial initial condition and fixed boundary."""

    def __init__(self, nx: int, ny: int, cx: float = 0.1, cy: float = 0.1):
        self.nx = int(nx)
        self.ny = int(ny)
        self.cx = float(cx)
        self.cy = float(cy)

    def init_grid_np(self, dtype=np.float32) -> np.ndarray:
        """Host grid evaluated in float64, then cast (the oracle form)."""
        nx, ny = self.nx, self.ny
        ix = np.arange(nx, dtype=np.float64)[:, None]
        iy = np.arange(ny, dtype=np.float64)[None, :]
        u = ix * (nx - ix - 1) * iy * (ny - iy - 1)
        return u.astype(dtype)

    def init_grid(self, device, dtype=torch.float32) -> torch.Tensor:
        """Grid built on ``device`` as the float32 outer product of the
        per-axis factors ``fx = ix*(nx-ix-1)``.

        Every operation is one correctly rounded float32 operation in the
        same order as the JAX package's ``init_grid``, so the two grids
        are bitwise equal (and equal to the float64 oracle while the
        factors stay below 2^24, i.e. for nx, ny <= 8192). ``dtype`` (a
        torch dtype or a ``HeatConfig.dtype`` name) is the storage dtype
        the float32 product is cast to at the end, as in the JAX package.
        """
        return self.init_block(device, (0, 0), (self.nx, self.ny), dtype)

    def init_block(self, device, origin, shape,
                   dtype=torch.float32) -> torch.Tensor:
        """The ``shape`` block of :meth:`init_grid` whose cell (0, 0) is
        global cell ``origin``, built alone: the same float32 operations
        on the same values (the global indices are exact in float32), so
        the blocks of a mesh are bitwise the slices of the full grid and
        no full-grid temporary is needed."""
        from parallel_heat_tpu_torch.ops.stencil import storage_dtype

        nx, ny = self.nx, self.ny
        ix = torch.arange(origin[0], origin[0] + shape[0],
                          dtype=torch.float32, device=device)
        iy = torch.arange(origin[1], origin[1] + shape[1],
                          dtype=torch.float32, device=device)
        fx = ix * (nx - ix - 1)
        fy = iy * (ny - iy - 1)
        return (fx[:, None] * fy[None, :]).to(storage_dtype(dtype))
