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
        factors stay below 2^24, i.e. for nx, ny <= 8192).
        """
        nx, ny = self.nx, self.ny
        ix = torch.arange(nx, dtype=torch.float32, device=device)
        iy = torch.arange(ny, dtype=torch.float32, device=device)
        fx = ix * (nx - ix - 1)
        fy = iy * (ny - iy - 1)
        return (fx[:, None] * fy[None, :]).to(dtype)
