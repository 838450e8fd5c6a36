"""Jacobi stencil update ops in plain PyTorch.

The update rule::

    u'[i,j] = u[i,j] + cx*(u[i+1,j] + u[i-1,j] - 2*u[i,j])
                     + cy*(u[i,j+1] + u[i,j-1] - 2*u[i,j])

applied to interior cells only; boundary cells are Dirichlet (never
written). Arithmetic is float32. The 3D 7-point rule adds
``cz*(u[.,.,k+1] + u[.,.,k-1] - 2*u)`` on the third axis.

Two combine forms coexist, as in the JAX package:

- the **torch backend** (:func:`step_2d`, :func:`step_2d_residual`)
  evaluates the reference's textbook tree
  ``c + cx*(up+down-2c) + cy*(left+right-2c)``;
- the **kernels** and their plain versions evaluate the factored form
  :func:`combine_2d`, ``a0*c + cx*(up+down) + cy*(left+right)`` with
  ``a0 = 1-2cx-2cy``, in exactly this operation order, each operation
  rounded on its own (the CUDA sources use ``__fmul_rn``/``__fadd_rn``
  so that nvcc contracts nothing into an FMA). Eager PyTorch rounds
  every elementwise op, so a kernel and its plain version agree
  bitwise; the two forms agree to a few ulp. In 3D the same holds for
  :func:`step_3d` and :func:`combine_3d`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def coeffs_f32(cx: float, cy: float) -> Tuple[float, float, float]:
    """``(a0, cx, cy)`` as float32 values (held in Python floats).

    ``a0 = 1 - 2cx - 2cy`` is evaluated in float64 and rounded to float32
    once, as the JAX kernels' ``jnp.float32(1.0 - 2.0*cx - 2.0*cy)`` does;
    ``cx`` and ``cy`` are rounded to float32. Every consumer (kernels and
    plain versions) takes its constants from here.
    """
    return (float(np.float32(1.0 - 2.0 * cx - 2.0 * cy)),
            float(np.float32(cx)), float(np.float32(cy)))


def coeffs3_f32(cx: float, cy: float,
                cz: float) -> Tuple[float, float, float, float]:
    """``(a0, cx, cy, cz)`` as float32 values for the 7-point combine:
    ``a0 = 1 - 2cx - 2cy - 2cz`` evaluated in float64 (left to right,
    as the JAX package's ``combine_3d``) and rounded to float32 once."""
    return (float(np.float32(1.0 - 2.0 * cx - 2.0 * cy - 2.0 * cz)),
            float(np.float32(cx)), float(np.float32(cy)),
            float(np.float32(cz)))


def combine_2d(c, up, down, left, right, a0: float, cx: float, cy: float):
    """Factored 5-point combine ``a0*c + cx*(up+down) + cy*(left+right)``,
    evaluated left to right; constants from :func:`coeffs_f32`."""
    return a0 * c + cx * (up + down) + cy * (left + right)


def combine_3d(c, xm, xp, ym, yp, zm, zp, a0: float, cx: float, cy: float,
               cz: float):
    """Factored 7-point combine
    ``a0*c + cx*(xm+xp) + cy*(ym+yp) + cz*(zm+zp)``, evaluated left to
    right; constants from :func:`coeffs3_f32`."""
    return a0 * c + cx * (xm + xp) + cy * (ym + yp) + cz * (zm + zp)


def stencil_interior_2d(u: torch.Tensor, cx: float, cy: float):
    """Textbook 5-point update of every cell that has four neighbours:
    ``(m, n) -> (m-2, n-2)``. As every function of this module, it takes
    leading member axes: a ``(B, m, n)`` stack is B grids."""
    u = u.to(torch.float32)
    c = u[..., 1:-1, 1:-1]
    return (
        c
        + cx * (u[..., 2:, 1:-1] + u[..., :-2, 1:-1] - 2.0 * c)
        + cy * (u[..., 1:-1, 2:] + u[..., 1:-1, :-2] - 2.0 * c)
    )


def step_2d(u: torch.Tensor, cx: float, cy: float) -> torch.Tensor:
    """One full-grid step: interior updated, boundary carried over."""
    out = u.clone()
    out[..., 1:-1, 1:-1] = stencil_interior_2d(u, cx, cy).to(u.dtype)
    return out


def step_2d_residual(u: torch.Tensor, cx: float, cy: float):
    """One step plus the max-norm residual ``max |u' - u|`` over the
    interior (a float32 tensor, 0-d for one grid and one value per member
    for a stack; NaN if any update is NaN)."""
    old = u[..., 1:-1, 1:-1].to(torch.float32)
    new = stencil_interior_2d(u, cx, cy)
    residual = (new - old).abs().amax(dim=(-2, -1))
    out = u.clone()
    out[..., 1:-1, 1:-1] = new.to(u.dtype)
    return out, residual


def stencil_interior_3d(u: torch.Tensor, cx: float, cy: float, cz: float):
    """Textbook 7-point update of every cell that has six neighbours:
    ``(m, n, p) -> (m-2, n-2, p-2)``."""
    u = u.to(torch.float32)
    c = u[..., 1:-1, 1:-1, 1:-1]
    return (
        c
        + cx * (u[..., 2:, 1:-1, 1:-1] + u[..., :-2, 1:-1, 1:-1] - 2.0 * c)
        + cy * (u[..., 1:-1, 2:, 1:-1] + u[..., 1:-1, :-2, 1:-1] - 2.0 * c)
        + cz * (u[..., 1:-1, 1:-1, 2:] + u[..., 1:-1, 1:-1, :-2] - 2.0 * c)
    )


def step_3d(u: torch.Tensor, cx: float, cy: float,
            cz: float) -> torch.Tensor:
    """One full-grid 3D step: interior updated, faces carried over."""
    out = u.clone()
    out[..., 1:-1, 1:-1, 1:-1] = stencil_interior_3d(u, cx, cy,
                                                     cz).to(u.dtype)
    return out


def step_3d_residual(u: torch.Tensor, cx: float, cy: float, cz: float):
    """One 3D step plus the interior max-norm residual (float32, 0-d for
    one grid and one value per member for a stack; NaN-propagating)."""
    old = u[..., 1:-1, 1:-1, 1:-1].to(torch.float32)
    new = stencil_interior_3d(u, cx, cy, cz)
    residual = (new - old).abs().amax(dim=(-3, -2, -1))
    out = u.clone()
    out[..., 1:-1, 1:-1, 1:-1] = new.to(u.dtype)
    return out, residual
