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

Precision (``SEMANTICS.md`` "Precision"). Arithmetic is float32 at every
storage dtype. In ``accumulate="storage"`` mode a step rounds the interior
to the storage dtype (the textbook steps here do, by ``.to(u.dtype)``), and
the residual is the step's float32 update against the float32 of the old
state. In ``"f32chunk"`` mode (bfloat16 only) the state carries float32
through chunks of :data:`F32CHUNK_DEPTH` steps and rounds once a chunk
(:func:`f32chunk_steps`; the chunking is ``stencil_kernels``'
``_chunked_multistep``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# The f32chunk mode's chunk depth K: steps the state carries float32
# before it rounds to storage. The JAX package's ``_sub_rows`` of a 2-byte
# dtype, the sublane count of its temporal kernels (16 for bfloat16); here
# it is part of the semantics, not a tuning knob, and no launch depth of
# the port's kernels moves it.
F32CHUNK_DEPTH = 16

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float64": torch.float64}


def storage_dtype(name) -> torch.dtype:
    """The torch dtype of a storage dtype named as in ``HeatConfig.dtype``
    (a torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else _STORAGE[name]


def widen_bits(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor as float32 by its bits (the upper 16 bits of
    each float32), exact for every value, NaN payloads included: the
    kernels' widening (csrc/heat_common.cuh heat_widen)."""
    return (t.view(torch.int16).to(torch.int32) << 16).view(torch.float32)


def narrow_bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor that holds bfloat16 values (widened ones) as
    bfloat16, by its upper 16 bits: the kernels' exact narrowing of
    copied cells (heat_bf16_exact)."""
    return (t.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def ring_exact(out: torch.Tensor, u: torch.Tensor) -> None:
    """``out``'s Dirichlet ring from the 2D grid ``u``'s (each member's,
    for a stack with leading member axes), bit for bit, across a
    bfloat16 / float32 pair too, as the kernels copy it: a conversion
    would turn a NaN's payload into the canonical one."""
    for rows, cols in ((0, slice(None)), (-1, slice(None)),
                       (slice(None), 0), (slice(None), -1)):
        _copy_exact(out, u, (Ellipsis, rows, cols))


def faces_exact(out: torch.Tensor, u: torch.Tensor) -> None:
    """:func:`ring_exact` in 3D: ``out``'s six Dirichlet faces from the
    grid ``u``'s (each member's, for a stack with leading member axes),
    bit for bit, across a bfloat16 / float32 pair too."""
    every = slice(None)
    for at in (0, -1):
        for index in ((Ellipsis, at, every, every),
                      (Ellipsis, every, at, every),
                      (Ellipsis, every, every, at)):
            _copy_exact(out, u, index)


def _copy_exact(out: torch.Tensor, u: torch.Tensor, index) -> None:
    """``out[index] = u[index]`` by bits where the dtypes differ."""
    src = u[index]
    if u.dtype == out.dtype:
        out[index] = src
    elif u.dtype == torch.bfloat16:
        out[index] = widen_bits(src.contiguous())
    else:
        out[index] = narrow_bits(src.contiguous())


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


def f32chunk_steps(u: torch.Tensor, out: torch.Tensor, k: int,
                   with_residual: bool, cx: float, cy: float):
    """``k`` textbook steps of ``u`` into ``out`` with the state carried in
    float32 and rounded to ``out``'s dtype once, at the end: one f32chunk
    chunk (the counterpart of ``pallas_stencil.f32chunk_jnp_multistep``'s
    chunk function). Returns the last step's residual, its float32 update
    against the float32 level it read, or None without
    ``with_residual``. The ring is copied from ``u``. Leading member axes
    are taken, as by the steps it chains."""
    v = u.to(torch.float32)
    res = None
    for s in range(k):
        if with_residual and s == k - 1:
            v, res = step_2d_residual(v, cx, cy)
        else:
            v = step_2d(v, cx, cy)
    out[..., 1:-1, 1:-1] = v[..., 1:-1, 1:-1]
    ring_exact(out, u)
    return res
