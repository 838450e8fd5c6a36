"""Carry a run's state across from the JAX package.

A solver whose only state is its grid carries across as its
configuration plus that grid. :func:`from_jax` takes
``dataclasses.asdict`` of a ``parallel_heat_tpu.HeatConfig`` (a plain
dict, so this module needs nothing of JAX) and a numpy grid such as
``np.asarray(result.grid)`` or a checkpoint array; for an ensemble, also
``dataclasses.asdict`` of a ``parallel_heat_tpu.EnsembleConfig`` and the
stacked ``(B, *shape)`` member grids.

A bfloat16 grid from the JAX package is an ``ml_dtypes`` array on the
numpy side. This package does not import ``ml_dtypes`` (the card's
machine has none): it carries such a grid across by its bits, a view as
16-bit integers on the numpy side and as ``torch.bfloat16`` on the torch
side (:func:`to_tensor`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from parallel_heat_tpu_torch.config import EnsembleConfig, HeatConfig
from parallel_heat_tpu_torch.ops.stencil import storage_dtype

# The JAX package's backend names, in this package's vocabulary.
_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def to_tensor(grid, dtype, device) -> torch.Tensor:
    """A new contiguous tensor of ``grid`` (a tensor, a numpy array, an
    ``ml_dtypes`` bfloat16 array or anything ``np.asarray`` takes) as
    ``dtype`` on ``device``. A bfloat16 array crosses by its bits."""
    if not isinstance(grid, torch.Tensor):
        arr = np.array(grid, copy=True, order="C")
        if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
            grid = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            grid = torch.from_numpy(arr)
    return grid.to(device=device, dtype=storage_dtype(dtype),
                   copy=True).contiguous()


def from_jax(config_fields: dict, grid: Optional[np.ndarray],
             device: str = "cuda", ensemble_fields: Optional[dict] = None):
    """``(HeatConfig, grid tensor or None)`` for this package, or, with
    ``ensemble_fields``, ``(HeatConfig, EnsembleConfig, stacked grids or
    None)``.

    2D and 3D (``nz`` set) configs carry across, ``scheme``, the
    ``mg_*`` knobs, the mesh fields (``mesh_shape``, ``overlap``,
    ``halo_depth``, ``halo_overlap``) and the observers
    (``guard_interval``, ``diag_interval``, ``pipeline_depth``) included.
    ``dtype`` and ``accumulate`` carry across too. A JAX-only field set
    away from its default (``mg_partition``) is refused, as
    :meth:`HeatConfig.from_dict` does. The grid, when given, is checked
    against the config's shape (``(B, *shape)`` for an ensemble of B
    members) and copied to ``device`` in the config's dtype (a bfloat16
    grid by its bits); the global grid of a
    sharded config (``np.asarray`` of a JAX sharded array gathers it)
    comes back split into this package's blocks (2D or 3D), a list in the
    mesh's row-major order that ``solve(config, initial=blocks)`` takes.
    """
    fields = dict(config_fields)
    backend = fields.get("backend", "auto")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown JAX backend {backend!r}")
    fields["backend"] = _BACKENDS[backend]
    fields["device"] = device
    config = HeatConfig.from_dict(fields)
    want = config.shape
    ensemble = None
    if ensemble_fields is not None:
        ensemble = EnsembleConfig(**ensemble_fields).validate()
        want = (ensemble.members,) + want
    tensor = None
    if grid is not None:
        tensor = to_tensor(grid, config.dtype, device)
        if tuple(tensor.shape) != want:
            raise ValueError(f"grid shape {tuple(tensor.shape)} does not "
                             f"match the expected shape {want}")
        if ensemble is None and config.is_sharded():
            from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

            tensor = HeatMesh(config.mesh_shape, device).split(tensor)
    if ensemble is not None:
        return config, ensemble, tensor
    return config, tensor
