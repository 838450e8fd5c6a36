"""Carry a run's state across from the JAX package.

A solver whose only state is its grid carries across as its
configuration plus that grid. :func:`from_jax` takes
``dataclasses.asdict`` of a ``parallel_heat_tpu.HeatConfig`` (a plain
dict, so this module needs nothing of JAX) and a numpy grid such as
``np.asarray(result.grid)`` or a checkpoint array; for an ensemble, also
``dataclasses.asdict`` of a ``parallel_heat_tpu.EnsembleConfig`` and the
stacked ``(B, *shape)`` member grids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from parallel_heat_tpu_torch.config import EnsembleConfig, HeatConfig

# The JAX package's backend names, in this package's vocabulary.
_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def from_jax(config_fields: dict, grid: Optional[np.ndarray],
             device: str = "cuda", ensemble_fields: Optional[dict] = None):
    """``(HeatConfig, grid tensor or None)`` for this package, or, with
    ``ensemble_fields``, ``(HeatConfig, EnsembleConfig, stacked grids or
    None)``.

    2D and 3D (``nz`` set) configs carry across, ``scheme``, the
    ``mg_*`` knobs, the mesh fields (``mesh_shape``, ``overlap``,
    ``halo_depth``, ``halo_overlap``) and the observers
    (``guard_interval``, ``diag_interval``, ``pipeline_depth``) included.
    JAX-only fields set away from their defaults (``accumulate``,
    ``mg_partition``) are refused, as
    :meth:`HeatConfig.from_dict` does. The grid, when given, is checked
    against the config's shape (``(B, *shape)`` for an ensemble of B
    members) and copied to ``device`` as float32; the global grid of a
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
        arr = np.asarray(grid)
        if arr.shape != want:
            raise ValueError(f"grid shape {arr.shape} does not match the "
                             f"expected shape {want}")
        tensor = torch.tensor(arr, dtype=torch.float32, device=device)
        if ensemble is None and config.is_sharded():
            from parallel_heat_tpu_torch.parallel.mesh import HeatMesh

            tensor = HeatMesh(config.mesh_shape, device).split(tensor)
    if ensemble is not None:
        return config, ensemble, tensor
    return config, tensor
