"""Carry a run's state across from the JAX package.

A solver whose only state is its grid carries across as its
configuration plus that grid. :func:`from_jax` takes
``dataclasses.asdict`` of a ``parallel_heat_tpu.HeatConfig`` (a plain
dict, so this module needs nothing of JAX) and a numpy grid such as
``np.asarray(result.grid)`` or a checkpoint array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from parallel_heat_tpu_torch.config import HeatConfig

# The JAX package's backend names, in this package's vocabulary.
_BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda"}


def from_jax(config_fields: dict, grid: Optional[np.ndarray],
             device: str = "cuda") -> Tuple[HeatConfig, Optional[torch.Tensor]]:
    """``(HeatConfig, grid tensor or None)`` for this package.

    2D and 3D (``nz`` set) configs carry across. JAX-only fields set away
    from their defaults (a mesh, an implicit scheme, observers, ...) are
    refused, as :meth:`HeatConfig.from_dict` does. The grid, when given,
    is checked against the config's shape and copied to ``device`` as
    float32.
    """
    fields = dict(config_fields)
    backend = fields.get("backend", "auto")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown JAX backend {backend!r}")
    fields["backend"] = _BACKENDS[backend]
    fields["device"] = device
    config = HeatConfig.from_dict(fields)
    if grid is None:
        return config, None
    arr = np.asarray(grid)
    if arr.shape != config.shape:
        raise ValueError(f"grid shape {arr.shape} does not match config "
                         f"shape {config.shape}")
    tensor = torch.tensor(arr, dtype=torch.float32, device=device)
    return config, tensor
