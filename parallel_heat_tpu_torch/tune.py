"""Pin a kernel decision: the port of ``parallel_heat_tpu.tune.force``.

Tests and ``chip_smoke.py`` drive each kernel through the real
``solve()`` by pinning a decision site for the extent of a ``with``
block: ``single_2d`` (the 2D picker), ``single_3d`` (the 3D picker),
``ensemble_2d`` (the ensemble engine's batched-kernel decision),
``block_temporal_2d`` (the sharded 2D round's kernel: G-circ and G run
only when pinned) or ``block_temporal_3d`` (the sharded 3D round's: H
and the deferred pair H-defer run only when pinned). The pinned choice
still goes through the picker's feasibility check.

``single_3d`` exists for the same reason as the 2D site. The JAX package
reaches kernel D only where kernel F declines a geometry; on the card
F's tiled design declines no grid of 3^3 or more, so the pin is the only
way to drive D through ``solve()``. It changes no result: F(K) is
bitwise K launches of D.

The measured tuning DB of the JAX package is not ported yet (ROADMAP
queue 1 item 11).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

SITE_CHOICES = {"single_2d": ("A", "E-uni", "E", "I-uni", "I", "B", "C",
                               "torch"),
                "single_3d": ("F", "D", "torch"),
                "ensemble_2d": ("M", "vmap"),
                "block_temporal_2d": ("G-uni", "G-fuse", "G-circ", "G",
                                      "torch"),
                "block_temporal_3d": ("H-fused", "H", "H-defer", "torch")}

_force_var: contextvars.ContextVar[Optional[Dict[str, str]]] = \
    contextvars.ContextVar("pht_torch_tune_force", default=None)


@contextlib.contextmanager
def force(site: str, choice: str):
    """Pin ``site``'s decision to ``choice`` inside the block."""
    if site not in SITE_CHOICES:
        raise ValueError(f"unknown tune site {site!r}")
    if choice not in SITE_CHOICES[site]:
        raise ValueError(f"choice {choice!r} outside site {site!r}'s "
                         f"vocabulary {SITE_CHOICES[site]}")
    nxt = dict(_force_var.get() or {})
    nxt[site] = choice
    token = _force_var.set(nxt)
    try:
        yield
    finally:
        _force_var.reset(token)


def forced(site: str) -> Optional[str]:
    """The choice pinned for ``site`` in this context, or None."""
    return (_force_var.get() or {}).get(site)
