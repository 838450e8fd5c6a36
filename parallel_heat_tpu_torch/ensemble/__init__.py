"""Batched ensemble engine: many independent grids on one card.

The port of ``parallel_heat_tpu/ensemble``. B independent member grids of
one :class:`~parallel_heat_tpu_torch.config.HeatConfig` are stacked on a
leading member axis and advanced together: by kernel M
(``ops/batched.py``, one launch for all members) where it admits, by the
textbook torch stencil or the implicit V-cycle over the member axis (the
"vmap" path) otherwise. Converge mode keeps per-member verdicts on the
device, freezes finished members by a masked update, and compacts the
live batch when the live fraction drops below
``EnsembleConfig.compact_threshold``.

Contracts, as in the JAX package:

- **member parity**: a member of a batched run is bitwise the
  single-grid ``solve()`` of the same config on the same resolved path;
- **compaction invariance**: a member's trajectory does not depend on
  when (or whether) other members finish.
"""

from parallel_heat_tpu_torch.ensemble.engine import (  # noqa: F401
    EnsembleBoundary,
    EnsembleInterrupted,
    EnsembleResult,
    EnsembleSolver,
    ensemble_path,
    packable,
)
