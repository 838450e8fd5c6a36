"""parallel_heat_tpu_torch — the PyTorch/CUDA port of parallel_heat_tpu.

The JAX package ``parallel_heat_tpu`` is the reference; this package
computes the same runs on an NVIDIA H100 (Hopper, sm_90a) with PyTorch
and hand-written CUDA kernels, and never imports JAX or the JAX package.
It carries ``solve(HeatConfig)`` on one device, float32, fixed-step and
converge-to-eps: the explicit scheme in 2D through the seven kernels of
the 2D picker (``ops/stencil_kernels.py``) and in 3D (``nz`` set) through
kernel F (``heat_f_temporal3d``, K steps per pass) and kernel D
(``heat_d_step3d``, one step; ``ops/stencil_kernels_3d.py``); the
implicit schemes (``scheme="backward_euler" | "crank_nicolson"``, 2D)
through a multigrid V-cycle per step whose transfer operators are the
kernels ``heat_mg_restrict`` and ``heat_mg_prolong``
(``ops/multigrid.py``); and ``EnsembleSolver(config, B)``, B member
grids of one config advanced together, through kernel M
(``heat_m_ensemble``, ``ops/batched.py``) where it admits. An explicit
config with ``mesh_shape`` runs cut over a mesh of blocks
(:class:`HeatMesh`, every block on the run's one device) by K-deep halo
exchanges and rounds of the sharded kernels: ``heat_g_*`` in 2D
(``ops/stencil_kernels_block.py``, ``parallel/temporal.py``) and
``heat_h_*`` in 3D (``ops/stencil_kernels_block_3d.py``,
``parallel/temporal3d.py``), bitwise a one-block run.
``solve_stream`` runs any of these in host-visible chunks with the
runtime guard, the grid diagnostics and a :class:`Telemetry` sink, and
at pipeline depth 2 keeps the next chunk on the card while it drains
the last one's observers. Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"``.
"""

from parallel_heat_tpu_torch.config import EnsembleConfig, HeatConfig
from parallel_heat_tpu_torch.ensemble import EnsembleResult, EnsembleSolver
from parallel_heat_tpu_torch.models import HeatPlate2D, HeatPlate3D
from parallel_heat_tpu_torch.parallel.mesh import HeatMesh, pick_mesh_shape
from parallel_heat_tpu_torch.solver import (
    HeatResult,
    explain,
    grid_all_finite,
    grid_stats,
    make_initial_grid,
    solve,
    solve_stream,
)
from parallel_heat_tpu_torch.utils.telemetry import Telemetry

__version__ = "0.1.0"

__all__ = [
    "EnsembleConfig",
    "EnsembleResult",
    "EnsembleSolver",
    "HeatConfig",
    "HeatMesh",
    "HeatPlate2D",
    "HeatPlate3D",
    "HeatResult",
    "Telemetry",
    "explain",
    "grid_all_finite",
    "grid_stats",
    "make_initial_grid",
    "pick_mesh_shape",
    "solve",
    "solve_stream",
    "__version__",
]
