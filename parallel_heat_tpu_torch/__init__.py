"""parallel_heat_tpu_torch — the PyTorch/CUDA port of parallel_heat_tpu.

The JAX package ``parallel_heat_tpu`` is the reference; this package
computes the same runs on an NVIDIA H100 (Hopper, sm_90a) with PyTorch
and hand-written CUDA kernels, and never imports JAX or the JAX package.
It carries ``solve(HeatConfig)`` on one device, explicit scheme,
float32, fixed-step and converge-to-eps: 2D through the seven kernels of
the 2D picker (``ops/stencil_kernels.py``) and 3D (``nz`` set) through
kernel F (``heat_f_temporal3d``, K steps per pass) and kernel D
(``heat_d_step3d``, one step; ``ops/stencil_kernels_3d.py``). Entry
points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
"""

from parallel_heat_tpu_torch.config import HeatConfig
from parallel_heat_tpu_torch.models import HeatPlate2D, HeatPlate3D
from parallel_heat_tpu_torch.solver import (
    HeatResult,
    explain,
    solve,
)

__version__ = "0.1.0"

__all__ = [
    "HeatConfig",
    "HeatPlate2D",
    "HeatPlate3D",
    "HeatResult",
    "explain",
    "solve",
    "__version__",
]
