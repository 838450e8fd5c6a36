"""parallel_heat_tpu_torch — the PyTorch/CUDA port of parallel_heat_tpu.

The JAX package ``parallel_heat_tpu`` is the reference; this package
computes the same runs on an NVIDIA H100 (Hopper, sm_90a) with PyTorch
and hand-written CUDA kernels, and never imports JAX or the JAX package.
This slice carries the main path: ``solve(HeatConfig)`` on one device,
2D, explicit scheme, float32, fixed-step and converge-to-eps, through
kernel B (``heat_b_step``, one step) and kernel E (``heat_e_temporal``,
K steps per pass). Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``.
"""

from parallel_heat_tpu_torch.config import HeatConfig
from parallel_heat_tpu_torch.models import HeatPlate2D
from parallel_heat_tpu_torch.solver import (
    HeatResult,
    explain,
    solve,
)

__version__ = "0.1.0"

__all__ = [
    "HeatConfig",
    "HeatPlate2D",
    "HeatResult",
    "explain",
    "solve",
    "__version__",
]
