from parallel_heat_tpu_torch.models.plate2d import HeatPlate2D
from parallel_heat_tpu_torch.models.plate3d import HeatPlate3D

__all__ = ["HeatPlate2D", "HeatPlate3D"]
