from parallel_heat_tpu_torch.models.plate2d import HeatPlate2D

__all__ = ["HeatPlate2D"]
