from beso_tpu_torch.core.precond import append_dims, edm_scalings
from beso_tpu_torch.core.schedules import get_noise_schedule

__all__ = ["append_dims", "edm_scalings", "get_noise_schedule"]
