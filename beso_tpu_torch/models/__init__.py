from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.models.scaler import Scaler, fit_scaler

__all__ = ["DiffusionGPT", "GCDenoiser", "Scaler", "fit_scaler",
           "make_rollout_denoise_factory"]
