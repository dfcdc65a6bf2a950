from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.models.scaler import Scaler, fit_minmax_scaler, fit_scaler

__all__ = ["DiffusionGPT", "GCDenoiser", "Scaler", "fit_minmax_scaler", "fit_scaler",
           "make_fused_denoise_fn", "make_rollout_denoise_factory"]


def __getattr__(name):
    # models.fused imports ops.fused_layer, which imports models.gpt: loaded
    # on first use, so that importing ops.fused_layer first is no cycle
    if name == "make_fused_denoise_fn":
        from beso_tpu_torch.models.fused import make_fused_denoise_fn

        return make_fused_denoise_fn
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
