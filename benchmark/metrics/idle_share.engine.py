"""The device's idle time while a denoiser call (`engine.call`, the engine
and the model's host work around its kernels) was the innermost program
span open, as a share of the whole env steps' time in the host slice
(`benchmark/spans.py`)."""

from benchmark import spans

UNIT, SOURCE = "%", "device_trace"
LAYER = "model step"
MOVES = "rollout_env_steps_per_s"
KERNELS = "every device operation, against the program spans of the host slice"


def read(ctx):
    return spans.idle_share(ctx, "engine")
