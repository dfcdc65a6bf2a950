"""The device's idle time while the physics' span (`physics.step`, around
`kitchen_step`) was the innermost program span open, as a share of the
whole env steps' time in the host slice (`benchmark/spans.py`)."""

from benchmark import spans

UNIT, SOURCE = "%", "device_trace"
LAYER = "physics"
MOVES = "rollout_env_steps_per_s"
KERNELS = "every device operation, against the program spans of the host slice"


def read(ctx):
    return spans.idle_share(ctx, "physics")
