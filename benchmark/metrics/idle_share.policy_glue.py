"""The device's idle time while the rollout loop or the policy glue was the
innermost program span open (`rollout.step` or `policy.predict`, outside
their denoiser calls and physics), as a share of the whole env steps' time
in the host slice (`benchmark/spans.py`)."""

from benchmark import spans

UNIT, SOURCE = "%", "device_trace"
LAYER = "rollout loop and policy glue"
MOVES = "rollout_env_steps_per_s"
KERNELS = "every device operation, against the program spans of the host slice"


def read(ctx):
    return spans.idle_share(ctx, "policy_glue")
