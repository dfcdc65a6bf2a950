"""Device operations per whole env step that the rollout loop and the policy
glue enqueued: the runtime calls that launch a kernel or a copy or set
memory made while `rollout.step` or `policy.predict` was the innermost
program span open, outside the denoiser calls and the physics
(`benchmark/spans.py`)."""

from benchmark import spans

UNIT, SOURCE = "launches/step", "device_trace"
LAYER = "rollout loop and policy glue"
MOVES = "rollout_env_steps_per_s"
KERNELS = "runtime calls that enqueue a kernel, copy or memset, against the program spans"


def read(ctx):
    return spans.launches_per_step(ctx, "policy_glue")
