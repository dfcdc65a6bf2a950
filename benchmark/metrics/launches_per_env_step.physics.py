"""Device operations per whole env step that the physics enqueued: the
runtime calls that launch a kernel or a copy or set memory made while
`physics.step` was the innermost program span open (`benchmark/spans.py`)."""

from benchmark import spans

UNIT, SOURCE = "launches/step", "device_trace"
LAYER = "physics"
MOVES = "rollout_env_steps_per_s"
KERNELS = "runtime calls that enqueue a kernel, copy or memset, against the program spans"


def read(ctx):
    return spans.launches_per_step(ctx, "physics")
