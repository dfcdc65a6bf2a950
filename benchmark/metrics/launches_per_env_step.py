"""Device kernels per env step in the traced slice: the rollout loop and
policy glue (`rollout/rollout.py`, `agents/policy.py`,
`sampling/samplers.py`, `models/cfg.py`) launch them one by one from the
host."""

UNIT, SOURCE = "launches/step", "device_trace"
LAYER = "rollout loop and policy glue"
MOVES = "rollout_env_steps_per_s"
KERNELS = "every device kernel"


def read(ctx):
    if ctx.trace is None or ctx.unit != "env_step" or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.trace.steps
