"""The device's idle share in the rollout's traced slice: one less the
union of the kernel intervals over the slice's wall time."""

UNIT, SOURCE = "%", "device_trace"
LAYER = "device"
MOVES = "rollout_env_steps_per_s"
KERNELS = "every device kernel"


def read(ctx):
    if ctx.trace is None or ctx.unit != "env_step" or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
