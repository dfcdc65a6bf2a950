"""The rollout's model FLOPs over the window's time, as a share of the peak
of the configuration's dtype: per env step, the full-sequence forward of
every CFG row at every denoiser call, whatever part of it the engine
computes. The traced steps and their time are left out, as the profiler
slows them."""

from benchmark import yardstick

UNIT, SOURCE = "%", "host_clock"
LAYER = "model step"
MOVES = "rollout_env_steps_per_s"
KERNELS = "none: analytic FLOPs over the untraced window's wall time"


def read(ctx):
    if ctx.trace is None or ctx.unit != "env_step":
        return None
    s, t = ctx.shapes, ctx.trace
    flops = s["calls_per_step"] * yardstick.denoiser_call_flops(ctx.cfg, s["rows_per_call"])
    rate = flops * (ctx.work["steps"] - t.traced_steps) / (ctx.work["window_s"] - t.traced_s)
    return 100.0 * rate / yardstick.peak_flops(ctx.cfg["compute_dtype"])
