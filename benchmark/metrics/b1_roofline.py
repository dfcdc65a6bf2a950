"""Kernel B1 (`ops/fused_layer.py::fused_layer_prefix`, the fused layer over
the suffix tokens against the cached prefix): the `layer_work` bound of
each launch at the cell's shape over the launches' device time."""

from benchmark import yardstick

UNIT, SOURCE = "%", "device_trace"
LAYER = "kernels: fused layer"
MOVES = "rollout_env_steps_per_s"
KERNELS = ("fused_layer_f32_kernel", "fused_layer_prefix_kernel")


def read(ctx):
    if ctx.trace is None or ctx.unit != "env_step" or not ctx.shapes.get("cached"):
        return None
    times = [e - s for name, s, e in ctx.trace.kernels if any(k in name for k in KERNELS)]
    if not times:
        return None
    s, dt = ctx.shapes, ctx.cfg["compute_dtype"]
    flops, nbytes = yardstick.layer_work(s["rows_per_call"], s["suffix_tokens"],
                                         ctx.cfg["hidden_dim"], s["prefix_tokens"],
                                         elem=yardstick.ELEM_BYTES[dt])
    bound_ms, _ = yardstick.bound(flops, nbytes, yardstick.peak_flops(dt))
    return 100.0 * bound_ms * len(times) / (sum(times) / 1e3)
