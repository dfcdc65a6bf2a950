"""The program's spans in the host slice of a `--trace 1` run, and the idle
time and device operations of its whole env steps put down to the layer
whose span was innermost.

The port opens a profiler range at each of its layer boundaries
(`beso_tpu_torch.utils.metrics.span`): `rollout.step` around each env step,
holding `policy.predict` (the policy glue) with an `engine.call` around
each denoiser call, and `physics.step` around the env's step. The host
slice records them among its host operations (`TraceSlice.host_ops`), on
the clock of its device operations (`TraceSlice.host_kernels`).

A step is whole when the slice holds its span from end to end. The slice
starts and stops inside a step's first denoiser call: a range the profiler
saw open at its start is not recorded, and one still open at its stop ends
where the slice ends, after every other operation. So a whole step starts
after the slice's first operation and ends before its last end.

Without a trace, or with no whole `rollout.step` in it (a program without
the spans), every function here gives None.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

STEP = "rollout.step"
# the layer of each span, where it is the innermost one open
LAYER_OF = {"rollout.step": "policy_glue", "policy.predict": "policy_glue",
            "engine.call": "engine", "physics.step": "physics"}
LAYERS = ("physics", "policy_glue", "engine")
# the runtime calls that put an operation on the device's queue
ENQUEUE = ("LaunchKernel", "Memcpy", "Memset")


class StepLayers(NamedTuple):
    steps: int            # whole steps
    step_us: float        # their total time
    idle_us: dict         # layer -> device idle while that layer's span was innermost
    launches: dict        # layer -> enqueueing runtime calls made inside it


def _whole_steps(ts) -> list:
    events = ts.host_ops + ts.host_kernels
    if not events:
        return []
    first, last = min(e[1] for e in events), max(e[2] for e in events)
    return sorted((s, e) for name, s, e in ts.host_ops
                  if name == STEP and first < s < e < last)


def _busy(kernels) -> tuple:
    """The union of the device operations' intervals as sorted starts and
    ends, with the busy time before each interval's start."""
    starts, ends = [], []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    before = [0.0]
    for s, e in zip(starts, ends):
        before.append(before[-1] + e - s)
    return starts, ends, before


def _busy_in(busy, a: float, b: float) -> float:
    """Busy time of the device between a and b."""
    starts, ends, before = busy

    def upto(t):
        i = bisect.bisect_right(starts, t)   # intervals starting at or before t
        if i == 0:
            return 0.0
        return before[i - 1] + min(ends[i - 1], t) - starts[i - 1]

    return upto(b) - upto(a)


def _innermost(spans, t: float) -> Optional[str]:
    """The layer of the shortest span open at t."""
    open_ = [(e - s, name) for name, s, e in spans if s <= t < e]
    return LAYER_OF[min(open_)[1]] if open_ else None


def step_layers(ts) -> Optional[StepLayers]:
    """Idle time and enqueueing calls of the whole steps, by layer."""
    if ts is None:
        return None
    steps = _whole_steps(ts)
    if not steps:
        return None
    spans = sorted(((n, s, e) for n, s, e in ts.host_ops if n in LAYER_OF), key=lambda x: x[1])
    span_starts = [s for _, s, _ in spans]
    calls = sorted(s for n, s, e in ts.host_ops if any(k in n for k in ENQUEUE))
    busy = _busy(ts.host_kernels)
    idle = dict.fromkeys(LAYERS, 0.0)
    launches = dict.fromkeys(LAYERS, 0)
    for s0, e0 in steps:
        inside = [x for x in spans[bisect.bisect_left(span_starts, s0):
                                   bisect.bisect_right(span_starts, e0)] if x[2] <= e0]
        cuts = sorted({t for _, s, e in inside for t in (s, e)})
        for a, b in zip(cuts, cuts[1:]):
            layer = _innermost(inside, (a + b) / 2)
            idle[layer] += (b - a) - _busy_in(busy, a, b)
        for t in calls[bisect.bisect_left(calls, s0):bisect.bisect_left(calls, e0)]:
            launches[_innermost(inside, t)] += 1
    return StepLayers(len(steps), sum(e - s for s, e in steps), idle, launches)


def read_for(ctx) -> Optional[StepLayers]:
    """`step_layers` of a rollout cell's trace; None elsewhere."""
    if ctx.trace is None or ctx.unit != "env_step":
        return None
    return step_layers(ctx.trace)


def idle_share(ctx, layer: str) -> Optional[float]:
    """The device's idle time while `layer`'s span was innermost, as a share
    (%) of the whole steps' time."""
    sl = read_for(ctx)
    return None if sl is None else 100.0 * sl.idle_us[layer] / sl.step_us


def launches_per_step(ctx, layer: str) -> Optional[float]:
    """The device operations `layer` enqueued per whole step."""
    sl = read_for(ctx)
    return None if sl is None else sl.launches[layer] / sl.steps
