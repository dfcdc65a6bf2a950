"""The traced slices of a `--trace 1` run: torch.profiler over a fixed
number of steps inside the window, with the host clock between two syncs
around each slice.

Two slices follow each other. The first records the device's kernels
alone (CUDA activity), so that recording the host's operations does not
slow a host-bound step: the per-layer metrics and the device's busy time
(the union of the kernel intervals) are read from it. The second records
the host's operations too (CPU and CUDA activity, as
`beso_tpu_torch.utils.metrics.profile_trace` does), and only labels the
breakdown's idle gaps with the host operation that was running when each
began. The breakdown's device operations are the first slice's.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from benchmark import yardstick

_NAME_CHARS = 120


class TraceSlice(NamedTuple):
    kernels: list        # (name, start us, end us) of every device kernel
    window_s: float      # host clock between the syncs around the slice
    busy_s: float        # union of the kernel intervals
    steps: int           # steps of the driver's unit inside the slice
    host_kernels: list   # the second slice's kernels
    host_ops: list       # (name, start us, end us) of the second slice's host operations
    host_window_s: float  # host clock around the second slice
    traced_steps: int    # steps inside both slices
    traced_s: float      # host clock from the first slice's start to the second's end


def _events(prof):
    kernels, host = [], []
    for ev in prof.events():
        rec = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        (kernels if ev.device_type == torch.autograd.DeviceType.CUDA else host).append(rec)
    return kernels, host


class Tracer:
    """Profiles steps [start, start + steps) with the device's activity
    alone, then [start + steps, start + steps + host_steps) with the host's
    too; the driver calls `tick(step)` where each of its steps begins."""

    def __init__(self, device, start: int, steps: int, host_steps: int):
        self.device, self.start = torch.device(device), start
        self.steps, self.host_steps = steps, host_steps
        self._prof, self._t_begin, self._t0 = None, 0.0, 0.0
        self._first = None
        self.slice: Optional[TraceSlice] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _begin(self, host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
            [ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts)
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()

    def _end(self):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        kernels, host = _events(self._prof)
        self._prof = None
        return kernels, host, window_s

    def tick(self, step: int) -> None:
        if self.slice is not None:
            return
        if step == self.start and self._prof is None:
            self._t_begin = time.perf_counter()
            self._begin(host=False)
        elif step == self.start + self.steps and self._first is None:
            kernels, _, window_s = self._end()
            self._first = (kernels, window_s)
            self._begin(host=True)
        elif step == self.start + self.steps + self.host_steps and self._first is not None:
            host_kernels, host, host_window_s = self._end()
            kernels, window_s = self._first
            self.slice = TraceSlice(kernels, window_s, yardstick.busy_us(kernels) / 1e6,
                                    self.steps, host_kernels, host, host_window_s,
                                    self.steps + self.host_steps,
                                    time.perf_counter() - self._t_begin)


def _short(name: str) -> str:
    return name if len(name) <= _NAME_CHARS else name[:_NAME_CHARS - 3] + "..."


def breakdown(ts: TraceSlice, n: int = 10) -> dict:
    """{"device_ops": [[kernel, seconds]], "idle_gaps": [[host op, seconds]]},
    the n largest of each: the first slice's kernels, the second slice's
    gaps."""
    by_kernel: dict = {}
    for name, start, end in ts.kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + (end - start) / 1e6
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n]
    host = sorted(ts.host_ops, key=lambda h: h[1])
    by_host: dict = {}
    j, open_ops = 0, []
    for g0, g1 in yardstick.idle_gaps(ts.host_kernels):
        while j < len(host) and host[j][1] <= g0:
            open_ops.append(host[j])
            j += 1
        open_ops = [h for h in open_ops if h[2] >= g0]
        # the innermost host operation running when the device fell idle
        label = (min(open_ops, key=lambda h: h[2] - h[1])[0] if open_ops
                 else "host between operations")
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0) / 1e6
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[_short(k), v] for k, v in ops],
            "idle_gaps": [[_short(k), v] for k, v in gaps]}
