"""Metrics logging and profiling hooks (torch port of
`beso_tpu/utils/metrics.py`).

A JSONL writer that always works offline, mirrored to wandb where it is
installed and enabled; wall-clock phase timing; named spans at the
program's layer boundaries, recorded while a torch profiler runs; and a
torch.profiler trace of the CPU and the CUDA device, exported as a Chrome
trace, where the JAX package captures a jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler


class _NullSpan:
    """The span while no profiler records: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()
_OPEN: list = []   # recorded spans whose blocks are still running, innermost last


class _Span:
    """A profiler range that ends with its block, or earlier with the
    profiler that recorded it (`_end_open_spans`)."""

    __slots__ = ("_range",)

    def __init__(self, rng):
        self._range = rng

    def __enter__(self):
        self._range.__enter__()
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            _OPEN.remove(self)
            rng, self._range = self._range, None
            rng.__exit__(*exc)
        return False


def _end_open_spans() -> None:
    """End the ranges still open when a profiler stops. That profiler has
    taken its records and ended them at its stop; ended later, inside the
    next profiler's session, a range would write into the records of the
    first one, which are freed by then. Here no profiler records, so ending
    them records nothing."""
    while _OPEN:
        s = _OPEN.pop()
        rng, s._range = s._range, None
        rng.__exit__(None, None, None)


def _end_spans_at_profiler_stop() -> None:
    """torch offers no hook at a profiler's stop: wrap the function that
    every profiler calls there (once, where torch has it), the first time a
    span is recorded."""
    stop = getattr(_autograd_profiler, "_run_on_profiler_stop", None)
    if stop is None or getattr(stop, "ends_open_spans", False):
        return

    def run_on_profiler_stop():
        stop()
        _end_open_spans()

    run_on_profiler_stop.ends_open_spans = True
    _autograd_profiler._run_on_profiler_stop = run_on_profiler_stop


def span(name: str, args: Optional[dict] = None):
    """A named range of host time in the profiler's trace, for `with`.

    While a torch profiler records, a profiler range on the host's timeline,
    nested by time among the aten operations and on the clock of the device
    trace, with `args` (a dict of numbers or strings) as its keyword values;
    otherwise the shared `NULL_SPAN`, at the cost of one flag check. A
    range still open when its profiler stops ends there.

    The range is a plain function-scope record (`_RecordFunctionFast`), not
    a `torch.profiler.record_function`: a user-scope range also puts a copy
    of itself on the device's timeline, covering the kernels it launched and
    the idle between them, where a trace reader would take it for device
    work."""
    if not _autograd_profiler._is_profiler_enabled:
        return NULL_SPAN
    _end_spans_at_profiler_stop()
    if args is None:
        return _Span(torch._C._profiler._RecordFunctionFast(name))
    return _Span(torch._C._profiler._RecordFunctionFast(name, [], args))


class MetricsWriter:
    """Append-only `metrics.jsonl` in `log_dir` (none without one): one
    record per `log` call, with the wall time and the step; with
    `use_wandb`, each record also goes to `wandb.log`, where wandb imports
    (else the JSONL file alone is written)."""

    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self._file = None
        if log_dir is not None:
            p = Path(log_dir)
            p.mkdir(parents=True, exist_ok=True)
            self._file = open(p / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"_time": time.time(), **metrics}
        if step is not None:
            rec["_step"] = step
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()

    close = finish


def make_metrics_writer(log_dir=None, use_wandb=False, **kw) -> MetricsWriter:
    """A writer whose wandb run is `wandb.init(**kw)` (e.g. `project=`)."""
    return MetricsWriter(log_dir, use_wandb, kw or None)


@contextlib.contextmanager
def step_timer(writer: Optional[MetricsWriter], name: str, step=None):
    """Wall-clock time of the block, logged as `time/<name>_s`. It does not
    synchronize a device: a block that queues CUDA work should end with
    `torch.cuda.synchronize()` to be timed whole. Under a profiler the
    block is also the span `name`."""
    t0 = time.perf_counter()
    with span(name):
        yield
    dt = time.perf_counter() - t0
    if writer is not None:
        writer.log({f"time/{name}_s": dt}, step=step)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU activity, and CUDA where a
    card is present), written to `log_dir/trace.json` in the Chrome trace
    format (chrome://tracing, Perfetto); nothing without a `log_dir`."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))
