"""Metrics logging and profiling hooks (torch port of
`beso_tpu/utils/metrics.py`).

A JSONL writer that always works offline, mirrored to wandb where it is
installed and enabled; wall-clock phase timing; and a torch.profiler trace
of the CPU and the CUDA device, exported as a Chrome trace, where the JAX
package captures a jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Optional


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
    `torch.cuda.synchronize()` to be timed whole."""
    t0 = time.perf_counter()
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
    import torch
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
