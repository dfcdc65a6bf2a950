"""Metrics logging: an append-only JSONL file (torch port of the writer in
`beso_tpu/utils/metrics.py`; its optional wandb mirror and jax.profiler
hook are not carried over: the shipped configs keep wandb off).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsWriter:
    """Append-only `metrics.jsonl` in `log_dir`: one record per `log` call,
    with the wall time and the step."""

    def __init__(self, log_dir):
        p = Path(log_dir)
        p.mkdir(parents=True, exist_ok=True)
        self._file = open(p / "metrics.jsonl", "a")

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"_time": time.time(), **metrics}
        if step is not None:
            rec["_step"] = step
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
