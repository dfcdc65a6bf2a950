"""Finding a cell's parts by name: `BENCHMARK.json` at the checkout's root
names the cells, configurations and metrics; each part is a file of its own
under `benchmark/`:

- `configs/<config>.json` (the `file` of the configuration's entry): the
  configuration as it is run;
- `traffic/<traffic>.json`: what the window drives and its parameters;
  its `kind` picks the driver (`drivers/<kind>.py`);
- `metrics/<metric>.py`: the reader of one metric, end-to-end or per-layer;
- `cells/<workload>.json`: the limits of the numbers the cell compares.

A new cell, configuration, traffic mix or metric is new files and new
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Optional


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.dir / "cells" / f"{workload}.json").read_text())["limits"]

    def driver(self, kind: str):
        """The driver class of a traffic kind (`drivers/<kind>.py`, the one
        class in it whose name ends in "Driver")."""
        mod = importlib.import_module(f"benchmark.drivers.{kind}")
        return next(v for k, v in vars(mod).items() if k.endswith("Driver")
                    and isinstance(v, type) and v.__module__ == mod.__name__)

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metric entries this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metric entries that list this cell; every entry
        names its cells."""
        return [m for m in self.bench["per_layer"] if workload in m["workloads"]]


def load(root: Optional[Path] = None) -> Spec:
    return Spec(root if root is not None else Path(__file__).resolve().parents[1])
