"""A cell at a size the CPU holds: the configuration's widths cut to 48
(6 heads of 8), 2 layers; 8 envs x 12-step episodes. Used only by the CPU
tests."""

from __future__ import annotations

import time

from benchmark import spec as spec_mod
from benchmark.run import run_cell

SEED = 2 ** 31 + 12345
CONFIG = {"hidden_dim": 48, "num_hidden_layers": 2, "n_heads": 6}
TRAFFIC = {"envs": 8, "episode_steps": 12, "warmup_steps": 2, "trace_start": 5,
           "trace_steps": 3, "trace_host_steps": 2}


def run(workload: str, trace: bool = False, spec=None, seed: int = SEED) -> dict:
    spec = spec or spec_mod.load()
    return run_cell(spec, workload, seed, 0.2, trace, "cpu", time.monotonic(), CONFIG,
                    TRAFFIC)


def driver(workload: str, spec=None, seed: int = SEED):
    """The cell's driver at the tiny size, set up and run for one episode,
    its program state released."""
    spec = spec or spec_mod.load()
    cell = spec.workload(workload)
    cfg = {**spec.config(cell["config"]), **CONFIG}
    traffic = {**spec.traffic(cell["traffic"]), **TRAFFIC}
    d = spec.driver(traffic["kind"])(cfg, traffic, seed, "cpu")
    d.setup()
    d.window(0.0)
    d.release()
    return d
