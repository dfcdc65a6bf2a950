"""The readings that a cell's limits are set from, at the cell's own size:
for each seed, the program's numbers (as a run compares them) and the
control's (the reference put in the program's place at the precision below
the configuration's: TF32 for float32). Each seed runs whole episodes at the
cell's load for `--seconds` (0: one episode), so as many steps are compared
as in a run of that length. The benchmark's own runs do not run this.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds 30]

prints one JSON line per seed, then {"lower": ..., "upper": ...}: the
largest program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

CONTROL_PRECISION = {"float32": "tf32"}


def readings(spec, workload: str, seed: int, device, config_overrides=None,
             traffic_overrides=None, seconds: float = 0.0) -> dict:
    import torch

    cell = spec.workload(workload)
    cfg = {**spec.config(cell["config"]), **(config_overrides or {})}
    traffic = {**spec.traffic(cell["traffic"]), **(traffic_overrides or {})}
    driver = spec.driver(traffic["kind"])(cfg, traffic, seed, torch.device(device))
    driver.setup()
    driver.window(seconds)
    driver.release()
    precision = CONTROL_PRECISION[cfg["compute_dtype"]]
    return {"seed": seed, "program": driver.judge(), "control": driver.judge(precision),
            "control_precision": precision}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from benchmark import spec as spec_mod

    spec = spec_mod.load()
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(spec, args.workload, seed, args.device, seconds=args.seconds)
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in r["control"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
