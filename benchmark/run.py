"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. In order: build or load the port's kernels
(at first use, into the checkout's `build/kernels/`), make the data and the
weights from the seed, warm up the cell's own shapes (all of it `setup_s`),
run the cell's traffic for `--seconds` (whole episodes),
read the device's memory peak, free the program's state, judge what the
timed path produced against the plain reference, and print one JSON line:
the end-to-end metrics with `--trace 0`, the per-layer metrics of a traced
slices of the window with `--trace 1`, the numbers compared beside their
limits under "checks", last. It exits with 2, and prints no result,
without the CUDA cards the cell asks for, and with 3 if `jax`, `jaxlib`,
`flax` or `beso_tpu` was loaded.
"""

from __future__ import annotations

import time

_T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "beso_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (`beso_tpu_torch` is not `beso_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, config_overrides=None, traffic_overrides=None) -> dict:
    """One run of a cell on `device`: the result line's object."""
    import torch

    from benchmark.trace import Tracer, breakdown

    cell = spec.workload(workload)
    cfg = {**spec.config(cell["config"]), **(config_overrides or {})}
    traffic = {**spec.traffic(cell["traffic"]), **(traffic_overrides or {})}
    limits = spec.limits(workload)
    device = torch.device(device)
    driver = spec.driver(traffic["kind"])(cfg, traffic, seed, device)
    t_driver = time.monotonic()
    driver.setup()
    setup_s = time.monotonic() - t_start
    parts = {"before_setup": t_driver - t_start, **driver.setup_parts}
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in parts.items()), file=sys.stderr)
    tracer = (Tracer(device, traffic["trace_start"], traffic["trace_steps"],
                     traffic["trace_host_steps"]) if trace else None)
    work = driver.window(seconds, tracer)
    print("episodes_s " + " ".join(f"{t:.3f}" for t in work["episode_s"]), file=sys.stderr)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        kind, count = torch.cuda.get_device_name(device), 1
    else:
        peak, kind, count = 0, "cpu", 1
    driver.release()
    numbers = driver.judge()
    values = {k: numbers.get(k, float("inf")) for k in limits}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in values.items())
    # a number that is not finite is printed as a string, which JSON allows
    checks = {k: {"value": v if math.isfinite(v) else repr(v), "limit": limits[k]}
              for k, v in values.items()}

    ctx = types.SimpleNamespace(cfg=cfg, traffic=traffic, shapes=driver.shapes(),
                                unit=driver.unit, work=work, setup_s=setup_s,
                                trace=tracer.slice if tracer else None)
    entries = spec.per_layer(workload) if trace else spec.end_to_end(workload)
    metrics = {}
    for m in entries:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": count, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(work["attempted"]),
           "failed": int(work["failed"]), "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        t = ctx.trace
        print(f"trace s_per_step device_only {t.window_s / t.steps:.5f} with_host "
              f"{t.host_window_s / (t.traced_steps - t.steps):.5f}", file=sys.stderr)
        dev["busy_s"], dev["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
        out["breakdown"] = breakdown(ctx.trace)
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import inputs, spec as spec_mod

    seed = inputs.expect_seed(args.seed)
    spec = spec_mod.load()
    chips = spec.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.workload, seed, args.seconds, bool(args.trace), "cuda",
                   _T_START)
    leaked = forbidden_modules()
    if leaked:
        print(f"benchmark: forbidden modules loaded: {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        ok = isinstance(c["value"], float) and c["value"] <= c["limit"]
        verdict = "ok" if ok else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
