"""The result line: its keys, the metrics each cell reports, the numbers
compared beside their limits last, and no result without a card."""

import json
import math
import subprocess
import sys

import pytest

from benchmark import spec as spec_mod
from benchmark.tests import tiny

SPEC = spec_mod.load()
CELLS = [w["name"] for w in SPEC.bench["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(workload, trace):
    out = tiny.run(workload, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    entries = SPEC.per_layer(workload) if trace else SPEC.end_to_end(workload)
    names = {m["name"]: m["unit"] for m in entries}
    assert set(out["metrics"]) <= set(names)
    for name, m in out["metrics"].items():
        assert m["unit"] == names[name] and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == set(names)
    assert set(out["checks"]) == set(SPEC.limits(workload))
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(out))


def test_no_result_without_a_card():
    """Here, without CUDA, the command exits 2 and prints nothing on stdout
    (decided at run time, never while tests are collected)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "kitchen.rollout", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                        "--trace", "0"], cwd=SPEC.root, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr
