"""Finding configurations, traffic mixes, metrics and cells by name, and a
cell added as new files and new BENCHMARK.json entries only."""

import json
import shutil

import pytest

from benchmark import spec as spec_mod
from benchmark.drivers.rollout import RolloutDriver
from benchmark.tests import tiny

SPEC = spec_mod.load()


def test_every_entry_finds_its_files():
    names = {c["name"] for c in SPEC.bench["configs"]}
    for w in SPEC.bench["workloads"]:
        assert w["config"] in names
        traffic = SPEC.traffic(w["traffic"])
        assert SPEC.driver(traffic["kind"]) is RolloutDriver
        assert SPEC.limits(w["name"])
        reported = [m["name"] for m in SPEC.end_to_end(w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert SPEC.per_layer(w["name"])
    e2e = {m["name"]: m for m in SPEC.bench["end_to_end"]}
    for m in SPEC.bench["end_to_end"] + SPEC.bench["per_layer"]:
        r = SPEC.reader(m["name"])
        assert (r.UNIT, r.SOURCE) == (m["unit"], m["source"])
        if "layer" in m:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])
            # every per-layer entry names its cells, each of which reports
            # the end-to-end metric it moves
            for w in m["workloads"]:
                assert w in e2e[m["moves"]].get("workloads", [w])


def test_the_configuration_files_are_as_shipped():
    yaml = pytest.importorskip("yaml")
    for c in SPEC.bench["configs"]:
        cfg = SPEC.config(c["name"])
        shipped = yaml.safe_load(open(SPEC.root / cfg["shipped_as"]))
        for k, v in shipped.items():
            if k in cfg:
                assert cfg[k] == v, (c["name"], k)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        SPEC.workload("no.such.cell")
    with pytest.raises(KeyError):
        SPEC.config("no_such_config")


NEW_METRIC = '''"""Episodes completed in the window (a test's metric)."""
UNIT, SOURCE = "episodes", "program_counter"
LAYER = "rollout loop and policy glue"
MOVES = "rollout_env_steps_per_s"
KERNELS = "none"


def read(ctx):
    return float(ctx.work["episodes"]) if "episodes" in ctx.work else None
'''


def test_a_cell_added_as_files_only(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell that
    exist only as new files and entries in a copy of the benchmark run, and
    the new metric is reported."""
    root = tmp_path / "checkout"
    shutil.copytree(SPEC.dir, root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((SPEC.root / "BENCHMARK.json").read_text())
    cfg = {**SPEC.config("kitchen_state"), "name": "kitchen_small", "cond_lambda": 2.0}
    (root / "benchmark/configs/kitchen_small.json").write_text(json.dumps(cfg))
    traffic = {**SPEC.traffic("rollout_kitchen"), "episode_steps": 10}
    (root / "benchmark/traffic/rollout_short.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/episodes_per_window.py").write_text(NEW_METRIC)
    limits = json.loads((SPEC.dir / "cells/kitchen.rollout.json").read_text())
    (root / "benchmark/cells/small.rollout.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": "kitchen_small", "source": "https://example.org",
                             "file": "benchmark/configs/kitchen_small.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "small.rollout", "config": "kitchen_small",
                               "traffic": "rollout_short", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "rollout_env_steps_per_s":
            m["workloads"].append("small.rollout")
    bench["per_layer"].append({"name": "episodes_per_window", "unit": "episodes",
                               "better": "higher", "source": "program_counter",
                               "layer": "rollout loop and policy glue",
                               "moves": "rollout_env_steps_per_s",
                               "workloads": ["small.rollout"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = spec_mod.load(root)
    assert spec.config("kitchen_small")["cond_lambda"] == 2.0
    out = tiny.run("small.rollout", trace=True, spec=spec)
    assert out["correct"], out["checks"]
    assert out["metrics"]["episodes_per_window"]["value"] >= 1.0
    out = tiny.run("small.rollout", trace=False, spec=spec)
    assert set(out["metrics"]) == {"rollout_env_steps_per_s", "setup_s"}
