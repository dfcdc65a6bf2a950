"""The port's metrics helpers (`utils/metrics.py`) against `beso_tpu`'s,
the training CLI's wandb switch, `average_final_goal_distance` and the
module constants the port carries for parity."""

import json
import math
import sys
import time
import types

import numpy as np
import pytest
import torch

from beso_tpu_torch.utils import metrics as tm

RECORDS = [({"loss": 0.5, "mean_loss": 0.25}, 1), ({"test_loss": 1.5}, None),
           ({"eval/avrg_reward": 2.0, "epoch": 3}, 40)]


def _fake_wandb(monkeypatch):
    calls = []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls.append(("init", kw))
    fake.log = lambda metrics, step=None: calls.append(("log", dict(metrics), step))
    fake.finish = lambda: calls.append(("finish",))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return calls


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_jsonl_matches_jax_records(tmp_path):
    from beso_tpu.utils import metrics as jm

    for mod, d in ((jm, tmp_path / "jax"), (tm, tmp_path / "torch")):
        w = mod.make_metrics_writer(log_dir=str(d))
        for rec, step in RECORDS:
            w.log(rec, step=step)
        w.finish()
    jrows, trows = _rows(tmp_path / "jax" / "metrics.jsonl"), _rows(
        tmp_path / "torch" / "metrics.jsonl")
    assert all(isinstance(r.pop("_time"), float) for r in jrows + trows)
    assert trows == jrows
    assert [r.get("_step") for r in trows] == [1, None, 40]


def test_wandb_mirror(tmp_path, monkeypatch):
    calls = _fake_wandb(monkeypatch)
    w = tm.make_metrics_writer(log_dir=str(tmp_path), use_wandb=True, project="beso")
    for rec, step in RECORDS:
        w.log(rec, step=step)
    w.close()
    assert calls == [("init", {"project": "beso"}),
                     *(("log", rec, step) for rec, step in RECORDS), ("finish",)]
    assert len(_rows(tmp_path / "metrics.jsonl")) == len(RECORDS)


def test_wandb_absent_writes_jsonl_only(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)     # import wandb raises
    w = tm.MetricsWriter(str(tmp_path), use_wandb=True, wandb_kwargs={"project": "p"})
    w.log({"loss": 1.0}, step=2)
    w.finish()
    rows = _rows(tmp_path / "metrics.jsonl")
    assert len(rows) == 1 and rows[0]["loss"] == 1.0 and rows[0]["_step"] == 2
    w = tm.MetricsWriter()                     # no log dir: nothing written
    w.log({"loss": 1.0})
    w.finish()


def test_step_timer(tmp_path):
    w = tm.MetricsWriter(str(tmp_path))
    with tm.step_timer(w, "train", step=7):
        time.sleep(0.02)
    with tm.step_timer(None, "nothing"):
        pass
    w.close()
    (row,) = _rows(tmp_path / "metrics.jsonl")
    assert row["_step"] == 7 and 0.02 <= row["time/train_s"] < 5.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tm.profile_trace(str(tmp_path / "trace")):
        (a @ a).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::mm" in names
    with tm.profile_trace(None):
        (a @ a).sum()
    assert [p.name for p in tmp_path.iterdir()] == ["trace"]


def test_training_cli_with_wandb_enabled(tmp_path, monkeypatch):
    """wandb.enabled=true builds the writer with the config's project, as
    the JAX CLI does; every JSONL record is mirrored to wandb."""
    from beso_tpu_torch.scripts import training

    calls = _fake_wandb(monkeypatch)
    res = training.main(["--config", "configs/franka_kitchen.yaml", "--device", "cpu",
                         "--run-dir", str(tmp_path), "wandb.enabled=true",
                         "num_hidden_layers=1", "hidden_dim=32", "n_heads=2",
                         "max_train_steps=2", "eval_every_n_steps=2", "train_batch_size=8",
                         "eval_n_times=2", "eval_n_steps=2"])
    assert math.isfinite(res["avrg_reward"])
    assert calls[0] == ("init", {"project": "beso_tpu_experiments"})
    assert calls[-1] == ("finish",)
    logged = [c for c in calls if c[0] == "log"]
    assert logged and len(logged) == len(_rows(tmp_path / "metrics.jsonl"))


def test_average_final_goal_distance_matches_jax():
    from beso_tpu.rollout.rollout import average_final_goal_distance as jfn
    from beso_tpu_torch.rollout.rollout import average_final_goal_distance

    d = np.random.RandomState(0).rand(37).astype(np.float32)
    assert average_final_goal_distance(d) == jfn(d)
    assert average_final_goal_distance(torch.as_tensor(d)) == jfn(d)


@pytest.mark.parametrize("module, name", [
    ("envs.kitchen.goals", "ALL_TASKS"),
    ("envs.kitchen.env", "RESET_NOISE"),
    ("envs.block_push.env", "EFFECTOR_HEIGHT"),
    ("envs.block_push.env", "MIN_TARGET_DIST"),
])
def test_constants_match_jax(module, name):
    import importlib

    got = getattr(importlib.import_module(f"beso_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"beso_tpu.{module}"), name)
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype == np.dtype("<U13")
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref and type(got) is type(ref)


def test_clean_style_matches_jax():
    """CLEAN_STYLE: one episode's style, the JAX defaults field for field;
    `sample_kitchen_style` gives B rows of it."""
    from beso_tpu.envs.kitchen.oracle import CLEAN_STYLE as jclean
    from beso_tpu_torch.envs.kitchen.oracle import CLEAN_STYLE, sample_kitchen_style

    assert CLEAN_STYLE._fields == jclean._fields
    for f, g, r in zip(CLEAN_STYLE._fields, CLEAN_STYLE, jclean):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f)
        assert g.shape == np.asarray(r).shape and g.dtype.is_floating_point == (
            np.asarray(r).dtype.kind == "f"), f
    rows = sample_kitchen_style(3)
    for f, g in zip(rows._fields, rows):
        assert torch.equal(g, getattr(CLEAN_STYLE, f).expand(3, *g.shape[1:])), f
