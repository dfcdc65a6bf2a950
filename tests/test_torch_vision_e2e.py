"""The port's three data and vision CLIs end to end on the CPU at a tiny size
(`beso_tpu_torch/scripts/generate_demos.py`, `demo_census.py`,
`validate_vision_e2e.py`, each with `--device cpu`).

`generate_demos` writes files that both packages' loaders and the port's
workspaces read back; `demo_census` prints its statistics, computed as the
JAX script's functions compute them; `validate_vision_e2e` prints its JSON
line with finite values for both envs, with `--pretrain-steps` and with
`--probe-only`. Without `--device` each CLI asks for the card.
"""

from __future__ import annotations

import functools
import json
import math

import numpy as np
import pytest
import torch

import beso_tpu_torch.scripts.validate_vision_e2e as vcli
from beso_tpu.data import trajectories as jtraj
from beso_tpu_torch.data import trajectories as ttraj
from beso_tpu_torch.scripts import demo_census, generate_demos
from beso_tpu_torch.workspaces import BlockPushWorkspace, FrankaKitchenWorkspace

torch.set_num_threads(1)


@pytest.mark.parametrize("env", ["block_push", "kitchen"])
def test_generate_demos_writes_files_the_loaders_read(env, tmp_path, capsys):
    """8 oracle episodes x 40 steps written in the dataset layout, read back
    by the port's loader and workspace and by the JAX package's loader; the
    labels and lengths survive; `--census` prints the census."""
    out = generate_demos.main(["--env", env, "--out", str(tmp_path), "--episodes", "8",
                               "--steps", "40", "--seed", "3", "--play-style", "--census",
                               "--device", "cpu"])
    assert "census:" in capsys.readouterr().out
    if env == "block_push":
        data = ttraj.load_multimodal_push(out, onehot_goals=True, reduce_obs_dim=False)
        jdata = jtraj.load_multimodal_push(out, onehot_goals=True, reduce_obs_dim=False)
        ws = BlockPushWorkspace(data_path=str(out), reduce_obs_dim=False, device="cpu",
                                window_size=5)
        shape = (8, 40, 16)
    else:
        data = ttraj.load_relay_kitchen(out, onehot_goals=True)
        jdata = jtraj.load_relay_kitchen(out, onehot_goals=True)
        ws = FrankaKitchenWorkspace(data_path=str(out), device="cpu")
        shape = (8, 40, 30)
    assert data.observations.shape == shape
    for name in ("observations", "actions", "lengths", "onehot_goals"):
        np.testing.assert_array_equal(getattr(data, name), np.asarray(getattr(jdata, name)))
    assert np.isfinite(data.observations).all() and (data.lengths > 0).all()
    assert ws.full_data.num_trajectories == 8
    batch = ws.train_set.sample_batch(torch.Generator().manual_seed(0), 4)
    assert torch.isfinite(batch["observation"]).all()


def test_demo_census_prints_the_jax_scripts_statistics(capsys):
    """4 clean and 4 play-style kitchen episodes: both JSON rows printed, and
    the census, its statistics and the branching factors equal the JAX
    script's functions on the same labels."""
    import scripts.demo_census as jcensus
    from beso_tpu_torch.envs.kitchen.oracle import generate_kitchen_demonstrations

    out = demo_census.main(["--episodes", "4", "--seed", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("clean {") and lines[1].startswith("play_style {")
    assert json.loads(lines[-1]) == out
    assert set(out["clean"]) == {"distinct_sequences", "entropy_bits", "top1_share",
                                 "branching_depth_1_2_3", "steps_to_first_completion",
                                 "ee_path_length_m"}
    data = generate_kitchen_demonstrations(4, 280, generator=torch.Generator().manual_seed(6))
    census = demo_census.completion_census(data.onehot_goals)
    assert census == jcensus.completion_census(data.onehot_goals)
    assert demo_census.census_stats(census) == jcensus.census_stats(census)
    assert demo_census.branching_factors(census) == jcensus.branching_factors(census)
    assert out["clean"] == {**demo_census.census_stats(census),
                            "branching_depth_1_2_3": demo_census.branching_factors(census),
                            **demo_census.execution_stats(data, torch.device("cpu"))}
    jstats = jcensus.execution_stats(data)
    assert demo_census.execution_stats(data, torch.device("cpu")) == jstats


@pytest.fixture
def tiny_vision(monkeypatch):
    """Episodes of 30 steps, evaluations of 4 and one pretraining step per
    call, so that the CLI runs at a CPU test's size."""
    monkeypatch.setattr(vcli, "DEMO_STEPS", {"block_push": 30, "kitchen": 30})
    monkeypatch.setattr(vcli, "EVAL_STEPS", {"block_push": 4, "kitchen": 4})
    monkeypatch.setattr(vcli, "pretrain_state_regression", functools.partial(
        vcli.pretrain_state_regression, steps_per_call=1))
    return ["--device", "cpu", "--episodes", "8", "--train-steps", "1", "--batch-size", "4",
            "--eval-n-times", "4", "--img", "32"]


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [
    ["--pretrain-steps", "2"], ["--env", "kitchen"],
    ["--semantic", "--goal-stack", "--embed-size", "16", "--freeze-encoder"]],
    ids=["block_push_pretrain", "kitchen", "block_push_semantic_goal_stack_frozen"])
def test_validate_vision_e2e_prints_finite_json(extra, tiny_vision, capsys, monkeypatch):
    """Both envs; block push with encoder pretraining, and with the mask
    channels, the stacked goal image, a 16-wide embedding and the encoder
    frozen (its weights unchanged by training)."""
    real_train, frozen = vcli.Trainer.train, {}

    def train(self, ts, *a, **kw):
        before = {k: v.clone() for k, v in ts.model.encoder.state_dict().items()}
        ts = real_train(self, ts, *a, **kw)
        frozen["same"] = all(torch.equal(before[k], v)
                             for k, v in ts.model.encoder.state_dict().items())
        return ts

    monkeypatch.setattr(vcli.Trainer, "train", train)
    out = vcli.main(tiny_vision + extra)
    assert frozen["same"] == ("--freeze-encoder" in extra)
    if "--freeze-encoder" in extra:
        assert out["freeze_encoder"] and out["semantic"] and out["embed_size"] == 16
    line = _json_line(capsys)
    assert line == out
    assert set(out) >= {"env", "semantic", "goal_stack", "pretrain_steps", "freeze_encoder",
                        "embed_size", "vision_result", "vision_reward",
                        "train_steps_per_sec", "params"}
    for key in ("vision_result", "vision_reward", "train_steps_per_sec"):
        assert math.isfinite(out[key])
    assert out["params"] > 10 ** 6
    if "--pretrain-steps" in extra:
        assert math.isfinite(out["pretrain_rmse_mean"])


def test_validate_vision_e2e_probe_only(tiny_vision, capsys):
    """--probe-only prints the probe's per-dim RMSE; it needs
    --pretrain-steps, and pretraining refuses --goal-stack (6 channels)."""
    out = vcli.main(tiny_vision + ["--env", "kitchen", "--probe-only", "--pretrain-steps", "2"])
    assert _json_line(capsys) == out and out["probe_only"]
    assert len(out["rmse_per_dim"]) == 30 and np.isfinite(out["rmse_per_dim"]).all()
    with pytest.raises(SystemExit):
        vcli.main(tiny_vision + ["--probe-only"])
    with pytest.raises(SystemExit):
        vcli.main(tiny_vision + ["--goal-stack", "--pretrain-steps", "2"])


def test_clis_default_to_the_card(tmp_path):
    """Without `--device` each CLI runs on the card; on a host without one
    it raises instead of falling back to the CPU."""
    import inspect

    from beso_tpu_torch.models import pretrain

    assert "device" in inspect.signature(pretrain.pretrain_state_regression).parameters
    if torch.cuda.is_available():
        return
    for main, argv in ((generate_demos.main, ["--env", "kitchen", "--out", str(tmp_path),
                                              "--episodes", "2", "--steps", "2"]),
                       (demo_census.main, ["--episodes", "2"]),
                       (vcli.main, ["--episodes", "2"])):
        with pytest.raises((RuntimeError, AssertionError)):
            main(argv)
