"""Every mode of the port's evaluation CLI (`beso_tpu_torch.scripts.
evaluate`) on both shipped evaluation configs, on the CPU at 2 runs x 2
steps, on a run the training CLI trained 2 steps at a tiny width: the
single variant, the sampler study (the 8 samplers), the sampler x step-
count grid (8 samplers x 7 step counts), the CFG study and the noisy-
sampler study. Each returns finite metrics with the JAX CLI's labels and
keys; the studies write their arrays and plots to `store_path`."""

import math

import numpy as np
import pytest
import torch

from beso_tpu.workspaces.base import (NOISY_STUDY_SAMPLERS, STUDY_SAMPLERS,
                                      STUDY_STEP_COUNTS)
from beso_tpu_torch.scripts import evaluate, training

CONFIGS = {"kitchen": ("configs/franka_kitchen.yaml", "configs/evaluate_kitchen.yaml"),
           "block_push": ("configs/block_push.yaml", "configs/evaluate_blocks.yaml")}
TINY = ["num_hidden_layers=1", "hidden_dim=48", "n_heads=4", "max_train_steps=2",
        "eval_every_n_steps=2", "train_batch_size=8", "eval_n_times=2", "eval_n_steps=2"]
torch.set_num_threads(1)
MODES = {"test_single_variant": None,
         "test_all_samplers": list(STUDY_SAMPLERS),
         "compare_samplers_over_diffent_steps": list(STUDY_SAMPLERS),
         "compare_classifier_free_guidance": [f"lambda={v}" for v in (0.0, 1.0, 1.5, 2.0, 2.5)],
         "compare_noisy_sampler": list(NOISY_STUDY_SAMPLERS)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> a run directory of the training CLI."""
    out = {}
    for name, (model_path, _) in CONFIGS.items():
        run = tmp_path_factory.mktemp(name)
        training.main(["--config", model_path, "--device", "cpu", "--run-dir", str(run),
                       *TINY])
        out[name] = run
    return out


def _finite(values):
    return len(values) > 0 and all(math.isfinite(float(v)) for v in np.ravel(values))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_evaluate_cli_mode(name, mode, runs, tmp_path):
    flags = [f"{m}={'true' if m == mode else 'false'}" for m in MODES]
    out = evaluate.main(["--config", CONFIGS[name][1], "--device", "cpu",
                         f"model_store_path={runs[name]}", "num_runs=2",
                         "num_steps_per_run=2", f"store_path={tmp_path}", *flags])
    labels = MODES[mode]
    if labels is None:
        assert _finite([out[k] for k in ("avrg_reward", "std_reward", "avrg_result",
                                         "std_result")])
    elif mode == "compare_samplers_over_diffent_steps":
        assert out["samplers"] == labels and out["steps"] == list(STUDY_STEP_COUNTS)
        assert out["result"].shape == (len(labels), len(STUDY_STEP_COUNTS))
        assert _finite(out["result"]) and _finite(out["reward"])
        assert (tmp_path / "sampler_steps_grid.png").exists()
    else:
        assert out["labels"] == labels
        assert _finite(out["results"] + out["avrg_rewards"])
        assert len(list(tmp_path.glob("*_std_results.npy"))) == 1
        assert len(list(tmp_path.glob("*.png"))) == 1


def test_evaluate_cli_fused_cached_engine(runs, tmp_path, monkeypatch):
    """`inference_engine=fused_cached`: the kitchen sampler study serves its
    grid samplers on B1 and the others on B4 (on the CPU each kernel's plain
    version), with the results and labels of the default engine."""
    import beso_tpu_torch.models.fused as tfused

    calls = {"fused_layer": 0, "fused_layer_prefix": 0}

    def count(name):
        real = getattr(tfused, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(tfused, name, wrapped)

    for name in calls:
        count(name)
    base = ["--config", CONFIGS["kitchen"][1], "--device", "cpu",
            f"model_store_path={runs['kitchen']}", "num_runs=2", "num_steps_per_run=2",
            f"store_path={tmp_path}", "test_single_variant=false", "test_all_samplers=true"]
    ref = evaluate.main(base)
    assert calls == {"fused_layer": 0, "fused_layer_prefix": 0}
    out = evaluate.main([*base, "inference_engine=fused_cached"])
    assert calls["fused_layer"] > 0 and calls["fused_layer_prefix"] > 0
    assert out["labels"] == ref["labels"] == MODES["test_all_samplers"]
    np.testing.assert_allclose(out["results"], ref["results"], atol=1e-6)
    np.testing.assert_allclose(out["avrg_rewards"], ref["avrg_rewards"], atol=1e-6)
