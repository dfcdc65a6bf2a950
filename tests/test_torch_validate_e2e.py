"""`beso_tpu_torch/scripts/validate_e2e.py` against `scripts/validate_e2e.py`
on the CPU, both envs, at a tiny size with every flag: the summary's keys
(nested) equal the JAX script's, and both scripts run the same evaluations
in the same order (the policy overrides of every `test_agent` call, the
perturbed physics of the robustness protocol field for field). The port
runs for real (oracle demos, training, every evaluation, on the model's
full width: the script fixes it); on the JAX side, whose evaluations each
compile a rollout, the training is skipped and every evaluation after the
first returns the first's result, since only its structure is compared.
Numbers differ by RNG and are held finite."""

import copy
import math

import numpy as np
import pytest
import torch

import beso_tpu_torch.scripts.validate_e2e as tcli

TINY = ["--episodes", "4", "--train-steps", "2", "--batch-size", "4", "--eval-n-times", "2",
        "--eval-n-steps", "2", "--seed", "3"]
FLAGS = {"kitchen": ["--robustness", "--lambda-sweep", "--play-style", "--kettle-boost", "0.5",
                     "--eval-nfe-sweep", "--eval-kde-sweep", "--eval-best-configs"],
         "block_push": ["--demo-steps", "40", "--robustness", "--lambda-sweep", "--play-style",
                        "--eval-nfe-sweep", "--eval-kde-sweep", "--eval-best-configs"]}
PHYSICS = ("drive_eff", "interact_radius", "grasp_radius", "release_radius", "kettle_gain",
           "kettle_max_speed")


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def _values(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _values(v)
    else:
        yield tree


def _overrides(kw):
    """An evaluation's policy overrides and physics, comparable across packages."""
    out = {k: v for k, v in kw.items() if k not in ("key", "generator", "log_metrics",
                                                    "physics_params")}
    if kw.get("physics_params") is not None:
        p = kw["physics_params"]
        out["physics"] = [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).tolist()
                          for v in (getattr(p, f) for f in PHYSICS)]
    return out


@pytest.mark.parametrize("env", ["kitchen", "block_push"])
def test_validate_e2e_matches_jax(env, monkeypatch):
    import scripts.validate_e2e as jcli
    from beso_tpu.agents.beso_agent import BesoAgent as JAgent
    from beso_tpu.workspaces import BlockPushWorkspace as JBlock
    from beso_tpu.workspaces import FrankaKitchenWorkspace as JKitchen
    from beso_tpu_torch.workspaces import BlockPushWorkspace, FrankaKitchenWorkspace

    argv = ["--env", env, *TINY, *FLAGS[env]]
    port_calls, jax_calls = [], []
    ws_cls = FrankaKitchenWorkspace if env == "kitchen" else BlockPushWorkspace
    real = ws_cls.test_agent

    def recording(self, agent, **kw):
        port_calls.append(_overrides(kw))
        return real(self, agent, **kw)

    monkeypatch.setattr(ws_cls, "test_agent", recording)
    summary = tcli.main([*argv, "--device", "cpu"])

    jws_cls = JKitchen if env == "kitchen" else JBlock
    jreal, first = jws_cls.test_agent, []

    def jax_recording(self, agent, **kw):
        jax_calls.append(_overrides(kw))
        if not first:
            first.append(jreal(self, agent, **kw))
        return copy.deepcopy(first[0])

    monkeypatch.setattr(jws_cls, "test_agent", jax_recording)
    monkeypatch.setattr(JAgent, "train_agent", lambda self, *a, **kw: None)
    jsummary = jcli.main(argv)

    assert _keys(summary) == _keys(jsummary)
    assert port_calls == jax_calls
    assert len(port_calls) == (2 + 3 + 4 + 4 + 5 + (4 if env == "kitchen" else 0))
    assert all(math.isfinite(v) for v in _values(summary))
