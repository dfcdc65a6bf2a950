"""The evaluation slice of `beso_tpu_torch` against `beso_tpu` (CPU, f32): the
slicer's tail and sequence-end goals, `Trainer.restore`, the agent's
`reset` / `predict` (JAX's action noise injected) and `visualize_ode` (JAX's
start noise injected), the study sweep of `workspaces/base.py` with a stub
`test_agent`, the agent and policy configs the evaluation CLI builds from
the shipped evaluation configs, and the training and evaluation CLIs end to
end at a tiny size. Tolerance atol = rtol = 1e-5, as `test_torch_policy.py`."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, make_models, t

import beso_tpu_torch.agents.beso_agent as tagent_mod
import beso_tpu_torch.agents.policy as tpolicy
from beso_tpu.data.slicer import SlicedDataset as JSlicedDataset
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu_torch.data.slicer import SlicedDataset
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.scripts import evaluate, training

EVAL_CONFIGS = {"kitchen": ("configs/franka_kitchen.yaml", "configs/evaluate_kitchen.yaml"),
                "block_push": ("configs/block_push.yaml", "configs/evaluate_blocks.yaml")}
TINY = ["num_hidden_layers=1", "hidden_dim=48", "n_heads=4", "max_train_steps=2",
        "eval_every_n_steps=2", "train_batch_size=8", "eval_n_times=2", "eval_n_steps=2"]


# ---- the slicer's goal modes ---------------------------------------------------

@pytest.mark.parametrize("mode", ["only_sample_tail", "only_sample_seq_end"])
@pytest.mark.parametrize("min_future_sep", [0, 3])
def test_slicer_tail_and_seq_end_goals_match_jax(mode, min_future_sep):
    """The deterministic goal modes: every batch, goals included, equal to
    JAX's for the same windows."""
    data = synthetic_kitchen_data(n_traj=6, t_max=30, seed=5)
    kw = dict(window=6, future_seq_len=2, min_future_sep=min_future_sep, **{mode: True})
    jds = JSlicedDataset(data, future_conditional=True, **kw)
    tds = SlicedDataset(data, **kw, device="cpu")
    idx = np.arange(len(tds))
    jb = jds.batch_at(idx, jax.random.PRNGKey(0))
    tb = tds.batch_at(idx)
    assert sorted(tb) == sorted(jb)
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert tb["goal_observation"].any()


def test_slicer_without_goals_matches_jax():
    data = synthetic_kitchen_data(n_traj=4, t_max=25, seed=6)
    jb = JSlicedDataset(data, window=5, future_conditional=False).batch_at(
        np.arange(10), jax.random.PRNGKey(0))
    tds = SlicedDataset(data, window=5, future_conditional=False, device="cpu")
    tb = tds.batch_at(np.arange(10))
    assert sorted(tb) == sorted(jb) == ["action", "observation"]
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    with pytest.raises(ValueError, match="future_seq_len"):
        SlicedDataset(data, window=5, device="cpu")


# ---- Trainer.restore ---------------------------------------------------------------

def _tiny_agent(seed, tmp_path=None):
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

    ws = FrankaKitchenWorkspace(seed=42, data=synthetic_kitchen_data(24, 40, seed=2),
                                eval_n_times=3, eval_n_steps=2, device="cpu")
    cfg = BesoAgentConfig(hidden_dim=32, n_layers=1, n_heads=2, cond_mask_prob=0.1,
                          max_train_steps=2, eval_every_n_steps=2, train_batch_size=8,
                          cond_lambda=1.5)
    agent = BesoAgent(cfg, ws.scaler, checkpoint_dir=tmp_path and str(tmp_path),
                      device="cpu")
    agent.init(torch.Generator().manual_seed(seed))
    return ws, agent


def test_trainer_restore(tmp_path):
    """`Trainer.restore` loads a saved state into a freshly built agent's
    state: weights, EMA, optimizer moments, LR schedule and step."""
    ws, agent = _tiny_agent(0, tmp_path)
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator().manual_seed(1))
    _, other = _tiny_agent(7)
    ts = other.trainer.restore(other.state, tmp_path, "final")
    assert ts is other.state and ts.step == 2 and ts.ema.num_updates == 2
    assert ts.scheduler.last_epoch == 2
    for (n, p), (_, q) in zip(agent.state.model.named_parameters(),
                              ts.model.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(agent.state.ema.params[n], ts.ema.params[n]), n
    for s_a, s_b in zip(agent.state.optimizer.state.values(), ts.optimizer.state.values()):
        assert all(torch.equal(s_a[k], s_b[k]) for k in s_a)


# ---- reset / predict / visualize_ode against the JAX agent -------------------------

def _agents(cond_lambda=1.5):
    """A JAX and a port BesoAgent with the same weights (live and EMA) and
    scalers over the same data."""
    from beso_tpu.agents.beso_agent import BesoAgent as JAgent
    from beso_tpu.agents.beso_agent import BesoAgentConfig as JConfig
    from beso_tpu.models.ema import ema_init as jema_init
    from beso_tpu.train.trainer import TrainState as JTrainState
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.models.convert import params_from_jax
    from beso_tpu_torch.models.ema import ema_init

    _, _, params, _ = make_models(seed=61)
    data = synthetic_kitchen_data(n_traj=8, t_max=30, seed=62)
    obs, act = data.all_observations(), data.all_actions()
    kw = dict(obs_dim=30, action_dim=9, hidden_dim=48, n_layers=2, n_heads=2, goal_seq_len=2,
              window_size=4, cond_lambda=cond_lambda)
    jagent = JAgent(JConfig(**kw), jax_fit(obs, act, False))
    jagent.state = JTrainState(params=params, opt_state=None, ema=jema_init(params),
                               step=jnp.zeros((), jnp.int32))
    agent = BesoAgent(BesoAgentConfig(**kw), fit_scaler(obs, act, False), device="cpu")
    agent.init(torch.Generator().manual_seed(0))
    params_from_jax(params, agent.state.model)
    agent.state.ema = ema_init(agent.state.model.named_parameters())
    return jagent, agent


def test_agent_reset_and_predict_match_jax(monkeypatch):
    """W + 2 control steps through `BesoAgent.reset` / `predict` (CFG 1.5),
    JAX's action noise injected: actions and rolling contexts agree."""
    jagent, agent = _agents()
    B = 5
    rng = np.random.RandomState(63)
    goal = rng.randn(B, 2, 30).astype(np.float32)
    noise = {}
    monkeypatch.setattr(tpolicy, "action_noise", lambda b, a, gen, dev: t(noise["now"]))
    jstate, state = jagent.reset(B), agent.reset(B)
    assert state.obs_buf.device.type == "cpu" and int(state.count.sum()) == 0
    for step in range(agent.cfg.window_size + 2):
        obs = rng.randn(B, 30).astype(np.float32)
        key = jax.random.PRNGKey(200 + step)
        noise["now"] = np.asarray(jax.random.normal(key, (B, 9)))
        jact, jstate = jagent.predict(jstate, jnp.asarray(obs), jnp.asarray(goal), key)
        act, state = agent.predict(state, t(obs), t(goal), None)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), **TOL)
        for name in ("obs_buf", "act_buf"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), **TOL)


def test_visualize_ode_matches_jax(monkeypatch):
    """Every step of the step-wise DDIM trajectory, JAX's start noise
    injected; 4 steps on the karras grid as an override."""
    jagent, agent = _agents()
    rng = np.random.RandomState(64)
    state = rng.randn(1, 4, 30).astype(np.float32)
    goal = rng.randn(1, 2, 30).astype(np.float32)
    key = jax.random.PRNGKey(65)
    monkeypatch.setattr(tagent_mod, "ode_noise",
                        lambda shape, gen, dev: t(np.asarray(jax.random.normal(key, shape))))
    for kw in ({}, dict(new_sampling_steps=4, noise_scheduler="karras")):
        ref = jagent.visualize_ode(jnp.asarray(state), jnp.asarray(goal), key, get_mean=6, **kw)
        out = agent.visualize_ode(t(state), t(goal), None, get_mean=6, **kw)
        assert out.shape == (kw.get("new_sampling_steps", 3) + 1, 6, 4, 9)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ---- the studies ----------------------------------------------------------------

def _stub_workspaces():
    """A JAX and a port workspace whose test_agent returns numbers made from
    its arguments and the episode counts, recording each call."""
    from beso_tpu.workspaces.base import BaseWorkspace as JBase
    from beso_tpu_torch.workspaces.base import BaseWorkspace

    def make(base):
        class Stub(base):
            def __init__(self):
                self.eval_n_times, self.eval_n_steps, self.calls = 10, 20, []

            def test_agent(self, agent, **kw):
                self.calls.append(kw)
                lam = kw.get("cond_lambda") or 0.0
                steps = kw.get("n_inference_steps") or 3
                r = 0.123456 * lam + self.eval_n_times / 7 + steps / 11
                return {"avrg_reward": r, "std_reward": r / 3, "avrg_result": r / 5,
                        "std_result": self.eval_n_steps / 13}
        return Stub()

    return make(JBase), make(BaseWorkspace)


def test_sweep_matches_jax(tmp_path):
    """`_sweep` through the CFG study and a ddim-only step grid: the same
    results, the same .npy files, the episode counts restored."""
    jws, ws = _stub_workspaces()
    outs = []
    for w, d in ((jws, tmp_path / "jax"), (ws, tmp_path / "port")):
        outs.append(w.compare_classifier_free_guidance(None, 4, 2, n_inference_steps=5,
                                                       store_path=str(d), log_metrics=False))
        assert (w.eval_n_times, w.eval_n_steps) == (10, 20)
    assert outs[0] == outs[1] and len(outs[1]["results"]) == 5
    for k in ("avrg_rewards", "results", "std_rewards", "std_results"):
        name = f"cfg_lambda_comparison_{k}.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))
    assert (tmp_path / "port" / "cfg_lambda_comparison.png").exists()
    assert jws.calls == ws.calls
    grids = [w.compare_sampler_types_over_n_steps(None, 3, 2, steps_list=(3, 5),
                                                  samplers_list=("ddim",))
             for w in (jws, ws)]
    for k in ("result", "reward", "result_std", "reward_std"):
        np.testing.assert_array_equal(grids[1][k], grids[0][k])


@pytest.mark.parametrize("study", ["compare_sampler_types", "compare_noisy_sampler",
                                   "compare_sde_sampling", "compare_kde_vs_mean_vs_single",
                                   "compare_sampler_types_over_n_steps"])
def test_unported_studies_raise_before_a_rollout(study):
    _, ws = _stub_workspaces()
    kw = {"compare_sde_sampling": dict(churn_list=[0.0, 0.5]),
          "compare_kde_vs_mean_vs_single": dict(sampler_type="ddim")}.get(study, {})
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*A(14|20)"):
        getattr(ws, study)(None, 2, 2, **kw)
    assert ws.calls == []


# ---- the evaluation CLI --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(EVAL_CONFIGS))
def test_eval_cli_configs_match_jax(name):
    """The agent config (the run's config with the eval config's sigma range)
    and the policy config of the single variant, field for field against
    JAX's `build_agent_config` + `dataclasses.replace` and its workspace's
    `_policy_cfg`."""
    import scripts.training as jtraining
    from beso_tpu.agents.beso_agent import BesoAgent as JAgent
    from beso_tpu.utils.config import load_config as jload
    from beso_tpu.workspaces.kitchen_workspace import FrankaKitchenWorkspace as JWorkspace
    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.utils.config import load_config
    from beso_tpu_torch.workspaces import BaseWorkspace

    model_path, eval_path = EVAL_CONFIGS[name]
    model_cfg, eval_cfg = load_config(model_path), load_config(eval_path)
    assert (model_cfg, eval_cfg) == (jload(model_path), jload(eval_path))
    jcfg = jtraining.build_agent_config(model_cfg)
    jcfg = dataclasses.replace(jcfg, sigma_min=eval_cfg.get("sigma_min", jcfg.sigma_min),
                               sigma_max=eval_cfg.get("sigma_max", jcfg.sigma_max))
    cfg = evaluate.eval_agent_config(eval_cfg, model_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    # JAX's evaluate.py:57-70
    cond_lambda = (eval_cfg.get("cond_lambda", 1.0)
                   if model_cfg.get("cond_mask_prob", 0) > 0 else None)
    common = dict(new_sampler_type=eval_cfg.get("sampler_type"),
                  n_inference_steps=eval_cfg.get("n_inference_steps"),
                  noise_scheduler=eval_cfg.get("noise_scheduler"), cond_lambda=cond_lambda,
                  get_mean=eval_cfg.get("n_action_samples"),
                  aggregation=eval_cfg.get("aggregation"))
    extra = {"s_churn": eval_cfg.get("s_churn", 0.0), "s_min": eval_cfg.get("s_min", 0.0)}
    assert evaluate.policy_overrides(eval_cfg, model_cfg) == common
    jpol = JWorkspace._policy_cfg(None, JAgent(jcfg, None), extra_args=extra, **common)
    pol = BaseWorkspace._policy_cfg(BesoAgent(cfg, None, device="cpu"), extra_args=extra,
                                    **common)
    jfields = dataclasses.asdict(jpol)
    assert dataclasses.asdict(pol) == {k: jfields[k] for k in dataclasses.asdict(pol)}
    assert (pol.sampler_type, pol.num_sampling_steps) == ("ddim", 3)


def _train_tiny(name, run_dir):
    model_path, _ = EVAL_CONFIGS[name]
    res = training.main(["--config", model_path, "--device", "cpu", "--run-dir",
                         str(run_dir), *TINY])
    assert math.isfinite(res["avrg_result"])


@pytest.mark.parametrize("name", sorted(EVAL_CONFIGS))
def test_training_and_evaluate_clis_end_to_end(name, tmp_path):
    """Both CLIs on the CPU at a tiny size: train, then evaluate the shipped
    eval config's single variant (2 runs x 2 steps), then its CFG study."""
    _train_tiny(name, tmp_path / "run")
    ev = ["--config", EVAL_CONFIGS[name][1], "--device", "cpu",
          f"model_store_path={tmp_path / 'run'}", "num_runs=2", "num_steps_per_run=2"]
    out = evaluate.main(ev)
    assert {"avrg_reward", "avrg_result", "std_reward", "std_result"} <= set(out)
    assert all(math.isfinite(out[k]) for k in ("avrg_reward", "avrg_result"))
    study = evaluate.main([*ev, "test_single_variant=false",
                           "compare_classifier_free_guidance=true",
                           f"store_path={tmp_path / 'cfg'}"])
    assert study["labels"] == [f"lambda={v}" for v in (0.0, 1.0, 1.5, 2.0, 2.5)]
    assert all(math.isfinite(v) for v in study["results"] + study["avrg_rewards"])
    assert (tmp_path / "cfg" / "cfg_lambda_comparison_results.npy").exists()
    with pytest.raises(NotImplementedError, match="A14"):
        evaluate.main([*ev, "test_all_samplers=true"])


@pytest.mark.parametrize("name", sorted(EVAL_CONFIGS))
def test_reloaded_run_evaluates_as_in_memory_agent(name, tmp_path):
    """An agent trained in memory, evaluated with the eval config's study,
    gives exactly the metrics the evaluation CLI gives after reloading its
    stored run with the same seed (the eval config's sigma range set to the
    run's, so that both agents sample alike)."""
    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.utils.config import load_config, save_config

    model_path, eval_path = EVAL_CONFIGS[name]
    model_cfg = load_config(model_path, TINY)
    run = tmp_path / "run"
    save_config(model_cfg, run)
    ws = training.build_workspace(model_cfg, "cpu")
    agent = BesoAgent(training.build_agent_config(model_cfg), ws.scaler, device="cpu")
    agent.init(torch.Generator().manual_seed(model_cfg["seed"]))
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator().manual_seed(3))
    agent.store_model_weights(str(run))
    overrides = [f"model_store_path={run}", "num_runs=3", "num_steps_per_run=3",
                 f"sigma_min={model_cfg['sigma_min']}", f"sigma_max={model_cfg['sigma_max']}"]
    eval_cfg = load_config(eval_path, overrides)
    in_memory = evaluate.run_study(ws, agent, eval_cfg, model_cfg,
                                   torch.Generator().manual_seed(eval_cfg["seed"]))
    reloaded = evaluate.main(["--config", eval_path, "--device", "cpu", *overrides])
    assert reloaded == in_memory
