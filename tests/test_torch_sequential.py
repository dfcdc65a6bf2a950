"""The sequential kitchen evaluation and the kitchen workspace's options:
`beso_tpu_torch` against `beso_tpu` on the CPU (f32, the small model).

* `sequential_kitchen_goals`, `onehot_kitchen_goals` and `load_init_qpos`
  equal JAX's;
* `rollout_kitchen_sequential`: each step's goal (the env's stage) and
  action, then rewards, results, completions and their order, with JAX's
  noise injected (its key splits replayed); once on the physics as it is,
  once with a stand-in completion rule in both packages' step (task
  `steps // 3 mod 7` counts as done), so that stages also advance on a
  completed goal task, not only on a spent budget;
* the workspace's `test_agent(evaluate_sequential=True)` and its known-start
  and `physics_params` options against JAX's workspace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, make_models, t

import beso_tpu_torch.agents.policy as tpolicy
import beso_tpu_torch.rollout.sequential as tseq
from beso_tpu.agents.policy import PolicyConfig as JPolicyConfig
from beso_tpu.envs.kitchen import goals as jgoals
from beso_tpu.envs.kitchen.env import DEFAULT_KITCHEN_PARAMS
from beso_tpu.envs.kitchen.env import load_init_qpos as jax_load_init_qpos
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu.rollout import sequential as jseq
from beso_tpu.workspaces.kitchen_workspace import FrankaKitchenWorkspace as JWorkspace
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.envs.kitchen import goals as tgoals
from beso_tpu_torch.envs.kitchen.env import default_kitchen_params, load_init_qpos
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

B, STEPS = 5, 14
CFG = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3, cond_lambda=1.5)


@pytest.fixture(scope="module")
def data():
    return synthetic_kitchen_data(n_traj=16, t_max=40, seed=2)


@pytest.mark.parametrize("n", [3, 20])
def test_sequential_and_onehot_goals_match_jax(data, n):
    for a, b in zip(tgoals.sequential_kitchen_goals(data, 2, n, seed=42),
                    jgoals.sequential_kitchen_goals(data, 2, n, seed=42)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(tgoals.onehot_kitchen_goals(data, n, seed=7),
                    jgoals.onehot_kitchen_goals(data, n, seed=7)):
        np.testing.assert_array_equal(a, b)
    no_labels = dataclasses.replace(data, onehot_goals=None)
    with pytest.raises(ValueError, match="onehot"):
        tgoals.sequential_kitchen_goals(no_labels, 2, n, seed=42)


def test_load_init_qpos_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    np.save(tmp_path / "all_init_qpos.npy", rng.randn(6, 30))
    np.save(tmp_path / "all_init_qvel.npy", rng.randn(6, 29))
    for a, b in zip(load_init_qpos(tmp_path), jax_load_init_qpos(tmp_path)):
        np.testing.assert_array_equal(a, b)


def _fake_completion(steps, completed):
    """Stand-in completion rule: task (steps // 3) mod 7 counts as done."""
    return completed | (np.arange(7) == (steps // 3) % 7)


@pytest.mark.parametrize("stand_in", [False, True])
def test_rollout_kitchen_sequential_matches_jax(data, stand_in, monkeypatch):
    _, jden, params, tden = make_models(seed=33)
    obs_all, act_all = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs_all, act_all, False), fit_scaler(obs_all, act_all, False)
    goals, tf, task_ids, expected = tgoals.sequential_kitchen_goals(data, 2, B, seed=42)
    tf = tf // 8              # budgets of a few steps, so the stages advance
    key = jax.random.PRNGKey(5)
    jlog = {"goal": [], "action": []}

    def jrecord(goal, action):
        jlog["goal"].append(np.asarray(goal))
        jlog["action"].append(np.asarray(action))

    real_jpredict, real_jstep = jseq.policy_predict, jseq.kitchen_step

    def jpredict(dn, sc, ps, obs, goal, k, cfg):
        action, ps = real_jpredict(dn, sc, ps, obs, goal, k, cfg)
        jax.debug.callback(jrecord, goal, action, ordered=True)
        return action, ps

    def jstep(state, action, params_):
        state, obs, r, d = real_jstep(state, action, params_)
        if stand_in:
            state = state._replace(completed=jnp.asarray(
                state.completed | (jnp.arange(7) == (state.steps // 3) % 7)))
        return state, obs, r, d

    monkeypatch.setattr(jseq, "policy_predict", jpredict)
    monkeypatch.setattr(jseq, "kitchen_step", jstep)
    jcfg = JPolicyConfig(**CFG)
    ref = jseq.rollout_kitchen_sequential(
        lambda s, a, g, sig: jden.apply(params, s, a, g, sig), jscaler, jcfg,
        jnp.asarray(goals), jnp.asarray(tf), jnp.asarray(task_ids), jnp.asarray(expected),
        key, n_steps=STEPS, budget_margin=1)

    _, k_roll = jax.random.split(key)
    noises = iter([np.asarray(jax.random.normal(k, (B, 9)))
                   for k in jax.random.split(k_roll, STEPS)])
    monkeypatch.setattr(tpolicy, "action_noise", lambda *a: t(next(noises)))
    tlog = {"goal": [], "action": []}
    real_tpredict, real_tstep = tseq.policy_predict, tseq.kitchen_step

    def tpredict(dn, sc, ps, obs, goal, gen, cfg):
        action, ps = real_tpredict(dn, sc, ps, obs, goal, gen, cfg)
        tlog["goal"].append(goal.numpy().copy())
        tlog["action"].append(action.numpy().copy())
        return action, ps

    def tstep(state, action, params_=None):
        state, obs, r, d = real_tstep(state, action, params_)
        if stand_in:
            state = state._replace(completed=torch.as_tensor(_fake_completion(
                state.steps.numpy()[:, None], state.completed.numpy())))
        return state, obs, r, d

    monkeypatch.setattr(tseq, "policy_predict", tpredict)
    monkeypatch.setattr(tseq, "kitchen_step", tstep)
    out = tseq.rollout_kitchen_sequential(
        tden, scaler, tpolicy.PolicyConfig(**CFG), t(goals), t(tf), t(task_ids),
        t(expected), None, n_steps=STEPS, budget_margin=1)

    assert len(tlog["goal"]) == len(jlog["goal"]) == STEPS
    stages = [[int(np.argmax((g[b] == goals[b]).all(axis=(1, 2)))) for b in range(B)]
              for g in tlog["goal"]]
    assert max(max(s) for s in stages) >= 2         # the stages did advance
    np.testing.assert_array_equal(np.stack(tlog["goal"]), np.stack(jlog["goal"]))
    np.testing.assert_allclose(np.stack(tlog["action"]), np.stack(jlog["action"]), **TOL)
    np.testing.assert_allclose(out.rewards.numpy(), np.asarray(ref.rewards), **TOL)
    np.testing.assert_array_equal(out.results.numpy(), np.asarray(ref.results))
    np.testing.assert_array_equal(out.completed.numpy(), np.asarray(ref.completed))
    np.testing.assert_array_equal(out.completion_order.numpy(),
                                  np.asarray(ref.completion_order))
    assert out.env_steps == B * STEPS


class _Agents:
    """A JAX and a port stand-in agent on the same small model: what the
    workspaces call (make_denoise_fn, make_denoise_factory, scaler,
    policy_config; the port's also make_uncached_denoise_fn)."""

    def __init__(self, jws, ws):
        _, jden, params, tden = make_models(seed=34)

        class JAgent:
            scaler = jws.scaler

            @staticmethod
            def make_denoise_fn():
                return lambda s, a, g, sig: jden.apply(params, s, a, g, sig)

            @staticmethod
            def make_denoise_factory(cfg):
                return None

            @staticmethod
            def policy_config(**kw):
                return JPolicyConfig(**{**CFG, **{k: v for k, v in kw.items()
                                                  if v is not None}})

        class TAgent(JAgent):
            scaler = ws.scaler

            @staticmethod
            def make_denoise_fn():
                return tden

            make_uncached_denoise_fn = make_denoise_fn

            @staticmethod
            def policy_config(**kw):
                return tpolicy.PolicyConfig(**{**CFG, **{k: v for k, v in kw.items()
                                                         if v is not None}})

        self.jax, self.port = JAgent(), TAgent()


def _workspaces(data, n_envs, n_steps):
    kw = dict(seed=42, eval_n_times=n_envs, eval_n_steps=n_steps, data=data)
    return JWorkspace(**kw), FrankaKitchenWorkspace(**kw, device="cpu")


def _inject_rollout_noise(monkeypatch, key, n_envs, n_steps, n_rollouts=1):
    """JAX's rollout noise (`_run_rollout` and the sequential rollout split
    the key alike: k_reset, k_roll, then one key per step), replayed for
    `n_rollouts` rollouts from the same key."""
    _, k_roll = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(k, (n_envs, 9)))
             for k in jax.random.split(k_roll, n_steps)] * n_rollouts
    noises = iter(draws)
    monkeypatch.setattr(tpolicy, "action_noise", lambda *a: t(next(noises)))


def _same_metrics(got, ref):
    for k in ("avrg_reward", "std_reward", "avrg_result", "std_result"):
        np.testing.assert_allclose(got[k], ref[k], **TOL)
    for k in ("success_rate_1", "solved_tasks", "expected_tasks", "traj_count"):
        assert got[k] == ref[k]


def test_workspace_sequential_matches_jax(data, monkeypatch):
    """test_agent(evaluate_multigoal=True, evaluate_sequential=True): the
    pair of results, each against JAX's workspace from the same key."""
    jws, ws = _workspaces(data, 4, 6)
    agents = _Agents(jws, ws)
    key = jax.random.PRNGKey(42)                     # the workspaces' seed
    jmg, jsq = jws.test_agent(agents.jax, evaluate_sequential=True, key=key,
                              log_metrics=False)
    _inject_rollout_noise(monkeypatch, key, 4, 6, n_rollouts=2)
    mg, sq = ws.test_agent(agents.port, evaluate_sequential=True, log_metrics=False)
    _same_metrics(mg, jmg)
    _same_metrics(sq, jsq)
    assert ws.test_agent(agents.port, evaluate_multigoal=False, evaluate_sequential=False,
                         log_metrics=False) is None


def test_workspace_known_starts_and_physics_match_jax(data, monkeypatch):
    """start_from_known with an init_qpos pool (wrapping past its 3 rows)
    and with the dataset's first frames, under a wider interact_radius."""
    jws, ws = _workspaces(data, 5, 5)
    agents = _Agents(jws, ws)
    pool = data.observations[:3, 0, :30] + 0.05
    key = jax.random.PRNGKey(42)
    jparams = DEFAULT_KITCHEN_PARAMS.replace(interact_radius=jnp.asarray(0.06))
    tparams = dataclasses.replace(default_kitchen_params(torch.device("cpu")),
                                  interact_radius=torch.tensor(0.06))
    for init_qpos in (pool, None):
        ref = jws.test_agent(agents.jax, key=key, log_metrics=False, start_from_known=True,
                             init_qpos=init_qpos, physics_params=jparams)
        _inject_rollout_noise(monkeypatch, key, 5, 5)
        got = ws.test_agent(agents.port, log_metrics=False, start_from_known=True,
                            init_qpos=init_qpos, physics_params=tparams)
        _same_metrics(got, ref)


def test_workspace_caller_generator_starts_both_evaluations_alike(data, monkeypatch):
    """test_agent with both evaluations and a caller's generator: the
    sequential rollout draws what it draws alone from a generator in the
    same state (JAX hands both evaluations the same key), and the caller's
    generator ends where the multigoal rollout left it."""
    jws, ws = _workspaces(data, 3, 4)
    agents = _Agents(jws, ws)
    draws = []
    real = tpolicy.action_noise
    monkeypatch.setattr(tpolicy, "action_noise",
                        lambda *a: draws.append(real(*a)) or draws[-1])
    gen = torch.Generator().manual_seed(7)
    ws.test_agent(agents.port, evaluate_sequential=True, generator=gen, log_metrics=False)
    after = gen.get_state()
    both, draws[:] = list(draws), []
    ws.test_agent(agents.port, evaluate_multigoal=False, evaluate_sequential=True,
                  generator=torch.Generator().manual_seed(7), log_metrics=False)
    assert len(both) == 2 * len(draws) == 2 * 4
    for got, ref in zip(both[4:], draws):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    multigoal_only = torch.Generator().manual_seed(7)
    ws.test_agent(agents.port, generator=multigoal_only, log_metrics=False)
    assert torch.equal(after, multigoal_only.get_state())
