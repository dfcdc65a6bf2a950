"""`rollout_kitchen` end to end: `beso_tpu_torch` against `beso_tpu`, with the
`cached` engine and lambda=1.5 CFG, 8 envs x 6 steps.

The port is fed the JAX action noise: the test replays `_run_rollout`'s key
splits (`beso_tpu/rollout/rollout.py:75,99`) and hands the port
`normal(step_key, (B, A))` for each step through its noise helper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import make_models, t

import beso_tpu_torch.agents.policy as tpolicy
import beso_tpu_torch.rollout.rollout as trollout
from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.agents.policy import policy_predict, policy_reset
from beso_tpu.envs.kitchen.env import kitchen_reset, kitchen_step
from beso_tpu.models.cached import \
    make_rollout_denoise_factory as jax_factory
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu.rollout import rollout_kitchen as jax_rollout
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.rollout import (average_success_metric, rollout_kitchen,
                                    success_rate_histogram)

B, STEPS = 8, 6
CFG = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
           sigma_min=0.005, sigma_max=1.0, sampler_type="ddim", cond_lambda=1.5)


def test_rollout_kitchen_matches_jax(monkeypatch):
    _, jden, params, tden = make_models(seed=31)
    data = synthetic_kitchen_data(n_traj=16, t_max=40, seed=0)
    obs_all, act_all = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs_all, act_all, False), fit_scaler(obs_all, act_all, False)
    goals, expected = multigoal_kitchen_goals(data, 2, B, seed=42)
    jcfg = JaxPolicyConfig(**CFG)
    jfactory = jax_factory(jden, params, jscaler, jcfg, engine="cached")
    key = jax.random.PRNGKey(3)

    def jdn(s, a, g, sig):
        return jden.apply(params, s, a, g, sig)

    ref = jax_rollout(jdn, jscaler, jcfg, jnp.asarray(goals), jnp.asarray(expected),
                      key, n_steps=STEPS, denoise_factory=jfactory)

    # the same loop step by step in JAX, for the per-step actions
    k_reset, k_roll = jax.random.split(key)
    step_keys = jax.random.split(k_roll, STEPS)
    env = jax.vmap(kitchen_reset)(jax.random.split(k_reset, B))
    dn, obs = jfactory(jnp.asarray(goals)), env.qpos
    pstate, jactions = policy_reset(B, jcfg), []
    for k in step_keys:
        action, pstate = policy_predict(dn, jscaler, pstate, obs,
                                        jnp.asarray(goals), k, jcfg)
        env, obs, _, _ = jax.vmap(kitchen_step)(env, action)
        jactions.append(np.asarray(action))

    noises = iter([np.asarray(jax.random.normal(k, (B, 9))) for k in step_keys])
    monkeypatch.setattr(tpolicy, "action_noise", lambda *a: t(next(noises)))
    actions = []
    real_step = trollout.kitchen_step

    def recording_step(state, action, params=None):
        actions.append(action.numpy().copy())
        return real_step(state, action, params)

    monkeypatch.setattr(trollout, "kitchen_step", recording_step)
    cfg = tpolicy.PolicyConfig(**CFG)
    out = rollout_kitchen(None, scaler, cfg, t(goals), t(expected), None,
                          n_steps=STEPS, denoise_factory=make_rollout_denoise_factory(
                              tden, scaler, cfg, engine="cached"))

    assert len(actions) == STEPS
    np.testing.assert_allclose(np.stack(actions), np.stack(jactions),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out.completed.numpy(), np.asarray(ref.completed))
    np.testing.assert_array_equal(out.results.numpy(), np.asarray(ref.results))
    np.testing.assert_array_equal(out.completion_order.numpy(),
                                  np.asarray(ref.completion_order))
    np.testing.assert_allclose(out.rewards.numpy(), np.asarray(ref.rewards))
    assert out.env_steps == B * STEPS == int(ref.env_steps)


def test_success_metrics():
    n = np.asarray([0, 1, 2, 4, 5])
    assert success_rate_histogram(n) == {
        "success_rate_1": 0.8, "success_rate_2": 0.6, "success_rate_3": 0.4,
        "success_rate_4": 0.4, "success_rate_5": 0.2}
    assert average_success_metric(np.asarray([0.0, 1.0, 0.5, 1.0])) == 0.5


def test_init_qpos_must_match_batch():
    cfg = tpolicy.PolicyConfig(**CFG)
    scaler = fit_scaler(np.zeros((4, 30)), np.ones((4, 9)), False)
    with pytest.raises(ValueError, match="one start state per episode"):
        rollout_kitchen(None, scaler, cfg, t(np.zeros((2, 2, 30), np.float32)),
                        t(np.zeros((2, 7), bool)), None, n_steps=1,
                        init_qpos=t(np.zeros((3, 30), np.float32)))
