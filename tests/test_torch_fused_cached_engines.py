"""The cached fused serving engine's other forms, against `beso_tpu`:

- `make_fused_cached_denoise_fn` with `token_lanes=False` (B3) and with
  `layer_group` > 1 (B2) at every grid sigma, and a kitchen rollout under
  `BESO_LAYER_GROUP=2`, against the JAX engines as
  `tests/test_fused_inference.py` runs them (interpret mode, env_block 8),
  atol 1e-5, rtol 1e-4;
- the agent's engine for an ineligible policy config: JAX's full forward,
  the port's B4 under `fused_cached`.

The kernels' plain versions and the uncached engine are in
`tests/test_torch_fused_engines.py`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import make_inputs, make_models, t

import beso_tpu.models.fused as jfused
import beso_tpu_torch.agents.policy as tpolicy
import beso_tpu_torch.models.fused as tfused
from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.models.cached import \
    make_rollout_denoise_factory as jax_factory
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu.rollout import rollout_kitchen as jax_rollout
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.rollout import rollout_kitchen

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
E = 8           # JAX env_block
GRID = [1.0, 0.18, 0.032]


CACHED_CASES = {
    "token_lanes_false": (dict(token_lanes=False), True),
    "group2": (dict(layer_group=2), True),
    "group3": (dict(layer_group=3), True),
    "group2_mlp_head": (dict(layer_group=2), False),
}


@pytest.mark.parametrize("name", sorted(CACHED_CASES))
def test_fused_cached_forms_match_jax(name):
    """3 layers, so a group of 2 leaves a group of 1 and a group of 3 is the
    whole stack (a group larger than the stack is the same launch; chip_smoke
    phase 9 runs a group of 4 on 6 layers); every grid sigma."""
    engine_kw, linear = CACHED_CASES[name]
    kw, jden, params, tden = make_models(seed=51, n_layers=3, linear_output=linear)
    s, a, g, _ = make_inputs(kw, B=8, seed=52)
    # jitted once, so the interpret-mode kernels trace once for all sigmas
    jdn = jax.jit(jfused.make_fused_cached_denoise_fn(
        jden, params, jnp.asarray(g), jnp.asarray(GRID), env_block=E,
        interpret=True, **engine_kw))
    dn = tfused.make_fused_cached_denoise_fn(tden, t(g), GRID, **engine_kw)
    for sg in GRID:
        sig = np.full((8,), sg, np.float32)
        ref = jdn(*(jnp.asarray(v) for v in (s, a, g, sig)))
        out = dn(t(s), t(a), t(g), t(sig))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ENGINE_TOL)


def test_layer_group_rollout_matches_jax(monkeypatch):
    """A 3-step kitchen rollout on `fused_cached` with BESO_LAYER_GROUP=2 in
    both packages (3 layers: groups of 2 and 1), the port fed the JAX
    action noise; the port's engine goes through B2 only."""
    B, STEPS = 4, 3
    cfg_kw = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
                  sigma_min=0.005, sigma_max=1.0, sampler_type="ddim", cond_lambda=1.5)
    monkeypatch.setenv("BESO_LAYER_GROUP", "2")
    monkeypatch.setattr(jfused, "make_fused_cached_denoise_fn",
                        functools.partial(jfused.make_fused_cached_denoise_fn,
                                          env_block=E))
    _, jden, params, tden = make_models(seed=61, n_layers=3)
    data = synthetic_kitchen_data(n_traj=8, t_max=40, seed=0)
    obs_all, act_all = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs_all, act_all, False), fit_scaler(obs_all, act_all, False)
    goals, expected = multigoal_kitchen_goals(data, 2, B, seed=42)
    jcfg = JaxPolicyConfig(**cfg_kw)
    key = jax.random.PRNGKey(3)
    ref = jax_rollout(None, jscaler, jcfg, jnp.asarray(goals), jnp.asarray(expected), key,
                      n_steps=STEPS,
                      denoise_factory=jax_factory(jden, params, jscaler, jcfg,
                                                  engine="fused_cached"))

    # the JAX loop's action noise (`beso_tpu/rollout/rollout.py:75,99`)
    _, k_roll = jax.random.split(key)
    noises = iter([np.asarray(jax.random.normal(k, (B, 9)))
                   for k in jax.random.split(k_roll, STEPS)])
    monkeypatch.setattr(tpolicy, "action_noise", lambda *a: t(next(noises)))
    calls = {"group": 0, "single": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfused, "fused_layers_prefix_group",
                        counting("group", tfused.fused_layers_prefix_group))
    monkeypatch.setattr(tfused, "fused_layer_prefix",
                        counting("single", tfused.fused_layer_prefix))
    cfg = tpolicy.PolicyConfig(**cfg_kw)
    out = rollout_kitchen(None, scaler, cfg, t(goals), t(expected), None, n_steps=STEPS,
                          denoise_factory=make_rollout_denoise_factory(
                              tden, scaler, cfg, engine="fused_cached"))
    assert calls == {"group": STEPS * 3 * 2, "single": 0}
    np.testing.assert_allclose(out.rewards.numpy(), np.asarray(ref.rewards), atol=1e-4)
    np.testing.assert_array_equal(out.completed.numpy(), np.asarray(ref.completed))


# ---- the agent's engine choice ----------------------------------------------

def _agents(engine):
    """The same small agent config in both packages, initialised."""
    from beso_tpu.agents.beso_agent import BesoAgent as JaxAgent
    from beso_tpu.agents.beso_agent import BesoAgentConfig as JaxAgentConfig
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig

    data = synthetic_kitchen_data(n_traj=2, t_max=20, seed=0)
    obs, act = data.all_observations(), data.all_actions()
    kw = dict(hidden_dim=32, n_layers=1, n_heads=2, max_train_steps=1,
              inference_engine=engine)
    jcfg = JaxAgentConfig(**kw)
    jagent = JaxAgent(jcfg, jax_fit(obs, act, False))
    jagent.init(jax.random.PRNGKey(0), {
        "observation": jnp.zeros((2, jcfg.window_size, jcfg.obs_dim)),
        "action": jnp.zeros((2, jcfg.window_size, jcfg.action_dim)),
        "goal_observation": jnp.zeros((2, jcfg.goal_seq_len, jcfg.obs_dim))})
    agent = BesoAgent(BesoAgentConfig(**kw), fit_scaler(obs, act, False), device="cpu")
    agent.init(torch.Generator().manual_seed(0))
    return jagent, agent


@pytest.mark.parametrize("engine", ["fused_cached", "cached"])
def test_agent_falls_back_only_where_jax_does(engine, monkeypatch):
    """An ineligible policy config (churn, several action samples): a
    ValueError for 'cached' in both packages; for 'fused_cached' JAX's full
    forward (None), and in the port the whole sequence on B4 (every layer
    through `fused_layer`), equal to the plain forward. An eligible config
    gives a factory in both."""
    jagent, agent = _agents(engine)
    calls = [0]
    real = tfused.fused_layer

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tfused, "fused_layer", counted)
    for a in (jagent, agent):
        assert a.make_denoise_factory(a.policy_config()) is not None
        for change in (dict(s_churn=0.5), dict(n_action_samples=2)):
            pcfg = dataclasses.replace(a.policy_config(), **change)
            if engine == "cached":
                with pytest.raises(ValueError):
                    a.make_denoise_factory(pcfg)
            elif a is jagent:
                assert a.make_denoise_factory(pcfg) is None
            else:
                kw = dict(state_dim=30, action_dim=9, obs_seq_len=4, goal_seq_len=2)
                s, act, g, sig = make_inputs(kw, B=3, seed=53)
                calls[0] = 0
                got = a.make_denoise_factory(pcfg)(t(g))(t(s), t(act), t(g), t(sig))
                assert calls[0] == a.cfg.n_layers
                ref = a.make_denoise_fn()(t(s), t(act), t(g), t(sig))
                np.testing.assert_allclose(got.numpy(), ref.numpy(), **ENGINE_TOL)
