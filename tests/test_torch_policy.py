"""DDIM and `policy_predict` against `beso_tpu`, with the JAX action noise
injected into the port through its one noise-drawing helper."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, make_models, t

import beso_tpu_torch.agents.policy as tpolicy
from beso_tpu.agents import policy as jpolicy
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu.sampling.samplers import sample_ddim as jax_ddim
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.sampling.samplers import sample_ddim, sample_loop

GRID = np.asarray([1.0, 0.3, 0.05, 0.0], np.float32)


def test_ddim_matches_jax():
    x = np.random.RandomState(0).randn(5, 4, 9).astype(np.float32)

    def jden(v, sig):
        return jnp.tanh(v) * (0.5 + sig[:, None, None])

    def tden(v, sig):
        return torch.tanh(v) * (0.5 + sig[:, None, None])

    ref = jax_ddim(jden, jnp.asarray(x), GRID)
    np.testing.assert_allclose(sample_ddim(tden, t(x), GRID).numpy(),
                               np.asarray(ref), **TOL)
    clip = sample_loop("ddim", tden, t(x), GRID,
                       clip_fn=lambda v: torch.clamp(v, -0.2, 0.2))
    assert clip.abs().max() <= 0.2


@pytest.mark.parametrize("name", ["euler", "heun", "dpmpp_2m", "no_such"])
def test_other_samplers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sample_loop(name, lambda v, s: v, torch.zeros(2, 3), GRID)


@pytest.mark.parametrize("cond_lambda", [1.0, 1.5])
def test_policy_predict_matches_jax(cond_lambda, monkeypatch):
    """W+2 steps: the window fills, then rolls; actions, buffers and
    counts agree each step."""
    _, jden, params, tden = make_models(seed=12)
    data = synthetic_kitchen_data(n_traj=8, t_max=30, seed=3)
    obs_all, act_all = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs_all, act_all, False), fit_scaler(obs_all, act_all, False)
    kw = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
              cond_lambda=cond_lambda)
    jcfg, cfg = jpolicy.PolicyConfig(**kw), tpolicy.PolicyConfig(**kw)
    B = 6
    rng = np.random.RandomState(4)
    goal = rng.randn(B, 2, 30).astype(np.float32)
    noise = {}
    monkeypatch.setattr(tpolicy, "action_noise",
                        lambda b, a, gen, dev: t(noise["now"]))

    def jdn(s, a, g, sig):
        return jden.apply(params, s, a, g, sig)

    jstate, state = jpolicy.policy_reset(B, jcfg), tpolicy.policy_reset(B, cfg)
    for step in range(cfg.window_size + 2):
        obs = rng.randn(B, 30).astype(np.float32)
        key = jax.random.PRNGKey(100 + step)
        noise["now"] = np.asarray(jax.random.normal(key, (B, 9)))
        jact, jstate = jpolicy.policy_predict(jdn, jscaler, jstate, jnp.asarray(obs),
                                              jnp.asarray(goal), key, jcfg)
        act, state = tpolicy.policy_predict(tden, scaler, state, t(obs), t(goal),
                                            None, cfg)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), **TOL)
        for name in ("obs_buf", "act_buf"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), **TOL)
        np.testing.assert_array_equal(state.count.numpy(), np.asarray(jstate.count))


@pytest.mark.parametrize("change", [dict(n_action_samples=2),
                                    dict(sampler_type="picard")])
def test_policy_unported_options_raise(change):
    cfg = dataclasses.replace(
        tpolicy.PolicyConfig(window_size=2, obs_dim=3, action_dim=2), **change)
    scaler = fit_scaler(np.zeros((4, 3)), np.ones((4, 2)), False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpolicy.policy_predict(lambda *a: a[1], scaler, tpolicy.policy_reset(2, cfg),
                               torch.zeros(2, 3), torch.zeros(2, 1, 3), None, cfg)
