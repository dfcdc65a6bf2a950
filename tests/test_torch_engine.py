"""The port's `cached` and `fused_cached` engines (on the CPU the fused one
runs the layer kernel's plain version) against JAX `make_cached_denoise_fn`
through the rollout factory, with lambda=1.5 CFG batch stacking."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, make_inputs, make_models, t

from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.core.schedules import get_noise_schedule
from beso_tpu.models.cached import \
    make_rollout_denoise_factory as jax_factory
from beso_tpu.models.cfg import cfg_denoise_fn as jax_cfg
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.cfg import cfg_denoise_fn
from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn
from beso_tpu_torch.models.scaler import fit_scaler

CFG = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
           sigma_min=0.005, sigma_max=1.0, sampler_type="ddim", cond_lambda=1.5)


@pytest.mark.parametrize("engine", ["cached", "fused_cached"])
@pytest.mark.parametrize("linear_output", [True, False])
def test_engine_matches_jax_cached(engine, linear_output):
    kw, jden, params, tden = make_models(seed=7, linear_output=linear_output)
    data = synthetic_kitchen_data(n_traj=8, t_max=30, seed=1)
    obs, act = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs, act, False), fit_scaler(obs, act, False)
    s, a, g, _ = make_inputs(kw, B=6, seed=8)
    jdn = jax_cfg(jax_factory(jden, params, jscaler, JaxPolicyConfig(**CFG),
                              engine="cached")(jnp.asarray(g)), 1.5)
    dn = cfg_denoise_fn(make_rollout_denoise_factory(
        tden, scaler, PolicyConfig(**CFG), engine=engine)(t(g)), 1.5)
    grid = get_noise_schedule(3, 0.005, 1.0, 5.0, "exponential")[:-1]
    for sg in grid:
        sig = np.full((6,), sg, np.float32)
        ref = jdn(jnp.asarray(s), jnp.asarray(a), jnp.asarray(g), jnp.asarray(sig))
        out = dn(t(s), t(a), t(g), t(sig))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("change,match", [
    (dict(sampler_type="euler_ancestral"), "grid-sigma sampler"),
    (dict(s_churn=0.5), "s_churn"),
    (dict(n_action_samples=4), "single action sample"),
])
def test_factory_gating(change, match):
    _, _, _, tden = make_models(seed=9)
    data = synthetic_kitchen_data(n_traj=4, t_max=30, seed=2)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), False)
    cfg = dataclasses.replace(PolicyConfig(**CFG), **change)
    with pytest.raises(ValueError, match=match):
        make_rollout_denoise_factory(tden, scaler, cfg, engine="fused_cached")


def test_fused_rejects_batch_mismatch():
    kw, _, _, tden = make_models(seed=10)
    s, a, g, _ = make_inputs(kw, B=4, seed=11)
    dn = make_fused_cached_denoise_fn(tden, t(g), [1.0, 0.1])
    with pytest.raises(ValueError, match="prefix cache batch 4 != call batch 3"):
        dn(t(s[:3]), t(a[:3]), None, torch.full((3,), 0.1))
