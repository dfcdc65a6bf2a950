"""`models/cfg.py::classifier_guided_denoise_fn` against JAX's, with the same
denoiser weights (`torch_parity.make_models`) and the same numpy-weighted
guide in both frameworks: on the plain forward and on the cached engine,
outside and inside `torch.inference_mode` (where the rollouts run)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import make_inputs, make_models, t

from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.core.schedules import get_noise_schedule
from beso_tpu.models.cached import make_rollout_denoise_factory as jax_factory
from beso_tpu.models.cfg import classifier_guided_denoise_fn as jax_guided
from beso_tpu.models.scaler import fit_scaler as jax_fit
from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.cfg import classifier_guided_denoise_fn
from beso_tpu_torch.models.scaler import fit_scaler

CFG = dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3,
           sigma_min=0.005, sigma_max=1.0, sampler_type="ddim", cond_lambda=1.0)
TOL = dict(atol=1e-5, rtol=1e-5)


def guide_weights(seed=3, hidden=16):
    """A two-layer tanh guide over the last state, every action and the
    last goal: Q = w2 . tanh(W1 x + b1)."""
    rng = np.random.RandomState(seed)
    n_in = 30 + 4 * 9 + 30
    return ((rng.randn(n_in, hidden) / np.sqrt(n_in)).astype(np.float32),
            (0.1 * rng.randn(hidden)).astype(np.float32),
            rng.randn(hidden).astype(np.float32))


def torch_guide(w):
    W1, b1, w2 = (torch.as_tensor(v) for v in w)

    def guide(s, a, g):
        x = torch.cat([s[:, -1], a.reshape(a.shape[0], -1), g[:, -1]], -1)
        return torch.tanh(x @ W1 + b1) @ w2

    return guide


def jax_guide(w):
    W1, b1, w2 = (jnp.asarray(v) for v in w)

    def guide(s, a, g):
        x = jnp.concatenate([s[:, -1], a.reshape(a.shape[0], -1), g[:, -1]], -1)
        return jnp.tanh(x @ W1 + b1) @ w2

    return guide


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("cond_lambda", [2.0, 0.5])
def test_guided_plain_forward_matches_jax(inference, cond_lambda):
    kw, jden, params, tden = make_models(seed=21)
    s, a, g, sig = make_inputs(kw, B=5, seed=22)
    w = guide_weights()
    jdn = jax_guided(lambda *v: jden.apply(params, *v), jax_guide(w), cond_lambda)
    ref = np.asarray(jdn(*(jnp.asarray(v) for v in (s, a, g, sig))))
    dn = classifier_guided_denoise_fn(tden, torch_guide(w), cond_lambda)
    with torch.inference_mode(inference):
        out = dn(t(s), t(a), t(g), t(sig))
    assert out.is_inference() == inference
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the guide moved the prediction
    plain = tden(t(s), t(a), t(g), t(sig)).detach().numpy()
    assert np.abs(out.numpy() - plain).max() > 1e-3


@pytest.mark.parametrize("inference", [False, True])
def test_guided_cached_engine_matches_jax(inference):
    kw, jden, params, tden = make_models(seed=23)
    data = synthetic_kitchen_data(n_traj=8, t_max=30, seed=1)
    obs, act = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs, act, False), fit_scaler(obs, act, False)
    s, a, g, _ = make_inputs(kw, B=6, seed=24)
    w = guide_weights(seed=5)
    jdn = jax_guided(jax_factory(jden, params, jscaler, JaxPolicyConfig(**CFG),
                                 engine="cached")(jnp.asarray(g)), jax_guide(w))
    guide = torch_guide(w)     # weights made outside, as a trained guide's
    with torch.inference_mode(inference):
        dn = classifier_guided_denoise_fn(make_rollout_denoise_factory(
            tden, scaler, PolicyConfig(**CFG), engine="cached")(t(g)), guide)
        for sg in get_noise_schedule(3, 0.005, 1.0, 5.0, "exponential")[:-1]:
            sig = np.full((6,), sg, np.float32)
            ref = jdn(jnp.asarray(s), jnp.asarray(a), jnp.asarray(g), jnp.asarray(sig))
            out = dn(t(s), t(a), t(g), t(sig))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_step_is_the_guide_gradient_at_the_prediction():
    """out - pred = lambda sigma^2 dQ/da at a = pred, per row: each row's
    step is its own guide value's gradient."""
    kw, _, _, tden = make_models(seed=25)
    s, a, g, sig = (t(v) for v in make_inputs(kw, B=3, seed=26))
    guide = torch_guide(guide_weights())
    out = classifier_guided_denoise_fn(tden, guide, 2.0)(s, a, g, sig)
    pred = tden(s, a, g, sig)
    for i in range(3):
        x = pred[i:i + 1].clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(guide(s[i:i + 1], x, g[i:i + 1]).sum(), x)
        torch.testing.assert_close(out[i] - pred[i], 2.0 * sig[i] ** 2 * grad[0],
                                   rtol=1e-5, atol=1e-6)
