"""The samplers on a small DiffusionGPT (2 layers, D=32), weights carried
from flax by `params_from_jax`: every name of `SAMPLERS` through
`sample_loop` (heun, euler and dpm also with churn and a clip_fn), Picard
(ddim and euler, K = n and K < n) on the folded [n*B] batch with its
per-row sigmas, DPM-Solver adaptive's step counts, and `log_likelihood`
with its divergence by `torch.func.jvp` through the plain forward. JAX's
draws injected through `sampler_noise` and `rademacher_probe`; tolerance
the port's TOL (1e-5), 1e-4 relative for the log-likelihood."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, inject_sampler_draws, make_inputs, make_models, t

import beso_tpu_torch.sampling.likelihood as tlik
import beso_tpu_torch.sampling.samplers as tsamplers
from beso_tpu.core.schedules import get_noise_schedule
from beso_tpu.sampling import dpm_solver as jdpm
from beso_tpu.sampling import samplers as jsamplers
from beso_tpu.sampling.likelihood import log_likelihood as jax_ll
from beso_tpu.sampling.parallel import sample_picard as jax_picard
from beso_tpu_torch.sampling import dpm_solver as tdpm
from beso_tpu_torch.sampling.likelihood import log_likelihood
from beso_tpu_torch.sampling.parallel import sample_picard

B = 4
KEY = jax.random.PRNGKey(7)
SIG = get_noise_schedule(4, 0.005, 1.0, 5.0, "exponential")


@pytest.fixture(scope="module")
def models():
    """(jax denoise_fn, port denoise_fn, x): closures over one batch of
    states and goals; both take a folded batch (Picard) by tiling them."""
    kw, jden, params, tden = make_models(seed=21, embed_dim=32)
    s, a, g, _ = make_inputs(kw, B, seed=22)

    def jdn(x, sig):
        r = x.shape[0] // B
        return jden.apply(params, jnp.tile(s, (r, 1, 1)), x, jnp.tile(g, (r, 1, 1)), sig)

    def tdn(x, sig):
        r = x.shape[0] // B
        return tden(t(s).repeat(r, 1, 1), x, t(g).repeat(r, 1, 1), sig)

    return jdn, tdn, a


@pytest.mark.parametrize("name, churn", [(n, False) for n in jsamplers.SAMPLERS]
                         + [(n, True) for n in ("heun", "euler", "dpm")])
def test_samplers_on_the_model_match_jax(name, churn, models, monkeypatch):
    jdn, tdn, a = models
    inject_sampler_draws(monkeypatch, KEY, name)
    kw = dict(s_churn=2.0, s_tmin=0.01) if churn else {}
    jclip = (lambda v: jnp.clip(v, -1.5, 1.5)) if churn else None
    tclip = (lambda v: torch.clamp(v, -1.5, 1.5)) if churn else None
    ref = jsamplers.sample_loop(name, jdn, jnp.asarray(a), SIG, KEY, clip_fn=jclip, **kw)
    got = tsamplers.sample_loop(name, tdn, t(a), SIG, None, clip_fn=tclip, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("update, K", [("ddim", None), ("euler", None), ("ddim", 2)])
def test_picard_on_the_model_matches_jax(update, K, models):
    jdn, tdn, a = models
    ref = jax_picard(jdn, jnp.asarray(a), SIG, update=update, n_iterations=K)
    got = sample_picard(tdn, t(a), SIG, update=update, n_iterations=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_dpm_adaptive_on_the_model_matches_jax(models):
    jdn, tdn, a = models
    ref, info = jdpm.sample_dpm_adaptive(jdn, jnp.asarray(a), 0.005, 1.0, KEY,
                                         return_info=True)
    got, tinfo = tdpm.sample_dpm_adaptive(tdn, t(a), 0.005, 1.0, None, return_info=True)
    assert tinfo == {k: int(v) for k, v in info.items()}
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_log_likelihood_on_the_model_matches_jax(models, monkeypatch):
    jdn, tdn, a = models
    v = (jax.random.randint(KEY, a.shape, 0, 2) * 2 - 1).astype(jnp.float32)
    monkeypatch.setattr(tlik, "rademacher_probe", lambda x, gen: t(np.asarray(v)))
    ref, _ = jax_ll(jdn, jnp.asarray(a), 0.01, 2.0, KEY, n_steps=8)
    got, _ = log_likelihood(tdn, t(a), 0.01, 2.0, None, n_steps=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
