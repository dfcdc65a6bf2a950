"""Every sampler of `beso_tpu_torch.sampling` against its `beso_tpu`
counterpart on analytic denoisers (CPU, f32, atol = rtol = 1e-5): each name
of `SAMPLERS` through `sample_loop`, with and without churn and a clip_fn,
`sample_euler_visualization`, Picard (ddim and euler, K = n and K < n), DPM-
Solver fast and adaptive (the accepted and rejected step counts too), the
LMS coefficients (1e-6) and `log_likelihood` (1e-4 relative). The JAX draws
are injected through the port's one noise helper, `sampler_noise`: step i
draws `normal(fold_in(key, i))`, split in two where `sample_dpmpp_sde`
splits, and the adaptive solver's iteration i its i-th key split; the
log-likelihood's Rademacher probe through `rademacher_probe`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import inject_sampler_draws, t

import beso_tpu_torch.sampling.likelihood as tlik
import beso_tpu_torch.sampling.samplers as tsamplers
from beso_tpu.core.schedules import get_noise_schedule
from beso_tpu.sampling import dpm_solver as jdpm
from beso_tpu.sampling import samplers as jsamplers
from beso_tpu.sampling.lms import lms_coefficient_matrix as jax_lms
from beso_tpu.sampling.likelihood import log_likelihood as jax_ll
from beso_tpu.sampling.parallel import sample_picard as jax_picard
from beso_tpu_torch.sampling import dpm_solver as tdpm
from beso_tpu_torch.sampling.lms import lms_coefficient_matrix
from beso_tpu_torch.sampling.likelihood import log_likelihood
from beso_tpu_torch.sampling.parallel import sample_picard

TOL = dict(atol=1e-5, rtol=1e-5)
SIGMA_D = 0.5
KEY = jax.random.PRNGKey(7)
GRIDS = {"exp3": get_noise_schedule(3, 0.005, 1.0, 5.0, "exponential"),
         "karras8": get_noise_schedule(8, 0.01, 2.0, 7.0, "karras")}


def gaussian(lib):
    """The exact denoiser of N(0, sigma_d^2) data."""
    def den(x, sig):
        s = sig[:, None, None]
        return x * SIGMA_D ** 2 / (s ** 2 + SIGMA_D ** 2)
    return den


def tanh_standin(lib):
    def den(x, sig):
        return lib.tanh(x) * (0.5 + sig[:, None, None])
    return den


DENOISERS = {"gaussian": gaussian, "tanh": tanh_standin}


def x0(seed=0, shape=(5, 4, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def inject(monkeypatch, name="euler"):
    inject_sampler_draws(monkeypatch, KEY, name)


@pytest.mark.parametrize("den", sorted(DENOISERS))
@pytest.mark.parametrize("name", jsamplers.SAMPLERS)
def test_sample_loop_matches_jax(name, den, monkeypatch):
    inject(monkeypatch, name)
    x, sig = x0(), GRIDS["exp3"]
    ref = jsamplers.sample_loop(name, DENOISERS[den](jnp), jnp.asarray(x), sig, KEY)
    got = tsamplers.sample_loop(name, DENOISERS[den](torch), t(x), sig, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["euler", "heun", "dpm", "lms", "ancestral",
                                  "euler_ancestral", "dpmpp_2s_ancestral", "dpmpp_2s",
                                  "dpmpp_2m", "dpmpp_2m_sde", "dpmpp_2m_sde_fixed"])
def test_churn_and_clip_on_a_long_grid_match_jax(name, monkeypatch):
    """karras 8-step grid; churn where the sampler takes it (s_tmin cuts
    the churn off below sigma 0.05), a clip_fn, eta 0.7 for the ancestral
    and SDE ones."""
    inject(monkeypatch, name)
    x, sig = x0(1), GRIDS["karras8"]
    churn = dict(s_churn=1.5, s_tmin=0.05) if name in ("euler", "heun", "dpm") else {}
    eta = {} if churn or name in ("lms", "dpmpp_2s", "dpmpp_2m") else dict(eta=0.7)

    def run(lib, fn_mod, xx):
        clip = ((lambda v: jnp.clip(v, -0.9, 0.9)) if lib is jnp
                else (lambda v: torch.clamp(v, -0.9, 0.9)))
        return fn_mod.sample_loop(name, DENOISERS["tanh"](lib), xx, sig,
                                  KEY if lib is jnp else None, clip_fn=clip, **churn, **eta)

    ref = run(jnp, jsamplers, jnp.asarray(x))
    got = run(torch, tsamplers, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if name not in ("dpmpp_2m_sde",):   # its last step is unclipped Euler, as in JAX
        assert got.abs().max() <= 0.9


def test_euler_visualization_matches_jax(monkeypatch):
    inject(monkeypatch)
    x, sig = x0(2), GRIDS["karras8"]
    kw = dict(s_churn=0.8)
    ref, ref_xs = jsamplers.sample_euler_visualization(gaussian(jnp), jnp.asarray(x), sig,
                                                       KEY, **kw)
    got, xs = tsamplers.sample_euler_visualization(gaussian(torch), t(x), sig, None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert xs.shape == (8, 5, 4, 3)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref_xs), **TOL)


@pytest.mark.parametrize("update", ["ddim", "euler"])
@pytest.mark.parametrize("K", [None, 3])
def test_picard_matches_jax(update, K):
    """Held to JAX's sweeps with a clip_fn; K = n without one reproduces
    the sequential sampler."""
    x, sig = x0(3), GRIDS["karras8"]
    ref = jax_picard(tanh_standin(jnp), jnp.asarray(x), sig, update=update, n_iterations=K,
                     clip_fn=lambda v: jnp.clip(v, -2.0, 2.0))
    got = sample_picard(tanh_standin(torch), t(x), sig, update=update, n_iterations=K,
                        clip_fn=lambda v: torch.clamp(v, -2.0, 2.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if K is None:
        seq = tsamplers.sample_loop(update, tanh_standin(torch), t(x), sig)
        np.testing.assert_allclose(sample_picard(tanh_standin(torch), t(x), sig,
                                                 update=update).numpy(), seq.numpy(), **TOL)
    with pytest.raises(ValueError, match="unsupported update"):
        sample_picard(tanh_standin(torch), t(x), sig, update="heun")


@pytest.mark.parametrize("n", [4, 6, 7])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_dpm_fast_matches_jax(n, eta, monkeypatch):
    inject(monkeypatch)
    x = x0(4)
    ref = jdpm.sample_dpm_fast(tanh_standin(jnp), jnp.asarray(x), 0.01, 1.5, n, KEY, eta=eta)
    got = tdpm.sample_dpm_fast(tanh_standin(torch), t(x), 0.01, 1.5, n, None, eta=eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("den", sorted(DENOISERS))
@pytest.mark.parametrize("order, eta", [(3, 0.0), (2, 0.0), (3, 0.4)])
def test_dpm_adaptive_matches_jax(den, order, eta, monkeypatch):
    """Output and the accepted / rejected step counts; at eta > 0 the JAX
    iteration i draws from its i-th key split."""
    keys, k = [], KEY
    for _ in range(64):
        k, sub = jax.random.split(k)
        keys.append(sub)
    monkeypatch.setattr(tsamplers, "sampler_noise", lambda x, gen, step, part=0: t(
        np.asarray(jax.random.normal(keys[step], tuple(x.shape)))))
    x = x0(5)
    ref, info = jdpm.sample_dpm_adaptive(DENOISERS[den](jnp), jnp.asarray(x), 0.01, 1.0, KEY,
                                         order=order, eta=eta, return_info=True)
    got, tinfo = tdpm.sample_dpm_adaptive(DENOISERS[den](torch), t(x), 0.01, 1.0, None,
                                          order=order, eta=eta, return_info=True)
    assert tinfo == {k: int(v) for k, v in info.items()}
    assert tinfo["n_accept"] > 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ancestral_step_and_unknown_sampler():
    for eta in (0.0, 0.5, 1.0):
        ref = jsamplers.get_ancestral_step(jnp.float32(0.8), jnp.float32(0.3), eta)
        got = tsamplers.get_ancestral_step(0.8, 0.3, eta)
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(ref, np.float32), rtol=1e-6)
    with pytest.raises(ValueError, match="desired sampler type not found"):
        tsamplers.sample_loop("no_such", gaussian(torch), t(x0()), GRIDS["exp3"])
    assert tsamplers.SAMPLERS == jsamplers.SAMPLERS


@pytest.mark.parametrize("order", [2, 4])
def test_lms_coefficients_match_jax(order):
    for sig in GRIDS.values():
        np.testing.assert_allclose(lms_coefficient_matrix(sig, order), jax_lms(sig, order),
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="too high"):
        from beso_tpu_torch.sampling.lms import linear_multistep_coeff
        linear_multistep_coeff(3, GRIDS["exp3"], 1, 0)


def test_log_likelihood_matches_jax(monkeypatch):
    """The tanh stand-in (a non-trivial divergence) at 16 RK4 steps, JAX's
    Rademacher probe injected; and the Gaussian case against its closed
    form."""
    x = x0(6)
    v = (jax.random.randint(KEY, x.shape, 0, 2) * 2 - 1).astype(jnp.float32)
    monkeypatch.setattr(tlik, "rademacher_probe", lambda a, gen: t(np.asarray(v)))
    ref, info = jax_ll(tanh_standin(jnp), jnp.asarray(x), 0.01, 5.0, KEY, n_steps=16)
    got, tinfo = log_likelihood(tanh_standin(torch), t(x), 0.01, 5.0, None, n_steps=16)
    assert tinfo == info
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    monkeypatch.undo()
    # N(0, sigma_d^2 + sigma_min^2) data: its exact log density, with the
    # port's own probe (the divergence of a linear drift is probe-free)
    ll, _ = log_likelihood(gaussian(torch), t(x), 1e-3, 50.0,
                           torch.Generator().manual_seed(0), n_steps=128)
    var = SIGMA_D ** 2 + 1e-6
    exact = (-0.5 * (x.reshape(5, -1) ** 2).sum(1) / var
             - 0.5 * 12 * np.log(2 * np.pi * var))
    np.testing.assert_allclose(ll.numpy(), exact, rtol=1e-3)
