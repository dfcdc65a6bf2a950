"""`policy_predict`'s sampler and action-selection options against
`beso_tpu` for W+2 steps (`torch_parity.check_policy_against_jax`: JAX's
action noise and sampler draws injected; atol = rtol = 1e-5): n = 4 action
samples with the mean, KDE and single aggregations, Picard (ddim and
euler, K = n and K < n, tiled conditioning with CFG and with n samples),
euler with churn and the stochastic dpmpp_2m_sde. The KDE cases run on a
denoiser averaged over the action dims (`on_a_line`), whose candidates'
densities differ well above rounding."""

import pytest
from torch_parity import check_policy_against_jax

POLICY_CASES = {
    "mean": dict(n_action_samples=4, aggregation="mean", cond_lambda=1.5),
    "kde": dict(n_action_samples=4, aggregation="kde"),
    "single_of_4": dict(n_action_samples=4, aggregation="single"),
    "picard": dict(sampler_type="picard", num_sampling_steps=4, cond_lambda=1.5),
    "picard_euler_k2": dict(sampler_type="picard", num_sampling_steps=4,
                            picard_update="euler", picard_iterations=2),
    "picard_mean": dict(sampler_type="picard", n_action_samples=4, aggregation="mean"),
    "euler_churn_mean": dict(sampler_type="euler", s_churn=1.0, n_action_samples=4,
                             aggregation="mean"),
    "dpmpp_2m_sde": dict(sampler_type="dpmpp_2m_sde", cond_lambda=1.5),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_options_match_jax(case, monkeypatch):
    cfg = POLICY_CASES[case]
    check_policy_against_jax(cfg, monkeypatch, on_a_line=cfg.get("aggregation") == "kde")
