"""DDIM, `policy_predict` (one sample per step, lambda 1 and 1.5) and the
KDE selection against `beso_tpu`, with the JAX action noise injected into
the port through its noise-drawing helper; the Picard bench CLI on the
CPU. `test_torch_policy_options.py` holds the other policy options."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, check_policy_against_jax, t

import beso_tpu_torch.agents.policy as tpolicy
from beso_tpu.agents import policy as jpolicy
from beso_tpu.sampling.samplers import sample_ddim as jax_ddim
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


@pytest.mark.parametrize("name", ["no_such"])
def test_other_samplers_raise(name):
    with pytest.raises(ValueError, match="desired sampler type not found"):
        sample_loop(name, lambda v, s: v, torch.zeros(2, 3), GRID)


@pytest.mark.parametrize("cond_lambda", [1.0, 1.5])
def test_policy_predict_matches_jax(cond_lambda, monkeypatch):
    """W+2 steps: the window fills, then rolls; actions, buffers and
    counts agree each step."""
    check_policy_against_jax(dict(cond_lambda=cond_lambda), monkeypatch)


def test_kde_select_matches_jax():
    """The max-density candidate with the population std bandwidth, on
    candidate sets with a clear mode and a spread one."""
    rng = np.random.RandomState(5)
    cands = rng.randn(6, 5, 3).astype(np.float32)
    cands[:3, :3] = cands[:3, :1] + 0.01 * rng.randn(3, 3, 3).astype(np.float32)
    got = tpolicy._kde_select(t(cands))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpolicy._kde_select(cands)))


def test_bench_picard_runs_on_the_cpu():
    """`python -m beso_tpu_torch.scripts.bench_picard --device cpu` at a tiny
    grid: its JSON record, every time positive."""
    from beso_tpu_torch.scripts import bench_picard

    out = bench_picard.main(["--device", "cpu", "--window", "4", "--batch", "2", "--nfe", "3",
                             "--reps", "1"])
    assert (out["device"], out["tokens"], out["nfe"]) == ("cpu", 11, 3)
    assert all(out[k] > 0 for k in ("sequential_ddim_ms", "picard_k7_ms", "picard_k12_ms"))
