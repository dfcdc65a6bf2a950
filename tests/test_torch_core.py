"""Schedules, EDM scalings, scaler, synthetic data and goals:
`beso_tpu_torch` against `beso_tpu`; and the port's import isolation."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, t

from beso_tpu.core import precond as jprecond
from beso_tpu.core import schedules as jsched
from beso_tpu.data.trajectories import get_split_idx as jsplit
from beso_tpu.data.trajectories import synthetic_kitchen_data as jdata
from beso_tpu.envs.kitchen.goals import multigoal_kitchen_goals as jgoals
from beso_tpu.models.scaler import fit_scaler as jfit
from beso_tpu_torch.core import precond, schedules
from beso_tpu_torch.data.trajectories import get_split_idx, synthetic_kitchen_data
from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
from beso_tpu_torch.models.scaler import fit_scaler

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind", ["exponential", "karras", "linear", "vp",
                                  "cosine_beta", "ve", "iddpm"])
def test_noise_schedules_equal(kind):
    a = schedules.get_noise_schedule(3, 0.005, 1.0, 5.0, kind)
    b = jsched.get_noise_schedule(3, 0.005, 1.0, 5.0, kind)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_polyexponential_equal():
    np.testing.assert_array_equal(
        schedules.get_sigmas_polyexponential(5, 0.005, 1.0, 2.0),
        jsched.get_sigmas_polyexponential(5, 0.005, 1.0, 2.0))


def test_edm_scalings_and_append_dims():
    sig = np.exp(np.random.RandomState(0).uniform(-6, 1, size=16)).astype(np.float32)
    for a, b in zip(precond.edm_scalings(t(sig), 0.5),
                    jprecond.edm_scalings(jnp.asarray(sig), 0.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert precond.append_dims(t(sig), 3).shape == (16, 1, 1)
    with pytest.raises(ValueError):
        precond.append_dims(torch.zeros(2, 3), 1)


@pytest.mark.parametrize("scale_data", [False, True])
def test_scaler_matches(scale_data):
    data = synthetic_kitchen_data(n_traj=8, t_max=40, seed=3)
    obs, act = data.all_observations(), data.all_actions()
    ts = fit_scaler(obs, act, scale_data=scale_data)
    js = jfit(obs, act, scale_data=scale_data)
    rng = np.random.RandomState(1)
    x = rng.randn(5, 2, 30).astype(np.float32)
    y = (3 * rng.randn(5, 9)).astype(np.float32)
    onehot = rng.rand(5, 7).astype(np.float32)
    for name in ("x_bounds", "y_bounds", "x_mean", "y_std"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(ts.scale_input(t(x)).numpy(),
                               np.asarray(js.scale_input(jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(ts.scale_input(t(onehot)).numpy(), onehot)
    np.testing.assert_allclose(ts.clip_action(t(y)).numpy(),
                               np.asarray(js.clip_action(jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(
        ts.inverse_scale_output(t(y)).numpy(),
        np.asarray(js.inverse_scale_output(jnp.asarray(y))), **TOL)


def test_synthetic_data_and_goals_equal():
    a, b = synthetic_kitchen_data(16, 50, seed=7), jdata(16, 50, seed=7)
    for name in ("observations", "actions", "lengths", "onehot_goals"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert get_split_idx(16, 42) == jsplit(16, 42)
    g1, e1 = multigoal_kitchen_goals(a, 2, 40, seed=42)
    g2, e2 = jgoals(b, 2, 40, seed=42)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(e1, e2)


def test_port_imports_no_jax():
    """`beso_tpu_torch` runs where JAX is absent: importing the package and
    its serving path pulls in no jax, flax, yaml or beso_tpu module."""
    code = ("import sys, beso_tpu_torch, beso_tpu_torch.rollout, "
            "beso_tpu_torch.models.fused, beso_tpu_torch.models.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'yaml', 'beso_tpu'))\n"
            "assert 'jax' not in sys.modules, bad\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
