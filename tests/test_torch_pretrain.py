"""Parity of the port's encoder pretraining (`beso_tpu_torch/models/
pretrain.py`) and of `validate_vision_e2e`'s pretraining set-up with the
JAX package's.

A few Adam steps of state regression from kitchen renders (f32, 32 px)
with JAX's batch indices, state jitter and probe indices injected through
`pretrain_draws` and JAX's initial weights: the losses, the probe's RMSE
and the trained encoder against `beso_tpu.models.pretrain`; the cosine
schedule against optax's; the CLI's block-push pool, jitter, floor, target
and weight functions against the JAX script's; the graft, including its
refusal of a missing or non-unique "encoder".
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn
from torch_parity import _redraw, t

import beso_tpu.envs.kitchen.camera as jkcam
import beso_tpu.models.pretrain as jpretrain
import beso_tpu_torch.models.pretrain as tpretrain
from beso_tpu.envs.kitchen.env import INIT_QPOS
from beso_tpu_torch.envs.kitchen.camera import render_kitchen_obs_rgb
from beso_tpu_torch.models.convert import params_from_jax, params_to_numpy_tree
from beso_tpu_torch.models.vision_policy import ConvImageEncoder, VisionPolicyGPT

torch.set_num_threads(1)

TOL = 1e-5
FEATURES = (8, 16)
EMBED = 16
BG = np.asarray([0.93, 0.93, 0.91], np.float32)


def _pool(m=40, seed=0):
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(INIT_QPOS, np.float32), (m, 1))
    q[:, :9] += rng.uniform(-0.3, 0.3, (m, 9))
    q[:, 22] = rng.uniform(-0.7, 0.0, m)
    q[:, 19] = rng.uniform(0.0, 0.3, m)
    return q.astype(np.float32)


def jax_render(o):
    return jkcam.render_kitchen_obs_rgb(o, 32, 32) - jnp.asarray(BG)


def port_render(b):
    return render_kitchen_obs_rgb(b, 32, 32) - torch.as_tensor(BG)


def jax_target(b):
    return jnp.concatenate([2.0 * b[..., :9], jnp.sin(b[..., 22:23])], -1)


def port_target(b):
    return torch.cat([2.0 * b[..., :9], torch.sin(b[..., 22:23])], -1)


def jax_weight(b):
    return jnp.concatenate([(jnp.abs(b[..., :9]) < 1.0).astype(jnp.float32),
                            jnp.ones_like(b[..., :1])], -1)


def port_weight(b):
    return torch.cat([(torch.abs(b[..., :9]) < 1.0).float(), torch.ones_like(b[..., :1])], -1)


def inject_pretrain(monkeypatch, key, pool, steps, batch, init_params):
    """JAX's per-step indices and jitter and its probe indices from `key`
    through `pretrain_draws`; JAX's initial weights into the port's net."""
    k_init, k_train = jax.random.split(key)
    m = pool.shape[0]
    idx, jit = [], []
    for k in jax.random.split(k_train, steps):
        k_idx, k_jit = jax.random.split(k)
        idx.append(np.asarray(jax.random.randint(k_idx, (batch,), 0, m)))
        jit.append(np.asarray(jax.random.normal(k_jit, (batch, pool.shape[1]))))
    probe = np.asarray(jax.random.randint(jax.random.fold_in(k_train, 7), (min(512, m),), 0, m))

    def fake(what, n, m_, shape, generator, device, step=0):
        if what == "index":
            return t(idx[step]).long()
        if what == "jitter":
            return t(jit[step])
        return t(probe).long()

    class Net(tpretrain.StateRegressionNet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            params_from_jax(init_params, self)

    monkeypatch.setattr(tpretrain, "pretrain_draws", fake)
    monkeypatch.setattr(tpretrain, "StateRegressionNet", Net)
    return k_init


@pytest.mark.parametrize("custom", [False, True])
def test_pretraining_steps_match_jax(custom, monkeypatch):
    """3 Adam steps (steps_per_call 3, batch 6, cosine schedule, jitter 0.1
    of the pool std) from JAX's initial weights with its draws injected:
    losses, probe RMSE and every trained encoder weight within 1e-5 of max
    |ref|; `custom` with a target_fn (a scaled and a sin-mapped slice) and a
    weight_fn masking out-of-range dims."""
    pool = _pool()
    key = jax.random.PRNGKey(4)
    kw = dict(embed_size=EMBED, features=FEATURES, steps=3, batch_size=6, steps_per_call=3)
    jt, jw = (jax_target, jax_weight) if custom else (None, None)
    pt, pw = (port_target, port_weight) if custom else (None, None)
    target_dim = 10 if custom else 30
    k_init = jax.random.split(key)[0]
    net = jpretrain.StateRegressionNet(obs_dim=target_dim, embed_size=EMBED, features=FEATURES)
    img0 = jax.vmap(jax_render)(jnp.asarray(pool[:2]))
    init = jax.tree.map(np.asarray, _redraw(jax.eval_shape(net.init, k_init, img0), 9))
    monkeypatch.setattr(jpretrain.StateRegressionNet, "init", lambda self, k, x: init)
    jenc, jinfo = jpretrain.pretrain_state_regression(key, pool, jax_render, target_fn=jt,
                                                      weight_fn=jw, **kw)
    inject_pretrain(monkeypatch, key, pool, 3, 6, init)
    tenc_state, tinfo = tpretrain.pretrain_state_regression(None, pool, port_render,
                                                            target_fn=pt, weight_fn=pw, **kw)
    for name in ("first_loss", "final_loss", "rmse_mean"):
        np.testing.assert_allclose(tinfo[name], jinfo[name], rtol=TOL, err_msg=name)
    np.testing.assert_allclose(tinfo["rmse_per_dim"], jinfo["rmse_per_dim"],
                               atol=TOL * np.abs(jinfo["rmse_per_dim"]).max())
    enc = ConvImageEncoder(3, EMBED, FEATURES)
    enc.load_state_dict(tenc_state)
    got = params_to_numpy_tree(enc)["params"]
    start = init["params"]["encoder"]
    for name in ("Conv_0", "Conv_1", "Dense_0"):
        for leaf in ("kernel", "bias"):
            ref = np.asarray(jenc[name][leaf])
            np.testing.assert_allclose(got[name][leaf], ref, atol=TOL * np.abs(ref).max(),
                                       err_msg=f"{name}/{leaf}")
            assert np.abs(ref - start[name][leaf]).max() > 1e-4   # the steps moved it


@pytest.mark.parametrize("count", [0, 1, 7, 50, 99, 100, 140])
def test_cosine_schedule_matches_optax(count):
    """The LambdaLR factor at update `count` (from 0, clamped at the decay
    steps) against `optax.cosine_decay_schedule(lr, 100, 0.01)`."""
    ref = float(optax.cosine_decay_schedule(1e-3, 100, 0.01)(count))
    np.testing.assert_allclose(1e-3 * tpretrain.cosine_decay_factor(count, 100), ref,
                               rtol=TOL)


def _capture_setup(monkeypatch, module, name):
    """Replace `module.name` (the pretraining call) by a stub that records
    its arguments."""
    seen = {}

    def stub(key, pool, render, **kw):
        seen.update(kw, pool=np.asarray(pool))
        return None, {"rmse_mean": 0.0, "rmse_per_dim": np.zeros(1), "first_loss": 0.0,
                      "final_loss": 0.0}

    monkeypatch.setattr(module, name, stub)
    return seen


def test_cli_pretraining_setup_matches_jax(monkeypatch):
    """`validate_vision_e2e`'s block-push pretraining set-up: the pool (the
    demo rows plus their goal pictures, shuffled), the jitter scales, the
    normalization floor and the symmetry-adapted target and weight functions
    against the JAX script's on the same demos."""
    import scripts.validate_vision_e2e as jcli
    import beso_tpu_torch.scripts.validate_vision_e2e as tcli
    from beso_tpu_torch.data.trajectories import synthetic_push_data

    data = synthetic_push_data(n_traj=6, t_max=20, seed=1)
    data = dataclasses.replace(data, observations=data.observations.astype(np.float32))
    ws = argparse.Namespace(full_data=data)
    args = argparse.Namespace(img=32, semantic=False, seed=3, pretrain_steps=2, batch_size=4)
    log = logging.getLogger("test")
    jseen = _capture_setup(monkeypatch, jpretrain, "pretrain_state_regression")
    jcli._pretrain_encoder(args, log, ws, argparse.Namespace(
        embed_size=8, enc_features=(4,), dtype=jnp.float32), kitchen=False)
    tseen = _capture_setup(monkeypatch, tcli, "pretrain_state_regression")
    tcli._pretrain_encoder(args, log, ws, VisionPolicyGPT(
        embed_dim=16, n_layers=1, n_heads=2, img_hw=(32, 32), embed_size=8,
        enc_features=(4,)), False, torch.device("cpu"))
    np.testing.assert_array_equal(tseen["pool"], jseen["pool"])
    np.testing.assert_allclose(tseen["jitter_std"], jseen["jitter_std"], rtol=1e-6)
    assert tseen["std_floor"] == jseen["std_floor"] == 0.01
    for key in ("embed_size", "features", "steps", "batch_size"):
        assert tuple(np.atleast_1d(tseen[key])) == tuple(np.atleast_1d(jseen[key])), key
    b = jseen["pool"]
    for fn in ("target_fn", "weight_fn"):
        ref = np.asarray(jseen[fn](jnp.asarray(b)))
        np.testing.assert_allclose(tseen[fn](t(b)).numpy(), ref, atol=1e-6, err_msg=fn)
    w = np.asarray(jseen["weight_fn"](jnp.asarray(b)))
    assert w.shape == (b.shape[0], 14) and (w == 0).any() and (w == 1).any()


def test_graft_matches_jax_and_refuses_ambiguity():
    """The graft loads the pretrained encoder into the policy's unique
    "encoder" (the result equals JAX's grafted tree) and raises where there
    is none or more than one."""
    policy = VisionPolicyGPT(embed_dim=16, n_layers=1, n_heads=2, img_hw=(32, 32),
                             embed_size=8, enc_features=(4, 8),
                             generator=torch.Generator().manual_seed(0))
    before = params_to_numpy_tree(policy)
    enc = ConvImageEncoder(3, 8, (4, 8), generator=torch.Generator().manual_seed(1))
    tpretrain.graft_encoder_params(policy, enc.state_dict())
    ref = jpretrain.graft_encoder_params(before["params"], params_to_numpy_tree(enc)["params"])
    got = params_to_numpy_tree(policy)["params"]
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        np.testing.assert_array_equal(flat[path], leaf)
    with pytest.raises(ValueError, match="exactly one 'encoder'"):
        tpretrain.graft_encoder_params(nn.ModuleDict({"a": policy, "b": VisionPolicyGPT(
            embed_dim=16, n_layers=1, n_heads=2, embed_size=8, enc_features=(4, 8))}),
            enc.state_dict())
    with pytest.raises(ValueError, match="exactly one 'encoder'"):
        tpretrain.graft_encoder_params(nn.Linear(2, 2), enc.state_dict())
    with pytest.raises(ValueError):
        jpretrain.graft_encoder_params({"a": {"encoder": {}}, "b": {"encoder": {}}}, {})
