"""Parity of the port's vision policies' EDM loss and gradients with the
JAX package's (`beso_tpu_torch/models/vision_policy.py` through
`GCDenoiser.loss`), on the weights and inputs of `test_torch_vision.py`,
with the sigma, the noise and the CFG goal masks injected into both
packages; and `freeze_encoder`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_vision as tv
import torch
from torch_parity import t

from beso_tpu.models.denoiser import GCDenoiser as JaxDenoiser
from beso_tpu_torch.models.convert import params_to_numpy_tree
from beso_tpu_torch.models.denoiser import GCDenoiser

torch.set_num_threads(1)

B = 3
MASK_P = 0.3


def _draws(kind):
    s, a, g, sig = tv._inputs(kind, B, seed=2)
    rng = np.random.RandomState(3)
    noise = rng.randn(*a.shape).astype(np.float32)
    mask = rng.rand(B, g.shape[1], tv.SMALL["embed_size"]) < MASK_P
    return (s, a, g, noise, sig), mask


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(kind, dtype, grads=True):
    """JAX's loss and (with `grads`) gradient tree (numpy), the CFG mask
    injected through `jax.random.bernoulli` for its one mask draw."""
    jm, params, _ = tv.make_policies(kind, dtype, cond_mask_prob=MASK_P)
    args, mask = _draws(kind)
    jden = JaxDenoiser(jm, sigma_data=0.5)

    def jloss(p):
        return jden.loss(p, *(jnp.asarray(x) for x in args), train=True,
                         rngs={"dropout": jax.random.PRNGKey(0),
                               "cond_mask": jax.random.PRNGKey(1)})

    real = jax.random.bernoulli
    jax.random.bernoulli = lambda key, p, shape: jnp.asarray(mask).reshape(shape)
    try:
        if not grads:
            return float(tv.jax_call(kind, jloss)(params)), None
        jl, jg = tv.jax_call(kind, jax.value_and_grad(jloss))(params)
    finally:
        jax.random.bernoulli = real
    return float(jl), jax.tree.map(np.asarray, jg)["params"]


def port_loss_and_grads(kind, dtype, monkeypatch, freeze=False):
    """The port's loss and model on the same weights and draws, the CFG
    mask injected through `torch.rand` for its one mask draw."""
    _, _, tm = tv.make_policies(kind, dtype, cond_mask_prob=MASK_P, freeze_encoder=freeze)
    args, mask = _draws(kind)
    real_rand = torch.rand

    def fake_rand(shape, *a, **kw):
        if tuple(shape) == mask.shape:
            return torch.where(t(mask), 0.0, 1.0)
        return real_rand(shape, *a, **kw)

    monkeypatch.setattr(torch, "rand", fake_rand)
    loss = GCDenoiser(tm, 0.5).loss(*(t(x) for x in args), train=True)
    loss.backward()
    monkeypatch.undo()
    return loss.detach().numpy(), tm


def grads_as_tree(tm):
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in tm.named_parameters()}
    return params_to_numpy_tree(tm, grads)["params"]


def assert_tree_close(got, ref, frac):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        tv.close(flat_got[path], leaf, frac, jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["block_push", "kitchen"])
def test_loss_and_grads_match_jax(kind, dtype, monkeypatch):
    """The EDM loss within 1e-5 (f32) / 2^-5 (bf16) of JAX's in the same
    dtype; every gradient tensor within that fraction of its max |ref|,
    where the reference is JAX's f32 gradient: in bf16 XLA sums the first
    conv's bias gradient in bf16, 9.5% off its own f32 gradient on the
    block-push policy, while the port's bf16 gradients stay within 2.8% of
    it. The encoder's gradients are not zero."""
    tol = tv.DTYPES[dtype][2]
    loss, tm = port_loss_and_grads(kind, dtype, monkeypatch)
    tv.close(loss, jax_loss_and_grads(kind, dtype, dtype == "f32")[0], tol, "loss")
    got = grads_as_tree(tm)
    assert_tree_close(got, jax_loss_and_grads(kind, "f32")[1], tol)
    assert np.abs(got["encoder"]["Conv_0"]["kernel"]).max() > 0


@pytest.mark.parametrize("kind", ["block_push", "kitchen"])
def test_freeze_encoder_stops_its_gradients(kind, monkeypatch):
    """freeze_encoder: no gradient reaches the encoder (its grads stay None,
    as `jax.lax.stop_gradient` gives JAX's zeros); the loss and the GPT's
    gradients are those of the unfrozen policy (f32)."""
    loss, tm = port_loss_and_grads(kind, "f32", monkeypatch, freeze=True)
    jl, jg = jax_loss_and_grads(kind, "f32")
    assert all(p.grad is None for p in tm.encoder.parameters())
    tv.close(loss, jl, tv.F32_TOL, "loss")
    assert_tree_close(grads_as_tree(tm)["VisionDiffusionGPT_0"], jg["VisionDiffusionGPT_0"],
                      tv.F32_TOL)
