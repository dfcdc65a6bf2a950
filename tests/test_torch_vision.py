"""Parity of the port's vision models (`beso_tpu_torch/models/vision.py`,
`vision_policy.py`, `VisionDiffusionGPT` and the converter's vision
entries) with the JAX package's.

The weights are flax's tree shapes redrawn from a seeded numpy
RandomState (`torch_parity._redraw`) and copied by `params_from_jax`;
inputs are numpy draws. f32 agrees within 1e-5 of max |ref|, bf16 within
2^-5. The loss and gradients are in `test_torch_vision_grads.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch_parity import _redraw, t

import beso_tpu.envs.kitchen.camera  # noqa: F401  (its jnp constants, made outside any trace)
import beso_tpu.models.vision as jvision
import beso_tpu.models.vision_policy as jvp
from beso_tpu.envs.block_push.env import block_push_obs, block_push_reset
from beso_tpu.envs.kitchen.env import INIT_QPOS
from beso_tpu_torch.models import vision as tvision
from beso_tpu_torch.models import vision_policy as tvp
from beso_tpu_torch.models.convert import params_from_jax, params_to_numpy_tree
from beso_tpu_torch.models.gpt import VisionDiffusionGPT

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -5
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
SMALL = dict(embed_dim=48, n_layers=2, n_heads=2, img_hw=(32, 32), embed_size=16,
             enc_features=(8, 16, 16), attn_pdrop=0.0, resid_pdrop=0.0)


def close(got, ref, frac, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, atol=frac * max(np.abs(ref).max(), 1e-6), rtol=0,
                               err_msg=what)


# ---- the pooling modules and the conv ---------------------------------------

@pytest.mark.parametrize("side", [32, 33])
def test_coordconv_softargmax_and_pools_match_flax(side):
    x = np.random.RandomState(side).randn(3, side, side - 3, 5).astype(np.float32)
    for jm, tm in ((jvision.CoordConv(), tvision.CoordConv()),
                   (jvision.SpatialSoftArgmax(), tvision.SpatialSoftArgmax()),
                   (jvision.GlobalMaxPool2d(), tvision.GlobalMaxPool2d()),
                   (jvision.GlobalAvgPool2d(), tvision.GlobalAvgPool2d())):
        ref = jm.apply({}, jnp.asarray(x))
        close(tm(t(x)).numpy(), ref, F32_TOL, type(tm).__name__)


@pytest.mark.parametrize("side", [32, 33, 8, 7])
def test_conv_same_padding_matches_flax(side):
    """`conv2d_same` against flax `nn.Conv(f, (3, 3), strides=(2, 2))` at an
    even and an odd side: "SAME" puts no row before and one after on an even
    side, one on each side on an odd one, which torch's `padding=1` matches
    only on the odd side."""
    rng = np.random.RandomState(side)
    x = rng.randn(2, side, side, 4).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2))
    params = _redraw(jax.eval_shape(conv.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = np.asarray(conv.apply(params, jnp.asarray(x)))
    w = t(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1))
    b = t(params["params"]["bias"])
    xc = t(x).permute(0, 3, 1, 2)
    got = tvp.conv2d_same(xc, w, b, 2, torch.float32).permute(0, 2, 3, 1).numpy()
    close(got, ref, F32_TOL)
    assert tvp.same_padding(side, 3, 2) == ((0, 1) if side % 2 == 0 else (1, 1))
    sym = (torch.nn.functional.conv2d(xc, w, b, stride=2, padding=1)
           .permute(0, 2, 3, 1).numpy())
    assert sym.shape == ref.shape
    assert np.allclose(sym, ref, atol=1e-4) == (side % 2 == 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("side", [32, 33])
def test_encoder_matches_flax(side, dtype):
    """ConvImageEncoder (CoordConv, three SAME strided convs with tanh GELU,
    the f32 keypoint softmax, the Dense) on [6, side, side, 3] images."""
    jdt, tdt, tol = DTYPES[dtype]
    x = np.random.RandomState(1).rand(6, side, side, 3).astype(np.float32) - 0.5
    jenc = jvp.ConvImageEncoder(16, features=(8, 16, 16), dtype=jdt)
    params = _redraw(jax.eval_shape(jenc.init, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ref = jenc.apply(params, jnp.asarray(x))
    tenc = tvp.ConvImageEncoder(3, 16, (8, 16, 16), tdt)
    params_from_jax(jax.tree.map(np.asarray, params), tenc)
    got = tenc(t(x))
    assert got.dtype == tdt
    close(got.detach().float().numpy(), np.asarray(ref, np.float32), tol)


# ---- the policies -----------------------------------------------------------

def _inputs(kind, B=3, seed=0):
    """Raw observations, actions, goals and sigmas of B windows."""
    rng = np.random.RandomState(seed)
    if kind == "block_push":
        keys = jax.random.split(jax.random.PRNGKey(seed), B * 5)
        obs = np.array(jax.vmap(lambda k: block_push_obs(block_push_reset(k)))(keys))
        obs[:, 6:8] = obs[:, 0:2] + rng.uniform(-0.05, 0.05, (B * 5, 2))
        obs = obs.reshape(B, 5, 16).astype(np.float32)
        goals = obs[:, -1:].copy()
        goals[..., 6:] = 0.0
        acts = rng.randn(B, 5, 2)
    else:
        q = np.tile(np.asarray(INIT_QPOS, np.float32), (B, 6, 1))
        q[..., :9] += rng.uniform(-0.3, 0.3, (B, 6, 9))
        q[..., 22] = rng.uniform(-0.7, 0.0, (B, 6))
        obs, goals = q[:, :4], q[:, 4:]
        acts = rng.randn(B, 4, 9)
    sigma = np.exp(rng.uniform(-3, 0, B))
    return tuple(a.astype(np.float32) for a in (obs, acts, goals, sigma))


def make_policies(kind, dtype="f32", seed=0, **extra):
    """(flax module, numpy params, torch module) with the same weights."""
    jdt, tdt, _ = DTYPES[dtype]
    kw = {**SMALL, **extra}
    jcls, tcls = ((jvp.VisionPolicyGPT, tvp.VisionPolicyGPT) if kind == "block_push"
                  else (jvp.KitchenVisionPolicyGPT, tvp.KitchenVisionPolicyGPT))
    jm = jcls(**kw, dtype=jdt)
    s, a, g, sig = _inputs(kind)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(s), jnp.asarray(a),
                            jnp.asarray(g), jnp.asarray(sig))
    params = jax.tree.map(np.asarray, _redraw(params, seed))
    tm = tcls(**kw, dtype=tdt)
    params_from_jax(params, tm)
    return jm, params, tm


def jax_call(kind, fn, **jit_kw):
    """`fn` jitted for the kitchen policy, op by op for block push: XLA's
    fusion of the block-push camera under jit rounds some silhouette depths
    otherwise than its op-by-op form (22 of 15,360 pixels differ at 32 px),
    and a flipped pixel moves the keypoints; the op-by-op form is the one
    `test_torch_camera.py` holds the port's camera against."""
    return jax.jit(fn, **jit_kw) if kind == "kitchen" else fn


VARIANTS = [("block_push", {}), ("block_push", {"semantic": True}),
            ("block_push", {"goal_stack": True}), ("kitchen", {})]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,extra", VARIANTS)
def test_policy_forward_matches_jax(kind, extra, dtype):
    """The inner-model forward (render, encode, VisionDiffusionGPT) and its
    `uncond` form: 2 layers x 48 wide, 32 px."""
    _, _, tol = DTYPES[dtype]
    jm, params, tm = make_policies(kind, dtype, **extra)
    args = _inputs(kind, seed=1)
    apply = jax_call(kind, jm.apply, static_argnames=("uncond",))
    for uncond in (False, True):
        ref = apply(params, *(jnp.asarray(a) for a in args), uncond=uncond)
        got = tm(*(t(a) for a in args), uncond=uncond)
        assert got.dtype == torch.float32
        close(got.detach().numpy(), ref, tol, f"uncond={uncond}")


def test_vision_diffusion_gpt_goal_dim_default():
    """goal_dim defaults to state_dim - 14 (`beso_tpu/models/gpt.py:286-294`)
    and gives goals their own embedding."""
    m = VisionDiffusionGPT(50, 2, 32, 1, 2, 1, 5)
    assert m.goal_dim == 36 and m.has_goal_emb
    assert VisionDiffusionGPT(50, 2, 32, 1, 2, 1, 5, goal_dim=48).goal_dim == 48


@pytest.mark.parametrize("kind,extra", VARIANTS)
def test_converter_round_trips(kind, extra):
    """params_from_jax then params_to_numpy_tree gives the flax tree back
    exactly (conv kernels [kh, kw, in, out] <-> [out, in, kh, kw])."""
    _, params, tm = make_policies(kind, **extra)
    back = params_to_numpy_tree(tm)
    flat = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    ref = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=jax.tree_util.keystr(path))
