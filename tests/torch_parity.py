"""Shared helpers for the `beso_tpu_torch` parity tests (test_torch_*.py).

Builds a small DiffusionGPT in both packages with the same weights: flax
gives the tree's shapes (`jax.eval_shape` of its init, so nothing is
computed), every leaf is then drawn from a seeded numpy
RandomState (so the weights are not near-zero and the comparison has
teeth), and `params_from_jax` copies the tree into the torch module.
Inputs are drawn with numpy and handed to both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from beso_tpu.models import DiffusionGPT as JaxGPT
from beso_tpu.models import GCDenoiser as JaxDenoiser
from beso_tpu.ops.fused_layer import padded_head_dim
from beso_tpu_torch.models.convert import params_from_jax
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.ops.fused_layer import prepare_layer_params

torch.set_num_threads(1)

# 2 layers x 48 wide x 2 heads at the kitchen token layout (G=2, window 4)
SMALL = dict(state_dim=30, action_dim=9, embed_dim=48, n_layers=2, n_heads=2,
             goal_seq_len=2, obs_seq_len=4)
TOL = dict(atol=1e-5, rtol=1e-5)


def _redraw(params, seed: int):
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        shape = tuple(a.shape)
        if "scale" in name:                      # LayerNorm gains
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        fan_in = shape[0] if len(shape) == 2 else shape[-1]
        std = 0.1 if "bias" in name else 1.0 / np.sqrt(fan_in)
        return (std * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def make_models(seed: int = 0, **overrides):
    """(kw, jax GCDenoiser, numpy flax params, torch GCDenoiser)."""
    kw = {**SMALL, **overrides}
    jden = JaxDenoiser(JaxGPT(**kw), sigma_data=0.5)
    T, G = kw["obs_seq_len"], kw["goal_seq_len"]
    gdim = kw.get("goal_dim") or kw["state_dim"]
    params = jax.eval_shape(jden.init, jax.random.PRNGKey(seed),
                            jnp.zeros((2, T, kw["state_dim"])),
                            jnp.zeros((2, T, kw["action_dim"])),
                            jnp.zeros((2, G, gdim)), jnp.full((2,), 0.5))
    params = _redraw(params, seed)
    tmodel = DiffusionGPT(**kw)
    params_from_jax(params, tmodel)
    return kw, jden, params, GCDenoiser(tmodel, sigma_data=0.5)


def make_inputs(kw, B: int, seed: int):
    """numpy (states, actions, goals, sigma) for a batch of B."""
    rng = np.random.RandomState(seed)
    T, G = kw["obs_seq_len"], kw["goal_seq_len"]
    gdim = kw.get("goal_dim") or kw["state_dim"]
    f32 = np.float32
    return (rng.randn(B, T, kw["state_dim"]).astype(f32),
            rng.randn(B, T, kw["action_dim"]).astype(f32),
            rng.randn(B, G, gdim).astype(f32),
            np.exp(rng.uniform(-5, 0, size=B)).astype(f32))


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def inject_sampler_draws(monkeypatch, key, name: str = "euler"):
    """Replace the port's `sampler_noise` by the JAX package's draws for
    sampler `name`: step i draws `normal(fold_in(key, i))`, split in two
    (parts 0 and 1) where `sample_dpmpp_sde` splits."""
    import beso_tpu_torch.sampling.samplers as tsamplers

    split = name in ("dpmpp_sde", "dpmpp_2m_sde")

    def noise(x, generator, step, part=0):
        k = jax.random.fold_in(key, step)
        if split:
            k = jax.random.split(k)[part]
        return t(np.asarray(jax.random.normal(k, tuple(x.shape))))

    monkeypatch.setattr(tsamplers, "sampler_noise", noise)


def layer_weights(D: int, seed: int) -> dict:
    """One block's weights in flax orientation ([in, out]) as numpy, under
    `Block.weights()`'s names."""
    rng = np.random.RandomState(seed)
    f = np.float32

    def w(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(f)

    def v(n, base=0.0):
        return (base + 0.1 * rng.randn(n)).astype(f)

    return dict(wqkv=w(D, 3 * D), bqkv=v(3 * D), wproj=w(D, D), bproj=v(D),
                wfc=w(D, 4 * D), bfc=v(4 * D), wfc2=w(4 * D, D), bfc2=v(D),
                ln1_s=v(D, 1.0), ln1_b=v(D), ln2_s=v(D, 1.0), ln2_b=v(D))


def port_layer(lw: dict, n_heads: int, dtype=torch.float32):
    """`layer_weights` in the port's fused-kernel layout."""
    lp = {k: t(a.T) if k.startswith("w") else t(a) for k, a in lw.items()}
    return prepare_layer_params(lp, n_heads, dtype)


def jax_layer(lw: dict, n_heads: int):
    """`layer_weights` in the JAX fused-kernel layout, f32."""
    from beso_tpu.ops.fused_layer import prepare_layer_params as jprepare

    return jprepare(*(jnp.asarray(lw[k]) for k in (
        "wqkv", "bqkv", "wproj", "bproj", "wfc", "bfc", "wfc2", "bfc2",
        "ln1_s", "ln1_b", "ln2_s", "ln2_b")), n_heads=n_heads, dtype=jnp.float32)


E = 8   # env_block of the JAX fused kernels in the parity tests


def to_tdb(a):
    """[B, T, C] -> the JAX phase-split layout [T, C, B]."""
    return jnp.asarray(np.ascontiguousarray(a.transpose(1, 2, 0)))


def prefix_tdb(a, H):
    """[B, P, D] -> [P, H*hdp, B] with the head dim zero-padded to hdp."""
    B, P, D = a.shape
    hd = D // H
    hdp = padded_head_dim(hd)
    a = np.pad(a.reshape(B, P, H, hd), [(0, 0)] * 3 + [(0, hdp - hd)])
    return jnp.asarray(a.reshape(B, P, H * hdp).transpose(1, 2, 0))


def prefix_tl(a, H):
    """[S, B, P, D] -> the token-lanes layout [S, nB, H*hdp, P*E]."""
    S, B, P, D = a.shape
    hd = D // H
    hdp = padded_head_dim(hd)
    a = np.pad(a.reshape(S, B, P, H, hd), [(0, 0)] * 4 + [(0, hdp - hd)])
    a = a.reshape(S, B // E, E, P, H * hdp).transpose(0, 1, 4, 3, 2)
    return jnp.asarray(a.reshape(S, B // E, H * hdp, P * E))


def from_tl(a, B, T2):
    """[nB, C, T2*E] -> [B, T2, C]."""
    a = np.asarray(a)
    return a.reshape(B // E, a.shape[1], T2, E).transpose(0, 3, 2, 1).reshape(B, T2, -1)


def smooth_block_push_hashes(monkeypatch):
    """Replace both packages' block-push dither hash by the same smooth
    function, sin(_HASH_W @ u). The shipped sin-hash moves by up to ~0.1 for
    an ulp of its product, which XLA and torch round differently, so from
    the first contact on the two packages would draw different dithers."""
    import beso_tpu.envs.block_push.env as jenv
    import beso_tpu_torch.envs.block_push.env as tenv

    w = torch.as_tensor(np.asarray(jenv._HASH_W).copy())

    def jax_hash(bpos, byaw, eff):
        return jnp.sin(jenv._HASH_W @ jnp.concatenate([bpos, byaw[None], eff]))

    def torch_hash(bpos, byaw, eff):
        u = torch.cat([bpos, byaw[..., None], eff], -1)
        return torch.sin((w * u[..., None, :]).sum(-1))

    monkeypatch.setattr(jenv, "_hash_noise", jax_hash)
    monkeypatch.setattr(tenv, "_hash_noise", torch_hash)


def check_policy_against_jax(policy_kw: dict, monkeypatch, B: int = 6,
                             on_a_line: bool = False):
    """`policy_predict` of both packages for W+2 steps from the same
    states on `make_models(seed=12)`, the JAX one jitted: actions, buffers
    and counts agree each step. Each step's key draws the action noise of
    all B x n rows and the sampler's draws, which the port is handed
    through `action_noise` and `sampler_noise`.

    `on_a_line` averages the denoiser's output over the action dims, so
    that the candidates lie on a line: in 9 dims, n random candidates are
    far apart against the KDE bandwidth, each density is 1 plus terms near
    the float32 epsilon, and the two members of the closest pair tie up to
    rounding; on a line the densities differ by ~1e-3."""
    from beso_tpu.agents import policy as jpolicy
    from beso_tpu.models.scaler import fit_scaler as jax_fit
    from beso_tpu_torch.agents import policy as tpolicy
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.models.scaler import fit_scaler

    _, jden, params, tden = make_models(seed=12)
    data = synthetic_kitchen_data(n_traj=8, t_max=30, seed=3)
    obs_all, act_all = data.all_observations(), data.all_actions()
    jscaler, scaler = jax_fit(obs_all, act_all, False), fit_scaler(obs_all, act_all, False)
    kw = {**dict(window_size=4, obs_dim=30, action_dim=9, num_sampling_steps=3), **policy_kw}
    jcfg, cfg = jpolicy.PolicyConfig(**kw), tpolicy.PolicyConfig(**kw)
    rng = np.random.RandomState(4)
    goal = rng.randn(B, 2, 30).astype(np.float32)
    noise = {}
    monkeypatch.setattr(tpolicy, "action_noise", lambda b, a, gen, dev: t(noise["now"]))

    def jdn(s, a, g, sig):
        out = jden.apply(params, s, a, g, sig)
        return jnp.broadcast_to(out.mean(-1, keepdims=True), out.shape) if on_a_line else out

    def tdn(s, a, g, sig):
        out = tden(s, a, g, sig)
        return out.mean(-1, keepdim=True).expand(out.shape) if on_a_line else out

    jstep = jax.jit(lambda st, o, k: jpolicy.policy_predict(jdn, jscaler, st, o,
                                                            jnp.asarray(goal), k, jcfg))
    jstate, state = jpolicy.policy_reset(B, jcfg), tpolicy.policy_reset(B, cfg)
    for step in range(cfg.window_size + 2):
        obs = rng.randn(B, 30).astype(np.float32)
        key = jax.random.PRNGKey(100 + step)
        noise["now"] = np.asarray(jax.random.normal(key, (B * cfg.n_action_samples, 9)))
        inject_sampler_draws(monkeypatch, key, cfg.sampler_type)
        jact, jstate = jstep(jstate, jnp.asarray(obs), key)
        act, state = tpolicy.policy_predict(tdn, scaler, state, t(obs), t(goal), None, cfg)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), **TOL)
        for name in ("obs_buf", "act_buf"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), **TOL)
        np.testing.assert_array_equal(state.count.numpy(), np.asarray(jstate.count))
