"""The other forms of the fused serving engine, against `beso_tpu`:

- the plain versions of kernels B2 (`fused_layers_prefix_group`), B3
  (`fused_layer_with_prefix`) and B4 (`fused_layer`) against the JAX TPU
  kernels in interpret mode, f32, atol = rtol = 1e-5;
- `make_fused_denoise_fn` (B4) against the JAX engine as
  `tests/test_fused_inference.py` runs it (interpret mode, env_block 8),
  atol 1e-5, rtol 1e-4;
- the wrappers' CPU dispatch.

The cached engine's B2 and B3 forms, the `BESO_LAYER_GROUP` rollout and the
agent's engine choice are in `tests/test_torch_fused_cached_engines.py`.
On the CPU every wrapper runs its plain version; the CUDA kernels are held
against the same plain versions on the card (`tests/test_torch_gpu.py`,
chip_smoke.py phase 8).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (TOL, jax_layer, layer_weights, make_inputs,
                          make_models, port_layer, t)

import beso_tpu.models.fused as jfused
from beso_tpu.ops import fused_layer as jfl
from beso_tpu.sampling.samplers import sample_ddim as jax_ddim
from beso_tpu_torch.models import make_fused_denoise_fn
from beso_tpu_torch.ops import fused_layer as fl
from beso_tpu_torch.sampling.samplers import sample_ddim

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
E = 8           # JAX env_block
PUSH = dict(state_dim=10, action_dim=2, embed_dim=48, n_layers=2, n_heads=4,
            goal_seq_len=1, obs_seq_len=5)


def _to_tdb(a):
    """[B, T, C] -> the JAX phase-split layout [T, C, B]."""
    return jnp.asarray(np.ascontiguousarray(a.transpose(1, 2, 0)))


def _prefix_tdb(a, H):
    """[B, P, D] -> [P, H*hdp, B] with the head dim zero-padded to hdp."""
    B, P, D = a.shape
    hd = D // H
    hdp = jfl.padded_head_dim(hd)
    a = np.pad(a.reshape(B, P, H, hd), [(0, 0)] * 3 + [(0, hdp - hd)])
    return jnp.asarray(a.reshape(B, P, H * hdp).transpose(1, 2, 0))


def _prefix_tl(a, H):
    """[S, B, P, D] -> the token-lanes layout [S, nB, H*hdp, P*E]."""
    S, B, P, D = a.shape
    hd = D // H
    hdp = jfl.padded_head_dim(hd)
    a = np.pad(a.reshape(S, B, P, H, hd), [(0, 0)] * 4 + [(0, hdp - hd)])
    a = a.reshape(S, B // E, E, P, H * hdp).transpose(0, 1, 4, 3, 2)
    return jnp.asarray(a.reshape(S, B // E, H * hdp, P * E))


def _from_tl(a, B, T2):
    """[nB, C, T2*E] -> [B, T2, C]."""
    a = np.asarray(a)
    return a.reshape(B // E, a.shape[1], T2, E).transpose(0, 3, 2, 1).reshape(B, T2, -1)


# ---- kernels: plain versions against the JAX TPU kernels -------------------

@pytest.mark.parametrize("H,hd,T", [(6, 60, 11), (12, 20, 12)])
def test_b4_plain_matches_jax_fused_layer(H, hd, T):
    """Kitchen (6 x 60, 11 tokens) and block-push (12 x 20, 12 tokens) widths."""
    D, B = H * hd, 8
    lw = layer_weights(D, seed=H + T)
    x = np.random.RandomState(T).randn(B, T, D).astype(np.float32)
    ref = jfl.fused_layer(_to_tdb(x), jax_layer(lw, H), n_heads=H, head_dim=hd,
                          env_block=E, interpret=True)
    out = fl.fused_layer_reference(t(x), port_layer(lw, H), n_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(2, 0, 1), **TOL)


@pytest.mark.parametrize("D,H,P,T2", [(48, 2, 3, 8), (40, 4, 2, 10)],
                         ids=["kitchen_like", "push_like"])
def test_b3_plain_matches_jax_fused_layer_with_prefix(D, H, P, T2):
    B = 8
    rng = np.random.RandomState(D + P)
    x, pk, pv = (rng.randn(B, n, D).astype(np.float32) for n in (T2, P, P))
    lw = layer_weights(D, seed=D)
    ref = jfl.fused_layer_with_prefix(
        _to_tdb(x), _prefix_tdb(pk, H), _prefix_tdb(pv, H), jax_layer(lw, H),
        n_heads=H, head_dim=D // H, env_block=E, interpret=True)
    out = fl.fused_layer_with_prefix_reference(t(x), t(pk), t(pv), port_layer(lw, H),
                                               n_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(2, 0, 1), **TOL)


@pytest.mark.parametrize("n_group", [2, 3])
def test_b2_plain_matches_jax_layer_group(n_group):
    """A group of 2 and of 3 layers with the ln_f + head epilogue, sigma row 1."""
    D, H, P, T2, S, M, B = 48, 2, 3, 8, 3, 9, 8
    rng = np.random.RandomState(n_group)
    f = np.float32
    x = rng.randn(B, T2, D).astype(f)
    pks = [rng.randn(S, B, P, D).astype(f) for _ in range(n_group)]
    pvs = [rng.randn(S, B, P, D).astype(f) for _ in range(n_group)]
    lws = [layer_weights(D, seed=10 + i) for i in range(n_group)]
    epi = (rng.rand(D).astype(f) + 0.5, 0.1 * rng.randn(D).astype(f),
           (rng.randn(M, D) / np.sqrt(D)).astype(f), 0.1 * rng.randn(M).astype(f))
    idx = np.asarray([1], np.int32)
    Mp = -(-M // 8) * 8
    jepi = (jnp.asarray(epi[0][:, None]), jnp.asarray(epi[1][:, None]),
            jnp.asarray(np.pad(epi[2], ((0, Mp - M), (0, 0)))),
            jnp.asarray(np.pad(epi[3], (0, Mp - M))[:, None]))
    x_tl = x.reshape(B // E, E, T2, D).transpose(0, 3, 2, 1).reshape(B // E, D, T2 * E)
    jout, jpred = jfl.fused_layers_prefix_tl_v2_group(
        jnp.asarray(x_tl), [_prefix_tl(a, H) for a in pks],
        [_prefix_tl(a, H) for a in pvs], jnp.asarray(idx),
        [jax_layer(lw, H) for lw in lws], n_heads=H, head_dim=D // H,
        suffix_len=T2, epilogue=jepi, interpret=True)
    out, pred = fl.fused_layers_prefix_group_reference(
        t(x), [t(a) for a in pks], [t(a) for a in pvs], t(idx),
        [port_layer(lw, H) for lw in lws], n_heads=H,
        epilogue=fl.FusedEpilogue(*(t(a) for a in epi)))
    np.testing.assert_allclose(out.numpy(), _from_tl(jout, B, T2), **TOL)
    np.testing.assert_allclose(pred.numpy(), _from_tl(jpred, B, T2)[..., :M], **TOL)


def _prefix_case(seed, D=48, H=2, P=3, T2=8, S=3, B=5):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = t(rng.randn(B, T2, D).astype(f))
    pks = [t(rng.randn(S, B, P, D).astype(f)) for _ in range(3)]
    pvs = [t(rng.randn(S, B, P, D).astype(f)) for _ in range(3)]
    layers = [port_layer(layer_weights(D, seed=seed + i), H) for i in range(3)]
    return x, pks, pvs, layers


@pytest.mark.parametrize("name", ["group", "with_prefix", "layer"])
def test_wrappers_cpu_dispatch_and_meta(name):
    """CPU tensors: the plain version, and no launch is counted; any device
    but CPU and CUDA raises."""
    x, pks, pvs, layers = _prefix_case(seed=5)
    idx = torch.tensor([0], dtype=torch.int32)
    call, plain = {
        "group": (lambda x_: fl.fused_layers_prefix_group(x_, pks, pvs, idx, layers,
                                                          n_heads=2),
                  lambda: fl.fused_layers_prefix_group_reference(x, pks, pvs, idx, layers,
                                                                 n_heads=2)),
        "with_prefix": (lambda x_: fl.fused_layer_with_prefix(x_, pks[0][0], pvs[0][0],
                                                              layers[0], n_heads=2),
                        lambda: fl.fused_layer_with_prefix_reference(
                            x, pks[0][0], pvs[0][0], layers[0], n_heads=2)),
        "layer": (lambda x_: fl.fused_layer(x_, layers[0], n_heads=2),
                  lambda: fl.fused_layer_reference(x, layers[0], n_heads=2)),
    }[name]
    wrapper = {"group": fl.fused_layers_prefix_group,
               "with_prefix": fl.fused_layer_with_prefix, "layer": fl.fused_layer}[name]
    before = wrapper.launches
    assert torch.equal(call(x), plain())
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call(x.to("meta"))


# ---- engines ---------------------------------------------------------------

FULL_CASES = {
    "kitchen": (dict(), 8, {}),
    "push": (PUSH, 8, {}),
    "uncond": (dict(), 8, dict(uncond=True)),
    "mlp_head": (dict(linear_output=False), 8, {}),
    "batch5": (PUSH, 5, {}),
}


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_fused_denoise_fn_matches_jax(name):
    over, B, kwargs = FULL_CASES[name]
    kw, jden, params, tden = make_models(seed=41, **over)
    s, a, g, sig = make_inputs(kw, B=B, seed=42)
    jfn = jax.jit(functools.partial(
        jfused.make_fused_denoise_fn(jden, params, env_block=E, interpret=True), **kwargs))
    ref = jfn(*(jnp.asarray(v) for v in (s, a, g, sig)))
    out = make_fused_denoise_fn(tden)(t(s), t(a), t(g), t(sig), **kwargs)
    assert out.shape == (B, kw["obs_seq_len"], kw["action_dim"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ENGINE_TOL)


def test_fused_denoise_fn_in_ddim():
    kw, jden, params, tden = make_models(seed=43, **PUSH)
    s, a, g, _ = make_inputs(kw, B=8, seed=44)
    x = np.random.RandomState(45).randn(*a.shape).astype(np.float32)
    sigmas = np.asarray([1.0, 0.3, 0.05, 0.0], np.float32)
    jfn = jfused.make_fused_denoise_fn(jden, params, env_block=E, interpret=True)
    sj, gj = jnp.asarray(s), jnp.asarray(g)
    ref = jax_ddim(lambda x_, sg: jfn(sj, x_, gj, sg), jnp.asarray(x), jnp.asarray(sigmas))
    fn = make_fused_denoise_fn(tden)
    out = sample_ddim(lambda x_, sg: fn(t(s), x_, t(g), sg), t(x), sigmas)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
