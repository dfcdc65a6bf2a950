"""DiffusionGPT forward: `beso_tpu_torch` against `beso_tpu` (f32, CPU)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import TOL, make_inputs, make_models, t

from beso_tpu_torch.models.gpt import DiffusionGPT

VARIANTS = {
    "linear": {},
    "mlp_head": dict(linear_output=False),
    "goal_emb": dict(goal_dim=12),
    "no_goal": dict(goal_conditioned=False),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("uncond", [False, True])
def test_forward_matches_flax(name, uncond):
    kw, jden, params, tden = make_models(seed=1, **VARIANTS[name])
    s, a, g, sig = make_inputs(kw, B=5, seed=2)
    ref = jden.inner_model.apply(params, jnp.asarray(s), jnp.asarray(a),
                                 jnp.asarray(g), jnp.asarray(sig),
                                 uncond=uncond)
    with torch.no_grad():
        out = tden.inner_model(t(s), t(a), t(g), t(sig), uncond=uncond)
    assert out.dtype == torch.float32 and out.shape == (5, 4, 9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_denoiser_matches_flax():
    kw, jden, params, tden = make_models(seed=3)
    s, a, g, sig = make_inputs(kw, B=6, seed=4)
    ref = jden.apply(params, *(jnp.asarray(v) for v in (s, a, g, sig)))
    out = tden(t(s), t(a), t(g), t(sig))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_init_follows_flax():
    """normal(0, 0.02) embeddings/head/pos_emb, lecun-normal truncated at
    2 std for the block Denses, zero biases, unit LayerNorms."""
    g = torch.Generator().manual_seed(0)
    m = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=96, n_layers=2,
                     n_heads=2, goal_seq_len=2, obs_seq_len=4, generator=g)
    for w in (m.tok_emb.weight, m.action_emb.weight, m.pos_emb,
              m.action_pred.weight):
        assert abs(w.std().item() - 0.02) < 0.004
    std = math.sqrt(1.0 / 96) / 0.87962566103423978
    w = m.blocks[0].attn.qkv.weight
    assert w.abs().max().item() <= 2 * std + 1e-6
    assert abs(w.std().item() - math.sqrt(1.0 / 96)) < 0.01
    assert all(b.abs().max().item() == 0 for b in
               (m.blocks[1].fc.bias, m.tok_emb.bias, m.action_pred.bias))
    assert torch.equal(m.ln_f.weight, torch.ones(96))


def test_bf16_forward_is_close():
    """bf16 compute tracks the f32 forward at bf16 rounding level."""
    kw, _, _, tden = make_models(seed=5)
    s, a, g, sig = (t(v) for v in make_inputs(kw, B=4, seed=6))
    m = tden.inner_model
    with torch.no_grad():
        ref = m(s, a, g, sig)
        m.dtype = torch.bfloat16
        out = m(s, a, g, sig)
    assert out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= 2 ** -5 * ref.abs().max().item()


@pytest.mark.parametrize("over", [{}, dict(obs_seq_len=64, attention="pallas")],
                         ids=["window4_broadcast", "tokens131_flash"])
def test_bf16_forward_matches_flax_bf16(over):
    """bf16 compute on both sides (flax `dtype=bfloat16`), same weights.

    Not bit-equal by design: flax `nn.Dense(dtype=bf16)` rounds the product
    to bf16 and then adds a bf16 bias, while the port's `dense` adds the f32
    bias to the f32-accumulated product and rounds once
    (`beso_tpu_torch/models/gpt.py::dense`, the rounding the CUDA kernels
    use). So the two differ by bf16 rounding carried through the layers:
    bound 2^-5 of max |ref|, and no more than twice flax's own bf16 error
    against its f32 forward (measured ~1% of max |ref| for each)."""
    import jax.numpy as jnp

    from beso_tpu.models import DiffusionGPT as JaxGPT

    kw, _, params, tden = make_models(seed=7, **over)
    s, a, g, sig = make_inputs(kw, B=4, seed=8)
    args = [jnp.asarray(v) for v in (s, a, g, sig)]
    ref = np.asarray(JaxGPT(**kw, dtype=jnp.bfloat16).apply(params, *args))
    ref_f32 = np.asarray(JaxGPT(**kw).apply(params, *args))
    m = tden.inner_model
    m.dtype = torch.bfloat16
    with torch.no_grad():
        out = m(t(s), t(a), t(g), t(sig)).numpy()
    err = np.abs(out - ref).max()
    assert err <= 2 ** -5 * np.abs(ref).max()
    assert err <= 2 * np.abs(ref - ref_f32).max()
