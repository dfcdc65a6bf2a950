"""Kernels B5 and B6's port: the plain versions behind `flash_attention`
against the JAX Pallas kernels (interpret mode, f32), the autograd wiring,
and the wrappers' CPU dispatch.

The CUDA kernels run only on the card: their kernel-vs-plain tests are in
`test_torch_gpu.py`, marked `gpu` (chip_smoke.py runs the same comparison
on the H100).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from beso_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("beso_tpu.ops.flash_attention")

# f32 on the CPU: both sides compute the same products in f32 and differ
# only in summation order (online softmax over 128-key blocks in JAX, one
# logsumexp here)
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(B, H, T, hd, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, hd).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [32, 60])
@pytest.mark.parametrize("T", [16, 131])
def test_forward_matches_jax(T, hd, causal):
    q, k, v = _qkv(2, 2, T, hd, seed=T + hd)
    jo, jlse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  True)
    o, lse = fa.flash_forward(t(q), t(k), t(v), causal)
    assert o.shape == (2, 2, T, hd) and lse.shape == (2, 2, T, 1)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T", [63, 64, 65, 131])
@pytest.mark.parametrize("hd", [15, 18, 20, 60])
def test_f32_narrow_forward_plain_matches_jax(hd, T, causal):
    """The f32 plain forward (o, lse) against `_flash_forward` (Pallas,
    interpret mode) at the shapes the card holds the f32 width-64 forward
    to: hd 15 (odd: its 4-byte `cp.async` form), 18 (2 mod 4: 8-byte
    `cp.async`), 20 (bulk tensor copies, one 32-column box) and 60 (two
    boxes); T 63 and 65 leave a ragged tile, 64 a whole one, 131 a 3-row
    last tile."""
    q, k, v = _qkv(2, 2, T, hd, seed=hd * T + causal)
    jo, jlse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  True)
    o, lse = fa.flash_forward(t(q), t(k), t(v), causal)
    assert o.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [16, 131])
def test_gradients_match_jax(T, causal):
    """dQ, dK and dV through the port's autograd Function (the plain
    versions of the two backward kernels) against jax.grad of the Pallas
    custom VJP, same cotangent."""
    q, k, v, g = _qkv(1, 3, T, 60, seed=7 * T, n=4)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal, interpret=True)
                       * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal=causal) * t(g)).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"d{name} (T={T}, causal={causal})")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [16, 131])
@pytest.mark.parametrize("hd", [60, 15, 20])
def test_backward_kernels_plain_match_jax(hd, T, causal):
    """The plain versions of the two backward kernels, as the autograd
    Function chains them (dQ returns delta, dK/dV takes it), against
    `_flash_attention_bwd` (Pallas, interpret mode) and its delta formula
    (:212-214) on the same forward output, lse and cotangent. hd 15 and 20
    are the small head dims that the f32 width-64 kernels take (hd 15 their
    `cp.async` form) and that the card compares them against."""
    q, k, v, g = _qkv(2, 3, T, hd, seed=11 * T + causal, n=4)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jlse = jfa._flash_forward(jq, jk, jv, causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  True)
    jdq, jdk, jdv = jfa._flash_attention_bwd(causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                             True, (jq, jk, jv, jo, jlse), jg)
    jdelta = jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1, keepdims=True)
    o, lse = t(np.asarray(jo)), t(np.asarray(jlse))
    dq, delta = fa.flash_backward_dq(t(q), t(k), t(v), o, t(g), lse, causal)
    dk, dv = fa.flash_backward_dkv(t(q), t(k), t(v), t(g), lse, delta, causal)
    assert delta.shape == (2, 3, T, 1) and delta.dtype == torch.float32
    for name, got, want in (("delta", delta, jdelta), ("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{name} (hd={hd}, T={T}, causal={causal})")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,T", [
    *(pytest.param(hd, 77, id=str(hd)) for hd in (72, 96, 100, 120, 128)),
    *(pytest.param(hd, T, id=f"{hd}-T{T}") for hd, T in ((80, 65), (66, 65), (120, 131),
                                                         (100, 131)))])
def test_wide_heads_plain_match_jax(hd, T, causal):
    """Head dims above 64 (the kernels' tile width 128): the plain forward
    (o, lse) against `_flash_forward`, and the plain dQ (with delta) and
    dK/dV against `_flash_attention_bwd` (Pallas, interpret mode) and its
    delta formula (:212-214) on the same forward output, lse and cotangent,
    at TOL. hd 72 is the smallest width-128 head dim, 80 the smallest whose
    rows are 16-byte aligned (the bf16 kernels' bulk tensor copies), 100
    and 66 ones whose rows are not (their `cp.async` path and a padded
    tile), 120 the 3-head chunked model's. T 77 leaves a ragged second
    tile, T 65 one row past a tile and T 131 a 3-row last tile: the edges
    the bf16 backward kernels mask on 64-row tiles."""
    q, k, v, g = _qkv(1, 2, T, hd, seed=hd + causal + (T != 77) * T, n=4)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jlse = jfa._flash_forward(jq, jk, jv, causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                  True)
    jdq, jdk, jdv = jfa._flash_attention_bwd(causal, jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K,
                                             True, (jq, jk, jv, jo, jlse), jg)
    o, lse = fa.flash_forward(t(q), t(k), t(v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    jdelta = jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1, keepdims=True)
    o, lse = t(np.asarray(jo)), t(np.asarray(jlse))
    dq, delta = fa.flash_backward_dq(t(q), t(k), t(v), o, t(g), lse, causal)
    dk, dv = fa.flash_backward_dkv(t(q), t(k), t(v), t(g), lse, delta, causal)
    for name, got, want in (("delta", delta, jdelta), ("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"{name} (hd={hd}, T={T}, causal={causal})")


def test_head_dim_above_128_raises_before_the_library_loads():
    """The kernels take head dims up to 128; the check runs before the
    kernel library is built or loaded, so it needs no card."""
    q = torch.zeros(1, 1, 4, 129)
    with pytest.raises(ValueError, match="head dims up to 128"):
        fa._check("flash_forward", q, q, q, {}, {})


def test_backward_pieces_match_autograd_of_plain_attention():
    """The two backward plain versions equal torch autograd through the
    plain forward (dK/dV and dQ of softmax(q k^T / sqrt(hd)) v), and the dQ
    version's delta is rowsum(dO * O)."""
    q, k, v, g = (t(a) for a in _qkv(2, 2, 40, 20, seed=3, n=4))
    qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_forward_reference(qr, kr, vr, True)
    (o * g).sum().backward()
    dq, delta = fa.flash_backward_dq_reference(q, k, v, o.detach(), g, lse.detach())
    dk, dv = fa.flash_backward_dkv_reference(q, k, v, g, lse.detach(), delta)
    np.testing.assert_allclose(delta.numpy(), (g * o.detach()).sum(-1, keepdim=True).numpy(),
                               atol=1e-6, rtol=1e-6)
    for got, want in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_wrappers_cpu_dispatch_counts_no_launch():
    q, k, v = (t(a) for a in _qkv(1, 2, 20, 16, seed=5))
    counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    before = [f.launches for f in counters]
    q.requires_grad_()
    fa.flash_attention(q, k, v).sum().backward()
    assert [f.launches for f in counters] == before
    assert torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_forward(q.detach().to("meta"), k.to("meta"), v.to("meta"))
