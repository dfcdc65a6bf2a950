"""Kernel-vs-plain tests of the port's CUDA kernels on the card, in bf16
within 2^-5 of max |ref| (chip_smoke.py's bound): B5 and B6 (flash
attention forward, dQ with delta, dK/dV; the backward also bit-equal from
launch to launch) and the fused layers B1 (at the ragged edge,
block push and with the epilogue, and its timed entry), B2 (layer group),
B3 (one selected prefix row) and B4 (whole causal sequence), which must
also equal B1 launches bit for bit where they compute the same thing.
Marked `gpu`: without a card they skip.

This file imports no JAX, so it also runs on the card's host, which has
none: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`.
"""

import numpy as np
import pytest
import torch

from beso_tpu_torch.ops import flash_attention as fa
from beso_tpu_torch.ops import fused_layer as fl

SHAPES = [((3, 2, 77, 60), True), ((3, 2, 77, 20), False), ((2, 3, 131, 18), True),
          ((1, 2, 2, 60), True), ((2, 2, 128, 64), True), ((2, 3, 131, 60), True),
          ((2, 3, 144, 60), True), ((2, 3, 16, 60), True), ((2, 2, 50, 15), False)]


def _close(got, ref):
    return (got.float() - ref.float()).abs().max() <= 2 ** -5 * ref.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", SHAPES, ids=[f"{s}-{c}" for s, c in SHAPES])
def test_flash_kernels_match_plain(shape, causal):
    """Forward (o, lse), dQ with delta and dK/dV against the plain
    versions, each kernel on the plain forward's o and lse and the plain
    delta; hd 18 takes the backward's 4-byte copies and the forward's
    unvectorised loads, hd 15 plain loads; T 2, 16, 128, 131 and 144 the
    tile and 16-row chunk edges (T 2, not 1: with one key dQ and dK are zero
    in exact arithmetic, and both sides give rounding noise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    rng = np.random.RandomState(sum(shape))
    q, k, v, do = (torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)
                   for _ in range(4))
    before = [f.launches for f in (fa.flash_forward, fa.flash_backward_dq,
                                   fa.flash_backward_dkv)]
    o, lse = fa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
    dq, delta = fa.flash_backward_dq(q, k, v, o_ref, do, lse_ref, causal)
    dq_ref, delta_ref = fa.flash_backward_dq_reference(q, k, v, o_ref, do, lse_ref, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta_ref, causal)
    dk_ref, dv_ref = fa.flash_backward_dkv_reference(q, k, v, do, lse_ref, delta_ref, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in (fa.flash_forward, fa.flash_backward_dq,
                                 fa.flash_backward_dkv)] == [b + 1 for b in before]
    for got, ref in ((o, o_ref), (lse, lse_ref), (dq, dq_ref), (delta, delta_ref), (dk, dk_ref),
                     (dv, dv_ref)):
        assert _close(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", [((2, 3, 131, 60), True), ((3, 2, 77, 20), False)],
                         ids=["131-60-causal", "77-20-full"])
def test_flash_backward_kernels_deterministic(shape, causal):
    """Two launches of each backward kernel on the same inputs give
    bit-equal dq, delta, dk and dv (no atomics)."""
    dev = _cuda()
    rng = np.random.RandomState(len(shape) + shape[2])
    q, k, v, do = (torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, causal)
    runs = []
    for _ in range(2):
        dq, delta = fa.flash_backward_dq(q, k, v, o, do, lse, causal)
        runs.append((dq, delta, *fa.flash_backward_dkv(q, k, v, do, lse, delta, causal)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_autograd_on_card_matches_plain_autograd():
    """Gradients through the autograd Function (kernels) against autograd
    through the plain forward, bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.as_tensor(rng.randn(2, 3, 131, 60).astype(np.float32)).to(dev)
                  for _ in range(4))
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c),
               lambda a, b, c: fa.flash_forward_reference(a, b, c)[0]):
        leaves = [x.to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
        (fn(*leaves).float() * g).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        assert _close(got, ref)


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_backward_dq(x, x, x, x, x, x[..., :1])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_backward_dkv(x, x, x, x, x[..., :1], x[..., :1])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


def _fused_layer(D, H, rng, dev):
    """One layer's random weights in the kernels' layout (bf16 on `dev`)."""
    def w(o, i):
        return torch.as_tensor((rng.randn(o, i) / np.sqrt(i)).astype(np.float32))

    def v(n, base=0.0):
        return torch.as_tensor((base + 0.1 * rng.randn(n)).astype(np.float32))

    lp = dict(wqkv=w(3 * D, D), bqkv=v(3 * D), wproj=w(D, D), bproj=v(D),
              wfc=w(4 * D, D), bfc=v(4 * D), wfc2=w(D, 4 * D), bfc2=v(D),
              ln1_s=v(D, 1.0), ln1_b=v(D), ln2_s=v(D, 1.0), ln2_b=v(D))
    return fl.prepare_layer_params({k: a.to(dev) for k, a in lp.items()}, H)


def _bf16(rng, *shape, dev):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,T", [(360, 6, 11), (240, 12, 12)])
def test_fused_layer_b4_matches_plain(D, H, T):
    """Kitchen and block-push widths; 37 envs leave the last tile ragged."""
    dev = _cuda()
    rng = np.random.RandomState(T)
    p = _fused_layer(D, H, rng, dev)
    x = _bf16(rng, 37, T, D, dev=dev)
    before = fl.fused_layer.launches
    out = fl.fused_layer(x, p, n_heads=H)
    ref = fl.fused_layer_reference(x, p, n_heads=H)
    torch.cuda.synchronize()
    assert fl.fused_layer.launches == before + 1
    assert _close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,P,T2", [(360, 6, 3, 8), (240, 12, 2, 10)])
def test_fused_layer_b3_matches_plain_and_b1(D, H, P, T2):
    dev = _cuda()
    rng = np.random.RandomState(P)
    p = _fused_layer(D, H, rng, dev)
    x = _bf16(rng, 37, T2, D, dev=dev)
    pk, pv = _bf16(rng, 3, 37, P, D, dev=dev), _bf16(rng, 3, 37, P, D, dev=dev)
    idx = torch.tensor([2], dtype=torch.int32, device=dev)
    out = fl.fused_layer_with_prefix(x, pk[2], pv[2], p, n_heads=H)
    ref = fl.fused_layer_with_prefix_reference(x, pk[2], pv[2], p, n_heads=H)
    b1 = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H)
    torch.cuda.synchronize()
    assert _close(out, ref)
    assert torch.equal(out, b1)


@pytest.mark.gpu
@pytest.mark.parametrize("n_group", [2, 4])
@pytest.mark.parametrize("epilogue", [False, True])
def test_fused_layers_b2_matches_plain_and_b1_chain(n_group, epilogue):
    dev = _cuda()
    rng = np.random.RandomState(n_group)
    D, H, P, T2, S, M, B = 360, 6, 3, 8, 3, 9, 37
    layers = [_fused_layer(D, H, rng, dev) for _ in range(n_group)]
    pks = [_bf16(rng, S, B, P, D, dev=dev) for _ in range(n_group)]
    pvs = [_bf16(rng, S, B, P, D, dev=dev) for _ in range(n_group)]
    x = _bf16(rng, B, T2, D, dev=dev)
    idx = torch.tensor([1], dtype=torch.int32, device=dev)
    epi = None
    if epilogue:
        epi = fl.FusedEpilogue(*(torch.as_tensor(a.astype(np.float32)).to(dev) for a in (
            1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), rng.randn(M, D) / np.sqrt(D),
            0.1 * rng.randn(M))))
    got = fl.fused_layers_prefix_group(x, pks, pvs, idx, layers, n_heads=H, epilogue=epi)
    ref = fl.fused_layers_prefix_group_reference(x, pks, pvs, idx, layers, n_heads=H,
                                                 epilogue=epi)
    y = x
    for li in range(n_group):
        last = li == n_group - 1
        chain = fl.fused_layer_prefix(y, pks[li], pvs[li], idx, layers[li], n_heads=H,
                                      epilogue=epi if last else None)
        y = chain[0] if (last and epi is not None) else chain
    torch.cuda.synchronize()
    got, ref, chain = ((v,) if epi is None else v for v in (got, ref, chain))
    for g, r, c in zip(got, ref, chain):
        assert _close(g, r)
        assert torch.equal(g, c)


B1_SHAPES = [(360, 6, 3, 8, 1999), (240, 12, 2, 10, 2000)]


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,P,T2,B", B1_SHAPES, ids=["kitchen-1999", "block_push-2000"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_fused_layer_b1_matches_plain(D, H, P, T2, B, epilogue):
    """Kitchen and block-push widths on every prefix row; 1999 envs of 8
    tokens and 2000 of 10 leave the last 64-row tile part-filled."""
    dev = _cuda()
    rng = np.random.RandomState(B)
    p = _fused_layer(D, H, rng, dev)
    x = _bf16(rng, B, T2, D, dev=dev)
    pk, pv = _bf16(rng, 3, B, P, D, dev=dev), _bf16(rng, 3, B, P, D, dev=dev)
    epi = None
    if epilogue:
        epi = fl.FusedEpilogue(*(torch.as_tensor(a.astype(np.float32)).to(dev) for a in (
            1.0 + 0.1 * rng.randn(D), 0.1 * rng.randn(D), rng.randn(9, D) / np.sqrt(D),
            0.1 * rng.randn(9))))
    for row in range(3):
        idx = torch.tensor([row], dtype=torch.int32, device=dev)
        got = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H, epilogue=epi)
        ref = fl.fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=H, epilogue=epi)
        torch.cuda.synchronize()
        for g, r in zip(*(((v,) if epi is None else v) for v in (got, ref))):
            assert _close(g, r)


@pytest.mark.gpu
def test_fused_layer_b1_timed_equals_b1():
    """The phase-clock entry computes what B1 does, bit for bit, and gives
    every block a positive cycle count per phase it runs; it leaves B1's
    launch count alone."""
    dev = _cuda()
    rng = np.random.RandomState(5)
    p = _fused_layer(360, 6, rng, dev)
    x = _bf16(rng, 2048, 8, 360, dev=dev)
    pk, pv = _bf16(rng, 3, 2048, 3, 360, dev=dev), _bf16(rng, 3, 2048, 3, 360, dev=dev)
    idx = torch.tensor([1], dtype=torch.int32, device=dev)
    before = fl.fused_layer_prefix.launches
    out, cycles = fl.fused_layer_prefix_timed(x, pk, pv, idx, p, n_heads=6)
    assert fl.fused_layer_prefix.launches == before
    ref = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=6)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert cycles.shape == (256, len(fl.PHASES))
    assert bool((cycles[:, :fl.PHASES.index("write") + 1] > 0).all())
