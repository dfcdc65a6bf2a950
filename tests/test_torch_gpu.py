"""Kernel-vs-plain tests of the port's CUDA kernels B5 and B6 (flash
attention forward, dQ, dK/dV) on the card, in bf16 within 2^-5 of max
|ref| (chip_smoke.py's bound). Marked `gpu`: without a card they skip.

This file imports no JAX, so it also runs on the card's host, which has
none: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`.
"""

import numpy as np
import pytest
import torch

from beso_tpu_torch.ops import flash_attention as fa

SHAPES = [((3, 2, 77, 60), True), ((3, 2, 77, 20), False), ((2, 3, 131, 18), True),
          ((1, 2, 2, 60), True), ((2, 2, 128, 64), True)]


def _close(got, ref):
    return (got.float() - ref.float()).abs().max() <= 2 ** -5 * ref.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", SHAPES, ids=[f"{s}-{c}" for s, c in SHAPES])
def test_flash_kernels_match_plain(shape, causal):
    """Forward (o, lse), dQ and dK/dV against the plain versions; hd 18
    takes the kernels' unvectorised load path, T 2 and 128 the tile edges
    (T 2, not 1: with one key dQ and dK are zero in exact arithmetic, and
    both sides give rounding noise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    rng = np.random.RandomState(sum(shape))
    q, k, v, do = (torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)
                   for _ in range(4))
    before = fa.flash_forward.launches
    o, lse = fa.flash_forward(q, k, v, causal)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    dq = fa.flash_backward_dq(q, k, v, do, lse_ref, delta, causal)
    dq_ref = fa.flash_backward_dq_reference(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = fa.flash_backward_dkv_reference(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert fa.flash_forward.launches == before + 1
    for got, ref in ((o, o_ref), (lse, lse_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert _close(got, ref)


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
        fa.flash_backward_dq(x, x, x, x, x[..., :1], x[..., :1])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_backward_dkv(x, x, x, x, x[..., :1], x[..., :1])
