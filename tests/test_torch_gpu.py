"""Kernel-vs-plain tests of the port's CUDA kernels on the card, within
2^-5 of max |ref| in bf16 (chip_smoke.py's bound) and 2^-12 in f32: B5 and
B6 (flash attention forward, dQ with delta, dK/dV, in bf16 and f32, at head
dims up to 128, the tile-width-128 kernels at T from 2 to 144; each kernel
also bit-equal from launch to launch) and the
fused layers B1 (at the ragged edge, block push and with the epilogue, and
its timed entry), B2 (layer group), B3 (one selected prefix row) and B4
(whole causal sequence), in bf16 and f32, which must also equal B1 launches
bit for bit where they compute the same thing, in f32 also at batches that
leave the last 2-block cluster's second block empty, and the f32 phase
clock; their erf GELU forms, and the engines of an erf model; the three
fused engines of an f32 model against the plain f32 engines within 2^-10. Marked `gpu`:
without a card they skip. The dtype rules of the flash wrappers and the
fused engines are also checked on the CPU. The plain f32 references run
with TF32 off (as it is by default).

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
          ((2, 3, 144, 60), True), ((2, 3, 16, 60), True), ((2, 2, 50, 15), False),
          ((2, 4, 131, 128), True), ((2, 2, 77, 96), False)]


# max |diff| bound per element type, as a fraction of max |ref|
FRACTION = {torch.bfloat16: 2 ** -5, torch.float32: 2 ** -12}
DTYPES = dict(argvalues=[torch.bfloat16, torch.float32], ids=["bf16", "f32"])


@pytest.fixture(autouse=True)
def _no_tf32():
    """The plain f32 references compute in full f32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _close(got, ref, frac=FRACTION[torch.bfloat16]):
    return (got.float() - ref.float()).abs().max() <= frac * ref.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,causal", SHAPES, ids=[f"{s}-{c}" for s, c in SHAPES])
def test_flash_kernels_match_plain(shape, causal, dtype):
    """Forward (o, lse), dQ with delta and dK/dV against the plain
    versions, each kernel on the plain forward's o and lse and the plain
    delta; hd 18 takes the bf16 kernels' 4-byte copies, hd 15 plain loads,
    hd 96 and 128 the width-128 instantiations;
    T 2, 16, 128, 131 and 144 the tile and 16-row chunk edges (T 2, not 1:
    with one key dQ and dK are zero in exact arithmetic, and both sides give
    rounding noise). f32 inputs run the f32 kernels and are held to f32
    accuracy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    rng = np.random.RandomState(sum(shape))
    q, k, v, do = (torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
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
        assert got.dtype == ref.dtype
        assert _close(got, ref, FRACTION[dtype])


WIDE_TS = (2, 16, 63, 64, 65, 131, 144)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("hd", [72, 100, 120, 128])
def test_wide_flash_kernels_match_plain(hd, dtype, causal):
    """The tile-width-128 kernels (flash_attention_wide.cu: the forward in
    both dtypes, the f32 dQ and dK/dV; the bf16 backward's width-128
    template) against the plain versions at T of 2 up to 144: one tile and
    its ragged edge (2, 16, 63), whole tiles (64), one row past a tile (65),
    the 3-row last tile (131) and a 16-row one (144). Odd tile counts leave
    the f32 forward's last block without its second query tile; hd 100
    (rows not 16-byte aligned) takes the bf16 forward's `cp.async` path, the
    others its bulk tensor copies."""
    dev = _cuda()
    for T in WIDE_TS:
        rng = np.random.RandomState(hd + T)
        q, k, v, do = (torch.as_tensor(rng.randn(2, 3, T, hd).astype(np.float32)).to(dev, dtype)
                       for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, causal)
        o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
        dq, delta = fa.flash_backward_dq(q, k, v, o_ref, do, lse_ref, causal)
        dq_ref, delta_ref = fa.flash_backward_dq_reference(q, k, v, o_ref, do, lse_ref, causal)
        dk, dv = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta_ref, causal)
        dk_ref, dv_ref = fa.flash_backward_dkv_reference(q, k, v, do, lse_ref, delta_ref, causal)
        torch.cuda.synchronize()
        for name, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                               ("delta", delta, delta_ref), ("dk", dk, dk_ref),
                               ("dv", dv, dv_ref)):
            assert _close(got, ref, FRACTION[dtype]), f"{name} at T={T}"


@pytest.mark.gpu
@pytest.mark.parametrize("kernels", ["forward", "backward"])
@pytest.mark.parametrize("shape,causal,dtype", [
    ((2, 3, 131, 60), True, torch.bfloat16), ((3, 2, 77, 20), False, torch.bfloat16),
    ((2, 4, 131, 128), True, torch.bfloat16), ((2, 2, 77, 96), False, torch.bfloat16),
    ((2, 4, 131, 128), True, torch.float32), ((2, 2, 77, 96), False, torch.float32),
    ((2, 3, 131, 120), True, torch.bfloat16), ((2, 3, 131, 120), True, torch.float32),
    ((2, 2, 65, 100), True, torch.bfloat16), ((2, 2, 65, 100), False, torch.float32)],
    ids=["131-60-causal", "77-20-full", "131-128-causal", "77-96-full", "131-128-causal-f32",
         "77-96-full-f32", "131-120-causal", "131-120-causal-f32", "65-100-causal",
         "65-100-full-f32"])
def test_flash_kernels_deterministic(shape, causal, dtype, kernels):
    """Two launches of the forward, or of each backward kernel, on the same
    inputs give bit-equal o and lse, or dq, delta, dk and dv (no atomics)."""
    dev = _cuda()
    rng = np.random.RandomState(len(shape) + shape[2])
    q, k, v, do = (torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
                   for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, causal)
    runs = []
    for _ in range(2):
        if kernels == "forward":
            runs.append(fa.flash_forward(q, k, v, causal))
        else:
            dq, delta = fa.flash_backward_dq(q, k, v, o, do, lse, causal)
            runs.append((dq, delta, *fa.flash_backward_dkv(q, k, v, do, lse, delta, causal)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [60, 96, 120, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_autograd_on_card_matches_plain_autograd(dtype, hd):
    """Gradients through the autograd Function (kernels) against autograd
    through the plain forward, in bf16 and in f32, at both tile widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    rng = np.random.RandomState(hd)
    q, k, v, g = (torch.as_tensor(rng.randn(2, 3, 131, hd).astype(np.float32)).to(dev)
                  for _ in range(4))
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c),
               lambda a, b, c: fa.flash_forward_reference(a, b, c)[0]):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        (fn(*leaves).float() * g).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        assert got.dtype == dtype
        assert _close(got, ref, FRACTION[dtype])


@pytest.mark.parametrize("dtypes,ok", [
    ((torch.bfloat16,) * 5, True), ((torch.float32,) * 5, True),
    ((torch.float16,) * 5, False), ((torch.float64,) * 3, False),
    ((torch.float32, torch.bfloat16, torch.float32), False),
    ((torch.bfloat16,) * 4 + (torch.float32,), False)],
    ids=["bf16", "f32", "f16", "f64", "mixed-qkv", "mixed-do"])
def test_flash_kernel_dtype_rules(dtypes, ok):
    """The kernels take q, k, v, o and dO all bf16 or all f32; anything else
    raises TypeError (checked before the kernel library loads)."""
    tensors = {n: torch.zeros(1, 1, 2, 8, dtype=d) for n, d in zip(("q", "k", "v", "o", "do"),
                                                                   dtypes)}
    if ok:
        assert fa.kernel_dtype("flash_backward_dq", tensors) == dtypes[0]
    else:
        with pytest.raises(TypeError, match="all bf16 or all f32"):
            fa.kernel_dtype("flash_backward_dq", tensors)


@pytest.mark.parametrize("device,dtype,ok", [
    ("cuda", torch.float32, True), ("cuda", torch.float16, False),
    ("cuda", torch.bfloat16, True), ("cpu", torch.float32, True),
    ("cuda", torch.float64, False)],
    ids=["cuda-f32", "cuda-f16", "cuda-bf16", "cpu-f32", "cuda-f64"])
def test_fused_engines_dtype_check(device, dtype, ok):
    """The fused layer kernels take bf16 and f32 on the card; the CPU runs
    their plain versions in any dtype. Needs no card: only the device's
    type is read."""
    if ok:
        fl.check_fused_dtype(torch.device(device), dtype)
    else:
        with pytest.raises(TypeError, match="bf16 or f32 on the card"):
            fl.check_fused_dtype(torch.device(device), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["fused_cached", "uncached", "agent"])
def test_fused_engines_f32_match_plain_engines(engine):
    """An f32 model on the card: the 'fused_cached' rollout factory, the
    uncached `make_fused_denoise_fn` and the agent's factory with
    inference_engine 'fused_cached' run the f32 fused-layer kernels and
    match the plain f32 engines ('cached', the plain forward) within 2^-10
    of max |ref| at every grid sigma."""
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.models import (DiffusionGPT, GCDenoiser, fit_scaler,
                                       make_fused_denoise_fn, make_rollout_denoise_factory)

    dev = _cuda()
    rng = np.random.RandomState(3)
    data = synthetic_kitchen_data(n_traj=4, t_max=20, seed=0)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), scale_data=False,
                        device=dev)
    cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, sampler_type="ddim",
                       num_sampling_steps=3, cond_lambda=1.5)
    if engine == "agent":
        agent = BesoAgent(BesoAgentConfig(hidden_dim=96, n_layers=2, n_heads=2,
                                          inference_engine="fused_cached"), scaler, device=dev)
        agent.init(torch.Generator().manual_seed(0))
        den = agent.eval_denoiser()
    else:
        model = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=96, n_layers=2, n_heads=2,
                             goal_seq_len=2, obs_seq_len=4, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0)).to(dev)
        den = GCDenoiser(model, sigma_data=0.5)
    assert den.inner_model.dtype == torch.float32
    B = 6
    s, a = (torch.as_tensor(rng.randn(B, 4, n).astype(np.float32)).to(dev) for n in (30, 9))
    goals_raw = torch.as_tensor(rng.randn(B // 2, 2, 30).astype(np.float32)).to(dev)
    g = torch.as_tensor(rng.randn(B, 2, 30).astype(np.float32)).to(dev)
    counters = (fl.fused_layer_prefix, fl.fused_layer)
    before = [c.launches for c in counters]
    if engine == "uncached":
        fused, plain = make_fused_denoise_fn(den), den
    else:
        factory = (agent.make_denoise_factory(cfg) if engine == "agent"
                   else make_rollout_denoise_factory(den, scaler, cfg, engine="fused_cached"))
        fused = factory(goals_raw)
        plain = make_rollout_denoise_factory(den, scaler, cfg, engine="cached")(goals_raw)
    for sg in get_noise_schedule(3, 0.005, 1.0, 5.0, "exponential")[:-1]:
        sig = torch.full((B,), float(sg), device=dev)
        got, ref = fused(s, a, g, sig), plain(s, a, g, sig)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _close(got, ref, 2 ** -10)
    after = [c.launches for c in counters]
    assert after[engine == "uncached"] == before[engine == "uncached"] + 3 * 2


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


def _fused_layer(D, H, rng, dev, dtype=torch.bfloat16):
    """One layer's random weights in the kernels' layout (`dtype` on `dev`)."""
    def w(o, i):
        return torch.as_tensor((rng.randn(o, i) / np.sqrt(i)).astype(np.float32))

    def v(n, base=0.0):
        return torch.as_tensor((base + 0.1 * rng.randn(n)).astype(np.float32))

    lp = dict(wqkv=w(3 * D, D), bqkv=v(3 * D), wproj=w(D, D), bproj=v(D),
              wfc=w(4 * D, D), bfc=v(4 * D), wfc2=w(D, 4 * D), bfc2=v(D),
              ln1_s=v(D, 1.0), ln1_b=v(D), ln2_s=v(D, 1.0), ln2_b=v(D))
    return fl.prepare_layer_params({k: a.to(dev) for k, a in lp.items()}, H, dtype)


def _bf16(rng, *shape, dev, dtype=torch.bfloat16):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D,H,T", [(360, 6, 11), (240, 12, 12)])
def test_fused_layer_b4_matches_plain(D, H, T, dtype):
    """Kitchen and block-push widths; 37 envs leave the last tile ragged."""
    dev = _cuda()
    rng = np.random.RandomState(T)
    p = _fused_layer(D, H, rng, dev, dtype)
    x = _bf16(rng, 37, T, D, dev=dev, dtype=dtype)
    before = fl.fused_layer.launches
    out = fl.fused_layer(x, p, n_heads=H)
    ref = fl.fused_layer_reference(x, p, n_heads=H)
    torch.cuda.synchronize()
    assert fl.fused_layer.launches == before + 1
    assert out.dtype == dtype
    assert _close(out, ref, FRACTION[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D,H,P,T2", [(360, 6, 3, 8), (240, 12, 2, 10)])
def test_fused_layer_b3_matches_plain_and_b1(D, H, P, T2, dtype):
    dev = _cuda()
    rng = np.random.RandomState(P)
    p = _fused_layer(D, H, rng, dev, dtype)
    x = _bf16(rng, 37, T2, D, dev=dev, dtype=dtype)
    pk = _bf16(rng, 3, 37, P, D, dev=dev, dtype=dtype)
    pv = _bf16(rng, 3, 37, P, D, dev=dev, dtype=dtype)
    idx = torch.tensor([2], dtype=torch.int32, device=dev)
    out = fl.fused_layer_with_prefix(x, pk[2], pv[2], p, n_heads=H)
    ref = fl.fused_layer_with_prefix_reference(x, pk[2], pv[2], p, n_heads=H)
    b1 = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H)
    torch.cuda.synchronize()
    assert _close(out, ref, FRACTION[dtype])
    assert torch.equal(out, b1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("n_group", [2, 4])
@pytest.mark.parametrize("epilogue", [False, True])
def test_fused_layers_b2_matches_plain_and_b1_chain(n_group, epilogue, dtype):
    dev = _cuda()
    rng = np.random.RandomState(n_group)
    D, H, P, T2, S, M, B = 360, 6, 3, 8, 3, 9, 37
    layers = [_fused_layer(D, H, rng, dev, dtype) for _ in range(n_group)]
    pks = [_bf16(rng, S, B, P, D, dev=dev, dtype=dtype) for _ in range(n_group)]
    pvs = [_bf16(rng, S, B, P, D, dev=dev, dtype=dtype) for _ in range(n_group)]
    x = _bf16(rng, B, T2, D, dev=dev, dtype=dtype)
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
        assert _close(g, r, FRACTION[dtype])
        assert torch.equal(g, c)


B1_SHAPES = [(360, 6, 3, 8, 1999), (240, 12, 2, 10, 2000)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D,H,P,T2,B", B1_SHAPES, ids=["kitchen-1999", "block_push-2000"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_fused_layer_b1_matches_plain(D, H, P, T2, B, epilogue, dtype):
    """Kitchen and block-push widths on every prefix row; 1999 envs of 8
    tokens and 2000 of 10 leave the last 64-row tile part-filled."""
    dev = _cuda()
    rng = np.random.RandomState(B)
    p = _fused_layer(D, H, rng, dev, dtype)
    x = _bf16(rng, B, T2, D, dev=dev, dtype=dtype)
    pk = _bf16(rng, 3, B, P, D, dev=dev, dtype=dtype)
    pv = _bf16(rng, 3, B, P, D, dev=dev, dtype=dtype)
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
            assert _close(g, r, FRACTION[dtype])


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


@pytest.mark.gpu
def test_fused_layer_b1_f32_timed_equals_b1():
    """The f32 phase-clock entry computes what f32 B1 does, bit for bit,
    gives every block (whole clusters) a positive cycle count per phase it
    runs, and leaves B1's launch count alone."""
    dev = _cuda()
    rng = np.random.RandomState(6)
    f32 = torch.float32
    p = _fused_layer(360, 6, rng, dev, f32)
    x = _bf16(rng, 2048, 8, 360, dev=dev, dtype=f32)
    pk, pv = (_bf16(rng, 3, 2048, 3, 360, dev=dev, dtype=f32) for _ in range(2))
    idx = torch.tensor([1], dtype=torch.int32, device=dev)
    before = fl.fused_layer_prefix.launches
    out, cycles = fl.fused_layer_prefix_timed(x, pk, pv, idx, p, n_heads=6)
    assert fl.fused_layer_prefix.launches == before
    ref = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=6)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert cycles.shape == (256, len(fl.F32_PHASES))
    assert bool((cycles[:, :fl.PHASES.index("write") + 1] > 0).all())


# f32 batches whose tile count is odd, so the last 2-block cluster's second
# block has no rows: 1985 kitchen envs of 8 tokens (249 tiles of 8 envs),
# 1995 block-push envs of 10 (333 tiles of 6), 2041 envs of 11 tokens for B4
# (409 tiles of 5)
EMPTY_BLOCK_CASES = ["b1-kitchen-1985", "b1-block_push-1995", "b3-kitchen-1985",
                     "b4-kitchen-2041", "b2-kitchen-1985"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", EMPTY_BLOCK_CASES)
def test_fused_layers_f32_cluster_with_empty_block(case):
    """The f32 kernels at batches that leave the last cluster's second block
    empty: within 2^-12 of max |ref| of the plain versions, B3 and B2
    bit-equal to B1 launches (the empty block must still take its share of
    the cluster's weight chunks, or its peer would hang)."""
    dev = _cuda()
    kind, name, B = case.split("-")
    B = int(B)
    D, H, P, T2 = (240, 12, 2, 10) if name == "block_push" else (360, 6, 3, 8)
    f32 = torch.float32
    rng = np.random.RandomState(B)
    p = _fused_layer(D, H, rng, dev, f32)
    idx = torch.tensor([1], dtype=torch.int32, device=dev)
    if kind == "b4":
        x = _bf16(rng, B, 11, D, dev=dev, dtype=f32)
        got, ref = fl.fused_layer(x, p, n_heads=H), fl.fused_layer_reference(x, p, n_heads=H)
        torch.cuda.synchronize()
        assert _close(got, ref, FRACTION[f32])
        return
    x = _bf16(rng, B, T2, D, dev=dev, dtype=f32)
    pk, pv = (_bf16(rng, 3, B, P, D, dev=dev, dtype=f32) for _ in range(2))
    b1 = fl.fused_layer_prefix(x, pk, pv, idx, p, n_heads=H)
    if kind == "b1":
        ref = fl.fused_layer_prefix_reference(x, pk, pv, idx, p, n_heads=H)
        torch.cuda.synchronize()
        assert _close(b1, ref, FRACTION[f32])
    elif kind == "b3":
        got = fl.fused_layer_with_prefix(x, pk[1], pv[1], p, n_heads=H)
        ref = fl.fused_layer_with_prefix_reference(x, pk[1], pv[1], p, n_heads=H)
        torch.cuda.synchronize()
        assert _close(got, ref, FRACTION[f32]) and torch.equal(got, b1)
    else:
        p2 = _fused_layer(D, H, rng, dev, f32)
        pk2, pv2 = (_bf16(rng, 3, B, P, D, dev=dev, dtype=f32) for _ in range(2))
        got = fl.fused_layers_prefix_group(x, [pk, pk2], [pv, pv2], idx, [p, p2], n_heads=H)
        ref = fl.fused_layers_prefix_group_reference(x, [pk, pk2], [pv, pv2], idx, [p, p2],
                                                     n_heads=H)
        chain = fl.fused_layer_prefix(b1, pk2, pv2, idx, p2, n_heads=H)
        torch.cuda.synchronize()
        assert _close(got, ref, FRACTION[f32]) and torch.equal(got, chain)


ERF_KERNELS = ["b1", "b2", "b3", "b4"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("kernel", ERF_KERNELS)
def test_fused_layers_erf_match_plain(kernel, dtype):
    """The erf GELU form of B1-B4 (`approximate_gelu=False`) at the kitchen
    width against its plain version (2^-5 bf16, 2^-12 f32), counted in
    `erf_launches`, apart from the tanh form, and in f32 nearer the erf than
    the tanh plain version; B2 and B3 erf bit-equal to B1 erf launches; and
    the tanh form (`approximate_gelu=True`) bit-equal to the launch without
    the argument, the path as it was before the erf form came."""
    dev = _cuda()
    rng = np.random.RandomState(41)
    D, H, P, T2, B = 360, 6, 3, 8, 1999
    erf = dict(approximate_gelu=False)
    p, p2 = _fused_layer(D, H, rng, dev, dtype), _fused_layer(D, H, rng, dev, dtype)
    pk, pv, pk2, pv2 = (_bf16(rng, 3, B, P, D, dev=dev, dtype=dtype) for _ in range(4))
    idx = torch.tensor([1], dtype=torch.int32, device=dev)
    x = _bf16(rng, 2047, 11, D, dev=dev, dtype=dtype)
    x8 = _bf16(rng, B, T2, D, dev=dev, dtype=dtype)
    pk1, pv1 = pk[1].clone(), pv[1].clone()   # row 1 as the engine selects it, aligned
    forms = {   # (wrapper, its launch with keyword args kw, its plain version)
        "b4": (fl.fused_layer, lambda kw: fl.fused_layer(x, p, n_heads=H, **kw),
               lambda kw: fl.fused_layer_reference(x, p, n_heads=H, **kw)),
        "b1": (fl.fused_layer_prefix,
               lambda kw: fl.fused_layer_prefix(x8, pk, pv, idx, p, n_heads=H, **kw),
               lambda kw: fl.fused_layer_prefix_reference(x8, pk, pv, idx, p, n_heads=H, **kw)),
        "b3": (fl.fused_layer_with_prefix,
               lambda kw: fl.fused_layer_with_prefix(x8, pk1, pv1, p, n_heads=H, **kw),
               lambda kw: fl.fused_layer_with_prefix_reference(x8, pk1, pv1, p, n_heads=H,
                                                               **kw)),
        "b2": (fl.fused_layers_prefix_group,
               lambda kw: fl.fused_layers_prefix_group(x8, [pk, pk2], [pv, pv2], idx, [p, p2],
                                                       n_heads=H, **kw),
               lambda kw: fl.fused_layers_prefix_group_reference(
                   x8, [pk, pk2], [pv, pv2], idx, [p, p2], n_heads=H, **kw)),
    }
    wrapper, call, plain_of = forms[kernel]
    plain = plain_of(erf)
    same = None   # the B1 erf launches B3 and B2 must equal
    if kernel in ("b3", "b2"):
        same = fl.fused_layer_prefix(x8, pk, pv, idx, p, n_heads=H, **erf)
        if kernel == "b2":
            same = fl.fused_layer_prefix(same, pk2, pv2, idx, p2, n_heads=H, **erf)
    launches, erf_launches = wrapper.launches, wrapper.erf_launches
    got, again = call(erf), call(erf)
    tanh, tanh_default = call(dict(approximate_gelu=True)), call({})
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.erf_launches) == (launches + 4, erf_launches + 2)
    assert _close(got, plain, FRACTION[dtype])
    assert torch.equal(got, again)
    if same is not None:
        assert torch.equal(got, same)
    assert torch.equal(tanh, tanh_default)
    # the erf and tanh forms differ by less than bf16's rounding and by less
    # than the f32 bound: in bf16 the two launches differ; in f32 the erf
    # launch is nearer the erf plain version than the tanh one
    assert not torch.equal(tanh, got)
    if dtype == torch.float32:
        def err(ref):
            return (got - ref).abs().max()

        assert 4 * err(plain) < err(plain_of({}))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", **DTYPES)
def test_erf_model_engines_launch_erf_kernels(dtype):
    """A `DiffusionGPT(approximate_gelu=False)` on the card: its fused_cached
    engine runs erf B1 launches only and matches the plain cached engine,
    and its uncached engine erf B4 launches, matching the plain forward
    (2^-5 bf16, 2^-10 f32 of max |ref|)."""
    from beso_tpu_torch.core.schedules import get_noise_schedule
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser, make_fused_denoise_fn
    from beso_tpu_torch.models.cached import make_cached_denoise_fn
    from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn

    dev = _cuda()
    rng = np.random.RandomState(43)
    model = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=96, n_layers=2, n_heads=2,
                         goal_seq_len=2, obs_seq_len=4, dtype=dtype, approximate_gelu=False,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    den = GCDenoiser(model, sigma_data=0.5)
    B = 6
    s, a, g = (torch.as_tensor(rng.randn(B, n, d).astype(np.float32)).to(dev)
               for n, d in ((4, 30), (4, 9), (2, 30)))
    frac = 2 ** -10 if dtype == torch.float32 else FRACTION[torch.bfloat16]
    grid = get_noise_schedule(3, 0.005, 1.0, 5.0, "exponential")[:-1]
    fused, plain = make_fused_cached_denoise_fn(den, g, grid), make_cached_denoise_fn(den, g, grid)
    uncached = make_fused_denoise_fn(den)
    counts = [(w.launches, w.erf_launches) for w in (fl.fused_layer_prefix, fl.fused_layer)]
    for sg in grid:
        sig = torch.full((B,), float(sg), device=dev)
        got, ref = fused(s, a, g, sig), plain(s, a, g, sig)
        got4, ref4 = uncached(s, a, g, sig), den(s, a, g, sig)
        torch.cuda.synchronize()
        assert _close(got, ref, frac) and _close(got4, ref4, frac)
    n = 3 * 2
    assert [(w.launches, w.erf_launches) for w in (fl.fused_layer_prefix, fl.fused_layer)] == [
        (c[0] + n, c[1] + n) for c in counts]
