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
fused engines of an f32 model against the plain f32 engines within 2^-10;
every sampler and Picard through `policy_predict` on B4 against the plain
forward, and the grid samplers on `fused_cached` against `cached`; the
scripted kitchen steps of `kitchen_scenarios.py` against the CPU; the
vision slice: both cameras by pixel share, a vision policy's loss and
gradients and the kitchen oracle (its jacobian in inference mode too)
against the CPU; B5/B6 under a seed axis (`torch.func.vmap`, the seed
sweep's rule): bit-equal to one launch on the folded batch, one launch per
kernel and call; the multi-device layer: a sharded `fused_cached` rollout on
an NCCL rank against one process's rollout of the shard (bit-equal, exact
B1 launches), and the single-device modules (registry ids, xArm IK, env
state I/O, the native loader's stream) on the card; classifier guidance
around `fused_cached` against `cached`, and a `profile_trace` of train
steps that names the three flash kernels. Marked `gpu`:
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
          ((2, 4, 131, 128), True), ((2, 2, 77, 96), False),
          # the f32 width-64 forms at a ragged (63, 65) and a whole (64) tile:
          # hd 18 the 8-byte `cp.async` copies, hd 20 and 60 bulk tensor copies
          *(((2, 3, T, hd), causal) for hd in (18, 20, 60) for T in (63, 64, 65)
            for causal in (True, False))]


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
    and the f32 width-64 kernels' 8-byte and 4-byte `cp.async` form (hd 20
    and 60 their bulk tensor copies); hd 96 and 128 the width-128 ones;
    T 2, 16, 63, 64, 65, 128, 131 and 144 the tile and 16-row chunk edges (T 2, not 1:
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
@pytest.mark.parametrize("hd", [72, 100, 120, 128, 80, 66])
def test_wide_flash_kernels_match_plain(hd, dtype, causal):
    """The tile-width-128 kernels (flash_attention_wide.cu: the forward, dQ
    and dK/dV, each in bf16 and f32) against the plain versions at T of 2
    up to 144: one tile and its ragged edge (2, 16, 63), whole tiles (64),
    one row past a tile (65), the 3-row last tile (131) and a 16-row one
    (144). Odd tile counts leave the f32 forward's last block without its
    second query tile. In bf16, hd 72, 80 (the smallest head dim with
    16-byte rows), 120 and 128 take the three kernels' bulk tensor copies
    (`flash_*_wide_bf16_kernel<true>`), hd 100 and 66 (hdp 80; rows not
    16-byte aligned) their `cp.async` form (`<false>`)."""
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
    ((2, 2, 65, 100), True, torch.bfloat16), ((2, 2, 65, 100), False, torch.float32),
    ((2, 3, 131, 60), True, torch.float32), ((3, 2, 77, 20), False, torch.float32),
    ((2, 2, 50, 15), False, torch.float32), ((2, 3, 65, 18), True, torch.float32),
    ((2, 3, 63, 20), True, torch.float32), ((2, 3, 64, 60), False, torch.float32),
    ((2, 3, 65, 60), True, torch.float32)],
    ids=["131-60-causal", "77-20-full", "131-128-causal", "77-96-full", "131-128-causal-f32",
         "77-96-full-f32", "131-120-causal", "131-120-causal-f32", "65-100-causal",
         "65-100-full-f32", "131-60-causal-f32", "77-20-full-f32", "50-15-full-f32",
         "65-18-causal-f32", "63-20-causal-f32", "64-60-full-f32", "65-60-causal-f32"])
def test_flash_kernels_deterministic(shape, causal, dtype, kernels):
    """Two launches of the forward, or of each backward kernel, on the same
    inputs give bit-equal o and lse, or dq, delta, dk and dv (no atomics).
    hd 20 and 60 reach flash_attention.cu's `mma.sync` kernels in bf16 and
    flash_attention_f32.cu's `wgmma` kernels in f32 (hd 60 and 20 their bulk
    tensor copies, hd 18 and 15 their 8-byte and 4-byte `cp.async` form; T
    63, 64, 65 a ragged, whole and one-row-past tile); hd 96 and above
    flash_attention_wide.cu's `wgmma` ones (bf16 hd 100: the `cp.async`
    form; bf16 hd 96, 120, 128: bulk tensor copies; the bf16 backward's two
    warpgroups add their dQ halves in a fixed order)."""
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


# Resident blocks per SM of the bf16 width-128 backward as designed
# (flash_attention_wide.cu): dQ two 256-thread blocks (128 registers, two
# stages), dK/dV two 128-thread blocks (two stages, 97.5 KB each).
WIDE_BF16_BWD_BLOCKS = {"flash_backward_dq": 2, "flash_backward_dkv": 2}


@pytest.mark.gpu
def test_wide_bf16_backward_blocks_per_sm():
    """The occupancy calculator gives the bf16 width-128 dQ and dK/dV
    kernels at least one resident block per SM, and the count their design
    states."""
    _cuda()
    blocks = fa.blocks_per_sm(torch.bfloat16, 128)
    for name, want in WIDE_BF16_BWD_BLOCKS.items():
        assert blocks[name] >= 1, blocks
        assert blocks[name] == want, blocks


# Resident blocks per SM of the f32 width-64 backward as designed
# (flash_attention_f32.cu): dQ and dK/dV each two 128-thread blocks (one
# warpgroup, a kept pair and two stages, 97 KB each), 8 warps per SM.
F32_NARROW_BWD_BLOCKS = {"flash_backward_dq": 2, "flash_backward_dkv": 2}
WARPS_PER_BLOCK = 4


@pytest.mark.gpu
def test_f32_narrow_backward_blocks_per_sm():
    """The occupancy calculator gives the f32 width-64 dQ and dK/dV kernels
    the resident blocks their design states, and at least 8 warps per SM
    (the `mma.sync` template's two blocks of four)."""
    _cuda()
    blocks = fa.blocks_per_sm(torch.float32, 64)
    for name, want in F32_NARROW_BWD_BLOCKS.items():
        assert blocks[name] == want, blocks
        assert blocks[name] * WARPS_PER_BLOCK >= 8, blocks


# Resident blocks per SM of the f32 width-64 forward as designed
# (flash_attention_f32.cu): two 128-thread blocks (one warpgroup, Q and three
# 32 KB stages, 113 KB each), 8 warps per SM.
F32_NARROW_FWD_BLOCKS = 2


@pytest.mark.gpu
def test_f32_narrow_forward_blocks_per_sm():
    """The occupancy calculator gives the f32 width-64 forward the resident
    blocks its design states, and at least 8 warps per SM."""
    _cuda()
    blocks = fa.blocks_per_sm(torch.float32, 64)
    assert blocks["flash_forward"] == F32_NARROW_FWD_BLOCKS, blocks
    assert blocks["flash_forward"] * WARPS_PER_BLOCK >= 8, blocks


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


def test_forward_ablation_guards_each_part_once(tmp_path):
    """`scripts/ablate_flash_f32_fwd.py` finds each part of the f32
    width-64 forward it switches off exactly once in the kernel's source
    and guards it there, in its own copy (the checkout's source unchanged).
    Needs no card: the copy is only written."""
    from beso_tpu_torch.scripts import ablate_flash_f32_fwd as ab

    src = ab.ROOT / "beso_tpu_torch" / "csrc" / "flash_attention_f32.cu"
    before = src.read_text()
    ab.guarded_sources(tmp_path / "csrc")
    guarded = (tmp_path / "csrc" / "flash_attention_f32.cu").read_text()
    assert src.read_text() == before and "PROBE" not in before
    assert guarded.count("PROBE != ") == 2 * len(ab.GUARDS)
    for _, new in ab.GUARDS:
        assert guarded.count(new) == 1


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


def _policy_setup(dev):
    """A small f32 kitchen-layout model on the card, a scaler, 6 envs' goals
    and W+1 observations."""
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser, fit_scaler

    rng = np.random.RandomState(44)
    model = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=96, n_layers=2, n_heads=2,
                         goal_seq_len=2, obs_seq_len=4, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    scaler = fit_scaler(rng.randn(64, 30), rng.randn(64, 9), False, device=dev)
    goals = torch.as_tensor(rng.randn(6, 2, 30).astype(np.float32)).to(dev)
    obs_seq = [torch.as_tensor(rng.randn(6, 30).astype(np.float32)).to(dev) for _ in range(5)]
    return GCDenoiser(model, sigma_data=0.5), scaler, goals, obs_seq


def _window(dn, scaler, cfg, goals, obs_seq, dev):
    from beso_tpu_torch.agents.policy import policy_predict, policy_reset

    gen = torch.Generator(dev).manual_seed(3)
    state, acts = policy_reset(goals.shape[0], cfg, dev), []
    for obs in obs_seq:
        a, state = policy_predict(dn, scaler, state, obs, goals, gen, cfg)
        acts.append(a)
    return torch.stack(acts)


@pytest.mark.gpu
def test_every_sampler_on_b4_matches_plain_forward():
    """chip_smoke.py phase 14a's uncached engine at 6 envs: a W+1-step
    policy window (lambda=1.5 CFG) for every sampler and Picard on B4
    against the plain forward, within 2^-10 of max |ref|, the same
    generator seed, exactly 2 B4 launches per denoiser call."""
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.models import make_fused_denoise_fn
    from beso_tpu_torch.sampling.samplers import SAMPLERS

    dev = _cuda()
    den, scaler, goals, obs_seq = _policy_setup(dev)
    b4 = make_fused_denoise_fn(den)
    for name in SAMPLERS + ("picard",):
        cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, sampler_type=name,
                           cond_lambda=1.5)
        calls = [0]

        def counted(*a, **kw):
            calls[0] += 1
            return b4(*a, **kw)

        before = fl.fused_layer.launches
        got = _window(counted, scaler, cfg, goals, obs_seq, dev)
        ref = _window(den, scaler, cfg, goals, obs_seq, dev)
        torch.cuda.synchronize()
        assert fl.fused_layer.launches - before == 2 * calls[0], name
        assert _close(got, ref, 2 ** -10), name


@pytest.mark.gpu
def test_grid_samplers_on_fused_cached_match_cached():
    """chip_smoke.py phase 14a's cached engines at 6 envs: the grid samplers
    (ddim, euler, dpmpp_2m, lms) on `fused_cached` (B1) against the plain
    `cached` engine, within 2^-10 of max |ref|, exactly 2 B1 launches per
    denoiser call."""
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.models import make_rollout_denoise_factory
    from beso_tpu_torch.models.cached import CACHED_SAFE_SAMPLERS

    dev = _cuda()
    den, scaler, goals, obs_seq = _policy_setup(dev)
    for name in CACHED_SAFE_SAMPLERS:
        cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, sampler_type=name,
                           cond_lambda=1.5)
        fused, plain = (make_rollout_denoise_factory(den, scaler, cfg, engine=e)(goals)
                        for e in ("fused_cached", "cached"))
        calls = [0]

        def counted(*a, **kw):
            calls[0] += 1
            return fused(*a, **kw)

        before = fl.fused_layer_prefix.launches
        got = _window(counted, scaler, cfg, goals, obs_seq, dev)
        ref = _window(plain, scaler, cfg, goals, obs_seq, dev)
        torch.cuda.synchronize()
        assert fl.fused_layer_prefix.launches - before == 2 * calls[0], name
        assert _close(got, ref, 2 ** -10), name


@pytest.mark.gpu
def test_scripted_kitchen_steps_on_card_match_cpu():
    """chip_smoke.py phase 14d: the scripted batch of `kitchen_scenarios`
    (microwave drags, kettle grasps, tracking and release; actions found on
    the CPU) replayed by `kitchen_step` on the card: states within 1e-5 of
    the CPU's, the same grasps, and every golden band held on the card."""
    import kitchen_scenarios

    script = kitchen_scenarios.script_kitchen_scenarios()
    cpu, card = (kitchen_scenarios.replay(*script, d) for d in ("cpu", _cuda()))
    np.testing.assert_allclose(card.qpos, cpu.qpos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(card.ee, cpu.ee, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(card.grasped, cpu.grasped)
    bands = kitchen_scenarios.kitchen_bands(card)
    assert all(held for held, _ in bands.values()), bands


def _demo_frames(n, rng):
    """n block-push and kitchen observations from the port's oracles (CPU)."""
    from beso_tpu_torch.envs.block_push.oracle import rollout_oracle
    from beso_tpu_torch.envs.kitchen.oracle import rollout_kitchen_oracle

    g = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
    bp = rollout_oracle(8, 60, 0.004, generator=g)[0].reshape(-1, 16)
    k = rollout_kitchen_oracle(8, 60, 4, 0.02, generator=g)[0].reshape(-1, 30)
    return (bp[rng.choice(len(bp), n, replace=False)],
            k[rng.choice(len(k), n, replace=False)])


@pytest.mark.gpu
def test_cameras_on_card_match_cpu():
    """chip_smoke.py phase 15b at 64 oracle frames and 64 x 64 and 128 x 128:
    both cameras' renders on the card against the CPU's, all but 0.5% of
    the pixels within 1e-5 in every channel."""
    from beso_tpu_torch.envs.block_push.camera import render_obs_masks, render_obs_rgb
    from beso_tpu_torch.envs.kitchen.camera import render_kitchen_obs_rgb

    dev = _cuda()
    bp, k = _demo_frames(64, np.random.RandomState(0))
    for render, obs in ((render_obs_rgb, bp), (render_obs_masks, bp),
                        (render_kitchen_obs_rgb, k)):
        for side in (64, 128):
            got = render(obs.to(dev), side, side).cpu()
            ref = render(obs, side, side)
            bad = ((got - ref).abs() > 1e-5).any(-1).float().mean().item()
            assert bad <= 0.005, (render.__name__, side, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["block_push", "kitchen"])
def test_vision_policy_step_on_card_matches_cpu(kind):
    """chip_smoke.py phase 15c at 2 layers x 48 wide, 64 px, batch 4: the
    f32 EDM loss and every gradient of a vision policy on the card against
    the CPU with the same weights, sigma and noise (both encode the CPU's
    renders), within 2^-10 of max |ref|; the bf16 forward within 2^-5 of
    the f32 one."""
    from beso_tpu_torch.models.denoiser import GCDenoiser
    from beso_tpu_torch.models.vision_policy import KitchenVisionPolicyGPT, VisionPolicyGPT

    dev = _cuda()
    rng = np.random.RandomState(1)
    bp, k = _demo_frames(24, rng)
    cls, obs, T, G, A = ((VisionPolicyGPT, bp, 5, 1, 2) if kind == "block_push"
                         else (KitchenVisionPolicyGPT, k, 4, 2, 9))
    kw = dict(embed_dim=48, n_layers=2, n_heads=2, img_hw=(64, 64), embed_size=16,
              enc_features=(8, 16, 16), attn_pdrop=0.0, resid_pdrop=0.0)

    def model(dtype, device):
        return cls(**kw, dtype=dtype, generator=torch.Generator().manual_seed(0)).to(device)

    B = 4
    x = [obs[:B * T].reshape(B, T, -1), torch.as_tensor(rng.uniform(-1, 1, (B, T, A))).float(),
         obs[B * T:B * T + B * G].reshape(B, G, -1), torch.as_tensor(rng.randn(B, T, A)).float(),
         torch.as_tensor(np.exp(rng.uniform(-3, 0, B))).float()]
    cpu, card = model(torch.float32, "cpu"), model(torch.float32, dev)
    card.render = lambda o: cpu.render(o.cpu()).to(dev)
    losses = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        loss = GCDenoiser(m, 0.5).loss(*(a.to(d) for a in x), train=True)
        loss.backward()
        losses.append(loss.detach().cpu())
    assert _close(losses[1], losses[0], 2 ** -10)
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert _close(q.grad.cpu(), p.grad, 2 ** -10), name
    bf = model(torch.bfloat16, dev)
    bf.load_state_dict(cpu.state_dict())
    bf.render = card.render
    with torch.no_grad():
        xd = [a.to(dev) for a in x]
        assert _close(bf(xd[0], xd[1], xd[2], xd[4]), card(xd[0], xd[1], xd[2], xd[4]),
                      2 ** -5)


@pytest.mark.gpu
def test_kitchen_oracle_on_card():
    """The fingertip jacobian on the card equals the CPU's, in inference
    mode too (forward-mode AD is off there); the oracle's 16 episodes x 280
    steps on the card complete >= 3.8 of the 4 assigned tasks
    (tests/test_kitchen_oracle.py's band)."""
    from beso_tpu_torch.envs.kitchen import oracle

    dev = _cuda()
    q = torch.as_tensor(np.random.RandomState(0).uniform(-2, 2, (16, 7)).astype(np.float32))
    ref = oracle.fingertip_jacobian(q)
    with torch.inference_mode():
        got = oracle.fingertip_jacobian(q.to(dev)).cpu()
    assert ref.abs().max() > 0.1 and _close(got, ref, 1e-5)
    _, _, completed, _, seqs = oracle.rollout_kitchen_oracle(
        16, 280, 4, generator=torch.Generator(dev).manual_seed(0), device=dev)
    completed, seqs = completed.cpu(), seqs.cpu()
    assigned = [int(completed[i, s[s >= 0]].sum()) for i, s in enumerate(seqs)]
    assert np.mean(assigned) >= 3.8


SEED_SHAPES = [((4, 256, 6, 131, 60), torch.bfloat16), ((2, 256, 3, 131, 120), torch.bfloat16),
               ((3, 2, 2, 77, 60), torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", SEED_SHAPES,
                         ids=[f"{s}-{str(d)[6:]}" for s, d in SEED_SHAPES])
def test_flash_under_a_seed_axis(shape, dtype):
    """B5/B6 under `torch.func.vmap` over a leading seed axis [S, B, H, T,
    hd] (the sweep's rule): the forward and the backward, outside the map
    (`.backward()`) and inside it (`vmap(grad)`), bit-equal to one launch on
    the folded [S*B, H, T, hd] tensors, and exactly one launch of each
    kernel per call whatever S is; within 2^-5 (bf16) / 2^-12 (f32) of max
    |ref| of the plain versions on the folded tensors."""
    dev = _cuda()
    S, B, H, T, hd = shape
    g = torch.Generator(dev).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    fold = [x.reshape(S * B, H, T, hd) for x in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_forward(*fold[:3])
    dq_ref, delta = fa.flash_backward_dq(*fold[:3], o_ref, fold[3], lse_ref)
    dk_ref, dv_ref = fa.flash_backward_dkv(*fold[:3], fold[3], lse_ref, delta)

    def counts():
        return [f.launches for f in (fa.flash_forward, fa.flash_backward_dq,
                                     fa.flash_backward_dkv)]

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = counts()
    o = torch.func.vmap(fa.flash_attention)(*leaves)
    o.backward(do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1]
    assert torch.equal(o.reshape(S * B, H, T, hd), o_ref)
    for x, ref in zip(leaves, (dq_ref, dk_ref, dv_ref)):
        assert torch.equal(x.grad.reshape(S * B, H, T, hd), ref)

    def f(q, k, v, do):
        return (fa.flash_attention(q, k, v).float() * do.float()).sum()

    before = counts()
    grads = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v, do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1]
    for got, ref in zip(grads, (dq_ref, dk_ref, dv_ref)):
        assert _close(got.reshape(S * B, H, T, hd), ref, FRACTION[dtype])

    plain_o, plain_lse = fa.flash_forward_reference(*fold[:3])
    plain_dq, plain_delta = fa.flash_backward_dq_reference(*fold[:3], plain_o, fold[3],
                                                           plain_lse)
    plain_dk, plain_dv = fa.flash_backward_dkv_reference(*fold[:3], fold[3], plain_lse,
                                                         plain_delta)
    for got, ref in ((o_ref, plain_o), (dq_ref, plain_dq), (dk_ref, plain_dk),
                     (dv_ref, plain_dv)):
        assert _close(got, ref, FRACTION[dtype])


@pytest.mark.gpu
def test_sharded_rollout_on_an_nccl_rank(tmp_path):
    """`rollout_kitchen_sharded` on one NCCL rank (W=1) with `fused_cached`
    in bf16: the metrics bit-equal to one process's rollout on the shard's
    generator, and exactly steps x 3 NFE x layers B1 launches."""
    import torch_dist_workers as workers

    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser, fit_scaler
    from beso_tpu_torch.models.cached import make_rollout_denoise_factory
    from beso_tpu_torch.parallel.launch import spawn
    from beso_tpu_torch.rollout import rollout_kitchen
    from beso_tpu_torch.rollout.sharded import shard_generator

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    kw = dict(state_dim=30, action_dim=9, embed_dim=96, n_layers=2, n_heads=2, goal_seq_len=2,
              obs_seq_len=4, dtype=torch.bfloat16)
    model = DiffusionGPT(**kw, generator=torch.Generator().manual_seed(3))
    data = synthetic_kitchen_data(n_traj=16, t_max=40, seed=0)
    goals, expected = multigoal_kitchen_goals(data, 2, 64, seed=42)
    cfg = dict(window_size=4, obs_dim=30, action_dim=9, cond_lambda=1.5)
    spec = dict(model_kw=kw, state=model.state_dict(), cfg=cfg, obs=data.all_observations(),
                act=data.all_actions(), goals=goals, expected=expected, seed=5, n_steps=4)
    torch.save(spec, tmp_path / "spec.pt")
    spawn(workers.nccl_rollout_worker, 1, "nccl", args=(str(tmp_path),), timeout_s=300)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    dev = torch.device("cuda")
    scaler = fit_scaler(spec["obs"], spec["act"], False, device=dev)
    factory = make_rollout_denoise_factory(GCDenoiser(model.to(dev), 0.5), scaler,
                                           PolicyConfig(**cfg), engine="fused_cached")
    ref = rollout_kitchen(None, scaler, PolicyConfig(**cfg), torch.as_tensor(goals, device=dev),
                          torch.as_tensor(expected, device=dev), shard_generator(5, 0, dev),
                          n_steps=4, denoise_factory=factory)
    for k in ("rewards", "results", "completed", "completion_order"):
        assert got["metrics"][k].equal(getattr(ref, k).cpu()), k
    assert got["launches"] == 4 * 3 * 2


def _single_contact_placement(state, reach):
    """8 single-block envs of a CPU `state` placed for contact, as
    `tests/test_torch_env_extras.py` places JAX's (and chip_smoke.py 17e):
    the effector behind the block pushing toward the target (envs 0-3), the
    block at the INSERT slot's bearings 0-2.5 rad (envs 4-7), env 7 at its
    goal. Returns (state, the action [8, 2] of every step)."""
    block, target = state.block_pos.clone(), state.target_pos
    ang = state.target_yaw[4:8] + torch.tensor([0.0, 0.3, 1.2, 2.5])
    block[4:8] = target[4:8] + 0.045 * torch.stack([ang.cos(), ang.sin()], -1)
    block[7] = target[7]
    d = target - block
    d[7] = torch.tensor([0.0, 1.0])
    d = d / d.norm(dim=-1, keepdim=True)
    eff = block - 0.035 * d
    eff[7] = state.reach_target[7] if reach else target[7] + torch.tensor([0.0, -0.2])
    action = 0.02 * d
    action[7] = 0.0
    return state._replace(effector=eff, effector_target=eff.clone(), block_pos=block), action


@pytest.mark.gpu
def test_single_device_modules_on_card(tmp_path):
    """Every registry id stepped on the card against the CPU (obs and reward
    within 1e-5 absolute and relative, done equal; the single-block ids
    placed for contact, each card step from the CPU's state, since contact
    is chaotic; the multimodal ids free running without contact), xArm IK
    on the card in inference mode to under 1e-3, a CUDA env state saved and
    loaded, the native loader's batches streamed to the card equal to its
    host batches."""
    import math

    from beso_tpu_torch.data.native import NativeSlicedLoader
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.envs import registry
    from beso_tpu_torch.envs.block_push.env import block_push_reset, block_push_step
    from beso_tpu_torch.envs.block_push.single import (ACTION_MAX, ACTION_MIN,
                                                       SingleBlockPushState)
    from beso_tpu_torch.envs.block_push.xarm import xarm_fk_pose, xarm_ik
    from beso_tpu_torch.envs.pose3d import Pose3d, quat_from_rotvec
    from beso_tpu_torch.envs.state_io import load_env_state, save_env_state

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    lo, hi = torch.tensor(ACTION_MIN), torch.tensor(ACTION_MAX)
    rng = np.random.RandomState(0)
    for env_id in registry.registered_ids():
        spec = registry.make(env_id)
        kitchen = env_id.startswith("kitchen")
        cpu = spec.reset_fn(8, torch.Generator().manual_seed(0))
        single = isinstance(cpu, SingleBlockPushState)
        if single:
            cpu, a = _single_contact_placement(cpu, "Reach" in env_id)
            if "Normalized" in env_id:
                a = (a - (hi + lo) * 0.5) / ((hi - lo) * 0.5)
            start, actions = cpu.block_pos.clone(), [a] * 3
        else:
            actions = []
            for _ in range(2):
                a = rng.uniform(-1, 1, (8, 9 if kitchen else 2)).astype(np.float32)
                if not kitchen:
                    a = a * 0.005
                    a[:, 1] = -abs(a[:, 1])
                actions.append(torch.as_tensor(a))
        card = type(cpu)(*(x.to(dev) for x in cpu))
        for a in actions:
            if single:
                card = type(cpu)(*(x.to(dev) for x in cpu))
            card, oc, rc, dc = spec.step_fn(card, a.to(dev))
            cpu, o, r, d = spec.step_fn(cpu, a)
            torch.testing.assert_close(oc.cpu(), o, atol=1e-5, rtol=1e-5, msg=env_id)
            torch.testing.assert_close(rc.cpu(), r, atol=1e-5, rtol=1e-5, msg=env_id)
            assert dc.cpu().equal(d), env_id
        if single:
            assert ((cpu.block_pos - start).norm(dim=-1)[:7] > 1e-3).all(), env_id
    target = Pose3d(quat_from_rotvec(torch.tensor([0.0, math.pi / 2, 0.0], device=dev)),
                    torch.tensor([0.5, 0.0, 0.1], device=dev))
    with torch.inference_mode():
        pose = xarm_fk_pose(xarm_ik(target))
    assert (pose.translation - target.translation).abs().max() < 1e-3
    state = block_push_reset(8, torch.Generator(dev).manual_seed(1), dev)
    state, *_ = block_push_step(state, torch.full((8, 2), 0.01, device=dev))
    save_env_state(state, tmp_path / "s.npz")
    back = load_env_state(block_push_reset(8, None, dev), tmp_path / "s.npz")
    assert all(a.is_cuda and a.equal(b) for a, b in zip(back, state))
    data = synthetic_kitchen_data(n_traj=8, t_max=40, seed=3)
    nl = NativeSlicedLoader(data.observations, data.actions, data.lengths, window=4,
                            future_seq_len=2)
    for k, batch in enumerate(nl.batches(seed=5, batch_size=32, n_batches=4, device=dev)):
        host = nl.sample_batch_host(5, k, 32)
        assert all(batch[n].is_cuda and batch[n].cpu().equal(host[n]) for n in host)


def _tanh_guide(dev, seed=5, hidden=32):
    """A seeded two-layer tanh guide over the last state, every action and
    the last goal (chip_smoke.py phase 18a's)."""
    rng = np.random.RandomState(seed)
    n_in = 30 + 4 * 9 + 30
    W1 = torch.as_tensor((rng.randn(n_in, hidden) / np.sqrt(n_in)).astype(np.float32)).to(dev)
    b1 = torch.as_tensor((0.1 * rng.randn(hidden)).astype(np.float32)).to(dev)
    w2 = torch.as_tensor(rng.randn(hidden).astype(np.float32)).to(dev)

    def guide(s, a, g):
        x = torch.cat([s[:, -1], a.reshape(a.shape[0], -1), g[:, -1]], -1)
        return torch.tanh(x @ W1 + b1) @ w2

    return guide


@pytest.mark.gpu
def test_guided_policy_on_fused_cached_matches_cached():
    """chip_smoke.py phase 18a at 6 envs: `classifier_guided_denoise_fn`
    around the `fused_cached` engine (B1) against the same guide around the
    plain `cached` engine, a W+1-step policy window (lambda=1.5 CFG) inside
    `torch.inference_mode`, within 2^-10 of max |ref|, exactly 2 B1
    launches per denoiser call."""
    from beso_tpu_torch.agents.policy import PolicyConfig
    from beso_tpu_torch.models import make_rollout_denoise_factory
    from beso_tpu_torch.models.cfg import classifier_guided_denoise_fn

    dev = _cuda()
    den, scaler, goals, obs_seq = _policy_setup(dev)
    guide = _tanh_guide(dev)
    cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, cond_lambda=1.5)
    with torch.inference_mode():
        fused, plain = (classifier_guided_denoise_fn(
            make_rollout_denoise_factory(den, scaler, cfg, engine=e)(goals), guide)
            for e in ("fused_cached", "cached"))
        calls = [0]

        def counted(*a, **kw):
            calls[0] += 1
            return fused(*a, **kw)

        before = fl.fused_layer_prefix.launches
        got = _window(counted, scaler, cfg, goals, obs_seq, dev)
        ref = _window(plain, scaler, cfg, goals, obs_seq, dev)
        unguided = _window(make_rollout_denoise_factory(den, scaler, cfg, engine="cached")(
            goals), scaler, cfg, goals, obs_seq, dev)
    torch.cuda.synchronize()
    assert fl.fused_layer_prefix.launches - before == 2 * calls[0]
    assert _close(got, ref, 2 ** -10)
    assert not torch.equal(got, unguided)


@pytest.mark.gpu
def test_profile_trace_names_the_flash_kernels(tmp_path):
    """chip_smoke.py phase 18b at a small width: `profile_trace` around
    fused train steps of a 2-layer bf16 model on the flash path: the Chrome
    trace names B5 and both B6 kernels, exactly layers x steps launches of
    each; `step_timer` writes its record to a `MetricsWriter`."""
    import json

    from beso_tpu_torch.core.densities import make_sample_density
    from beso_tpu_torch.data.slicer import SlicedDataset
    from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
    from beso_tpu_torch.models import DiffusionGPT, GCDenoiser, fit_scaler
    from beso_tpu_torch.train.trainer import Trainer, make_fused_train_steps, make_optimizer
    from beso_tpu_torch.utils.metrics import MetricsWriter, profile_trace, step_timer

    dev = _cuda()
    model = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=96, n_layers=2, n_heads=2,
                         goal_seq_len=2, obs_seq_len=8, attention="pallas",
                         dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).to(dev)
    den = GCDenoiser(model, sigma_data=0.5)
    data = synthetic_kitchen_data(n_traj=16, t_max=40)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), device=dev)
    train_set = SlicedDataset(data, window=8, future_conditional=True, future_seq_len=2,
                              device=dev)
    density = make_sample_density("loglogistic", sigma_data=0.5, sigma_min=0.005,
                                  sigma_max=1.0)
    ts = Trainer(den, make_optimizer, density, scaler).init_state()
    fused = make_fused_train_steps(den, density, scaler, train_set, 16, 3)
    gen = torch.Generator(dev).manual_seed(1)
    ts, _ = fused(ts, gen)     # warm-up
    counters = (fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    before = [f.launches for f in counters]
    writer = MetricsWriter(str(tmp_path))
    with profile_trace(str(tmp_path / "trace")), step_timer(writer, "train", step=3):
        ts, losses = fused(ts, gen)
        torch.cuda.synchronize()
    writer.close()
    assert [f.launches - b for f, b in zip(counters, before)] == [2 * 3] * 3
    assert bool(torch.isfinite(losses).all())
    names = {ev.get("name", "") for ev in json.loads(
        (tmp_path / "trace" / "trace.json").read_text())["traceEvents"]}
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        assert any(kernel in n for n in names), kernel
    (row,) = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert row["_step"] == 3 and row["time/train_s"] > 0
