"""`beso_tpu_torch/scripts/profile_train.py` on the CPU: its FLOP count
against a hand count and against torch's own count of the products a train
step runs (`torch.utils.flop_counter.FlopCounterMode`, forward and
backward), the kernel categories, and both modes at a tiny size (the
device numbers come from the card: on the CPU the profile reports them
"not measured")."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from beso_tpu_torch.models import DiffusionGPT, GCDenoiser
from beso_tpu_torch.scripts import profile_train as pt


def test_flop_count_by_hand():
    """A 1-layer D=8 model, 2 heads, G=1 goal token, T=2 states (N = 6
    tokens), state 3, action 2, batch 1, linear head; every product by hand."""
    m = DiffusionGPT(3, 2, 8, 1, 2, 1, 2, attention="broadcast")
    embed = 2 * 8 * (1 + 1 * 3 + 2 * 3 + 2 * 2)            # sigma, goal, states, actions
    block = 2 * 6 * 8 * (3 * 8 + 8 + 4 * 8 + 4 * 8) + 2 * 2 * 6 * 6 * 8   # products, attention
    head = 2 * 2 * 8 * 2
    assert pt.forward_flops(m, 1) == (embed, block + head)
    assert pt.train_step_flops(m, 5) == 5 * (3 * (block + head) + 2 * embed)
    # the flash form computes the causal half of the scores
    _, body = pt.forward_flops(m, 1, attention="pallas")
    assert body == block + head - 4 * (36 - 21) * 8


@pytest.mark.parametrize("kw", [dict(), dict(linear_output=False), dict(goal_dim=12),
                                dict(n_layers=3, n_heads=4, embed_dim=32)],
                         ids=["linear", "mlp_head", "goal_emb", "3_layers"])
def test_flop_count_matches_torch(kw):
    """`train_step_flops` equals FlopCounterMode's count of one loss forward
    and backward on the CPU (broadcast attention), exactly."""
    model = DiffusionGPT(30, 9, kw.pop("embed_dim", 16), kw.pop("n_layers", 2),
                         kw.pop("n_heads", 2), 2, 4, **kw,
                         generator=torch.Generator().manual_seed(0))
    B = 3
    g = torch.Generator().manual_seed(1)
    s, a = torch.randn(B, 4, 30, generator=g), torch.randn(B, 4, 9, generator=g)
    goals = torch.randn(B, 2, model.goal_dim or 30, generator=g)
    with FlopCounterMode(display=False) as counter:
        loss = GCDenoiser(model).loss(s, a, goals, torch.randn_like(a),
                                      torch.rand(B, generator=g) + 0.1, train=True)
        loss.backward()
    assert counter.get_total_flops() == pt.train_step_flops(model, B)


def test_categories():
    cases = {"void flash_fwd_kernel<__nv_bfloat16, 64>": "attention kernels",
             "void (anonymous namespace)::softmax_warp_forward<float>": "attention kernels",
             "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize": "GEMM",
             "ampere_sgemm_128x64_tn": "GEMM",
             "void at::native::(anonymous namespace)::multi_tensor_apply_kernel": "optimizer",
             "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>":
                 "elementwise and casts",
             "void at::native::reduce_kernel<512, 1>": "elementwise and casts",
             "Memcpy DtoD (Device -> Device)": "other"}
    for name, cat in cases.items():
        assert pt.categorize(name) == cat, name


def test_profile_and_scaling_on_cpu(monkeypatch):
    """Both modes at batch 4, 2 steps of the kitchen training model: finite
    losses; the profile says "not measured" for the device (no card); the
    scaling row's MFU is its FLOPs x steps/s over the bf16 peak."""
    out = pt.profile(torch.device("cpu"), batch=4, chunk=2)
    assert out["loss_finite"] and out["device"] == "not measured"
    rows = pt.main(["--scaling", "--configs", "4:2,8:1", "--device", "cpu"])
    assert [(r["batch"], r["chunk"]) for r in rows] == [(4, 2), (8, 1)]
    for r in rows:
        assert r["loss_finite"] and r["steps_per_sec"] > 0
        assert math.isclose(r["mfu"], r["flops_per_step"] * r["steps_per_sec"]
                            / pt.PEAK_BF16_FLOPS)
        assert math.isclose(r["samples_per_sec"], r["steps_per_sec"] * r["batch"])


def test_device_time_from_one_window():
    """Busy time is the union of the kernels' intervals (overlaps counted
    once, gaps not at all), the idle share one less busy over the same
    window's wall time, unclamped; categories sum each kernel's own time."""
    kernels = [("ampere_sgemm_128x64_tn", 0.0, 4000.0),
               ("void flash_fwd_kernel<__nv_bfloat16, 64>", 3000.0, 5000.0),
               ("void at::native::reduce_kernel<512, 1>", 8000.0, 9000.0)]
    out = pt.device_time(kernels, wall_ms=12.0, n_steps=2)
    assert out["wall_ms_per_step"] == 6.0 and out["device_ms_per_step"] == 3.0
    assert out["idle_share"] == 0.5
    assert {c: v["ms_per_step"] for c, v in out["categories"].items()} == {
        "GEMM": 2.0, "attention kernels": 1.0, "elementwise and casts": 0.5}
    assert pt.device_time(kernels, wall_ms=4.0, n_steps=1)["idle_share"] == -0.5
