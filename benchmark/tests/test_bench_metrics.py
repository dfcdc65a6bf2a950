"""Each metric reader on a small synthetic kernel list."""

import types

import pytest

from benchmark import spec as spec_mod
from benchmark import yardstick as Y
from benchmark.trace import TraceSlice, breakdown

SPEC = spec_mod.load()
CFG = {**SPEC.config("kitchen_state")}


def ctx(unit, kernels, window_s=1e-3, steps=2, cfg=CFG, shapes=None, work=None):
    trace = TraceSlice(list(kernels), window_s, Y.busy_us(kernels) / 1e6, steps, [], [],
                       window_s, steps + 1, 2 * window_s)
    return types.SimpleNamespace(cfg=cfg, traffic={}, shapes=shapes or {}, unit=unit,
                                 work=work or {}, setup_s=1.5, trace=trace)


ROLL = {"rows_per_call": 4096, "calls_per_step": 3, "cached": True, "suffix_tokens": 8,
        "prefix_tokens": 3, "tokens": 11}
KERNELS = [("fused_layer_f32_kernel<false, false>", 0.0, 100.0),
           ("void at::native::vectorized_elementwise_kernel", 150.0, 200.0),
           ("ampere_sgemm_128x64_tn", 190.0, 300.0),
           ("fused_layer_f32_kernel<false, false>", 400.0, 500.0)]


def read(name, c):
    return SPEC.reader(name).read(c)


def test_launches_and_idle_share():
    c = ctx("env_step", KERNELS)
    assert read("launches_per_env_step", c) == 2.0
    # busy: 100 + 150 + 100 us of a 1 ms slice
    assert read("idle_share.rollout", c) == pytest.approx(65.0)
    other = ctx("other", KERNELS, steps=4)
    assert read("launches_per_env_step", other) is None
    assert read("idle_share.rollout", other) is None


def test_b1_and_b4_rooflines():
    c = ctx("env_step", KERNELS, shapes=ROLL)
    flops, nbytes = Y.layer_work(4096, 8, 360, 3, elem=4)
    bound_ms = Y.bound(flops, nbytes, Y.PEAK_F32_BF16X3_FLOPS)[0]
    assert read("b1_roofline", c) == pytest.approx(100 * bound_ms * 2 / 0.2)
    assert read("b4_roofline", c) is None
    b4 = ctx("env_step", KERNELS, shapes={**ROLL, "cached": False})
    flops, nbytes = Y.layer_work(4096, 11, 360, 0, elem=4)
    bound_ms = Y.bound(flops, nbytes, Y.PEAK_F32_BF16X3_FLOPS)[0]
    assert read("b4_roofline", b4) == pytest.approx(100 * bound_ms * 2 / 0.2)
    assert read("b1_roofline", b4) is None
    none = ctx("env_step", KERNELS[1:3], shapes=ROLL)
    assert read("b1_roofline", none) is None


def test_mfu_against_the_model_flops():
    # 12 steps in 0.7 s, of which 2 steps in 0.1 s traced: 10 steps in 0.6 s
    c = ctx("env_step", KERNELS, window_s=0.05, steps=1, shapes=ROLL,
            work={"steps": 12, "window_s": 0.7})
    flops = 3 * Y.denoiser_call_flops(CFG, 4096)
    assert read("mfu.rollout", c) == pytest.approx(100 * 10 * flops / 0.6 / (989e12 / 3))
    assert read("mfu.rollout", ctx("other", KERNELS, shapes=ROLL)) is None


def test_end_to_end_readers():
    c = types.SimpleNamespace(work={"env_steps": 1000, "window_s": 2.0}, setup_s=3.0)
    assert read("rollout_env_steps_per_s", c) == 500.0
    assert read("setup_s", c) == 3.0
    assert read("rollout_env_steps_per_s", types.SimpleNamespace(work={})) is None


def test_per_layer_readers_find_nothing_without_a_trace():
    c = types.SimpleNamespace(cfg=CFG, traffic={}, shapes=ROLL, unit="env_step", work={},
                              setup_s=1.0, trace=None)
    for m in SPEC.bench["per_layer"]:
        assert read(m["name"], c) is None, m["name"]


def test_breakdown_names_the_host_operation_of_each_gap():
    host = [("aten::copy_", 95.0, 160.0), ("cudaStreamSynchronize", 300.0, 399.0)]
    b = breakdown(TraceSlice(KERNELS, 1e-3, 0.0, 1, KERNELS, host, 1e-3, 2, 2e-3))
    assert b["device_ops"][0] == ["fused_layer_f32_kernel<false, false>", 200e-6]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(100e-6)
