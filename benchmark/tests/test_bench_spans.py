"""The span readers (`benchmark/spans.py` and the metrics that read it) on a
synthetic host slice with known spans, device operations and runtime calls."""

import types

import pytest

from benchmark import spans
from benchmark import spec as spec_mod
from benchmark import yardstick as Y
from benchmark.trace import TraceSlice, breakdown

SPEC = spec_mod.load()
READERS = ("idle_share.physics", "idle_share.policy_glue", "idle_share.engine",
           "launches_per_env_step.physics", "launches_per_env_step.policy_glue")

# times in us. Two whole steps, [100, 400] and [450, 800]; a step cut at the
# slice's start (it starts with the slice) and one cut at its stop (it ends
# with the slice, after every other operation)
SPANS = [("rollout.step", 0.0, 50.0),
         ("rollout.step", 100.0, 400.0), ("policy.predict", 110.0, 300.0),
         ("engine.call", 150.0, 200.0), ("engine.call", 220.0, 260.0),
         ("physics.step", 310.0, 390.0),
         ("rollout.step", 450.0, 800.0), ("policy.predict", 460.0, 650.0),
         ("engine.call", 500.0, 600.0), ("physics.step", 660.0, 790.0),
         ("rollout.step", 900.0, 1000.0), ("policy.predict", 905.0, 1000.0)]
CALLS = [("cudaLaunchKernel", 20.0, 22.0),
         ("cudaLaunchKernel", 120.0, 122.0), ("cudaLaunchKernel", 160.0, 162.0),
         ("cudaLaunchKernel", 170.0, 172.0), ("cudaLaunchKernelExC", 230.0, 232.0),
         ("cudaMemcpyAsync", 320.0, 322.0), ("cudaMemsetAsync", 330.0, 331.0),
         ("cudaStreamSynchronize", 340.0, 380.0), ("cudaLaunchKernel", 395.0, 396.0),
         ("cudaLaunchKernel", 470.0, 471.0), ("cudaLaunchKernel", 510.0, 511.0),
         ("cudaLaunchKernel", 520.0, 521.0), ("cudaLaunchKernel", 700.0, 701.0),
         ("cudaLaunchKernel", 950.0, 951.0)]
OPS = [("aten::mul", 118.0, 124.0), ("aten::index", 318.0, 385.0)]
KERNELS = [("k", 0.0, 40.0), ("k", 125.0, 140.0), ("k", 165.0, 205.0), ("k", 200.0, 215.0),
           ("k", 235.0, 255.0), ("Memcpy HtoD (Pageable -> Device)", 325.0, 335.0),
           ("k", 400.0, 420.0), ("k", 475.0, 480.0), ("k", 515.0, 590.0),
           ("k", 705.0, 760.0), ("k", 955.0, 990.0)]
# idle by layer, step 1 then step 2
IDLE = {"policy_glue": (10 + 25 + 5 + 40 + 10 + 10) + (10 + 35 + 50 + 10 + 10),
        "engine": (15 + 20) + 25, "physics": 70 + 75}
STEP_US = 300.0 + 350.0
LAUNCHES = {"policy_glue": 2 + 1, "engine": 3 + 2, "physics": 2 + 1}


def ctx(host_ops, host_kernels=KERNELS, unit="env_step"):
    trace = TraceSlice(list(host_kernels), 1e-3, Y.busy_us(host_kernels) / 1e6, 4,
                       list(host_kernels), list(host_ops), 1e-3, 8, 2e-3)
    return types.SimpleNamespace(cfg={}, traffic={}, shapes={}, unit=unit, work={},
                                 setup_s=1.0, trace=trace)


def test_idle_and_launches_go_to_the_innermost_span():
    sl = spans.step_layers(ctx(SPANS + CALLS + OPS).trace)
    assert sl.steps == 2 and sl.step_us == STEP_US
    assert sl.idle_us == pytest.approx(IDLE)
    assert sl.launches == LAUNCHES


def test_partial_steps_at_the_slice_edges_are_dropped():
    """The calls of the cut steps (at 20 and 950 us) and their device time
    count nowhere; without the two whole steps nothing is left."""
    sl = spans.step_layers(ctx(SPANS + CALLS).trace)
    assert sum(sl.launches.values()) == 11
    cut = [s for s in SPANS if s[0] == "rollout.step" and s[1] in (0.0, 900.0)]
    assert spans.step_layers(ctx(cut + CALLS).trace) is None


def test_the_layers_sum_to_the_whole_steps():
    """The per-layer idle is the whole steps' idle, and the per-layer
    launches are every enqueueing call inside them."""
    sl = spans.step_layers(ctx(SPANS + CALLS).trace)
    busy_in_steps = 15 + 50 + 20 + 10 + 5 + 75 + 55
    assert sum(sl.idle_us.values()) == pytest.approx(STEP_US - busy_in_steps)
    enqueued = [c for c in CALLS if "Synchronize" not in c[0]
                and any(s <= c[1] < e for s, e in ((100.0, 400.0), (450.0, 800.0)))]
    assert sum(sl.launches.values()) == len(enqueued)


def test_readers_report_each_layer():
    c = ctx(SPANS + CALLS + OPS)
    want = {"idle_share.physics": 100 * IDLE["physics"] / STEP_US,
            "idle_share.policy_glue": 100 * IDLE["policy_glue"] / STEP_US,
            "idle_share.engine": 100 * IDLE["engine"] / STEP_US,
            "launches_per_env_step.physics": LAUNCHES["physics"] / 2,
            "launches_per_env_step.policy_glue": LAUNCHES["policy_glue"] / 2}
    for name in READERS:
        assert SPEC.reader(name).read(c) == pytest.approx(want[name]), name


def test_readers_find_nothing_without_spans():
    """A program without the spans (the trace has operations, no span), a
    trace of another driver's unit, and no trace at all."""
    bare = ctx(CALLS + OPS)
    other = ctx(SPANS + CALLS, unit="train_step")
    none = types.SimpleNamespace(unit="env_step", trace=None)
    for name in READERS:
        for c in (bare, other, none):
            assert SPEC.reader(name).read(c) is None, name


def test_breakdown_names_the_span_a_gap_opens_in():
    """The accepted breakdown labels a gap with the innermost host
    operation open when it began, which is now a span where no aten
    operation was running."""
    b = breakdown(ctx(SPANS + CALLS + OPS).trace)
    gaps = dict(b["idle_gaps"])
    # 140-165, 215-235 and 480-515 us
    assert gaps["policy.predict"] == pytest.approx(80e-6)
    assert gaps["physics.step"] == pytest.approx(195e-6)      # 760-955 us
    # only the loop between the steps, 420-475 us, is outside every span
    assert gaps["host between operations"] == pytest.approx(55e-6)
