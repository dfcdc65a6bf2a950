"""The program's spans (`utils.metrics.span`) at the rollout's layer
boundaries: their nesting in a kitchen and a block-push rollout under
torch.profiler, no range at all without a profiler, the names in
`profile_trace`'s Chrome trace, an open span ended with its profiler, and
on the card the device operations they account for.

This file imports no JAX, so its `gpu` test also runs on the card's host:
`python -m pytest --noconftest -m gpu tests/test_torch_spans.py`.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beso_tpu_torch.agents.policy import PolicyConfig
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data, synthetic_push_data
from beso_tpu_torch.envs.block_push.goals import block_push_goal_frames
from beso_tpu_torch.envs.kitchen.goals import multigoal_kitchen_goals
from beso_tpu_torch.models import DiffusionGPT, GCDenoiser
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.scaler import fit_minmax_scaler, fit_scaler
from beso_tpu_torch.rollout import rollout_block_push, rollout_kitchen
from beso_tpu_torch.utils import metrics

SPANS = ("rollout.episode", "engine.prefix_build", "rollout.step", "policy.predict",
         "engine.call", "physics.step")
STEPS, NFE = 4, 3


def _denoiser(state_dim, action_dim, dtype=torch.float32, width=32, heads=2, device="cpu"):
    model = DiffusionGPT(state_dim=state_dim, action_dim=action_dim, embed_dim=width,
                         n_layers=2, n_heads=heads, goal_seq_len=2 if state_dim == 30 else 1,
                         obs_seq_len=4, dtype=dtype,
                         generator=torch.Generator().manual_seed(0)).to(device)
    return GCDenoiser(model, sigma_data=0.5)


def _kitchen(B=4, steps=STEPS, engine="cached", device="cpu", seed=0, **model_kw):
    """A kitchen rollout with CFG (lambda 1.5) on the given engine; returns
    its metrics."""
    data = synthetic_kitchen_data(n_traj=8, t_max=30, seed=0)
    scaler = fit_scaler(data.all_observations(), data.all_actions(), scale_data=False,
                        device=device)
    cfg = PolicyConfig(window_size=4, obs_dim=30, action_dim=9, sampler_type="ddim",
                       num_sampling_steps=NFE, cond_lambda=1.5)
    den = _denoiser(30, 9, device=device, **model_kw)
    goals, expected = multigoal_kitchen_goals(data, 2, B, seed=42)
    factory = make_rollout_denoise_factory(den, scaler, cfg, engine=engine)
    return rollout_kitchen(None, scaler, cfg, torch.as_tensor(goals, device=device),
                           torch.as_tensor(expected, device=device),
                           torch.Generator(device).manual_seed(seed), n_steps=steps,
                           denoise_factory=factory)


def _block_push(B=4, steps=STEPS):
    data = synthetic_push_data(n_traj=8, t_max=30, seed=0)
    scaler = fit_minmax_scaler(data.all_observations()[:, :10], data.all_actions())
    frames, expected = block_push_goal_frames(data, B, seed=6)
    cfg = PolicyConfig(window_size=4, obs_dim=10, action_dim=2, sampler_type="ddim",
                       num_sampling_steps=NFE, cond_lambda=2.0)
    factory = make_rollout_denoise_factory(_denoiser(10, 2), scaler, cfg, engine="cached")
    return rollout_block_push(None, scaler, cfg, torch.as_tensor(frames),
                              torch.as_tensor(expected), torch.Generator().manual_seed(0),
                              n_steps=steps, denoise_factory=factory)


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in SPANS]


def _inside(spans, name, outer):
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


def _check_steps(spans, steps):
    """One `rollout.step` per env step, in order; each holds one
    `policy.predict` with NFE `engine.call`s, then one `physics.step`."""
    step_spans = sorted((s for s in spans if s[0] == "rollout.step"), key=lambda s: s[1])
    assert len(step_spans) == steps
    for a, b in zip(step_spans, step_spans[1:]):
        assert a[2] <= b[1]
    for st in step_spans:
        (pred,) = _inside(spans, "policy.predict", st)
        (phys,) = _inside(spans, "physics.step", st)
        assert pred[2] <= phys[1]
        assert len(_inside(spans, "engine.call", pred)) == NFE
        assert not _inside(spans, "engine.call", phys)
    assert sum(s[0] == "engine.call" for s in spans) == NFE * steps


def test_kitchen_rollout_spans_nest():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _kitchen()
    spans = _spans(prof)
    _check_steps(spans, STEPS)
    (episode,) = [s for s in spans if s[0] == "rollout.episode"]
    (build,) = _inside(spans, "engine.prefix_build", episode)
    assert len(_inside(spans, "rollout.step", episode)) == STEPS
    first = min(s[1] for s in spans if s[0] == "rollout.step")
    assert build[2] <= first


def test_block_push_rollout_spans_nest():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _block_push()
    spans = _spans(prof)
    _check_steps(spans, STEPS)
    assert sum(s[0] == "physics.step" for s in spans) == STEPS


def test_step_spans_carry_the_step_index():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        _kitchen(steps=3)
    steps = [e.kwinputs for e in prof.events() if e.name == "rollout.step"]
    assert steps == [{"step": 0}, {"step": 1}, {"step": 2}]


def test_no_profiler_makes_no_range(monkeypatch):
    """Without a profiler a span is the shared null context and no profiler
    range is made, by the spans or by anything else on the path."""
    made = []

    def counting(real):
        def make(*args, **kw):
            made.append(args[0])
            return real(*args, **kw)
        return make

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting(torch.autograd.profiler.record_function))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    assert metrics.span("rollout.step") is metrics.NULL_SPAN
    assert metrics.span("rollout.step", {"step": 3}) is metrics.NULL_SPAN
    _kitchen(steps=2)
    _block_push(steps=2)
    with metrics.step_timer(None, "timed"):
        pass
    assert made == []
    # the counters see the spans once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("probe"):
            pass
    assert made == ["probe"]


def test_spans_leave_the_rollout_unchanged():
    plain = _kitchen(steps=3, seed=5)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _kitchen(steps=3, seed=5)
    for a, b in zip(plain, traced):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_profile_trace_names_the_spans(tmp_path):
    with metrics.profile_trace(str(tmp_path)), metrics.step_timer(None, "evaluation"):
        _kitchen(steps=2)
    names = {ev.get("name") for ev in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]}
    assert set(SPANS) | {"evaluation"} <= names


def test_a_span_open_at_the_profiler_stop_ends_with_it():
    """A span still open when its profiler stops is recorded as ending
    there, and its block's later end, under the next profiler, records
    nothing (the first profiler's records are freed by then)."""
    first = profile(activities=[ProfilerActivity.CPU])
    first.start()
    s = metrics.span("open.at.stop")
    s.__enter__()
    torch.ones(4).sum()
    first.stop()
    assert metrics._OPEN == []
    second = profile(activities=[ProfilerActivity.CPU])
    second.start()
    with metrics.span("inner"):
        torch.ones(4).sum()
    s.__exit__(None, None, None)
    second.stop()
    assert [e.name for e in first.events()].count("open.at.stop") == 1
    names = [e.name for e in second.events()]
    assert "open.at.stop" not in names and names.count("inner") == 1


ENQUEUE = ("LaunchKernel", "Memcpy", "Memset")


@pytest.mark.gpu
def test_spans_account_for_the_device_operations_on_the_card():
    """A `fused_cached` kitchen rollout on the card under a CPU and CUDA
    profiler: the runtime calls that enqueue a device operation inside the
    `rollout.step` spans match the device operations of those steps within
    2%, and every launch of the fused layer (B1) is made inside an
    `engine.call`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    _kitchen(B=100, steps=2, engine="fused_cached", device="cuda", width=96)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _kitchen(B=100, steps=24, engine="fused_cached", device=dev, width=96)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in host if e.name in SPANS]
    # the spans are host ranges only: nothing of theirs on the device's timeline
    assert not any(e.name in SPANS for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    steps = sorted((s for s in spans if s[0] == "rollout.step"), key=lambda s: s[1])[1:]
    assert len(steps) == 23
    lo, hi = steps[0][1], steps[-1][2]
    calls = [e for e in host if any(k in e.name for k in ENQUEUE)
             and any(s[1] <= e.time_range.start < s[2] for s in steps)]
    ops = [e for e in device if lo <= e.time_range.start < hi]
    assert abs(len(calls) - len(ops)) <= 0.02 * len(ops), (len(calls), len(ops))
    # B1's launches, found by the correlation id they share with their
    # kernels: 2 layers per denoiser call in each step, each inside a call
    engine_calls = [s for s in spans if s[0] == "engine.call"]
    launch_at = {e.id: e.time_range.start for e in host if "LaunchKernel" in e.name}
    b1 = [launch_at[e.id] for e in device if "fused_layer" in e.name]
    b1 = [t for t in b1 if any(s[1] <= t < s[2] for s in steps)]
    assert len(b1) == 2 * NFE * len(steps)
    for t in b1:
        assert any(s[1] <= t < s[2] for s in engine_calls), t
