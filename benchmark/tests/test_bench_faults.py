"""The comparison that decides `correct` fails where it must: the control
(the reference at the precision below the configuration's, put in the
program's place) fails at least one number of each cell, and a run with
the timed path broken underneath comes out not correct, for each fault
the cell can have."""

import pytest
import torch

from benchmark import spec as spec_mod
from benchmark.control import CONTROL_PRECISION
from benchmark.tests import tiny

SPEC = spec_mod.load()
CELLS = [w["name"] for w in SPEC.bench["workloads"]]


def _fails(numbers: dict, workload: str) -> list:
    limits = SPEC.limits(workload)
    return [k for k, lim in limits.items() if not numbers.get(k, float("inf")) <= lim]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    d = tiny.driver(workload)
    assert not _fails(d.judge(), workload)
    precision = CONTROL_PRECISION[d.cfg["compute_dtype"]]
    assert _fails(d.judge(precision), workload)


def _step_unchanged(monkeypatch):
    from beso_tpu_torch.rollout import rollout

    step = rollout.kitchen_step

    def unchanged(state, action, *args):
        _, obs, reward, done = step(state, action, *args)
        return state, state.qpos, reward, done

    monkeypatch.setattr(rollout, "kitchen_step", unchanged)


def _answer_altered(monkeypatch):
    from beso_tpu_torch.agents import beso_agent

    make = beso_agent.BesoAgent.make_denoise_factory

    def factory(self, *a, **kw):
        inner = make(self, *a, **kw)

        def episode(goals):
            dn = inner(goals)

            def altered(*args, **kwargs):
                out = dn(*args, **kwargs).clone()
                out[0] += 0.01
                return out

            return altered

        return episode

    monkeypatch.setattr(beso_agent.BesoAgent, "make_denoise_factory", factory)


def _half_rows(monkeypatch):
    """The engine computes the first half of its rows; the rest repeat them."""
    from beso_tpu_torch.agents import beso_agent

    make = beso_agent.BesoAgent.make_denoise_factory

    def factory(self, *a, **kw):
        inner = make(self, *a, **kw)

        def episode(goals):
            dn = inner(goals)

            def half(*args, **kwargs):
                out = dn(*args, **kwargs)
                h = out.shape[0] // 2
                return torch.cat([out[:h], out[:out.shape[0] - h]])

            return half

        return episode

    monkeypatch.setattr(beso_agent.BesoAgent, "make_denoise_factory", factory)


@pytest.mark.parametrize("fault", [_step_unchanged, _answer_altered, _half_rows])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_rollout_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run(workload)
    assert out["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(workload, card):
    from benchmark.control import readings

    # the published widths (the kernels' own shapes), two layers, few rows
    r = readings(SPEC, workload, tiny.SEED, card, {"num_hidden_layers": 2}, tiny.TRAFFIC)
    assert not _fails(r["program"], workload)
    assert _fails(r["control"], workload)
