"""The kitchen step's CUDA kernel (`ops/kitchen_step.py`,
`csrc/kitchen_step.cu`) against the eager step it replaces.

A pool of 1,000 (state, action) rows built on the CPU reaches every branch
of the step: arm motion blocked by the wall and by the microwave box,
hooked and kept drives on a rotary element and on the slide, a hook lost at
the step's end, the kettle's engage, tracking under the speed cap and
release by gripper and by distance, tasks completing on the step (with a
completion step already set, which must stay), envs already done (frozen,
reward 0), task subsets and known starts. The CPU tests hold the pool's
coverage, `kitchen_step`'s CPU path (the eager code, bit for bit, with the
kernel's counter untouched), the table of the forward kinematics and the
wrapper's checks; `test_torch_kitchen.py` holds the pool's eager step to
`beso_tpu`'s. The tests marked `gpu` run one step of the pool's first
B rows (B = 1, 100, 128, 129, 1000: one and several blocks, a ragged last
block) under four physics settings through the kernel, through the eager
step on the card (within 1e-6) and through the eager step on the CPU
(within 1e-5, as the eager step on the card is), and hold the
kernel's mechanism: one launch, nothing the host waits for, the same bits
from launch to launch and for row slices, and the eager path where a
gradient flows.

This file imports no JAX, so it also runs on the card's host:
`python -m pytest --noconftest -m gpu tests/test_torch_kitchen_kernel.py`.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from beso_tpu_torch.envs.kitchen import env as kenv
from beso_tpu_torch.envs.kitchen.fk import _mdh_transform, _PANDA_DH, mdh_table, panda_fk
from beso_tpu_torch.envs.kitchen.oracle import kitchen_draws, kitchen_oracle_policy, oracle_reset
from beso_tpu_torch.ops import kitchen_step as ks

CPU = torch.device("cpu")
POOL = 1000
BATCHES = (1, 100, 128, 129, 1000)
# the physics settings: shipped, the robustness evaluation's -20% and +20%,
# and a kettle speed cap below the release radius, under which a held
# kettle's tracking is capped
SETTINGS = ("shipped", "scaled_0.8", "scaled_1.2", "kettle_cap")
BRANCHES = ("wall_block", "microwave_block", "rotary_kept", "slide_kept", "hook_lost",
            "kettle_engage", "kettle_capped", "release_by_gripper", "release_by_distance",
            "completes", "order_kept", "frozen", "task_subset")


def _params(setting, device):
    p = kenv.default_kitchen_params(device)
    if setting.startswith("scaled_"):
        s = float(setting.split("_")[1])
        return kenv.perturb_kitchen_params(p, s, s, s)
    if setting == "kettle_cap":
        return dataclasses.replace(p, kettle_max_speed=torch.tensor(0.02, device=device))
    return p


def _cat(states):
    return kenv.KitchenState(*(torch.cat(f) for f in zip(*states)))


def _rows(state, idx):
    return kenv.KitchenState(*(f[idx] for f in state))


def _branches(state, action, params):
    """{branch: bool [B]}: which rows reach each branch, recomputed from the
    eager step's own functions."""
    c = kenv._consts(CPU)
    q, e0 = state.qpos, state.ee_pos
    a = torch.clamp(action, -1.0, 1.0) * kenv.ACT_AMP
    q_cand = torch.clamp(q[:, :9] + a * kenv.CONTROL_DT, c.joint_lo, c.joint_hi)
    ec = panda_fk(q_cand[:, :7], kenv.KITCHEN_BASE_POS)
    free = ~kenv._collides(e0, params)
    wall = (ec[:, 1] > params.wall_y) & free
    blocked = kenv._collides(ec, params) & free
    en = torch.where(blocked[:, None], e0, ec)
    handles = kenv.kitchen_handles(q, params)
    hooked = kenv._segment_dist(e0, handles, params.bar_dirs, params.bar_halflen) < \
        params.interact_radius
    new, _, reward, _ = kenv._kitchen_step_eager(state, action, params)
    moved = new.qpos[:, c.primary] != q[:, c.primary]
    rotary = params.rotary > 0.5
    grip = q_cand[:, 7:9].mean(-1)
    kettle = kenv._segment_dist(en, handles, params.bar_dirs, params.bar_halflen)[:, 6]
    live, was = ~state.done, state.kettle_grasped
    newly = new.completed & ~state.completed
    disp = torch.linalg.norm((en - e0) * params.kettle_gain, dim=-1)
    return dict(
        wall_block=wall & live, microwave_block=blocked & ~wall & live,
        rotary_kept=(hooked & moved & rotary)[:, :6].any(-1) & live,
        slide_kept=(hooked & moved & ~rotary)[:, :6].any(-1) & live,
        hook_lost=(hooked & ~moved)[:, :6].any(-1) & ~blocked & live,
        kettle_engage=~was & new.kettle_grasped & live,
        kettle_capped=was & new.kettle_grasped & (disp > params.kettle_max_speed) & live,
        release_by_gripper=was & (grip > params.grip_open_thresh) & live,
        release_by_distance=was & (grip <= params.grip_open_thresh)
        & (kettle > params.release_radius) & live,
        completes=newly.any(-1), order_kept=(newly & (state.completion_order >= 0)).any(-1),
        frozen=state.done & (reward == 0),
        task_subset=~state.tasks_to_complete.all(-1) & live)


@functools.lru_cache(maxsize=None)
def _pool():
    """POOL (state, action) rows on the CPU, shuffled: scripted oracle
    episodes (hooks, drives, kettle grasps, completions) with their own and
    with random actions, random arm poses and actions (blocked motion),
    held kettles opened or yanked, completions with a completion step
    already set, envs already done, task subsets and known starts."""
    rng = np.random.RandomState(0)
    g = torch.Generator().manual_seed(0)
    B, steps = 48, 120
    task_seq = kitchen_draws("task_seq", B, g, None, n_tasks=4, kettle_boost=0.5)
    style = kitchen_draws("style", B, g, None)
    env, carry = kenv.kitchen_reset(B), oracle_reset(B)
    states, actions = [], []
    for _ in range(steps):
        action, carry = kitchen_oracle_policy(env, carry, task_seq, None, style)
        states.append(env)
        actions.append(action)
        env = kenv.kitchen_step(env, action)[0]
    oracle, oracle_act = _cat(states), torch.cat(actions)
    n = oracle.qpos.shape[0]

    def pick(mask, k):
        idx = np.flatnonzero(mask.numpy())
        return torch.as_tensor(rng.choice(idx, min(k, len(idx)), replace=False))

    def uniform(rows, lo=-1.5, hi=1.5):
        return torch.as_tensor(rng.uniform(lo, hi, size=(rows, 9)).astype(np.float32))

    br = _branches(oracle, oracle_act, _params("shipped", CPU))
    parts = [(_rows(oracle, i), oracle_act[i]) for i in (
        pick(br["rotary_kept"], 60), pick(br["slide_kept"], 40), pick(br["hook_lost"], 40),
        pick(br["kettle_engage"], 20), pick(br["completes"], 20),
        pick(torch.ones(n, dtype=torch.bool), 400))]
    # the same states under random actions
    i = pick(torch.ones(n, dtype=torch.bool), 150)
    parts.append((_rows(oracle, i), uniform(len(i))))
    # held kettles: kept closed (tracking), opened, or yanked away
    held = pick(oracle.kettle_grasped, 40)
    for fingers, scale in ((-1.0, 0.05), (1.0, 0.05), (-1.0, 1.0)):
        act = uniform(len(held), -scale, scale)
        act[:, 7:9] = fingers
        parts.append((_rows(oracle, held), act))
    # completions whose completion step is already set: it must stay
    done_now = pick(br["completes"], 20)
    st = _rows(oracle, done_now)
    parts.append((st._replace(completion_order=torch.full_like(st.completion_order, 3)),
                  oracle_act[done_now]))
    # random arm poses and actions: the wall and the microwave box block
    lo, hi = torch.as_tensor(kenv.JOINT_LO), torch.as_tensor(kenv.JOINT_HI)
    q = torch.as_tensor(kenv.INIT_QPOS).repeat(8000, 1)
    q[:, :9] = lo + (hi - lo) * torch.as_tensor(rng.rand(8000, 9).astype(np.float32))
    rand = kenv.kitchen_reset_from_qpos(q)
    rand_act = uniform(8000, -1.0, 1.0)
    rb = _branches(rand, rand_act, _params("shipped", CPU))
    for mask in (rb["wall_block"], rb["microwave_block"]):
        i = pick(mask, 40)
        parts.append((_rows(rand, i), rand_act[i]))
    # envs already done, task subsets, known starts with subsets
    i = pick(torch.ones(n, dtype=torch.bool), 60)
    parts.append((_rows(oracle, i)._replace(done=torch.ones(len(i), dtype=torch.bool)),
                  oracle_act[i]))
    i = pick(torch.ones(n, dtype=torch.bool), 40)
    st = _rows(oracle, i)
    subset = torch.as_tensor(rng.rand(len(i), 7) < 0.5)
    parts.append((st._replace(tasks_to_complete=st.tasks_to_complete & subset), oracle_act[i]))
    starts = torch.as_tensor(kenv.INIT_QPOS + rng.normal(0, 0.05, size=(40, 30)).astype(np.float32))
    parts.append((kenv.kitchen_reset_from_qpos(starts, task_mask=[1, 0, 1, 1, 0, 0, 1]),
                  uniform(40, -1.0, 1.0)))
    state, action = _cat([s for s, _ in parts]), torch.cat([a for _, a in parts])
    order = torch.as_tensor(rng.permutation(state.qpos.shape[0])[:POOL])
    return _rows(state, order), action[order].contiguous()


def test_case_pool_reaches_every_branch():
    """Every branch of the step is taken by at least three rows of the pool
    under the shipped physics (the capped kettle under `kettle_cap`), and by
    some of the first 100 rows together."""
    state, action = _pool()
    assert state.qpos.shape == (POOL, 30)
    counts = {}
    for setting in ("shipped", "kettle_cap"):
        for name, rows in _branches(state, action, _params(setting, CPU)).items():
            counts[name] = max(counts.get(name, 0), int(rows.sum()))
    assert set(counts) == set(BRANCHES)
    assert all(v >= 3 for v in counts.values()), counts
    head = _branches(_rows(state, slice(0, 100)), action[:100], _params("shipped", CPU))
    assert sum(bool(v.any()) for v in head.values()) >= len(BRANCHES) - 3, head


@pytest.mark.parametrize("setting", SETTINGS)
def test_cpu_step_is_the_eager_step(setting):
    """On the CPU `kitchen_step` is `_kitchen_step_eager`, bit for bit, and
    the kernel's counter stays where it was."""
    state, action = _pool()
    params = _params(setting, CPU)
    before = ks.kitchen_step.launches
    got = kenv.kitchen_step(state, action, params)
    ref = kenv._kitchen_step_eager(state, action, params)
    assert ks.kitchen_step.launches == before
    for a, b in zip([*got[0], *got[1:]], [*ref[0], *ref[1:]]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fk_table_is_the_transforms_entries():
    """`mdh_table` holds the constant entries of `_mdh_transform`'s matrices
    (at theta 0) for the 7 links and the fingertip, bit for bit."""
    table = torch.as_tensor(mdh_table())
    links = (*_PANDA_DH, (0.0, 0.107 + 0.103, 0.0))
    assert table.shape == (len(links), 5)
    for row, (a, d, alpha) in zip(table, links):
        M = _mdh_transform(a, d, alpha, torch.zeros(1))[0]
        assert torch.equal(row, torch.stack([M[0, 3], M[1, 1], M[2, 1], -M[1, 3], M[2, 3]]))
    assert torch.equal(kenv._consts(CPU).fk_table, table)


def _bad_inputs():
    """Four rows of the pool, the shipped params and the tables, on the CPU."""
    state, action = _pool()
    return (_rows(state, slice(0, 4)), action[:4], kenv.default_kitchen_params(CPU),
            kenv._consts(CPU))


BAD = {
    "device": (lambda s, a, p, c: (s, a.to("meta"), p, c), "is on meta"),
    "action_dtype": (lambda s, a, p, c: (s, a.double(), p, c), "dtype"),
    "steps_dtype": (lambda s, a, p, c: (s._replace(steps=s.steps.long()), a, p, c), "dtype"),
    "params_dtype": (lambda s, a, p, c: (s, a, dataclasses.replace(
        p, wall_y=p.wall_y.double()), c), "dtype"),
    "qpos_shape": (lambda s, a, p, c: (s._replace(qpos=s.qpos[:, :29].contiguous()), a, p, c),
                   "shape"),
    "table_shape": (lambda s, a, p, c: (s, a, p, c._replace(fk_table=c.fk_table[:7])), "shape"),
    "not_contiguous": (lambda s, a, p, c: (s, a.t().contiguous().t(), p, c), "contiguous"),
    "cpu": (lambda s, a, p, c: (s, a, p, c), "runs on CUDA"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The wrapper raises ValueError for a tensor on another device, of
    another dtype or shape, or not contiguous, and for CPU inputs (whose
    step is the eager one), before it loads the kernel library."""
    make, match = BAD[case]
    s, a, p, c = make(*_bad_inputs())
    with pytest.raises(ValueError, match=match):
        ks.kitchen_step(s, a, p, c, kenv.ACT_AMP, kenv.CONTROL_DT, kenv.BONUS_THRESH)


@pytest.mark.parametrize("field", ["qpos", "done", "action"])
def test_wrapper_takes_row_slices_where_they_lie(field):
    """A row slice off the 32-byte alignment of the vector-loading kernels (a
    shard's known starts) passes every check of the wrapper, whose kernel
    loads scalars: on the CPU it reaches the one error left, the device."""
    s, a, p, c = _bad_inputs()
    state, action = _pool()
    if field == "action":
        a = action[1:5]
        sliced = a
    else:
        s = s._replace(**{field: getattr(state, field)[1:5]})
        sliced = getattr(s, field)
    assert sliced.is_contiguous() and sliced.data_ptr() % 32
    with pytest.raises(ValueError, match="runs on CUDA"):
        ks.kitchen_step(s, a, p, c, kenv.ACT_AMP, kenv.CONTROL_DT, kenv.BONUS_THRESH)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    return torch.device("cuda")


def _to(state, device):
    return kenv.KitchenState(*(f.to(device) for f in state))


def _fields(result):
    state, obs, reward, done = result
    return [*state, reward], obs, done


NAMES = [n for n, _, _ in ks.STATE] + ["reward"]


@pytest.mark.gpu
@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("B", BATCHES)
def test_kernel_matches_eager_step(B, setting):
    """One step of the pool's first B rows through the kernel, the eager step
    on the card and the eager step on the CPU: floats within 1e-6 of the
    card's eager step (the kernel contracts as the eager kernels do, and
    gives their bits), within 1e-5 of the CPU's (the eager step on the card
    itself is up to 7e-6 from it: a last-bit difference of the fingertip
    between the two devices' sin and cos, swept by a 4 cm knob lever, moves
    the knob by that), flags and completion steps equal to both; the obs is
    the new qpos and done the new done, as the eager step returns them."""
    dev = _cuda()
    state, action = _pool()
    state, action = _rows(state, slice(0, B)), action[:B]
    params = _params(setting, dev)
    before = ks.kitchen_step.launches
    got = kenv.kitchen_step(_to(state, dev), action.to(dev), params)
    assert ks.kitchen_step.launches == before + 1
    card = kenv._kitchen_step_eager(_to(state, dev), action.to(dev), params)
    cpu = kenv._kitchen_step_eager(state, action, _params(setting, CPU))
    (fields, obs, done), card_fields, cpu_fields = (
        _fields(got), _fields(card)[0], _fields(cpu)[0])
    assert obs.data_ptr() == fields[0].data_ptr() and done.data_ptr() == fields[6].data_ptr()
    for name, x, y, z in zip(NAMES, fields, card_fields, cpu_fields):
        x, y = x.cpu(), y.cpu()
        assert x.dtype == y.dtype == z.dtype and x.shape == z.shape, name
        if x.dtype.is_floating_point:
            assert float((x - y).abs().max()) <= 1e-6, (name, float((x - y).abs().max()))
            assert float((x - z).abs().max()) <= 1e-5, (name, float((x - z).abs().max()))
        else:
            assert torch.equal(x, y) and torch.equal(x, z), name


@pytest.mark.gpu
def test_kernel_reads_row_slices_where_they_lie():
    """A step of rows 1-100 given as slices of the pool on the card (off the
    32-byte alignment, no copy) gives the bits of the same rows copied."""
    dev = _cuda()
    state, action = _pool()
    state, action = _to(state, dev), action.to(dev)
    rows = slice(1, 101)
    sliced = _fields(kenv.kitchen_step(_rows(state, rows), action[rows]))[0]
    copied = _fields(kenv.kitchen_step(kenv.KitchenState(*(f[rows].clone() for f in state)),
                                       action[rows].clone()))[0]
    assert state.qpos[rows].data_ptr() % 32
    assert all(torch.equal(x, y) for x, y in zip(sliced, copied))


@pytest.mark.gpu
def test_kernel_is_deterministic():
    """Two launches on the same input give the same bits."""
    dev = _cuda()
    state, action = _pool()
    state, action = _to(state, dev), action.to(dev)
    a, b = (_fields(kenv.kitchen_step(state, action))[0] for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_kernel_step_is_one_launch_and_never_waits():
    """A step on the card is one launch of the kernel, and nothing in it
    makes the host wait for the card (CUDA's sync debug mode raises on any
    synchronising call)."""
    dev = _cuda()
    state, action = _pool()
    state, action = _to(_rows(state, slice(0, 100)), dev), action[:100].to(dev)
    params = kenv.default_kitchen_params(dev)
    kenv._consts(dev)
    torch.cuda.synchronize()
    before = ks.kitchen_step.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        kenv.kitchen_step(state, action, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ks.kitchen_step.launches == before + 1


@pytest.mark.gpu
def test_gradient_takes_the_eager_step():
    """Where a gradient flows through the step (an action that requires
    grad, grad mode on), `kitchen_step` runs the eager step on the card and
    the fingertip's gradient reaches the action; under no_grad the same
    input takes the kernel."""
    dev = _cuda()
    state, action = _pool()
    state = _to(_rows(state, slice(0, 16)), dev)
    action = action[:16].to(dev).requires_grad_(True)
    before = ks.kitchen_step.launches
    new = kenv.kitchen_step(state, action)[0]
    assert ks.kitchen_step.launches == before
    new.ee_pos.sum().backward()
    assert action.grad is not None and bool(action.grad.abs().sum() > 0)
    with torch.no_grad():
        kenv.kitchen_step(state, action)
    assert ks.kitchen_step.launches == before + 1
