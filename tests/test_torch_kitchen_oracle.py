"""Parity of the port's kitchen oracle (`beso_tpu_torch/envs/kitchen/
oracle.py`) with `beso_tpu/envs/kitchen/oracle.py`.

The policy step (differential IK through the forward-mode fingertip
jacobian) is held on batches of given states, carries, task sequences and
styles; the draws by their distributions; short rollouts with the JAX
package's draws injected through `kitchen_draws`; the one-hot labelling
and tail truncation bit for bit on the same episodes; and the port alone
against `tests/test_kitchen_oracle.py`'s band (>= 3.8 of 4 tasks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_parity import t

import beso_tpu.envs.kitchen.env as jenv
import beso_tpu.envs.kitchen.oracle as joracle
import beso_tpu_torch.envs.kitchen.env as tenv
import beso_tpu_torch.envs.kitchen.oracle as toracle
from beso_tpu.envs.kitchen.fk import panda_fk as jax_fk

torch.set_num_threads(1)


def _state(js) -> tenv.KitchenState:
    return tenv.KitchenState(*(torch.as_tensor(np.array(v)) for v in js))


def _style(js) -> toracle.KitchenOracleStyle:
    out = [torch.as_tensor(np.array(v)) for v in js]
    return toracle.KitchenOracleStyle(*(v.long() if v.dtype == torch.int32 else v
                                        for v in out))


def _jax_draws(B, seed, play_style, kettle_boost=0.0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * B)
    seq = jax.vmap(lambda k: joracle.sample_task_sequence(k, 4, kettle_boost))(keys[:B])
    style = jax.vmap(lambda k: joracle.sample_kitchen_style(k, play_style))(keys[B:])
    return seq, style


def _given_states(B, seed, seq, style):
    """Arm configurations around the start pose, object joints part way,
    the fingertip (ee_pos) placed near the current task's handle in a third
    of the envs and near the detour point in a sixth, some grasps latched,
    some tasks completed, random carries."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(jenv.INIT_QPOS, np.float32), (B, 1))
    q[:, :7] += rng.uniform(-0.4, 0.4, (B, 7))
    q[:, 7:9] = rng.uniform(0.0, 0.04, (B, 2))
    for j, lo, hi in ((11, -0.9, 0.0), (15, -0.9, 0.0), (17, -0.7, 0.0), (19, 0.0, 0.4),
                      (21, 0.0, 1.4), (22, -0.8, 0.0)):
        q[:, j] = rng.uniform(lo, hi, B)
    q[:, 23:26] += rng.uniform(-0.1, 0.1, (B, 3))
    ptr = rng.randint(0, 5, B)
    steps = rng.randint(0, 80, B)
    seq_np = np.asarray(seq)
    task = np.maximum(seq_np[np.arange(B), np.minimum(ptr, 3)], 0)
    handles = np.asarray(jax.vmap(lambda qq: jenv.kitchen_handles(
        qq, jenv.DEFAULT_KITCHEN_PARAMS))(jnp.asarray(q)))
    ee = np.asarray(jax.vmap(lambda qq: jax_fk(qq, jenv.KITCHEN_BASE_POS))(jnp.asarray(q[:, :7])))
    pick = rng.rand(B)
    near = handles[np.arange(B), task] + rng.uniform(-0.03, 0.03, (B, 3))
    detour = (handles[np.arange(B), np.asarray(style.detour_task) * np.ones(B, int)]
              + np.asarray([0.0, -0.06, 0.04]) + rng.uniform(-0.05, 0.05, (B, 3)))
    ee = np.where((pick < 1 / 3)[:, None], near, np.where((pick > 5 / 6)[:, None], detour, ee))
    js = jenv.KitchenState(
        qpos=jnp.asarray(q), ee_pos=jnp.asarray(ee, jnp.float32),
        tasks_to_complete=jnp.ones((B, 7), bool),
        completed=jnp.asarray(rng.rand(B, 7) < 0.2),
        completion_order=jnp.full((B, 7), -1, jnp.int32),
        kettle_grasped=jnp.asarray(rng.rand(B) < 0.3),
        done=jnp.zeros(B, bool), steps=jnp.zeros(B, jnp.int32))
    jc = joracle.KitchenOracleCarry(task_ptr=jnp.asarray(ptr, jnp.int32),
                                    task_steps=jnp.asarray(steps, jnp.int32),
                                    detour_done=jnp.asarray(rng.rand(B) < 0.5))
    return js, jc


@pytest.mark.parametrize("play_style", [False, True])
def test_policy_step_matches_jax(play_style):
    """One step on 128 given states: the 9-dim actions within 1e-5 of max
    |ref| (the IK's joint velocities, clipped, and the finger command), the
    carry exactly; tasks advance, time out and hold."""
    B = 128
    seq, style = _jax_draws(B, 1, play_style)
    js, jc = _given_states(B, 2, seq, style)
    jact, jnext = jax.vmap(lambda s, c, q, st: joracle.kitchen_oracle_policy(
        s, c, q, jenv.DEFAULT_KITCHEN_PARAMS, st))(js, jc, seq, style)
    carry = toracle.KitchenOracleCarry(torch.as_tensor(np.array(jc.task_ptr)).long(),
                                       torch.as_tensor(np.array(jc.task_steps)).long(),
                                       torch.as_tensor(np.array(jc.detour_done)))
    act, nxt = toracle.kitchen_oracle_policy(_state(js), carry, t(seq).long(), None,
                                             _style(style))
    ref = np.asarray(jact)
    np.testing.assert_allclose(act.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    for name in ("task_ptr", "task_steps", "detour_done"):
        np.testing.assert_array_equal(getattr(nxt, name).numpy(),
                                      np.asarray(getattr(jnext, name)), err_msg=name)
    assert (ref[:, 7] == -1).any() and (ref[:, 7] == 1).any()     # fingers close / open
    assert (nxt.task_ptr.numpy() > np.asarray(jc.task_ptr)).any()
    assert (np.abs(ref[:, :7]) < 1).any() and (np.abs(ref[:, :7]) == 1).any()


def test_fingertip_jacobian_matches_jacfwd():
    """`fingertip_jacobian` (one batched jvp) against `jax.jacfwd` of the
    JAX FK, within 1e-5 of max |ref|."""
    q = np.random.RandomState(0).uniform(-2, 2, (16, 7)).astype(np.float32)
    ref = np.asarray(jax.vmap(jax.jacfwd(lambda x: jax_fk(x, jenv.KITCHEN_BASE_POS)))(
        jnp.asarray(q)))
    got = toracle.fingertip_jacobian(t(q)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_draws_match_jax_distribution():
    """4096 draws of each package: the task at every sequence position and
    the lead-kettle share under kettle_boost 0.5 by frequency (within 0.03),
    sequences are permutations; the play-style fields by KS (p > 1e-3) or
    frequency; the wander directions are unit vectors."""
    n = 4096
    jseq, jstyle = _jax_draws(n, 7, True, kettle_boost=0.5)
    g = torch.Generator().manual_seed(7)
    seq = toracle.sample_task_sequence(n, 4, 0.5, g)
    style = toracle.sample_kitchen_style(n, g, play_style=True)
    jseq = np.asarray(jseq)
    for pos in range(4):
        np.testing.assert_allclose(np.bincount(seq[:, pos].numpy(), minlength=7) / n,
                                   np.bincount(jseq[:, pos], minlength=7) / n, atol=0.03)
    assert all(len(set(r)) == 4 for r in seq.tolist())
    short = toracle.sample_task_sequence(8, 2, generator=g)
    assert (short[:, 2:] == -1).all() and (short[:, :2] >= 0).all()
    for name in ("speed_mult", "pause_prob"):
        assert stats.ks_2samp(getattr(style, name).numpy(),
                              np.asarray(getattr(jstyle, name))).pvalue > 1e-3, name
    for name, k in (("detour_task", 7), ("wander_steps", 25)):
        np.testing.assert_allclose(np.bincount(getattr(style, name).numpy(), minlength=k) / n,
                                   np.bincount(np.asarray(getattr(jstyle, name)),
                                               minlength=k) / n, atol=0.03, err_msg=name)
    assert abs(style.detour_gate.mean().item() - float(np.asarray(jstyle.detour_gate).mean())) \
        < 0.03
    np.testing.assert_allclose(style.wander_dir.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    clean = toracle.sample_kitchen_style(4)
    assert (clean.speed_mult == 1).all() and (clean.detour_gate == 0).all()


def inject_kitchen_draws(monkeypatch, key, B, n_steps, play_style):
    """Replace the port's `kitchen_draws` by the draws `rollout_kitchen_oracle`
    makes from `key` split over B episodes (JAX's task sequences and styles;
    per step the pause uniforms of fold_in(k, 1) and the action noise)."""
    keys = jax.random.split(key, B)
    parts = jax.vmap(lambda k: jax.random.split(k, 3))(keys)     # seq, noise, style
    step_keys = jax.vmap(lambda k: jax.random.split(k, n_steps))(parts[:, 1])
    per_step = jax.vmap(jax.vmap(lambda k: (jax.random.uniform(jax.random.fold_in(k, 1), ()),
                                            jax.random.normal(k, (9,)))))(step_keys)
    draws = {"task_seq": t(jax.vmap(lambda k: joracle.sample_task_sequence(k, 4))(
                 parts[:, 0])).long(),
             "style": _style(jax.vmap(lambda k: joracle.sample_kitchen_style(k, play_style))(
                 parts[:, 2])),
             "pause": np.asarray(per_step[0]), "action": np.asarray(per_step[1])}

    def fake(what, batch_size, generator, device, step=0, **kw):
        assert batch_size == B
        d = draws[what]
        return t(d[:, step]) if isinstance(d, np.ndarray) else d

    monkeypatch.setattr(toracle, "kitchen_draws", fake)


@pytest.mark.parametrize("play_style", [False, True])
def test_rollout_with_injected_draws_matches_jax(play_style, monkeypatch):
    """8 episodes x 40 steps (action noise 0.02) with JAX's draws injected:
    observations within 1e-4 and actions within 1e-4 of max |ref| at every
    step, completion flags and orders equal."""
    B, T = 8, 40
    key = jax.random.PRNGKey(5)
    inject_kitchen_draws(monkeypatch, key, B, T, play_style)
    jobs, jact, jcomp, jorder, jseq = jax.jit(jax.vmap(
        lambda k: joracle.rollout_kitchen_oracle(k, T, 4, 0.02, play_style=play_style)))(
        jax.random.split(key, B))
    obs, act, comp, order, seq = toracle.rollout_kitchen_oracle(B, T, 4, 0.02,
                                                                play_style=play_style)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=0)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert np.asarray(jcomp).any()


@pytest.fixture(scope="module")
def jax_episodes():
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    return jax.jit(jax.vmap(lambda k: joracle.rollout_kitchen_oracle(k, 140, 4, 0.02)))(keys)


def test_labelling_and_truncation_bit_for_bit(jax_episodes, monkeypatch):
    """JAX's `generate_kitchen_demonstrations` on given episodes against the
    port's labelling of the same episodes: one-hot rows and lengths equal."""
    obs, act, comp, order, seq = (np.asarray(a) for a in jax_episodes)
    monkeypatch.setattr(joracle.jax, "vmap", lambda f: lambda keys: jax_episodes)
    ref = joracle.generate_kitchen_demonstrations(jax.random.PRNGKey(0), n_episodes=8,
                                                  n_steps=140)
    monkeypatch.undo()
    data = toracle.label_kitchen_demonstrations(obs, act, comp, order)
    np.testing.assert_array_equal(data.onehot_goals, ref.onehot_goals)
    np.testing.assert_array_equal(data.lengths, ref.lengths)
    np.testing.assert_array_equal(data.observations, ref.observations)
    assert data.onehot_goals.sum() > 0 and (data.lengths < 140).any()


def test_port_oracle_within_success_band():
    """`tests/test_kitchen_oracle.py`'s band on the port alone: >= 3.8 of
    the 4 assigned tasks completed on average over 16 episodes x 280
    steps; the demo set's format."""
    g = torch.Generator().manual_seed(0)
    obs, act, completed, order, seqs = toracle.rollout_kitchen_oracle(16, 280, 4, generator=g)
    assigned = [sum(bool(completed[i, s]) for s in seqs[i].tolist() if s >= 0)
                for i in range(16)]
    assert np.mean(assigned) >= 3.8
    data = toracle.label_kitchen_demonstrations(obs.numpy(), act.numpy(),
                                                completed.numpy(), order.numpy())
    assert data.observations.shape == (16, 280, 30) and data.onehot_goals.shape == (16, 280, 7)
    assert data.onehot_goals.sum((1, 2)).mean() >= 3.8
