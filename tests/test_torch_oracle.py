"""Parity of the port's block-push oracle (`beso_tpu_torch/envs/block_push/
oracle.py`) with `beso_tpu/envs/block_push/oracle.py`.

The policy step is held on batches of given states, carries and params
(play-style included), the param draws by their distributions, short
rollouts with the JAX package's draws injected through `oracle_draws` on
the smooth stand-in hash (the shipped sin-hash decorrelates at an ulp,
`torch_parity.smooth_block_push_hashes`), the one-hot labelling and tail
truncation bit for bit on the same observations, and the port alone
against `tests/test_oracle.py`'s success bands.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch_parity import smooth_block_push_hashes, t

import beso_tpu.envs.block_push.env as jenv
import beso_tpu.envs.block_push.oracle as joracle
import beso_tpu_torch.envs.block_push.env as tenv
import beso_tpu_torch.envs.block_push.oracle as toracle

torch.set_num_threads(1)


def _state(js) -> tenv.BlockPushState:
    return tenv.BlockPushState(*(torch.as_tensor(np.array(v)) for v in js))


def _params(jp) -> toracle.OracleParams:
    out = [torch.as_tensor(np.array(v)) for v in jp]
    return toracle.OracleParams(*(v.long() if v.dtype == torch.int32 else v for v in out))


def _jax_params(B, seed, play_style):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(lambda k: joracle.sample_oracle_params(k, play_style))(keys)


def _given_states(B, seed, jp):
    """JAX resets with the commanded effector scattered over the workspace,
    a third of it at the pre-push pose of the current block (within the
    reach tolerance or just outside), a sixth of the current blocks moved
    next to their target, and random carries."""
    rng = np.random.RandomState(seed)
    js = jax.vmap(jenv.block_push_reset)(jax.random.split(jax.random.PRNGKey(seed), B))
    cur = rng.randint(0, 3, B)
    idx = np.minimum(cur, 1)
    order, assign = np.asarray(jp.block_order), np.asarray(jp.target_assign)
    block, target = order[np.arange(B), idx], assign[np.arange(B), idx]
    bpos = np.array(js.block_pos)
    tpos = np.asarray(js.target_pos)[np.arange(B), target]
    near_target = rng.rand(B) < 1 / 6
    bpos[np.arange(B), block] = np.where(
        near_target[:, None], tpos + rng.uniform(-0.04, 0.04, (B, 2)),
        bpos[np.arange(B), block])
    b = bpos[np.arange(B), block]
    d = (tpos - b) / np.linalg.norm(tpos - b, axis=1, keepdims=True)
    ab = np.asarray(jp.approach_bias) * np.ones(B)
    ca, sa = np.cos(ab), np.sin(ab)
    pre = b - 0.07 * np.stack([ca * d[:, 0] - sa * d[:, 1], sa * d[:, 0] + ca * d[:, 1]], 1)
    eff = np.where((rng.rand(B) < 1 / 3)[:, None], pre + rng.uniform(-0.02, 0.02, (B, 2)),
                   rng.uniform([0.15, -0.5], [0.7, 0.5], (B, 2)))
    js = js._replace(block_pos=jnp.asarray(bpos, jnp.float32),
                     effector_target=jnp.asarray(eff, jnp.float32),
                     effector=jnp.asarray(eff, jnp.float32))
    jc = joracle.OracleCarry(cur_idx=jnp.asarray(cur, jnp.int32),
                             phase=jnp.asarray(rng.randint(0, 2, B), jnp.int32),
                             detour_done=jnp.asarray(rng.rand(B) < 0.5))
    return js, jc


@pytest.mark.parametrize("play_style", [False, True])
def test_policy_step_matches_jax(play_style):
    """One step on 256 given states: actions within 1e-5 of max |ref|, the
    carry (block index, phase, detour latch) exactly; every transition is
    taken somewhere."""
    B = 256
    jp = _jax_params(B, 3, play_style)
    js, jc = _given_states(B, 4, jp)
    jact, jnext = jax.vmap(joracle.oracle_policy)(js, jc, jp)
    carry = toracle.OracleCarry(*(torch.as_tensor(np.array(v)) for v in jc))
    carry = carry._replace(cur_idx=carry.cur_idx.long(), phase=carry.phase.long())
    act, nxt = toracle.oracle_policy(_state(js), carry, _params(jp))
    ref = np.asarray(jact)
    np.testing.assert_allclose(act.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    for name in ("cur_idx", "phase", "detour_done"):
        np.testing.assert_array_equal(getattr(nxt, name).numpy(),
                                      np.asarray(getattr(jnext, name)), err_msg=name)
    cur0, ph0 = np.asarray(jc.cur_idx), np.asarray(jc.phase)
    cur1, ph1 = nxt.cur_idx.numpy(), nxt.phase.numpy()
    assert (cur1 > cur0).any()                         # a block done
    assert ((ph0 == 0) & (ph1 == 1)).any()             # reach -> push
    assert ((ph0 == 1) & (ph1 == 0) & (cur1 == cur0)).any()   # contact lost
    assert (np.abs(ref[cur1 >= 2]) == 0).all()


def test_param_draws_match_jax_distribution():
    """4096 play-style draws of each package: the continuous fields by a
    two-sample KS test (p > 1e-3), the coin flips and the wander steps by
    their frequencies (within 0.03), and the ranges."""
    n = 4096
    jp = _jax_params(n, 5, True)
    tp = toracle.sample_oracle_params(n, torch.Generator().manual_seed(5), play_style=True)
    for name in ("approach_bias", "speed_mult", "pause_prob"):
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert stats.ks_2samp(a, b).pvalue > 1e-3, name
    for i in range(2):
        assert stats.ks_2samp(tp.detour[:, i].numpy(), np.asarray(jp.detour)[:, i]).pvalue > 1e-3
    for name, k in (("block_order", 2), ("target_assign", 2), ("wander_steps", 20)):
        a = getattr(tp, name).numpy().reshape(n, -1)[:, 0]
        b = np.asarray(getattr(jp, name)).reshape(n, -1)[:, 0]
        np.testing.assert_allclose(np.bincount(a, minlength=k) / n,
                                   np.bincount(b, minlength=k) / n, atol=0.03, err_msg=name)
    assert abs(tp.detour_gate.mean().item() - float(np.asarray(jp.detour_gate).mean())) < 0.03
    assert (tp.block_order.sum(1) == 1).all() and (tp.target_assign.sum(1) == 1).all()
    assert tp.speed_mult.min() >= 0.6 and tp.speed_mult.max() <= 1.4
    assert tp.pause_prob.min() >= 0.0 and tp.pause_prob.max() <= 0.15
    clean = toracle.sample_oracle_params(8, torch.Generator().manual_seed(0))
    assert (clean.speed_mult == 1).all() and (clean.pause_prob == 0).all()
    assert (clean.detour_gate == 0).all() and (clean.wander_steps == 0).all()


def inject_oracle_draws(monkeypatch, key, B, n_steps, play_style):
    """Replace the port's `oracle_draws` by the draws `rollout_oracle` makes
    from `key` split over B episodes (JAX's reset and params rows; per step
    the action noise, the wander jitter and the pause uniforms)."""
    keys = jax.random.split(key, B)
    parts = jax.vmap(lambda k: jax.random.split(k, 4))(keys)     # env, par, noise, wd
    step_keys = jax.vmap(lambda k: jax.random.split(k, n_steps))(parts[:, 2])
    sub = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 3)))(step_keys)   # [B, T, 3]
    draws = {
        "reset": _state(jax.vmap(jenv.block_push_reset)(parts[:, 0])),
        "params": _params(jax.vmap(lambda k: joracle.sample_oracle_params(k, play_style))(
            parts[:, 1])),
        "wander": t(jax.vmap(lambda k: jax.random.normal(k, (2,)))(parts[:, 3])),
        "action": np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (2,))))(
            sub[:, :, 0])),
        "wander_step": np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (2,))))(
            sub[:, :, 1])),
        "pause": np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ())))(
            sub[:, :, 2])),
    }

    def fake(what, batch_size, generator, device, step=0, play_style=False):
        assert batch_size == B
        d = draws[what]
        return t(d[:, step]) if isinstance(d, np.ndarray) else d

    monkeypatch.setattr(toracle, "oracle_draws", fake)


@pytest.mark.parametrize("play_style", [False, True])
def test_rollout_with_injected_draws_matches_jax(play_style, monkeypatch):
    """8 episodes x 25 steps (action noise 0.004) on the smooth stand-in
    hash with JAX's draws injected: observations and actions within 1e-5
    at every step, completion flags equal."""
    smooth_block_push_hashes(monkeypatch)
    B, T = 8, 25
    key = jax.random.PRNGKey(11)
    inject_oracle_draws(monkeypatch, key, B, T, play_style)
    jobs, jact, jcomp, jin = jax.jit(jax.vmap(
        lambda k: joracle.rollout_oracle(k, T, 0.004, play_style)))(jax.random.split(key, B))
    obs, act, comp, in_target = toracle.rollout_oracle(B, T, 0.004, play_style)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
    np.testing.assert_array_equal(in_target.numpy(), np.asarray(jin))
    assert float(np.abs(np.diff(np.asarray(jobs)[..., 8:10], axis=1)).max()) > 1e-3


@pytest.fixture(scope="module")
def jax_demos():
    return joracle.generate_demonstrations(jax.random.PRNGKey(2), n_episodes=8, n_steps=120)


def test_labelling_and_truncation_bit_for_bit(jax_demos):
    """The port's labelling of JAX's demo observations equals JAX's: one-hot
    rows, lengths and the arrays passed through."""
    data = toracle.label_demonstrations(np.asarray(jax_demos.observations),
                                        np.asarray(jax_demos.actions))
    np.testing.assert_array_equal(data.onehot_goals, jax_demos.onehot_goals)
    np.testing.assert_array_equal(data.lengths, jax_demos.lengths)
    np.testing.assert_array_equal(data.observations, jax_demos.observations)
    assert data.onehot_goals.sum() > 0 and (data.lengths < 120).any()


def test_port_oracle_within_success_bands():
    """`tests/test_oracle.py`'s bands on the port alone, shipped hash, from
    one batch of 16 episodes x 250 steps (action noise 0.004): both blocks
    done in >= 90% of them; >= 1.5 labels per episode over their first 200
    steps (a 200-step demo of the same episodes), actions within the env's
    cap."""
    g = torch.Generator().manual_seed(0)
    obs, act, completed, _ = toracle.rollout_oracle(16, 250, 0.004, generator=g)
    assert (completed.sum(1) >= 2).float().mean() >= 0.9
    data = toracle.label_demonstrations(obs[:, :200].numpy(), act[:, :200].numpy())
    assert data.observations.shape == (16, 200, 16)
    assert data.actions.shape == (16, 200, 2) and data.onehot_goals.shape == (16, 200, 4)
    assert data.onehot_goals.sum((1, 2)).mean() >= 1.5
    assert np.abs(data.actions).max() <= 0.1 + 1e-6
