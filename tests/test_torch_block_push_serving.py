"""The block-push data, scaling, rollout, workspace and CLI of
`beso_tpu_torch` against `beso_tpu`.

The rollout test replays the JAX rollout's draws: the port's reset returns
the JAX reset states and its action noise is `normal(step_key, (B, 2))` for
the JAX step keys (`beso_tpu/rollout/rollout.py:75,99`). Both packages'
contact-dither hash is replaced by the same smooth stand-in, as in
tests/test_torch_block_push.py, so that a contact does not decorrelate
the two trajectories.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import make_models, smooth_block_push_hashes, t

import beso_tpu.envs.block_push.env as jenv
import beso_tpu_torch.agents.policy as tpolicy
import beso_tpu_torch.envs.block_push.env as tenv
import beso_tpu_torch.rollout.rollout as trollout
from beso_tpu.agents.policy import PolicyConfig as JaxPolicyConfig
from beso_tpu.agents.policy import policy_predict, policy_reset
from beso_tpu.data.slicer import SlicedDataset as JSlicedDataset
from beso_tpu.data.transforms import blockpush_mask_targets as j_mask_targets
from beso_tpu.data.transforms import zero_goal_dims as j_zero_goal_dims
from beso_tpu.envs.block_push.goals import build_block_push_goals as j_build_goals
from beso_tpu.models.cached import make_rollout_denoise_factory as jax_factory
from beso_tpu.models.scaler import fit_minmax_scaler as j_fit_minmax
from beso_tpu.models.scaler import fit_scaler as j_fit_scaler
from beso_tpu.rollout import rollout_block_push as jax_rollout
from beso_tpu.train import trainer as jtr
from beso_tpu_torch.data.export import export_multimodal_push
from beso_tpu_torch.data.slicer import SlicedDataset
from beso_tpu_torch.data.trajectories import synthetic_push_data
from beso_tpu_torch.data.transforms import blockpush_mask_targets, zero_goal_dims
from beso_tpu_torch.envs.block_push.goals import block_push_goal_frames
from beso_tpu_torch.models.cached import make_rollout_denoise_factory
from beso_tpu_torch.models.scaler import fit_minmax_scaler, fit_scaler
from beso_tpu_torch.rollout import rollout_block_push
from beso_tpu_torch.train import trainer as ttr

SCALER_FIELDS = ("x_mean", "x_std", "y_mean", "y_std", "x_min", "x_max", "y_min", "y_max",
                 "x_bounds", "y_bounds")


# ---- transforms and the slicer ---------------------------------------------------

@pytest.mark.parametrize("mask_targets", [False, True])
@pytest.mark.parametrize("reduce_obs_dim", [False, True])
def test_mask_targets_variants_match_jax(mask_targets, reduce_obs_dim):
    """The 4 variants on 16- or 10-dim batches: exactly JAX's output, and
    the caller's batch left as it was."""
    rng = np.random.RandomState(0)
    d = 10 if reduce_obs_dim else 16
    batch = {"observation": rng.randn(4, 5, d).astype(np.float32),
             "action": rng.randn(4, 5, 2).astype(np.float32),
             "goal_observation": rng.randn(4, 1, d).astype(np.float32)}
    tb = {k: t(v) for k, v in batch.items()}
    got = blockpush_mask_targets(mask_targets, reduce_obs_dim)(tb)
    ref = j_mask_targets(mask_targets, reduce_obs_dim)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
        np.testing.assert_array_equal(tb[k].numpy(), batch[k], err_msg=k)
    for d_goal in (4, 10, 16):
        g = rng.randn(3, d_goal).astype(np.float32)
        np.testing.assert_array_equal(zero_goal_dims(t(g)).numpy(),
                                      np.asarray(j_zero_goal_dims(jnp.asarray(g))))


def test_slicer_transform_matches_jax():
    """The slicer with the block-push transform: the same windows as JAX's,
    the goal's non-block dims zero and its block dims from a real future
    frame."""
    data = synthetic_push_data(n_traj=8, t_max=30, seed=2)
    tf_t, tf_j = blockpush_mask_targets(True, False), j_mask_targets(True, False)
    jds = JSlicedDataset(data, window=5, future_conditional=True, future_seq_len=1,
                         transform=tf_j)
    tds = SlicedDataset(data, window=5, future_seq_len=1, transform=tf_t, device="cpu")
    idx = np.arange(0, len(tds), 2)
    jb = jds.batch_at(idx, jax.random.PRNGKey(0))
    tb = tds.batch_at(idx, torch.Generator().manual_seed(0))
    for k in ("observation", "action"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert not tb["observation"][..., 10:].any()
    goals = tb["goal_observation"].numpy()
    kept = [0, 1, 3, 4]
    assert not np.delete(goals, kept, axis=-1).any()
    slices = tds.slices.numpy()[idx]
    for row, (traj, start) in zip(goals, slices):
        lo, hi = start + 5, data.lengths[traj] - 1
        if lo < hi:
            assert any(np.array_equal(data.observations[traj, g, kept], row[0, kept])
                       for g in range(lo, hi))
    plain = SlicedDataset(data, window=5, future_seq_len=1, device="cpu")
    assert tds.sample_batch(torch.Generator().manual_seed(1), 6)["observation"].shape == \
        plain.sample_batch(torch.Generator().manual_seed(1), 6)["observation"].shape


# ---- scalers ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["minmax", "standard"])
@pytest.mark.parametrize("scale_data", [True, False])
def test_scaler_maps_match_jax(kind, scale_data):
    """Fitted fields (float64 on the host, stored f32) and every map against
    JAX's, to 1e-6 relative: the min-max kind's standardizing
    `scale_input` beside its [-1, 1] `inverse_scale_input`, the 4-dim goal
    case, and clip_action."""
    data = synthetic_push_data(n_traj=10, t_max=40, seed=4)
    obs, act = data.all_observations(), data.all_actions()
    fit_t, fit_j = ((fit_minmax_scaler, j_fit_minmax) if kind == "minmax"
                    else (fit_scaler, j_fit_scaler))
    ts, js = fit_t(obs, act, scale_data), fit_j(obs, act, scale_data)
    assert ts.kind == js.kind == kind and ts.scale_data == js.scale_data
    for name in SCALER_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, err_msg=name)
    rng = np.random.RandomState(1)
    x16, x4 = rng.randn(5, 16).astype(np.float32), rng.randn(5, 4).astype(np.float32)
    y = rng.randn(5, 2).astype(np.float32) * 0.05
    for fn, v in (("scale_input", x16), ("scale_input", x4), ("inverse_scale_input", x16),
                  ("scale_output", y), ("inverse_scale_output", y), ("clip_action", y * 40)):
        np.testing.assert_allclose(getattr(ts, fn)(t(v)).numpy(),
                                   np.asarray(getattr(js, fn)(jnp.asarray(v))),
                                   rtol=1e-6, atol=1e-7, err_msg=fn)
    if kind == "minmax" and scale_data:
        np.testing.assert_array_equal(ts.y_bounds.numpy(), [[-1, -1], [1, 1]])
        # outputs land in [-1, 1] over the fitted actions
        s = ts.scale_output(t(act)).numpy()
        assert s.min() >= -1 - 1e-6 and s.max() <= 1 + 1e-6


def test_adam_without_weight_decay_equals_optax_adam():
    """configs/block_push.yaml asks for `optimizer: adam, weight_decay: 0.0`:
    the port's torch Adam gives optax.adam's update (the JAX trainer's
    choice for that config) over 5 steps with the step-LR schedule, to 1e-7
    of the parameters (steps ~lr = 1e-4); AdamW at weight decay 0 is the
    same update."""
    from beso_tpu_torch.scripts.training import build_agent_config
    from beso_tpu_torch.utils.config import load_config

    cfg = build_agent_config(load_config("configs/block_push.yaml", []))
    assert (cfg.optimizer, cfg.weight_decay, cfg.lr) == ("adam", 0.0, 1e-4)
    rng = np.random.RandomState(0)
    p0 = rng.randn(50).astype(np.float32)
    grads = [rng.randn(50).astype(np.float32) * 10.0 ** rng.uniform(-3, 1) for _ in range(5)]
    jopt = jtr.make_optimizer(cfg.optimizer, cfg.lr, cfg.betas, cfg.weight_decay, 2, 0.5)
    jp, state = jnp.asarray(p0), None
    state = jopt.init(jp)
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    for name in ("adam", "adamw"):
        p = torch.nn.Parameter(t(p0))
        opt, sched = ttr.make_optimizer([p], name=name, lr=cfg.lr, betas=cfg.betas,
                                        weight_decay=cfg.weight_decay, lr_step_size=2,
                                        lr_gamma=0.5)
        for g in grads:
            p.grad = t(g)
            opt.step()
            sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7,
                                   err_msg=name)


# ---- the rollout -----------------------------------------------------------------

B, STEPS = 4, 6
MODEL = dict(state_dim=10, action_dim=2, goal_seq_len=1, obs_seq_len=5, n_heads=2)
CFG = dict(window_size=5, obs_dim=10, action_dim=2, num_sampling_steps=3, sigma_min=0.05,
           sigma_max=1.0, sampler_type="ddim", cond_lambda=2.0)


def _push_setup():
    data = synthetic_push_data(n_traj=16, t_max=40, seed=0)
    obs10 = data.all_observations()[:, :10]
    act = data.all_actions()
    frames, expected = block_push_goal_frames(data, B, seed=6)
    return fit_minmax_scaler(obs10, act), j_fit_minmax(obs10, act), frames, expected


@pytest.mark.parametrize("mask_targets", [False, True])
def test_rollout_block_push_matches_jax(mask_targets, monkeypatch):
    """4 envs x 6 steps with the min-max scaler, lambda = 2 CFG and the
    `cached` engine, at reduce_obs_dim True (mask off) and False (mask on,
    16-dim model): the actions of every step to 1e-4 (as the kitchen
    rollout's test), results and completions exactly, rewards to 1e-6."""
    smooth_block_push_hashes(monkeypatch)
    reduce = not mask_targets
    d = 10 if reduce else 16
    _, jden, params, tden = make_models(seed=41, **{**MODEL, "state_dim": d})
    data = synthetic_push_data(n_traj=16, t_max=40, seed=0)
    obs_all = data.all_observations()[:, :d]
    scaler, jscaler = (fit_minmax_scaler(obs_all, data.all_actions()),
                       j_fit_minmax(obs_all, data.all_actions()))
    frames, expected = block_push_goal_frames(data, B, seed=6)
    cfg_kw = {**CFG, "obs_dim": d}
    jcfg = JaxPolicyConfig(**cfg_kw)
    jfactory = jax_factory(jden, params, jscaler, jcfg, engine="cached")
    key = jax.random.PRNGKey(5)
    ref = jax_rollout(None, jscaler, jcfg, jnp.asarray(frames), jnp.asarray(expected), key,
                      n_steps=STEPS, reduce_obs_dim=reduce, mask_targets=mask_targets,
                      denoise_factory=jfactory)

    # the same loop step by step in JAX, for the per-step actions
    k_reset, k_roll = jax.random.split(key)
    step_keys = jax.random.split(k_roll, STEPS)
    env = jax.vmap(jenv.block_push_reset)(jax.random.split(k_reset, B))
    reset_state = env
    obs0 = jax.vmap(jenv.block_push_obs)(env)
    goals = j_build_goals(obs0, jnp.asarray(frames), 1, reduce_obs_dim=reduce)
    dn, obs = jfactory(goals), obs0[:, :d]
    pstate, jactions = policy_reset(B, jcfg), []
    jstep = jax.jit(jax.vmap(jenv.block_push_step))
    for k in step_keys:
        action, pstate = policy_predict(dn, jscaler, pstate, obs, goals, k, jcfg)
        env, obs_full, _, _ = jstep(env, action)
        obs = obs_full[:, :d]
        if mask_targets:
            obs = obs.at[:, 10:].set(0.0)
        jactions.append(np.asarray(action))

    noises = iter([np.asarray(jax.random.normal(k, (B, 2))) for k in step_keys])
    monkeypatch.setattr(tpolicy, "action_noise", lambda *a: t(next(noises)))
    monkeypatch.setattr(trollout, "block_push_reset", lambda *a: tenv.BlockPushState(
        *(torch.as_tensor(np.array(v)) for v in reset_state)))
    actions, real_step = [], trollout.block_push_step

    def recording_step(state, action):
        actions.append(action.numpy().copy())
        return real_step(state, action)

    monkeypatch.setattr(trollout, "block_push_step", recording_step)
    cfg = tpolicy.PolicyConfig(**cfg_kw)
    out = rollout_block_push(None, scaler, cfg, t(frames), t(expected), None, n_steps=STEPS,
                             reduce_obs_dim=reduce, mask_targets=mask_targets,
                             denoise_factory=make_rollout_denoise_factory(
                                 tden, scaler, cfg, engine="cached"))
    assert len(actions) == STEPS
    np.testing.assert_allclose(np.stack(actions), np.stack(jactions), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out.completed.numpy(), np.asarray(ref.completed))
    np.testing.assert_array_equal(out.results.numpy(), np.asarray(ref.results))
    np.testing.assert_allclose(out.rewards.numpy(), np.asarray(ref.rewards), atol=1e-6)
    assert out.env_steps == B * STEPS == int(ref.env_steps)
    assert (out.completion_order.numpy() == -1).all()


def test_rollout_goals_are_built_before_the_engine(monkeypatch):
    """The factory sees the flip-fixed [B, 1, 10] goals of the live reset."""
    scaler, _, frames, expected = _push_setup()
    seen = []

    def factory(goals):
        seen.append(goals.clone())
        return lambda s, a, g, sig: torch.zeros_like(a)

    gen = torch.Generator().manual_seed(0)
    state = tenv.block_push_reset(B, torch.Generator().manual_seed(0))
    monkeypatch.setattr(trollout, "block_push_reset", lambda *a: state)
    rollout_block_push(None, scaler, tpolicy.PolicyConfig(**CFG), t(frames), t(expected), gen,
                       n_steps=2, denoise_factory=factory)
    want = j_build_goals(jnp.asarray(tenv.block_push_obs(state).numpy()), jnp.asarray(frames), 1)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(want))


# ---- the workspace and the CLI -----------------------------------------------------

def test_workspace_wiring_matches_jax(tmp_path):
    """BlockPushWorkspace from `data=` against beso_tpu's: the split, the
    min-max scaler over the 10-dim train observations and the masked
    windows; then from `data_path` files written by export_multimodal_push,
    equal to `data=`."""
    from beso_tpu.workspaces import BlockPushWorkspace as JWorkspace
    from beso_tpu_torch.workspaces import BlockPushWorkspace

    data = synthetic_push_data(n_traj=20, t_max=40, seed=3)
    kw = dict(seed=6, window_size=5, goal_seq_len=1)
    jw, tw = JWorkspace(data=data, **kw), BlockPushWorkspace(data=data, **kw, device="cpu")
    assert (len(jw.train_set), len(jw.test_set)) == (len(tw.train_set), len(tw.test_set))
    assert tw.scaler.kind == jw.scaler.kind == "minmax"
    for name in SCALER_FIELDS:
        np.testing.assert_allclose(getattr(tw.scaler, name).numpy(),
                                   np.asarray(getattr(jw.scaler, name)), rtol=1e-6)
    assert tw.train_set.observations.shape[-1] == 10
    idx = np.arange(0, len(tw.test_set), 3)
    jb = jw.test_set.batch_at(idx, jax.random.PRNGKey(0))
    tb = tw.test_set.batch_at(idx, torch.Generator().manual_seed(0))
    for k in ("observation", "action"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert not tb["goal_observation"][..., [2, 5, 6, 7, 8, 9]].any()

    export_multimodal_push(data, tmp_path)
    from_path = BlockPushWorkspace(data_path=str(tmp_path), **kw, device="cpu")
    assert from_path.full_data.obs_dim == 16
    np.testing.assert_array_equal(from_path.full_data.observations, data.observations)
    for split in ("train_set", "test_set"):
        a, b = getattr(from_path, split), getattr(tw, split)
        for name in ("slices", "observations", "actions", "lengths"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (split, name)
    for name in SCALER_FIELDS:
        assert torch.equal(getattr(from_path.scaler, name), getattr(tw.scaler, name))
    std = BlockPushWorkspace(data=data, **kw, use_minmax_scaler=False, device="cpu")
    assert std.scaler.kind == "standard"


def test_workspace_evaluates_an_agent(tmp_path):
    """test_agent on a tiny trained agent (4 envs x 3 steps, on the fused
    engine's CPU fall-back to its plain version): the metric keys, values in
    range, and evaluate_multigoal / evaluate_sequential ignored."""
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.workspaces import BlockPushWorkspace

    ws = BlockPushWorkspace(seed=6, data=synthetic_push_data(24, 40, seed=2), eval_n_times=4,
                            eval_n_steps=3, device="cpu")
    cfg = BesoAgentConfig(obs_dim=10, action_dim=2, hidden_dim=32, n_layers=1, n_heads=2,
                          goal_seq_len=1, window_size=5, attn_pdrop=0.05, resid_pdrop=0.05,
                          cond_mask_prob=0.1, optimizer="adam", weight_decay=0.0,
                          max_train_steps=2, eval_every_n_steps=2, train_batch_size=8,
                          sigma_min=0.05, cond_lambda=2.0, inference_engine="fused_cached")
    agent = BesoAgent(cfg, ws.scaler, checkpoint_dir=str(tmp_path), device="cpu")
    agent.init(torch.Generator().manual_seed(0))
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator().manual_seed(1))
    runs = [ws.test_agent(agent, evaluate_multigoal=m, evaluate_sequential=s,
                          generator=torch.Generator().manual_seed(2), log_metrics=False)
            for m, s in ((True, True), (False, False))]
    assert runs[0] == runs[1]
    out = runs[0]
    assert set(out) == {"avrg_reward", "std_reward", "avrg_result", "std_result",
                        "cond_success_ratio"}
    assert all(math.isfinite(v) for v in out.values())
    assert 0.0 <= out["avrg_result"] <= 1.0 and out["avrg_reward"] >= 0.0


def test_training_cli_block_push_end_to_end(tmp_path):
    """`python -m beso_tpu_torch.scripts.training --config
    configs/block_push.yaml --device cpu` at a tiny size: 1 layer, width 48,
    4 heads, 4 steps, a final evaluation of 4 envs x 3 steps; the stored
    state and the metrics. Without --device it asks for the card, which a
    host without one refuses."""
    from beso_tpu_torch.scripts import training
    from beso_tpu_torch.workspaces import BlockPushWorkspace

    tiny = ["num_hidden_layers=1", "hidden_dim=48", "n_heads=4", "max_train_steps=4",
            "eval_every_n_steps=2", "train_batch_size=8", "eval_n_times=4", "eval_n_steps=3"]
    res = training.main(["--config", "configs/block_push.yaml", "--device", "cpu",
                         "--run-dir", str(tmp_path), *tiny])
    assert set(res) >= {"avrg_reward", "avrg_result", "cond_success_ratio"}
    assert all(math.isfinite(v) for v in res.values())
    for f in ("config.yaml", "metrics.jsonl", "train_state.pt"):
        assert (tmp_path / f).exists(), f
    import inspect

    assert inspect.signature(BlockPushWorkspace).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            training.main(["--config", "configs/block_push.yaml",
                           "--run-dir", str(tmp_path / "card"), *tiny])
