"""The training slice of `beso_tpu_torch` against `beso_tpu` (CPU, f32 unless
noted): EDM loss and gradients (131-token flash path and window-4
broadcast path), AdamW/StepLR/EMA over three injected train steps, sigma
densities, dropout and goal-mask rates, slicing, evaluation, checkpoints,
workspace wiring and the training CLI end to end."""

import json
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats
from torch_parity import make_inputs, make_models, t

from beso_tpu.core import densities as jdens
from beso_tpu.core.schedules import get_sigmas_exponential as j_sigmas_exponential
from beso_tpu.data.slicer import SlicedDataset as JSlicedDataset
from beso_tpu.data.slicer import make_slices as j_make_slices
from beso_tpu.models import ema as jema
from beso_tpu.models.scaler import fit_scaler as j_fit_scaler
from beso_tpu.sampling.samplers import sample_loop as j_sample_loop
from beso_tpu.train import trainer as jtr
from beso_tpu_torch.core import densities as tdens
from beso_tpu_torch.data.slicer import SlicedDataset, make_slices
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models import ema as tema
from beso_tpu_torch.models.convert import params_to_numpy_tree
from beso_tpu_torch.models.gpt import DiffusionGPT, dropout
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.train import checkpoint, trainer as ttr


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(got, want, rtol, atol_frac, what=""):
    """Leaf by leaf: |got - want| <= atol_frac * max|want| + rtol * |want|."""
    g, w = dict(_leaves(got)), dict(_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    for name in w:
        atol = atol_frac * max(float(np.abs(w[name]).max()), 1e-30)
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def _grads(model):
    return params_to_numpy_tree(model, {n: p.grad for n, p in model.named_parameters()})


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

LOSS_CASES = {
    # 131 tokens through the flash kernels' plain versions vs Pallas (interpret)
    "pallas_131": (dict(obs_seq_len=64, attention="pallas", n_layers=1), False),
    "broadcast_w4": (dict(attention="broadcast"), False),
    "broadcast_w4_last_action": (dict(attention="broadcast"), True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_jax(case):
    """f32: loss to 1e-5 relative; every gradient leaf to 1e-4 relative plus
    1e-5 of the leaf's max (sums over batch and tokens in another order)."""
    over, last_only = LOSS_CASES[case]
    kw, jden, params, tden = make_models(seed=11, **over)
    s, a, g, sig = make_inputs(kw, B=3, seed=12)
    noise = np.random.RandomState(13).randn(*a.shape).astype(np.float32)

    def jloss(p):
        return jden.loss(p, *(jnp.asarray(x) for x in (s, a, g, noise, sig)),
                         pred_last_action_only=last_only, train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    model = tden.inner_model
    loss = tden.loss(t(s), t(a), t(g), t(noise), t(sig),
                     pred_last_action_only=last_only, train=True)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert_trees_close(_grads(model), jg, rtol=1e-4, atol_frac=1e-5, what=case)


# ---------------------------------------------------------------------------
# optimizer, schedule, EMA
# ---------------------------------------------------------------------------

def _batch(rng, B, T, G):
    return dict(observation=rng.randn(B, T, 30).astype(np.float32),
                action=np.clip(rng.randn(B, T, 9), -1, 1).astype(np.float32),
                goal_observation=rng.randn(B, G, 30).astype(np.float32))


def test_three_train_steps_match_optax_and_ema():
    """Three steps with injected batch, sigma and noise: parameters, AdamW
    moments and the EMA shadow against optax.adamw + `ema_update`. f32;
    params and EMA to 1e-6 absolute (Adam steps are ~lr = 1e-4 each) but
    for elements with rounding-level gradients, moments to 1e-4 relative
    plus 1e-5 of each leaf's max; the key bias apart (`_key_bias_apart`)."""
    kw, jden, params, tden = make_models(seed=21)
    rng = np.random.RandomState(22)
    T, G, B = kw["obs_seq_len"], kw["goal_seq_len"], 4
    data = [_batch(rng, B, T, G) for _ in range(3)]
    sigmas = [np.exp(rng.uniform(-4, 0, B)).astype(np.float32) for _ in range(3)]
    noises = [rng.randn(B, T, 9).astype(np.float32) for _ in range(3)]
    obs = np.concatenate([d["observation"].reshape(-1, 30) for d in data])
    act = np.concatenate([d["action"].reshape(-1, 9) for d in data])

    jscaler = j_fit_scaler(obs, act, scale_data=True)
    jopt = jtr.make_optimizer("adamw", 1e-4, (0.9, 0.999), 0.01, 100, 0.99)
    opt_state, ema = jopt.init(params), jema.ema_init(params)
    grad_fn = jax.jit(jax.grad(lambda p, st, at, gt, n, sig: jden.loss(
        p, st, at, gt, n, sig, train=True, rngs={"dropout": jax.random.PRNGKey(0)})))
    for d, sig, n in zip(data, sigmas, noises):
        st, at, gt = jtr.process_batch({k: jnp.asarray(v) for k, v in d.items()}, jscaler)
        grads = grad_fn(params, st, at, gt, jnp.asarray(n), jnp.asarray(sig))
        updates, opt_state = jopt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jema.ema_update(ema, params, 0.999)

    tscaler = fit_scaler(obs, act, scale_data=True)
    trainer = ttr.Trainer(tden, partial(ttr.make_optimizer, name="adamw"),
                          sample_density=None, scaler=tscaler)
    ts = trainer.init_state()
    step = ttr.make_train_step(tden, None, tscaler, ema_decay=0.999)
    for d, sig, n in zip(data, sigmas, noises):
        loss = step(ts, {k: t(v) for k, v in d.items()}, None, sigma=t(sig), noise=t(n))
        assert torch.isfinite(loss)

    model, lr = ts.model, 1e-4
    assert ts.step == 3 and ts.ema.num_updates == int(ema.num_updates) == 3
    named = dict(model.named_parameters())
    adam, state = opt_state[0], ts.optimizer.state
    pairs = [("params", params_to_numpy_tree(model), params, 0.0, 1e-6),
             ("exp_avg", {n: state[p]["exp_avg"] for n, p in named.items()},
              adam.mu, 1e-4, 1e-5),
             ("exp_avg_sq", {n: state[p]["exp_avg_sq"] for n, p in named.items()},
              adam.nu, 1e-4, 1e-5),
             ("ema", ts.ema.params, ema.params, 0.0, 1e-6)]
    for what, got, want, rtol, tol in pairs:
        if what in ("exp_avg", "exp_avg_sq", "ema"):
            got = params_to_numpy_tree(model, got)
        got, want = _key_bias_apart(got), _key_bias_apart(want)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            if name.endswith("#key"):
                # zero gradient in exact arithmetic: Adam turns the rounding
                # noise on either side into steps of up to lr each
                np.testing.assert_allclose(got[name], w, rtol=0, atol=3 * lr,
                                           err_msg=f"{what} {name}")
                continue
            if what in ("params", "ema"):
                # an element whose gradient is at rounding level on both
                # sides steps by up to lr differently (Adam normalises it),
                # and the EMA follows: at most 0.1% of a leaf, each within 3 lr
                diff = np.abs(got[name] - w)
                assert diff.max() <= 3 * lr, name
                assert (diff > tol).mean() <= 1e-3, (name, (diff > tol).sum())
                continue
            atol = tol * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol,
                                       err_msg=f"{what} {name}")


def _key_bias_apart(tree):
    """Flatten a flax-named tree and move the key third of every qkv bias to
    a leaf of its own ("...#key"). That bias adds the same q.b_k to every
    score of a row, which the softmax ignores: its gradient is zero in
    exact arithmetic and rounding noise in f32, on both sides."""
    out = {}
    for name, a in _leaves(jax.tree.map(np.asarray, tree)):
        if name.endswith("/attn/qkv/bias"):
            q, k, v = np.split(a, 3)
            out[name] = np.concatenate([q, v])
            out[name + "#key"] = k
        else:
            out[name] = a
    return out


@pytest.mark.parametrize("count", [0, 99, 100, 250])
def test_step_lr_schedule_matches_optax(count):
    want = float(jtr.step_lr_schedule(1e-4, 100, 0.99)(jnp.asarray(count)))
    assert math.isclose(ttr.step_lr_schedule(1e-4, 100, 0.99)(count), want, rel_tol=1e-6)
    # the optimizer's rate at train step `count` (scheduler stepped after each step)
    opt, sched = ttr.make_optimizer([torch.nn.Parameter(torch.zeros(2))], lr=1e-4)
    for _ in range(count):
        opt.step()
        sched.step()
    assert math.isclose(opt.param_groups[0]["lr"], want, rel_tol=1e-6)


def test_ema_update_and_warmup_match_jax():
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jstate = jema.ema_init(jax.tree.map(jnp.asarray, tree))
    tstate = tema.ema_init((k, t(v)) for k, v in tree.items())
    for i in range(12):
        new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}
        jstate = jema.ema_update(jstate, jax.tree.map(jnp.asarray, new), 0.9)
        tema.ema_update(tstate, ((k, t(v)) for k, v in new.items()), 0.9)
    for k in tree:
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(jstate.params[k]),
                                   rtol=1e-6, atol=1e-7)
    jw, tw = jema.EMAWarmup(inv_gamma=2.0, power=0.75), tema.EMAWarmup(inv_gamma=2.0, power=0.75)
    for _ in range(5):
        assert tw.get_value() == jw.get_value()
        jw.step()
        tw.step()


# ---------------------------------------------------------------------------
# densities, dropout, goal mask
# ---------------------------------------------------------------------------

DENSITIES = {
    "lognormal": dict(loc=-0.6, scale=1.6),
    "loglogistic": {},
    "loguniform": {},
    "uniform": {},
    "v-diffusion": {},
    "discrete": dict(discrete_values=[0.005, 0.07, 0.3, 1.0]),
    "split-lognormal": dict(loc=-0.5, scale=1.2),
}


@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_density_matches_jax_distribution(name):
    """Two-sample KS test, 5000 draws each: the port's draws come from the
    same distribution as the JAX sampler's (p > 1e-3)."""
    kw = DENSITIES[name]
    jd = np.asarray(jdens.make_sample_density(name, 0.5, 0.005, 1.0, **kw)(
        jax.random.PRNGKey(0), (5000,)))
    td = tdens.make_sample_density(name, 0.5, 0.005, 1.0, **kw)(
        torch.Generator().manual_seed(0), (5000,))
    assert td.dtype == torch.float32 and td.shape == (5000,)
    assert stats.ks_2samp(jd, td.numpy()).pvalue > 1e-3
    if name in ("loglogistic", "loguniform", "uniform", "v-diffusion"):
        assert 0.005 <= td.min().item() and td.max().item() <= 1.0 + 1e-6


def test_dropout_rate_and_scale():
    n, rate = 200_000, 0.3
    for dtype in (torch.float32, torch.bfloat16):
        y = dropout(torch.ones(n, dtype=dtype), rate, torch.Generator().manual_seed(1))
        assert y.dtype == dtype
        zero = (y == 0).float().mean().item()
        assert abs(zero - rate) < 4 * math.sqrt(rate * (1 - rate) / n)
        kept = y[y != 0].float()
        assert torch.allclose(kept, torch.full_like(kept, 1 / (1 - rate)), rtol=1e-2)


def test_goal_mask_rate_and_train_randomness():
    """train=True zeroes goal elements with probability cond_mask_prob (as
    `gpt.py:218-226`); the same generator seed gives the same forward."""
    torch.manual_seed(0)
    m = DiffusionGPT(30, 9, 32, 1, 2, 2, 4, cond_mask_prob=0.25, resid_pdrop=0.1,
                     generator=torch.Generator().manual_seed(0))
    seen = []
    orig = m.embed_goals
    m.embed_goals = lambda goals, drop=None: seen.append(goals) or orig(goals, drop)
    rng = np.random.RandomState(0)
    s, a = t(rng.randn(64, 4, 30).astype(np.float32)), t(rng.randn(64, 4, 9).astype(np.float32))
    g = t(rng.rand(64, 2, 30).astype(np.float32) + 0.5)
    sig = torch.full((64,), 0.3)
    out1 = m(s, a, g, sig, train=True, generator=torch.Generator().manual_seed(5))
    out2 = m(s, a, g, sig, train=True, generator=torch.Generator().manual_seed(5))
    m(s, a, g, sig)                                      # eval: no mask
    assert torch.equal(out1, out2)
    masked = (seen[0] == 0).float().mean().item()
    assert abs(masked - 0.25) < 4 * math.sqrt(0.25 * 0.75 / g.numel())
    assert torch.equal(seen[2], g)
    assert not torch.equal(out1, m(s, a, g, sig))


def test_attention_knob_follows_jax():
    m = DiffusionGPT(30, 9, 32, 1, 2, 2, 64, attn_pdrop=0.3)
    assert m.attention_impl(131, train=False) == "pallas"
    assert m.attention_impl(131, train=True) == "broadcast"   # dropout active
    assert m.attention_impl(11, train=False) == "broadcast"
    m.attention = "pallas"
    with pytest.raises(ValueError, match="attn_pdrop"):
        m.attention_impl(131, train=True)
    with pytest.raises(ValueError, match="attention must be"):
        DiffusionGPT(30, 9, 32, 1, 2, 2, 4, attention="flash")


# ---------------------------------------------------------------------------
# data, evaluation, checkpoints, workspace, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_future_sep", [0, 3])
def test_slices_and_batches_match_jax(min_future_sep):
    """Slice table, windows and the goal rule against the JAX slicer: the
    same observations and actions; zero goals exactly where JAX has them
    (no future window), elsewhere a real window starting in
    [end + min_future_sep, T - G) (the draw itself differs by RNG)."""
    data = synthetic_kitchen_data(n_traj=6, t_max=30, seed=1)
    np.testing.assert_array_equal(make_slices(data.lengths, 8),
                                  j_make_slices(data.lengths, 8))
    kw = dict(window=8, future_seq_len=2, min_future_sep=min_future_sep)
    jds = JSlicedDataset(data, future_conditional=True, **kw)
    tds = SlicedDataset(data, **kw, device="cpu")
    assert len(jds) == len(tds)
    idx = np.arange(0, len(tds), 3)
    jb = jds.batch_at(idx, jax.random.PRNGKey(0))
    tb = tds.batch_at(idx, torch.Generator().manual_seed(0))
    for k in ("observation", "action"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    goals = tb["goal_observation"].numpy()
    np.testing.assert_array_equal(goals.any(axis=(1, 2)),
                                  np.asarray(jb["goal_observation"]).any(axis=(1, 2)))
    for row, (traj, start) in zip(goals, make_slices(data.lengths, 8)[idx]):
        lo, hi = start + 8 + min_future_sep, data.lengths[traj] - 2
        if lo >= hi:
            assert not row.any()
            continue
        assert any(np.array_equal(data.observations[traj, g0:g0 + 2], row)
                   for g0 in range(lo, hi)), (traj, start)


def test_sample_and_epoch_batches_shapes():
    tds = SlicedDataset(synthetic_kitchen_data(n_traj=4, t_max=40), window=6,
                        future_seq_len=2, device="cpu")
    b = tds.sample_batch(torch.Generator().manual_seed(0), 5)
    assert b["observation"].shape == (5, 6, 30) and b["goal_observation"].shape == (5, 2, 30)
    ep = list(tds.epoch_batches(7))
    assert len(ep) == len(tds) // 7
    again = list(tds.epoch_batches(7))
    assert torch.equal(ep[0]["goal_observation"], again[0]["goal_observation"])


def test_evaluate_mse_matches_jax_on_same_noise():
    """DDIM generation MSE with the same initial noise on both sides (the
    port draws it from its generator first)."""
    kw, jden, params, tden = make_models(seed=31)
    rng = np.random.RandomState(32)
    d = _batch(rng, 5, kw["obs_seq_len"], kw["goal_seq_len"])
    scaler = fit_scaler(d["observation"], d["action"], scale_data=False)
    jscaler = j_fit_scaler(d["observation"], d["action"], scale_data=False)
    got = ttr.evaluate_mse(tden, None, {k: t(v) for k, v in d.items()}, scaler,
                           torch.Generator().manual_seed(4))
    x = torch.randn(d["action"].shape, generator=torch.Generator().manual_seed(4))
    st, at, gt = jtr.process_batch({k: jnp.asarray(v) for k, v in d.items()}, jscaler)
    x0 = j_sample_loop("ddim", lambda acts, sig: jden.apply(params, st, acts, gt, sig),
                       jnp.asarray(x.numpy()), j_sigmas_exponential(3, 0.005, 1.0),
                       jax.random.PRNGKey(0))
    want = float(jnp.mean((x0 - at) ** 2))
    assert math.isclose(got.item(), want, rel_tol=1e-5)


def _small_agent(tmp_path, device="cpu"):
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig
    from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

    ws = FrankaKitchenWorkspace(seed=42, data=synthetic_kitchen_data(24, 40, seed=2),
                                window_size=4, goal_seq_len=2, eval_n_times=3,
                                eval_n_steps=2, device=device)
    cfg = BesoAgentConfig(hidden_dim=32, n_layers=1, n_heads=2, attn_pdrop=0.1,
                          cond_mask_prob=0.1, max_train_steps=4, eval_every_n_steps=2,
                          train_batch_size=8, cond_lambda=1.5)
    agent = BesoAgent(cfg, ws.scaler, checkpoint_dir=str(tmp_path), device=device)
    agent.init(torch.Generator().manual_seed(0))
    return ws, agent


def test_checkpoint_round_trip(tmp_path):
    """save -> more steps -> restore gives back params, AdamW moments, LR
    schedule, EMA and step; a step after the restore equals the step that
    followed the save."""
    ws, agent = _small_agent(tmp_path)
    ts, tr = agent.state, agent.trainer
    step = tr._train_step()
    batch = ws.train_set.sample_batch(torch.Generator().manual_seed(1), 8)
    for _ in range(2):
        step(ts, batch, torch.Generator().manual_seed(2))
    checkpoint.save_train_state(ts, tmp_path, "ck")
    step(ts, batch, torch.Generator().manual_seed(3))
    after = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    checkpoint.restore_train_state(ts, tmp_path, "ck")
    assert ts.step == 2 and ts.ema.num_updates == 2
    assert ts.scheduler.last_epoch == 2
    step(ts, batch, torch.Generator().manual_seed(3))
    for n, p in ts.model.named_parameters():
        assert torch.equal(p, after[n]), n
    state = next(iter(ts.optimizer.state.values()))
    assert int(state["step"]) == 3


def test_agent_trains_and_evaluates(tmp_path):
    """BesoAgent.train_agent in step mode keeps the best and final
    checkpoints; the EMA weights drive the cached-engine rollout."""
    ws, agent = _small_agent(tmp_path)
    agent.train_agent(ws.train_set, ws.test_set, torch.Generator().manual_seed(3))
    assert agent.state.step == 4
    assert (tmp_path / "best.pt").exists() and (tmp_path / "final.pt").exists()
    ema_den = agent.eval_denoiser()
    for n, p in ema_den.inner_model.named_parameters():
        assert torch.equal(p, agent.state.ema.params[n])
    assert agent.make_denoise_factory(agent.policy_config()) is not None  # cached
    out = ws.test_agent(agent, generator=torch.Generator().manual_seed(0),
                        log_metrics=False, cond_lambda=1.5)
    assert set(out) >= {"avrg_reward", "avrg_result", "success_rate_1", "task_tree"}


def test_workspace_wiring_matches_jax():
    from beso_tpu.workspaces import FrankaKitchenWorkspace as JWorkspace
    from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

    data = synthetic_kitchen_data(20, 50, seed=3)
    kw = dict(seed=7, data=data, window_size=5, goal_seq_len=2, scale_data=True)
    jw, tw = JWorkspace(**kw), FrankaKitchenWorkspace(**kw, device="cpu")
    assert (len(jw.train_set), len(jw.test_set)) == (len(tw.train_set), len(tw.test_set))
    for name in ("x_mean", "x_std", "y_mean", "y_std", "y_bounds"):
        np.testing.assert_allclose(getattr(tw.scaler, name).numpy(),
                                   np.asarray(getattr(jw.scaler, name)), rtol=1e-6)
    y = np.random.RandomState(0).randn(3, 9).astype(np.float32)
    np.testing.assert_allclose(tw.scaler.scale_output(t(y)).numpy(),
                               np.asarray(jw.scaler.scale_output(jnp.asarray(y))), rtol=1e-6)
    x = np.ones((2, 30), np.float32)
    np.testing.assert_allclose(tw.scaler.inverse_scale_input(t(x)).numpy(),
                               np.asarray(jw.scaler.inverse_scale_input(jnp.asarray(x))),
                               rtol=1e-6)


def test_training_cli_end_to_end(tmp_path):
    """`python -m beso_tpu_torch.scripts.training` on the chunked config with
    tiny overrides: 1 layer, width 32, 4 steps, evaluation every 2, a final
    evaluation of 4 envs x 3 steps; then 2 more steps resumed from its
    stored train state."""
    from beso_tpu_torch.scripts import training

    cfg = ["--config", "configs/franka_kitchen_chunked.yaml", "--device", "cpu"]
    tiny = ["num_hidden_layers=1", "hidden_dim=32", "n_heads=2", "eval_every_n_steps=2",
            "train_batch_size=8", "eval_n_times=4", "eval_n_steps=3"]
    res = training.main([*cfg, "--run-dir", str(tmp_path), "max_train_steps=4", *tiny])
    assert math.isfinite(res["avrg_reward"]) and math.isfinite(res["avrg_result"])
    for f in ("config.yaml", "metrics.jsonl", "best.pt", "final.pt", "train_state.pt"):
        assert (tmp_path / f).exists(), f
    rows = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["_step"] for r in rows if "test_loss" in r] == [0, 2]
    assert all(math.isfinite(r["loss"]) for r in rows if "loss" in r)

    training.main([*cfg, "--run-dir", str(tmp_path / "resumed"), "--resume",
                   str(tmp_path), "max_train_steps=2", *tiny])
    state = torch.load(tmp_path / "resumed" / "train_state.pt", weights_only=True)
    assert state["step"] == 6 and state["ema_num_updates"] == 6


def test_entry_points_default_to_the_card(tmp_path):
    """BesoAgent, FrankaKitchenWorkspace, SlicedDataset and the training CLI
    run on the card unless the CPU is asked for: on a host without one they
    raise instead of falling back to the CPU."""
    import inspect

    from beso_tpu_torch.agents.beso_agent import BesoAgent
    from beso_tpu_torch.scripts import training
    from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

    for cls in (BesoAgent, FrankaKitchenWorkspace, SlicedDataset):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        SlicedDataset(synthetic_kitchen_data(n_traj=2, t_max=20), window=4, future_seq_len=2)
    with pytest.raises((RuntimeError, AssertionError)):
        training.main(["--config", "configs/franka_kitchen_chunked.yaml",
                       "--run-dir", str(tmp_path), "max_train_steps=1"])
