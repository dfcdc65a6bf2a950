"""The training-tools slice of `beso_tpu_torch` against `beso_tpu` (CPU, f32):
`make_fused_train_steps`, the seed sweep (`train/sweep.py`: the stacked
train steps at window 4 and at 131 tokens through the flash kernels' plain
versions, `sweep_eval_mse`, `run_sweep`, `seed_state`), the flash
operators under a seed axis, `perturb_kitchen_params` and the sweep CLI
end to end. JAX's draws (batches, sigma, noise) are injected into the port
per seed, so both sides train on the same numbers."""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _key_bias_apart
from torch_parity import make_models, t

from beso_tpu.core.densities import make_sample_density as j_make_density
from beso_tpu.data.slicer import SlicedDataset as JSlicedDataset
from beso_tpu.models import ema as jema
from beso_tpu.models.scaler import fit_scaler as j_fit_scaler
from beso_tpu.train import sweep as jsweep
from beso_tpu.train import trainer as jtr
from beso_tpu_torch.core.densities import make_sample_density
from beso_tpu_torch.data.slicer import SlicedDataset
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models.convert import params_from_jax, params_to_numpy_tree
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.ema import ema_init
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.ops import flash_attention as fa
from beso_tpu_torch.train import sweep as tsweep
from beso_tpu_torch.train import trainer as ttr

LR = 1e-4
CASES = {
    "broadcast_w4": dict(attention="broadcast"),
    # 131 tokens through the flash kernels' plain versions vs Pallas (interpret)
    "pallas_131": dict(obs_seq_len=64, attention="pallas", n_layers=1),
}


class Injected:
    """JAX's per-step draws served to the port in call order, by generator:
    the sampler's batches, the density's sigmas and the step's noise."""

    def __init__(self, draws_by_generator):
        self.batches, self.sigmas, self.noises = {}, {}, {}
        for gen, draws in draws_by_generator:
            self.batches[id(gen)] = [{k: t(v) for k, v in b.items()} for b, _, _ in draws]
            self.sigmas[id(gen)] = [t(s) for _, s, _ in draws]
            self.noises[id(gen)] = [t(n) for _, _, n in draws]

    def sample_batch(self, generator, batch_size):
        b = self.batches[id(generator)].pop(0)
        assert b["action"].shape[0] == batch_size
        return b

    def density(self, generator, shape, device=None):
        return self.sigmas[id(generator)].pop(0)

    def noise(self, shape, generator, device):
        n = self.noises[id(generator)].pop(0)
        assert tuple(n.shape) == tuple(shape)
        return n

    def exhausted(self) -> bool:
        return not any(q for d in (self.batches, self.sigmas, self.noises) for q in d.values())


def _setup(case, B):
    """Both packages' data, scaler, slicer and density (the JAX side's)."""
    kw = {**dict(state_dim=30, action_dim=9, embed_dim=48, n_layers=2, n_heads=2,
                 goal_seq_len=2, obs_seq_len=4), **CASES[case]}
    T = kw["obs_seq_len"]
    data = synthetic_kitchen_data(n_traj=6, t_max=T + 40, seed=3)
    jds = JSlicedDataset(data, window=T, future_seq_len=2, future_conditional=True)
    jscaler = j_fit_scaler(data.all_observations(), data.all_actions(), scale_data=True)
    tscaler = fit_scaler(data.all_observations(), data.all_actions(), scale_data=True)
    jdensity = j_make_density("loglogistic", 0.5, 0.005, 1.0)
    return kw, data, jds, jscaler, tscaler, jdensity


def _jax_draws(jds, jdensity, key, n_steps, B):
    """The draws of JAX's fused steps for one key: per step k -> (k_batch,
    k_step); the batch from k_batch, sigma and noise from k_step's split
    (`beso_tpu/train/trainer.py:100-112,150-155`)."""
    out = []
    for k in jax.random.split(key, n_steps):
        k_batch, k_step = jax.random.split(k)
        batch = {kk: np.asarray(v) for kk, v in jds.sample_batch(k_batch, B).items()}
        k_sig, k_noise, _ = jax.random.split(k_step, 3)
        sigma = np.asarray(jdensity(k_sig, (B,)))
        noise = np.asarray(jax.random.normal(k_noise, batch["action"].shape))
        out.append((batch, sigma, noise))
    return out


def assert_params_close(got, want, what):
    """Parameters (or the EMA shadow) after Adam steps, flax-named trees:
    the key third of every qkv bias (zero gradient in exact arithmetic,
    rounding noise on both sides that Adam turns into steps of up to lr)
    within 3 lr; elsewhere every element within 3 lr and all but 0.1% of a
    leaf within 1e-6 (ROADMAP C2, "Adam and zero gradients")."""
    got, want = _key_bias_apart(got), _key_bias_apart(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 3 * LR, (what, name, diff.max())
        if not name.endswith("#key"):
            assert (diff > 1e-6).mean() <= 1e-3, (what, name, (diff > 1e-6).sum())


def _port_state(kw, params):
    model = DiffusionGPT(**kw)
    params_from_jax(params, model)
    opt, sched = ttr.make_optimizer(model.parameters(), name="adamw", lr=LR)
    return ttr.TrainState(model, opt, sched, ema_init(model.named_parameters()), 0)


def test_fused_train_steps_match_jax(monkeypatch):
    """`make_fused_train_steps`, 3 steps on the window-4 model with JAX's
    draws: losses to 1e-5 relative, parameters and EMA as
    `assert_params_close`."""
    B, n = 4, 3
    kw, data, jds, jscaler, tscaler, jdensity = _setup("broadcast_w4", B)
    _, jden, params, _ = make_models(seed=41, **CASES["broadcast_w4"])
    jopt = jtr.make_optimizer("adamw", LR)
    ts = jtr.TrainState(params, jopt.init(params), jema.ema_init(params),
                        jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(7)
    fused = jtr.make_fused_train_steps(jden, jopt, jdensity, jscaler, jds, B, n)
    ts_out, jlosses = fused(ts, key)

    gen = torch.Generator().manual_seed(0)
    inj = Injected([(gen, _jax_draws(jds, jdensity, key, n, B))])
    monkeypatch.setattr(ttr, "step_noise", inj.noise)
    tts = _port_state(kw, params)
    tfused = ttr.make_fused_train_steps(GCDenoiser(tts.model, 0.5), inj.density, tscaler,
                                        inj, B, n)
    tts, losses = tfused(tts, gen)
    assert inj.exhausted() and losses.shape == (n,) and tts.step == n
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    assert_params_close(params_to_numpy_tree(tts.model), ts_out.params, "params")
    assert_params_close(params_to_numpy_tree(tts.model, tts.ema.params), ts_out.ema.params,
                        "ema")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_train_steps_match_jax(case, monkeypatch):
    """`make_sweep_train_steps`, 2 seeds x 3 steps with JAX's per-seed draws
    (window 4; and 131 tokens through the flash plain versions against
    JAX's Pallas kernels in interpret mode, one layer): per-seed losses to
    1e-5 relative, each seed's parameters and EMA as `assert_params_close`."""
    B, n, S = 2, 3, 2
    kw, data, jds, jscaler, tscaler, jdensity = _setup(case, B)
    trees = [make_models(seed=50 + i, **CASES[case]) for i in range(S)]
    jden = trees[0][1]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[tr[2] for tr in trees])
    jopt = jtr.make_optimizer("adamw", LR)
    ts = jtr.TrainState(stacked, jax.vmap(jopt.init)(stacked),
                        jax.vmap(jema.ema_init)(stacked), jnp.zeros((S,), jnp.int32))
    keys = jax.random.split(jax.random.PRNGKey(9), S)
    fused = jsweep.make_sweep_train_steps(jden, jopt, jdensity, jscaler, jds, B, n)
    ts_out, jlosses = fused(ts, keys)

    gens = [torch.Generator().manual_seed(100 + i) for i in range(S)]
    inj = Injected([(g, _jax_draws(jds, jdensity, k, n, B)) for g, k in zip(gens, keys)])
    monkeypatch.setattr(tsweep, "step_noise", inj.noise)

    def model_factory(generator):
        model = DiffusionGPT(**kw)
        params_from_jax(trees[generator.initial_seed() - 50][2], model)
        return model

    ss = tsweep.init_sweep_state(model_factory, partial(ttr.make_optimizer, name="adamw",
                                                        lr=LR), [50, 51])
    tfused = tsweep.make_sweep_train_steps(inj.density, tscaler, inj, B, n)
    ss, losses = tfused(ss, gens)
    assert inj.exhausted() and losses.shape == (S, n) and ss.step == n
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    for i in range(S):
        mine = tsweep.seed_state(ss, i)
        want = jsweep.seed_state(ts_out, i)
        assert_params_close(params_to_numpy_tree(mine.model), want.params, f"seed {i}")
        assert_params_close(params_to_numpy_tree(mine.model, mine.ema.params),
                            want.ema.params, f"seed {i} ema")


def _kitchen_like(generator):
    """A small model with every training draw: the CFG goal mask and the
    embedding, attention and residual dropouts."""
    return DiffusionGPT(30, 9, 32, 2, 2, 2, 4, embed_pdrob=0.1, attn_pdrop=0.3,
                        resid_pdrop=0.05, cond_mask_prob=0.1, generator=generator)


def _port_sweep_setup():
    data = synthetic_kitchen_data(n_traj=8, t_max=40, seed=5)
    scaler = fit_scaler(data.all_observations(), data.all_actions())
    ds = SlicedDataset(data, window=4, future_seq_len=2, device="cpu")
    density = make_sample_density("loglogistic", 0.5, 0.005, 1.0)
    return ds, scaler, density, partial(ttr.make_optimizer, name="adamw", lr=LR)


def test_given_draws_equal_the_generators():
    """`forward(train=True, draws=train_draws(g))` computes exactly what
    `forward(train=True, generator=g)` does (a forward under vmap takes its
    draws so); `uncond` drops the goal mask's draw; a wrong list raises."""
    m = _kitchen_like(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    s, a, gl = torch.randn(5, 4, 30, generator=g), torch.randn(5, 4, 9, generator=g), \
        torch.randn(5, 2, 30, generator=g)
    sig = torch.rand(5, generator=g) + 0.1
    want = m(s, a, gl, sig, train=True, generator=torch.Generator().manual_seed(3))
    draws = m.train_draws(torch.Generator().manual_seed(3), s, gl)
    assert len(draws) == 1 + 1 + 2 + 2 * 3   # goal mask, 3 embeddings, 2 x (attn, 2 resid)
    assert torch.equal(m(s, a, gl, sig, train=True, draws=draws), want)
    uncond = m.train_draws(torch.Generator().manual_seed(3), s, gl, uncond=True)
    assert len(uncond) == len(draws) - 1
    assert torch.equal(m(s, a, gl, sig, uncond=True, train=True, draws=uncond),
                       m(s, a, gl, sig, uncond=True, train=True,
                         generator=torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="draws"):
        m(s, a, gl, sig, train=True, draws=draws[:-1])
    with pytest.raises(ValueError, match="more draws"):
        m(s, a, gl, sig, train=True, draws=draws + [draws[-1]])


def test_sweep_equals_separate_runs_and_seeds_differ():
    """Each seed of the sweep (every draw of the kitchen-like model: goal
    mask and three dropouts) trains as a run of its own with the same
    generator would (`make_fused_train_steps` after `Trainer.train`'s child
    draw): the same losses to 1e-6 relative, parameters and EMA as
    `assert_params_close`; the seeds' weights, streams and losses differ."""
    ds, scaler, density, opt = _port_sweep_setup()
    seeds = [3, 5]
    ss = tsweep.init_sweep_state(_kitchen_like, opt, seeds)
    p = next(iter(ss.params.values()))
    assert p.shape[0] == 2 and (p[0] - p[1]).abs().max() > 1e-3
    train_gens, _ = tsweep.seed_generators(seeds, "cpu")
    ss, losses = tsweep.make_sweep_train_steps(density, scaler, ds, 8, 3)(ss, train_gens)
    assert (losses[0] - losses[1]).abs().min() > 1e-4
    for i, s in enumerate(seeds):
        model = _kitchen_like(torch.Generator().manual_seed(s))
        o, sc = opt(model.parameters())
        ts = ttr.TrainState(model, o, sc, ema_init(model.named_parameters()), 0)
        gen = torch.Generator().manual_seed(s + 1)
        ttr._child_generator(gen)   # the evaluation stream's draw
        ts, want = ttr.make_fused_train_steps(GCDenoiser(model), density, scaler, ds, 8,
                                              3)(ts, gen)
        np.testing.assert_allclose(losses[i].numpy(), want.numpy(), rtol=1e-6)
        mine = tsweep.seed_state(ss, i)
        assert mine.step == ts.step == 3 and mine.ema.num_updates == 3
        assert_params_close(params_to_numpy_tree(mine.model), params_to_numpy_tree(model),
                            f"seed {s}")
        assert_params_close(params_to_numpy_tree(mine.model, mine.ema.params),
                            params_to_numpy_tree(model, ts.ema.params), f"seed {s} ema")
        for n_, q in model.named_parameters():
            st_m, st_w = mine.optimizer.state[dict(mine.model.named_parameters())[n_]], \
                ts.optimizer.state[q]
            assert float(st_m["step"]) == float(st_w["step"]) == 3
        assert mine.scheduler.state_dict()["last_epoch"] == ts.scheduler.state_dict()[
            "last_epoch"]


def test_sweep_eval_mse_matches_jax_and_per_seed():
    """`sweep_eval_mse` on one shared batch with JAX's per-seed start noise
    (split(key, S)): each seed's MSE against JAX's `sweep_eval_mse` to 1e-5
    relative and against the port's `evaluate_mse` of that seed alone; a
    sampler that draws after the start raises under the map."""
    S, B = 2, 5
    kw, data, jds, jscaler, tscaler, _ = _setup("broadcast_w4", B)
    trees = [make_models(seed=60 + i) for i in range(S)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[tr[2] for tr in trees])
    ts = jtr.TrainState(stacked, None, jema.ema_init(stacked), jnp.zeros((S,), jnp.int32))
    batch = {k: np.asarray(v) for k, v in jds.sample_batch(jax.random.PRNGKey(2), B).items()}
    key = jax.random.PRNGKey(4)
    want = jsweep.sweep_eval_mse(trees[0][1], ts, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jscaler, key)
    noise = np.stack([np.asarray(jax.random.normal(k, batch["action"].shape))
                      for k in jax.random.split(key, S)])

    def model_factory(generator):
        model = DiffusionGPT(**kw)
        params_from_jax(trees[generator.initial_seed() - 60][2], model)
        return model

    ss = tsweep.init_sweep_state(model_factory, partial(ttr.make_optimizer, lr=LR), [60, 61])
    tbatch = {k: t(v) for k, v in batch.items()}
    got = tsweep.sweep_eval_mse(ss, tbatch, tscaler, [None] * S, noise=t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for i in range(S):
        alone = ttr.evaluate_mse(trees[i][3], None, tbatch, tscaler, None, noise=t(noise[i]))
        np.testing.assert_allclose(got[i].item(), alone.item(), rtol=1e-6)
    gens = [torch.Generator().manual_seed(i) for i in range(S)]
    with pytest.raises(RuntimeError, match="random"):
        tsweep.sweep_eval_mse(ss, tbatch, tscaler, gens, sampler_type="euler_ancestral")


def test_run_sweep_history():
    """`run_sweep`: an entry per evaluation (every 2 of 5 steps, and the
    last), per-seed last losses and test MSEs, finite; the state at the
    last step; the MSE of each seed equal to `sweep_eval_mse` of the
    returned state on the seed's evaluation stream."""
    ds, scaler, density, opt = _port_sweep_setup()
    seeds = [1, 2, 3]
    test_batch = ds.sample_batch(torch.Generator().manual_seed(9), 6)
    seen = []
    ss, history = tsweep.run_sweep(_kitchen_like, opt, density, scaler, ds, test_batch, seeds,
                                   batch_size=4, max_train_steps=5, eval_every_n_steps=2,
                                   fused_steps=50, metrics_cb=lambda s, e: seen.append(s))
    assert [h[0] for h in history] == seen == [2, 4, 5] and ss.step == 5
    for _, loss, mse in history:
        assert loss.shape == mse.shape == (3,) and np.isfinite(loss).all() \
            and np.isfinite(mse).all()
    _, eval_gens = tsweep.seed_generators(seeds, "cpu")
    for _ in range(2):   # the two evaluations before the last
        tsweep.sweep_eval_mse(ss, test_batch, scaler, eval_gens)
    again = tsweep.sweep_eval_mse(ss, test_batch, scaler, eval_gens)
    np.testing.assert_allclose(again.numpy(), history[-1][2], rtol=1e-6)


@pytest.mark.parametrize("vmap_dims", [(0, 0, 0), (1, 0, None)], ids=["dim0", "dim1-shared"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_versions_under_vmap(vmap_dims, causal):
    """The three flash operators under `torch.func.vmap`: bit for bit the
    folded call (mapped axes anywhere, unmapped tensors broadcast), one
    call per operator for all slices; autograd through the map, outside it
    (`.backward()`) and inside it (`vmap(grad)`), against each slice's own
    autograd within 1e-6 of max |ref|."""
    S, B, H, T, hd = 3, 2, 2, 19, 8
    g = torch.Generator().manual_seed(int(causal))
    base = [torch.randn(S, B, H, T, hd, generator=g) for _ in range(4)]
    args = [x.movedim(0, d) if d is not None else x[0] for x, d in zip(base[:3], vmap_dims)]
    full = [x if d is not None else x[0].expand(S, *x.shape[1:]) for x, d in
            zip(base[:3], vmap_dims)]
    fold = [x.reshape(S * B, H, T, hd) for x in full]
    calls = {}
    real = {n: getattr(fa, n) for n in ("flash_forward_reference", "flash_backward_dq_reference",
                                        "flash_backward_dkv_reference")}

    def counting(name):
        def fn(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            assert a[0].shape == (S * B, H, T, hd)
            return real[name](*a, **kw)
        return fn

    mp = pytest.MonkeyPatch()
    for name in real:
        mp.setattr(fa, name, counting(name))
    try:
        o, lse = torch.func.vmap(torch.ops.beso.flash_forward, in_dims=(*vmap_dims, None))(
            *args, causal)
        o_f, lse_f = real["flash_forward_reference"](*fold, causal)
        assert torch.equal(o.reshape(S * B, H, T, hd), o_f)
        assert torch.equal(lse.reshape(S * B, H, T, 1), lse_f)
        do = base[3]
        dq, delta = torch.func.vmap(lambda *a: torch.ops.beso.flash_backward_dq(*a, causal))(
            *full, o, do, lse)
        dq_f, delta_f = real["flash_backward_dq_reference"](*fold, o_f, do.reshape(fold[0].shape),
                                                             lse_f, causal)
        assert torch.equal(dq.reshape(dq_f.shape), dq_f)
        assert torch.equal(delta.reshape(delta_f.shape), delta_f)
        dk, dv = torch.func.vmap(lambda *a: torch.ops.beso.flash_backward_dkv(*a, causal))(
            *full, do, lse, delta)
        dk_f, dv_f = real["flash_backward_dkv_reference"](
            *fold, do.reshape(fold[0].shape), lse_f, delta_f, causal)
        assert torch.equal(dk.reshape(dk_f.shape), dk_f)
        assert torch.equal(dv.reshape(dv_f.shape), dv_f)
        assert calls == dict.fromkeys(real, 1)

        leaves = [x.clone().requires_grad_() for x in full]
        (torch.func.vmap(partial(fa.flash_attention, causal=causal))(*leaves) * do).sum() \
            .backward()

        def f(q, k, v, d):
            return (fa.flash_attention(q, k, v, causal) * d).sum()

        inner = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(*full, do)
        assert calls == dict.fromkeys(real, 3)
    finally:
        mp.undo()
    for i in range(S):
        own = [x[i].clone().requires_grad_() for x in full]
        (fa.flash_attention(*own, causal) * do[i]).sum().backward()
        for outer_g, inner_g, x in zip(leaves, inner, own):
            ref = x.grad
            tol = 1e-6 * ref.abs().max()
            assert (outer_g.grad[i] - ref).abs().max() <= tol
            assert (inner_g[i] - ref).abs().max() <= tol


def test_perturb_kitchen_params_matches_jax():
    """Every field of the perturbed calibration equals JAX's, bit for bit."""
    from beso_tpu.envs.kitchen import env as jenv
    from beso_tpu_torch.envs.kitchen import env as tenv

    for kw in (dict(), dict(gain_scale=0.8), dict(radius_scale=1.2),
               dict(gain_scale=1.2, radius_scale=0.8, kettle_scale=1.5),
               dict(kettle_scale=0.5)):
        got = tenv.perturb_kitchen_params(**kw)
        want = jenv.perturb_kitchen_params(**kw)
        for field in tenv.KitchenParams.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), err_msg=field)
    base = tenv.default_kitchen_params()
    assert tenv.perturb_kitchen_params(base, gain_scale=0.8).drive_eff.data_ptr() \
        != base.drive_eff.data_ptr()


def test_sweep_cli_run_dirs_load_into_evaluate(tmp_path):
    """`scripts/sweep.py` on configs/block_push.yaml at a tiny size, two
    grid cells x two seeds: a run dir per cell and seed (config with the
    seed, train_state.pt holding seed_state's weights), summaries per cell
    and at the root with the final evaluation, and each run dir loads into
    the port's evaluation CLI."""
    from beso_tpu_torch.scripts import evaluate, sweep

    tiny = ["num_hidden_layers=1", "hidden_dim=48", "n_heads=4", "max_train_steps=3",
            "eval_every_n_steps=2", "train_batch_size=8", "test_batch_size=8",
            "eval_n_times=2", "eval_n_steps=2"]
    summary = sweep.main(["--config", "configs/block_push.yaml", "--seeds", "1,2",
                          "--grid", "lr=1e-4,3e-4", "--run-dir", str(tmp_path),
                          "--final-eval", "--device", "cpu", *tiny])
    assert sorted(summary) == ["lr-1e-4", "lr-3e-4"]
    assert json.loads((tmp_path / "summary.json").read_text()).keys() == summary.keys()
    for cell, cs in summary.items():
        assert [h[0] for h in cs["history"]] == [2, 3]
        assert json.loads((tmp_path / cell / "summary.json").read_text())["history"] == \
            [list(h) for h in cs["history"]]
        for seed in (1, 2):
            entry = cs["seeds"][seed]
            assert np.isfinite([entry["final_loss"], entry["final_test_mse"]]).all()
            assert np.isfinite(entry["eval"]["avrg_reward"])
            run = tmp_path / cell / f"seed_{seed}"
            assert (run / "config.yaml").exists() and (run / "train_state.pt").exists()
            out = evaluate.main(["--config", "configs/evaluate_blocks.yaml", "--device", "cpu",
                                 f"model_store_path={run}", "num_runs=2",
                                 "num_steps_per_run=2"])
            assert np.isfinite(out["avrg_reward"])
    state = torch.load(tmp_path / "lr-1e-4" / "seed_2" / "train_state.pt", weights_only=True)
    assert state["step"] == 3 and state["ema_num_updates"] == 3
    one = torch.load(tmp_path / "lr-1e-4" / "seed_1" / "train_state.pt", weights_only=True)
    assert any(not torch.equal(one["params"][k], state["params"][k]) for k in state["params"])
