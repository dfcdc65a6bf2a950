"""`make_optimizer(mu_dtype=torch.bfloat16)` against `optax.adamw(1e-4,
mu_dtype=jnp.bfloat16)` (optax 0.2.6's `scale_by_adam` order, its update
run op by op) on the same fixed gradients; and the bf16-moment optimizer
under the fused train steps, StepLR and the EMA."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beso_tpu_torch.train.trainer import AdamLowPrecisionMoment, make_optimizer

SHAPES = [(17, 5), (33,), (4, 4, 3), (1,)]


def _run_both(name, steps=5, seed=0):
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
              for s in SHAPES] for _ in range(steps)]
    opt = (optax.adamw(1e-4, mu_dtype=jnp.bfloat16) if name == "adamw"
           else optax.adam(1e-4, mu_dtype=jnp.bfloat16))
    jp = [jnp.asarray(p) for p in p0]
    st = opt.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    topt, sched = make_optimizer(tp, name, 1e-4, weight_decay=1e-4, mu_dtype=torch.bfloat16)
    assert isinstance(topt, AdamLowPrecisionMoment)
    for g in grads:
        u, st = opt.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, u)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        topt.step()
        sched.step()
    return tp, topt, jp, st[0]


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_bf16_moment_matches_optax(name):
    tp, topt, jp, adam_state = _run_both(name)
    for p, j, mu, nu in zip(tp, jp, adam_state.mu, adam_state.nu):
        j = np.asarray(j)
        np.testing.assert_allclose(p.detach().numpy(), j, rtol=1e-6, atol=1e-6 * np.abs(j).max())
        m = topt.state[p]["exp_avg"]
        assert m.dtype == torch.bfloat16 and mu.dtype == jnp.bfloat16
        np.testing.assert_array_equal(m.float().numpy(), np.asarray(mu.astype(jnp.float32)))
        np.testing.assert_allclose(topt.state[p]["exp_avg_sq"].numpy(), np.asarray(nu),
                                   rtol=1e-6)


def test_update_uses_the_unrounded_moment():
    """One step from zero moments: the update is the f32 (1 - b1) g over its
    bias correction, not its bf16 rounding (what torch.optim.AdamW with a
    bf16 exp_avg would apply)."""
    g = torch.tensor([1.0 + 2 ** -12, -3.0 - 2 ** -10, 0.3])
    p = torch.nn.Parameter(torch.zeros(3))
    opt, _ = make_optimizer([p], "adam", 1e-2, mu_dtype=torch.bfloat16)
    p.grad = g.clone()
    opt.step()
    mu = g * (1 - 0.9)
    want = -1e-2 * (mu / (1 - 0.9)) / (torch.sqrt(g * g * (1 - 0.999) / (1 - 0.999)) + 1e-8)
    torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0.0)
    assert torch.equal(opt.state[p]["exp_avg"], mu.bfloat16())


def test_state_dict_round_trip_keeps_bf16_moment():
    """load_state_dict casts moments to the parameter's dtype; the next step
    stores the bf16 moment again and goes on as without the round trip."""
    rng = np.random.default_rng(1)
    grads = [torch.tensor(rng.standard_normal((6, 3)).astype(np.float32)) for _ in range(4)]

    def run(round_trip):
        p = torch.nn.Parameter(torch.ones(6, 3))
        opt, _ = make_optimizer([p], "adamw", 1e-3, mu_dtype=torch.bfloat16)
        for i, g in enumerate(grads):
            p.grad = g.clone()
            opt.step()
            if round_trip and i == 1:
                opt2, _ = make_optimizer([p], "adamw", 1e-3, mu_dtype=torch.bfloat16)
                opt2.load_state_dict(opt.state_dict())
                opt = opt2
        return p.detach(), opt.state[p]["exp_avg"]

    (p0, m0), (p1, m1) = run(False), run(True)
    assert torch.equal(p0, p1) and torch.equal(m0, m1) and m1.dtype == torch.bfloat16


def test_fused_train_steps_with_bf16_moment():
    """`profile_train`'s set-up with --mu-bf16 at a tiny size: the fused
    steps under StepLR and the EMA, bf16 first moments, finite losses."""
    from beso_tpu_torch.scripts import profile_train

    _, ts, fused = profile_train._setup(4, 3, torch.device("cpu"), mu_bf16=True)
    ts, losses = fused(ts, torch.Generator().manual_seed(0))
    assert ts.step == 3 and bool(torch.isfinite(losses).all())
    assert profile_train.first_moment_dtype(ts.optimizer) == "torch.bfloat16"
    assert ts.scheduler.last_epoch == 3
    ema = ts.ema.params
    assert any(not torch.equal(ema[n], p) for n, p in ts.model.named_parameters())
    rows = profile_train.main(["--device", "cpu", "--scaling", "--configs", "4:2",
                               "--mu-bf16"])
    assert rows[0]["mu_dtype"] == "torch.bfloat16" and rows[0]["loss_finite"]
    rows = profile_train.main(["--device", "cpu", "--scaling", "--configs", "4:2"])
    assert rows[0]["mu_dtype"] == "torch.float32"
