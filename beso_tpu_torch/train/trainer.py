"""Training loop: optimizers, EMA, eval-MSE, best-checkpoint logic (torch port
of `beso_tpu/train/trainer.py`).

Functional parity targets:
* BesoAgent.train_step (`beso_agent.py:215-248`): sigma ~ sample density,
  noise ~ N(0,1), EDM loss, optimizer step, per-step LR schedule, EMA update.
* BesoAgent.evaluate (`beso_agent.py:250-289`): generate with the EMA weights
  over a `num_sampling_steps`-step exponential sigma grid and report the MSE
  against the ground truth.
* the optimizers of the shipped configs: AdamW(lr 1e-4, betas (0.9, 0.999),
  weight decay 0.01) for kitchen, Adam(lr 1e-4) for block push, both under
  StepLR(step_size=100, gamma=0.99) stepped every train step, i.e.
  lr(t) = lr0 * 0.99^(t // 100). As in `beso_tpu` (`trainer.py:68-71`, plain
  `optax.adamw`), weight decay applies to every parameter: one parameter
  group, no decay mask.
* train_agent_on_steps (`beso_agent.py:177-213`): periodic full test-set
  sweep, best-test-MSE checkpointing.

The JAX package fuses 200 steps into one `lax.scan` program; here a step is
a Python call and the loop runs step after step (`make_fused_train_steps`
for a fixed count). Nothing in a step reads the device from the host: the
loss is read once per evaluation interval.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from beso_tpu_torch.agents.policy import scale_goal_for_model
from beso_tpu_torch.core.schedules import get_sigmas_exponential
from beso_tpu_torch.models.denoiser import GCDenoiser, precondition
from beso_tpu_torch.models.ema import EmaState, ema_init, ema_update
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.sampling.samplers import sample_loop

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """Everything a run carries from step to step. `model` is the
    denoiser's inner DiffusionGPT, whose parameters the optimizer updates."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema: EmaState
    step: int = 0


def step_lr_schedule(base_lr: float, step_size: int = 100, gamma: float = 0.99):
    """torch.optim.lr_scheduler.StepLR equivalent (stepped every train step)."""

    def schedule(count):
        return base_lr * gamma ** (count // step_size)

    return schedule


class AdamLowPrecisionMoment(torch.optim.Optimizer):
    """Adam(W) whose first moment is stored in `mu_dtype` (bf16), in the
    order of optax 0.2.6's `scale_by_adam(mu_dtype=...)` followed by
    `add_decayed_weights` and the rate, as `optax.adamw` chains them. Per
    step, with m the stored moment and g the gradient:

        mu = (1 - b1) g + b1 m          in f32; b1 m is a `mu_dtype` product
                                        (b1 rounded to `mu_dtype`, as
                                        optax's Python b1 times a bf16 m)
        nu = (1 - b2) g^2 + b2 nu       f32
        u = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p = p + u * -lr

    and m = mu rounded to `mu_dtype` after the update: this step's update
    uses the unrounded f32 mu. (torch.optim.AdamW with a bf16 `exp_avg`
    rounds the moment before its update.) The state keys are AdamW's:
    `step`, `exp_avg` (`mu_dtype`) and `exp_avg_sq` (f32)."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st.update(step=torch.zeros(()),
                              exp_avg=torch.zeros_like(p, dtype=self.mu_dtype),
                              exp_avg_sq=torch.zeros_like(p, dtype=torch.float32))
                elif st["exp_avg"].dtype != self.mu_dtype:
                    # load_state_dict casts the moments to the parameter's dtype
                    st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            ms = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            for st in states:
                st["step"] += 1
            t = int(states[0]["step"])
            b1, b2 = group["betas"]
            b1_m = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(ms, b1_m))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            den = torch._foreach_div(nus, 1 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu, 1 - b1 ** t)
            torch._foreach_div_(upd, den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            torch._foreach_copy_(ms, mu)
        return loss


def make_optimizer(params, name: str = "adamw", lr: float = 1e-4,
                   betas: tuple = (0.9, 0.999), weight_decay: float = 0.01,
                   lr_step_size: int = 100, lr_gamma: float = 0.99, mu_dtype=None):
    """(optimizer, scheduler) over `params` in one group. Calling
    `scheduler.step()` after each optimizer step gives the step-t update
    the rate lr * gamma^(t // lr_step_size), at the same counts as optax.
    `mu_dtype` (e.g. torch.bfloat16) stores the first moment in that dtype,
    as optax's `mu_dtype` does (`AdamLowPrecisionMoment`)."""
    params = list(params)
    if mu_dtype is not None:
        if name not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {name!r}")
        opt = AdamLowPrecisionMoment(params, lr=lr, betas=betas, eps=1e-8,
                                     weight_decay=weight_decay if name == "adamw" else 0.0,
                                     mu_dtype=mu_dtype)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    factor = step_lr_schedule(1.0, lr_step_size, lr_gamma)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def process_batch(batch: dict, scaler: Scaler):
    """Scale a raw batch (base_agent.py:111-142): standardize obs/goal/action;
    zero the non-block dims of 10-dim block-push goals."""
    state = scaler.scale_input(batch["observation"])
    goal = scale_goal_for_model(scaler, batch["goal_observation"])
    action = scaler.scale_output(batch["action"])
    return state, action, goal


def step_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Unit normal draws of a train step's action noise, its one draw besides
    the batch, the sigma density and the model's own."""
    return torch.randn(shape, generator=generator, device=device)


def make_train_step(denoiser: GCDenoiser, sample_density: Callable,
                    scaler: Scaler, ema_decay: float = 0.999,
                    update_ema_every_n_steps: int = 1,
                    pred_last_action_only: bool = False, mesh=None):
    """Build `train_step(ts, batch, generator, sigma=None, noise=None) -> loss`
    (beso_agent.py:215-248). Sigma, noise, dropout and the CFG goal mask
    draw from `generator`; `sigma` [B] and `noise` (the action shape) may be
    given instead of drawn. Returns the loss as a detached device scalar.

    Under a `mesh` (`parallel/mesh.py`; the model placed by
    `partition_params`) `batch` is the global batch and `generator` the
    same on every rank: each rank makes the step's draws over the global
    batch in the single process's order (sigma, noise, then the model's
    `train_draws`), computes the loss on its data rows, and the gradients
    are summed over the data axes and divided by their size, so they are
    the global batch's; the optimizer, schedule and EMA then step alike on
    every rank. The returned loss is the global batch's."""
    if mesh is not None:
        from beso_tpu_torch.parallel.mesh import (all_reduce_data_, all_reduce_grads,
                                                  data_index, data_rows)

    def train_step(ts: TrainState, batch: dict, generator: Optional[torch.Generator],
                   sigma: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        state_t, action_t, goal_t = process_batch(batch, scaler)
        dev = action_t.device
        if sigma is None:
            sigma = sample_density(generator, (action_t.shape[0],), device=dev)
        if noise is None:
            noise = step_noise(action_t.shape, generator, dev)
        given = {}   # the model's draws, made here under a mesh
        if mesh is not None:
            draws = ts.model.train_draws(generator, state_t, goal_t)
            rows = data_rows(mesh, action_t.shape[0])
            state_t, action_t, goal_t, noise, sigma = (
                a[rows] for a in (state_t, action_t, goal_t, noise, sigma))
            given["draws"] = [u[rows] for u in draws]
        loss = denoiser.loss(state_t, action_t, goal_t, noise, sigma,
                             pred_last_action_only=pred_last_action_only,
                             train=True, generator=generator, **given)
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(ts.model, mesh)
            loss = all_reduce_data_(loss.detach().clone(), mesh) / data_index(mesh)[1]
        ts.optimizer.step()
        ts.scheduler.step()
        ts.step += 1
        if ts.step % update_ema_every_n_steps == 0:
            ema_update(ts.ema, ts.model.named_parameters(), ema_decay)
        return loss.detach()

    return train_step


def make_fused_train_steps(denoiser: GCDenoiser, sample_density: Callable, scaler: Scaler,
                           train_sampler, batch_size: int, n_steps: int, **kwargs):
    """`fused(ts, generator) -> (ts, losses [n_steps])`: `n_steps` train
    steps, each sampling its batch on the device and then running
    `make_train_step` (`beso_tpu/train/trainer.py:130-160`), all drawing
    from `generator` in the order `Trainer.train` draws. The JAX package
    fuses them into one `lax.scan` program; here they are a Python loop
    that reads nothing back to the host, so the device runs ahead of it.
    `scripts/profile_train.py` runs it; the seed sweep (`train/sweep.py`)
    steps its stacked seeds in the same draw order, so a sweep seed trains
    as this function does on the seed's generator."""
    step_fn = make_train_step(denoiser, sample_density, scaler, **kwargs)

    def fused(ts: TrainState, generator: Optional[torch.Generator]):
        losses = [step_fn(ts, train_sampler.sample_batch(generator, batch_size), generator)
                  for _ in range(n_steps)]
        return ts, torch.stack(losses)

    return fused


@torch.no_grad()
def evaluate_mse(denoiser: GCDenoiser, params, batch: dict, scaler: Scaler,
                 generator: Optional[torch.Generator], num_sampling_steps: int = 3,
                 sigma_min: float = 0.005, sigma_max: float = 1.0,
                 sampler_type: str = "ddim",
                 pred_last_action_only: bool = False,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Test-set generation MSE (beso_agent.py:250-289) as a device scalar;
    pass the EMA params (None: the model's own). The start is `noise` (unit
    normal, the action shape) times sigma_max, drawn from `generator` if
    not given."""
    state_t, action_t, goal_t = process_batch(batch, scaler)
    sigmas = get_sigmas_exponential(num_sampling_steps, sigma_min, sigma_max)
    if noise is None:
        noise = torch.randn(action_t.shape, generator=generator, device=action_t.device)
    x = noise * sigma_max
    inner = denoiser.inner(params)

    def denoise(actions, sigma):
        return precondition(inner, state_t, actions, goal_t, sigma,
                            denoiser.sigma_data)

    x_0 = sample_loop(sampler_type, denoise, x, sigmas, generator)
    if pred_last_action_only:
        return torch.mean((x_0[:, -1:] - action_t[:, -1:]) ** 2)
    return torch.mean((x_0 - action_t) ** 2)


@dataclasses.dataclass
class Trainer:
    """Step-based training orchestration (beso_agent.py:177-213).

    `optimizer_factory(params) -> (optimizer, scheduler)`, for instance a
    `functools.partial` of `make_optimizer`."""

    denoiser: GCDenoiser
    optimizer_factory: Callable
    sample_density: Callable
    scaler: Scaler
    max_train_steps: int = 1000
    eval_every_n_steps: int = 500
    ema_decay: float = 0.999
    update_ema_every_n_steps: int = 1
    num_sampling_steps: int = 3
    sigma_min: float = 0.005
    sigma_max: float = 1.0
    sampler_type: str = "ddim"
    use_ema: bool = True
    pred_last_action_only: bool = False
    checkpoint_dir: Optional[str] = None
    log_every: int = 1000
    metrics_writer: Any = None

    def init_state(self) -> TrainState:
        model = self.denoiser.inner_model
        optimizer, scheduler = self.optimizer_factory(model.parameters())
        return TrainState(model, optimizer, scheduler,
                          ema_init(model.named_parameters()), 0)

    def eval_params(self, ts: TrainState):
        return ts.ema.params if self.use_ema else None

    def _train_step(self):
        return make_train_step(self.denoiser, self.sample_density, self.scaler,
                               self.ema_decay, self.update_ema_every_n_steps,
                               self.pred_last_action_only)

    def _test_mse(self, ts: TrainState, test_batches_fn, generator) -> float:
        mses = [evaluate_mse(self.denoiser, self.eval_params(ts), b, self.scaler,
                             generator, self.num_sampling_steps, self.sigma_min,
                             self.sigma_max, self.sampler_type,
                             self.pred_last_action_only)
                for b in test_batches_fn()]
        return float(torch.stack(mses).mean()) if mses else float("nan")

    def _log_losses(self, losses, step: int, **extra) -> float:
        losses = torch.stack(losses)
        last = float(losses[-1])
        if self.metrics_writer is not None:
            self.metrics_writer.log({"loss": last, "mean_loss": float(losses.mean()),
                                     **extra}, step=step)
        return last

    def train(self, ts: TrainState, train_sampler, test_batches_fn,
              generator: torch.Generator, batch_size: int = 1024) -> TrainState:
        """train_sampler: SlicedDataset-like with .sample_batch(generator, n);
        test_batches_fn: () -> iterable of test batches."""
        step_fn = self._train_step()
        eval_gen = _child_generator(generator)
        best_test_mse = float("inf")
        t0 = time.time()
        step = 0
        while step < self.max_train_steps:
            if step % self.eval_every_n_steps == 0:
                test_mse = self._test_mse(ts, test_batches_fn, eval_gen)
                log.info("step %d: mean test mse %.6f", step, test_mse)
                if self.metrics_writer is not None:
                    self.metrics_writer.log({"test_loss": test_mse}, step=step)
                if test_mse < best_test_mse:
                    best_test_mse = test_mse
                    if self.checkpoint_dir is not None:
                        self.save(ts, self.checkpoint_dir)
                        log.info("new best test loss; checkpoint stored")
            n = min(self.max_train_steps - step,
                    self.eval_every_n_steps - step % self.eval_every_n_steps)
            losses = [step_fn(ts, train_sampler.sample_batch(generator, batch_size),
                              generator) for _ in range(n)]
            step += n
            loss = self._log_losses(losses, step)
            if step % self.log_every < n:
                log.info("step %d: batch loss %.6f (%.1f s)", step, loss,
                         time.time() - t0)
        if self.checkpoint_dir is not None:
            self.save(ts, self.checkpoint_dir, name="final")
        return ts

    def train_on_epochs(self, ts: TrainState, train_sampler, test_batches_fn,
                        generator: torch.Generator, epochs: int,
                        batch_size: int = 1024, steps_per_epoch: Optional[int] = None,
                        patience: int = 80) -> TrainState:
        """Epoch-mode training with early stopping on test MSE
        (beso_agent.py:130-175 + base_agent.py:144-157: stop after `patience`
        epochs without improvement, checkpointing the best)."""
        step_fn = self._train_step()
        eval_gen = _child_generator(generator)
        spe = steps_per_epoch or max(1, len(train_sampler) // batch_size)
        best_test_mse = float("inf")
        epochs_no_improvement = 0
        for epoch in range(epochs):
            test_mse = self._test_mse(ts, test_batches_fn, eval_gen)
            if test_mse < best_test_mse:
                best_test_mse = test_mse
                epochs_no_improvement = 0
                if self.checkpoint_dir is not None:
                    self.save(ts, self.checkpoint_dir)
            else:
                epochs_no_improvement += 1
            if epochs_no_improvement > patience:
                log.info("Early stopping!")
                break
            losses = [step_fn(ts, train_sampler.sample_batch(generator, batch_size),
                              generator) for _ in range(spe)]
            loss = self._log_losses(losses, ts.step, epoch_test_loss=test_mse,
                                    epoch=epoch)
            log.info("Epoch %d: mean test mse %.6f, train loss %.6f",
                     epoch, test_mse, loss)
        return ts

    def save(self, ts: TrainState, directory: str, name: str = "best"):
        from beso_tpu_torch.train.checkpoint import save_train_state

        save_train_state(ts, directory, name)

    def restore(self, ts_template: TrainState, directory: str,
                name: str = "best") -> TrainState:
        """A saved state loaded into `ts_template` in place
        (`beso_tpu/train/trainer.py:346-350`)."""
        from beso_tpu_torch.train.checkpoint import restore_train_state

        return restore_train_state(ts_template, directory, name)


def _child_generator(generator: torch.Generator) -> torch.Generator:
    """A second generator on the same device, seeded from `generator`
    (the evaluation noise stream)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(generator.device).manual_seed(seed)
