"""Multi-seed sweep training: S seeds as one program (torch port of
`beso_tpu/train/sweep.py`).

The reference's Hydra `--multirun seed=1,...,N` launches N processes, one
model each. Here the S models train together: their parameters are stacked
on a leading seed axis (`torch.func.stack_module_state`), the loss runs
under `torch.func.vmap(functional_call)`, one `backward()` of the sum of the
per-seed losses gives every seed its own gradient, and one AdamW, one
StepLR and one EMA update the stacked tensors. That is exact per seed: the
seeds share no parameter, AdamW, its weight decay and the EMA are
elementwise, and `make_optimizer` clips no global norm (a stacked norm would
mix seeds). The schedule is shared, as all seeds take the same steps.
Under the map every matrix product runs once for all seeds, and the flash
kernels fold the seed axis into their batch axis (`ops/flash_attention.py`):
one launch per layer and kernel for all S seeds.

Each seed draws only from its own generators, as a run of its own would:
`torch.func.vmap` refuses random operations, so every draw of a step (the
batch, sigma, the noise, the CFG goal mask and dropout) is made outside the
map from the seed's generator, in the order `Trainer.train` draws them, and
passed in as a batched tensor. Seed s's weights come from
`torch.Generator().manual_seed(s)`, its train stream from a generator
seeded s + 1 and its evaluation stream from a child of that one, as the
training CLI seeds a run.

Non-seed grids (lr, sampler, ...) change the program; `scripts/sweep.py`
loops over those cells and maps the seeds inside each. `shard_sweep_state`
puts the seed axis over a mesh's "dp" ranks: each rank then trains its
seeds on their own generators, with no communication.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.ema import EmaState, ema_init, ema_update
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.train.trainer import (TrainState, _child_generator, evaluate_mse,
                                          process_batch, step_noise)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SweepState:
    """S seeds' train states on a leading seed axis. `denoiser`'s inner
    model is a template on the meta device: the forward runs it with
    `params` in place of its own (it has none)."""

    denoiser: GCDenoiser
    params: Dict[str, torch.Tensor]   # name -> [S, ...] leaf tensors
    optimizer_factory: Callable       # params -> (optimizer, scheduler)
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema: EmaState                     # the stacked shadow
    seeds: Tuple[int, ...]
    step: int = 0


def init_sweep_state(model_factory: Callable[[torch.Generator], nn.Module],
                     optimizer_factory: Callable, seeds: Sequence[int],
                     sigma_data: float = 0.5) -> SweepState:
    """Stacked state: seed i's model from `model_factory(torch.Generator()
    .manual_seed(seeds[i]))` (the weights `BesoAgent.init` would draw), one
    optimizer and scheduler from `optimizer_factory(params)` over the
    stacked tensors, the EMA shadow started from them."""
    seeds = tuple(int(s) for s in seeds)
    models = [model_factory(torch.Generator().manual_seed(s)) for s in seeds]
    params, buffers = torch.func.stack_module_state(models)
    if buffers:
        raise ValueError(f"the sweep stacks parameters only, the model has buffers "
                         f"{sorted(buffers)}")
    template = copy.deepcopy(models[0]).to("meta")
    optimizer, scheduler = optimizer_factory(params.values())
    return SweepState(GCDenoiser(template, sigma_data), params, optimizer_factory, optimizer,
                      scheduler, ema_init(params.items()), seeds)


def seed_generators(seeds: Sequence[int], device) -> Tuple[List[torch.Generator],
                                                           List[torch.Generator]]:
    """Each seed's (train, evaluation) generators on `device`: the train
    stream seeded s + 1 and the evaluation stream its child, as the
    training CLI and `Trainer.train` seed a run's."""
    train = [torch.Generator(device).manual_seed(int(s) + 1) for s in seeds]
    return train, [_child_generator(g) for g in train]


def _stack(per_seed: List) -> Any:
    """[seed][...] nested lists/tuples of tensors -> one stacked structure."""
    first = per_seed[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(per_seed)
    return type(first)(_stack(list(xs)) for xs in zip(*per_seed))


def make_sweep_train_steps(sample_density: Callable, scaler: Scaler, train_sampler,
                           batch_size: int, n_steps: int, ema_decay: float = 0.999,
                           update_ema_every_n_steps: int = 1,
                           pred_last_action_only: bool = False) -> Callable:
    """`fused(ss, generators) -> (ss, losses [S, n_steps])`: `n_steps` train
    steps of every seed, seed i drawing from `generators[i]`
    (`beso_tpu/train/sweep.py:53-76`). Per step the seeds' draws are made
    outside the map, the loss and its gradient run once for all seeds, then
    AdamW, StepLR and the EMA once over the stacked tensors."""

    def draws(ss: SweepState, generator):
        batch = train_sampler.sample_batch(generator, batch_size)
        state_t, action_t, goal_t = process_batch(batch, scaler)
        dev = action_t.device
        sigma = sample_density(generator, (action_t.shape[0],), device=dev)
        noise = step_noise(action_t.shape, generator, dev)
        model_draws = ss.denoiser.inner_model.train_draws(generator, state_t, goal_t)
        return state_t, action_t, goal_t, noise, sigma, model_draws

    def one_seed(ss: SweepState):
        def loss(params, state_t, action_t, goal_t, noise, sigma, model_draws):
            return ss.denoiser.loss(state_t, action_t, goal_t, noise, sigma,
                                    pred_last_action_only=pred_last_action_only,
                                    params=params, train=True, draws=list(model_draws))
        return loss

    def step(ss: SweepState, generators) -> torch.Tensor:
        stacked = _stack([draws(ss, g) for g in generators])
        losses = torch.func.vmap(one_seed(ss))(ss.params, *stacked)
        ss.optimizer.zero_grad(set_to_none=True)
        losses.sum().backward()
        ss.optimizer.step()
        ss.scheduler.step()
        ss.step += 1
        if ss.step % update_ema_every_n_steps == 0:
            ema_update(ss.ema, ss.params.items(), ema_decay)
        return losses.detach()

    def fused(ss: SweepState, generators: Sequence[torch.Generator]):
        if len(generators) != len(ss.seeds):
            raise ValueError(f"{len(generators)} generators for {len(ss.seeds)} seeds")
        return ss, torch.stack([step(ss, generators) for _ in range(n_steps)], dim=1)

    return fused


@torch.no_grad()
def sweep_eval_mse(ss: SweepState, batch: dict, scaler: Scaler,
                   generators: Sequence[Optional[torch.Generator]], use_ema: bool = True,
                   noise: Optional[torch.Tensor] = None, **eval_kwargs) -> torch.Tensor:
    """Per-seed test MSE [S] on one shared batch (beso_agent.py:250-289),
    `evaluate_mse` mapped over the seeds: seed i's start noise from
    `generators[i]` (or `noise` [S, B, T, A], given). A sampler that draws
    after the start (the ancestral ones, churn) raises under the map rather
    than draw from a generator other than the seed's."""
    params = ss.ema.params if use_ema else ss.params
    if noise is None:
        _, action_t, _ = process_batch(batch, scaler)
        noise = torch.stack([torch.randn(action_t.shape, generator=g, device=action_t.device)
                             for g in generators])

    def one(p, x):
        return evaluate_mse(ss.denoiser, p, batch, scaler, None, noise=x, **eval_kwargs)

    return torch.func.vmap(one)(params, noise)


def seed_state(ss: SweepState, i: int) -> TrainState:
    """Seed i's TrainState, a model and optimizer of its own with seed i's
    parameters, moments, schedule, EMA shadow and step, as a run of its own
    would hold them (`save_train_state` writes it)."""
    model = copy.deepcopy(ss.denoiser.inner_model)
    model = model.to_empty(device=next(iter(ss.params.values())).device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ss.params[name][i])
    optimizer, scheduler = ss.optimizer_factory(model.parameters())
    state = ss.optimizer.state_dict()
    state["state"] = {k: {n: v[i].clone() if n in ("exp_avg", "exp_avg_sq") else v.clone()
                          for n, v in st.items()}
                      for k, st in state["state"].items()}
    optimizer.load_state_dict(state)
    scheduler.load_state_dict(ss.scheduler.state_dict())
    ema = EmaState({n: t[i].clone() for n, t in ss.ema.params.items()}, ss.ema.num_updates)
    return TrainState(model, optimizer, scheduler, ema, ss.step)


def shard_sweep_state(ss: SweepState, mesh, axis: str = "dp") -> SweepState:
    """This rank's part of the seed axis over the mesh axis `axis`
    (`beso_tpu/train/sweep.py:96-109`): rank i of n keeps seeds [i S/n,
    (i+1) S/n) with their parameters, AdamW moments, EMA shadow, schedule
    and step, in a state with an optimizer of its own. Each seed then draws
    from its own generators (`seed_generators(state.seeds, device)`), as in
    the unsharded sweep; the per-seed programs are independent, so the
    ranks never communicate. Raises unless n divides S."""
    S = len(ss.seeds)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if S % n:
        raise ValueError(f"{S} seeds not divisible over {n} '{axis}' devices")
    i = mesh.get_local_rank(axis)
    rows = slice(i * S // n, (i + 1) * S // n)
    params = {k: v.detach()[rows].clone().requires_grad_(v.requires_grad)
              for k, v in ss.params.items()}
    optimizer, scheduler = ss.optimizer_factory(params.values())
    state = ss.optimizer.state_dict()
    state["state"] = {k: {m: t[rows].clone() if m in ("exp_avg", "exp_avg_sq") else t.clone()
                          for m, t in st.items()}
                      for k, st in state["state"].items()}
    optimizer.load_state_dict(state)
    scheduler.load_state_dict(ss.scheduler.state_dict())
    ema = EmaState({k: t[rows].clone() for k, t in ss.ema.params.items()}, ss.ema.num_updates)
    return SweepState(ss.denoiser, params, ss.optimizer_factory, optimizer, scheduler, ema,
                      ss.seeds[rows], ss.step)


def run_sweep(model_factory: Callable, optimizer_factory: Callable, sample_density: Callable,
              scaler: Scaler, train_sampler, test_batch: dict, seeds: Sequence[int], *,
              device=None, sigma_data: float = 0.5, batch_size: int = 1024,
              max_train_steps: int = 1000, eval_every_n_steps: int = 500,
              fused_steps: int = 50, use_ema: bool = True,
              num_sampling_steps: int = 3, sigma_min: float = 0.005, sigma_max: float = 1.0,
              sampler_type: str = "ddim", pred_last_action_only: bool = False,
              metrics_cb: Optional[Callable[[int, Any], None]] = None, **train_kwargs):
    """Train all seeds to max_train_steps (`beso_tpu/train/sweep.py:112-166`);
    returns (ss, history), history a list of (step, per-seed last train
    loss [S], per-seed test MSE [S]) at every evaluation. Each seed draws
    from its own generators, `seed_generators(seeds, device)`."""
    ss = init_sweep_state(model_factory, optimizer_factory, seeds, sigma_data)
    device = device if device is not None else next(iter(ss.params.values())).device
    train_gens, eval_gens = seed_generators(ss.seeds, device)
    n_params = sum(p[0].numel() for p in ss.params.values())
    log.info("sweep: %d seeds x %d params, %d steps", len(ss.seeds), n_params, max_train_steps)

    history = []
    step = 0
    while step < max_train_steps:
        to_eval = eval_every_n_steps - (step % eval_every_n_steps)
        n = min(fused_steps, to_eval, max_train_steps - step)
        ss, losses = make_sweep_train_steps(
            sample_density, scaler, train_sampler, batch_size, n,
            pred_last_action_only=pred_last_action_only, **train_kwargs)(ss, train_gens)
        step += n
        if step % eval_every_n_steps == 0 or step >= max_train_steps:
            mse = sweep_eval_mse(ss, test_batch, scaler, eval_gens, use_ema=use_ema,
                                 num_sampling_steps=num_sampling_steps, sigma_min=sigma_min,
                                 sigma_max=sigma_max, sampler_type=sampler_type,
                                 pred_last_action_only=pred_last_action_only)
            entry = (step, losses[:, -1].cpu().numpy(), mse.cpu().numpy())
            history.append(entry)
            log.info("sweep step %d: loss %s | test MSE %s", step,
                     [f"{x:.4f}" for x in entry[1]], [f"{x:.4f}" for x in entry[2]])
            if metrics_cb is not None:
                metrics_cb(step, entry)
    return ss, history
