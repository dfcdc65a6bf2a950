"""Policy prediction with a rolling obs/action context (torch port of
`beso_tpu/agents/policy.py`).

Functional parity target: BesoAgent.predict + reset
(`beso/agents/diffusion_agents/beso_agent.py:291-388`):

* an observation window of `window_size` and the matching action window
  give the transformer its context;
* fresh noise x ~ N(0, sigma_max^2) is drawn ONLY for the newest action
  token; earlier predicted actions stay as context (beso_agent.py:352-362);
* the sampler integrates the full action-token tensor and the newest slot
  is kept, clipped to 1.1x the action bounds and inverse-scaled; the clipped
  scaled value enters the action context (beso_agent.py:373-387).

The windows are fixed-shape left-aligned buffers plus a fill counter, as
in the JAX package: while a buffer fills, its padding sits to the right of
the real tokens, where the causal mask hides it from the read-out slot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from beso_tpu_torch.core.schedules import get_noise_schedule
from beso_tpu_torch.models.cfg import cfg_denoise_fn
from beso_tpu_torch.models.scaler import Scaler
from beso_tpu_torch.sampling.parallel import sample_picard
from beso_tpu_torch.sampling.samplers import sample_loop
from beso_tpu_torch.utils.metrics import span


class PolicyState(NamedTuple):
    """Rolling context carried across env steps."""

    obs_buf: torch.Tensor   # [B, W, obs_dim] left-aligned window
    act_buf: torch.Tensor   # [B, W, act_dim] left-aligned; slot t-1 = newest
    count: torch.Tensor     # [B] int32 number of observations seen


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Inference-time knobs (a subset of BesoAgent's ctor args)."""

    window_size: int
    obs_dim: int
    action_dim: int
    sampler_type: str = "ddim"
    num_sampling_steps: int = 3
    sigma_min: float = 0.005
    sigma_max: float = 1.0
    sigma_data: float = 0.5
    rho: float = 5.0
    noise_scheduler: str = "exponential"
    cond_lambda: float = 1.0  # >1/<1 wraps the model in CFG
    s_churn: float = 0.0      # churn of heun, euler and dpm; the others ignore it
    s_tmin: float = 0.0
    # multi-sample action selection (reference get_mean/use_kde,
    # beso_agent.py:352-368)
    n_action_samples: int = 1
    aggregation: str = "single"  # 'single' | 'mean' | 'kde'
    # sampler_type='picard' runs Picard parallel sampling
    # (sampling/parallel.py): K sweeps of one [n*B]-row denoise each in
    # place of n sequential calls
    picard_update: str = "ddim"          # 'ddim' | 'euler'
    picard_iterations: Optional[int] = None  # None = n (exact)


def scale_goal_for_model(scaler: Scaler, goal: torch.Tensor) -> torch.Tensor:
    """Scale the goal, then zero the non-block dims of 10-dim block-push
    goals (base_agent.py:119-120)."""
    goal_s = scaler.scale_input(goal)
    if goal_s.shape[-1] == 10:
        goal_s = goal_s.clone()
        goal_s[..., [2, 5, 6, 7, 8, 9]] = 0.0
    return goal_s


def policy_reset(batch_size: int, cfg: PolicyConfig, device=None) -> PolicyState:
    """Clear the rolling contexts (beso_agent.py:291-294)."""
    W = cfg.window_size
    return PolicyState(
        obs_buf=torch.zeros(batch_size, W, cfg.obs_dim, device=device),
        act_buf=torch.zeros(batch_size, W, cfg.action_dim, device=device),
        count=torch.zeros(batch_size, dtype=torch.int32, device=device))


def _append_window(buf: torch.Tensor, item: torch.Tensor, count: torch.Tensor,
                   width: int) -> torch.Tensor:
    """Left-aligned deque append: write at slot `count` while filling, else
    shift left and write at the last slot."""
    B = buf.shape[0]
    full = (count >= width)[:, None, None]
    base = torch.where(full, torch.roll(buf, -1, dims=1), buf)
    slot = torch.clamp(count, max=width - 1).long()
    base[torch.arange(B, device=buf.device), slot] = item
    return base


def action_noise(batch: int, action_dim: int,
                 generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Unit normal draws for the newest action slot, [batch, action_dim].
    The policy's own random draw; a stochastic sampler then draws from the
    same generator (`sampling/samplers.py::sampler_noise`)."""
    return torch.randn(batch, action_dim, generator=generator, device=device)


def kde_density(cands: torch.Tensor) -> torch.Tensor:
    """Each candidate's density under a gaussian KDE over its env's
    candidate set (Scott's-rule bandwidth, population std as jnp.std).
    cands: [B, n, d] -> [B, n]."""
    B, n, d = cands.shape
    std = torch.std(cands, dim=1, keepdim=True, correction=0).mean(dim=-1, keepdim=True)
    h = torch.clamp(std * n ** (-1.0 / (d + 4)), min=1e-6)        # [B, 1, 1]
    sq = torch.sum((cands[:, :, None, :] - cands[:, None, :, :]) ** 2, dim=-1)
    return torch.sum(torch.exp(-0.5 * sq / h ** 2), dim=-1)


def _kde_select(cands: torch.Tensor) -> torch.Tensor:
    """The max-density sample per env (`kde_density`). cands: [B, n, d] ->
    [B, d]."""
    best = torch.argmax(kde_density(cands), dim=-1)
    return cands[torch.arange(cands.shape[0], device=cands.device), best]


def policy_predict(denoise: Callable[..., torch.Tensor], scaler: Scaler,
                   state: PolicyState, obs: torch.Tensor, goal: torch.Tensor,
                   generator: Optional[torch.Generator], cfg: PolicyConfig):
    """One control step: returns (action [B, act_dim] env units, new_state).

    `denoise(states, actions, goals, sigma)` is the preconditioned denoiser.
    obs: [B, obs_dim] raw observation; goal: [B, G, goal_dim] raw goal.
    With `n_action_samples` = n > 1, each env's rows are repeated n times
    (`repeat_interleave`) into one [B*n]-row sampler call and `aggregation`
    picks the action from the n candidates. `generator` draws the action
    noise, then the sampler's noise. Under a profiler the step is the span
    `policy.predict`, and each call of `denoise` within it `engine.call`
    (CFG's stacking and combining stay outside it).
    """
    with span("policy.predict"):
        return _predict(denoise, scaler, state, obs, goal, generator, cfg)


def _engine_calls(denoise):
    """`denoise` with each call inside the span `engine.call`."""
    def call(*args, **kw):
        with span("engine.call"):
            return denoise(*args, **kw)

    return call


def _predict(denoise, scaler: Scaler, state: PolicyState, obs: torch.Tensor,
             goal: torch.Tensor, generator: Optional[torch.Generator], cfg: PolicyConfig):
    B = obs.shape[0]
    W = cfg.window_size
    rows = torch.arange(B, device=obs.device)

    obs_s = scaler.scale_input(obs)
    goal_s = scale_goal_for_model(scaler, goal)
    obs_buf = _append_window(state.obs_buf, obs_s, state.count, W)
    count = state.count + 1

    # fresh noise for ONLY the newest action token (beso_agent.py:352-362)
    n_samp = max(1, cfg.n_action_samples)
    newest = torch.clamp(count - 1, max=W - 1).long()
    x, obs_in, goal_in, newest_in = state.act_buf, obs_buf, goal_s, newest
    if n_samp > 1:
        x, obs_in, goal_in, newest_in = (v.repeat_interleave(n_samp, dim=0)
                                         for v in (x, obs_in, goal_in, newest_in))
    Bn = B * n_samp
    x = x.clone()
    x[torch.arange(Bn, device=obs.device), newest_in] = action_noise(
        Bn, cfg.action_dim, generator, obs.device) * cfg.sigma_max

    sigmas = get_noise_schedule(cfg.num_sampling_steps, cfg.sigma_min,
                                cfg.sigma_max, cfg.rho, cfg.noise_scheduler)
    dn = cfg_denoise_fn(_engine_calls(denoise), cfg.cond_lambda)
    if cfg.sampler_type == "picard":
        def dn_tiled(actions, sigma):
            # the conditioning tiled over the folded [n_grid * Bn] batch
            reps = actions.shape[0] // Bn
            return dn(obs_in.repeat(reps, 1, 1), actions, goal_in.repeat(reps, 1, 1),
                      sigma)

        x0 = sample_picard(dn_tiled, x, sigmas, update=cfg.picard_update,
                           n_iterations=cfg.picard_iterations)
    else:
        x0 = sample_loop(cfg.sampler_type, lambda a, sig: dn(obs_in, a, goal_in, sig),
                         x, sigmas, generator, s_churn=cfg.s_churn, s_tmin=cfg.s_tmin)

    # keep only the newest action slot (beso_agent.py:373-374)
    a_scaled = x0[torch.arange(Bn, device=obs.device), newest_in]
    if n_samp > 1:
        cands = a_scaled.reshape(B, n_samp, cfg.action_dim)
        if cfg.aggregation == "mean":
            a_scaled = cands.mean(dim=1)
        elif cfg.aggregation == "kde":
            a_scaled = _kde_select(cands)
        else:  # 'single'
            a_scaled = cands[:, 0]
    a_scaled = scaler.clip_action(a_scaled)
    action = scaler.inverse_scale_output(a_scaled)

    # queue the clipped scaled action as next-step context (beso_agent.py:387)
    act_buf = state.act_buf.clone()
    act_buf[rows, newest] = a_scaled
    # when the obs window is full the action window shifts with it
    act_buf = torch.where((count >= W)[:, None, None],
                          torch.roll(act_buf, -1, dims=1), act_buf)
    return action, PolicyState(obs_buf=obs_buf, act_buf=act_buf, count=count)
