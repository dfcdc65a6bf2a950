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
from beso_tpu_torch.sampling.samplers import sample_loop


class PolicyState(NamedTuple):
    """Rolling context carried across env steps."""

    obs_buf: torch.Tensor   # [B, W, obs_dim] left-aligned window
    act_buf: torch.Tensor   # [B, W, act_dim] left-aligned; slot t-1 = newest
    count: torch.Tensor     # [B] int32 number of observations seen


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Inference-time knobs: `beso_tpu`'s PolicyConfig but for Picard's
    options. `policy_predict` raises for what is not ported
    (`check_ported`)."""

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
    s_churn: float = 0.0      # read by the stochastic samplers (A14); DDIM ignores it
    s_tmin: float = 0.0
    # multi-sample action selection (reference get_mean/use_kde,
    # beso_agent.py:352-368); only one sample is ported
    n_action_samples: int = 1
    aggregation: str = "single"  # 'single' | 'mean' | 'kde'


def scale_goal_for_model(scaler: Scaler, goal: torch.Tensor) -> torch.Tensor:
    """Scale the goal, then zero the non-block dims of 10-dim block-push
    goals (base_agent.py:119-120)."""
    goal_s = scaler.scale_input(goal)
    if goal_s.shape[-1] == 10:
        goal_s = goal_s.clone()
        goal_s[..., [2, 5, 6, 7, 8, 9]] = 0.0
    return goal_s


# the samplers `sampling/samplers.py::sample_loop` runs
PORTED_SAMPLERS = ("ddim",)


def check_ported(sampler_type: Optional[str] = None,
                 n_action_samples: Optional[int] = None) -> None:
    """Raise NotImplementedError, with its ROADMAP item, for a sampler or a
    multi-sample action selection that is not ported; None is not checked."""
    if n_action_samples is not None and n_action_samples > 1:
        raise NotImplementedError(
            "n_action_samples > 1 (mean and KDE aggregation) is not ported yet "
            "(ROADMAP.md, queue A, item A20)")
    if sampler_type is not None and sampler_type not in PORTED_SAMPLERS:
        raise NotImplementedError(
            f"sampler {sampler_type!r} is not ported to beso_tpu_torch yet "
            f"(ROADMAP.md, queue A, item A14)")


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
    The policy's only random draw."""
    return torch.randn(batch, action_dim, generator=generator, device=device)


def policy_predict(denoise: Callable[..., torch.Tensor], scaler: Scaler,
                   state: PolicyState, obs: torch.Tensor, goal: torch.Tensor,
                   generator: Optional[torch.Generator], cfg: PolicyConfig):
    """One control step: returns (action [B, act_dim] env units, new_state).

    `denoise(states, actions, goals, sigma)` is the preconditioned denoiser.
    obs: [B, obs_dim] raw observation; goal: [B, G, goal_dim] raw goal.
    """
    check_ported(cfg.sampler_type, cfg.n_action_samples)
    B = obs.shape[0]
    W = cfg.window_size
    rows = torch.arange(B, device=obs.device)

    obs_s = scaler.scale_input(obs)
    goal_s = scale_goal_for_model(scaler, goal)
    obs_buf = _append_window(state.obs_buf, obs_s, state.count, W)
    count = state.count + 1

    # fresh noise for ONLY the newest action token (beso_agent.py:352-362)
    newest = torch.clamp(count - 1, max=W - 1).long()
    x = state.act_buf.clone()
    x[rows, newest] = action_noise(B, cfg.action_dim, generator,
                                   obs.device) * cfg.sigma_max

    sigmas = get_noise_schedule(cfg.num_sampling_steps, cfg.sigma_min,
                                cfg.sigma_max, cfg.rho, cfg.noise_scheduler)
    dn = cfg_denoise_fn(denoise, cfg.cond_lambda)
    x0 = sample_loop(cfg.sampler_type,
                     lambda a, sig: dn(obs_buf, a, goal_s, sig), x, sigmas)

    # keep only the newest action slot (beso_agent.py:373-374)
    a_scaled = scaler.clip_action(x0[rows, newest])
    action = scaler.inverse_scale_output(a_scaled)

    # queue the clipped scaled action as next-step context (beso_agent.py:387)
    act_buf = state.act_buf.clone()
    act_buf[rows, newest] = a_scaled
    # when the obs window is full the action window shifts with it
    act_buf = torch.where((count >= W)[:, None, None],
                          torch.roll(act_buf, -1, dims=1), act_buf)
    return action, PolicyState(obs_buf=obs_buf, act_buf=act_buf, count=count)
