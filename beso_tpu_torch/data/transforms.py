"""Observation and goal masking transforms for block push (torch port of
`beso_tpu/data/transforms.py`).

Functional parity target: `blockpush_mask_targets` (`beso/envs/utils.py:13-77`),
4 variants by (mask_targets, reduce_obs_dim): optionally zero obs[..., 10:]
(the target poses), and zero the non-block goal dims: [2, 5, 6, 7, 8, 9]
for 10-dim goals, and [10..15] as well for full 16-dim goals. The
transforms return new tensors and leave the caller's batch as it was.
"""

from __future__ import annotations

import torch

_GOAL_ZERO_10 = [2, 5, 6, 7, 8, 9]
_GOAL_ZERO_16 = [2, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def zero_goal_dims(goal: torch.Tensor) -> torch.Tensor:
    """Zero the non-block-position goal dims, chosen by the trailing size
    (dims past a narrower goal's end are skipped, as JAX's scatter drops
    them)."""
    n = goal.shape[-1]
    keep = torch.ones(n, dtype=torch.bool, device=goal.device)
    keep[[d for d in (_GOAL_ZERO_10 if n <= 10 else _GOAL_ZERO_16) if d < n]] = False
    return torch.where(keep, goal, torch.zeros((), dtype=goal.dtype, device=goal.device))


def blockpush_mask_targets(mask_targets: bool = False, reduce_obs_dim: bool = False):
    """Batch-dict transform factory (envs/utils.py:13-77). `reduce_obs_dim`
    is accepted for the reference's signature: the goal's own width picks
    the dims to zero."""

    def transform(batch: dict) -> dict:
        batch = dict(batch)
        if mask_targets:
            obs = batch["observation"]
            batch["observation"] = torch.cat(
                [obs[..., :10], torch.zeros_like(obs[..., 10:])], -1)
        if "goal_observation" in batch:
            batch["goal_observation"] = zero_goal_dims(batch["goal_observation"])
        return batch

    return transform
