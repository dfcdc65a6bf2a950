"""Environment registry of the reference's gym env ids (torch port of
`beso_tpu/envs/registry.py`).

The ids are the gym registrations of `beso/envs/__init__.py:6-37`
(kitchen) and `beso/envs/block_pushing/block_pushing.py:1020-1097` +
`block_pushing_multimodal.py:706-730` (block push). `make(env_id)` returns
an `EnvSpec` of the port's batched functions:

* `reset_fn(batch_size, generator=None, device=None)` -> state of B envs
  (the kitchen resets deterministically and draws nothing);
* `step_fn(state, action [B, A])` -> (state, obs, reward [B], done [B]);
* `obs_fn(state)` -> obs [B, obs_dim];
* `render_fn(state, env_index=0)` -> uint8 RGB of one env, on the host
  (matplotlib), for the `*Rgb-v0` ids; None otherwise.

Variants (each behaviourally distinct): `*Normalized-v0` is the reference's
BlockPushNormalized wrapper (observations restructured and mapped with the
published stats, actions in [-1, 1], reward x100); `BlockInsert*` the
slotted INSERT task; `BlockPushMultimodalFlipped-v0` the horizontal layout
at a 25-step limit.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional


class EnvSpec(NamedTuple):
    reset_fn: Callable
    step_fn: Callable
    obs_fn: Callable
    max_episode_steps: int
    render_fn: Optional[Callable] = None


def _kitchen_spec(task_mask=None, steps=280) -> EnvSpec:
    from beso_tpu_torch.envs.kitchen.env import kitchen_obs, kitchen_reset, kitchen_step

    def reset_fn(batch_size, generator=None, device=None):
        return kitchen_reset(batch_size, device, task_mask)

    return EnvSpec(reset_fn, kitchen_step, kitchen_obs, steps)


def _multimodal_spec(steps=350, horizontal=False, rgb=False) -> EnvSpec:
    from beso_tpu_torch.envs.block_push.env import (block_push_obs, block_push_reset,
                                                    block_push_step)

    render_fn = None
    if rgb:
        from beso_tpu_torch.envs.block_push.render import render_frame
        render_fn = render_frame
    return EnvSpec(partial(block_push_reset, horizontal=horizontal), block_push_step,
                   block_push_obs, steps, render_fn)


def _single_spec(task: str, steps=100, normalized=False, rgb=False) -> EnvSpec:
    from beso_tpu_torch.envs.block_push.single import (denormalize_action, normalized_obs,
                                                       single_block_push_obs,
                                                       single_block_push_reset,
                                                       single_block_push_step)

    reset_fn = partial(single_block_push_reset, task=task)
    step_fn = partial(single_block_push_step, task=task)
    obs_fn = single_block_push_obs
    if normalized:
        raw_step = step_fn
        obs_fn = normalized_obs

        def step_fn(state, action):  # noqa: F811
            s, _, r, d = raw_step(state, denormalize_action(action))
            # "Keep returns in [0, 100]" (block_pushing.py:860)
            return s, normalized_obs(s), r * 100.0, d

    render_fn = None
    if rgb:
        from beso_tpu_torch.envs.block_push.render import render_single_frame
        render_fn = partial(render_single_frame, task=task)
    return EnvSpec(reset_fn, step_fn, obs_fn, steps, render_fn)


# kitchen task-subset variants (envs/franka_kitchen/v0.py:4-20): the three
# fixed 4-task subsets and the evaluated all-7 variant
_KITCHEN_SUBSETS = {
    "kitchen-all-v0": None,
    "kitchen-microwave-kettle-light-slider-v0": (0, 0, 1, 1, 0, 1, 1),
    "kitchen-microwave-kettle-burner-light-v0": (1, 0, 1, 0, 0, 1, 1),
    "kitchen-kettle-microwave-light-slider-v0": (0, 0, 1, 1, 0, 1, 1),
}

_REGISTRY = {
    **{k: (lambda m=v: _kitchen_spec(m)) for k, v in _KITCHEN_SUBSETS.items()},
    "BlockPush-v0": lambda: _single_spec("PUSH"),
    "BlockPushNormalized-v0": lambda: _single_spec("PUSH", normalized=True),
    "BlockPushRgb-v0": lambda: _single_spec("PUSH", rgb=True),
    "BlockReach-v0": lambda: _single_spec("REACH"),
    "BlockReachNormalized-v0": lambda: _single_spec("REACH", normalized=True),
    "BlockReachRgb-v0": lambda: _single_spec("REACH", rgb=True),
    "BlockInsert-v0": lambda: _single_spec("INSERT"),
    "BlockInsertRgb-v0": lambda: _single_spec("INSERT", rgb=True),
    "BlockPushMultimodal-v0": _multimodal_spec,
    "BlockPushMultimodalFlipped-v0": lambda: _multimodal_spec(steps=25, horizontal=True),
    "BlockPushHorizontalMultimodal-v0": lambda: _multimodal_spec(horizontal=True),
    "BlockPushMultimodalRgb-v0": lambda: _multimodal_spec(rgb=True),
    # SHARED_MEMORY is a pybullet connection mode: no behavioural difference
    "SharedBlockPushMultimodal-v0": _multimodal_spec,
}


def make(env_id: str) -> EnvSpec:
    try:
        return _REGISTRY[env_id]()
    except KeyError:
        raise ValueError(f"unknown env id {env_id!r}; known: {sorted(_REGISTRY)}") from None


def registered_ids():
    return sorted(_REGISTRY)
