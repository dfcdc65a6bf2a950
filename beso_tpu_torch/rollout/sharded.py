"""Data-parallel serving rollouts over a mesh (torch port of
`beso_tpu/rollout/sharded.py`).

The JAX package wraps the whole rollout in `shard_map` so that each device
runs its own Pallas kernels on its env shard. Here each rank is a process:
it takes its B / n envs of the global batch (`parallel.mesh.data_rows`),
runs `rollout_kitchen` / `rollout_block_push` on its own device (the
device of the tensors it was given) with the given engine, and the
metrics are gathered over the data axes in env order. Under
`engine="fused_cached"` each rank launches the layer kernels (B1) at its
shard's shape. Nothing crosses ranks inside the loop; ranks of one data
shard (a "tp" axis) run the same shard.

Each shard draws from a generator of its own, a deterministic function of
(seed, shard index) (the counterpart of `_fold_shard_key`,
`beso_tpu/rollout/sharded.py:47-56`): `shard_generator(seed, i, device)`
is `torch.Generator(device).manual_seed(shard_seed(seed, i))` with
`shard_seed(seed, i) = splitmix64(seed * 2**32 + i) >> 1`. A single-process
rollout of shard i's envs on that generator gives the shard's metrics.
"""

from __future__ import annotations

import torch

from beso_tpu_torch.parallel.mesh import data_index, data_rows, gather_data
from beso_tpu_torch.rollout.rollout import (RolloutMetrics, rollout_block_push,
                                            rollout_kitchen)

_MASK64 = (1 << 64) - 1


def shard_seed(seed: int, index: int) -> int:
    """splitmix64(seed * 2^32 + index), halved to a non-negative int64."""
    x = (int(seed) * (1 << 32) + int(index) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def shard_generator(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(shard_seed(seed, index))


def _sharded(rollout_fn, mesh, goals, expected, seed: int, n_steps: int,
             sharded_kw=None) -> RolloutMetrics:
    """`rollout_fn(goals, expected, generator, n_steps, **kw)` on this
    rank's env shard; `sharded_kw` entries (leading dim: the env batch)
    are cut with the goals, None entries passed as None."""
    B = expected.shape[0]
    rows = data_rows(mesh, B)   # raises unless the shards divide B
    kw = {k: (None if v is None else v[rows]) for k, v in (sharded_kw or {}).items()}
    gen = shard_generator(seed, data_index(mesh)[0], expected.device)
    m = rollout_fn(goals[rows], expected[rows], gen, n_steps, **kw)
    return RolloutMetrics(
        rewards=gather_data(m.rewards, mesh), results=gather_data(m.results, mesh),
        completed=gather_data(m.completed, mesh), env_steps=B * n_steps,
        completion_order=gather_data(m.completion_order, mesh))


def rollout_kitchen_sharded(denoise_fn, scaler, cfg, goals, expected, seed: int, mesh,
                            n_steps: int = 280, physics_params=None, init_qpos=None,
                            denoise_factory=None) -> RolloutMetrics:
    """`rollout_kitchen` with the env batch sharded over the mesh's data
    axes; `goals`, `expected` (and `init_qpos`) are the global batch, the
    same on every rank."""

    def fn(goals, expected, generator, n_steps, init_qpos=None):
        return rollout_kitchen(denoise_fn, scaler, cfg, goals, expected, generator,
                               n_steps=n_steps, physics_params=physics_params,
                               init_qpos=init_qpos, denoise_factory=denoise_factory)

    return _sharded(fn, mesh, goals, expected, seed, n_steps, dict(init_qpos=init_qpos))


def rollout_block_push_sharded(denoise_fn, scaler, cfg, goal_frames, expected, seed: int,
                               mesh, n_steps: int = 300, goal_seq_len: int = 1,
                               reduce_obs_dim: bool = True, mask_targets: bool = False,
                               denoise_factory=None) -> RolloutMetrics:
    """`rollout_block_push` sharded over the mesh's data axes: each shard
    resets its envs from its own generator and builds the flip-fixed goals
    from its live resets."""

    def fn(goals, expected, generator, n_steps):
        return rollout_block_push(denoise_fn, scaler, cfg, goals, expected, generator,
                                  n_steps=n_steps, goal_seq_len=goal_seq_len,
                                  reduce_obs_dim=reduce_obs_dim, mask_targets=mask_targets,
                                  denoise_factory=denoise_factory)

    return _sharded(fn, mesh, goal_frames, expected, seed, n_steps)
