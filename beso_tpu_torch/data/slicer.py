"""Window slicing and future-goal sampling on device tensors (torch port of
`beso_tpu/data/slicer.py`).

Functional parity target: `TrajectorySlicerDataset`
(`beso/envs/dataloaders/trajectory_loader.py:79-197`):

* every trajectory is cut into all overlapping windows of length `window`
  (slice table built once, trajectory_loader.py:129-138);
* each item is a dict {observation[W], action[W], goal_observation[G]};
* the future-conditional goal is a random window at least `min_future_sep`
  after the slice end (trajectory_loader.py:169-182); zeros if the
  trajectory is too short (trajectory_loader.py:183-186).

The dataset lives on the device as padded tensors and a batch is one
gather, as in the JAX package; random draws come from an explicit
`torch.Generator` on that device. An optional `transform` maps each batch
dict (the block-push workspace masks goals with it, `data/transforms.py`).
The JAX slicer's other goal modes (`only_sample_tail`,
`only_sample_seq_end`, no goal) are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from beso_tpu_torch.data.trajectories import TrajectoryData


def make_slices(lengths: np.ndarray, window: int) -> np.ndarray:
    """All (traj, start) pairs with start + window <= length
    (trajectory_loader.py:129-138), int32 [N, 2]."""
    out = [(i, start) for i, T in enumerate(np.asarray(lengths))
           for start in range(int(T) - window + 1)]
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


class SlicedDataset:
    """Batched window sampler over a TrajectoryData, on `device`."""

    def __init__(self, data: TrajectoryData, window: int, future_seq_len: int,
                 min_future_sep: int = 0,
                 transform: Optional[Callable[[dict], dict]] = None, device="cuda"):
        self.window = window
        self.future_seq_len = future_seq_len
        self.min_future_sep = min_future_sep
        self.transform = transform
        self.device = torch.device(device)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.slices = dev(make_slices(data.lengths, window), torch.long)
        self.observations = dev(data.observations, torch.float32)
        self.actions = dev(data.actions, torch.float32)
        self.lengths = dev(data.lengths, torch.long)

    def __len__(self) -> int:
        return int(self.slices.shape[0])

    def _gather(self, slice_idx: torch.Tensor,
                generator: Optional[torch.Generator]) -> dict:
        traj = self.slices[slice_idx, 0]           # [B]
        start = self.slices[slice_idx, 1]          # [B]
        W = self.window
        t_idx = start[:, None] + torch.arange(W, device=self.device)[None, :]
        batch = {"observation": self.observations[traj[:, None], t_idx],
                 "action": self.actions[traj[:, None], t_idx]}

        G = self.future_seq_len
        end = start + W
        T = self.lengths[traj]
        lo = end + self.min_future_sep
        hi = T - G                                   # exclusive upper start
        span = torch.clamp(hi - lo, min=1)
        u = torch.randint(0, 1 << 30, lo.shape, generator=generator, device=self.device)
        g_idx = (lo + u % span)[:, None] + torch.arange(G, device=self.device)[None, :]
        g_idx = torch.clamp(g_idx, 0, self.observations.shape[1] - 1)
        goal = self.observations[traj[:, None], g_idx]
        batch["goal_observation"] = torch.where((lo < hi)[:, None, None], goal,
                                                torch.zeros((), device=self.device))
        return batch if self.transform is None else self.transform(batch)

    def sample_batch(self, generator: Optional[torch.Generator],
                     batch_size: int) -> dict:
        """Random batch of windows (shuffled training stream)."""
        idx = torch.randint(0, len(self), (batch_size,), generator=generator,
                            device=self.device)
        return self._gather(idx, generator)

    def batch_at(self, indices, generator: Optional[torch.Generator] = None) -> dict:
        """Batch at explicit slice indices (test stream)."""
        return self._gather(torch.as_tensor(indices, dtype=torch.long,
                                            device=self.device), generator)

    def epoch_batches(self, batch_size: int,
                      generator: Optional[torch.Generator] = None):
        """Sequential full-epoch iteration (drops the ragged tail). Without a
        generator the goal draws come from a fresh one seeded 0, so every
        epoch yields the same batches (the JAX package's fixed key)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        for b in range(len(self) // batch_size):
            idx = torch.arange(b * batch_size, (b + 1) * batch_size, device=self.device)
            yield self._gather(idx, generator)
