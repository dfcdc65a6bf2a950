"""Input encoders: batch dict -> (state, goal) tensors (torch port of
`beso_tpu/agents/encoders.py`).

Functional parity targets: `BaseEncoder`
(`beso/agents/input_encoders/base_encoder.py:6-17`) and `NoEncoder`
(`beso/agents/input_encoders/obs_encoder.py:11-22`), the trivial encoder
that pulls 'observation' / 'goal_observation' from the batch. Vision
encoders compose the modules of `beso_tpu_torch.models.vision`.
"""

from __future__ import annotations

import abc
from typing import Tuple

import torch


class BaseEncoder(abc.ABC):
    @abc.abstractmethod
    def __call__(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        ...


class NoEncoder(BaseEncoder):
    """Identity encoder (obs_encoder.py:11-22)."""

    def __init__(self, obs_modality: str = "observation",
                 goal_modality: str = "goal_observation"):
        self.obs_modality = obs_modality
        self.goal_modality = goal_modality

    def __call__(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        return batch[self.obs_modality], batch[self.goal_modality]
