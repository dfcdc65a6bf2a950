"""Full train-state checkpoints with `torch.save` (port of the save/restore part
of `beso_tpu/train/checkpoint.py`).

The reference stores bare model weights only (`beso_agent.py:466-476`), so it
cannot resume mid-training; here the full state round-trips: parameters,
optimizer moments and step counts, the LR scheduler, the EMA shadow and its
update counter, and the train step. The loader for the reference's `.pth`
state-dict names waits (ROADMAP queue A).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from beso_tpu_torch.train.trainer import TrainState


def checkpoint_path(directory, name: str = "best") -> Path:
    return Path(directory) / f"{name}.pt"


def save_train_state(ts: TrainState, directory, name: str = "best") -> Path:
    path = checkpoint_path(directory, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({"params": ts.model.state_dict(),
                "optimizer": ts.optimizer.state_dict(),
                "scheduler": ts.scheduler.state_dict(),
                "ema": ts.ema.params,
                "ema_num_updates": ts.ema.num_updates,
                "step": ts.step}, tmp)
    os.replace(tmp, path)
    return path


@torch.no_grad()
def restore_train_state(ts: TrainState, directory, name: str = "best") -> TrainState:
    """Load a saved state into `ts` (built with the same model config) in
    place, onto the devices its tensors already live on."""
    device = next(ts.model.parameters()).device
    state = torch.load(checkpoint_path(directory, name), map_location=device,
                       weights_only=True)
    ts.model.load_state_dict(state["params"])
    ts.optimizer.load_state_dict(state["optimizer"])
    ts.scheduler.load_state_dict(state["scheduler"])
    for k, v in state["ema"].items():
        ts.ema.params[k].copy_(v)
    ts.ema.num_updates = state["ema_num_updates"]
    ts.step = state["step"]
    return ts
