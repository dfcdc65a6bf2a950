"""Schematic kitchen renderer: task-progress frames (torch port of
`beso_tpu/envs/kitchen/render.py`).

The reference renders MuJoCo RGB rollout videos
(kitchen_workspace_manager.py:263-266, 309-314). Without the MuJoCo scene
this draws, per frame, one progress bar per task element (|obs - goal|
against the 0.3 completion threshold) and the fingertip position. It runs
on the host with matplotlib, imported when a frame is drawn; its absence
raises ImportError. `env_index` picks the env of a batched state.
"""

from __future__ import annotations

import numpy as np

from beso_tpu_torch.envs.block_push.render import _pyplot
from beso_tpu_torch.envs.kitchen.env import ALL_TASKS, BONUS_THRESH, GOAL_VEC, TASK_MASKS


def render_frame(state, env_index: int = 0, size: int = 320) -> np.ndarray:
    """One env of a `KitchenState` as RGB uint8 [size, size, 3]."""
    plt = _pyplot()
    qpos = state.qpos[env_index].detach().float().cpu().numpy()
    dists = np.linalg.norm((qpos - GOAL_VEC) * TASK_MASKS, axis=-1)
    # progress: 1 at the goal, 0 at (or beyond) 3x the threshold
    progress = np.clip(1.0 - dists / (3 * BONUS_THRESH), 0, 1)
    done = dists < BONUS_THRESH

    fig, ax = plt.subplots(figsize=(size / 100, size / 100), dpi=100)
    y = np.arange(7)
    ax.barh(y, progress, color=["tab:green" if d else "tab:blue" for d in done])
    ax.axvline(1.0 - 1 / 3, color="k", ls="--", lw=1)  # completion line
    ax.set_yticks(y, [t.replace(" ", "\n") for t in ALL_TASKS], fontsize=6)
    ax.set_xlim(0, 1.05)
    ax.set_xlabel("task progress", fontsize=7)
    ee = state.ee_pos[env_index].detach().float().cpu().numpy()
    ax.set_title(f"ee=({ee[0]:+.2f},{ee[1]:+.2f},{ee[2]:+.2f})  done={int(done.sum())}/7",
                 fontsize=8)
    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf
