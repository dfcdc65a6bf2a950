"""Top-down 2D renderer and video writer for the block-push envs (torch
port of `beso_tpu/envs/block_push/render.py`; the reference renders with
Bullet's GL camera, `block_pushing.py:604-679`, and writes imageio videos,
`kitchen_workspace_manager.py:309-314`).

A matplotlib schematic of the planar scene: blocks as oriented squares,
target zones as circles, the effector as a dot. It runs on the host:
matplotlib and imageio are imported when a frame is drawn or a video
written, and their absence raises ImportError with what to install. The
port's states are batched: `env_index` picks the env to draw.
"""

from __future__ import annotations

from typing import List

import numpy as np

from beso_tpu_torch.envs.block_push.env import (BLOCK_HALF, EFFECTOR_RADIUS,
                                                GOAL_DIST_TOLERANCE, WORKSPACE_BOUNDS)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the block-push renderer draws with matplotlib, which is not "
                          "installed (pip install matplotlib)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x, env_index: int) -> np.ndarray:
    return x[env_index].detach().float().cpu().numpy()


def _axes(plt, size: int):
    fig, ax = plt.subplots(figsize=(size / 100, size / 100), dpi=100)
    lo, hi = np.asarray(WORKSPACE_BOUNDS)
    ax.set_xlim(lo[0] - 0.05, hi[0] + 0.05)
    ax.set_ylim(lo[1] - 0.05, hi[1] + 0.05)
    ax.set_aspect("equal")
    ax.axis("off")
    return fig, ax


def _block(ax, pos: np.ndarray, yaw: float, color: str) -> None:
    from matplotlib.patches import Rectangle
    from matplotlib.transforms import Affine2D

    rect = Rectangle(pos - BLOCK_HALF, 2 * BLOCK_HALF, 2 * BLOCK_HALF, color=color, alpha=0.8)
    rect.set_transform(Affine2D().rotate_around(*pos, yaw) + ax.transData)
    ax.add_patch(rect)


def _pixels(plt, fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def render_frame(state, env_index: int = 0, size: int = 256) -> np.ndarray:
    """One env of a multimodal `BlockPushState` as RGB uint8 [size, size, 3]."""
    plt = _pyplot()
    from matplotlib.patches import Circle

    fig, ax = _axes(plt, size)
    colors = ["tab:red", "tab:green"]
    target_pos, block_pos = _host(state.target_pos, env_index), _host(state.block_pos, env_index)
    block_yaw = _host(state.block_yaw, env_index)
    for t in range(2):
        ax.add_patch(Circle(target_pos[t], GOAL_DIST_TOLERANCE, fill=False, color=colors[t],
                            lw=2))
    for b in range(2):
        _block(ax, block_pos[b], float(block_yaw[b]), colors[b])
    ax.add_patch(Circle(_host(state.effector, env_index), EFFECTOR_RADIUS, color="k"))
    return _pixels(plt, fig)


def render_single_frame(state, env_index: int = 0, size: int = 256,
                        task: str = "PUSH") -> np.ndarray:
    """One env of a `SingleBlockPushState` (PUSH / REACH / INSERT) as RGB:
    the `*Rgb-v0` ids' renderer. INSERT draws the slot opening as a wedge,
    REACH its reach point."""
    plt = _pyplot()
    from matplotlib.patches import Circle, Wedge

    from beso_tpu_torch.envs.block_push.single import SLOT_HALF_ANGLE, SLOT_RADIUS

    # the zones are drawn at the multimodal env's tolerance, as the JAX renderer does
    fig, ax = _axes(plt, size)
    tpos = _host(state.target_pos, env_index)
    if task == "INSERT":
        yaw = float(_host(state.target_yaw, env_index))
        ax.add_patch(Wedge(tpos, SLOT_RADIUS, np.degrees(yaw + SLOT_HALF_ANGLE),
                           np.degrees(yaw - SLOT_HALF_ANGLE) + 360, color="tab:gray",
                           alpha=0.5))
    ax.add_patch(Circle(tpos, GOAL_DIST_TOLERANCE, fill=False, color="tab:green", lw=2))
    if task == "REACH":
        ax.add_patch(Circle(_host(state.reach_target, env_index), GOAL_DIST_TOLERANCE,
                            fill=False, color="tab:blue", lw=2))
    _block(ax, _host(state.block_pos, env_index), float(_host(state.block_yaw, env_index)),
           "tab:red")
    ax.add_patch(Circle(_host(state.effector, env_index), EFFECTOR_RADIUS, color="k"))
    return _pixels(plt, fig)


def save_video(frames: List[np.ndarray], path, fps: int = 30) -> None:
    """Write frames to an mp4 or gif (kitchen_workspace_manager.py:309-314)."""
    try:
        import imageio
    except ImportError as e:
        raise ImportError("writing a video needs imageio, which is not installed "
                          "(pip install imageio)") from e
    imageio.mimsave(path, frames, fps=fps)
