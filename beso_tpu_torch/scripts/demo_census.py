"""Demo-set multimodality census: clean vs play-style generators (port of
`scripts/demo_census.py`).

Runs the kitchen workspace's census instruments (the trajectory census and
the conditional-probability task tree of kitchen_workspace_manager.py:
564-570,637-708) over demonstration sets generated by the port's kitchen
oracle, plus execution-level dispersion statistics:

* sequence census: distinct completed-task sequences, Shannon entropy of
  the sequence distribution, top-1 share;
* task tree: mean branching factor at depths 1-3, weighted by prefix mass;
* execution dispersion: per-episode steps-to-first-completion and
  fingertip path length (mean +- std).

Usage: python -m beso_tpu_torch.scripts.demo_census [--episodes 1024]
       [--seed 6] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from beso_tpu_torch.envs.kitchen.env import ALL_TASKS, KITCHEN_BASE_POS
from beso_tpu_torch.envs.kitchen.fk import panda_fk
from beso_tpu_torch.workspaces.kitchen_workspace import FrankaKitchenWorkspace


def completion_census(onehot: np.ndarray) -> dict:
    """Trajectory census over demo one-hot labels [N, T, 7]: key = the
    completed tasks joined in completion order (the reference census key,
    kitchen_workspace_manager.py:564-570)."""
    census: dict = {}
    for ep in onehot:
        t_idx, task_idx = np.nonzero(ep > 0.5)
        order = np.argsort(t_idx)
        key = ", ".join(ALL_TASKS[task_idx[k]] for k in order)
        census[key] = census.get(key, 0) + 1
    return census


def census_stats(census: dict) -> dict:
    counts = np.asarray(list(census.values()), float)
    p = counts / counts.sum()
    entropy = float(-(p * np.log2(p)).sum())
    return {
        "distinct_sequences": len(census),
        "entropy_bits": round(entropy, 2),
        "top1_share": round(float(p.max()), 3),
    }


def branching_factors(census: dict, max_depth: int = 3) -> list:
    """Mass-weighted mean branching factor at each prefix depth of the
    task tree (kitchen_workspace_manager.py:637-708 tree semantics)."""
    tree = FrankaKitchenWorkspace.get_state_transitions(census)
    out = []
    level = [(tree, sum(census.values()))]
    for _ in range(max_depth):
        weights, branches, nxt = [], [], []
        for node, mass in level:
            kids = [(k, v) for k, v in node.items() if k not in ("count", "prob")]
            if not kids:
                continue
            weights.append(mass)
            branches.append(len(kids))
            nxt.extend((v, v["count"]) for _, v in kids)
        if not weights:
            out.append(0.0)
            level = []
            continue
        w = np.asarray(weights, float)
        out.append(round(float((w * np.asarray(branches)).sum() / w.sum()), 2))
        level = nxt
    return out


def execution_stats(data, device) -> dict:
    """Within-sequence execution dispersion from the raw demos."""
    onehot = np.asarray(data.onehot_goals)
    lengths = np.asarray(data.lengths)
    obs = np.asarray(data.observations)
    N, T_max = obs.shape[:2]
    q = torch.as_tensor(np.ascontiguousarray(obs[..., :7]), device=device)
    ee_all = panda_fk(q.reshape(N * T_max, 7), KITCHEN_BASE_POS).reshape(N, T_max, 3)
    ee_all = ee_all.cpu().numpy()
    first, path_len = [], []
    for i in range(N):
        t_idx, _ = np.nonzero(onehot[i] > 0.5)
        if t_idx.size:
            first.append(int(t_idx.min()))
        ee = ee_all[i, :int(lengths[i])]
        path_len.append(float(np.linalg.norm(np.diff(ee, axis=0), axis=-1).sum()))
    first = np.asarray(first, float)
    path_len = np.asarray(path_len)
    return {
        "steps_to_first_completion": f"{first.mean():.1f} +- {first.std():.1f}",
        "ee_path_length_m": f"{path_len.mean():.2f} +- {path_len.std():.2f}",
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--episodes", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=6)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; --device cpu runs on the CPU)")
    args = parser.parse_args(argv)

    from beso_tpu_torch.envs.kitchen.oracle import generate_kitchen_demonstrations

    device = torch.device(args.device)
    out = {}
    for label, play in (("clean", False), ("play_style", True)):
        data = generate_kitchen_demonstrations(
            args.episodes, 280, play_style=play,
            generator=torch.Generator(device).manual_seed(args.seed), device=device)
        census = completion_census(np.asarray(data.onehot_goals))
        row = census_stats(census)
        row["branching_depth_1_2_3"] = branching_factors(census)
        row.update(execution_stats(data, device))
        out[label] = row
        print(label, json.dumps(row))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
