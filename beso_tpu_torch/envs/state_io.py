"""Environment state save and restore (torch port of
`beso_tpu/envs/state_io.py`, the counterpart of the reference's pybullet
scene serialization, `utils_pybullet.py:243-450`).

An env state is a NamedTuple of tensors (batched or not). Its leaves go to
an `.npz` in field order as `leaf_0`, `leaf_1`, ..., with `_version` and a
`_treedef` description: the JAX package's format, so that a state saved by
either package loads in the other (JAX flattens a NamedTuple in field
order too). The loader checks the version only, as JAX's does, and takes
the structure from a template state.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

_FORMAT_VERSION = "beso_tpu_env_state_v1"


def _leaves(tree: Any) -> List[torch.Tensor]:
    """A (nested) NamedTuple's tensors in field order."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(template: Any, it) -> Any:
    if isinstance(template, tuple):
        return type(template)(*(_rebuild(v, it) for v in template))
    return next(it)


def save_env_state(state: Any, path) -> None:
    """Write any env state (a NamedTuple of tensors, batched or not) to .npz."""
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": torch.as_tensor(x).detach().cpu().numpy()
              for i, x in enumerate(leaves)}
    np.savez(path, _version=np.asarray(_FORMAT_VERSION),
             _treedef=np.asarray(f"{type(state).__name__}({len(leaves)} leaves)"), **arrays)


def load_env_state(template: Any, path) -> Any:
    """The state saved at `path`, shaped like `template`, each leaf on its
    template leaf's device."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["_version"]) != _FORMAT_VERSION:
            raise ValueError(f"unknown state format {str(data['_version'])!r}")
        devices = [torch.as_tensor(x).device for x in _leaves(template)]
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=d) for i, d in enumerate(devices)]
    return _rebuild(template, iter(leaves))
