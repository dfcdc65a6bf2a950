"""Load a flax DiffusionGPT parameter tree into the torch DiffusionGPT.

No JAX counterpart: this is the hand-off that lets both packages compute
with the same weights. The tree is given as numpy arrays (for example
`jax.tree.map(np.asarray, params)`), so this module imports no JAX.

Names map one to one: `block_{i}/{ln1,attn/qkv,attn/proj,ln2,fc,fc_proj}`,
`ln_f`, `sigma_emb`, `tok_emb`, `goal_emb`, `action_emb`, `pos_emb`, and
`action_pred` or `action_pred_fc`/`action_pred_out`. Flax Dense kernels are
[in, out]; torch Linear weights are [out, in].
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.as_tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: flax {tuple(src.shape)} vs "
                         f"torch {tuple(dst.shape)}")
    dst.copy_(src)


def _dense(lin: nn.Linear, tree: Mapping[str, Any]) -> None:
    _copy(lin.weight, np.asarray(tree["kernel"]).T)
    _copy(lin.bias, tree["bias"])


def _norm(ln: nn.LayerNorm, tree: Mapping[str, Any]) -> None:
    _copy(ln.weight, tree["scale"])
    _copy(ln.bias, tree["bias"])


def params_from_jax(flax_params: Mapping[str, Any], model) -> None:
    """Copy a flax DiffusionGPT tree (numpy leaves, with or without the
    top-level "params" key) into `model` in place."""
    p = flax_params.get("params", flax_params)
    with torch.no_grad():
        for name in ("sigma_emb", "tok_emb", "action_emb"):
            _dense(getattr(model, name), p[name])
        if model.has_goal_emb:
            _dense(model.goal_emb, p["goal_emb"])
        _copy(model.pos_emb, p["pos_emb"])
        for i, blk in enumerate(model.blocks):
            fb = p[f"block_{i}"]
            _norm(blk.ln1, fb["ln1"])
            _dense(blk.attn.qkv, fb["attn"]["qkv"])
            _dense(blk.attn.proj, fb["attn"]["proj"])
            _norm(blk.ln2, fb["ln2"])
            _dense(blk.fc, fb["fc"])
            _dense(blk.fc_proj, fb["fc_proj"])
        _norm(model.ln_f, p["ln_f"])
        if model.linear_output:
            _dense(model.action_pred, p["action_pred"])
        else:
            _dense(model.action_pred_fc, p["action_pred_fc"])
            _dense(model.action_pred_out, p["action_pred_out"])
