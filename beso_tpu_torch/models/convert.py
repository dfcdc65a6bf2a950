"""Carry DiffusionGPT weights between the flax tree and the torch module.

No JAX counterpart: this is the hand-off that lets both packages compute
with the same weights, in both directions: `params_from_jax` loads a flax
tree into the torch model, `params_to_numpy_tree` gives the torch weights
back under the flax names (to compare trained weights leaf by leaf). Trees
are numpy arrays (for example `jax.tree.map(np.asarray, params)`), so this
module imports no JAX.

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


def _named_modules(model):
    """(flax path, torch module, kind) for every parameterised layer."""
    out = [(("sigma_emb",), model.sigma_emb, "dense"),
           (("tok_emb",), model.tok_emb, "dense"),
           (("action_emb",), model.action_emb, "dense")]
    if model.has_goal_emb:
        out.append((("goal_emb",), model.goal_emb, "dense"))
    for i, blk in enumerate(model.blocks):
        b = f"block_{i}"
        out += [((b, "ln1"), blk.ln1, "norm"), ((b, "attn", "qkv"), blk.attn.qkv, "dense"),
                ((b, "attn", "proj"), blk.attn.proj, "dense"),
                ((b, "ln2"), blk.ln2, "norm"), ((b, "fc"), blk.fc, "dense"),
                ((b, "fc_proj"), blk.fc_proj, "dense")]
    out.append((("ln_f",), model.ln_f, "norm"))
    if model.linear_output:
        out.append((("action_pred",), model.action_pred, "dense"))
    else:
        out += [(("action_pred_fc",), model.action_pred_fc, "dense"),
                (("action_pred_out",), model.action_pred_out, "dense")]
    return out


def params_to_numpy_tree(model, params=None) -> dict:
    """The torch model's weights (or `params`, a name -> tensor dict such as
    the EMA shadow, in `model.named_parameters()` names) as a flax-named
    numpy tree {"params": {...}} with Dense kernels [in, out]."""
    values = dict(model.named_parameters()) if params is None else params
    names = {id(p): n for n, p in model.named_parameters()}

    def get(t):
        return values[names[id(t)]].detach().float().cpu().numpy()

    tree: dict = {"pos_emb": get(model.pos_emb)}
    for path, mod, kind in _named_modules(model):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if kind == "dense":
            node[path[-1]] = {"kernel": get(mod.weight).T, "bias": get(mod.bias)}
        else:
            node[path[-1]] = {"scale": get(mod.weight), "bias": get(mod.bias)}
    return {"params": tree}


def params_from_jax(flax_params: Mapping[str, Any], model) -> None:
    """Copy a flax DiffusionGPT tree (numpy leaves, with or without the
    top-level "params" key) into `model` in place."""
    p = flax_params.get("params", flax_params)
    with torch.no_grad():
        _copy(model.pos_emb, p["pos_emb"])
        for path, mod, kind in _named_modules(model):
            node = p
            for part in path:
                node = node[part]
            (_dense if kind == "dense" else _norm)(mod, node)
