"""Carry model weights between the flax tree and the torch module.

No JAX counterpart: this is the hand-off that lets both packages compute
with the same weights, in both directions: `params_from_jax` loads a flax
tree into the torch model, `params_to_numpy_tree` gives the torch weights
back under the flax names (to compare trained weights leaf by leaf). Trees
are numpy arrays (for example `jax.tree.map(np.asarray, params)`), so this
module imports no JAX.

DiffusionGPT names map one to one: `block_{i}/{ln1,attn/qkv,attn/proj,ln2,fc,fc_proj}`,
`ln_f`, `sigma_emb`, `tok_emb`, `goal_emb`, `action_emb`, `pos_emb`, and
`action_pred` or `action_pred_fc`/`action_pred_out`. A sigma embedding of
another kind than "Linear" is the flax submodule `{class name}_0`
(models/embeddings.py), its Denses `Dense_0`, `Dense_1`, FourierFeatures'
`weight`, and GaussianFourier's fixed projection the "constants" leaf
`GaussianFourierProjection_0/W`. The vision models: ConvImageEncoder's
`Conv_{i}` and `Dense_0`; a vision policy's `encoder` and
`VisionDiffusionGPT_0` (a DiffusionGPT tree); StateRegressionNet's
`encoder`, `head_hidden` and `head_out`. Flax Dense kernels are [in, out]
and torch Linear weights [out, in]; flax Conv kernels are [kh, kw, in, out]
and torch Conv2d weights [out, in, kh, kw].
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


def _conv(conv: nn.Conv2d, tree: Mapping[str, Any]) -> None:
    _copy(conv.weight, np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    _copy(conv.bias, tree["bias"])


def embedding_entries(emb, prefix=()):
    """(flax path, torch module or tensor, kind) of a `models/embeddings.py`
    module under the flax path `prefix`; kind "const" lives in the tree's
    "constants" collection, "param" is a bare parameter."""
    from beso_tpu_torch.models import embeddings as E

    if isinstance(emb, E.FourierFeatures):
        return [(prefix + ("weight",), emb.weight, "param")]
    if isinstance(emb, E.LinearTimeEmbedding):
        return [(prefix + ("Dense_0",), emb.fc, "dense")]
    out = [(prefix + ("Dense_0",), emb.fc1, "dense"), (prefix + ("Dense_1",), emb.fc2, "dense")]
    if isinstance(emb, E.GaussianFourierEmbedding):
        out.append((prefix + ("GaussianFourierProjection_0", "W"), emb.proj.W, "const"))
    return out


def mlp_entries(net):
    """(flax path, torch Linear, "dense") of a `models/mlps.py` network under
    the flax module names of `beso_tpu/models/mlps.py` (Dense_i in order of
    creation, TwoLayerPreActivationResNetLinear_j)."""
    from beso_tpu_torch.models import mlps

    if isinstance(net, mlps.MLPNetwork):
        lins = [*net.hidden, net.out]
        return [((f"Dense_{i}",), lin, "dense") for i, lin in enumerate(lins)]
    if isinstance(net, mlps.TwoLayerPreActivationResNetLinear):
        return [(("Dense_0",), net.l1, "dense"), (("Dense_1",), net.l2, "dense")]
    out = [(("Dense_0",), net.inp, "dense"), (("Dense_1",), net.out, "dense")]
    for j, blk in enumerate(net.blocks):
        out += [((f"TwoLayerPreActivationResNetLinear_{j}",) + path, lin, kind)
                for path, lin, kind in mlp_entries(blk)]
    return out


def _named_modules(model):
    """(flax path, torch module or tensor, kind) for every parameterised layer."""
    if model.sigma_embedding == "Linear":
        out = [(("sigma_emb",), model.sigma_emb, "dense")]
    else:
        out = embedding_entries(model.sigma_emb, (f"{type(model.sigma_emb).__name__}_0",))
    out += [(("tok_emb",), model.tok_emb, "dense"),
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


def _prefixed(prefix: str, entries):
    return [((prefix,) + path, mod, kind) for path, mod, kind in entries]


def model_entries(model):
    """(flax path, torch module or tensor, kind) of every parameterised
    layer of a DiffusionGPT, a ConvImageEncoder, either vision policy or a
    StateRegressionNet, under the flax module names."""
    from beso_tpu_torch.models import pretrain, vision_policy as vp

    if isinstance(model, vp.ConvImageEncoder):
        return ([((f"Conv_{i}",), conv, "conv") for i, conv in enumerate(model.convs)]
                + [(("Dense_0",), model.dense, "dense")])
    if isinstance(model, (vp.VisionPolicyGPT, vp.KitchenVisionPolicyGPT)):
        return (_prefixed("encoder", model_entries(model.encoder))
                + _prefixed("VisionDiffusionGPT_0", model_entries(model.inner)))
    if isinstance(model, pretrain.StateRegressionNet):
        return (_prefixed("encoder", model_entries(model.encoder))
                + [(("head_hidden",), model.head_hidden, "dense"),
                   (("head_out",), model.head_out, "dense")])
    return [(("pos_emb",), model.pos_emb, "param"), *_named_modules(model)]


def params_to_numpy_tree(model, params=None) -> dict:
    """The torch model's weights (or `params`, a name -> tensor dict such as
    the EMA shadow, in `model.named_parameters()` names; buffers from the
    model) as a flax-named numpy tree {"params": {...}} with Dense kernels
    [in, out], and {"constants": {...}} for GaussianFourier's projection."""
    values = {**dict(model.named_buffers()), **dict(model.named_parameters()),
              **(params or {})}
    names = {id(p): n for n, p in [*model.named_parameters(), *model.named_buffers()]}

    def get(t):
        return values[names[id(t)]].detach().float().cpu().numpy()

    trees: dict = {}
    for path, mod, kind in model_entries(model):
        node = trees.setdefault("constants" if kind == "const" else "params", {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if kind == "dense":
            node[path[-1]] = {"kernel": get(mod.weight).T, "bias": get(mod.bias)}
        elif kind == "conv":
            node[path[-1]] = {"kernel": get(mod.weight).transpose(2, 3, 1, 0),
                              "bias": get(mod.bias)}
        elif kind == "norm":
            node[path[-1]] = {"scale": get(mod.weight), "bias": get(mod.bias)}
        else:
            node[path[-1]] = get(mod)
    return trees


def entries_from_jax(flax_params: Mapping[str, Any], entries) -> None:
    """Copy the leaves of a flax tree (numpy leaves; "params" and
    "constants" collections, or a bare params tree) into the torch modules
    or tensors of (flax path, target, kind) entries, in place."""
    trees = {"params": flax_params.get("params", flax_params),
             "constants": flax_params.get("constants", {})}
    with torch.no_grad():
        for path, mod, kind in entries:
            node = trees["constants" if kind == "const" else "params"]
            for part in path:
                node = node[part]
            if kind == "dense":
                _dense(mod, node)
            elif kind == "conv":
                _conv(mod, node)
            elif kind == "norm":
                _norm(mod, node)
            else:
                _copy(mod, node)


def params_from_jax(flax_params: Mapping[str, Any], model) -> None:
    """Copy a flax tree (numpy leaves, the variables {"params": ...,
    "constants": ...} or the bare params tree) of a model of
    `model_entries` into `model` in place."""
    entries_from_jax(flax_params, model_entries(model))
