"""Checkpoints: full train-state save/restore with `torch.save`, and the
converter between the reference's `.pth` key space and the port's model
(torch port of `beso_tpu/train/checkpoint.py`).

The reference stores bare model weights only (`beso_agent.py:466-476`), so it
cannot resume mid-training; here the full state round-trips: parameters,
optimizer moments and step counts, the LR scheduler, the EMA shadow and its
update counter, and the train step.

The reference's `model_state_dict.pth` names its GCDenoiser's modules
(`score_gpts.py:15-211`): `inner_model.blocks.N.attn.{query,key,value,proj}`,
`inner_model.blocks.N.{ln1,ln2,mlp.0,mlp.2}`, `inner_model.{tok_emb,
sigma_emb,action_emb,pos_emb,ln_f}` and `inner_model.action_pred` (or
`action_pred.0`/`.2` for the two-layer head). The port's model fuses
query, key and value into one `attn.qkv` Linear, rows in (q, k, v) order.
Unlike the JAX package, whose converter and export drop it, the port also
carries `inner_model.goal_emb` (a model whose goal_dim differs from its
state_dim embeds its goals with it), and refuses at load time a checkpoint
that lacks it for such a model. The reference trains with torch's erf GELU:
build the model with `approximate_gelu=False` to compute as it did.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
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


# ---------------------------------------------------------------------------
# the reference's .pth key space <-> the port's DiffusionGPT
# ---------------------------------------------------------------------------

def _tensor(v) -> torch.Tensor:
    """A state-dict value (tensor or numpy array) as an f32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float()
    return torch.as_tensor(np.asarray(v, np.float32))


def convert_torch_diffusion_gpt(state_dict: Mapping[str, Any], n_layers: int) -> dict:
    """Map a reference `model_state_dict.pth` (GCDenoiser module names, with
    or without the `inner_model.` prefix) onto the port's DiffusionGPT
    state-dict names, f32 CPU tensors (`beso_tpu/train/checkpoint.py:44-96`).
    `goal_emb` is carried where the dict has it."""
    p = "inner_model." if any(k.startswith("inner_model.") for k in state_dict) else ""

    def w(key):
        return _tensor(state_dict[key])

    out = {}

    def lin(dst, src):
        out[dst + ".weight"] = w(src + ".weight")
        out[dst + ".bias"] = w(src + ".bias")

    for name in ("tok_emb", "sigma_emb", "action_emb"):
        lin(name, p + name)
    if p + "goal_emb.weight" in state_dict:
        lin("goal_emb", p + "goal_emb")
    out["pos_emb"] = w(p + "pos_emb")[0][None]   # keep [1, seq, D]
    lin("ln_f", p + "ln_f")
    for i in range(n_layers):
        src, dst = f"{p}blocks.{i}.", f"blocks.{i}."
        for part in ("weight", "bias"):
            out[f"{dst}attn.qkv.{part}"] = torch.cat(
                [w(f"{src}attn.{nm}.{part}") for nm in ("query", "key", "value")])
        lin(dst + "attn.proj", src + "attn.proj")
        lin(dst + "ln1", src + "ln1")
        lin(dst + "ln2", src + "ln2")
        lin(dst + "fc", src + "mlp.0")
        lin(dst + "fc_proj", src + "mlp.2")
    if p + "action_pred.weight" in state_dict:
        lin("action_pred", p + "action_pred")
    else:   # two-layer SiLU head (score_gpts.py:186-190)
        lin("action_pred_fc", p + "action_pred.0")
        lin("action_pred_out", p + "action_pred.2")
    return out


def load_torch_checkpoint(weights_path, n_layers: int,
                          filename: str = "model_state_dict.pth") -> dict:
    """Read a reference .pth checkpoint (beso_agent.py:458-464) as the port's
    state-dict names. The file is a pickle, read as the JAX package reads it
    (`weights_only=False`, so numpy values load too): load only files you
    trust."""
    sd = torch.load(os.path.join(weights_path, filename), map_location="cpu",
                    weights_only=False)
    return convert_torch_diffusion_gpt(sd, n_layers)


def export_torch_state_dict(params: Mapping[str, torch.Tensor], n_layers: int) -> dict:
    """Inverse conversion: the port's DiffusionGPT state dict (or the EMA
    shadow, by parameter name) -> reference-style keys, f32 CPU tensors
    (`beso_tpu/train/checkpoint.py:111-145`), `goal_emb` included where the
    model has it. Raises ValueError for a sigma embedding other than
    "Linear", which the reference key space holds differently."""
    if "sigma_emb.weight" not in params:
        raise ValueError("export_torch_state_dict takes a model with the 'Linear' sigma "
                         "embedding")
    flat = {}

    def put(dst, src):
        flat[dst + ".weight"] = _tensor(params[src + ".weight"]).clone()
        flat[dst + ".bias"] = _tensor(params[src + ".bias"]).clone()

    for name in ("tok_emb", "sigma_emb", "action_emb", "ln_f"):
        put("inner_model." + name, name)
    if "goal_emb.weight" in params:
        put("inner_model.goal_emb", "goal_emb")
    flat["inner_model.pos_emb"] = _tensor(params["pos_emb"]).clone()
    for i in range(n_layers):
        src, dst = f"blocks.{i}.", f"inner_model.blocks.{i}."
        for part in ("weight", "bias"):
            qkv = _tensor(params[f"{src}attn.qkv.{part}"])
            for nm, t in zip(("query", "key", "value"), qkv.chunk(3)):
                flat[f"{dst}attn.{nm}.{part}"] = t.clone()
        put(dst + "attn.proj", src + "attn.proj")
        put(dst + "mlp.0", src + "fc")
        put(dst + "mlp.2", src + "fc_proj")
        put(dst + "ln1", src + "ln1")
        put(dst + "ln2", src + "ln2")
    if "action_pred.weight" in params:
        put("inner_model.action_pred", "action_pred")
    else:
        put("inner_model.action_pred.0", "action_pred_fc")
        put("inner_model.action_pred.2", "action_pred_out")
    return flat


def load_reference_weights(model, weights: Mapping[str, torch.Tensor]) -> None:
    """Copy `convert_torch_diffusion_gpt`'s output into `model` in place.
    Raises ValueError where the checkpoint does not fit the model's
    embeddings: a non-"Linear" sigma embedding, or a goal embedding the
    checkpoint lacks (goal_dim != state_dim) or holds for a model without
    one; any other missing or extra key raises as `load_state_dict` does."""
    if model.sigma_embedding != "Linear":
        raise ValueError(f"reference checkpoints hold the 'Linear' sigma embedding; the "
                         f"model has {model.sigma_embedding!r}")
    has = "goal_emb.weight" in weights
    if model.has_goal_emb and not has:
        raise ValueError(
            f"the checkpoint has no inner_model.goal_emb, and the model embeds its goals "
            f"with one (goal_dim {model.goal_dim} != state_dim {model.state_dim})")
    if has and not model.has_goal_emb:
        raise ValueError("the checkpoint holds inner_model.goal_emb, and the model shares "
                         "tok_emb for its goals (goal_dim None or equal to state_dim)")
    with torch.no_grad():
        model.load_state_dict(dict(weights), strict=True)
