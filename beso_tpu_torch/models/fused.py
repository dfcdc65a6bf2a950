"""The fused serving engines: the DiffusionGPT forward on the fused CUDA layers.

Torch port of `beso_tpu/models/fused.py`. Token assembly (embeddings,
positional embeddings, interleaving) and the output head stay plain PyTorch,
as in models/gpt.py; the transformer stack runs through the fused layer
kernels of ops/fused_layer.py, one form per engine:

- `make_fused_denoise_fn` (`:361-385`): the uncached engine. The whole token
  sequence `[sigma, goals, s_1, a_1, ...]` goes through one `fused_layer`
  launch (B4) per layer; it takes any sigma.
- `make_fused_cached_denoise_fn` (`:163-358`): prefix-KV cache + suffix
  layers. Per episode the [sigma, goal] prefix K/V are built once per grid
  sigma (models/cached.py, plain PyTorch); every call then runs only the 2T
  state/action tokens, through one `fused_layer_prefix` launch (B1) per
  layer, the last with the ln_f + linear-head epilogue (`token_lanes=True`,
  the default); through `fused_layers_prefix_group` (B2), `layer_group`
  layers per launch (`layer_group > 1`); or through `fused_layer_with_prefix`
  (B3) on the prefix row selected with `index_select` (`token_lanes=False`).

The sigma-grid row is chosen on the device (`grid_index`), so a call never
syncs the host. On CPU tensors the layer wrappers run their plain versions,
which is how the CPU tests hold these engines against the JAX ones.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from beso_tpu_torch.models.cached import (RawGPTParams, build_prefix,
                                          extract_gpt_params, grid_index)
from beso_tpu_torch.models.denoiser import precondition
from beso_tpu_torch.models.gpt import layer_norm
from beso_tpu_torch.ops.fused_layer import (FusedEpilogue, FusedLayerParams,
                                            check_fused_dtype, fused_layer,
                                            fused_layer_prefix,
                                            fused_layer_with_prefix,
                                            fused_layers_prefix_group,
                                            prepare_layer_params)


class FusedGPTParams(NamedTuple):
    """A DiffusionGPT's weights for the fused engines: the plain tensors
    (`raw`, for the embeddings, ln_f and the head) and every layer in the
    kernels' layout."""

    raw: RawGPTParams
    layers: Tuple[FusedLayerParams, ...]


def prepare_fused_gpt(model) -> FusedGPTParams:
    """Extract and lay out the model's weights once per engine
    (`beso_tpu/models/fused.py:50-90`), with the kernels' tiled copy of
    each layer's weights (`prepare_layer_params`). The engines run in the
    model's dtype, as the JAX ones do: bf16 or f32 on the card (the f32
    kernels compute to f32 accuracy). Raises TypeError for a model on the
    card that computes in another dtype (`check_fused_dtype`)."""
    sigma_embedding = getattr(model, "sigma_embedding", "Linear")
    if sigma_embedding != "Linear":
        raise NotImplementedError(
            "fused inference supports the shipped 'Linear' sigma embedding")
    check_fused_dtype(next(model.parameters()).device, model.dtype)
    rp = extract_gpt_params(model)
    return FusedGPTParams(raw=rp, layers=tuple(
        prepare_layer_params(lp, model.n_heads, model.dtype) for lp in rp.layers))


def _final_head(model, rp: RawGPTParams, x: torch.Tensor) -> torch.Tensor:
    """ln_f (f32 statistics, rounded to the compute dtype) and the head over
    the action slots of suffix tokens x [B, 2T, D]; f32 [B, T, A]."""
    x = layer_norm(x, rp.lnf_scale, rp.lnf_bias, model.dtype)
    return model.head(x[:, 1::2])


def fused_gpt_apply(model, fp: FusedGPTParams, states: torch.Tensor,
                    actions: torch.Tensor, goals: torch.Tensor,
                    sigma: torch.Tensor, *, uncond: bool = False) -> torch.Tensor:
    """DiffusionGPT forward (inference) with the B4 layers
    (`beso_tpu/models/fused.py:93-160`): same numerics as
    `DiffusionGPT.forward` with train=False."""
    G = model.eff_goal_len
    parts = [model.embed_sigma(sigma)]
    if model.goal_conditioned:
        if uncond:
            goals = torch.zeros_like(goals)
        parts.append(model.embed_goals(goals))
    parts.append(model.embed_suffix(states, actions))
    x = torch.cat([p.to(model.dtype) for p in parts], dim=1).contiguous()
    for lp in fp.layers:
        x = fused_layer(x, lp, n_heads=model.n_heads)
    return _final_head(model, fp.raw, x[:, G + 1:])


def make_fused_denoise_fn(den):
    """`denoise_fn(states, actions, goals, sigma, uncond=False)`, equal to
    `den(...)` but with the transformer stack on the B4 kernel
    (`beso_tpu/models/fused.py:361-385`). Any sigma, no per-episode state."""
    model = den.inner_model
    fp = prepare_fused_gpt(model)

    def inner(states, actions, goals, sigma, uncond: bool = False):
        return fused_gpt_apply(model, fp, states, actions, goals, sigma,
                               uncond=uncond)

    @torch.no_grad()
    def denoise_fn(states, actions, goals, sigma, **kwargs):
        return precondition(inner, states, actions, goals, sigma,
                            den.sigma_data, uncond=kwargs.get("uncond", False))

    return denoise_fn


def make_fused_cached_denoise_fn(den, goals_scaled: torch.Tensor, sigmas, *,
                                 token_lanes: bool = True,
                                 layer_group: int = 1,
                                 fp: FusedGPTParams | None = None):
    """Per-episode EDM-preconditioned `dn(states, actions, goals_ignored,
    sigma)` on the fused layer kernels. Same gating as the cached engine:
    grid-sigma samplers only; the call batch must equal the cache batch.
    `fp` is the model's `prepare_fused_gpt`, built here when not given.

    `token_lanes=True` runs B1 per layer, or B2 with `layer_group` layers
    per launch (groups need not divide the layer count; the epilogue runs
    with the last group). `token_lanes=False` runs B3 per layer, with ln_f
    and the head outside the kernel, and ignores `layer_group`. The names
    are the JAX engine's, whose two TPU layouts these were. The JAX engine's
    TPU-only options `attn_qbatch`, `env_block` and `interpret` are not
    ported: they choose among TPU layouts of the same computation.
    """
    if layer_group < 1:
        raise ValueError(f"layer_group must be >= 1, got {layer_group}")
    model = den.inner_model
    fp = prepare_fused_gpt(model) if fp is None else fp
    rp = fp.raw
    dtype = model.dtype
    H = model.n_heads
    D = model.embed_dim
    prefix = build_prefix(model, rp, goals_scaled, sigmas)
    S, L, B_pref, P = prefix.k.shape[:4]
    # [S, L, B, P, H, hd] -> per layer [S, B, P, D], the kernels' layout
    pk = [prefix.k[:, li].reshape(S, B_pref, P, D).to(dtype).contiguous()
          for li in range(L)]
    pv = [prefix.v[:, li].reshape(S, B_pref, P, D).to(dtype).contiguous()
          for li in range(L)]
    layers = fp.layers
    epi = None
    if token_lanes and model.linear_output:
        w, b = rp.head
        epi = FusedEpilogue(rp.lnf_scale.float().contiguous(),
                            rp.lnf_bias.float().contiguous(),
                            w.float().contiguous(), b.float().contiguous())
    groups = [(lo, min(lo + layer_group, L)) for lo in range(0, L, layer_group)]

    def suffix_layers(x, idx):
        """The suffix tokens through every layer; returns (x, pred or None)."""
        if not token_lanes:
            for li, lp in enumerate(layers):
                x = fused_layer_with_prefix(x, pk[li].index_select(0, idx)[0],
                                            pv[li].index_select(0, idx)[0], lp,
                                            n_heads=H)
            return x, None
        idx = idx.to(torch.int32)
        for lo, hi in groups:
            e = epi if hi == L else None
            if layer_group > 1:
                out = fused_layers_prefix_group(x, pk[lo:hi], pv[lo:hi], idx,
                                                layers[lo:hi], n_heads=H, epilogue=e)
            else:
                out = fused_layer_prefix(x, pk[lo], pv[lo], idx, layers[lo],
                                         n_heads=H, epilogue=e)
            x = out if e is None else out[0]
        return x, (None if epi is None else out[1])

    def inner(states, actions, goals, sigma):
        B = states.shape[0]
        if B != B_pref:
            raise ValueError(f"prefix cache batch {B_pref} != call batch {B}")
        x = model.embed_suffix(states, actions).contiguous()
        x, pred = suffix_layers(x, grid_index(sigma, prefix.sigmas))
        if pred is not None:
            # pred [B, 2T, M] f32: action slots are the odd suffix tokens
            return pred[:, 1::2]
        return _final_head(model, rp, x)

    @torch.no_grad()
    def dn(states, actions, goals, sigma, **kwargs):
        return precondition(inner, states, actions, goals, sigma,
                            den.sigma_data)

    return dn
