"""Prefix-KV cached inference (torch port of `beso_tpu/models/cached.py`).

In the token sequence `[sigma, g_1..g_G, s_1, a_1, ..., s_T, a_T]` the prefix
`[sigma, g*]` attends only to itself, so its per-layer K/V depend only on
(sigma, goal). During a rollout the goal is fixed per episode and the
sampler visits a fixed sigma grid, so the prefix K/V for every (sigma_k,
goal) pair are built once per episode; each denoiser call then runs only
the 2T state/action tokens. Valid for samplers that evaluate the model on
grid sigmas only (the rollout factory gates this).

This is the plain engine: every layer runs as PyTorch tensor code. The
`fused_cached` engine (models/fused.py) runs the same suffix layers through
the CUDA kernel and is held against this one.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch

from beso_tpu_torch.models.denoiser import precondition
from beso_tpu_torch.models.gpt import block_forward, dense, layer_norm

# samplers whose model evaluations stay on the sigma grid
CACHED_SAFE_SAMPLERS = ("ddim", "euler", "dpmpp_2m", "lms")


class RawGPTParams(NamedTuple):
    """DiffusionGPT weights as plain tensors; Linear weights are [out, in]."""

    sig_w: torch.Tensor
    sig_b: torch.Tensor
    tok_w: torch.Tensor
    tok_b: torch.Tensor
    goal_w: Optional[torch.Tensor]
    goal_b: Optional[torch.Tensor]
    act_w: torch.Tensor
    act_b: torch.Tensor
    pos_emb: torch.Tensor
    layers: Tuple[dict, ...]
    lnf_scale: torch.Tensor
    lnf_bias: torch.Tensor
    head: Tuple[torch.Tensor, ...]


class PrefixKV(NamedTuple):
    k: torch.Tensor        # [S, L, B, P, H, hd]
    v: torch.Tensor        # [S, L, B, P, H, hd]
    sigmas: torch.Tensor   # [S] f32, the grid the cache was built for


def extract_gpt_params(model) -> RawGPTParams:
    """The model's weights as plain tensors. Raises NotImplementedError for a
    sigma embedding other than the shipped "Linear" one, whose token the
    engines build with one product (`beso_tpu/models/cached.py:61`)."""
    if model.sigma_embedding != "Linear":
        raise NotImplementedError(
            "cached inference supports the shipped 'Linear' sigma embedding")

    def lin(m):
        return m.weight.detach(), m.bias.detach()

    layers = [{k: w.detach() for k, w in blk.weights().items()}
              for blk in model.blocks]
    head = (lin(model.action_pred) if model.linear_output
            else lin(model.action_pred_fc) + lin(model.action_pred_out))
    goal_w, goal_b = lin(model.goal_emb) if model.has_goal_emb else (None, None)
    return RawGPTParams(*lin(model.sigma_emb), *lin(model.tok_emb),
                        goal_w, goal_b, *lin(model.action_emb),
                        pos_emb=model.pos_emb.detach(), layers=tuple(layers),
                        lnf_scale=model.ln_f.weight.detach(),
                        lnf_bias=model.ln_f.bias.detach(), head=head)


def build_prefix(model, rp: RawGPTParams, goals_scaled: torch.Tensor,
                 sigmas) -> PrefixKV:
    """Run the prefix tokens [sigma, g_1..g_G] through all layers for every
    grid sigma and keep the per-layer K/V. goals_scaled: [B, G, goal_dim] as
    fed to the model (already scaled or zeroed); sigmas: [S]."""
    B = goals_scaled.shape[0]
    D = model.embed_dim
    dtype = model.dtype
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32,
                             device=goals_scaled.device)
    S = sigmas.shape[0]

    sig = (torch.log(sigmas) / 4.0).reshape(S, 1, 1, 1)
    emb_t = dense(sig, rp.sig_w, rp.sig_b, dtype).expand(S, B, 1, D)
    if model.goal_conditioned:
        w, b = ((rp.goal_w, rp.goal_b) if rp.goal_w is not None
                else (rp.tok_w, rp.tok_b))
        G = model.eff_goal_len
        goal_x = dense(goals_scaled, w, b, dtype) + rp.pos_emb[:, :G]
        seq = torch.cat([emb_t.float(), goal_x.expand(S, B, G, D)], dim=2)
    else:
        seq = emb_t
    P = seq.shape[2]
    x = seq.reshape(S * B, P, D).to(dtype)

    mask = torch.ones(P, P, dtype=torch.bool, device=x.device).tril()
    ks, vs = [], []
    for lp in rp.layers:
        x, (k, v) = block_forward(lp, x, model.n_heads, dtype, mask,
                                  approximate_gelu=model.approximate_gelu)
        ks.append(k)
        vs.append(v)
    H = model.n_heads
    shape = (model.n_layers, S, B, P, H, D // H)
    return PrefixKV(k=torch.stack(ks).reshape(shape).transpose(0, 1),
                    v=torch.stack(vs).reshape(shape).transpose(0, 1),
                    sigmas=sigmas)


def grid_index(sigma: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Index of the grid sigma nearest (in log) to sigma[0], as a 1-element
    int64 tensor on the device: selecting a cache row never syncs the host."""
    tiny = 1e-12
    d = torch.abs(torch.log(torch.clamp(sigma[:1], min=tiny))
                  - torch.log(torch.clamp(grid, min=tiny)))
    return torch.argmin(d).reshape(1)


def suffix_forward(model, rp: RawGPTParams, prefix: PrefixKV,
                   states: torch.Tensor, actions: torch.Tensor,
                   sigma: torch.Tensor) -> torch.Tensor:
    """Inner-model forward over the 2T state/action tokens with cached
    prefix K/V. sigma: [B], all entries equal to one grid value."""
    B, T, _ = states.shape
    P = 1 + model.eff_goal_len
    D = model.embed_dim
    dtype = model.dtype
    idx = grid_index(sigma, prefix.sigmas)

    x = model.embed_suffix(states, actions)
    # suffix query t (sequence position P+t) sees all P prefix keys plus
    # suffix keys j <= t
    causal = torch.ones(2 * T, 2 * T, dtype=torch.bool, device=x.device).tril()
    mask = torch.cat([torch.ones(2 * T, P, dtype=torch.bool, device=x.device),
                      causal], dim=1)
    k_rows = prefix.k.index_select(0, idx)[0]
    v_rows = prefix.v.index_select(0, idx)[0]
    for li, lp in enumerate(rp.layers):
        x, _ = block_forward(lp, x, model.n_heads, dtype, mask,
                             (k_rows[li], v_rows[li]),
                             approximate_gelu=model.approximate_gelu)

    x = layer_norm(x, rp.lnf_scale, rp.lnf_bias, dtype)
    x = x.reshape(B, T, 2, D)[:, :, 1]                       # action slots
    return model.head(x)


def make_cached_denoise_fn(den, goals_scaled: torch.Tensor, sigmas):
    """Per-episode denoise fn: EDM-preconditioned suffix forward against a
    prefix cache built once for (goals_scaled, sigma grid).

    The returned `dn(states, actions, goals, sigma)` ignores its goals
    argument (the cache encodes them); its batch must match goals_scaled.
    """
    model = den.inner_model
    rp = extract_gpt_params(model)
    prefix = build_prefix(model, rp, goals_scaled, sigmas)

    def inner(states, actions, goals, sigma):
        return suffix_forward(model, rp, prefix, states, actions, sigma)

    @torch.no_grad()
    def dn(states, actions, goals, sigma, **kwargs):
        return precondition(inner, states, actions, goals, sigma,
                            den.sigma_data)

    return dn


def make_rollout_denoise_factory(den, scaler, cfg, engine: str = "cached"):
    """Per-episode denoise-fn factory for `rollout_*.denoise_factory`.

    Returns `factory(goals_raw) -> dn`, which builds the prefix cache once
    per rollout for the policy's sigma grid and the episode goals, stacked
    as `cfg_denoise_fn` stacks its batch ([goals, zeros] for CFG), so the
    cached batch lines up with the wrapped calls. `engine` is "cached" (this
    module, plain PyTorch) or "fused_cached" (models/fused.py, the CUDA
    layer kernels). For "fused_cached", the environment variable
    `BESO_LAYER_GROUP=N`, read each time the factory is called (default 1),
    runs N layers per kernel launch (`layer_group`), as
    `beso_tpu/models/cached.py:284-293` does. The fused engine's weights are
    laid out once here (`prepare_fused_gpt`) and shared by every episode, so
    the model's weights must not change while the factory is in use.

    Gating (raises ValueError otherwise): the sampler must stay on the sigma
    grid (CACHED_SAFE_SAMPLERS), s_churn == 0, single action sample. For
    "fused_cached" a model on the card must compute in bf16 or f32 (raises
    TypeError here, before any episode; `check_fused_dtype`).
    """
    from beso_tpu_torch.agents.policy import scale_goal_for_model
    from beso_tpu_torch.core.schedules import get_noise_schedule

    if cfg.sampler_type not in CACHED_SAFE_SAMPLERS:
        raise ValueError(
            f"cached inference engine requires a grid-sigma sampler "
            f"{CACHED_SAFE_SAMPLERS}, got {cfg.sampler_type!r}")
    if cfg.s_churn:
        raise ValueError("cached inference engine requires s_churn == 0")
    if cfg.n_action_samples > 1:
        raise ValueError("cached inference engine requires a single action "
                         "sample per step")
    if engine not in ("cached", "fused_cached"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "fused_cached":
        from beso_tpu_torch.models.fused import (make_fused_cached_denoise_fn,
                                                 prepare_fused_gpt)

        fp = prepare_fused_gpt(den.inner_model)

    sigmas = get_noise_schedule(cfg.num_sampling_steps, cfg.sigma_min,
                                cfg.sigma_max, cfg.rho,
                                cfg.noise_scheduler)[:-1]  # drop appended 0

    def factory(goals_raw):
        g_s = scale_goal_for_model(scaler, goals_raw)
        if cfg.cond_lambda == 0.0:
            g_model = torch.zeros_like(g_s)
        elif cfg.cond_lambda != 1.0:
            # cfg_denoise_fn stacks [cond, uncond] along batch
            g_model = torch.cat([g_s, torch.zeros_like(g_s)])
        else:
            g_model = g_s
        if engine == "fused_cached":
            return make_fused_cached_denoise_fn(
                den, g_model, sigmas, fp=fp,
                layer_group=int(os.environ.get("BESO_LAYER_GROUP", "1")))
        return make_cached_denoise_fn(den, g_model, sigmas)

    return factory
