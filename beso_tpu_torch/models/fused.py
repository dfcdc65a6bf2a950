"""`fused_cached` engine: prefix-KV cache + the fused CUDA suffix layers.

Torch port of `make_fused_cached_denoise_fn` (`beso_tpu/models/fused.py:163-358`).
Per episode the [sigma, goal] prefix K/V are built once per grid sigma
(models/cached.py, plain PyTorch); every denoiser call then embeds the 2T
state/action tokens and runs them through one `fused_layer_prefix` launch
per layer (ops/fused_layer.py), the last with the ln_f + linear-head
epilogue when the model has a linear head.

The sigma-grid row is chosen on the device (`grid_index`) and read by the
kernel, so a call never syncs the host. On CPU tensors the layer wrapper
runs its plain version, which is how the CPU tests hold this engine against
the JAX one.
"""

from __future__ import annotations

import torch

from beso_tpu_torch.models.cached import (build_prefix, extract_gpt_params,
                                          grid_index)
from beso_tpu_torch.models.denoiser import precondition
from beso_tpu_torch.models.gpt import layer_norm
from beso_tpu_torch.ops.fused_layer import (FusedEpilogue, fused_layer_prefix,
                                            prepare_layer_params)


def make_fused_cached_denoise_fn(den, goals_scaled: torch.Tensor, sigmas):
    """Per-episode EDM-preconditioned `dn(states, actions, goals_ignored,
    sigma)` on the fused layer kernel. Same gating as the cached engine:
    grid-sigma samplers only; the call batch must equal the cache batch."""
    model = den.inner_model
    rp = extract_gpt_params(model)
    dtype = model.dtype
    H = model.n_heads
    D = model.embed_dim
    prefix = build_prefix(model, rp, goals_scaled, sigmas)
    S, L, B_pref, P = prefix.k.shape[:4]
    # [S, L, B, P, H, hd] -> per layer [S, B, P, D], the kernel's layout
    pk = [prefix.k[:, li].reshape(S, B_pref, P, D).to(dtype).contiguous()
          for li in range(L)]
    pv = [prefix.v[:, li].reshape(S, B_pref, P, D).to(dtype).contiguous()
          for li in range(L)]
    layers = [prepare_layer_params(lp, H, dtype) for lp in rp.layers]
    epi = None
    if model.linear_output:
        w, b = rp.head
        epi = FusedEpilogue(rp.lnf_scale.float().contiguous(),
                            rp.lnf_bias.float().contiguous(),
                            w.float().contiguous(), b.float().contiguous())

    def inner(states, actions, goals, sigma):
        B = states.shape[0]
        if B != B_pref:
            raise ValueError(f"prefix cache batch {B_pref} != call batch {B}")
        idx = grid_index(sigma, prefix.sigmas).to(torch.int32)
        x = model.embed_suffix(states, actions).contiguous()
        for li, lp in enumerate(layers):
            last = li == L - 1
            out = fused_layer_prefix(x, pk[li], pv[li], idx, lp, n_heads=H,
                                     epilogue=epi if last else None)
            x = out[0] if (last and epi is not None) else out
        if epi is not None:
            # pred [B, 2T, M] f32: action slots are the odd suffix tokens
            return out[1][:, 1::2]
        x = layer_norm(x, rp.lnf_scale, rp.lnf_bias, dtype)
        return model.head(x[:, 1::2])

    @torch.no_grad()
    def dn(states, actions, goals, sigma, **kwargs):
        return precondition(inner, states, actions, goals, sigma,
                            den.sigma_data)

    return dn
