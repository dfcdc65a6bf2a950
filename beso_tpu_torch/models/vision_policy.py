"""Image-conditioned diffusion policy: camera render -> conv encoder -> GPT
(torch port of `beso_tpu/models/vision_policy.py`).

`VisionDiffusionGPT` (score_gpts.py:377-642) over image embeddings, with
the vision pooling modules (vision_modules.py:7-117). Observations stay
low-dimensional in the data and are rendered inside every train and
denoise call by the fixed-camera renderers (`envs/block_push/camera.py`,
`envs/kitchen/camera.py`), under `torch.no_grad()`, since the frames are a
function of the data only; a CoordConv + strided-conv + SpatialSoftArgmax
encoder is trained end to end through the diffusion loss.

Both policies take the inner-model signature of `DiffusionGPT.forward`
(states, actions, goals, sigma, uncond, train, generator), so
`GCDenoiser`, `Trainer`, EMA, `policy_predict` and the rollouts take them
unchanged; they run the plain forward (the fused engines serve
`DiffusionGPT` only).

Numerics follow the JAX modules: flax's "SAME" padding (for a stride-2
3x3 conv on an even side: no row before, one after; `conv2d_same`), tanh
GELU, the keypoint softmax in f32, and with `dtype=bfloat16` the conv and
dense outputs rounded to bf16 (the f32 bias added before the one
rounding, as the port's `dense` does).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from beso_tpu_torch.envs.block_push.camera import render_obs_masks, render_obs_rgb
from beso_tpu_torch.envs.kitchen.camera import render_kitchen_obs_rgb
from beso_tpu_torch.models.gpt import VisionDiffusionGPT, _lecun_linear, dense, gelu
from beso_tpu_torch.models.vision import coord_grid, spatial_soft_argmax_nchw

_BLOCK_PUSH_BG = (0.92, 0.92, 0.90)
_KITCHEN_BG = (0.93, 0.93, 0.91)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) of flax / XLA "SAME" padding along one side: the
    output has ceil(size / stride) positions, the odd pad goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv(padding="SAME")` on an NCHW tensor: `dtype` operands,
    the f32 bias, rounded to `dtype`."""
    kh, kw = weight.shape[2:]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    x = F.pad(x.to(dtype), (left, right, top, bottom))
    y = F.conv2d(x, weight.to(dtype), stride=stride)
    return (y.float() + bias.float()[:, None, None]).to(dtype)


class ConvImageEncoder(nn.Module):
    """CoordConv -> strided 3x3 convs with GELU -> SpatialSoftArgmax (f32)
    -> Dense: images [N, H, W, in_channels] -> embeddings [N, embed_size]
    in `dtype`."""

    def __init__(self, in_channels: int, embed_size: int = 32,
                 features: Sequence[int] = (16, 32), dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList()
        c_in = in_channels + 2     # + the CoordConv channels
        for f in features:
            conv = nn.Conv2d(c_in, f, 3, stride=2, device=device)
            # flax Conv default: lecun-normal (truncated at 2 std), zero bias
            std = math.sqrt(1.0 / (9 * c_in)) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                conv.bias.zero_()
            self.convs.append(conv)
            c_in = f
        self.dense = _lecun_linear(2 * c_in, embed_size, generator, device)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        N, H, W, _ = imgs.shape
        xx, yy = coord_grid(H, W, imgs.device)
        x = torch.cat([imgs.to(self.dtype).permute(0, 3, 1, 2),
                       torch.stack([xx, yy]).to(self.dtype).expand(N, 2, H, W)], dim=1)
        for conv in self.convs:
            x = gelu(conv2d_same(x, conv.weight, conv.bias, 2, self.dtype))
        kp = spatial_soft_argmax_nchw(x.float())                 # [N, C, 2]
        return dense(kp.reshape(N, -1), self.dense.weight, self.dense.bias, self.dtype)


def _encode(enc: ConvImageEncoder, imgs: torch.Tensor, freeze: bool) -> torch.Tensor:
    """enc(imgs); with `freeze` no gradient reaches the encoder
    (`jax.lax.stop_gradient` on its features)."""
    with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze):
        return enc(imgs)


class VisionPolicyGPT(nn.Module):
    """Inner model over raw 16-dim block-push observations: renders and
    encodes the images internally, then runs VisionDiffusionGPT over
    [image embedding ++ normalized effector xy] state tokens and
    image-embedding goal tokens.

    `semantic` feeds the camera's per-object mask channels instead of RGB;
    `goal_stack` concatenates the goal image onto every state image (and
    goal tokens see the goal image twice); `freeze_encoder` stops the
    gradients into the encoder (for grafted pretrained weights,
    `models/pretrain.py`)."""

    def __init__(self, action_dim: int = 2, embed_dim: int = 240, n_layers: int = 4,
                 n_heads: int = 12, goal_seq_len: int = 1, obs_seq_len: int = 5,
                 embed_size: int = 48, img_hw: Tuple[int, int] = (128, 128),
                 enc_features: Sequence[int] = (24, 48, 64), semantic: bool = False,
                 goal_stack: bool = False, attn_pdrop: float = 0.05,
                 resid_pdrop: float = 0.05, cond_mask_prob: float = 0.0,
                 freeze_encoder: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_size, self.img_hw = embed_size, tuple(img_hw)
        self.enc_features = tuple(enc_features)
        self.semantic, self.goal_stack = semantic, goal_stack
        self.freeze_encoder, self.dtype = freeze_encoder, dtype
        channels = (5 if semantic else 3) * (2 if goal_stack else 1)
        self.encoder = ConvImageEncoder(channels, embed_size, enc_features, dtype,
                                        generator, device)
        self.inner = VisionDiffusionGPT(
            embed_size + 2, action_dim, embed_dim, n_layers, n_heads, goal_seq_len,
            obs_seq_len, goal_dim=embed_size, attn_pdrop=attn_pdrop,
            resid_pdrop=resid_pdrop, cond_mask_prob=cond_mask_prob, dtype=dtype,
            generator=generator, device=device)

    @torch.no_grad()
    def render(self, obs16: torch.Tensor) -> torch.Tensor:
        """Encoder input [N, h, w, C] of observations [N, 16]: the mask
        channels, or the background-subtracted RGB (the sparse objects
        carry the signal)."""
        h, w = self.img_hw
        if self.semantic:
            return render_obs_masks(obs16.float(), h, w)
        bg = torch.tensor(_BLOCK_PUSH_BG, device=obs16.device)
        return render_obs_rgb(obs16.float(), h, w) - bg

    def forward(self, states, actions, goals, sigma, *, uncond: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None):
        B, T, _ = states.shape
        G = goals.shape[1]
        E = self.embed_size
        s_img = self.render(states.reshape(B * T, 16))
        # goal picture: only the block configuration, everything else pushed
        # out of frame (a zeroed effector would paint a phantom at the origin)
        goals_r = torch.cat([goals[..., :6], torch.full_like(goals[..., 6:], 10.0)], -1)
        if self.goal_stack:
            g_img0 = self.render(goals_r[:, 0])                   # [B, h, w, C]
            s_img = torch.cat([s_img, g_img0.repeat_interleave(T, dim=0)], dim=-1)
        s_feat = _encode(self.encoder, s_img, self.freeze_encoder).reshape(B, T, E)
        # proprioception: the hand, even where it is occluded in the image
        proprio = (states[..., 6:8] - torch.tensor([0.425, 0.0], device=states.device)) / 0.3
        s_tok = torch.cat([s_feat, proprio.to(s_feat.dtype)], dim=-1)
        g_img = self.render(goals_r.reshape(B * G, 16))
        if self.goal_stack:
            g_img = torch.cat([g_img, g_img], dim=-1)
        g_feat = _encode(self.encoder, g_img, self.freeze_encoder).reshape(B, G, E)
        return self.inner(s_tok, actions, g_feat, sigma, uncond=uncond, train=train,
                          generator=generator)


class KitchenVisionPolicyGPT(nn.Module):
    """Kitchen from-pixels policy: raw 30-dim observations in, rendered by
    `render_kitchen_obs_rgb` and conv-encoded inside the call,
    VisionDiffusionGPT on top. Goals (future observations) go through the
    same camera; the normalized arm state qpos[:9] / 3 is appended to each
    state token. `freeze_encoder` as in VisionPolicyGPT."""

    def __init__(self, action_dim: int = 9, embed_dim: int = 360, n_layers: int = 6,
                 n_heads: int = 6, goal_seq_len: int = 2, obs_seq_len: int = 4,
                 embed_size: int = 48, img_hw: Tuple[int, int] = (128, 128),
                 enc_features: Sequence[int] = (24, 48, 64), attn_pdrop: float = 0.3,
                 resid_pdrop: float = 0.0, cond_mask_prob: float = 0.0,
                 freeze_encoder: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_size, self.img_hw = embed_size, tuple(img_hw)
        self.enc_features = tuple(enc_features)
        self.freeze_encoder, self.dtype = freeze_encoder, dtype
        self.encoder = ConvImageEncoder(3, embed_size, enc_features, dtype, generator, device)
        self.inner = VisionDiffusionGPT(
            embed_size + 9, action_dim, embed_dim, n_layers, n_heads, goal_seq_len,
            obs_seq_len, goal_dim=embed_size, attn_pdrop=attn_pdrop,
            resid_pdrop=resid_pdrop, cond_mask_prob=cond_mask_prob, dtype=dtype,
            generator=generator, device=device)

    @torch.no_grad()
    def render(self, obs30: torch.Tensor) -> torch.Tensor:
        """Background-subtracted RGB [N, h, w, 3] of observations [N, 30]."""
        bg = torch.tensor(_KITCHEN_BG, device=obs30.device)
        return render_kitchen_obs_rgb(obs30.float(), *self.img_hw) - bg

    def forward(self, states, actions, goals, sigma, *, uncond: bool = False,
                train: bool = False, generator: Optional[torch.Generator] = None):
        B, T, _ = states.shape
        G = goals.shape[1]
        E = self.embed_size
        s_feat = _encode(self.encoder, self.render(states.reshape(B * T, 30)),
                         self.freeze_encoder).reshape(B, T, E)
        g_feat = _encode(self.encoder, self.render(goals.reshape(B * G, 30)),
                         self.freeze_encoder).reshape(B, G, E)
        s_tok = torch.cat([s_feat, (states[..., :9] / 3.0).to(s_feat.dtype)], dim=-1)
        return self.inner(s_tok, actions, g_feat, sigma, uncond=uncond, train=train,
                          generator=generator)
