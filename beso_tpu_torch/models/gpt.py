"""Noise-conditioned causal transformer ("DiffusionGPT"), with its training forward.

Torch port of `beso_tpu/models/gpt.py` (itself the reference's
`score_gpts.py:15-374`):

token layout   [sigma_emb, g_1..g_G, s_1, a_1, ..., s_T, a_T]
sigma token    Linear(log(sigma)/4)         (score_gpts.py:284-286), or one
               of the other `sigma_embedding` kinds (models/embeddings.py)
tok_emb        shared Linear for states AND goals, unless goal_dim differs
               from state_dim, where goals get their own `goal_emb`
pos_emb        learned, shared between s_t and a_t
head           linear, or Linear(D,100)+SiLU+Linear(100,A)
output         action-slot tokens of the second half

Numerics follow the JAX package: the "broadcast" attention form with f32
softmax, tanh GELU by default (`gpt.py:127,175`; `approximate_gelu=False`
takes the erf GELU of the reference's `nn.GELU()`, for its checkpoints),
LayerNorm statistics in f32 with variance E[x^2] - mu^2, and every Linear computed as
an f32-accumulated product of `dtype` operands plus an f32 bias, rounded to
`dtype` once. Parameters stay f32; `dtype` is the compute type.

`train=True` adds the training-time randomness of `beso_tpu/models/gpt.py`,
drawn from an explicit `torch.Generator`: dropout on the embeddings
(`embed_pdrob`), on the attention probabilities of the broadcast form
(`attn_pdrop`) and after the projection and the MLP (`resid_pdrop`), each
as flax's `nn.Dropout` (keep with 1 - p, scale by 1/(1 - p)); and the CFG
goal mask, an elementwise Bernoulli(`cond_mask_prob`) zeroing of the goals.
The whole forward is differentiable.

`attention` picks the attention form as the JAX package does (`gpt.py:78-94`):
"broadcast" (plain PyTorch), "pallas" (the flash-attention kernels B5/B6 of
`ops/flash_attention.py`, CUDA on the card; the config keeps the JAX name)
or "auto" (flash at >= 64 tokens unless attention dropout is active).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from beso_tpu_torch.ops.flash_attention import flash_attention

# token count at/above which "auto" attention takes the flash kernels
# (`beso_tpu/models/gpt.py:40`)
_FLASH_THRESHOLD = 64

Drop = Optional[Callable[[torch.Tensor], torch.Tensor]]


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """`x @ weight.T + bias` with `dtype` operands, f32 accumulation and f32
    bias, rounded to `dtype` (the `_dense` of `beso_tpu/models/cached.py`).
    `weight` is [out, in], torch's Linear convention."""
    y = F.linear(x.to(dtype).float(), weight.to(dtype).float(), bias.float())
    return y.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics, var = E[x^2] - mu^2,
    eps 1e-5, output in `dtype`."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias).to(dtype)


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """GELU in f32, returned in the input's dtype: the tanh form, or with
    `approximate=False` the exact 0.5 x (1 + erf(x / sqrt 2))."""
    return F.gelu(x.float(), approximate="tanh" if approximate else "none").to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout` in training: keep with probability 1 - rate, scale
    the kept values by 1/(1 - rate) in x's dtype."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, drop: Drop = None) -> torch.Tensor:
    """Broadcast-form attention: q [B,Tq,H,hd], k/v [B,S,H,hd], mask [Tq,S]
    bool. Scores in f32 over the true head dim, probabilities (after the
    optional dropout `drop`) rounded to v's dtype, output [B, Tq, H*hd] in
    q's dtype."""
    B, Tq, H, hd = q.shape
    dtype = q.dtype
    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~mask[None, :, :, None], float("-inf"))
    probs = torch.softmax(scores, dim=2)
    if drop is not None:
        probs = drop(probs)
    probs = probs.to(v.dtype)
    y = torch.einsum("btsh,bshd->bthd", probs.float(), v.float())
    return y.to(dtype).reshape(B, Tq, H * hd)


def block_forward(lp: dict, x: torch.Tensor, n_heads: int, dtype: torch.dtype,
                  mask: Optional[torch.Tensor], kv_prefix=None, *,
                  flash: bool = False, attn_drop: Drop = None,
                  resid_drop: Drop = None, approximate_gelu: bool = True):
    """One pre-LN block (score_gpts.py:83-115) over tokens x [B, T, D] with
    weights `lp` (`Block.weights()` names, Linear weights [out, in]).
    Queries attend to [kv_prefix ++ own K/V] under mask [T, P+T], or, with
    `flash`, causally to their own K/V through the flash kernels. The
    optional dropouts act on the attention probabilities and after the
    projection and the MLP; `approximate_gelu` picks the MLP's GELU.
    Returns (x_out, (k, v)) with the block's own k, v as [B, T, H, hd]."""
    B, T, D = x.shape
    h = layer_norm(x, lp["ln1_s"], lp["ln1_b"], dtype)
    q, k, v = dense(h, lp["wqkv"], lp["bqkv"], dtype).split(D, dim=-1)
    q, k, v = (a.reshape(B, T, n_heads, D // n_heads) for a in (q, k, v))
    if flash:
        # kernel layout [B, H, T, hd]
        y = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
        y = y.transpose(1, 2).reshape(B, T, D)
    else:
        k_all, v_all = k, v
        if kv_prefix is not None:
            k_all = torch.cat([kv_prefix[0].to(k.dtype), k], dim=1)
            v_all = torch.cat([kv_prefix[1].to(v.dtype), v], dim=1)
        y = attend(q, k_all, v_all, mask, attn_drop)
    y = dense(y, lp["wproj"], lp["bproj"], dtype)
    x = x + (y if resid_drop is None else resid_drop(y))
    h = layer_norm(x, lp["ln2_s"], lp["ln2_b"], dtype)
    h = gelu(dense(h, lp["wfc"], lp["bfc"], dtype), approximate_gelu)
    h = dense(h, lp["wfc2"], lp["bfc2"], dtype)
    return x + (h if resid_drop is None else resid_drop(h)), (k, v)


def _normal_linear(n_in, n_out, generator, device):
    """miniGPT init: normal(0, 0.02) weights, zero bias (score_gpts.py:202-209)."""
    lin = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        nn.init.normal_(lin.weight, 0.0, 0.02, generator=generator)
        lin.bias.zero_()
    return lin


def _lecun_linear(n_in, n_out, generator, device):
    """flax `nn.Dense` default: lecun-normal (truncated normal at 2 std,
    variance 1/fan_in) weights, zero bias."""
    lin = nn.Linear(n_in, n_out, device=device)
    # std of a unit normal truncated to [-2, 2] (flax variance_scaling)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class CausalSelfAttention(nn.Module):
    """Fused-QKV causal self-attention weights (score_gpts.py:15-80); the
    math is in `block_forward`."""

    def __init__(self, n_embd: int, n_heads: int, generator=None, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = _lecun_linear(n_embd, 3 * n_embd, generator, device)
        self.proj = _lecun_linear(n_embd, n_embd, generator, device)


class Block(nn.Module):
    """Pre-LN transformer block with a 4x GELU MLP (score_gpts.py:83-115):
    tanh GELU, or erf with `approximate_gelu=False`."""

    def __init__(self, n_embd: int, n_heads: int, generator=None, device=None,
                 approximate_gelu: bool = True):
        super().__init__()
        self.approximate_gelu = approximate_gelu
        self.ln1 = nn.LayerNorm(n_embd, eps=1e-5, device=device)
        self.attn = CausalSelfAttention(n_embd, n_heads, generator, device)
        self.ln2 = nn.LayerNorm(n_embd, eps=1e-5, device=device)
        self.fc = _lecun_linear(n_embd, 4 * n_embd, generator, device)
        self.fc_proj = _lecun_linear(4 * n_embd, n_embd, generator, device)

    def weights(self) -> dict:
        """The block's parameters under `block_forward`'s names."""
        a = self.attn
        return dict(ln1_s=self.ln1.weight, ln1_b=self.ln1.bias,
                    wqkv=a.qkv.weight, bqkv=a.qkv.bias,
                    wproj=a.proj.weight, bproj=a.proj.bias,
                    ln2_s=self.ln2.weight, ln2_b=self.ln2.bias,
                    wfc=self.fc.weight, bfc=self.fc.bias,
                    wfc2=self.fc_proj.weight, bfc2=self.fc_proj.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, *, flash: bool = False,
                attn_drop: Drop = None, resid_drop: Drop = None) -> torch.Tensor:
        T = x.shape[1]
        causal = (None if flash else
                  torch.ones(T, T, dtype=torch.bool, device=x.device).tril())
        return block_forward(self.weights(), x, self.attn.n_heads, dtype, causal,
                             flash=flash, attn_drop=attn_drop,
                             resid_drop=resid_drop,
                             approximate_gelu=self.approximate_gelu)[0]


class DiffusionGPT(nn.Module):
    """Goal-conditioned noise-aware causal GPT over state/action tokens.

    `sigma_embedding` is the sigma token's embedding kind (utils.py:8-23):
    "Linear", the shipped one, or another kind of `models/embeddings.py`,
    held as `sigma_emb` as the reference holds it. `approximate_gelu=False`
    takes the erf GELU in every block."""

    def __init__(self, state_dim: int, action_dim: int, embed_dim: int,
                 n_layers: int, n_heads: int, goal_seq_len: int,
                 obs_seq_len: int, goal_conditioned: bool = True,
                 embed_pdrob: float = 0.0, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, cond_mask_prob: float = 0.0,
                 linear_output: bool = True, goal_dim: Optional[int] = None,
                 sigma_embedding: str = "Linear", approximate_gelu: bool = True,
                 attention: str = "auto", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if attention not in ("auto", "broadcast", "pallas"):
            raise ValueError(f"attention must be 'auto', 'broadcast' or 'pallas', "
                             f"got {attention!r}")
        self.state_dim = state_dim
        self.action_dim = action_dim
        self.embed_dim = embed_dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.goal_seq_len = goal_seq_len
        self.obs_seq_len = obs_seq_len
        self.goal_conditioned = goal_conditioned
        self.embed_pdrob = embed_pdrob
        self.attn_pdrop = attn_pdrop
        self.resid_pdrop = resid_pdrop
        self.cond_mask_prob = cond_mask_prob
        self.linear_output = linear_output
        self.goal_dim = goal_dim
        self.sigma_embedding = sigma_embedding
        self.approximate_gelu = approximate_gelu
        self.attention = attention
        self.dtype = dtype

        g, dev, D = generator, device, embed_dim
        if sigma_embedding == "Linear":
            self.sigma_emb = _normal_linear(1, D, g, dev)
        else:
            from beso_tpu_torch.models.embeddings import make_time_embedding

            self.sigma_emb = make_time_embedding(sigma_embedding, D, g, dev)
        self.tok_emb = _normal_linear(state_dim, D, g, dev)
        self.goal_emb = (_normal_linear(goal_dim, D, g, dev)
                         if self.has_goal_emb else None)
        self.action_emb = _normal_linear(action_dim, D, g, dev)
        self.pos_emb = nn.Parameter(torch.empty(1, self.seq_size, D, device=dev))
        with torch.no_grad():
            nn.init.normal_(self.pos_emb, 0.0, 0.02, generator=g)
        self.blocks = nn.ModuleList(
            [Block(D, n_heads, g, dev, approximate_gelu) for _ in range(n_layers)])
        self.ln_f = nn.LayerNorm(D, eps=1e-5, device=dev)
        if linear_output:
            self.action_pred = _normal_linear(D, action_dim, g, dev)
        else:
            self.action_pred_fc = _normal_linear(D, 100, g, dev)
            self.action_pred_out = _normal_linear(100, action_dim, g, dev)

    @property
    def has_goal_emb(self) -> bool:
        return self.goal_dim is not None and self.goal_dim != self.state_dim

    @property
    def eff_goal_len(self) -> int:
        return self.goal_seq_len if self.goal_conditioned else 0

    @property
    def seq_size(self) -> int:
        return self.eff_goal_len + self.obs_seq_len + 1

    def embed_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        """Sigma token [..., 1, D] from sigma [...]: Linear(log(sigma)/4) in
        the compute dtype, or another embedding kind of log(sigma)/4 in f32."""
        sig = (torch.log(sigma.float()) / 4.0)[..., None, None]
        if self.sigma_embedding == "Linear":
            return dense(sig, self.sigma_emb.weight, self.sigma_emb.bias, self.dtype)
        return self.sigma_emb(sig.reshape(-1)).reshape(*sigma.shape, 1, self.embed_dim)

    def embed_goals(self, goals: torch.Tensor, drop: Drop = None) -> torch.Tensor:
        """Goal tokens [B, G, D] (f32: the f32 pos_emb promotes them)."""
        emb = self.goal_emb if self.has_goal_emb else self.tok_emb
        G = self.eff_goal_len
        x = dense(goals, emb.weight, emb.bias, self.dtype) + self.pos_emb[:, :G]
        return x if drop is None else drop(x)

    def embed_suffix(self, states: torch.Tensor, actions: torch.Tensor,
                     drop: Drop = None) -> torch.Tensor:
        """Interleaved [s_1, a_1, ..., s_T, a_T] tokens [B, 2T, D] in dtype."""
        B, T, _ = states.shape
        G = self.eff_goal_len
        pos = self.pos_emb[:, G:G + T]
        state_x = dense(states, self.tok_emb.weight, self.tok_emb.bias,
                        self.dtype) + pos
        action_x = dense(actions, self.action_emb.weight, self.action_emb.bias,
                         self.dtype) + pos
        if drop is not None:
            state_x, action_x = drop(state_x), drop(action_x)
        seq = torch.stack([state_x, action_x], dim=2)
        return seq.reshape(B, 2 * T, self.embed_dim).to(self.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Action head over action-slot tokens, f32 output."""
        if self.linear_output:
            return F.linear(x.float(), self.action_pred.weight.float(),
                            self.action_pred.bias.float())
        h = dense(x, self.action_pred_fc.weight, self.action_pred_fc.bias,
                  self.dtype)
        h = F.silu(h.float()).to(self.dtype)
        return F.linear(h.float(), self.action_pred_out.weight.float(),
                        self.action_pred_out.bias.float())

    def attention_impl(self, n_tokens: int, train: bool) -> str:
        """The attention form of this call, "broadcast" or "pallas"
        (`beso_tpu/models/gpt.py:78-84`)."""
        dropout_active = train and self.attn_pdrop > 0
        impl = self.attention
        if impl == "auto":
            impl = ("pallas" if n_tokens >= _FLASH_THRESHOLD and not dropout_active
                    else "broadcast")
        if impl == "pallas" and dropout_active:
            raise ValueError("attention='pallas' does not support attn_pdrop")
        return impl

    def forward(self, states: torch.Tensor, actions: torch.Tensor,
                goals: torch.Tensor, sigma: torch.Tensor, *,
                uncond: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B,T,state], [B,T,action], [B,G,goal], [B] -> [B,T,action] f32.

        `train=True` turns on dropout and CFG goal masking, drawn from
        `generator` (None: the device's default generator)."""
        B, T, _ = states.shape
        G = self.eff_goal_len

        def drop(rate: float) -> Drop:
            if not train or rate == 0.0:
                return None
            return lambda x: dropout(x, rate, generator)

        parts = [self.embed_sigma(sigma)]
        if self.goal_conditioned:
            if uncond:
                goals = torch.zeros_like(goals)
            elif train and self.cond_mask_prob > 0.0:
                mask = torch.rand(goals.shape, generator=generator,
                                  device=goals.device) < self.cond_mask_prob
                goals = goals * (1.0 - mask.to(goals.dtype))
            parts.append(self.embed_goals(goals, drop(self.embed_pdrob)))
        parts.append(self.embed_suffix(states, actions, drop(self.embed_pdrob)))
        x = torch.cat([p.to(self.dtype) for p in parts], dim=1)
        flash = self.attention_impl(x.shape[1], train) == "pallas"
        for blk in self.blocks:
            x = blk(x, self.dtype, flash=flash, attn_drop=drop(self.attn_pdrop),
                    resid_drop=drop(self.resid_pdrop))
        x = layer_norm(x, self.ln_f.weight, self.ln_f.bias, self.dtype)
        x = x[:, G + 1:].reshape(B, T, 2, self.embed_dim)[:, :, 1]
        return self.head(x)
