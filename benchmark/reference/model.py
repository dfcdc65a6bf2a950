"""The DiffusionGPT of BESO in plain PyTorch, float32, with the EDM
preconditioning.

Token layout `[sigma, g_1..g_G, s_1, a_1, ..., s_T, a_T]`: the sigma token
is Linear(log(sigma) / 4) without a position; goals and states share
`tok_emb`; states and actions at step t share position G + t; pre-LN blocks
with causal attention and a 4x tanh-GELU MLP; LayerNorm eps 1e-5; the
linear head reads the action tokens. Weights are a dict of tensors under
the names of `weight_shapes`, Linear weights [out, in]. The forward is the
evaluation's: no goal mask and no dropout.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from benchmark.reference.precision import linear, matmul


def weight_shapes(cfg: dict) -> dict:
    """Name -> shape of every weight of the configuration's model."""
    D, A, S = cfg["hidden_dim"], cfg["action_dim"], cfg["obs_dim"]
    N = cfg["future_seq_length"] + cfg["window_size"] + 1
    shapes = {"pos_emb": (1, N, D),
              "sigma_emb.weight": (D, 1), "sigma_emb.bias": (D,),
              "tok_emb.weight": (D, S), "tok_emb.bias": (D,),
              "action_emb.weight": (D, A), "action_emb.bias": (D,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        shapes.update({
            p + "ln1.weight": (D,), p + "ln1.bias": (D,),
            p + "attn.qkv.weight": (3 * D, D), p + "attn.qkv.bias": (3 * D,),
            p + "attn.proj.weight": (D, D), p + "attn.proj.bias": (D,),
            p + "ln2.weight": (D,), p + "ln2.bias": (D,),
            p + "fc.weight": (4 * D, D), p + "fc.bias": (4 * D,),
            p + "fc_proj.weight": (D, 4 * D), p + "fc_proj.bias": (D,)})
    shapes.update({"ln_f.weight": (D,), "ln_f.bias": (D,),
                   "action_pred.weight": (A, D), "action_pred.bias": (A,)})
    return shapes


def layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * scale + bias


def attention(q, k, v, precision: str):
    """Causal attention over heads: q, k, v [R, H, N, hd] -> [R, H, N, hd]."""
    N, hd = q.shape[2], q.shape[3]
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
    causal = torch.ones(N, N, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return matmul(probs, v, precision)


def gpt_forward(w: dict, cfg: dict, states, actions, goals, sigma, precision: str = "f32"):
    """[R, T, obs], [R, T, act], [R, G, obs], [R] -> [R, T, act]."""
    R, T, _ = states.shape
    G, D, H = cfg["future_seq_length"], cfg["hidden_dim"], cfg["n_heads"]
    hd = D // H
    sig = (torch.log(sigma) / 4.0).reshape(R, 1, 1)
    tokens = [linear(sig, w["sigma_emb.weight"], w["sigma_emb.bias"], precision),
              linear(goals, w["tok_emb.weight"], w["tok_emb.bias"], precision)
              + w["pos_emb"][:, :G]]
    pos = w["pos_emb"][:, G:G + T]
    s = linear(states, w["tok_emb.weight"], w["tok_emb.bias"], precision) + pos
    a = linear(actions, w["action_emb.weight"], w["action_emb.bias"], precision) + pos
    tokens.append(torch.stack([s, a], dim=2).reshape(R, 2 * T, D))
    x = torch.cat(tokens, dim=1)
    N = x.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        h = layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"])
        qkv = linear(h, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"], precision)
        q, k, v = (t.reshape(R, N, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        y = attention(q, k, v, precision)
        y = y.transpose(1, 2).reshape(R, N, D)
        x = x + linear(y, w[p + "attn.proj.weight"], w[p + "attn.proj.bias"], precision)
        h = layer_norm(x, w[p + "ln2.weight"], w[p + "ln2.bias"])
        h = F.gelu(linear(h, w[p + "fc.weight"], w[p + "fc.bias"], precision),
                   approximate="tanh")
        x = x + linear(h, w[p + "fc_proj.weight"], w[p + "fc_proj.bias"], precision)
    x = layer_norm(x, w["ln_f.weight"], w["ln_f.bias"])
    x = x[:, G + 1:].reshape(R, T, 2, D)[:, :, 1]
    return linear(x, w["action_pred.weight"], w["action_pred.bias"], precision)


def edm_scalings(sigma, sigma_data: float):
    """c_skip, c_out, c_in of the Karras-EDM preconditioning, [R, 1, 1]."""
    var = (sigma ** 2 + sigma_data ** 2).reshape(-1, 1, 1)
    s = sigma.reshape(-1, 1, 1)
    return sigma_data ** 2 / var, s * sigma_data / torch.sqrt(var), 1.0 / torch.sqrt(var)


def denoise(w: dict, cfg: dict, states, actions, goals, sigma, precision: str = "f32"):
    """D(x, sigma) = F(s, c_in x, g, sigma) c_out + c_skip x."""
    c_skip, c_out, c_in = edm_scalings(sigma, cfg["sigma_data"])
    out = gpt_forward(w, cfg, states, actions * c_in, goals, sigma, precision)
    return out * c_out + actions * c_skip
