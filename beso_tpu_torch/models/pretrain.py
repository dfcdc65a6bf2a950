"""Encoder pretraining for image policies: state regression from pixels
(torch port of `beso_tpu/models/pretrain.py`).

The reference's vision pipelines consume precomputed embeddings of a
pretrained encoder (`beso/envs/franka_kitchen/dataloader.py:94-161`); no
pretrained weights can be vendored, so this stage renders demo states
through the fixed analytic camera, trains the policy's `ConvImageEncoder`
with a small regression head (thrown away) to regress the low-dimensional
state, and grafts the encoder weights into the policy
(`graft_encoder_params`), optionally frozen (`freeze_encoder=True`). The
per-dim RMSE of the probe says how much of the state the embedding
carries.

The JAX version scans `steps_per_call` steps per jitted call to spread its
dispatch cost; here the steps run in a plain loop, with the same count of
steps and the same per-step draws (the batch indices and the state
jitter, through `pretrain_draws`, which the tests replace by the JAX
package's draws).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from beso_tpu_torch.models.gpt import _lecun_linear, gelu
from beso_tpu_torch.models.vision_policy import ConvImageEncoder


class StateRegressionNet(nn.Module):
    """ConvImageEncoder (shared with the policy) + disposable MLP head. The
    encoder submodule is named "encoder", as in both vision policies, so
    its weights graft into them."""

    def __init__(self, obs_dim: int, in_channels: int, embed_size: int = 48,
                 features: Sequence[int] = (24, 48, 64), head_width: int = 128,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.encoder = ConvImageEncoder(in_channels, embed_size, features, dtype,
                                        generator, device)
        self.head_hidden = _lecun_linear(embed_size, head_width, generator, device)
        self.head_out = _lecun_linear(head_width, obs_dim, generator, device)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:   # [N, H, W, C]
        x = self.head_hidden(self.encoder(imgs).float())
        return self.head_out(gelu(x))


def graft_encoder_params(model: nn.Module, encoder_state: dict) -> nn.Module:
    """Load `encoder_state` (an encoder's state dict) into the unique
    submodule named "encoder" anywhere in `model`, in place; raises if
    there is none or more than one."""
    found = [m for name, m in model.named_modules() if name.split(".")[-1] == "encoder"]
    if len(found) != 1:
        raise ValueError(f"expected exactly one 'encoder' subtree, found {len(found)}")
    found[0].load_state_dict(encoder_state)
    return model


def pretrain_draws(what: str, n: int, m: int, shape, generator: Optional[torch.Generator],
                   device, step: int = 0):
    """The draws of `pretrain_state_regression` from `generator` in call
    order: "index" (n pool indices in [0, m) of step `step`), "jitter" (unit
    normals of `shape` of that step) and "probe" (the probe's n indices)."""
    if what in ("index", "probe"):
        return torch.randint(0, m, (n,), generator=generator, device=device)
    if what == "jitter":
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f"unknown draw {what!r}")


def cosine_decay_factor(count: int, decay_steps: int, alpha: float = 0.01) -> float:
    """`optax.cosine_decay_schedule`'s factor at update `count` (from 0)."""
    count = min(count, decay_steps)
    return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha


def pretrain_state_regression(
    generator: Optional[torch.Generator],
    states: np.ndarray,
    render_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    embed_size: int = 48,
    features: Sequence[int] = (24, 48, 64),
    dtype: torch.dtype = torch.float32,
    steps: int = 3000,
    batch_size: int = 256,
    lr: float = 1e-3,
    jitter_rel: float = 0.1,
    steps_per_call: int = 50,
    target_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    cosine_decay: bool = True,
    std_floor: float = 1e-3,
    jitter_std: Optional[np.ndarray] = None,
    device=None,
):
    """Train `ConvImageEncoder` on `device` to regress the low-dim state
    from its own rendering (see the JAX function for the arguments).

    `states` [M, obs_dim] is the pool (targets normalized by its weighted
    mean and std); `render_fn` maps states [B, obs_dim] to images
    [B, H, W, C] as the policy feeds its encoder; `target_fn` and
    `weight_fn` map states [B, obs_dim] to targets and per-target loss
    weights [B, target_dim]. It runs max(1, steps // steps_per_call) *
    steps_per_call Adam steps, the learning rate cosine-annealed over
    `steps` to lr / 100 when `cosine_decay`.

    Returns (encoder state dict, for `graft_encoder_params`; info with the
    final and first loss and the probe's per-dim weighted RMSE in target
    units)."""
    states = np.asarray(states, np.float32)
    m, obs_dim = states.shape
    if target_fn is None:
        target_fn = lambda b: b  # noqa: E731
    if weight_fn is None:
        weight_fn = lambda b: torch.ones_like(target_fn(b))  # noqa: E731

    pool_cpu = torch.as_tensor(states)
    pool_t = target_fn(pool_cpu).numpy().astype(np.float32)
    pool_w = weight_fn(pool_cpu).numpy().astype(np.float32)
    wsum = np.maximum(pool_w.sum(axis=0), 1e-6)
    mean = (pool_t * pool_w).sum(axis=0) / wsum
    var = (pool_w * (pool_t - mean) ** 2).sum(axis=0) / wsum
    std = np.maximum(np.sqrt(var), std_floor)

    pool = pool_cpu.to(device)
    with torch.no_grad():
        in_channels = render_fn(pool[:1]).shape[-1]
    net = StateRegressionNet(pool_t.shape[-1], in_channels, embed_size, features,
                             dtype=dtype, generator=generator, device=device)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    factor = ((lambda c: cosine_decay_factor(c, max(steps, 1))) if cosine_decay
              else (lambda c: 1.0))
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)

    mean_t = torch.as_tensor(mean, device=device)
    std_t = torch.as_tensor(std, device=device)
    if jitter_std is None:
        jitter_std = jitter_rel * np.maximum(states.std(axis=0), 1e-3)
    jitter_std = np.asarray(jitter_std, np.float32)
    apply_jitter = bool(np.any(jitter_std > 0))
    jitter_t = torch.as_tensor(jitter_std, device=device)

    def loss_fn(batch_states):
        imgs = render_fn(batch_states)
        pred = net(imgs)
        target = (target_fn(batch_states) - mean_t) / std_t
        w = weight_fn(batch_states)
        return torch.sum(w * (pred - target) ** 2) / torch.clamp(torch.sum(w), min=1e-6)

    losses = []
    for step in range(max(1, steps // steps_per_call) * steps_per_call):
        idx = pretrain_draws("index", batch_size, m, None, generator, device, step)
        b = pool[idx]
        if apply_jitter:
            b = b + jitter_t * pretrain_draws("jitter", batch_size, m, b.shape, generator,
                                              device, step)
        loss = loss_fn(b)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy()

    # held-in probe: per-dim weighted RMSE in target units on a fresh slice
    with torch.no_grad():
        probe = pool[pretrain_draws("probe", min(512, m), m, None, generator, device)]
        err = (net(render_fn(probe)) * std_t + mean_t) - target_fn(probe)
        w = weight_fn(probe)
        rmse = torch.sqrt(torch.sum(w * err ** 2, dim=0)
                          / torch.clamp(torch.sum(w, dim=0), min=1e-6)).cpu().numpy()
    info = {"final_loss": float(losses[-10:].mean()),
            "first_loss": float(losses[:10].mean()),
            "rmse_per_dim": rmse,
            "rmse_mean": float(rmse.mean())}
    encoder_state = {k: v.detach().clone() for k, v in net.encoder.state_dict().items()}
    return encoder_state, info
