"""The benchmark's fixed arithmetic: peaks, roofline bounds, model FLOPs,
and the device time of a traced window.

Copied into the benchmark so that a change to the program cannot move the
yardstick: `bound` and `layer_work` from `chip_smoke.py`, `forward_flops` (its
broadcast form) and the busy-union arithmetic of `device_time` from
`beso_tpu_torch/scripts/profile_train.py`. The FLOP counts take the
configuration's sizes (the keys of `benchmark/configs/*.json`) in place of a
model object.
"""

from __future__ import annotations

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16
# tensor-core operations and HBM3 bytes per second. An f32-exact product is
# counted as three bf16 tensor-core products (hi.hi + lo.hi + hi.lo), so f32
# work is held against a third of the bf16 rate, whatever the implementation.
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
PEAK_F32_BF16X3_FLOPS = PEAK_BF16_FLOPS / 3
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_BF16X3_FLOPS}
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def peak_flops(dtype: str) -> float:
    """The peak that the configuration's compute dtype is held against."""
    return PEAK_FLOPS[dtype]


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for this
    work, the larger of its operations over `peak` and its bytes over the
    memory rate, and which of the two it is."""
    t_ops, t_mem = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def layer_work(B, T, D, P, n_layers=1, elem=2):
    """Operations and bytes of n_layers fused layers over B rows x T tokens,
    each token seeing P prefix keys and its causal own keys, with
    `elem`-byte activations and weights (2: bf16, 4: f32): 24 D^2 per token
    per layer for the four products and 4 D per (query, key) pair for the
    scores and P.V; x read once and out written once, and per layer its
    weights (12 D^2, 13 D f32 of biases and LayerNorm) and one sigma row of
    prefix K and V (2 B P D)."""
    rows, pairs = B * T, B * sum(P + t + 1 for t in range(T))
    flops = n_layers * (rows * 24 * D * D + pairs * 4 * D)
    nbytes = (2 * rows * D * elem
              + n_layers * (12 * D * D * elem + 13 * D * 4 + 2 * B * P * D * elem))
    return flops, nbytes


def n_tokens(cfg: dict) -> int:
    """Sequence length of the full forward: sigma, goals, states and actions."""
    return 1 + cfg["future_seq_length"] + 2 * cfg["window_size"]


def forward_flops(cfg: dict, batch_size: int) -> tuple:
    """(embedding FLOPs, body FLOPs) of one forward over `batch_size`
    windows: the matrix products, 2 per multiply-add. The embeddings are the
    sigma, goal, state and action tokens; the body is the blocks (the four
    products per token, and the attention's scores and weighted sum over all
    N x N pairs, as the broadcast form computes them) and the linear head."""
    D, L = cfg["hidden_dim"], cfg["num_hidden_layers"]
    G, T = cfg["future_seq_length"], cfg["window_size"]
    N = n_tokens(cfg)
    goal_dim = cfg.get("goal_dim", cfg["obs_dim"])
    embed = 2 * D * (1 + G * goal_dim + T * (cfg["obs_dim"] + cfg["action_dim"]))
    block = 24 * N * D * D + 4 * N * N * D
    head = 2 * T * D * cfg["action_dim"]
    return batch_size * embed, batch_size * (L * block + head)


def denoiser_call_flops(cfg: dict, rows: int) -> int:
    """Model FLOPs of one denoiser call over `rows` rows: the full-sequence
    forward, whatever part of it an engine computes (a prefix cache saves
    work but not model FLOPs)."""
    embed, body = forward_flops(cfg, rows)
    return embed + body


def busy_us(kernels) -> float:
    """Microseconds in which at least one kernel ran: the union of the
    kernels' (name, start us, end us) intervals."""
    busy, last = 0.0, float("-inf")
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


def idle_gaps(kernels):
    """The (start us, end us) gaps between the union of the kernels'
    intervals, in time order."""
    gaps, last = [], None
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if last is not None and start > last:
            gaps.append((last, start))
        last = end if last is None else max(last, end)
    return gaps
