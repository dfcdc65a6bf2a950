"""PyTorch/CUDA port of `beso_tpu` for one NVIDIA Hopper card (H100).

The module paths mirror `beso_tpu`: `beso_tpu_torch.models.cached` is the
counterpart of `beso_tpu.models.cached`, and so on. The port imports torch
and numpy only; the JAX package is the reference its tests hold it against.

Slice 1 covers kitchen serving: the DiffusionGPT inference forward, the
prefix-KV cached engine, the `fused_cached` engine on the hand-written CUDA
layer kernel (`ops/fused_layer.py`, `csrc/fused_layer_prefix.cu`), DDIM
sampling, the windowed policy, the batched kitchen physics and the rollout.
"""
