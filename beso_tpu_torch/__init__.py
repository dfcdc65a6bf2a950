"""PyTorch/CUDA port of `beso_tpu` for one NVIDIA Hopper card (H100).

The module paths mirror `beso_tpu`: `beso_tpu_torch.models.cached` is the
counterpart of `beso_tpu.models.cached`, and so on. The port imports torch
and numpy only; the JAX package is the reference its tests hold it against.

Ported so far: kitchen serving (the DiffusionGPT forward, the prefix-KV
cached engine, the fused engines on the hand-written CUDA layer kernels
B1-B4 in `ops/fused_layer.py`, `csrc/fused_layer_prefix.cu` (bf16) and
`csrc/fused_layer_f32.cu` (f32): the `fused_cached` engine in its three
forms and the uncached `make_fused_denoise_fn`; every sampler, Picard
and the log-likelihood in `sampling/`, the windowed policy with n-sample
mean / KDE selection, the batched kitchen physics and the multigoal and
sequential rollouts), the
chunked-kitchen training path (densities, EMA, the training forward with
the flash-attention kernels B5/B6 in `ops/flash_attention.py` and
`csrc/flash_attention.cu`, the EDM loss, the slicer, the trainer,
checkpoints, the agent, the kitchen workspace and the training CLI) and
the dataset loaders and writers behind the workspace's `data_path`, Block
Push, the evaluation CLI with every study, and the vision slice: both
scripted oracles with `scripts/generate_demos.py` and
`scripts/demo_census.py`, both ray-cast cameras, the vision modules and
policies on `VisionDiffusionGPT`, the encoder pretraining and graft,
`agents/encoders.py` and `scripts/validate_vision_e2e.py`; the training
tools (the seed sweep, `validate_e2e`, `profile_train`); the multi-device
layer on `torch.distributed` (`parallel/`: meshes, tensor parallelism,
the mesh train steps, the dry run; `rollout/sharded.py`), the single-block
envs, xArm, the env registry, env-state I/O, the host renderers and
videos, and the native batch loader (`data/native/`).
"""
