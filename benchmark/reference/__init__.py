"""The plain reference that decides `correct`: the DiffusionGPT forward,
the EDM preconditioning, classifier-free guidance, the samplers' steps, the
scaler and the kitchen surrogate physics, in plain PyTorch and float32 with
TF32 switched off.

It imports nothing of the program (`beso_tpu_torch`), of the JAX package
(`beso_tpu`) or of `jax`, and takes nothing that the program made: the
benchmark hands it the same raw weights and data it hands the
program, and the program's outputs only to judge them.
"""
