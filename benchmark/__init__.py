"""The benchmark of the PyTorch and CUDA port (`beso_tpu_torch`); see README.md."""
