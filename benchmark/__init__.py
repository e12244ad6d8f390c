"""The benchmark of hotrack_tpu_torch, the PyTorch/CUDA port (see README.md)."""
