"""Plain references of the benchmark's configurations: float32 PyTorch,
importing nothing of the port (hotrack_tpu_torch) or of the JAX package.
They are given the benchmark's inputs and work out again whatever the
port's set-up derived from them (the distilled SDF, the packed weights)."""

import torch


def plain_float32() -> None:
    """float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
