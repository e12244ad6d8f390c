"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/nn/precision.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

Reduced-precision compute for HandTrackNet (`network/compute_dtype`).

The JAX package's HandTrackNet takes a compute dtype (bfloat16 or float16)
for its dense layers: the PointNet++ backbone, the keypoint set
abstractions, the rearrange layers and the FFN. Parameters, BatchNorm,
LayerNorm, the canonicalisation and the delta head stay float32. The port
rounds where the JAX code casts and nowhere else; `torch.autocast` is not
used, since it casts at other points and adds the bias inside the product.

`dense` is flax's `nn.Dense(dtype=cd)`: the input and the weights cast to
cd, their product in cd (a float32 sum, rounded once), then the bias, cast
to cd, added in cd (a second rounding). On the CPU the product is taken in
float32 on the rounded operands and rounded once, as XLA:CPU computes a
bf16 or fp16 dot; on the card it is cuBLAS's bf16 or fp16 GEMM, whose sum
is float32 once `train/trainer.pin_fp32` has turned the reduced-precision
reductions off. Without a compute dtype every helper here is the float32
(or float64) path as it was, untouched.
"""

from __future__ import annotations

import torch
from torch import nn

# the values of network/compute_dtype the JAX package accepts; float32 is
# its default path
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": None}


def resolve_compute_dtype(name) -> torch.dtype | None:
    """The dtype of `network/compute_dtype` (None or absent: the float32
    path); any value but those of COMPUTE_DTYPES raises."""
    if name is None:
        return None
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"network/compute_dtype must be one of {sorted(COMPUTE_DTYPES)} "
                         f"or absent, got {name!r}")
    return COMPUTE_DTYPES[name]


def dense(layer: nn.Linear, x: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """`layer(x)` in the compute dtype cd (flax's Dense(dtype=cd)), or
    `layer(x)` itself when cd is None."""
    if cd is None:
        return layer(x)
    x, w = x.to(cd), layer.weight.to(cd)
    if x.is_cuda:
        y = torch.matmul(x, w.t())
    else:
        y = torch.matmul(x.float(), w.float().t()).to(cd)
    return y + layer.bias.to(cd)


def to_f32(x: torch.Tensor, cd: torch.dtype | None) -> torch.Tensor:
    """x in float32 where a compute dtype is set (the JAX code's
    `astype(float32)` before a norm or the head), x itself otherwise."""
    return x if cd is None else x.float()
