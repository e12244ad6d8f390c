"""The arithmetic of the tensor-core SDF kernels in 3xTF32 (the wgmma walk of
csrc/sdf_mlp_wgmma.cuh, which every SDF kernel runs), emulated in plain
PyTorch.

A float32 x is split as big = tf32(x), small = tf32(x - big), where tf32
rounds to the nearest value with 10 mantissa bits (ties away from zero: the
13 low bits of the pattern are rounded off, as the kernels' `tf32_round`
does with integer operations). A product a * b is then taken as
big_a big_b + big_a small_b + small_a big_b, dropping small_a small_b. The
kernels keep both halves of a weight as TF32 values in float32 words
(`ops/sdf_mlp._pack_wg` splits them with `tf32_split`), and the activations
are split after each layer's bias and ReLU. Products of two TF32 values are
exact in float32, so this emulation sums them in float64 and rounds each
layer's sum to float32 once: it differs from the kernels only in the
summation order and the truncation of the tensor cores' float32 accumulators
(the kernels sum a layer's big*big products and its small ones in two
accumulators, added once). The features, biases, ReLU, output layer and
clamp are float32 as in the plain version (ops/sdf_mlp.raw_sdf_mlp).

The emulated MLP is used by the tests and by `chip_smoke.py` to hold the
kernels' arithmetic tightly; the port's paths never call it.
"""

from __future__ import annotations

import torch

from .sdf_mlp import fourier_features

_LOW_BITS = 0x1000   # half of the 13 dropped bits' unit


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32, to nearest, ties away from zero: a float32
    tensor whose 13 low mantissa bits are 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + _LOW_BITS) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple:
    """(big, small) with big = tf32(x), small = tf32(x - big); big + small
    is within 2^-21 |x| of x."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _product_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ w (K, N), float32 operands, in 3xTF32 with exact sums of
    the exact products, rounded to float32 once."""
    ab, as_ = (t.double() for t in tf32_split(a))
    wb, ws = (t.double() for t in tf32_split(w))
    return (torch.matmul(ab, wb + ws) + torch.matmul(as_, wb)).to(torch.float32)


def raw_sdf_mlp_3xtf32(model, points: torch.Tensor) -> torch.Tensor:
    """`raw_sdf_mlp` with the hidden layers in 3xTF32: points (..., 3) float32
    -> unclamped (...,)."""
    h = fourier_features(points, model.freqs, model.scale)
    lead = h.shape[:-1]
    h = h.reshape(-1, h.shape[-1])
    for w, b in zip(model.weights[:-1], model.biases[:-1]):
        h = torch.relu(_product_3xtf32(h, w) + b)
    out = torch.matmul(h, model.weights[-1]) + model.biases[-1]
    return out[:, 0].reshape(lead)
