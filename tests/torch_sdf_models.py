"""Seeded distilled-SDF models for the port's tests: the same numpy arrays
as the JAX package's `DistilledSDF` and as the port's. JAX is imported only
where a JAX model is asked for: the kernel tests run where there is none."""

import numpy as np

from hotrack_tpu_torch.utils.convert import distilled_from_numpy


def model_arrays(seed, widths=(21, 32, 32), freqs=None, clamp=0.05) -> dict:
    """A seeded model as `distilled_to_numpy`'s dict of numpy arrays."""
    rng = np.random.RandomState(seed)
    n_freqs = (widths[0] - 3) // 6
    dims = [*widths, 1]
    arrays = {
        "weights": tuple((rng.randn(dims[i], dims[i + 1]) * np.sqrt(2.0 / dims[i])
                          * (0.05 if i == len(dims) - 2 else 1.0)).astype(np.float32)
                         for i in range(len(dims) - 1)),
        "biases": tuple((rng.randn(dims[i + 1]) * 0.02).astype(np.float32)
                        for i in range(len(dims) - 1)),
        "freqs": np.asarray(np.pi * 2.0 ** np.arange(n_freqs) if freqs is None else freqs,
                            np.float32),
        "scale": np.float32(5.0), "clamp": np.float32(clamp)}
    return arrays


def random_model(seed, **kwargs):
    """The same seeded model as (the JAX package's, the port's)."""
    arrays = model_arrays(seed, **kwargs)
    return jax_model(arrays), distilled_from_numpy(arrays)


def jax_model(arrays: dict):
    """The JAX package's `DistilledSDF` from `distilled_to_numpy`'s dict."""
    import jax.numpy as jnp

    from hotrack_tpu.sdf import distill as jdistill
    return jdistill.DistilledSDF(
        tuple(jnp.asarray(w) for w in arrays["weights"]),
        tuple(jnp.asarray(b) for b in arrays["biases"]), jnp.asarray(arrays["freqs"]),
        jnp.asarray(arrays["scale"]), jnp.asarray(arrays["clamp"]))


# bf16 holds (tests/test_torch_sdf_bf16.py): at least BF16_SDF_SHARE of the
# values within BF16_SDF_ATOL_TIGHT, every value within `bf16_flip_atol`. A
# kernel on the card against its plain version takes BF16_CARD_FLIPS flips: the
# tensor cores' sums truncate where the plain version's round, so the two sides
# part at more rounding boundaries than two packages on the CPU do (on the card
# one value lay 1.8 top-unit steps from the plain version's, of 6.3M values).
BF16_SDF_ATOL_TIGHT = 1e-6
BF16_SDF_SHARE = 0.995
BF16_CARD_FLIPS = 4


def bf16_sum_atol(n: int, flip: float) -> float:
    """A sum of n values of the bf16 holds: the tight bound a value, the
    flipped values' (at most 1 - BF16_SDF_SHARE of them, and at least one)
    whole flip bound."""
    import math
    return n * BF16_SDF_ATOL_TIGHT + max(1, math.ceil((1 - BF16_SDF_SHARE) * n)) * flip


def bf16_share_floor(n_values: int, n_hidden: int = 3) -> float:
    """The least share of n_values within BF16_SDF_ATOL_TIGHT: BF16_SDF_SHARE at
    the shipped depth of 3 hidden layers, the values beyond it scaled with the
    depth (each hidden layer's output is rounded once, each rounding may flip),
    and never fewer than 4 of them (a few hundred values carry a flip or two)."""
    misses = max(4.0, (1 - BF16_SDF_SHARE) * max(n_hidden, 3) / 3 * n_values)
    return 1.0 - misses / n_values


def bf16_share_and_worst(got, want) -> tuple:
    """(share of the values within BF16_SDF_ATOL_TIGHT, largest difference)."""
    d = (got.double() - want.double()).abs().flatten()
    return float((d <= BF16_SDF_ATOL_TIGHT).double().mean()), float(d.max())


def bf16_flip_atol(model, points, flips: int = 1) -> float:
    """The flip part of the bf16 SDF holds (tests/test_torch_sdf_bf16.py): a
    float32 sum that lands on the other side of a bf16 rounding boundary moves
    an activation by one bf16 ulp, 2^(e - 7) for an activation in [2^e,
    2^(e + 1)), and the output layer carries that with the unit's weight.
    Bound: `flips` times the largest such step over the last hidden layer's
    units, each unit at its largest activation over `points` (..., 3)."""
    import torch

    from hotrack_tpu_torch.ops.sdf_mlp import fourier_features
    with torch.no_grad():
        h = fourier_features(points.reshape(-1, 3).float(), model.freqs, model.scale)
        for w, b in zip(model.weights[:-1], model.biases[:-1]):
            h = torch.relu(h @ w + b)
        top = h.abs().amax(0).clamp(min=1e-30)
        ulp = 2.0 ** (torch.floor(torch.log2(top)) - 7)
        return flips * float((ulp * model.weights[-1][:, 0].abs()).max())
