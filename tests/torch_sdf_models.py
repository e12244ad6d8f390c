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
