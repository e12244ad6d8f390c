"""Distilled neural SDF: a small Fourier-feature MLP standing in for the
trilinear volume lookup (port of hotrack_tpu/sdf/distill.py).

The particle optimisers query the SDF at about 2M positions per iteration
(2048 particles x 1024 points). The volume is distilled once per sequence
into an MLP (Fourier features -> 3 x 128 ReLU -> sdf) whose evaluation is
dense arithmetic instead of eight random gathers a point; on the card the
queries run in the hand-written kernels of csrc/ (ops/sdf_mlp.py,
ops/obj_energy.py). It approximates the baked volume to about a voxel; the
exact trilinear route stays available (`sdf_query: volume`).

Every random number of `distill_sdf_volume` comes from one `torch.Generator`
or, draw by draw, from `draws`, so a test can feed this package and the JAX
package the same numbers.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.sdf_mlp import fourier_features as _features
from ..ops.sdf_mlp import fused_sdf_mlp, fused_sdf_mlp_cf
from ..ops.sdf_mlp import raw_sdf_mlp as _raw_sdf
from ..utils.trace import spanned
from .volume import trilinear_sdf

__all__ = ["DistilledSDF", "MAX_FREQS", "HIDDEN", "DEPTH", "_features", "_raw_sdf",
           "eval_distilled_sdf", "eval_distilled_sdf_cf", "sdf_compute_dtype", "distill_sdf_volume",
           "near_surface_indices", "distilled_to"]


class DistilledSDF(NamedTuple):
    """MLP parameters and input scaling. Weights are (in, out), as in the
    JAX package."""

    weights: tuple          # ((in, h), (h, h), ..., (h, 1))
    biases: tuple
    freqs: torch.Tensor     # (F,) Fourier frequencies
    scale: torch.Tensor     # () coordinate normalisation (1 / extent)
    clamp: torch.Tensor     # () output clamp (0.05)


# the shipped architecture (hotrack_tpu/sdf/distill.py: at the 4000-step budget
# fewer frequencies fit the near-surface band better, and depth 3 matches 4)
MAX_FREQS = 3
HIDDEN = 128
DEPTH = 3


def distilled_to(model: DistilledSDF, device, dtype=None) -> DistilledSDF:
    """The model's tensors on `device` (and as `dtype`)."""
    def move(t):
        return t.to(device=device, dtype=dtype)

    return DistilledSDF(tuple(move(w) for w in model.weights),
                        tuple(move(b) for b in model.biases),
                        move(model.freqs), move(model.scale), move(model.clamp))


def sdf_compute_dtype():
    """The precision of the optimisers' SDF queries: torch.bfloat16 when the
    environment variable HOTRACK_SDF_BF16 is set to anything non-empty ("0"
    included), else None (float32-class), as in the JAX package. Read at
    each optimiser call (the JAX package reads it when it traces)."""
    return torch.bfloat16 if os.environ.get("HOTRACK_SDF_BF16") else None


def eval_distilled_sdf(model: DistilledSDF, points: torch.Tensor,
                       packed=None, compute_dtype=None) -> torch.Tensor:
    """points (..., 3) -> clamped sdf (...,). Gradient-free; a CUDA tensor
    runs the kernel of csrc/sdf_mlp.cu, a CPU tensor the plain version.
    compute_dtype: None (float32-class) or torch.bfloat16 (ops/sdf_mlp.py)."""
    return fused_sdf_mlp(model, points, packed, compute_dtype)


def eval_distilled_sdf_cf(model: DistilledSDF, points_cf: torch.Tensor,
                          packed=None, compute_dtype=None) -> torch.Tensor:
    """Channels-first variant: points_cf (..., 3, N) -> sdf (..., N)."""
    return fused_sdf_mlp_cf(model, points_cf, packed, compute_dtype)


def near_surface_indices(flat: torch.Tensor, clamp: float, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of voxels with |sdf| < 0.98 clamp (every other voxel
    keeps a weight of 1e-6): flat (V^3,) clamped sdf, u uniform in [0, 1) ->
    flat voxel indices on flat's device. The cumulative sum is float32, as in
    the JAX package; its rounding differs between frameworks, so draws agree
    exactly only on small volumes. It is taken on the host: a float32 scan on
    the card adds in an order that changes from run to run (2.98e-7 apart on
    a 201^3 volume, on an H100), which moved the draws, and so the fit,
    between two runs of one seed."""
    near_w = (torch.abs(flat) < clamp * 0.98).to(torch.float32).cpu() + 1e-6
    near_cdf = torch.cumsum(near_w / torch.sum(near_w), dim=0)
    idx = torch.searchsorted(near_cdf, u.cpu().to(near_cdf.dtype))  # first cdf >= u
    return torch.clamp(idx, 0, flat.shape[0] - 1).to(flat.device)


@spanned("sdf.distill")
def distill_sdf_volume(volume: torch.Tensor, voxel_scale: float,
                       generator: torch.Generator | None = None,
                       steps: int = 4000, batch: int = 8192,
                       clamp: float = 0.05, lr: float = 2e-3,
                       hidden: int | None = None, depth: int | None = None,
                       max_freqs: int | None = None, pool_batches: int = 64,
                       draws: dict | None = None) -> DistilledSDF:
    """Fit the MLP to a baked volume (V, V, V) at voxel_scale centred at 0,
    on the volume's device.

    Adam on continuous minibatches against the trilinear interpolant: half of
    each batch uniform in the cube, half near-surface voxels (inverse-CDF
    draw) jittered by +-1 voxel. Frequencies are capped at the grid's Nyquist.
    The learning rate halves after each third of the steps; Adam is written
    out in the JAX package's closed form (bias-corrected moments, eps outside
    the root).

    `pool_batches` > 0 draws the samples and their trilinear targets once, as
    a pool of pool_batches * batch points, and each step takes a random
    contiguous slice per half; 0 draws fresh samples every step.

    `draws` replaces the generator's numbers, key by key: 'init' (a tuple of
    standard-normal arrays, one per layer, (in, out)); 'pool_u', 'pool_n'
    ((pool_batches * batch // 2, 3) sample coordinates); 'offsets' ((steps, 2)
    slice starts); for pool_batches = 0, 'coords' ((steps, batch, 3)).
    """
    if steps < 3:
        # the JAX package divides by steps // 3 in the schedule
        raise ValueError(f"distill_sdf_volume needs steps >= 3, got {steps}")
    draws = draws or {}
    hidden = HIDDEN if hidden is None else hidden
    depth = DEPTH if depth is None else depth
    max_freqs = MAX_FREQS if max_freqs is None else max_freqs
    device = volume.device
    f32 = dict(dtype=torch.float32, device=device)
    gen_device = generator.device if generator is not None else device

    def rand(fn, shape):
        return fn(tuple(shape), generator=generator, dtype=torch.float32,
                  device=gen_device).to(device)

    def given(name):
        return torch.tensor(np.asarray(draws[name]), device=device)

    v = volume.shape[0]
    half = v // 2
    extent = half * voxel_scale
    n_freqs = min(max_freqs, max(2, int(math.log2(max(half / 2.0, 4.0))) + 1))
    freqs = torch.tensor(np.float32(np.pi) * 2.0 ** np.arange(n_freqs, dtype=np.float32), **f32)

    dims = [3 + 6 * n_freqs] + [hidden] * depth + [1]
    n_layers = len(dims) - 1
    if "init" in draws:
        init = [torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
                for a in draws["init"]]
    else:
        init = [rand(torch.randn, (dims[i], dims[i + 1])) for i in range(n_layers)]
    # a small head: start inside the clamp band
    weights = [init[i] * float(np.sqrt(np.float32(2.0 / dims[i])))
               * (0.01 if i == n_layers - 1 else 1.0) for i in range(n_layers)]
    biases = [torch.zeros(dims[i + 1], **f32) for i in range(n_layers)]
    scale = torch.tensor(1.0 / extent, **f32)
    clamp_t = torch.tensor(clamp, **f32)
    bbox_min = -half * voxel_scale
    flat = torch.clamp(volume.reshape(-1).to(torch.float32), -clamp, clamp)

    def draw_uniform(n):
        return (rand(torch.rand, (n, 3)) * 2.0 - 1.0) * extent

    def draw_near(n):
        idx = near_surface_indices(flat, clamp, rand(torch.rand, (n,)))
        centres = torch.stack([idx // (v * v) - half, (idx // v) % v - half,
                               idx % v - half], dim=-1).to(torch.float32) * voxel_scale
        return centres + (rand(torch.rand, (n, 3)) * 2.0 - 1.0) * voxel_scale

    def target_of(coords):
        return trilinear_sdf(volume, coords, voxel_scale, v, bbox_min=bbox_min,
                             clamp=clamp)

    hb = batch // 2
    pb = min(pool_batches, steps)
    if pb > 0:
        hp = pb * hb
        pool_u = given("pool_u").float() if "pool_u" in draws else draw_uniform(hp)
        pool_n = given("pool_n").float() if "pool_n" in draws else draw_near(hp)
        tgt_u, tgt_n = target_of(pool_u), target_of(pool_n)
        if "offsets" in draws:
            offsets = np.asarray(draws["offsets"]).astype(np.int64)
        else:
            offsets = torch.randint(0, hp - hb + 1, (steps, 2), generator=generator,
                                    device=gen_device).cpu().numpy()
    elif "coords" in draws:
        fresh = given("coords").float()

    params = [p.clone().requires_grad_(True) for p in weights + biases]
    m = [torch.zeros_like(p) for p in params]
    vv = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(steps):
        if pb > 0:
            o_u, o_n = int(offsets[i, 0]), int(offsets[i, 1])
            coords = torch.cat([pool_u[o_u:o_u + hb], pool_n[o_n:o_n + hb]])
            target = torch.cat([tgt_u[o_u:o_u + hb], tgt_n[o_n:o_n + hb]])
        else:
            coords = fresh[i] if "coords" in draws else torch.cat(
                [draw_uniform(hb), draw_near(hb)])
            target = target_of(coords)
        model = DistilledSDF(tuple(params[:n_layers]), tuple(params[n_layers:]),
                             freqs, scale, clamp_t)
        loss = torch.mean((_raw_sdf(model, coords) - target) ** 2)
        grads = torch.autograd.grad(loss, params)
        # host-side float32 scalars, as the JAX package computes them
        t = np.float32(i + 1)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        cur_lr = lr * 0.5 ** (i // (steps // 3))
        with torch.no_grad():
            for p, g, mm, vvv in zip(params, grads, m, vv):
                mm.mul_(b1).add_(g, alpha=1 - b1)
                vvv.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(cur_lr * (mm / c1) / (torch.sqrt(vvv / c2) + eps))
    params = [p.detach() for p in params]
    return DistilledSDF(tuple(params[:n_layers]), tuple(params[n_layers:]),
                        freqs, scale, clamp_t)
