"""Plain reference of the distilled SDF: the box volume, its trilinear
lookup, the Fourier-feature MLP and its distillation, in float32 PyTorch on
whatever device the inputs are on. A frozen copy of the semantics of
hotrack_tpu_torch's plain versions (`sdf/volume.trilinear_sdf`,
`sdf/distill.distill_sdf_volume`, `ops/sdf_mlp.raw_sdf_mlp`) as of the
benchmark's first version; it imports nothing of the port, and TF32 must be
off (`reference.plain_float32`).

The distillation draws from a generator in the same order as the port's, so
that a generator seeded alike gives the same samples on both sides.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class MLP(NamedTuple):
    weights: tuple   # ((in, h), ..., (h, 1))
    biases: tuple
    freqs: torch.Tensor
    scale: torch.Tensor
    clamp: torch.Tensor


def box_volume(size: int, voxel_scale: float, half, device=None) -> torch.Tensor:
    """Analytic SDF of a box of half-extents `half` centred at 0, sampled at
    the size^3 voxel centres (index - size // 2) * voxel_scale, xyz-major."""
    r = (torch.arange(size, device=device) - size // 2).to(torch.float32) * voxel_scale
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    c = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    q = torch.abs(c) - torch.tensor(half, dtype=torch.float32, device=c.device)
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
    return (outside + inside).reshape(size, size, size)


def trilinear(volume: torch.Tensor, points: torch.Tensor, voxel_scale: float,
              res: int, bbox_min: float, clamp: float = 0.05) -> torch.Tensor:
    """Trilinear lookup with the tracker's conventions: grid coordinates
    clipped to [0, res - 1] and truncated, neighbours clamped into the
    flattened volume, the result clamped to +-clamp."""
    flat = volume.reshape(-1)
    shape = points.shape[:-1]
    g = torch.clamp((points.reshape(-1, 3) - bbox_min) / voxel_scale, 0.0, res - 1.0)
    idx = g.to(torch.int64)
    frac = g - idx.to(g.dtype)
    x, y, z = frac[:, 0], frac[:, 1], frac[:, 2]
    i000 = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    nmax = flat.shape[0] - 1

    def take(i):
        return flat[torch.clamp(i, 0, nmax)]

    r2 = res * res
    c00 = take(i000) * (1 - z) + take(i000 + 1) * z
    c01 = take(i000 + res) * (1 - z) + take(i000 + res + 1) * z
    c10 = take(i000 + r2) * (1 - z) + take(i000 + r2 + 1) * z
    c11 = take(i000 + r2 + res) * (1 - z) + take(i000 + r2 + res + 1) * z
    d = (c00 * (1 - y) + c01 * y) * (1 - x) + (c10 * (1 - y) + c11 * y) * x
    return torch.clamp(d, -clamp, clamp).reshape(shape)


def features(points: torch.Tensor, freqs: torch.Tensor, scale) -> torch.Tensor:
    """(..., 3) -> (..., 3 + 6F): x | sin (axis-major, frequency-minor) | cos."""
    x = points * scale
    ang = x[..., None] * freqs
    lead = x.shape[:-1]
    return torch.cat([x, torch.sin(ang).reshape(*lead, -1),
                      torch.cos(ang).reshape(*lead, -1)], dim=-1)


def raw_mlp(model: MLP, points: torch.Tensor) -> torch.Tensor:
    """Unclamped MLP output (...,)."""
    h = features(points, model.freqs, model.scale)
    last = len(model.weights) - 1
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        h = torch.matmul(h, w) + b
        if i < last:
            h = torch.relu(h)
    return h[..., 0]


@torch.no_grad()
def sdf(model: MLP, points: torch.Tensor, chunk: int = 1 << 18):
    """Clamped SDF at points (..., 3), `chunk` points a pass."""
    flat = points.reshape(-1, 3)
    out = torch.cat([raw_mlp(model, flat[i:i + chunk])
                     for i in range(0, flat.shape[0], chunk)])
    return torch.clamp(out, -model.clamp, model.clamp).reshape(points.shape[:-1])


def distill(volume: torch.Tensor, voxel_scale: float, generator: torch.Generator,
            steps: int = 4000, batch: int = 8192, clamp: float = 0.05, lr: float = 2e-3,
            hidden: int = 128, depth: int = 3, max_freqs: int = 3,
            pool_batches: int = 64) -> MLP:
    """Fit the MLP to the volume: Adam (bias-corrected, eps outside the root)
    on slices of a pool of samples, half uniform in the cube and half drawn
    near the surface (inverse CDF over voxels with |sdf| < 0.98 clamp, every
    other voxel at weight 1e-6, jittered by +-1 voxel), against the
    trilinear interpolant; the rate halves after each third of the steps."""
    device = volume.device
    gen_device = generator.device
    f32 = dict(dtype=torch.float32, device=device)

    def rand(fn, shape):
        return fn(tuple(shape), generator=generator, dtype=torch.float32,
                  device=gen_device).to(device)

    v = volume.shape[0]
    half = v // 2
    extent = half * voxel_scale
    n_freqs = min(max_freqs, max(2, int(math.log2(max(half / 2.0, 4.0))) + 1))
    freqs = torch.tensor(np.float32(np.pi) * 2.0 ** np.arange(n_freqs, dtype=np.float32), **f32)
    dims = [3 + 6 * n_freqs] + [hidden] * depth + [1]
    n_layers = len(dims) - 1
    init = [rand(torch.randn, (dims[i], dims[i + 1])) for i in range(n_layers)]
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
        u = rand(torch.rand, (n,))
        near_w = (torch.abs(flat) < clamp * 0.98).to(torch.float32).cpu() + 1e-6
        cdf = torch.cumsum(near_w / torch.sum(near_w), dim=0)
        idx = torch.clamp(torch.searchsorted(cdf, u.cpu()), 0, flat.shape[0] - 1).to(device)
        centres = torch.stack([idx // (v * v) - half, (idx // v) % v - half,
                               idx % v - half], dim=-1).to(torch.float32) * voxel_scale
        return centres + (rand(torch.rand, (n, 3)) * 2.0 - 1.0) * voxel_scale

    hb = batch // 2
    hp = min(pool_batches, steps) * hb
    pool_u, pool_n = draw_uniform(hp), draw_near(hp)
    tgt_u = trilinear(volume, pool_u, voxel_scale, v, bbox_min, clamp)
    tgt_n = trilinear(volume, pool_n, voxel_scale, v, bbox_min, clamp)
    offsets = torch.randint(0, hp - hb + 1, (steps, 2), generator=generator,
                            device=gen_device).cpu().numpy()

    params = [p.clone().requires_grad_(True) for p in weights + biases]
    m = [torch.zeros_like(p) for p in params]
    vv = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(steps):
        o_u, o_n = int(offsets[i, 0]), int(offsets[i, 1])
        coords = torch.cat([pool_u[o_u:o_u + hb], pool_n[o_n:o_n + hb]])
        target = torch.cat([tgt_u[o_u:o_u + hb], tgt_n[o_n:o_n + hb]])
        model = MLP(tuple(params[:n_layers]), tuple(params[n_layers:]), freqs, scale, clamp_t)
        loss = torch.mean((raw_mlp(model, coords) - target) ** 2)
        grads = torch.autograd.grad(loss, params)
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
    return MLP(tuple(params[:n_layers]), tuple(params[n_layers:]), freqs, scale, clamp_t)
