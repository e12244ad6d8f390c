"""SDF volume baking and lookup (port of hotrack_tpu/sdf/volume.py).

- `volume_coords`: a cube of size^3 voxel centres at `voxel_scale` spacing,
  (index - size // 2) * scale, xyz-major.
- `bake_sdf_volume`: chunked decoder queries over the grid, divided by the
  DeepSDF normalisation scale.
- `trilinear_sdf`: the reference's `Distance` interpolation with its clamp to
  +-0.05, including its oddities: grid coordinates are truncated to int (not
  floored; they are clipped to >= 0 first), and at the upper boundary the
  neighbour indices are clamped into the *flattened* array, not per axis.
- `nearest_sdf`: the hand optimiser's floor-divide nearest-voxel lookup.

All lookups are gathers on the tensor's device; none carries a gradient to
the points.
"""

from __future__ import annotations

import torch


def volume_coords(size: int, voxel_scale: float, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """(size^3, 3) voxel-centre coordinates, xyz-major."""
    r = (torch.arange(size, device=device) - size // 2).to(dtype) * voxel_scale
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


@torch.no_grad()
def bake_sdf_volume(decoder, latent_code: torch.Tensor, coords: torch.Tensor,
                    size: int, norm_scale: float, chunk: int = 1 << 18) -> torch.Tensor:
    """Decode the SDF over a coordinate grid -> (size, size, size) volume.
    `decoder` maps (n, latent + 3) -> (n, 1); `coords` (size^3, 3) are
    instance-frame points. Chunked to bound peak memory."""
    latent = latent_code.reshape(1, -1)
    parts = []
    for start in range(0, coords.shape[0], chunk):
        xyz = coords[start:start + chunk]
        inp = torch.cat([latent.expand(xyz.shape[0], -1), xyz], dim=-1)
        parts.append(decoder(inp)[..., 0])
    return (torch.cat(parts) / norm_scale).reshape(size, size, size)


def trilinear_sdf(volume: torch.Tensor, points: torch.Tensor,
                  voxel_scale: float = 0.002, bbox_res: int = 201,
                  bbox_min: float = -0.2, clamp: float = 0.05) -> torch.Tensor:
    """Trilinearly interpolated SDF lookup, clamped to [-clamp, clamp].
    points (..., 3) in the volume's frame -> (...,)."""
    flat = volume.reshape(-1)
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    g = torch.clamp((p - bbox_min) / voxel_scale, 0.0, bbox_res - 1.0)
    idx = g.to(torch.int64)  # truncation; g >= 0
    frac = g - idx.to(g.dtype)
    x, y, z = frac[:, 0], frac[:, 1], frac[:, 2]
    i000 = (idx[:, 0] * bbox_res + idx[:, 1]) * bbox_res + idx[:, 2]
    nmax = flat.shape[0] - 1

    def take(i):
        return flat[torch.clamp(i, 0, nmax)]

    r2 = bbox_res * bbox_res
    c00 = take(i000) * (1 - z) + take(i000 + 1) * z
    c01 = take(i000 + bbox_res) * (1 - z) + take(i000 + bbox_res + 1) * z
    c10 = take(i000 + r2) * (1 - z) + take(i000 + r2 + 1) * z
    c11 = take(i000 + r2 + bbox_res) * (1 - z) + take(i000 + r2 + bbox_res + 1) * z
    d = (c00 * (1 - y) + c01 * y) * (1 - x) + (c10 * (1 - y) + c11 * y) * x
    return torch.clamp(d, -clamp, clamp).reshape(shape)


def nearest_sdf(volume: torch.Tensor, points: torch.Tensor,
                voxel_scale: float = 0.003, volume_size: int = 151) -> torch.Tensor:
    """Nearest-voxel SDF lookup with the reference's floor-divide binning
    (point // scale, clamped to the cube). points (..., 3) -> (...,)."""
    half = volume_size // 2
    shape = points.shape[:-1]
    p = points.reshape(-1, 3)
    ind = torch.clamp(torch.floor(p / voxel_scale), -half, half).to(torch.int64) + half
    return volume[ind[:, 0], ind[:, 1], ind[:, 2]].reshape(shape)
