"""Object tracking loop: per-frame SDF particle optimisation (port of
hotrack_tpu/track/obj.py:track_obj_sequence).

Per frame the gradient-free pose optimiser starts from the previous frame's
pose (the jittered ground truth on frame 0). The JAX package's `lax.scan` is
a Python loop here; nothing in it reads a device value, so the host runs
ahead of the card. The SDF volume is baked, and distilled, once per sequence.
"""

from __future__ import annotations

import torch

from ..opt.obj_pose import optimize_obj_pose
from ..ops.sdf_mlp import pack_distilled
from .types import ObjTrackResult


@torch.no_grad()
def track_obj_sequence(
    sdf_volume: torch.Tensor | None,  # (V, V, V); may be None with `distilled`
    presampled: torch.Tensor,         # (P, 6) particle bank
    obj_points: torch.Tensor,         # (T, N, 3) per-frame observed clouds
    init_rotation: torch.Tensor,      # (3, 3) jittered gt pose of frame 0
    init_translation: torch.Tensor,   # (3, 1)
    voxel_scale: float = 0.002,
    bbox_res: int = 201,
    distilled=None,                   # DistilledSDF (sdf/distill.py)
    obj_energy: str = "fused",
) -> ObjTrackResult:
    packed = None
    if distilled is not None and obj_points.is_cuda:
        packed = pack_distilled(distilled)  # once per sequence
    r, t = init_rotation, init_translation
    rs, ts, energies = [], [], []
    for pcld in obj_points:
        r, t, energy = optimize_obj_pose(
            sdf_volume, presampled, pcld, r, t, voxel_scale=voxel_scale,
            bbox_res=bbox_res, distilled=distilled, obj_energy=obj_energy,
            packed=packed)
        rs.append(r), ts.append(t), energies.append(energy)
    return ObjTrackResult(rotation=torch.stack(rs), translation=torch.stack(ts),
                          sdf_energy=torch.stack(energies))
