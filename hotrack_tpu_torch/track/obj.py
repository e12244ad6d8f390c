"""Object tracking loop: per-frame SDF particle optimisation (port of
hotrack_tpu/track/obj.py:track_obj_sequence and
track_obj_sequences_batched).

Per frame the gradient-free pose optimiser starts from the previous frame's
pose (the jittered ground truth on frame 0). The JAX package's `lax.scan` is
a Python loop here; nothing in it reads a device value, so the host runs
ahead of the card. The SDF volume is baked, and distilled, once per sequence.
Several sequences of equal length go through one loop with a leading
sequence axis (the JAX package's `vmap` of the per-sequence scan).
"""

from __future__ import annotations

import torch

from ..opt.obj_pose import optimize_obj_pose
from ..ops.sdf_mlp import pack_distilled, pack_distilled_batched
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


@torch.no_grad()
def track_obj_sequences_batched(
    sdf_volumes: torch.Tensor | None,  # (S, V, V, V); may be None with `distilled`
    presampled: torch.Tensor,          # (P, 6) particle bank, shared
    obj_points: torch.Tensor,          # (S, T, N, 3) per-sequence, per-frame clouds
    init_rotations: torch.Tensor,      # (S, 3, 3)
    init_translations: torch.Tensor,   # (S, 3, 1)
    voxel_scale: float = 0.002,
    bbox_res: int = 201,
    distilled=None,                    # a list of S DistilledSDF
    obj_energy: str = "fused",
) -> ObjTrackResult:
    """S sequences of T frames in one frame loop: every frame one call of the
    optimiser over (S, N, 3) clouds, each sequence with its own volume or
    model; on the card the batched kernels (#4b fused, #3b composed).
    Returns rotation (S, T, 3, 3), translation (S, T, 3, 1), sdf_energy
    (S, T)."""
    if distilled is not None and len(distilled) != obj_points.shape[0]:
        raise ValueError(f"{len(distilled)} models for {obj_points.shape[0]} sequences")
    packed = None
    if distilled is not None and obj_points.is_cuda:
        packed = pack_distilled_batched(distilled)  # once per chunk of sequences
    r, t = init_rotations, init_translations
    rs, ts, energies = [], [], []
    for f in range(obj_points.shape[1]):
        r, t, energy = optimize_obj_pose(
            sdf_volumes, presampled, obj_points[:, f], r, t, voxel_scale=voxel_scale,
            bbox_res=bbox_res, distilled=distilled, obj_energy=obj_energy, packed=packed)
        rs.append(r), ts.append(t), energies.append(energy)
    return ObjTrackResult(rotation=torch.stack(rs, 1), translation=torch.stack(ts, 1),
                          sdf_energy=torch.stack(energies, 1))
