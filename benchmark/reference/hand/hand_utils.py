"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/models/hand_utils.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

Hand-frame canonicalisation utilities.

Port of hotrack_tpu/models/hand_utils.py.
canonicalize/decanonicalize are channels-last: points (B, N, 3).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .mano_model import PALM_KP_IDS
from .procrustes import solve_rot_and_trans, solve_rot_and_trans_fast


class CanonPose(NamedTuple):
    """Hand-frame pose: camera = s * R @ handframe + t."""

    rotation: torch.Tensor     # (B, 3, 3)
    translation: torch.Tensor  # (B, 3, 1)
    scale: torch.Tensor        # (1,) or (B,)


def handkp2palmkp(kp: torch.Tensor) -> torch.Tensor:
    """The 6 palm keypoints [wrist + 5 MCPs] of 21-kp hands (B, 21, 3)."""
    if kp.shape[-2] == 21:
        return kp[..., list(PALM_KP_IDS), :]
    if kp.shape[-2] == 29:
        return kp[..., [0, 1, 5, 6, 7, 11, 12, 13, 17, 18, 19, 23, 24, 25], :]
    raise NotImplementedError(f"unsupported kp count {kp.shape[-2]}")


def solve_hand_frame(palm_template: torch.Tensor, kp: torch.Tensor,
                     scale: float = 0.2, solver: str | None = None) -> CanonPose:
    """Procrustes of the palm template (6, 3) or (B, 6, 3) against the palm
    keypoints of kp (B, 21, 3). `solver`: 'svd', 'horn', or None/'auto' for
    Horn unless HOTRACK_EXACT_PROCRUSTES=1 selects SVD. Train and eval must
    use the same solver."""
    if solver in (None, "auto"):
        solver = "svd" if os.environ.get("HOTRACK_EXACT_PROCRUSTES") else "horn"
    if solver == "svd":
        fn = solve_rot_and_trans
    elif solver == "horn":
        fn = solve_rot_and_trans_fast
    else:
        raise ValueError(f"unknown procrustes solver {solver!r}")
    rotation, translation = fn(palm_template, handkp2palmkp(kp))
    return CanonPose(rotation=rotation, translation=translation,
                     scale=torch.full((1,), scale, dtype=kp.dtype, device=kp.device))


def camera_frame(batch: int, dtype=torch.float32, device=None,
                 scale: float = 0.2) -> CanonPose:
    """Identity canonicalisation (handframe='camera')."""
    return CanonPose(
        rotation=torch.eye(3, dtype=dtype, device=device).expand(batch, 3, 3),
        translation=torch.zeros((batch, 3, 1), dtype=dtype, device=device),
        scale=torch.full((1,), scale, dtype=dtype, device=device))


def _scale_col(pose: CanonPose) -> torch.Tensor:
    return pose.scale.reshape(-1)[:, None, None]


def canonicalize(points: torch.Tensor, pose: CanonPose) -> torch.Tensor:
    """camera -> hand frame: R^T (x - t) / s, on rows."""
    t = pose.translation.transpose(-1, -2)  # (B, 1, 3)
    return torch.matmul(points - t, pose.rotation) / _scale_col(pose)


def decanonicalize(points: torch.Tensor, pose: CanonPose) -> torch.Tensor:
    """hand -> camera frame: s * R x + t."""
    t = pose.translation.transpose(-1, -2)
    return _scale_col(pose) * torch.matmul(points, pose.rotation.transpose(-1, -2)) + t


# parent of each of the 21 keypoints along the skeleton; the wrist is its own
KP_PARENT = (0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19)


def kp_bones(kp: torch.Tensor) -> torch.Tensor:
    """Parent-relative bone vectors: kp (B, 21, 3) -> (B, 21, 3)."""
    return kp - kp[:, list(KP_PARENT), :]


