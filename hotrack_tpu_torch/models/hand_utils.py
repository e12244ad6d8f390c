"""Hand-frame canonicalisation utilities.

Port of hotrack_tpu/models/hand_utils.py.
canonicalize/decanonicalize are channels-last: points (B, N, 3).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..mano.model import PALM_KP_IDS
from ..pose.procrustes import solve_rot_and_trans, solve_rot_and_trans_fast
from ..pose.rotations import matrix_to_rotvec, noisy_rot_matrix, unit_draw


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


def obb_frame(points: torch.Tensor) -> CanonPose:
    """Oriented-bounding-box canonical frame via PCA: points (B, N, 3) ->
    CanonPose with R = principal axes (max eigenvalue as x, min as z, y by
    cross product), scale = 1.2 * x-extent, and the translation that centres
    the normalised cloud. Eigenvector signs are the solver's (as in the JAX
    package); R^T (X - T) / s is defined up to those signs."""
    trans = torch.mean(points, dim=-2, keepdim=True)  # (B, 1, 3)
    x = points - trans
    n = points.shape[-2]
    c = torch.matmul(x.transpose(-1, -2), x) / (n - 1)
    _, eigvecs = torch.linalg.eigh(c)  # ascending eigenvalues
    r0 = eigvecs[..., :, 2]
    r2 = eigvecs[..., :, 0]
    r1 = torch.linalg.cross(r2, r0, dim=-1)
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True)
    r = torch.stack([r0, r1, r2], dim=-1)  # columns

    rotated = torch.matmul(x, r)
    bbox_len = 1.2 * (torch.amax(rotated, dim=-2) - torch.amin(rotated, dim=-2))
    scale = bbox_len[..., 0]
    t_local = torch.mean(rotated / scale[..., None, None], dim=-2)  # (B, 3)
    translation = trans.transpose(-1, -2) + torch.matmul(
        r, t_local[..., None]) * scale[..., None, None]
    return CanonPose(rotation=r, translation=translation, scale=scale)


# parent of each of the 21 keypoints along the skeleton; the wrist is its own
KP_PARENT = (0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19)


def kp_bones(kp: torch.Tensor) -> torch.Tensor:
    """Parent-relative bone vectors: kp (B, 21, 3) -> (B, 21, 3)."""
    return kp - kp[:, list(KP_PARENT), :]


def kp2bone_lengths(kp: torch.Tensor) -> torch.Tensor:
    """Lengths of the 20 real bones: kp (..., 21, 3) -> (..., 20)."""
    bones = kp[..., 1:, :] - kp[..., list(KP_PARENT)[1:], :]
    return torch.linalg.norm(bones, dim=-1)


def jitter_hand_mano(rot_mat: torch.Tensor, theta: torch.Tensor, trans: torch.Tensor,
                     beta: torch.Tensor, cfg: dict, generator: torch.Generator | None = None,
                     draws: dict | None = None):
    """Jitter full MANO parameters: the global rotation by noise of
    cfg['global_rotation'] rad, the translation and beta by normal noise of
    cfg['global_translation'] and cfg['beta'], the 15 joints' axis-angles
    by per-axis stds cfg['x'], cfg['y'], cfg['z']. Returns (noisy_mano (48,),
    trans (3,), beta (10,)). Drawn in that order from the generator, or from
    `draws`: {'rotation': (angle, quaternion) unit draws, 'trans', 'beta',
    'theta': standard normals of those shapes}."""
    draws = draws or {}
    noisy_aa = matrix_to_rotvec(noisy_rot_matrix(rot_mat, cfg["global_rotation"],
                                                 generator=generator,
                                                 draws=draws.get("rotation")))
    new_trans = trans + unit_draw(trans.shape, "normal", trans, generator,
                                  draws.get("trans")) * cfg["global_translation"]
    new_beta = beta + unit_draw(beta.shape, "normal", beta, generator,
                                draws.get("beta")) * cfg["beta"]
    scale = torch.tensor([cfg["x"], cfg["y"], cfg["z"]], dtype=theta.dtype,
                         device=theta.device).repeat(15)
    new_theta = theta + unit_draw(theta.shape, "normal", theta, generator,
                                  draws.get("theta")) * scale
    return torch.cat([noisy_aa, new_theta], -1), new_trans, new_beta
