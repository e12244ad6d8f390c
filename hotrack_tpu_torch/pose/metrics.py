"""Symmetry-aware pose-error metrics (port of hotrack_tpu/pose/metrics.py).

`axis` is the object's symmetry class at evaluation (from the data configs):
0/1/2 = continuous rotational symmetry about that column axis (angle between
the axis columns, optionally up/down symmetric); 3 = box 4-fold symmetry (min
over 4 flips); -1 = bottle 2-fold (min over identity and the xz flip);
anything else = the full SO(3) geodesic distance.
"""

from __future__ import annotations

import torch


def _geodesic(rot1, rot2, pre=None):
    r1 = rot1 if pre is None else torch.matmul(rot1, pre)
    mat_diff = torch.matmul(r1, rot2.transpose(-1, -2))
    diff = mat_diff[..., 0, 0] + mat_diff[..., 1, 1] + mat_diff[..., 2, 2]
    return torch.arccos(torch.clamp((diff - 1.0) / 2.0, -1.0, 1.0))


def _flip(i, j, like: torch.Tensor) -> torch.Tensor:
    d = torch.ones(3, dtype=like.dtype, device=like.device)
    d[i] = -1.0
    d[j] = -1.0
    return torch.diag(d)


def rot_diff_rad(rot1: torch.Tensor, rot2: torch.Tensor, axis: int,
                 up_and_down_sym: bool = False) -> torch.Tensor:
    """Rotation error in radians under symmetry class `axis`."""
    if 0 <= axis <= 2:
        diff = torch.clamp(torch.sum(rot1[..., axis] * rot2[..., axis], dim=-1),
                           -1.0, 1.0)
        if up_and_down_sym:
            diff = torch.abs(diff)
        return torch.arccos(diff)
    if axis == 3:  # box: identity + xy/xz/yz flips
        flips = ((0, 1), (0, 2), (1, 2))
    elif axis == -1:  # bottle: identity + xz flip
        flips = ((0, 2),)
    else:
        return _geodesic(rot1, rot2)
    cands = [_geodesic(rot1, rot2)]
    cands += [_geodesic(rot1, rot2, _flip(i, j, rot1)) for i, j in flips]
    return torch.min(torch.stack(cands, dim=-1), dim=-1).values


def rot_diff_degree(rot1, rot2, axis, up_and_down_sym=False):
    return rot_diff_rad(rot1, rot2, axis, up_and_down_sym) / torch.pi * 180.0


def trans_diff(trans1: torch.Tensor, trans2: torch.Tensor) -> torch.Tensor:
    """L2 translation error."""
    return torch.linalg.norm(trans1 - trans2, dim=-1)


def scale_diff(scale1, scale2):
    return torch.abs(scale1 - scale2)


def theta_diff(theta1, theta2):
    return torch.abs(theta1 - theta2)
