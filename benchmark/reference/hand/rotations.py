"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/pose/rotations.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

Rotation-representation conversions.

Port of hotrack_tpu/pose/rotations.py: quaternions are (w, x, y, z);
`matrix_to_unit_quaternion` uses the trace branch only, like the reference.
Arbitrary leading batch dimensions. The random functions take an explicit
`torch.Generator` and, like `data.pipeline.jitter_hand_kp`, an injectable
unit draw, so a test can feed both packages the same numbers.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + EPS)


def unit_quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(.., 4) unit quaternion -> (.., 3, 3) rotation."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
            2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
            2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y,
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_unit_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(.., 3, 3) rotation -> (.., 4) quaternion (trace branch with eps)."""
    trace = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    r = torch.sqrt(torch.clamp(trace, min=0.0))
    s = 1.0 / (2.0 * r + 1e-7)
    w = 0.5 * r
    x = (m[..., 2, 1] - m[..., 1, 2]) * s
    y = (m[..., 0, 2] - m[..., 2, 0]) * s
    z = (m[..., 1, 0] - m[..., 0, 1]) * s
    return normalize_quat(torch.stack([w, x, y, z], dim=-1))


def quater_to_axis_theta(q: torch.Tensor):
    """quaternion -> (axis, theta)."""
    q = normalize_quat(q)
    cosa = q[..., 0]
    norm = torch.sqrt(torch.clamp(1.0 - cosa**2, min=0.0))[..., None]
    mask = (norm < 1e-8).to(q.dtype)
    axis = q[..., 1:] / torch.maximum(norm, mask)
    theta = 2.0 * torch.arccos(torch.clamp(cosa, -1.0, 1.0))
    return axis, theta


def mano_quat2axisang(quat: torch.Tensor) -> torch.Tensor:
    """(.., 4K) quaternions -> (.., 3K) axis-angle."""
    lead = quat.shape[:-1]
    axis, theta = quater_to_axis_theta(quat.reshape(*lead, -1, 4))
    return (axis * theta[..., None]).reshape(*lead, -1)


def normalize_vector(v: torch.Tensor) -> torch.Tensor:
    """Safe normalise along the last axis; [1, 0, 0] for ~zero vectors."""
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    valid = (mag > EPS).to(v.dtype)
    backup = torch.zeros_like(v)
    backup[..., 0] = 1.0
    out = v / torch.clamp(mag, min=EPS)
    return out * valid + backup * (1.0 - valid)


def compute_rotation_matrix_from_ortho6d(poses: torch.Tensor) -> torch.Tensor:
    """(.., 6) -> (.., 3, 3) via Gram-Schmidt; columns = (x, y, z)."""
    x = normalize_vector(poses[..., 0:3])
    z = normalize_vector(torch.linalg.cross(x, poses[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


