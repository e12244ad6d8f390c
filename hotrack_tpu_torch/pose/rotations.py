"""Rotation-representation conversions (the part the tracking slice uses).

Port of hotrack_tpu/pose/rotations.py: quaternions are (w, x, y, z);
`matrix_to_unit_quaternion` uses the trace branch only, like the reference.
Arbitrary leading batch dimensions.
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


def axis_theta_to_quater(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """axis (.., 3), theta (..,) -> quaternion."""
    w = torch.cos(theta / 2.0)
    u = torch.sin(theta / 2.0)
    xyz = axis * u[..., None]
    return normalize_quat(torch.cat([w[..., None], xyz], dim=-1))


def axis_theta_to_matrix(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return unit_quaternion_to_matrix(axis_theta_to_quater(axis, theta))


def rotvec_to_axis_theta(rotvec: torch.Tensor):
    """(.., 3) rotation vector -> (axis, theta)."""
    theta = torch.linalg.norm(rotvec, dim=-1, keepdim=True)
    mask = (theta < 1e-8).to(rotvec.dtype)
    axis = rotvec / torch.maximum(theta, mask)
    return axis, theta[..., 0]


def rotvec_to_matrix(rotvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (.., 3) rotation vector -> (.., 3, 3)."""
    axis, theta = rotvec_to_axis_theta(rotvec)
    return axis_theta_to_matrix(axis, theta)
