"""Rotation-representation conversions.

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


def quat_multiply(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, v1 = q[..., :1], q[..., 1:]
    w2, v2 = r[..., :1], r[..., 1:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w, v], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (.., 3) by unit quaternions q (.., 4)."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_multiply(quat_multiply(q, qv), quat_conjugate(q))[..., 1:]


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


def quater_to_axis_theta(q: torch.Tensor):
    """quaternion -> (axis, theta)."""
    q = normalize_quat(q)
    cosa = q[..., 0]
    norm = torch.sqrt(torch.clamp(1.0 - cosa**2, min=0.0))[..., None]
    mask = (norm < 1e-8).to(q.dtype)
    axis = q[..., 1:] / torch.maximum(norm, mask)
    theta = 2.0 * torch.arccos(torch.clamp(cosa, -1.0, 1.0))
    return axis, theta


def axis_theta_to_matrix(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return unit_quaternion_to_matrix(axis_theta_to_quater(axis, theta))


def matrix_to_axis_theta(m: torch.Tensor):
    return quater_to_axis_theta(matrix_to_unit_quaternion(m))


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


def matrix_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    axis, theta = quater_to_axis_theta(matrix_to_unit_quaternion(m))
    return axis * theta[..., None]


def mano_axisang2quat(axisang: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(.., 3K) axis-angle blocks -> (.., 4K) quaternions (the reference's
    epsilon-regularised axis)."""
    lead = axisang.shape[:-1]
    aa = axisang.reshape(*lead, -1, 3)
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    q = axis_theta_to_quater(aa / (theta + eps), theta[..., 0])
    return q.reshape(*lead, -1)


def mano_quat2axisang(quat: torch.Tensor) -> torch.Tensor:
    """(.., 4K) quaternions -> (.., 3K) axis-angle."""
    lead = quat.shape[:-1]
    axis, theta = quater_to_axis_theta(quat.reshape(*lead, -1, 4))
    return (axis * theta[..., None]).reshape(*lead, -1)


def rot_diff_rad(rot1: torch.Tensor, rot2: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation distance in radians."""
    mat_diff = torch.matmul(rot1, rot2.transpose(-1, -2))
    diff = mat_diff[..., 0, 0] + mat_diff[..., 1, 1] + mat_diff[..., 2, 2]
    return torch.arccos(torch.clamp((diff - 1.0) / 2.0, -1.0, 1.0))


def rot_diff_degree(rot1: torch.Tensor, rot2: torch.Tensor) -> torch.Tensor:
    return rot_diff_rad(rot1, rot2) / torch.pi * 180.0


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


def rotvec_to_euler(rotvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> (heading, attitude, bank) euler angles, with the
    gimbal-lock branches beyond +-0.998."""
    axis, theta = rotvec_to_axis_theta(rotvec)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    s, c = torch.sin(theta), torch.cos(theta)
    t = 1.0 - c
    lock = x * y * t + z * s
    heading_l = 2.0 * torch.arctan2(x * torch.sin(theta / 2.0), torch.cos(theta / 2.0))
    half_pi = torch.full_like(heading_l, torch.pi / 2.0)
    zero = torch.zeros_like(heading_l)
    euler_n = torch.stack([heading_l, half_pi, zero], dim=-1)
    euler_s = torch.stack([-heading_l, -half_pi, zero], dim=-1)
    heading = torch.arctan2(y * s - x * z * t, 1.0 - (y * y + z * z) * t)
    attitude = torch.arcsin(torch.clamp(lock, -1.0, 1.0))
    bank = torch.arctan2(x * s - y * z * t, 1.0 - (x * x + z * z) * t)
    euler = torch.stack([heading, attitude, bank], dim=-1)
    return torch.where((lock > 0.998)[..., None], euler_n,
                       torch.where((lock < -0.998)[..., None], euler_s, euler))


def euler_to_rotvec(euler: torch.Tensor) -> torch.Tensor:
    """(heading, attitude, bank) euler angles -> rotation vector."""
    heading, attitude, bank = euler[..., 0], euler[..., 1], euler[..., 2]
    c1, s1 = torch.cos(heading / 2.0), torch.sin(heading / 2.0)
    c2, s2 = torch.cos(attitude / 2.0), torch.sin(attitude / 2.0)
    c3, s3 = torch.cos(bank / 2.0), torch.sin(bank / 2.0)
    w = c1 * c2 * c3 - s1 * s2 * s3
    xyz = torch.stack([c1 * c2 * s3 + s1 * s2 * c3, s1 * c2 * c3 + c1 * s2 * s3,
                       c1 * s2 * c3 - s1 * c2 * s3], dim=-1)
    angle = 2.0 * torch.arccos(torch.clamp(w, -1.0, 1.0))
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    degenerate = (norm < 1e-8).to(euler.dtype)
    axis = xyz / torch.maximum(norm, degenerate)
    unit_x = torch.zeros_like(axis)
    unit_x[..., 0] = 1.0
    axis = degenerate * unit_x + (1.0 - degenerate) * axis
    return axis * angle[..., None]


def compute_rotation_matrix_from_3d(vec: torch.Tensor) -> torch.Tensor:
    """(.., 3) direction -> (.., 3, 3) with the normalised vector as the
    middle column (y axis), completed by x = [1, 0, 0] cross products: the
    rotation head for axially symmetric parts."""
    y = normalize_vector(vec)
    x_raw = torch.zeros_like(y)
    x_raw[..., 0] = 1.0
    z = normalize_vector(torch.linalg.cross(x_raw, y, dim=-1))
    x = torch.linalg.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def compute_rotation_matrix_from_9d(m: torch.Tensor) -> torch.Tensor:
    """Symmetric orthogonalisation of (.., 3, 3) onto SO(3) via SVD."""
    u, _, vh = torch.linalg.svd(m, full_matrices=False)
    det = torch.linalg.det(torch.matmul(u, vh))
    vh = torch.cat([vh[..., :2, :], vh[..., 2:, :] * det[..., None, None]], dim=-2)
    return torch.matmul(u, vh)


def unit_draw(shape, kind: str, like: torch.Tensor,
              generator: torch.Generator | None = None,
              draw: torch.Tensor | None = None) -> torch.Tensor:
    """The unit random draw behind every jitter: a standard normal
    (kind='normal') or uniform in [0, 1) ('uniform'), of `like`'s dtype, made
    on the generator's device (so a host generator gives the same numbers on
    every device) and moved to `like`'s. `draw` replaces it."""
    if draw is None:
        if kind not in ("normal", "uniform"):
            raise ValueError(kind)
        fn = torch.rand if kind == "uniform" else torch.randn
        draw = fn(tuple(shape), generator=generator, dtype=like.dtype,
                  device=generator.device if generator is not None else like.device)
    return draw.to(device=like.device, dtype=like.dtype)


def generate_random_quaternion(shape, like: torch.Tensor,
                               generator: torch.Generator | None = None,
                               draw: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform random unit quaternions: a normalised standard-normal draw."""
    return normalize_quat(unit_draw(shape, "normal", like, generator, draw))


def jitter_quaternion(q: torch.Tensor, theta: torch.Tensor,
                      generator: torch.Generator | None = None,
                      draw: torch.Tensor | None = None) -> torch.Tensor:
    """Perturb q by angle theta (shape q.shape[:-1] + (1,)) toward a random
    orthogonal quaternion."""
    new_q = generate_random_quaternion(q.shape, q, generator, draw)
    dot = torch.sum(q * new_q, dim=-1, keepdim=True)
    q_orth = normalize_quat(new_q - q * dot)
    return q * torch.cos(theta / 2.0) + q_orth * torch.sin(theta / 2.0)


def noisy_rot_matrix(matrix: torch.Tensor, rad, kind: str = "normal",
                     generator: torch.Generator | None = None,
                     draws: tuple | None = None) -> torch.Tensor:
    """Random rotation noise of scale `rad` on (.., 3, 3) rotations. `draws`
    = (angle draw of shape matrix.shape[:-2], quaternion draw (.., 4))
    replaces the generator's."""
    d_theta, d_quat = draws if draws is not None else (None, None)
    base = matrix[..., 0, 0]
    u = unit_draw(base.shape, kind, matrix, generator, d_theta)
    theta = (torch.abs(u) if kind == "normal" else u) * rad
    quat = matrix_to_unit_quaternion(matrix)
    return unit_quaternion_to_matrix(
        jitter_quaternion(quat, theta[..., None], generator, d_quat))


def rotate_around_point(points: torch.Tensor, rotation: torch.Tensor,
                        pivot: torch.Tensor) -> torch.Tensor:
    """Rotate point sets (.., N, 3) by (.., 3, 3) about pivots (.., 3)."""
    pivot = pivot[..., None, :]
    return torch.matmul(points - pivot, rotation.transpose(-1, -2)) + pivot
