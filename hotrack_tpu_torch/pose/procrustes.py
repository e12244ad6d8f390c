"""Rigid Procrustes solvers for the palm-template hand frame.

Port of hotrack_tpu/pose/procrustes.py (`solve_rot_and_trans`,
`solve_rot_and_trans_fast`): both solve y = x @ R^T + t^T for x (N, 3) or
(B, N, 3) and y (B, N, 3), returning R (B, 3, 3) and t (B, 3, 1). The SVD
solver is the reference's construction; the fast one is Horn's quaternion
method with the same branch-free power iteration as the JAX package, so the
two packages pick the same rotation to rounding.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def _centred(x: torch.Tensor, y: torch.Tensor):
    if x.dim() == 2:
        x = x[None].expand_as(y)
    cx = torch.mean(x, dim=-2, keepdim=True)
    cy = torch.mean(y, dim=-2, keepdim=True)
    return x, cx, cy


def solve_rot_and_trans(x: torch.Tensor, y: torch.Tensor):
    """SVD (Kabsch with the det reflection fix): w = x_c^T y_c;
    R = V diag(1, 1, det(V U^T)) U^T; t = c_y - c_x R^T."""
    x, cx, cy = _centred(x, y)
    w = torch.matmul((x - cx).transpose(-1, -2), y - cy)
    u, _, vh = torch.linalg.svd(w, full_matrices=False)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(v, u.transpose(-1, -2)))
    ide = torch.eye(3, dtype=x.dtype, device=x.device).expand_as(w).clone()
    ide[..., 2, 2] = det
    r = torch.matmul(torch.matmul(v, ide), u.transpose(-1, -2))
    t = cy - torch.matmul(cx, r.transpose(-1, -2))
    return r, t.transpose(-1, -2)


def _horn_quaternion(w: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) maximising tr(R @ w): the top eigenvector
    of Horn's symmetric 4x4, by 8 normalised squarings plus 2 polishing
    matvecs (see hotrack_tpu/pose/procrustes.py:_horn_quaternion)."""
    sxx, sxy, sxz = w[..., 0, 0], w[..., 0, 1], w[..., 0, 2]
    syx, syy, syz = w[..., 1, 0], w[..., 1, 1], w[..., 1, 2]
    szx, szy, szz = w[..., 2, 0], w[..., 2, 1], w[..., 2, 2]
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1),
    ], dim=-2)
    sigma = torch.sqrt(torch.sum(n * n, dim=(-1, -2), keepdim=True)) + EPS
    a = n + sigma * torch.eye(4, dtype=w.dtype, device=w.device)
    a = a / sigma
    for _ in range(8):
        a = torch.matmul(a, a)
        a = a / torch.clamp(torch.amax(torch.abs(a), dim=(-1, -2), keepdim=True),
                            min=EPS)
    v = torch.sum(a, dim=-1)
    col = torch.argmax(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)
    alt = torch.gather(a, -1, col[..., None, None].expand(*a.shape[:-1], 1))[..., 0]
    small = (torch.linalg.norm(v, dim=-1, keepdim=True)
             < 1e-3 * torch.linalg.norm(alt, dim=-1, keepdim=True))
    v = torch.where(small, alt, v)
    for _ in range(2):
        v = torch.matmul(n, v[..., None])[..., 0] + sigma[..., 0] * v
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=EPS)
    return v


def _quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) unit quaternion -> (..., 3, 3) rotation (y = R x)."""
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], dim=-2)


def solve_rot_and_trans_fast(x: torch.Tensor, y: torch.Tensor):
    """Same R, t as `solve_rot_and_trans` (to ~1e-6 rad) by Horn's method."""
    x, cx, cy = _centred(x, y)
    w = torch.matmul((x - cx).transpose(-1, -2), y - cy)
    r = _quat_to_matrix(_horn_quaternion(w))
    t = cy - torch.matmul(cx, r.transpose(-1, -2))
    return r, t.transpose(-1, -2)
