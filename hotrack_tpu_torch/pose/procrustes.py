"""Procrustes and similarity-transform solvers (port of
hotrack_tpu/pose/procrustes.py).

The palm-template hand frame: `solve_rot_and_trans` and
`solve_rot_and_trans_fast` both solve y = x @ R^T + t^T for x (N, 3) or
(B, N, 3) and y (B, N, 3), returning R (B, 3, 3) and t (B, 3, 1). The SVD
solver is the reference's construction; the fast one is Horn's quaternion
method with the same branch-free power iteration as the JAX package, so the
two packages pick the same rotation to rounding.

The alignment suite: `rotate_pts` (Kabsch with the reflection fix),
`scale_pts`, `translate_pts`, the full similarity fit `transform_pts`
(optionally refined by a yaw-only fit in the canonical xz plane for
symmetric objects: `rotate_pts_2d`, `transform_pts_2d`,
`rot_around_yaxis_to_3d`), and the masked and weighted `*_mask` family.
Points are (..., N, 3) and translations (..., 3, 1), as in the JAX package.
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


def _det3(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.cross(a[..., 0, :], a[..., 1, :], dim=-1) * a[..., 2, :], dim=-1)


def rotate_pts(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Optimal rotation R with target ~= source @ R^T for centred point sets
    (..., N, 3): M = target^T source = U S V^T, R = U diag(1, 1, det(U V^T))
    V^T."""
    m = torch.matmul(target.transpose(-1, -2), source)
    u, _, vh = torch.linalg.svd(m, full_matrices=False)
    v = vh.transpose(-1, -2)
    d = _det3(torch.matmul(u, v.transpose(-1, -2)))
    mid = torch.zeros_like(u)
    mid[..., 0, 0] = 1.0
    mid[..., 1, 1] = 1.0
    mid[..., 2, 2] = d
    return torch.matmul(torch.matmul(u, mid), v.transpose(-1, -2))


def scale_pts(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Optimal scale for target ~= s * source."""
    return torch.sum(source * target, dim=(-1, -2)) / (
        torch.sum(source * source, dim=(-1, -2)) + EPS)


def translate_pts(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """source / target (..., 3, N) -> (..., 3, 1)."""
    return torch.mean(target - source, dim=-1, keepdim=True)


def rot_around_yaxis_to_3d(rot_2d: torch.Tensor) -> torch.Tensor:
    """Embed a 2 x 2 rotation of the xz plane into 3 x 3."""
    xx, xz = rot_2d[..., 0, 0], rot_2d[..., 0, 1]
    zx, zz = rot_2d[..., 1, 0], rot_2d[..., 1, 1]
    one, zero = torch.ones_like(xx), torch.zeros_like(xx)
    m = torch.stack([xx, zero, xz, zero, one, zero, zx, zero, zz], dim=-1)
    return m.reshape(*m.shape[:-1], 3, 3)


def rotate_pts_2d(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """2-D Kabsch; where the solution is not a rotation to 1e-5 (a degenerate
    problem), the identity."""
    m = torch.matmul(target.transpose(-1, -2), source)
    u, _, vh = torch.linalg.svd(m, full_matrices=False)
    v = vh.transpose(-1, -2)
    uvt = torch.matmul(u, v.transpose(-1, -2))
    d = uvt[..., 0, 0] * uvt[..., 1, 1] - uvt[..., 0, 1] * uvt[..., 1, 0]
    mid = torch.zeros_like(u)
    mid[..., 0, 0] = 1.0
    mid[..., 1, 1] = d
    r = torch.matmul(torch.matmul(u, mid), v.transpose(-1, -2))
    eye = torch.eye(2, dtype=r.dtype, device=r.device)
    res = torch.abs(torch.matmul(r.transpose(-1, -2), r) - eye).mean(dim=(-1, -2))
    valid = (res < 1e-5).to(r.dtype)[..., None, None]
    return valid * r + (1.0 - valid) * eye


def transform_pts_2d(source: torch.Tensor, target: torch.Tensor):
    """2-D rigid fit of (..., N, 2) sets -> (rotation (..., 2, 2),
    translation (..., 2, 1))."""
    sc = source - torch.mean(source, dim=-2, keepdim=True)
    tc = target - torch.mean(target, dim=-2, keepdim=True)
    rotation = rotate_pts_2d(sc, tc)
    translation = translate_pts(torch.matmul(rotation, source.transpose(-1, -2)),
                                target.transpose(-1, -2))
    return rotation, translation


def _yaw_refined(rotation, source, target, fit_2d, *args):
    """The rotation refined by a yaw-only fit of the xz coordinates in the
    canonical frame."""
    canon = torch.matmul(target, rotation)
    rot_2d, _ = fit_2d(source[..., [0, 2]], canon[..., [0, 2]], *args)
    return torch.matmul(rotation, rot_around_yaxis_to_3d(rot_2d))


def transform_pts(source: torch.Tensor, target: torch.Tensor, given_scale=None,
                  rotation=None, sym: bool = False):
    """Similarity fit target ~= s * source @ R^T + t^T -> (R, s, t (..., 3,
    1)). With sym, the rotation is refined by a yaw-only fit."""
    sc = source - torch.mean(source, dim=-2, keepdim=True)
    tc = target - torch.mean(target, dim=-2, keepdim=True)
    if rotation is None:
        rotation = rotate_pts(sc, tc)
    if sym:
        rotation = _yaw_refined(rotation, source, target, transform_pts_2d)
    scale = given_scale if given_scale is not None else scale_pts(
        torch.matmul(sc, rotation.transpose(-1, -2)), tc)
    translation = translate_pts(
        scale[..., None, None] * torch.matmul(rotation, source.transpose(-1, -2)),
        target.transpose(-1, -2))
    return rotation, scale, translation


def _masked_center(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(pts * mask, dim=-2, keepdim=True) / torch.clamp(
        torch.sum(mask, dim=-2, keepdim=True), min=1.0)


def rotate_pts_mask(source, target, w):
    """Weighted Kabsch: weights w >= 0 of shape (..., N, 1)."""
    w = torch.sqrt(w + EPS)
    return rotate_pts(source * w, target * w)


def scale_pts_mask(source, target, w):
    return torch.sum(source * target * w, dim=(-1, -2)) / (
        torch.sum(source * source * w, dim=(-1, -2)) + EPS)


def translate_pts_mask(source, target, w):
    """source / target (..., 3, N); w (..., N, 1): the weighted mean of the
    differences."""
    w = w.transpose(-1, -2)
    w_sum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    return torch.sum((target - source) * (w / w_sum), dim=-1, keepdim=True)


def transform_pts_2d_mask(source, target, mask):
    """Masked 2-D rigid fit."""
    sc = (source - _masked_center(source, mask)) * mask
    tc = (target - _masked_center(target, mask)) * mask
    rotation = rotate_pts_2d(sc * mask, tc * mask)
    translation = translate_pts_mask(torch.matmul(rotation, source.transpose(-1, -2)),
                                     target.transpose(-1, -2), mask)
    return rotation, translation


def transform_pts_mask(source, target, mask, weights, given_scale=None, rotation=None,
                       sym: bool = False):
    """Masked similarity fit: `mask` (..., N, 1) gates the valid points,
    `weights` (..., N, 1) weight the fit -> (R, s, t)."""
    sc = (source - _masked_center(source, mask)) * mask
    tc = (target - _masked_center(target, mask)) * mask
    if rotation is None:
        rotation = rotate_pts_mask(sc, tc, weights)
    if sym:
        rotation = _yaw_refined(rotation, source, target, transform_pts_2d_mask, weights)
    scale = given_scale if given_scale is not None else scale_pts_mask(
        torch.matmul(sc, rotation.transpose(-1, -2)), tc, weights)
    translation = translate_pts_mask(
        scale[..., None, None] * torch.matmul(rotation, source.transpose(-1, -2)),
        target.transpose(-1, -2), weights)
    return rotation, scale, translation
