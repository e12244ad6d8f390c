"""3-D bounding-box IoU evaluation (port of hotrack_tpu/pose/bbox.py).

`iou_3d`: the voxelised IoU of two oriented boxes (nres^3 sample points over
their joint extent, against both boxes at once); `aabb_iou_3d`: the
axis-aligned IoU; `bbox_from_corners`: min / max corners to the 8 vertices
in the reference's order; `eval_single_part_iou`: the posed-box suite, with
a 20-way yaw sweep of the gt box for symmetric objects.
"""

from __future__ import annotations

import numpy as np
import torch

from .part_dof import pose_with_part


def pts_inside_box(pts: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """pts (..., 3), bbox (8, 3) in the reference's corner order -> bool (...)."""
    up = pts - bbox[4]
    inside = None
    for u in (bbox[5] - bbox[4], bbox[7] - bbox[4], bbox[0] - bbox[4]):
        p = torch.sum(up * u, dim=-1)
        ok = (p > 0) & (p < torch.dot(u, u))
        inside = ok if inside is None else inside & ok
    return inside


def iou_3d(bbox1: torch.Tensor, bbox2: torch.Tensor, nres: int = 50) -> torch.Tensor:
    """Voxelised IoU of two oriented boxes (8, 3); 1 where neither holds a
    sample point."""
    both = torch.cat([bbox1, bbox2], dim=0)
    bmin, bmax = torch.min(both, dim=0).values, torch.max(both, dim=0).values
    lin = [torch.linspace(float(bmin[i]), float(bmax[i]), nres, dtype=bbox1.dtype,
                          device=bbox1.device) for i in range(3)]
    pts = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)
    f1, f2 = pts_inside_box(pts, bbox1), pts_inside_box(pts, bbox2)
    inter = torch.sum(f1 & f2)
    union = torch.sum(f1 | f2)
    one = torch.ones((), dtype=bbox1.dtype, device=bbox1.device)
    return torch.where(union == 0, one, inter / torch.clamp(union, min=1))


def aabb_iou_3d(bbox1: torch.Tensor, bbox2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU of the boxes' extents."""
    mx1, mn1 = torch.max(bbox1, 0).values, torch.min(bbox1, 0).values
    mx2, mn2 = torch.max(bbox2, 0).values, torch.min(bbox2, 0).values
    overlap = torch.minimum(mx1, mx2) - torch.maximum(mn1, mn2)
    inter = torch.where(torch.min(overlap) < 0, torch.zeros_like(overlap[0]),
                        torch.prod(overlap))
    return inter / (torch.prod(mx1 - mn1) + torch.prod(mx2 - mn2) - inter)


def bbox_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) min / max corners -> (..., 8, 3) box vertices."""
    pts = []
    for i in range(8):
        x, y, z = (i % 4) // 2, i // 4, i % 2
        pts.append(torch.stack([corners[..., x, 0], corners[..., y, 1], corners[..., z, 2]],
                               dim=-1))
    return torch.stack(pts, dim=-2)


def _y_rotation(theta: float) -> np.ndarray:
    return np.array([[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                     [-np.sin(theta), 0, np.cos(theta)]], np.float32)


def eval_single_part_iou(gt_corners, pred_corners, gt_pose: dict, pred_pose: dict,
                         nocs: bool = False, sym: bool = False, nres: int = 50) -> dict:
    """corners (B, P, 2, 3); poses {'rotation' (B, P, 3, 3), 'translation'
    (B, P, 3, 1), 'scale' (B, P)}. With sym the gt box is swept over 20 yaw
    angles about the predicted rotation and the best IoU kept. Returns
    {'npcs_iou', 'iou', 'gt_bbox_iou'}, each a (B, P) float32 numpy array."""
    iou_fn = aabb_iou_3d if nocs else (lambda a, b: iou_3d(a, b, nres))
    gt_npcs, pred_npcs = bbox_from_corners(gt_corners), bbox_from_corners(pred_corners)
    gt_poses = [gt_pose]
    if sym:
        gt_poses = [{"rotation": torch.matmul(pred_pose["rotation"], torch.as_tensor(
                         _y_rotation(2 * np.pi * i / 20.0), device=gt_corners.device)),
                     "translation": gt_pose["translation"], "scale": gt_pose["scale"]}
                    for i in range(20)]
    pred_posed = pose_with_part(pred_pose, pred_npcs)
    pred_posed_gt = pose_with_part(pred_pose, gt_npcs)
    gt_posed = [pose_with_part(pose, gt_npcs) for pose in gt_poses]
    b, p = pred_npcs.shape[:2]

    def batch_iou(boxes1_list, boxes2):
        out = np.zeros((b, p), np.float32)
        for bi in range(b):
            for pi in range(p):
                out[bi, pi] = max([0.0] + [float(iou_fn(boxes1[bi, pi], boxes2[bi, pi]))
                                           for boxes1 in boxes1_list])
        return out

    return {"npcs_iou": batch_iou([gt_npcs], pred_npcs),
            "iou": batch_iou(gt_posed, pred_posed),
            "gt_bbox_iou": batch_iou(gt_posed, pred_posed_gt)}
