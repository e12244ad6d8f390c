"""HandTrackNet in PyTorch (port of hotrack_tpu/models/hand_network.py).

HandTrackNet refines the previous frame's 21 hand keypoints against the
current point cloud: canonicalise into the palm-Procrustes hand frame at
scale 0.2, run a PointNet++ backbone over the cloud, query point features at
the keypoints (two set-abstraction layers sharing one kNN), mix through the
skeleton-rearrange modules and the FFN-mode TransT stack, and regress a
per-keypoint delta. Channels-last; submodule names follow the reference's
state dict, so reference checkpoints load (utils/convert.py). The visibility
output (IKNet only) and IKNet itself are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..nn.backbones import PointNet2Msg
from ..nn.blocks import RearrangeModule
from ..nn.pointnet2 import SetAbstractionAtCenters
from ..nn.transformer import ATTENTION_NOT_PORTED, AttnModule, TransT
from .hand_utils import (
    CanonPose,
    camera_frame,
    canonicalize,
    decanonicalize,
    solve_hand_frame,
)


def l2_loss(x, y, mask=None):
    """Mean per-point L2 distance; x, y (B, N, 3), mask (B, N)."""
    d = torch.linalg.norm(x - y, dim=-1)
    if mask is None:
        return torch.mean(d)
    num = torch.sum(d * mask, dim=-1)
    den = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.mean(num / den)


def l1_loss(x, y, mask=None):
    """Mean absolute difference."""
    if mask is None:
        return torch.mean(torch.abs(x - y))
    d = torch.mean(torch.abs(x - y), dim=-1)
    num = torch.sum(d * mask, dim=-1)
    den = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.mean(num / den)


def rotation_diff_deg(r1, r2):
    """Mean geodesic angle between rotation batches, degrees."""
    m = torch.matmul(r1.transpose(-1, -2), r2)
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.mean(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))) * 180.0 / torch.pi


class HandTrackNet(nn.Module):
    """Per-frame hand keypoint refiner.

    forward(hand_points (B, N, 3), jittered_kp (B, 21, 3), palm_template
    (6, 3) or (B, 6, 3), valid_mask (B, N) or None) -> dict with pred_kp
    (B, 21, 3), pred_kp_handframe, init_kp_handframe, points_handframe and
    canon_pose."""

    def __init__(self, net_cfg: Mapping[str, Any], backbone_out_dim: int = 384,
                 handframe: str = "kp", use_attention: bool = False,
                 procrustes_solver: str | None = None):
        super().__init__()
        d = backbone_out_dim
        if d % 6:
            raise ValueError(f"backbone_out_dim must divide by 6, got {d}")
        if use_attention:
            raise NotImplementedError(ATTENTION_NOT_PORTED)
        if handframe not in ("kp", "camera"):
            raise NotImplementedError(
                f"handframe={handframe!r} is not ported yet (ROADMAP.md, queue 1)")
        self.handframe = handframe
        self.procrustes_solver = procrustes_solver
        q_mlps = ((128, 128, d // 2), (128, 128, d // 2))
        q_kwargs = dict(radius_list=(0.2, 0.2), nsample_list=(16, 64),
                        mlp_list=q_mlps, knn=True)
        self.bhand = PointNet2Msg(net_cfg, d)
        self.q1 = SetAbstractionAtCenters(**q_kwargs, in_channel=d)
        self.r1 = RearrangeModule(d)
        self.q2 = SetAbstractionAtCenters(**q_kwargs, in_channel=d, center_channel=d)
        self.r2 = RearrangeModule(d)
        self.transt = TransT(d)
        self.c3 = AttnModule(d)
        self.final_mlp = nn.Sequential(nn.Linear(d, 256), nn.ReLU(), nn.Linear(256, 3))

    def forward(self, hand_points, jittered_kp, palm_template=None,
                valid_mask=None) -> dict:
        b, kp_num = jittered_kp.shape[0], jittered_kp.shape[1]
        if self.handframe == "kp":
            canon_pose = solve_hand_frame(palm_template, jittered_kp,
                                          solver=self.procrustes_solver)
        else:
            canon_pose = camera_frame(b, hand_points.dtype, hand_points.device)

        cam = canonicalize(torch.cat([hand_points, jittered_kp], dim=1), canon_pose)
        xyz2 = cam[:, :-kp_num]   # cloud in the hand frame
        xyz1 = cam[:, -kp_num:]   # keypoints in the hand frame

        src2 = self.bhand(xyz2, valid_mask)
        f11, group_idx = self.q1(xyz2, src2, xyz1, None, return_group_idx=True,
                                 valid_mask=valid_mask)
        f12 = self.r1(f11)
        f13 = self.q2(xyz2, src2, xyz1, f12, pre_group_idx=group_idx)
        f14 = self.r2(f13)
        fused = self.c3(self.transt(f14))
        pred_kp_handframe = self.final_mlp(fused) + xyz1
        return {
            "canon_pose": canon_pose,
            "init_kp_handframe": xyz1,
            "points_handframe": xyz2,
            "pred_kp_handframe": pred_kp_handframe,
            "pred_kp": decanonicalize(pred_kp_handframe, canon_pose),
        }


def hand_tracknet_loss(ret: dict, gt_kp, gt_palm_template=None,
                       gt_hand_pose: dict | None = None, track_flag: bool = False):
    """HandTrackNet losses and diagnostics; gt_kp (B, 21, 3). Returns
    (loss_dict, ret); the headline metric is hand_pred_kp_diff (MPJPE, m)."""
    canon_pose: CanonPose = ret["canon_pose"]
    gt_kp_handframe = canonicalize(gt_kp, canon_pose)
    ret["gt_kp_handframe"] = gt_kp_handframe
    s = canon_pose.scale.reshape(-1)[:, None, None]
    init_scaled = ret["init_kp_handframe"] * s
    pred_scaled = ret["pred_kp_handframe"] * s
    gt_scaled = gt_kp_handframe * s

    loss = {
        "hand_pred_kp_loss": l1_loss(pred_scaled, gt_scaled),
        "hand_pred_kp_diff": l2_loss(ret["pred_kp"], gt_kp),
        "hand_init_kp_diff": l2_loss(init_scaled, gt_scaled),
    }
    if gt_palm_template is not None:
        gt_frame = solve_hand_frame(gt_palm_template, gt_scaled)
        pred_frame = solve_hand_frame(gt_palm_template, pred_scaled)
        loss["hand_pred_r_loss"] = l1_loss(pred_frame.rotation, gt_frame.rotation)
        loss["hand_pred_t_loss"] = l1_loss(pred_frame.translation, gt_frame.translation)
        loss["hand_pred_r_diff"] = rotation_diff_deg(pred_frame.rotation,
                                                     gt_frame.rotation)
        loss["hand_pred_t_diff"] = l2_loss(pred_frame.translation.transpose(-1, -2),
                                           gt_frame.translation.transpose(-1, -2))
    if track_flag and gt_hand_pose is not None:
        loss["hand_canon_r_diff"] = rotation_diff_deg(canon_pose.rotation,
                                                      gt_hand_pose["rotation"])
        loss["hand_canon_t_diff"] = l2_loss(
            gt_hand_pose["translation"].transpose(-1, -2),
            canon_pose.translation.transpose(-1, -2))
    return loss, ret
