"""HandTrackNet and IKNet in PyTorch (port of hotrack_tpu/models/hand_network.py).

HandTrackNet refines the previous frame's 21 hand keypoints against the
current point cloud: canonicalise into the palm-Procrustes hand frame at
scale 0.2, run a PointNet++ backbone over the cloud, query point features at
the keypoints (two set-abstraction layers sharing one kNN), mix through the
skeleton-rearrange modules and the TransT stack (FFN mode as shipped), and
regress a per-keypoint delta. IKNet maps canonical keypoints and bones to 15
joint quaternions (MANO theta). Channels-last; submodule names follow the
reference's state dict, so reference checkpoints load (utils/convert.py).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ..mano.layer import mano_forward
from ..nn.backbones import PointNet2Msg
from ..nn.blocks import RearrangeModule, position_embedding_sine
from ..nn.pointnet2 import SetAbstractionAtCenters
from ..nn.transformer import AttnModule, TransT
from ..ops.pointops import knn_point
from ..pose.rotations import matrix_to_unit_quaternion, mano_quat2axisang
from .hand_utils import (
    CanonPose,
    camera_frame,
    canonicalize,
    decanonicalize,
    kp_bones,
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
    (6, 3) or (B, 6, 3) [handframe='kp'], obb_pose CanonPose
    [handframe='OBB'], valid_mask (B, N) or None) -> dict with pred_kp
    (B, 21, 3), pred_kp_handframe, init_kp_handframe, points_handframe and
    canon_pose; with compute_visibility also pred_kp_vis_mask (B, 21) bool:
    a keypoint counts as visible when the mean distance to its 4 nearest
    cloud points is under 2 cm (3 cm for the wrist and the thumb base)."""

    def __init__(self, net_cfg: Mapping[str, Any], backbone_out_dim: int = 384,
                 handframe: str = "kp", use_attention: bool = False,
                 procrustes_solver: str | None = None):
        super().__init__()
        d = backbone_out_dim
        if d % 6:
            raise ValueError(f"backbone_out_dim must divide by 6, got {d}")
        if handframe not in ("kp", "OBB", "camera"):
            raise ValueError(f"unknown handframe {handframe!r}")
        self.handframe = handframe
        self.use_attention = use_attention
        self.num_pos_feats = d // 6
        self.procrustes_solver = procrustes_solver
        q_mlps = ((128, 128, d // 2), (128, 128, d // 2))
        q_kwargs = dict(radius_list=(0.2, 0.2), nsample_list=(16, 64),
                        mlp_list=q_mlps, knn=True)
        self.bhand = PointNet2Msg(net_cfg, d)
        self.q1 = SetAbstractionAtCenters(**q_kwargs, in_channel=d)
        self.r1 = RearrangeModule(d)
        self.q2 = SetAbstractionAtCenters(**q_kwargs, in_channel=d, center_channel=d)
        self.r2 = RearrangeModule(d)
        self.transt = TransT(d, attention=use_attention)
        self.c3 = AttnModule(d, attention=use_attention)
        self.final_mlp = nn.Sequential(nn.Linear(d, 256), nn.ReLU(), nn.Linear(256, 3))

    def forward(self, hand_points, jittered_kp, palm_template=None,
                valid_mask=None, obb_pose: CanonPose | None = None,
                compute_visibility: bool = False) -> dict:
        b, kp_num = jittered_kp.shape[0], jittered_kp.shape[1]
        if self.handframe == "kp":
            canon_pose = solve_hand_frame(palm_template, jittered_kp,
                                          solver=self.procrustes_solver)
        elif self.handframe == "OBB":
            if obb_pose is None:
                raise ValueError("handframe='OBB' needs obb_pose")
            canon_pose = obb_pose
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
        if self.use_attention:
            pos = position_embedding_sine(cam, self.num_pos_feats)
            pos2, pos1 = pos[:, :-kp_num], pos[:, -kp_num:]
            f15, f251 = self.transt(f14, pos1, src2, pos2, attn=True)
            fused = self.c3(f15, pos1, f251, pos2, attn=True)
        else:
            # FFN mode never reads the positional embedding or result2
            fused = self.c3(self.transt(f14)[0])
        pred_kp_handframe = self.final_mlp(fused) + xyz1
        ret = {
            "canon_pose": canon_pose,
            "init_kp_handframe": xyz1,
            "points_handframe": xyz2,
            "pred_kp_handframe": pred_kp_handframe,
            "pred_kp": decanonicalize(pred_kp_handframe, canon_pose),
        }
        if compute_visibility:
            dist4, _ = knn_point(4, ret["pred_kp"], hand_points)
            avg = torch.mean(dist4, dim=-1)
            discount = torch.zeros(kp_num, dtype=avg.dtype, device=avg.device)
            discount[:2] = 0.01
            ret["pred_kp_vis_mask"] = (avg - discount) < 0.02
        return ret


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


class IKNet(nn.Module):
    """Inverse-kinematics net: canonical 21 keypoints + 21 parent-relative
    bones -> 15 joint quaternions (B, 60).

    The input is flattened kp-major (B, 21 * 3), as in the JAX package; the
    reference flattens (B, 3, 21) coordinate-major, so utils/convert.py
    permutes the first Linear's input columns between the two layouts.
    forward(init_kp (B, 21, 3), palm_template (6, 3) or (B, 6, 3)) -> dict."""

    def __init__(self, layer_num: int = 6, width: int = 1024,
                 iknetframe: str = "kp", procrustes_solver: str | None = None):
        super().__init__()
        if iknetframe not in ("kp", "camera"):
            raise ValueError(f"unknown iknetframe {iknetframe!r}")
        self.iknetframe = iknetframe
        self.procrustes_solver = procrustes_solver
        widths = [2 * 21 * 3] + [width] * layer_num
        self.linear = nn.ModuleList(
            [nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:])]
            + [nn.Linear(width, 15 * 4)])
        self.bn = nn.ModuleList([nn.BatchNorm1d(width, eps=1e-5)
                                 for _ in range(layer_num)])

    def forward(self, init_kp, palm_template) -> dict:
        b = init_kp.shape[0]
        canon_pose = solve_hand_frame(palm_template, init_kp,
                                      solver=self.procrustes_solver)
        if self.iknetframe == "kp":
            init_kp_handframe = canonicalize(init_kp, canon_pose)
        else:
            init_kp_handframe = init_kp * 5.0
        bones = kp_bones(init_kp_handframe)
        pack = torch.cat([init_kp_handframe.reshape(b, -1), bones.reshape(b, -1)],
                         dim=-1)
        for linear, bn in zip(self.linear, self.bn):
            pack = torch.relu(bn(linear(pack)))
        raw_quat = self.linear[-1](pack)
        return {
            "raw_quat": raw_quat,
            "init_kp": init_kp,
            "init_kp_handframe": init_kp_handframe,
            "global_pose": canon_pose,
            "MANO_theta": mano_quat2axisang(raw_quat),
        }


def iknet_predict_kp(mano_model, ret: dict, beta):
    """Compose the IKNet joint quaternions with the estimated global pose and
    run MANO: beta (B, 10) -> pred_kp (B, 21, 3)."""
    canon_pose: CanonPose = ret["global_pose"]
    b = ret["raw_quat"].shape[0]
    root_quat = matrix_to_unit_quaternion(canon_pose.rotation)
    pose_coeffs = mano_quat2axisang(torch.cat([root_quat, ret["raw_quat"]], dim=-1))
    _, pred_kp = mano_forward(mano_model, pose_coeffs, betas=beta.reshape(b, -1),
                              trans=canon_pose.translation.reshape(b, 3))
    return pred_kp


def iknet_loss(ret: dict, gt_quat, gt_kp):
    """IKNet losses: gt_quat (B, 60) annotated MANO joint quaternions (the
    global one stripped); gt_kp (B, 21, 3). Returns (loss_dict, ret)."""
    return {
        "quat_loss": torch.mean(torch.abs(ret["raw_quat"] - gt_quat)),
        "init_gt_kp_diff": l2_loss(ret["init_kp"], gt_kp),
    }, ret
