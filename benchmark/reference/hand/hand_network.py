"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/models/hand_network.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

HandTrackNet and IKNet in PyTorch (port of hotrack_tpu/models/hand_network.py).

HandTrackNet refines the previous frame's 21 hand keypoints against the
current point cloud: canonicalise into the palm-Procrustes hand frame at
scale 0.2, run a PointNet++ backbone over the cloud, query point features at
the keypoints (two set-abstraction layers sharing one kNN), mix through the
skeleton-rearrange modules and the TransT stack (FFN mode as shipped), and
regress a per-keypoint delta. IKNet maps canonical keypoints and bones to 15
joint quaternions (MANO theta). Channels-last; submodule names follow the
reference's state dict, so reference checkpoints load (utils/convert.py).

HandTrackNet's `compute_dtype` (`network/compute_dtype`: bfloat16, float16,
float32 or None) runs the backbone, the keypoint set abstractions, the
rearrange layers and the FFN's dense layers in that dtype, as the JAX net
does (nn/precision.py); parameters, norms, the canonicalisation, the
Procrustes solve and the delta head stay float32, and the parameter names do
not change. IKNet has no compute dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from .backbones import PointNet2Msg
from .blocks import RearrangeModule, position_embedding_sine
from .pointnet2 import SetAbstractionAtCenters
from .precision import resolve_compute_dtype, to_f32
from .transformer import AttnModule, TransT
from .pointops import knn_point
from .rotations import mano_quat2axisang
from .hand_utils import (
    CanonPose,
    camera_frame,
    canonicalize,
    decanonicalize,
    kp_bones,
    solve_hand_frame,
)


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
                 procrustes_solver: str | None = None, compute_dtype: str | None = None):
        super().__init__()
        cd = resolve_compute_dtype(compute_dtype)
        self.compute_dtype = cd
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
                        mlp_list=q_mlps, knn=True, compute_dtype=cd)
        self.bhand = PointNet2Msg(net_cfg, d, compute_dtype=cd)
        self.q1 = SetAbstractionAtCenters(**q_kwargs, in_channel=d)
        self.r1 = RearrangeModule(d, compute_dtype=cd)
        self.q2 = SetAbstractionAtCenters(**q_kwargs, in_channel=d, center_channel=d)
        self.r2 = RearrangeModule(d, compute_dtype=cd)
        self.transt = TransT(d, attention=use_attention, compute_dtype=cd)
        self.c3 = AttnModule(d, attention=use_attention, compute_dtype=cd)
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
        # the delta head on float32, for the residual
        pred_kp_handframe = self.final_mlp(to_f32(fused, self.compute_dtype)) + xyz1
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


