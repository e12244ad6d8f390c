"""PointNet++ backbones (port of hotrack_tpu/nn/backbones.py).

`PointNet2Msg`: channels-last input xyz (B, N, 3), output per-point features
(B, N, out_dim); per-point input features (the JAX module's points[..., 3:] /
use_xyz_feat) have no caller there and are not carried over.
`PointNet2Encoder`: the set-abstraction-only global encoder, points (B, N,
3 + in_channel) -> (B, 1, out_dim), with the JAX module's input features.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from .pointnet2 import (
    FeaturePropagation,
    SetAbstractionAll,
    SetAbstractionMsg,
    shared_mlp,
)


class PointNet2Msg(nn.Module):
    """sa1 -> sa2 -> sa3(group_all) -> fp3 -> fp2 -> fp1 -> linear+bn+relu.

    `net_cfg` is the pointnet config dict (configs/pointnet_config/*.yml)."""

    def __init__(self, net_cfg: Mapping[str, Any], out_dim: int):
        super().__init__()
        c = net_cfg
        self.sa1 = SetAbstractionMsg(c["sa1"]["npoint"], c["sa1"]["radius_list"],
                                     c["sa1"]["nsample_list"], c["sa1"]["mlp_list"])
        self.sa2 = SetAbstractionMsg(c["sa2"]["npoint"], c["sa2"]["radius_list"],
                                     c["sa2"]["nsample_list"], c["sa2"]["mlp_list"],
                                     in_channel=self.sa1.out_channel)
        self.sa3 = SetAbstractionAll(c["sa3"]["mlp"], in_channel=self.sa2.out_channel)
        self.fp3 = FeaturePropagation(
            c["fp3"]["mlp"], self.sa2.out_channel + self.sa3.out_channel)
        self.fp2 = FeaturePropagation(
            c["fp2"]["mlp"], self.sa1.out_channel + self.fp3.out_channel)
        self.fp1 = FeaturePropagation(c["fp1"]["mlp"], 3 + self.fp2.out_channel)
        self.conv1 = nn.Linear(self.fp1.out_channel, out_dim)
        self.bn1 = nn.BatchNorm1d(out_dim, eps=1e-5)

    def forward(self, xyz: torch.Tensor, valid_mask=None) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, None, valid_mask)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, None)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, xyz, l1)
        return shared_mlp((self.conv1,), (self.bn1,), l0)


class PointNet2Encoder(nn.Module):
    """sa1 -> sa2 -> sa3 (group all) -> Linear 256 + BN + ReLU + dropout 0.5
    -> Linear out_dim + BN + ReLU. `in_channel` extra channels per point
    after xyz are its features; with use_xyz_feat the features are the whole
    point (xyz included)."""

    def __init__(self, net_cfg: Mapping[str, Any], out_dim: int, in_channel: int = 0,
                 use_xyz_feat: bool = False):
        super().__init__()
        c = net_cfg
        self.use_xyz_feat = use_xyz_feat
        self.sa1 = SetAbstractionMsg(c["sa1"]["npoint"], c["sa1"]["radius_list"],
                                     c["sa1"]["nsample_list"], c["sa1"]["mlp_list"],
                                     in_channel=in_channel + 3 * use_xyz_feat)
        self.sa2 = SetAbstractionMsg(c["sa2"]["npoint"], c["sa2"]["radius_list"],
                                     c["sa2"]["nsample_list"], c["sa2"]["mlp_list"],
                                     in_channel=self.sa1.out_channel)
        self.sa3 = SetAbstractionAll(c["sa3"]["mlp"], in_channel=self.sa2.out_channel)
        self.fc1 = nn.Linear(self.sa3.out_channel, 256)
        self.bn1 = nn.BatchNorm1d(256, eps=1e-5)
        self.drop1 = nn.Dropout(0.5)
        self.fc2 = nn.Linear(256, out_dim)
        self.bn2 = nn.BatchNorm1d(out_dim, eps=1e-5)

    def forward(self, points: torch.Tensor, valid_mask=None) -> torch.Tensor:
        xyz = points[..., :3]
        feats = points if self.use_xyz_feat else (points[..., 3:] if points.shape[-1] > 3
                                                  else None)
        l1_xyz, l1 = self.sa1(xyz, feats, valid_mask)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, None)
        _, l3 = self.sa3(l2_xyz, l2)
        h = self.drop1(shared_mlp((self.fc1,), (self.bn1,), l3))
        return shared_mlp((self.fc2,), (self.bn2,), h)
