"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/nn/backbones.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

PointNet++ backbones (port of hotrack_tpu/nn/backbones.py).

`PointNet2Msg`: channels-last input xyz (B, N, 3), output per-point features
(B, N, out_dim); per-point input features (the JAX module's points[..., 3:] /
use_xyz_feat) have no caller there and are not carried over.
`PointNet2Encoder`: the set-abstraction-only global encoder, points (B, N,
3 + in_channel) -> (B, 1, out_dim), with the JAX module's input features.

`PointNet2Msg(compute_dtype=...)` runs every layer's Linear in that dtype
(nn/precision.py); its last BatchNorm and ReLU run on float32 and its output
stays float32, as the JAX module's does. The JAX `PointNet2Encoder` takes
no dtype, and neither does this one.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from .pointnet2 import (
    FeaturePropagation,
    SetAbstractionAll,
    SetAbstractionMsg,
)
from .precision import dense, to_f32


class PointNet2Msg(nn.Module):
    """sa1 -> sa2 -> sa3(group_all) -> fp3 -> fp2 -> fp1 -> linear+bn+relu.

    `net_cfg` is the pointnet config dict (configs/pointnet_config/*.yml)."""

    def __init__(self, net_cfg: Mapping[str, Any], out_dim: int, compute_dtype=None):
        super().__init__()
        c, cd = net_cfg, compute_dtype
        self.compute_dtype = cd
        self.sa1 = SetAbstractionMsg(c["sa1"]["npoint"], c["sa1"]["radius_list"],
                                     c["sa1"]["nsample_list"], c["sa1"]["mlp_list"],
                                     compute_dtype=cd)
        self.sa2 = SetAbstractionMsg(c["sa2"]["npoint"], c["sa2"]["radius_list"],
                                     c["sa2"]["nsample_list"], c["sa2"]["mlp_list"],
                                     in_channel=self.sa1.out_channel, compute_dtype=cd)
        self.sa3 = SetAbstractionAll(c["sa3"]["mlp"], in_channel=self.sa2.out_channel,
                                     compute_dtype=cd)
        self.fp3 = FeaturePropagation(
            c["fp3"]["mlp"], self.sa2.out_channel + self.sa3.out_channel, compute_dtype=cd)
        self.fp2 = FeaturePropagation(
            c["fp2"]["mlp"], self.sa1.out_channel + self.fp3.out_channel, compute_dtype=cd)
        self.fp1 = FeaturePropagation(c["fp1"]["mlp"], 3 + self.fp2.out_channel,
                                      compute_dtype=cd)
        self.conv1 = nn.Linear(self.fp1.out_channel, out_dim)
        self.bn1 = nn.BatchNorm1d(out_dim, eps=1e-5)

    def forward(self, xyz: torch.Tensor, valid_mask=None) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, None, valid_mask)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, None)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, xyz, l1)
        out = dense(self.conv1, l0, self.compute_dtype)
        out = to_f32(out, self.compute_dtype)
        return torch.relu(self.bn1(out.reshape(-1, out.shape[-1])).reshape(out.shape))
