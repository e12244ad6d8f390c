"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/nn/pointnet2.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

PointNet++ set-abstraction / feature-propagation modules in PyTorch.

Port of hotrack_tpu/nn/pointnet2.py. Channels-last — points (B, N, 3),
features (B, N, C), groups (B, S, K, C) — so each per-point shared MLP is an
`nn.Linear` (no cuDNN convolution, hence no TF32 on the card). Submodule
names follow the reference's state dict (`conv_blocks.{scale}.{layer}` /
`bn_blocks...` for multi-scale layers, `mlp_convs` / `mlp_bns` for the
others); its 1x1 convolution kernels load squeezed (utils/convert.py).
BatchNorm is `nn.BatchNorm1d` (eps 1e-5) over the flattened leading axes.

`compute_dtype` (bfloat16 or float16; None: float32) runs each shared MLP's
Linear layers in that dtype, BatchNorm on float32 and the ReLU on its result
cast back (nn/precision.py), as the JAX modules do. Features in the compute
dtype meet float32 coordinates in a concatenation or the 3-NN weights and
promote to float32 there, as in jnp; the max-pool over neighbours keeps the
compute dtype and sends its gradient to the first maximal neighbour.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .pointops import (
    farthest_point_sample,
    index_points,
    knn_point,
    query_ball_point,
    three_nn,
)
from .precision import dense, to_f32


def shared_mlp_layers(in_channel: int, widths: Sequence[int]):
    """The layers of one SharedMLP: (Linear list, BatchNorm1d list). Two
    lists, not one module, so the parameters keep the reference's key names
    (`conv_blocks.{i}.{j}` beside `bn_blocks.{i}.{j}`)."""
    convs, bns = nn.ModuleList(), nn.ModuleList()
    for w in widths:
        convs.append(nn.Linear(in_channel, w))
        bns.append(nn.BatchNorm1d(w, eps=1e-5))
        in_channel = w
    return convs, bns


def shared_mlp(convs, bns, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """SharedMLP (hotrack_tpu/nn/pointnet2.py): per-point [Linear -> BN ->
    ReLU] for each layer, channels-last; with a compute dtype the input and
    each Linear in it, BN on float32, its output cast back before the ReLU."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for conv, bn in zip(convs, bns):
        x = dense(conv, x, compute_dtype)
        x = bn(to_f32(x, compute_dtype).reshape(-1, x.shape[-1])).reshape(x.shape)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        x = torch.relu(x)
    return x


def _group_indices(xyz, centers, radius_list, nsample_list, knn, valid_mask):
    """Per-scale neighbourhood indices. kNN lists and equal-radius ball
    queries of one query are prefixes of the longest one, so scales sharing a
    query slice one max-k computation (as the JAX package does)."""
    if knn:
        _, idx = knn_point(max(nsample_list), centers, xyz)
        return [idx[..., :k] for k in nsample_list]
    out = [None] * len(radius_list)
    by_radius: dict[float, list[int]] = {}
    for i, r in enumerate(radius_list):
        by_radius.setdefault(float(r), []).append(i)
    for r, scale_ids in by_radius.items():
        kmax = max(nsample_list[i] for i in scale_ids)
        idx = query_ball_point(r, kmax, xyz, centers, valid_mask)
        for i in scale_ids:
            out[i] = idx[..., :nsample_list[i]]
    return out


def _group(xyz, feats, centers, group_idx):
    """Grouped features (B, S, K, D+3) in the reference's channel order
    [feats, rel_xyz] (just rel_xyz when feats is None)."""
    grouped_xyz = index_points(xyz, group_idx) - centers[:, :, None, :]
    if feats is None:
        return grouped_xyz
    return torch.cat([index_points(feats, group_idx), grouped_xyz], dim=-1)


class SetAbstractionMsg(nn.Module):
    """Multi-scale-grouping SA layer: FPS -> (ball|knn) group -> MLP -> max.
    `in_channel` is the feature width D of `feats` (0 for None)."""

    def __init__(self, npoint: int, radius_list, nsample_list, mlp_list,
                 in_channel: int = 0, knn: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.npoint = npoint
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.knn = knn
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for widths in mlp_list:
            convs, bns = shared_mlp_layers(in_channel + 3, widths)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)
        self.out_channel = sum(m[-1] for m in mlp_list)

    def forward(self, xyz, feats=None, valid_mask=None):
        """xyz (B, N, 3), feats (B, N, D) or None -> new_xyz (B, npoint, 3),
        new_feats (B, npoint, sum(mlp[-1]))."""
        fps_idx = farthest_point_sample(xyz, self.npoint, valid_mask)
        new_xyz = index_points(xyz, fps_idx)
        groups = _group_indices(xyz, new_xyz, self.radius_list,
                                self.nsample_list, self.knn, valid_mask)
        outs = []
        for convs, bns, group_idx in zip(self.conv_blocks, self.bn_blocks, groups):
            grouped = _group(xyz, feats, new_xyz, group_idx)
            h = shared_mlp(convs, bns, grouped, self.compute_dtype)
            outs.append(torch.max(h, dim=2).values)
        return new_xyz, torch.cat(outs, dim=-1)


class SetAbstractionAll(nn.Module):
    """group_all SA: one global group over all points -> MLP -> max."""

    def __init__(self, mlp: Sequence[int], in_channel: int = 0, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp_convs, self.mlp_bns = shared_mlp_layers(in_channel + 3, mlp)
        self.out_channel = mlp[-1]

    def forward(self, xyz, feats=None):
        """xyz (B, N, 3), feats (B, N, D) -> new_xyz (B, 1, 3) zeros,
        new_feats (B, 1, mlp[-1])."""
        grouped = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        h = shared_mlp(self.mlp_convs, self.mlp_bns, grouped[:, None], self.compute_dtype)
        return torch.zeros_like(xyz[:, :1, :]), torch.max(h, dim=2).values


class FeaturePropagation(nn.Module):
    """Inverse-squared-distance 3-NN feature upsampling + MLP.
    `in_channel` = D1 + D2."""

    def __init__(self, mlp: Sequence[int], in_channel: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp_convs, self.mlp_bns = shared_mlp_layers(in_channel, mlp)
        self.out_channel = mlp[-1]

    def forward(self, xyz1, xyz2, feats1, feats2):
        """xyz1 (B, N, 3) dense, xyz2 (B, S, 3) sparse, feats1 (B, N, D1) or
        None, feats2 (B, S, D2) -> (B, N, mlp[-1])."""
        n = xyz1.shape[1]
        if xyz2.shape[1] == 1:
            interpolated = feats2.expand(feats2.shape[0], n, feats2.shape[-1])
        else:
            dist2, idx = three_nn(xyz1, xyz2)
            recip = 1.0 / (dist2 + 1e-8)
            weight = recip / torch.sum(recip, dim=-1, keepdim=True)
            interpolated = torch.sum(index_points(feats2, idx) * weight[..., None],
                                     dim=2)
        if feats1 is not None:
            interpolated = torch.cat([feats1, interpolated], dim=-1)
        return shared_mlp(self.mlp_convs, self.mlp_bns, interpolated, self.compute_dtype)


class SetAbstractionAtCenters(nn.Module):
    """SA at given centres (no FPS): query neighbourhoods of the keypoints in
    the cloud, optionally concat a per-centre feature, optionally reuse a
    previous group index. `in_channel` = D of feats, `center_channel` = Dc."""

    def __init__(self, radius_list, nsample_list, mlp_list, in_channel: int,
                 center_channel: int = 0, knn: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.knn = knn
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for widths in mlp_list:
            convs, bns = shared_mlp_layers(in_channel + 3 + center_channel, widths)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)
        self.out_channel = sum(m[-1] for m in mlp_list)

    def forward(self, xyz, feats, centers, center_feats=None, pre_group_idx=None,
                return_group_idx: bool = False, valid_mask=None):
        """xyz (B, N, 3), feats (B, N, D), centers (B, S, 3), center_feats
        (B, S, Dc) or None -> new_feats (B, S, sum(mlp[-1])) [, group_idx list]."""
        if pre_group_idx is None:
            pre_group_idx = _group_indices(xyz, centers, self.radius_list,
                                           self.nsample_list, self.knn, valid_mask)
        outs = []
        for convs, bns, group_idx in zip(self.conv_blocks, self.bn_blocks,
                                         pre_group_idx):
            grouped = _group(xyz, feats, centers, group_idx)
            if center_feats is not None:
                tiled = center_feats[:, :, None, :].expand(
                    *grouped.shape[:3], center_feats.shape[-1])
                grouped = torch.cat([grouped, tiled], dim=-1)
            h = shared_mlp(convs, bns, grouped, self.compute_dtype)
            outs.append(torch.max(h, dim=2).values)
        new_feats = torch.cat(outs, dim=-1)
        if return_group_idx:
            return new_feats, list(pre_group_idx)
        return new_feats
