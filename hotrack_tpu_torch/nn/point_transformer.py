"""PointTransformer module set, an alternate backbone family (port of
hotrack_tpu/nn/point_transformer.py).

Vector attention over kNN neighbourhoods (without a relative positional
embedding, as in the reference's variant), residual blocks, FPS + kNN
transition down and 3-NN interpolation transition up, and the down / up
blocks that stack them. Channels-last: points (B, N, 3), features (B, N, C).
Unlike flax, a torch layer is built with its input width, so the blocks take
theirs as arguments (`in_channel`, `low_channel`). On the card, FPS and the
neighbourhood gathers run the hand-written kernels (csrc/fps.cu,
csrc/gather_rows.cu) through ops/pointops. BatchNorm is `nn.BatchNorm1d`
(eps 1e-5), not the JAX package's compensated BatchNorm.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pointops import farthest_point_sample, index_points, knn_point, three_nn
from .pointnet2 import shared_mlp, shared_mlp_layers


class PointTransformerLayer(nn.Module):
    """Vector attention: per point, softmax over its k nearest neighbours
    (itself included) of an MLP of q - k, weighting the neighbours' v."""

    def __init__(self, dim: int, attn_mlp_hidden_mult: int = 4, num_neighbors: int = 16,
                 in_channel: int | None = None):
        super().__init__()
        self.num_neighbors = num_neighbors
        self.to_qkv = nn.Linear(dim if in_channel is None else in_channel, dim * 3, bias=False)
        self.attn_mlp1 = nn.Linear(dim, dim * attn_mlp_hidden_mult)
        self.attn_mlp2 = nn.Linear(dim * attn_mlp_hidden_mult, dim)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """xyz (B, N, 3), points (B, N, D) -> (B, N, dim)."""
        _, group_idx = knn_point(self.num_neighbors, xyz, xyz)
        q, k, v = torch.chunk(self.to_qkv(points), 3, dim=-1)
        k_g, v_g = index_points(k, group_idx), index_points(v, group_idx)   # (B, N, K, dim)
        sim = self.attn_mlp2(torch.relu(self.attn_mlp1(q[:, :, None, :] - k_g)))
        return torch.sum(torch.softmax(sim, dim=2) * v_g, dim=2)


class PointTransformerResBlock(nn.Module):
    """Linear down to dim // div -> transformer layer -> linear up, plus the
    input."""

    def __init__(self, dim: int, div: int = 4, attn_mlp_hidden_mult: int = 4,
                 num_neighbors: int = 16):
        super().__init__()
        mid = dim // div
        self.linear_down = nn.Linear(dim, mid)
        self.transformer = PointTransformerLayer(mid, attn_mlp_hidden_mult, num_neighbors)
        self.linear_up = nn.Linear(mid, dim)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        return points + self.linear_up(self.transformer(xyz, self.linear_down(points)))


class PointTransformerTransitionDown(nn.Module):
    """FPS -> kNN group -> [features, relative xyz] -> MLP -> max.
    `in_channel` is the width of the input features (0 for none)."""

    def __init__(self, npoint: int, nsample: int, out_channel: int, in_channel: int = 0):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.mlp_convs, self.mlp_bns = shared_mlp_layers(in_channel + 3, (out_channel,))

    def forward(self, xyz, points=None, valid_mask=None):
        """-> new_xyz (B, npoint, 3), new_points (B, npoint, out_channel)."""
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint, valid_mask))
        _, group_idx = knn_point(self.nsample, new_xyz, xyz)
        grouped = index_points(xyz, group_idx) - new_xyz[:, :, None, :]
        if points is not None:
            grouped = torch.cat([index_points(points, group_idx), grouped], dim=-1)
        h = shared_mlp(self.mlp_convs, self.mlp_bns, grouped)
        return new_xyz, torch.max(h, dim=2).values


class PointTransformerTransitionUp(nn.Module):
    """MLP on the coarse features, 3-NN inverse-distance interpolation onto
    the dense points (a broadcast from a single coarse point), plus the dense
    features. `low_channel` is the coarse features' width."""

    def __init__(self, high_channel: int, low_channel: int):
        super().__init__()
        self.mlp_convs, self.mlp_bns = shared_mlp_layers(low_channel, (high_channel,))

    def forward(self, xyz_low, xyz_high, points_low, points_high):
        """xyz_low (B, S, 3) coarse, xyz_high (B, N, 3) dense -> (B, N,
        high_channel)."""
        h = shared_mlp(self.mlp_convs, self.mlp_bns, points_low)
        if xyz_low.shape[1] == 1:
            interpolated = h.expand(h.shape[0], xyz_high.shape[1], h.shape[-1])
        else:
            dist2, idx = three_nn(xyz_high, xyz_low)
            recip = 1.0 / (dist2 + 1e-8)
            weight = recip / torch.sum(recip, dim=-1, keepdim=True)
            interpolated = torch.sum(index_points(h, idx) * weight[..., None], dim=2)
        return interpolated + points_high


class PointTransformerDownBlock(nn.Module):
    """Transition down, then num_attn residual transformer blocks."""

    def __init__(self, npoint: int, nsample: int, out_channel: int, num_attn: int = 1,
                 div: int = 4, in_channel: int = 0):
        super().__init__()
        self.transition = PointTransformerTransitionDown(npoint, nsample, out_channel,
                                                         in_channel)
        self.blocks = nn.ModuleList(PointTransformerResBlock(out_channel, div,
                                                             num_neighbors=nsample)
                                    for _ in range(num_attn))

    def forward(self, xyz, points=None, valid_mask=None):
        xyz, points = self.transition(xyz, points, valid_mask)
        for block in self.blocks:
            points = block(xyz, points)
        return xyz, points


class PointTransformerUpBlock(nn.Module):
    """Transition up, then num_attn residual transformer blocks on the dense
    points."""

    def __init__(self, nsample: int, high_channel: int, low_channel: int, num_attn: int = 1,
                 div: int = 4):
        super().__init__()
        self.transition = PointTransformerTransitionUp(high_channel, low_channel)
        self.blocks = nn.ModuleList(PointTransformerResBlock(high_channel, div,
                                                             num_neighbors=nsample)
                                    for _ in range(num_attn))

    def forward(self, xyz_low, xyz_high, points_low, points_high):
        points = self.transition(xyz_low, xyz_high, points_low, points_high)
        for block in self.blocks:
            points = block(xyz_high, points)
        return points
