"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/nn/blocks.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

Keypoint rearrange module and the sine positional embedding.

Port of the HandTrackNet part of hotrack_tpu/nn/blocks.py. Channels-last.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .precision import dense

# four fixed skeleton-topology permutations of the 21 keypoints:
# neighbours along fingers / across the palm
REARRANGE_1 = (1, 2, 3, 4, 4, 6, 7, 8, 8, 10, 11, 12, 12, 14, 15, 16, 16, 18, 19, 20, 20)
REARRANGE_2 = (17, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19)
REARRANGE_3 = (1, 1, 2, 3, 4, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
REARRANGE_4 = (17, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 17, 18, 19, 20)
_PERMS = (REARRANGE_1, REARRANGE_2, REARRANGE_3, REARRANGE_4)


class RearrangeModule(nn.Module):
    """Concat 5 skeleton-permuted copies of the per-keypoint features and map
    them back: (B, 21, channel) -> (B, 21, channel), in the compute dtype
    where one is set (nn/precision.py)."""

    def __init__(self, channel: int = 384, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.linear = nn.Linear(5 * channel, channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x] + [x[:, list(p), :] for p in _PERMS], dim=-1)
        return dense(self.linear, x, self.compute_dtype)


def position_embedding_sine(coor: torch.Tensor, num_pos_feats: int = 64) -> torch.Tensor:
    """NeRF-style sin/cos embedding of globally min-max normalised
    coordinates: (B, N, 3) -> (B, N, 6 * num_pos_feats). HandTrackNet in FFN
    mode never consumes it, so its forward does not compute it."""
    normal = 2.0 * (coor - coor.min()) / (coor.max() - coor.min() + 1e-12) - 1.0
    freqs = math.pi * (2.0 ** torch.arange(num_pos_feats, dtype=coor.dtype,
                                           device=coor.device))
    k = normal[..., None] * freqs  # (B, N, 3, D)
    x = torch.cat([torch.sin(k), torch.cos(k)], dim=-1)
    return x.reshape(coor.shape[0], coor.shape[1], -1)
