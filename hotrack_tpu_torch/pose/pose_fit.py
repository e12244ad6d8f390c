"""Per-part pose fitting from correspondences (port of
hotrack_tpu/pose/pose_fit.py): a masked similarity fit of each part's scale
and translation given its rotation, for part poses recovered from NOCS-style
correspondences."""

from __future__ import annotations

import torch

from .procrustes import transform_pts_mask


def part_fit_st_no_ransac(labels: torch.Tensor, source: torch.Tensor, target: torch.Tensor,
                          rotation: torch.Tensor, num_parts: int, given_scale=None,
                          sym: bool = False) -> dict:
    """labels (B, N) part ids; source / target (B, N, 3); rotation (B, P, 3,
    3). Returns {'rotation', 'scale' (B, P), 'translation' (B, P, 3, 1)}."""
    scales, translations = [], []
    for p in range(num_parts):
        mask = (labels == p).to(source.dtype)[..., None]      # (B, N, 1)
        gs = None if given_scale is None else given_scale[:, p]
        _, s, t = transform_pts_mask(source, target, mask, mask, given_scale=gs,
                                     rotation=rotation[:, p], sym=sym)
        scales.append(s)
        translations.append(t)
    return {"rotation": rotation, "scale": torch.stack(scales, dim=1),
            "translation": torch.stack(translations, dim=1)}
