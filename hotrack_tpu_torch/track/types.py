"""Result tuples of the trackers (port of hotrack_tpu/track/types.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class HandTrackResult(NamedTuple):
    """Per-sequence hand tracking outputs; leading axis T (frames)."""

    pred_kp: torch.Tensor             # (T, 21, 3) final keypoints
    baseline_pred_kp: torch.Tensor    # (T, 21, 3) raw HandTrackNet keypoints
    canon_rotation: torch.Tensor      # (T, 3, 3) hand-frame canonicalisation
    canon_translation: torch.Tensor   # (T, 3, 1)
    global_rotation: torch.Tensor     # (T, 3, 3) IKNet/opt global pose
    global_translation: torch.Tensor  # (T, 3, 1)
    mano_theta: torch.Tensor          # (T, 45)
    pred_beta: torch.Tensor           # (1, 10)


class ObjTrackResult(NamedTuple):
    """Per-sequence object tracking outputs; leading axis T."""

    rotation: torch.Tensor      # (T, 3, 3)
    translation: torch.Tensor   # (T, 3, 1)
    sdf_energy: torch.Tensor    # (T,) final per-frame SDF energies
