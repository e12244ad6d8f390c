"""Sequence evaluation (port of hotrack_tpu/track/eval.py).

Hand: per-frame keypoint error (MPJPE, m) and the palm-Procrustes global R/t
errors. Object: symmetry-aware rotation / translation errors and the
5deg5cm / 10deg10cm accuracies (`eval_part_full`). Batched over the T frames.
"""

from __future__ import annotations

import torch

from ..models.hand_utils import canonicalize, solve_hand_frame
from ..pose.part_dof import eval_part_full
from .types import HandTrackResult, ObjTrackResult


@torch.inference_mode()
def eval_hand_sequence(result: HandTrackResult, gt_kp: torch.Tensor,
                       gt_palm_template: torch.Tensor) -> dict:
    """gt_kp (T, 21, 3); gt_palm_template (6, 3) or (T, 6, 3). Returns
    per-frame tensors (T,) and scalar means under 'mean/'."""
    kp_diff = torch.mean(torch.linalg.norm(result.pred_kp - gt_kp, dim=-1), dim=-1)

    scale = 0.2
    canon = solve_hand_frame(gt_palm_template, gt_kp)
    gt_scaled = canonicalize(gt_kp, canon) * scale
    pred_scaled = canonicalize(result.pred_kp, canon) * scale
    gt_frame = solve_hand_frame(gt_palm_template, gt_scaled)
    pred_frame = solve_hand_frame(gt_palm_template, pred_scaled)
    m = torch.matmul(pred_frame.rotation.transpose(-1, -2), gt_frame.rotation)
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    r_diff = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)) * 180.0 / torch.pi
    t_diff = torch.linalg.norm(
        pred_frame.translation[..., 0] - gt_frame.translation[..., 0], dim=-1)
    baseline_diff = torch.mean(
        torch.linalg.norm(result.baseline_pred_kp - gt_kp, dim=-1), dim=-1)

    return {
        "hand_pred_kp_diff": kp_diff,
        "hand_baseline_kp_diff": baseline_diff,
        "hand_pred_r_diff": r_diff,
        "hand_pred_t_diff": t_diff,
        "mean/hand_pred_kp_diff": torch.mean(kp_diff),
        "mean/hand_baseline_kp_diff": torch.mean(baseline_diff),
        "mean/hand_pred_r_diff": torch.mean(r_diff),
        "mean/hand_pred_t_diff": torch.mean(t_diff),
    }


@torch.inference_mode()
def eval_obj_sequence(result: ObjTrackResult, gt_rotation: torch.Tensor,
                      gt_translation: torch.Tensor, sym_axis: int,
                      up_and_down_sym: bool = False) -> dict:
    """Per-frame symmetry-aware object pose metrics. gt_rotation (T, 3, 3),
    gt_translation (T, 3, 1). Returns the per-frame tensors '<metric>_0' and
    their means under 'mean/'."""
    gt = {"rotation": gt_rotation[:, None], "translation": gt_translation[:, None]}
    pred = {"rotation": result.rotation[:, None],
            "translation": result.translation[:, None]}
    mean, per = eval_part_full(gt, pred, axis=int(sym_axis),
                               up_and_down_sym=up_and_down_sym, per_instance=True)
    out = {f"mean/{k}": v for k, v in mean.items()}
    out.update(per)
    return out
