"""Part-DoF pose evaluation: rotation / translation error and the 5deg5cm /
10deg10cm accuracies (port of hotrack_tpu/pose/part_dof.py).

Poses are dicts with 'rotation' (..., P, 3, 3) and 'translation'
(..., P, 3, 1); `eval_part_full` returns per-part means keyed
'<metric>_<part>'.
"""

from __future__ import annotations

import torch

from .metrics import rot_diff_degree, trans_diff


def eval_part_model(gt: dict, pred: dict, axis: int, up_and_down_sym: bool = False):
    tdiff = trans_diff(gt["translation"].squeeze(-1), pred["translation"].squeeze(-1))
    rdiff = rot_diff_degree(gt["rotation"], pred["rotation"], axis=axis,
                            up_and_down_sym=up_and_down_sym)
    return {"tdiff": tdiff, "rdiff": rdiff}


def eval_part_full(gt: dict, pred: dict, axis: int, up_and_down_sym: bool = False,
                   per_instance: bool = False):
    """Inputs have a trailing part axis P; returns (means over the batch
    keyed '<key>_<p>', the per-instance values under the same keys or {})."""
    pdiff = eval_part_model(gt, pred, axis=axis, up_and_down_sym=up_and_down_sym)
    pdiff["5deg5cm"] = torch.logical_and(pdiff["rdiff"] <= 5.0,
                                         pdiff["tdiff"] <= 0.05).float()
    pdiff["10deg10cm"] = torch.logical_and(pdiff["rdiff"] <= 10.0,
                                           pdiff["tdiff"] <= 0.10).float()
    flat = {f"{key}_{i}": pdiff[key][..., i]
            for key in pdiff for i in range(pdiff[key].shape[-1])}
    per_diff = dict(flat) if per_instance else {}
    mean = {key: torch.mean(value, dim=0) for key, value in flat.items()}
    return mean, per_diff


def pose_with_part(model: dict, src: torch.Tensor) -> torch.Tensor:
    """Apply per-part similarity transforms to canonical points
    src (..., P, N, 3)."""
    est = torch.matmul(src, model["rotation"].transpose(-1, -2))
    est = est * model["scale"][..., None, None]
    return est + model["translation"].transpose(-1, -2)


def compute_parts_delta_pose(init: dict, final: dict, canon: dict) -> dict:
    """Relative pose of `final` w.r.t. `init`, expressed in the `canon`
    frame."""
    if canon["scale"].dim() < final["scale"].dim():
        canon = {k: v[:, None] for k, v in canon.items()}
    s_0, s_f, s_c = init["scale"], final["scale"], canon["scale"]
    t_0, t_f, t_c = init["translation"], final["translation"], canon["translation"]
    r_0, r_f, r_c = init["rotation"], final["rotation"], canon["rotation"]

    s_delta = s_f / s_0
    r_delta = torch.matmul(torch.matmul(r_c.transpose(-1, -2), r_f),
                           torch.matmul(r_0.transpose(-1, -2), r_c))
    t = t_f - t_c
    correction = s_delta[..., None, None] * torch.matmul(
        torch.matmul(r_f, r_0.transpose(-1, -2)), t_0 - t_c)
    t = torch.where(torch.max(torch.abs(t_0 - t_c)) > 1e-7, t - correction, t)
    t_delta = torch.matmul(r_c.transpose(-1, -2), t) / s_c[..., None, None]
    return {"scale": s_delta, "rotation": r_delta, "translation": t_delta}


def convert_pred_rtvec_to_matrix(pred: torch.Tensor, sym: bool,
                                 rotation_kind: str) -> torch.Tensor:
    """Raw network rotation head -> rotation matrices: symmetric parts
    regress a 3-d axis; otherwise a 6-d Gram-Schmidt or a 9-d
    SVD-orthogonalised parameterisation. pred (..., D) -> (..., 3, 3)."""
    from .rotations import (
        compute_rotation_matrix_from_3d,
        compute_rotation_matrix_from_9d,
        compute_rotation_matrix_from_ortho6d,
    )

    lead = pred.shape[:-1]
    if sym:
        return compute_rotation_matrix_from_3d(pred)
    if rotation_kind == "6d":
        return compute_rotation_matrix_from_ortho6d(pred)
    if rotation_kind == "9d":
        return compute_rotation_matrix_from_9d(pred.reshape(*lead, 3, 3))
    raise NotImplementedError(rotation_kind)
