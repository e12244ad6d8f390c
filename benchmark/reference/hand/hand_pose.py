"""Plain reference (benchmark) of the hand pose optimiser of the paper's hand
pipeline (arXiv:2209.12009), after hotrack_tpu_torch/opt/hand_pose.py, with
the energy composed of plain parts: MANO's forward pass (`mano_layer`), the
vertices in the object's frame, the distilled SDF's plain MLP
(`reference.sdf`) and the silhouette bit read straight from the (H, W) mask.

Per frame, from IKNet's pose: 5 rounds of the particle search over a fixed
bank (P, 16) -- a quaternion and a translation of the global pose and 10 PCA
components of the joint angles, scaled by the search size -- scoring
  sil 0.1 x the share of vertices on background pixels
  + pen 1 x the deepest penetration into the object (max |sdf| of sdf < 0)
  + vis 10 x the mean distance of visible keypoints to HandTrackNet's
  + invis 0 x that of the invisible ones
  + smooth 1 x the mean distance to the last frame's keypoints (not frame 0)
  + attraction 0.05 x the fingertips' zones' least positive sdf, for fingers
    whose tip is invisible, while the current pose (particle 0) penetrates.
Any number B of independent items (a frame of a sequence each) at once.
"""

from __future__ import annotations

import torch

from .. import sdf as ref_sdf
from .mano_layer import mano_forward, pca_comps2pose, shape_hand
from .particle import ParticleSpec, normalize_quat_head, quat_extend, run_particle_opt
from .rotations import (compute_rotation_matrix_from_ortho6d, mano_quat2axisang,
                        matrix_to_unit_quaternion, unit_quaternion_to_matrix)

POSE_SPEC = ParticleSpec(iterations=5, scaling_coefficient2=0.1, beta=0.9)
INITIAL_SCALE = 0.005
THETA_SCALE = 30.0
NCOMPS = 10
TIP_KP_IDS = (8, 12, 16, 20, 4)
TIPS_RIGHT = (745, 317, 444, 556, 673)


def contact_zones(device=None) -> tuple:
    """The 16 vertices around each MANO fingertip vertex (the port's stand-in
    for the licensed Obman zones): ids (5, 16), mask (5, 16)."""
    idx = torch.stack([(torch.arange(t - 8, t + 8) % 778) for t in TIPS_RIGHT]).to(device)
    return idx, torch.ones_like(idx, dtype=torch.bool)


def _reproject_so3(r: torch.Tensor) -> torch.Tensor:
    return compute_rotation_matrix_from_ortho6d(
        r.reshape(*r.shape[:-2], 9)[..., :6]).transpose(-1, -2).contiguous()


def pixel_coords(points: torch.Tensor, intr: torch.Tensor, hw) -> tuple:
    """(iy, ix) of camera-frame points (B, ..., 3) under intrinsics (B, 4)
    fx, fy, cx, cy: (a / z) * f + c truncated toward zero, clipped."""
    h, w = hw
    shape = (-1,) + (1,) * (points.dim() - 2)
    fx, fy, cx, cy = (intr[:, i].reshape(shape) for i in range(4))
    z = points[..., 2]
    iy = torch.clamp((points[..., 1] / z * fy + cy).to(torch.int32), 0, h - 1)
    ix = torch.clamp((points[..., 0] / z * fx + cx).to(torch.int32), 0, w - 1)
    return iy, ix


@torch.no_grad()
def optimise(mano, model, bank, zones, hand_shape, init_rotation, init_translation,
             init_theta, pred_kp, vis_mask, last_frame_kp, has_last, obj_rotation,
             obj_translation, masks, intrinsics, energy_weight):
    """Items on a leading axis B: hand_shape (B, 1, 10), init_rotation
    (B, 1, 3, 3), init_translation (B, 1, 3, 1), init_theta (B, 1, 45),
    pred_kp / last_frame_kp (B, 1, 21, 3), vis_mask (B, 1, 21), has_last
    (B,), obj_rotation (B, 3, 3), obj_translation (B, 3), masks (B, H, W)
    bool, intrinsics (B, 4) -> (keypoints (B, 1, 21, 3), theta (B, 1, 45),
    rotation (B, 1, 3, 3), translation (B, 1, 3, 1))."""
    b, p = init_theta.shape[0], bank.shape[0]
    hw = tuple(masks.shape[-2:])
    shaped = shape_hand(mano, hand_shape.reshape(-1, 10))
    n_verts = mano.weights.shape[0]
    vis = vis_mask.to(bank.dtype)[:, 0, :]
    invis_finger = 1.0 - vis[:, list(TIP_KP_IDS)]
    n_vis = torch.clamp(vis.sum(-1), min=1.0)
    n_invis = torch.clamp((1.0 - vis).sum(-1), min=1.0)
    tips_idx, tips_mask = zones
    rows = torch.arange(b, device=bank.device)[:, None, None]
    has_last = has_last.reshape(b, 1)

    def candidate_pose(params, ext):
        r, t, theta = params
        new_r = torch.matmul(r, unit_quaternion_to_matrix(ext[..., :4]))
        new_t = t + ext[..., 4:7, None]
        new_theta = theta + pca_comps2pose(mano, ext[..., 7:], NCOMPS) * THETA_SCALE
        axisang = mano_quat2axisang(matrix_to_unit_quaternion(new_r))
        return torch.cat([axisang, new_theta], dim=-1), new_t[..., 0]

    def energy_fn(params, ext):
        pose, new_t = candidate_pose(params, ext)
        hand, kp = mano_forward(mano, pose.reshape(-1, 48), trans=new_t.reshape(-1, 3),
                                shaped=shaped)
        hand = hand.reshape(b, p, n_verts, 3)
        obj_frame = torch.matmul(hand - obj_translation[:, None, None, :], obj_rotation[:, None])
        sdf = ref_sdf.sdf(model, obj_frame)
        iy, ix = pixel_coords(hand, intrinsics, hw)
        sil = masks[rows, iy.long(), ix.long()].to(bank.dtype).sum(-1) / n_verts
        kp = kp.reshape(b, p, 21, 3)
        pen = torch.max(torch.abs(sdf) * (sdf < 0.0), dim=-1).values
        err = torch.linalg.norm(kp - pred_kp, dim=-1)
        vis_regu = torch.sum(err * vis[:, None, :], dim=-1) / n_vis[:, None]
        invis_regu = torch.sum(err * (1.0 - vis)[:, None, :], dim=-1) / n_invis[:, None]
        smooth = torch.mean(torch.linalg.norm(kp - last_frame_kp, dim=-1), dim=-1) * has_last
        region = sdf[..., tips_idx]
        region = region * (region > 0.0)
        region = torch.where(tips_mask[None], region, torch.full_like(region, float("inf")))
        attr = torch.sum(torch.min(region, dim=-1).values * invis_finger[:, None, :], dim=-1) \
            * (pen[:, :1] != 0.0)
        energy = (energy_weight["sil_loss"] * sil
                  + energy_weight["penetrate_sum_loss"] * pen
                  + energy_weight["vis_regu_loss"] * vis_regu
                  + energy_weight["invis_regu_loss"] * invis_regu
                  + energy_weight["temporal_smooth"] * smooth
                  + energy_weight["attraction_loss"] * attr)
        return energy, energy

    def apply_mean(params, mean_ext):
        r, t, theta = params
        r = _reproject_so3(torch.matmul(r, unit_quaternion_to_matrix(mean_ext[..., None, :4])))
        t = t + mean_ext[..., None, 4:7, None]
        theta = theta + pca_comps2pose(mano, mean_ext[..., None, 7:], NCOMPS) * THETA_SCALE
        return r, t, theta

    (r, t, theta), _ = run_particle_opt(
        POSE_SPEC, bank, INITIAL_SCALE, (init_rotation.contiguous(), init_translation,
                                         init_theta),
        energy_fn, apply_mean, extend_sample=quat_extend, postprocess_mean=normalize_quat_head,
        search_slice=lambda m: m[..., 1:], batch=(b,))
    axisang = mano_quat2axisang(matrix_to_unit_quaternion(r))
    _, final_kp = mano_forward(mano, torch.cat([axisang, theta], dim=-1).reshape(-1, 48),
                               trans=t[..., 0].reshape(-1, 3), shaped=shaped)
    return final_kp.reshape(b, 1, 21, 3), theta, r, t
