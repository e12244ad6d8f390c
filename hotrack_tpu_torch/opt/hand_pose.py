"""MANO hand pose optimiser against the object's SDF and the silhouette,
gradient-free (port of hotrack_tpu.opt.hand_pose).

Per frame: 5 iterations x 5120 particles over 16 dims (3 of a rotation
quaternion, 3 of translation, 10 MANO PCA components scaled by 30). Energy
terms, weighted by the config's opt/energy_weight:

  - sil_loss: the share of the 778 MANO vertices whose pixel lies on the
    background mask;
  - penetrate_sum_loss: the largest |SDF| over the vertices inside the object;
  - vis_regu_loss / invis_regu_loss: keypoint distance to the HandTrackNet
    prediction, split by the visibility mask;
  - attraction_loss: pulls the contact zones of invisible fingertips onto the
    object's surface, switched for all candidates by particle 0's penetration;
  - temporal_smooth: keypoint distance to the last frame's keypoints.

The two per-vertex terms (sdf, silhouette hit) are where the time goes. The
JAX package picks their route by backend and environment variables; here it
is the argument `hand_energy` (the config key of the same name), and which
SDF is queried is decided by `distilled` (config key `sdf_query`):

  - 'skin' (default): `mano_skin_inputs` + ops/hand_energy_skin (on the card
    the kernel of csrc/hand_energy_skin.cu: the vertices never reach memory);
  - 'fused': `mano_forward` + ops/hand_energy (csrc/hand_energy.cu);
  - 'separate': `mano_forward`, a matrix product into the object's frame,
    ops/sdf_mlp (csrc/sdf_mlp.cu) and ops/mask_lookup (csrc/mask_lookup.cu);
  - no `distilled`: the nearest-voxel volume lookup and ops/mask_lookup,
    whatever `hand_energy` says.

On CPU tensors every route runs the plain versions of those modules.

Several sequences at once (the JAX package's `vmap` of this optimiser) take
each per-sequence input with a leading S, stacked from the single sequence's
shapes (hand_shape (S, 1, 10), init_rotation (S, 1, 3, 3), pred_kp
(S, 1, 21, 3), vis_mask (S, 1, 21), obj_rotation (S, 3, 3), background_mask
(S, H, W) padded to one size, intrinsics of shape (S,)), a list of S
distilled models or volumes (S, V, V, V), and the shared bank. The routes
become the batched kernels: 'skin' #7b, 'fused' and 'separate' #3b + #5b,
'volume' each sequence's nearest voxel + #5b.

HOTRACK_SDF_BF16 (`sdf.distill.sdf_compute_dtype`, read at each call) puts
the SDF queries of 'skin', 'fused' and 'separate' in bf16, as in the JAX
package; the volume route and the silhouette terms are unchanged.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..mano.layer import mano_forward, mano_skin_inputs, pca_comps2pose, shape_hand
from ..mano.model import TIPS_RIGHT, ManoModel, index_tensor
from ..ops.hand_energy import (fused_hand_energy, fused_hand_energy_batched, hand_frame,
                               pixel_coords)
from ..ops.hand_energy_skin import (fused_hand_energy_skin, fused_hand_energy_skin_batched,
                                    skin_consts)
from ..ops.mask_lookup import pack_mask, packed_mask_lookup, packed_mask_lookup_batched
from ..ops.sdf_mlp import (fused_sdf_mlp, fused_sdf_mlp_batched, pack_distilled,
                           pack_distilled_batched)
from ..pose.rotations import (
    mano_quat2axisang,
    matrix_to_unit_quaternion,
    unit_quaternion_to_matrix,
)
from ..sdf.distill import sdf_compute_dtype
from ..sdf.volume import nearest_sdf
from ..utils.trace import spanned
from .obj_pose import _reproject_so3
from .particle import (
    ParticleSpec,
    normalize_quat_head,
    quat_extend,
    run_particle_opt,
)

POSE_SPEC = ParticleSpec(iterations=5, scaling_coefficient2=0.1, beta=0.9)
INITIAL_SCALE = 0.005
THETA_SCALE = 30.0
NCOMPS = 10
# fingertip keypoint ids checked for visibility
TIP_KP_IDS = (8, 12, 16, 20, 4)
HAND_ENERGY_ROUTES = ("skin", "fused", "separate")


class ContactZones(NamedTuple):
    """Fingertip contact-zone vertex ids, padded per finger: tips_idx (5, K)
    int64 vertex ids, tips_mask (5, K) bool, True where an entry is one."""

    tips_idx: torch.Tensor
    tips_mask: torch.Tensor

    def to(self, device) -> "ContactZones":
        return ContactZones(self.tips_idx.to(device), self.tips_mask.to(device))


def load_contact_zones(path: str | None = None, device=None) -> ContactZones:
    """The Obman contact zones (zones 1..5 of contact_zones.pkl are the
    fingertips). Without the asset, the 16 vertices around each MANO
    fingertip vertex: enough for tests and the synthetic rig."""
    if path is not None:
        with open(path, "rb") as f:
            contact_data = pickle.load(f)
        zones = [np.asarray(contact_data["contact_zones"][i + 1]) for i in range(5)]
    else:
        zones = [np.arange(t - 8, t + 8) % 778 for t in TIPS_RIGHT]
    kmax = max(len(z) for z in zones)
    idx = np.zeros((5, kmax), np.int64)
    mask = np.zeros((5, kmax), bool)
    for i, z in enumerate(zones):
        idx[i, :len(z)] = z
        mask[i, :len(z)] = True
    return ContactZones(torch.from_numpy(idx), torch.from_numpy(mask)).to(device)


def world2point2d(xyz: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame points (..., 3) -> (y, x) pixel coordinates (..., 2)."""
    x = xyz[..., 0] / xyz[..., 2] * fx + cx
    y = xyz[..., 1] / xyz[..., 2] * fy + cy
    return torch.stack([y, x], dim=-1)


@spanned("opt.hand_pose")
@torch.no_grad()
def optimize_hand_pose(
    mano_model: ManoModel,
    presampled: torch.Tensor,         # (P, 16) fixed particle bank
    zones: ContactZones,
    sdf_volume: torch.Tensor | None,  # (V, V, V) object SDF (151^3 at 3 mm)
    hand_shape: torch.Tensor,         # (1, 10) optimised beta
    init_rotation: torch.Tensor,      # (1, 3, 3) global hand rotation
    init_translation: torch.Tensor,   # (1, 3, 1)
    init_theta: torch.Tensor,         # (1, 45) MANO joint axis-angles
    pred_kp: torch.Tensor,            # (1, 21, 3) HandTrackNet prediction
    vis_mask: torch.Tensor,           # (1, 21) bool keypoint visibility
    last_frame_kp: torch.Tensor,      # (1, 21, 3); pred_kp and has_last = 0 on frame 0
    has_last,                         # number or 0-d tensor in {0., 1.}
    obj_rotation: torch.Tensor,       # (3, 3) object pose (the SDF's frame)
    obj_translation: torch.Tensor,    # (3,)
    background_mask: torch.Tensor,    # (H, W) bool: True = background pixel
    intrinsics: dict,                 # fx, fy, cx, cy: numbers or 0-d tensors
    energy_weight: dict,              # the config's opt/energy_weight map
    voxel_scale: float = 0.003,
    iterations: int = POSE_SPEC.iterations,
    distilled=None,                   # DistilledSDF: SDF queries through the MLP
    hand_energy: str = "skin",
    packed=None,                      # ops/sdf_mlp.PackedSDF of `distilled`
    trace: list | None = None,
):
    """Returns (final_kp (1, 21, 3), theta (1, 45), rotation (1, 3, 3),
    translation (1, 3, 1), final_energy ()), each with a leading S for S
    sequences. All tensors on one device; nothing here waits for the
    device."""
    if hand_energy not in HAND_ENERGY_ROUTES:
        raise ValueError(f"hand_energy must be one of {HAND_ENERGY_ROUTES}, "
                         f"got {hand_energy!r}")
    if distilled is None and sdf_volume is None:
        raise ValueError("optimize_hand_pose needs a distilled SDF or an SDF volume")
    spec = POSE_SPEC._replace(iterations=iterations)
    batch = tuple(init_theta.shape[:-2])     # () or (S,)
    if distilled is not None and hasattr(distilled, "weights") == bool(batch):
        raise ValueError(f"init_theta {tuple(init_theta.shape)} takes "
                         f"{'a list of models, one a sequence' if batch else 'one model'}")
    p = presampled.shape[0]
    hw = tuple(background_mask.shape[-2:])
    mask_bits = torch.stack([pack_mask(m) for m in background_mask]) if batch \
        else pack_mask(background_mask)
    frame = hand_frame(obj_rotation, obj_translation, intrinsics["fx"], intrinsics["fy"],
                       intrinsics["cx"], intrinsics["cy"])
    shaped = shape_hand(mano_model, hand_shape.reshape(-1, 10))
    route = hand_energy if distilled is not None else "volume"
    if distilled is not None and packed is None and presampled.is_cuda:
        packed = (pack_distilled_batched if batch else pack_distilled)(distilled)
    consts = skin_consts(mano_model, shaped, batched=bool(batch)) if route == "skin" else None
    compute_dtype = sdf_compute_dtype()
    n_verts = mano_model.weights.shape[0]
    vis = vis_mask.to(presampled.dtype)[..., 0, :]             # (*b, 21)
    invis_finger = 1.0 - vis[..., index_tensor(TIP_KP_IDS, vis.device)]   # (*b, 5)
    n_vis = torch.clamp(torch.sum(vis, dim=-1), min=1.0)
    n_invis = torch.clamp(torch.sum(1.0 - vis, dim=-1), min=1.0)
    # the same values give the same result bitwise whatever layout they came in
    init_rotation = init_rotation.contiguous()

    def candidate_pose(params, sample_ext):
        r, t, theta = params
        new_r = torch.matmul(r, unit_quaternion_to_matrix(sample_ext[..., :4]))
        new_t = t + sample_ext[..., 4:7, None]
        new_theta = theta + pca_comps2pose(mano_model, sample_ext[..., 7:], NCOMPS) * THETA_SCALE
        axisang = mano_quat2axisang(matrix_to_unit_quaternion(new_r))
        return torch.cat([axisang, new_theta], dim=-1), new_t[..., 0]

    def energy_fn(params, sample_ext):
        pose, new_t = candidate_pose(params, sample_ext)   # (*b, P, 48), (*b, P, 3)
        pose, new_t = pose.reshape(-1, 48), new_t.reshape(-1, 3)
        if route == "skin":
            kp, pose_map, rt_flat, offset = mano_skin_inputs(mano_model, pose, new_t, shaped)
            if batch:
                sdf, hits = fused_hand_energy_skin_batched(
                    distilled, mask_bits, frame, pose_map.reshape(*batch, p, -1),
                    rt_flat.reshape(*batch, p * 12, -1), offset.reshape(*batch, p, 3), consts,
                    hw, packed, compute_dtype)
            else:
                sdf, hits = fused_hand_energy_skin(distilled, mask_bits, frame, pose_map,
                                                   rt_flat, offset, consts, hw, packed,
                                                   compute_dtype)
        else:
            hand, kp = mano_forward(mano_model, pose, trans=new_t, shaped=shaped)
            hand = hand.reshape(*batch, p, n_verts, 3)
            if route == "fused":
                fused = fused_hand_energy_batched if batch else fused_hand_energy
                sdf, hits = fused(distilled, mask_bits, frame, hand, hw, packed, compute_dtype)
            else:
                if batch:
                    obj_frame = torch.matmul(hand - obj_translation[:, None, None, :],
                                             obj_rotation[:, None])
                else:
                    obj_frame = torch.matmul(hand - obj_translation.reshape(1, 1, 3),
                                             obj_rotation)
                if route == "separate":
                    sdf = (fused_sdf_mlp_batched if batch else fused_sdf_mlp)(
                        distilled, obj_frame, packed, compute_dtype)
                elif batch:
                    sdf = torch.stack([nearest_sdf(v, o, voxel_scale, v.shape[0])
                                       for v, o in zip(sdf_volume, obj_frame)])
                else:
                    sdf = nearest_sdf(sdf_volume, obj_frame, voxel_scale, sdf_volume.shape[0])
                lookup = packed_mask_lookup_batched if batch else packed_mask_lookup
                hits = lookup(mask_bits, *pixel_coords(hand, frame, hw), hw)
        return _terms(sdf, torch.sum(hits, dim=-1) / n_verts, kp.reshape(*batch, p, 21, 3))

    def _terms(sdf, sil, kp):
        pen = torch.max(torch.abs(sdf) * (sdf < 0.0), dim=-1).values          # (*b, P)

        err = torch.linalg.norm(kp - pred_kp, dim=-1)                       # (*b, P, 21)
        vis_regu = torch.sum(err * vis[..., None, :], dim=-1) / n_vis[..., None]
        invis_regu = torch.sum(err * (1.0 - vis)[..., None, :], dim=-1) / n_invis[..., None]

        smooth = torch.mean(torch.linalg.norm(kp - last_frame_kp, dim=-1), dim=-1) * has_last

        # fingertip attraction, switched for every candidate of a sequence by its particle 0
        region = sdf[..., zones.tips_idx]                                   # (*b, P, 5, K)
        region = region * (region > 0.0)
        region = torch.where(zones.tips_mask[None], region,
                             torch.full_like(region, float("inf")))
        per_finger = torch.min(region, dim=-1).values                       # (*b, P, 5)
        attr = torch.sum(per_finger * invis_finger[..., None, :], dim=-1) \
            * (pen[..., :1] != 0.0)

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
        theta = theta + pca_comps2pose(mano_model, mean_ext[..., None, 7:], NCOMPS) * THETA_SCALE
        return r, t, theta

    (r, t, theta), last_energy = run_particle_opt(
        spec, presampled, INITIAL_SCALE, (init_rotation, init_translation, init_theta),
        energy_fn, apply_mean, extend_sample=quat_extend,
        postprocess_mean=normalize_quat_head, search_slice=lambda m: m[..., 1:], trace=trace,
        batch=batch)

    axisang = mano_quat2axisang(matrix_to_unit_quaternion(r))
    _, final_kp = mano_forward(mano_model, torch.cat([axisang, theta], dim=-1).reshape(-1, 48),
                               trans=t[..., 0].reshape(-1, 3), shaped=shaped)
    return final_kp.reshape(*batch, 1, 21, 3), theta, r, t, last_energy
