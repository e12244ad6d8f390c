"""Hand tracking: the frame loop (port of
hotrack_tpu/track/hand.py:track_hand_sequence, and of the JAX runner's
`jax.vmap` of it over several sequences of equal length).

The JAX package runs the frames as one `lax.scan`; here the same step is a
Python loop over frames, with the state (last keypoints, palm template,
shape code, bone-length history) on the device and nothing read back on the
way:

  - the palm template starts as the rest-pose MANO's palm and is replaced by
    the optimised shape's when a shape mode is on;
  - frame 0 starts from the dataset's jittered keypoints; every later frame
    re-centres the previous prediction by the current cloud mean;
  - with IKNet: optional MANO shape optimisation from HandTrackNet's
    prediction on frame 0 (shape_mode 1), again every 10 frames (2), or every
    10 frames against the history of predicted bone lengths (3); IKNet ->
    MANO theta and global pose; optional per-frame pose optimisation against
    the object's SDF and the silhouette (`use_opt`).

`track_hand_sequences_batched` runs S sequences through the same loop with
the state carried per sequence along a leading axis (the shape modes'
re-optimisations fall on the same frames for every sequence); the nets take
batch S, and the optimisers their batched forms, which on the card launch the
batched kernels. `track_hand_sequence` is that loop with one sequence and the
unbatched optimisers.
"""

from __future__ import annotations

import torch

from ..mano.layer import mano_forward
from ..mano.model import ManoModel
from ..models.hand_network import HandTrackNet, IKNet, iknet_predict_kp
from ..models.hand_utils import handkp2palmkp
from ..ops.sdf_mlp import pack_distilled, pack_distilled_batched
from ..opt.hand_pose import ContactZones, optimize_hand_pose
from ..opt.hand_shape import kp2length, optimize_hand_shape
from .types import HandTrackResult

SHAPE_MODES = (0, 1, 2, 3)
HISTORY_ROWS = 64   # shape_mode 3: ring buffer of per-frame bone lengths
REOPT_EVERY = 10    # shape modes 2 and 3 re-optimise on frames 10, 20, ...


def _rest_palm_template(mano_model: ManoModel, beta: torch.Tensor) -> torch.Tensor:
    """Rest-pose palm keypoints (B, 6, 3) for the shapes beta (B, 10)."""
    _, kp = mano_forward(mano_model, torch.zeros((beta.shape[0], 48), dtype=beta.dtype,
                                                 device=beta.device), betas=beta)
    return handkp2palmkp(kp)


@torch.inference_mode()
def track_hand_sequence(
    handnet: HandTrackNet,
    mano_model: ManoModel,
    frames: dict,                                # (T, ...) tensors (prepare_batch output)
    iknet: IKNet | None = None,
    use_opt: bool = False,
    shape_mode: int | bool = False,              # False / 0: annotated beta; 1: optimised
                                                 # on frame 0; 2: again every 10 frames;
                                                 # 3: every 10 frames on the history
    shape_particles: torch.Tensor | None = None,   # (P, 10)
    pose_particles: torch.Tensor | None = None,    # (P, 16)
    zones: ContactZones | None = None,
    sdf_volume: torch.Tensor | None = None,
    background_masks: torch.Tensor | None = None,  # (T, H, W) bool
    energy_weight: dict | None = None,
    use_pred_obj_pose: bool = False,
    sdf_voxel_scale: float = 0.003,
    distilled=None,                              # DistilledSDF for the pose optimiser
    hand_energy: str = "skin",
) -> HandTrackResult:
    """Track one sequence on the device the frames lie on. Without `iknet`
    this is HandTrackNet alone and every other option is ignored, as in the
    JAX package; `use_opt` needs `iknet`, the particle banks and zones are
    needed where the options that use them are on."""
    return _track_hands(
        handnet, mano_model, frames, False, iknet=iknet, use_opt=use_opt,
        shape_mode=shape_mode, shape_particles=shape_particles,
        pose_particles=pose_particles, zones=zones, sdf_volume=sdf_volume,
        background_masks=background_masks, energy_weight=energy_weight,
        use_pred_obj_pose=use_pred_obj_pose, sdf_voxel_scale=sdf_voxel_scale,
        distilled=distilled, hand_energy=hand_energy)


@torch.inference_mode()
def track_hand_sequences_batched(
    handnet: HandTrackNet,
    mano_model: ManoModel,
    frames: dict,                                # (S, T, ...) tensors: S stacked batches
    iknet: IKNet | None = None,
    use_opt: bool = False,
    shape_mode: int | bool = False,
    shape_particles: torch.Tensor | None = None,   # (P, 10), shared
    pose_particles: torch.Tensor | None = None,    # (P, 16), shared
    zones: ContactZones | None = None,
    sdf_volumes: torch.Tensor | None = None,       # (S, V, V, V)
    background_masks: torch.Tensor | None = None,  # (S, T, H, W) bool, padded to one size
    energy_weight: dict | None = None,
    use_pred_obj_pose: bool = False,
    sdf_voxel_scale: float = 0.003,
    distilled=None,                              # a list of S DistilledSDF
    hand_energy: str = "skin",
) -> HandTrackResult:
    """Track S sequences of equal length T through one frame loop: the
    options of `track_hand_sequence`, with a volume, masks and a model a
    sequence. Returns a HandTrackResult whose fields carry a leading S
    (pred_beta (S, 1, 10))."""
    return _track_hands(
        handnet, mano_model, frames, True, iknet=iknet, use_opt=use_opt,
        shape_mode=shape_mode, shape_particles=shape_particles,
        pose_particles=pose_particles, zones=zones, sdf_volume=sdf_volumes,
        background_masks=background_masks, energy_weight=energy_weight,
        use_pred_obj_pose=use_pred_obj_pose, sdf_voxel_scale=sdf_voxel_scale,
        distilled=distilled, hand_energy=hand_energy)


def _track_hands(handnet, mano_model, frames, batched: bool, iknet=None, use_opt=False,
                 shape_mode=False, shape_particles=None, pose_particles=None, zones=None,
                 sdf_volume=None, background_masks=None, energy_weight=None,
                 use_pred_obj_pose=False, sdf_voxel_scale=0.003, distilled=None,
                 hand_energy="skin") -> HandTrackResult:
    """The frame loop over S sequences, state (S, ...) on the device; one
    sequence (batched False) is S = 1 with the unbatched optimisers, whose
    inputs lack the sequence axis (`seq`, `opt_in`, `opt_out` move between
    the two)."""
    shape_mode = int(shape_mode)
    if shape_mode not in SHAPE_MODES:
        raise ValueError(f"shape_mode must be one of {SHAPE_MODES}, got {shape_mode}")
    use_iknet = iknet is not None
    use_opt = bool(use_opt) and use_iknet
    if use_iknet and shape_mode and shape_particles is None:
        raise ValueError(f"shape_mode {shape_mode} needs shape_particles")
    if use_opt and (pose_particles is None or zones is None or energy_weight is None
                    or (sdf_volume is None and distilled is None)):
        raise ValueError("use_opt needs pose_particles, zones, energy_weight and an SDF "
                         "(sdf_volume or distilled)")

    def get(*keys):
        """frames[keys...] with the sequence axis: (S, T, ...)."""
        x = frames
        for k in keys:
            x = x[k]
        return x if batched else x[None]

    def seq(x):        # a per-sequence input of the optimisers, (S, ...) or (...)
        return x if batched else x[0]

    def opt_in(x):     # (S, ...) state -> the pose optimiser's (S, 1, ...) or (1, ...)
        return x[:, None] if batched else x

    def opt_out(x):
        return x[:, 0] if batched else x

    points = get("hand_points")                  # (S, T, N, 3)
    init_kp = get("jittered_hand_kp")
    n_seq, t_total = points.shape[:2]
    like = dict(dtype=points.dtype, device=points.device)

    shape_code = torch.zeros((n_seq, 10), **like)
    palm = _rest_palm_template(mano_model, shape_code)
    if use_iknet and shape_mode:
        # frame-0 shape optimisation from HandTrackNet's first prediction
        ret0 = handnet(points[:, 0], init_kp[:, 0], palm)
        lengths = kp2length(ret0["pred_kp"])[:, None]                 # (S, 1, 15)
        shape_code, _ = optimize_hand_shape(mano_model, shape_particles, seq(lengths))
        shape_code = shape_code.reshape(n_seq, 10)
        palm = _rest_palm_template(mano_model, shape_code)
    elif use_iknet:
        # the annotated shape: its rest template
        shape_code = get("gt_hand_pose", "mano_beta")[:, 0]
        palm = _rest_palm_template(mano_model, shape_code)

    obj_key = "pred_obj_pose" if use_pred_obj_pose else "gt_obj_pose"
    if use_opt and background_masks is None:
        background_masks = torch.zeros((n_seq, t_total, 1, 1), dtype=torch.bool,
                                       device=points.device)
    elif use_opt and not batched:
        background_masks = background_masks[None]
    packed = None
    if use_opt and distilled is not None and points.is_cuda:  # once per sequence or chunk
        packed = (pack_distilled_batched if batched else pack_distilled)(distilled)
    history = torch.zeros((n_seq, HISTORY_ROWS, 15), **like) if shape_mode == 3 else None

    out = {k: [] for k in ("pred_kp", "baseline", "canon_r", "canon_t", "global_r",
                           "global_t", "theta")}
    last_kp = None
    for i in range(t_total):
        hand_points = points[:, i]
        cloud_mean = torch.mean(hand_points, dim=-2, keepdim=True)
        recentred = None if i == 0 else last_kp + cloud_mean
        jittered_kp = init_kp[:, i] if i == 0 else recentred
        ret = handnet(hand_points, jittered_kp, palm, compute_visibility=use_iknet)
        baseline_kp = ret["pred_kp"]
        pred_kp = baseline_kp
        theta = torch.zeros((n_seq, 45), **like)
        global_r = ret["canon_pose"].rotation
        global_t = ret["canon_pose"].translation

        if use_iknet:
            if shape_mode == 3:
                history[:, i % HISTORY_ROWS] = kp2length(baseline_kp)
            if shape_mode in (2, 3) and i % REOPT_EVERY == 0 and i > 0:
                if shape_mode == 2:
                    lengths = kp2length(baseline_kp)[:, None]
                else:
                    # unfilled slots repeat the newest row, which leaves the
                    # mean |bone difference| over the filled rows' targets
                    lengths = history.clone()
                    lengths[:, min(i + 1, HISTORY_ROWS):] = history[:, None, i % HISTORY_ROWS]
                shape_code, _ = optimize_hand_shape(mano_model, shape_particles, seq(lengths))
                shape_code = shape_code.reshape(n_seq, 10)
                palm = _rest_palm_template(mano_model, shape_code)

            ik_ret = iknet(baseline_kp, palm)
            theta = ik_ret["MANO_theta"]
            global_r = ik_ret["global_pose"].rotation
            global_t = ik_ret["global_pose"].translation
            if use_opt:
                proj = get("projection")[:, i]
                kp, theta, global_r, global_t, _ = optimize_hand_pose(
                    mano_model, pose_particles, zones, sdf_volume, hand_shape=opt_in(shape_code),
                    init_rotation=opt_in(global_r), init_translation=opt_in(global_t),
                    init_theta=opt_in(theta), pred_kp=opt_in(baseline_kp),
                    vis_mask=opt_in(ret["pred_kp_vis_mask"]),
                    last_frame_kp=opt_in(baseline_kp if i == 0 else recentred),
                    has_last=float(i > 0),
                    obj_rotation=seq(get(obj_key, "rotation")[:, i]),
                    obj_translation=seq(get(obj_key, "translation")[:, i][..., 0]),
                    background_mask=seq(background_masks[:, i]),
                    intrinsics={k: seq(proj[:, j]) for j, k in enumerate(("fx", "fy", "cx",
                                                                          "cy"))},
                    energy_weight=energy_weight, voxel_scale=sdf_voxel_scale,
                    distilled=distilled, hand_energy=hand_energy, packed=packed)
                pred_kp, theta, global_r, global_t = (opt_out(x) for x in
                                                      (kp, theta, global_r, global_t))
            else:
                pred_kp = iknet_predict_kp(mano_model, ik_ret, shape_code)

        last_kp = pred_kp - cloud_mean
        out["pred_kp"].append(pred_kp)
        out["baseline"].append(baseline_kp)
        out["canon_r"].append(ret["canon_pose"].rotation)
        out["canon_t"].append(ret["canon_pose"].translation)
        out["global_r"].append(global_r)
        out["global_t"].append(global_t)
        out["theta"].append(theta)

    stacked = {k: seq(torch.stack(v, dim=1)) for k, v in out.items()}
    return HandTrackResult(
        pred_kp=stacked["pred_kp"], baseline_pred_kp=stacked["baseline"],
        canon_rotation=stacked["canon_r"], canon_translation=stacked["canon_t"],
        global_rotation=stacked["global_r"], global_translation=stacked["global_t"],
        mano_theta=stacked["theta"], pred_beta=seq(shape_code[:, None]))
