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

The loop's body is `HandStep.step`, its frame-0 prelude `HandStep.init_state`
(the streaming tracker of track/stream.py runs the same two).
`track_hand_sequences_batched` runs S sequences through the same loop with
the state carried per sequence along a leading axis (the shape modes'
re-optimisations fall on the same frames for every sequence); the nets take
batch S, and the optimisers their batched forms, which on the card launch the
batched kernels. `track_hand_sequence` is that loop with one sequence and the
unbatched optimisers. `track_hand_sequences_sharded` splits the sequences
over devices (track/shards.py), the batched loop on each.
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
from ..utils.trace import span, spanned
from . import shards
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


def track_hand_sequences_sharded(handnet: HandTrackNet, mano_model: ManoModel,
                                 stacked_frames: dict, devices=None,
                                 per_seq_kwargs: dict | None = None,
                                 **kwargs) -> HandTrackResult:
    """Several devices' tracking of S equal-length sequences (port of the JAX
    package's `track_hand_sequences_sharded`, whose `variables` the port's
    modules carry): S splits into len(devices) equal contiguous shares (S
    must divide by D), and each share runs `track_hand_sequences_batched` on
    its device, in a thread of its own. `devices` defaults to every visible
    card and may repeat one.

    The nets, MANO, the particle banks and every entry of `kwargs` are copied
    to each device whole (replicated, as the JAX function closes over them),
    except `distilled`, a list of S models, which is per sequence. Entries of
    `per_seq_kwargs` carry a leading S (a volume, masks a sequence) and are
    sliced by share. Returns the HandTrackResult of all S sequences on
    devices[0], in sequence order."""
    devices = shards.resolve_devices(devices)
    bounds = shards.share_bounds(shards.leading_size(stacked_frames), len(devices))
    per_seq_kwargs = dict(per_seq_kwargs or {})
    distilled = kwargs.pop("distilled", None)
    move = shards.Mover()
    jobs = []
    for device, sl in zip(devices, bounds):
        share_kwargs = {**move(kwargs, device),
                        **{k: move(v[sl], device) for k, v in per_seq_kwargs.items()}}
        if distilled is not None:
            share_kwargs["distilled"] = move(list(distilled[sl]), device)
        jobs.append((move(handnet, device), move(mano_model, device),
                     move(shards.slice_tree(stacked_frames, sl), device), share_kwargs))
    results = shards.run_shares(
        lambda device, job: track_hand_sequences_batched(job[0], job[1], job[2], **job[3]),
        devices, jobs)
    return shards.concat_results(results, devices[0])


class HandStep:
    """The tracker's per-frame step over S sequences, with its state explicit:
    the frame loop of `track_hand_sequence` / `track_hand_sequences_batched`
    and the streaming `track/stream.HandTracker` both run it (the port's
    counterpart of the JAX package's `_make_hand_step`).

    `init_state` is the frame-0 prelude (the shape code and its palm
    template; with shape mode 1-3 HandTrackNet and the shape optimiser on
    frame 0). The state is a dict of device tensors, (S, ...) each, and the
    host's frame index: the last keypoints (relative to their cloud's mean),
    the palm template, the shape code, the bone-length history (shape mode
    3) and the frame-0 keypoint estimate. `step` reads nothing on the host.
    One sequence (batched False) is S = 1 with the unbatched optimisers,
    whose inputs lack the sequence axis (`seq`, `opt_in`, `opt_out` move
    between the two)."""

    def __init__(self, handnet, mano_model, batched: bool, iknet=None, use_opt=False,
                 shape_mode=False, shape_particles=None, pose_particles=None, zones=None,
                 sdf_volume=None, energy_weight=None, sdf_voxel_scale=0.003, distilled=None,
                 hand_energy="skin"):
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
        self.handnet, self.mano, self.iknet, self.batched = handnet, mano_model, iknet, batched
        self.use_iknet, self.use_opt, self.shape_mode = use_iknet, use_opt, shape_mode
        self.shape_particles, self.pose_particles, self.zones = (shape_particles,
                                                                 pose_particles, zones)
        self.sdf_volume, self.energy_weight = sdf_volume, energy_weight
        self.sdf_voxel_scale, self.distilled, self.hand_energy = (sdf_voxel_scale, distilled,
                                                                  hand_energy)
        self.packed = None

    def seq(self, x):      # a per-sequence input of the optimisers, (S, ...) or (...)
        return x if self.batched else x[0]

    def opt_in(self, x):   # (S, ...) state -> the pose optimiser's (S, 1, ...) or (1, ...)
        return x[:, None] if self.batched else x

    def opt_out(self, x):
        return x[:, 0] if self.batched else x

    @spanned("track.hand.init")
    def init_state(self, points0: torch.Tensor, init_kp0: torch.Tensor,
                   mano_beta: torch.Tensor | None = None) -> dict:
        """Frame 0's clouds (S, N, 3) and keypoint estimate (S, 21, 3) ->
        the state before frame 0. mano_beta (S, 10): the annotated shape,
        which IKNet's rest template takes in shape mode 0."""
        n_seq = points0.shape[0]
        like = dict(dtype=points0.dtype, device=points0.device)
        shape_code = torch.zeros((n_seq, 10), **like)
        palm = _rest_palm_template(self.mano, shape_code)
        if self.use_iknet and self.shape_mode:
            # frame-0 shape optimisation from HandTrackNet's first prediction
            with span("net.handtracknet"):
                ret0 = self.handnet(points0, init_kp0, palm)
            lengths = kp2length(ret0["pred_kp"])[:, None]                 # (S, 1, 15)
            shape_code, _ = optimize_hand_shape(self.mano, self.shape_particles,
                                                self.seq(lengths))
            shape_code = shape_code.reshape(n_seq, 10)
            palm = _rest_palm_template(self.mano, shape_code)
        elif self.use_iknet:
            # the annotated shape: its rest template
            shape_code = mano_beta
            palm = _rest_palm_template(self.mano, shape_code)
        if self.use_opt and self.distilled is not None and points0.is_cuda \
                and self.packed is None:  # once per tracker: the model's weights
            self.packed = (pack_distilled_batched if self.batched
                           else pack_distilled)(self.distilled)
        return {"i": 0, "init_kp": init_kp0, "last_kp": None, "palm": palm,
                "shape_code": shape_code,
                "history": (torch.zeros((n_seq, HISTORY_ROWS, 15), **like)
                            if self.shape_mode == 3 else None)}

    @spanned("track.hand.frame")
    def step(self, state: dict, hand_points: torch.Tensor, projection=None,
             obj_rotation=None, obj_translation=None, background_mask=None):
        """One frame of S sequences: hand_points (S, N, 3); with the pose
        optimiser the frame's projection (S, 6), object pose (S, 3, 3),
        (S, 3) and background mask (S, H, W) bool. Returns (the next state,
        the frame's outputs (S, ...): pred_kp, baseline_pred_kp,
        canon_rotation, canon_translation, global_rotation,
        global_translation, MANO_theta)."""
        i, last_kp, palm, shape_code = (state["i"], state["last_kp"], state["palm"],
                                        state["shape_code"])
        history = state["history"]
        n_seq = hand_points.shape[0]
        like = dict(dtype=hand_points.dtype, device=hand_points.device)
        cloud_mean = torch.mean(hand_points, dim=-2, keepdim=True)
        recentred = None if i == 0 else last_kp + cloud_mean
        jittered_kp = state["init_kp"] if i == 0 else recentred
        with span("net.handtracknet"):
            ret = self.handnet(hand_points, jittered_kp, palm, compute_visibility=self.use_iknet)
        baseline_kp = ret["pred_kp"]
        pred_kp = baseline_kp
        theta = torch.zeros((n_seq, 45), **like)
        global_r = ret["canon_pose"].rotation
        global_t = ret["canon_pose"].translation

        if self.use_iknet:
            if self.shape_mode == 3:
                history = history.clone()
                history[:, i % HISTORY_ROWS] = kp2length(baseline_kp)
            if self.shape_mode in (2, 3) and i % REOPT_EVERY == 0 and i > 0:
                if self.shape_mode == 2:
                    lengths = kp2length(baseline_kp)[:, None]
                else:
                    # unfilled slots repeat the newest row, which leaves the
                    # mean |bone difference| over the filled rows' targets
                    lengths = history.clone()
                    lengths[:, min(i + 1, HISTORY_ROWS):] = history[:, None, i % HISTORY_ROWS]
                shape_code, _ = optimize_hand_shape(self.mano, self.shape_particles,
                                                    self.seq(lengths))
                shape_code = shape_code.reshape(n_seq, 10)
                palm = _rest_palm_template(self.mano, shape_code)

            with span("net.iknet"):
                ik_ret = self.iknet(baseline_kp, palm)
            theta = ik_ret["MANO_theta"]
            global_r = ik_ret["global_pose"].rotation
            global_t = ik_ret["global_pose"].translation
            if self.use_opt:
                seq, opt_in, opt_out = self.seq, self.opt_in, self.opt_out
                if background_mask is None:
                    background_mask = torch.zeros((n_seq, 1, 1), dtype=torch.bool,
                                                  device=hand_points.device)
                kp, theta, global_r, global_t, _ = optimize_hand_pose(
                    self.mano, self.pose_particles, self.zones, self.sdf_volume,
                    hand_shape=opt_in(shape_code), init_rotation=opt_in(global_r),
                    init_translation=opt_in(global_t), init_theta=opt_in(theta),
                    pred_kp=opt_in(baseline_kp), vis_mask=opt_in(ret["pred_kp_vis_mask"]),
                    last_frame_kp=opt_in(baseline_kp if i == 0 else recentred),
                    has_last=float(i > 0), obj_rotation=seq(obj_rotation),
                    obj_translation=seq(obj_translation), background_mask=seq(background_mask),
                    intrinsics={k: seq(projection[:, j]) for j, k in enumerate(("fx", "fy",
                                                                               "cx", "cy"))},
                    energy_weight=self.energy_weight, voxel_scale=self.sdf_voxel_scale,
                    distilled=self.distilled, hand_energy=self.hand_energy, packed=self.packed)
                pred_kp, theta, global_r, global_t = (opt_out(x) for x in
                                                      (kp, theta, global_r, global_t))
            else:
                pred_kp = iknet_predict_kp(self.mano, ik_ret, shape_code)

        new_state = dict(state, i=i + 1, last_kp=pred_kp - cloud_mean, palm=palm,
                         shape_code=shape_code, history=history)
        return new_state, {"pred_kp": pred_kp, "baseline_pred_kp": baseline_kp,
                           "canon_rotation": ret["canon_pose"].rotation,
                           "canon_translation": ret["canon_pose"].translation,
                           "global_rotation": global_r, "global_translation": global_t,
                           "MANO_theta": theta}


def _track_hands(handnet, mano_model, frames, batched: bool, iknet=None, use_opt=False,
                 shape_mode=False, shape_particles=None, pose_particles=None, zones=None,
                 sdf_volume=None, background_masks=None, energy_weight=None,
                 use_pred_obj_pose=False, sdf_voxel_scale=0.003, distilled=None,
                 hand_energy="skin") -> HandTrackResult:
    """The frame loop over S sequences: `HandStep` frame after frame."""
    stepper = HandStep(handnet, mano_model, batched, iknet=iknet, use_opt=use_opt,
                       shape_mode=shape_mode, shape_particles=shape_particles,
                       pose_particles=pose_particles, zones=zones, sdf_volume=sdf_volume,
                       energy_weight=energy_weight, sdf_voxel_scale=sdf_voxel_scale,
                       distilled=distilled, hand_energy=hand_energy)

    def get(*keys):
        """frames[keys...] with the sequence axis: (S, T, ...)."""
        x = frames
        for k in keys:
            x = x[k]
        return x if batched else x[None]

    points = get("hand_points")                  # (S, T, N, 3)
    init_kp = get("jittered_hand_kp")
    n_seq, t_total = points.shape[:2]
    beta = (get("gt_hand_pose", "mano_beta")[:, 0]
            if stepper.use_iknet and not stepper.shape_mode else None)
    state = stepper.init_state(points[:, 0], init_kp[:, 0], beta)

    obj_key = "pred_obj_pose" if use_pred_obj_pose else "gt_obj_pose"
    if stepper.use_opt and background_masks is None:
        background_masks = torch.zeros((n_seq, t_total, 1, 1), dtype=torch.bool,
                                       device=points.device)
    elif stepper.use_opt and not batched:
        background_masks = background_masks[None]

    out = {k: [] for k in ("pred_kp", "baseline_pred_kp", "canon_rotation",
                           "canon_translation", "global_rotation", "global_translation",
                           "MANO_theta")}
    for i in range(t_total):
        frame = {}
        if stepper.use_opt:
            frame = dict(projection=get("projection")[:, i],
                         obj_rotation=get(obj_key, "rotation")[:, i],
                         obj_translation=get(obj_key, "translation")[:, i][..., 0],
                         background_mask=background_masks[:, i])
        state, step_out = stepper.step(state, points[:, i], **frame)
        for k, v in step_out.items():
            out[k].append(v)

    stacked = {k: stepper.seq(torch.stack(v, dim=1)) for k, v in out.items()}
    return HandTrackResult(
        pred_kp=stacked["pred_kp"], baseline_pred_kp=stacked["baseline_pred_kp"],
        canon_rotation=stacked["canon_rotation"],
        canon_translation=stacked["canon_translation"],
        global_rotation=stacked["global_rotation"],
        global_translation=stacked["global_translation"],
        mano_theta=stacked["MANO_theta"], pred_beta=stepper.seq(state["shape_code"][:, None]))
