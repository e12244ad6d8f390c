"""Device-side batch preparation (port of hotrack_tpu/data/pipeline.py).

RawFrame batch (numpy, from the readers) -> the `full_data` dict of tensors on
one device: FPS (the CUDA kernel on the card) or a random subset of the hand
and object clouds to num_points, MANO ground-truth keypoints and palm
template, keypoint jitter and object-pose jitter. Every random number comes
from one `torch.Generator`; each unit draw can be replaced by a given tensor
(`kp_noise`, `sample_scores`, `obj_draws`), so tests can feed both packages
the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mano.layer import mano_forward
from ..mano.model import ManoModel
from ..models.hand_utils import handkp2palmkp, obb_frame
from ..ops.pointops import farthest_point_sample, index_points
from ..pose.rotations import noisy_rot_matrix, rotvec_to_matrix, unit_draw
from .schema import RawFrame


def jitter_hand_kp(kp: torch.Tensor, scale: float, kind: str = "normal",
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Per-coordinate keypoint noise. The unit draw (a standard normal, or
    uniform in [0, 1) for kind='uniform') is made on the generator's device,
    so a host generator gives the same jitter on every device; `noise`
    replaces it."""
    return kp + _signed(unit_draw(kp.shape, _kind(kind), kp, generator, noise),
                        kind) * scale


def _kind(kind: str) -> str:
    """Anything but 'uniform' draws normals, as in the JAX package."""
    return "uniform" if kind == "uniform" else "normal"


def _signed(draw: torch.Tensor, kind: str) -> torch.Tensor:
    """A uniform unit draw in [0, 1) spread to [-1, 1); a normal one as is."""
    return draw * 2.0 - 1.0 if kind == "uniform" else draw


def jitter_obj_pose(rotation, translation, scale, cfg: dict, kind: str = "normal",
                    generator: torch.Generator | None = None,
                    draws: dict | None = None):
    """Object pose noise: rotation (B, 3, 3) by |N| * cfg['rotation'] radians
    toward a random orthogonal quaternion; translation (B, 3, 1) along a
    random unit direction with magnitude N * cfg['translation']; scale (B,)
    + N * cfg['scale']. `draws` may hold the unit draws 'theta' (B,), 'quat'
    (B, 4), 'scale' (B,), 'norm' (B,), 'direction' (B, 3)."""
    draws = draws or {}
    kind = _kind(kind)

    def rand(name, shape):
        return _signed(unit_draw(shape, kind, scale, generator, draws.get(name)), kind)

    new_rot = noisy_rot_matrix(rotation, cfg["rotation"], kind, generator,
                               (draws.get("theta"), draws.get("quat")))
    new_scale = scale + rand("scale", scale.shape) * cfg["scale"]
    norm = rand("norm", scale.shape) * cfg["translation"]
    direction = rand("direction", translation[..., 0].shape)
    direction = direction / torch.clamp(
        torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-9)
    new_trans = translation + (direction * norm[..., None])[..., None]
    return new_rot, new_trans, new_scale


def _random_subset(valid: torch.Tensor, num_points: int,
                   generator: torch.Generator | None = None,
                   scores: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform without-replacement subset of the valid points of each batch
    row (invalid points are taken only when fewer than num_points are valid):
    uniform scores, invalid ones pushed below every valid one, top-k."""
    ref = torch.empty(0, dtype=torch.float32, device=valid.device)
    scores = unit_draw(valid.shape, "uniform", ref, generator, scores)
    scores = torch.where(valid, scores, scores - 2.0)
    return torch.topk(scores, num_points, dim=-1, largest=True, sorted=True).indices


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device)


def prepare_batch(mano_model: ManoModel, raw: RawFrame, num_points: int,
                  generator: torch.Generator | None = None,
                  hand_jitter_scale: float = 0.0, jitter_kind: str = "normal",
                  obj_jitter: dict | None = None, obj_jitter_kind: str = "normal",
                  template_with_theta: bool = False, include_obb: bool = False,
                  sample_kind: str = "fps",
                  kp_noise: torch.Tensor | None = None,
                  sample_scores: tuple | None = None,
                  obj_draws: dict | None = None, device=None) -> dict:
    """Batched RawFrame (leading axis B) -> dict of tensors on `device`
    (default: the MANO model's). Keys follow the JAX package's output;
    `hand_idx` / `obj_idx` are the sampled indices into the raw clouds.

    sample_kind 'fps' is deterministic per cloud; 'random' redraws a uniform
    subset of the valid points on every call (`sample_scores` = (hand, obj)
    score tensors (B, N) replaces the draw). obj_jitter {'rotation' rad,
    'translation', 'scale'} jitters the object pose (`obj_draws`, see
    jitter_obj_pose); include_obb adds the OBB canonical pose of the sampled
    hand cloud (handframe='OBB')."""
    if sample_kind not in ("fps", "random"):
        raise ValueError(f"unknown sample_kind {sample_kind!r}")
    device = torch.device(device) if device is not None else mano_model.v_template.device
    mano_model = mano_model.to(device)
    r = RawFrame(*(_tensor(getattr(raw, k), device) for k in RawFrame._fields))
    b = r.hand_points.shape[0]

    if sample_kind == "random":
        hand_scores, obj_scores = sample_scores or (None, None)
        hand_idx = _random_subset(r.hand_valid, num_points, generator, hand_scores)
        obj_idx = _random_subset(r.obj_valid, num_points, generator, obj_scores)
    else:
        hand_idx = farthest_point_sample(r.hand_points, num_points, r.hand_valid)
        obj_idx = farthest_point_sample(r.obj_points, num_points, r.obj_valid)
    hand_points = index_points(r.hand_points, hand_idx)
    hand_valid = torch.gather(r.hand_valid, 1, hand_idx.long())
    obj_points = index_points(r.obj_points, obj_idx)
    obj_valid = torch.gather(r.obj_valid, 1, obj_idx.long())

    _, mano_kp = mano_forward(mano_model, r.mano_pose, betas=r.mano_beta,
                              trans=r.mano_trans, original_version=True)
    if template_with_theta:
        # HO3D/DexYCB: the rest template keeps the annotated finger pose with
        # the global rotation zeroed
        template_pose = r.mano_pose.clone()
        template_pose[:, :3] = 0.0
    else:
        template_pose = torch.zeros((b, 48), dtype=mano_kp.dtype, device=device)
    _, template_kp = mano_forward(mano_model, template_pose, betas=r.mano_beta)
    palm_template = handkp2palmkp(template_kp)
    gt_kp = torch.where(r.has_annot_kp[:, None, None], r.annot_hand_kp, mano_kp)
    hand_rotation = rotvec_to_matrix(r.mano_pose[:, :3])

    jittered_kp = jitter_hand_kp(gt_kp, hand_jitter_scale, jitter_kind,
                                 generator=generator, noise=kp_noise)
    gt_obj = {"rotation": r.obj_rotation, "translation": r.obj_translation,
              "scale": r.obj_scale}
    if obj_jitter is not None:
        jr, jt, js = jitter_obj_pose(r.obj_rotation, r.obj_translation, r.obj_scale,
                                     obj_jitter, obj_jitter_kind, generator, obj_draws)
        jittered_obj = {"rotation": jr, "translation": jt, "scale": js}
    else:
        jittered_obj = dict(gt_obj)
    extra = {}
    if include_obb:
        obb = obb_frame(hand_points)
        extra["OBB_pose"] = {"rotation": obb.rotation, "translation": obb.translation,
                             "scale": obb.scale}
    return {
        **extra,
        "hand_points": hand_points,
        "hand_valid": hand_valid,
        "hand_idx": hand_idx,
        "obj_points": obj_points,
        "obj_valid": obj_valid,
        "obj_idx": obj_idx,
        "gt_hand_kp": gt_kp,
        "jittered_hand_kp": jittered_kp,
        "gt_hand_pose": {
            "rotation": hand_rotation,
            "translation": gt_kp[:, 0][..., None],
            "scale": torch.full((b,), 0.2, dtype=gt_kp.dtype, device=device),
            "mano_pose": r.mano_pose,
            "mano_trans": r.mano_trans,
            "mano_beta": r.mano_beta,
            "palm_template": palm_template,
        },
        "gt_obj_pose": gt_obj,
        "jittered_obj_pose": jittered_obj,
        "pred_obj_pose": {"rotation": r.pred_obj_rotation,
                          "translation": r.pred_obj_translation},
        "projection": r.projection,
        "frame_valid": r.valid,
    }
