"""Device-side batch preparation (port of hotrack_tpu/data/pipeline.py).

RawFrame batch (numpy, from the readers) -> the `full_data` dict of tensors on
one device: FPS of the hand and object clouds to num_points (the CUDA kernel
on the card), MANO ground-truth keypoints and palm template, and keypoint
jitter drawn from a `torch.Generator` (or taken from `kp_noise`, so tests can
feed both packages the same draw).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mano.layer import mano_forward
from ..mano.model import ManoModel
from ..models.hand_utils import handkp2palmkp
from ..ops.pointops import farthest_point_sample, index_points
from ..pose.rotations import rotvec_to_matrix
from .schema import RawFrame

_TODO = "{} is not ported yet: see ROADMAP.md, queue 1, slice 2 (training)"


def jitter_hand_kp(kp: torch.Tensor, scale: float, kind: str = "normal",
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Per-coordinate keypoint noise. The unit draw (a standard normal, or
    uniform in [0, 1) for kind='uniform') is made on the generator's device,
    so a host generator gives the same jitter on every device; `noise`
    replaces it."""
    if noise is None:
        draw = torch.rand if kind == "uniform" else torch.randn
        noise = draw(kp.shape, generator=generator, dtype=kp.dtype,
                     device=generator.device if generator is not None else kp.device)
    noise = noise.to(device=kp.device, dtype=kp.dtype)
    if kind == "uniform":
        return kp + (noise * 2.0 - 1.0) * scale
    return kp + noise * scale


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device)


def prepare_batch(mano_model: ManoModel, raw: RawFrame, num_points: int,
                  generator: torch.Generator | None = None,
                  hand_jitter_scale: float = 0.0, jitter_kind: str = "normal",
                  obj_jitter: dict | None = None, include_obb: bool = False,
                  sample_kind: str = "fps",
                  kp_noise: torch.Tensor | None = None, device=None) -> dict:
    """Batched RawFrame (leading axis B) -> dict of tensors on `device`
    (default: the MANO model's). Keys follow the JAX package's output;
    `hand_idx` / `obj_idx` are the FPS indices into the raw clouds."""
    if sample_kind != "fps":
        raise NotImplementedError(_TODO.format(f"sample_kind={sample_kind!r}"))
    if include_obb:
        raise NotImplementedError(_TODO.format("include_obb"))
    if obj_jitter is not None:
        raise NotImplementedError(_TODO.format("obj_jitter"))
    device = torch.device(device) if device is not None else mano_model.v_template.device
    mano_model = mano_model.to(device)
    r = RawFrame(*(_tensor(getattr(raw, k), device) for k in RawFrame._fields))
    b = r.hand_points.shape[0]

    hand_idx = farthest_point_sample(r.hand_points, num_points, r.hand_valid)
    obj_idx = farthest_point_sample(r.obj_points, num_points, r.obj_valid)
    hand_points = index_points(r.hand_points, hand_idx)
    hand_valid = torch.gather(r.hand_valid, 1, hand_idx.long())
    obj_points = index_points(r.obj_points, obj_idx)
    obj_valid = torch.gather(r.obj_valid, 1, obj_idx.long())

    _, mano_kp = mano_forward(mano_model, r.mano_pose, betas=r.mano_beta,
                              trans=r.mano_trans, original_version=True)
    # SimGrasp: the rest-pose template (HO3D/DexYCB keep the finger pose, not
    # ported with their readers)
    template_pose = torch.zeros((b, 48), dtype=mano_kp.dtype, device=device)
    _, template_kp = mano_forward(mano_model, template_pose, betas=r.mano_beta)
    palm_template = handkp2palmkp(template_kp)
    gt_kp = torch.where(r.has_annot_kp[:, None, None], r.annot_hand_kp, mano_kp)
    hand_rotation = rotvec_to_matrix(r.mano_pose[:, :3])

    jittered_kp = jitter_hand_kp(gt_kp, hand_jitter_scale, jitter_kind,
                                 generator=generator, noise=kp_noise)
    gt_obj = {"rotation": r.obj_rotation, "translation": r.obj_translation,
              "scale": r.obj_scale}
    return {
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
        "jittered_obj_pose": dict(gt_obj),
        "pred_obj_pose": {"rotation": r.pred_obj_rotation,
                          "translation": r.pred_obj_translation},
        "projection": r.projection,
        "frame_valid": r.valid,
    }
