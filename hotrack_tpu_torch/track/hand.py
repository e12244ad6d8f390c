"""Hand tracking: the per-sequence frame loop.

Port of hotrack_tpu/track/hand.py:track_hand_sequence without IKNet and the
optimisers. The JAX package runs the frames as one `lax.scan`; here the same
step is a Python loop over frames, with the state on the device:

  - the palm template is the rest-pose MANO's palm at zero shape;
  - frame 0 starts from the dataset's jittered keypoints; every later frame
    re-centres the previous prediction by the current cloud mean.
"""

from __future__ import annotations

import torch

from ..mano.layer import mano_forward
from ..mano.model import ManoModel
from ..models.hand_network import HandTrackNet
from ..models.hand_utils import handkp2palmkp
from .types import HandTrackResult

_SLICE_TODO = ("{} is not ported yet: see ROADMAP.md, queue 1, slice 4 "
               "(full hand pipeline: IKNet and the shape/pose optimisers)")


def _rest_palm_template(mano_model: ManoModel, beta: torch.Tensor) -> torch.Tensor:
    """Rest-pose palm keypoints (1, 6, 3) for the given shape (1, 10)."""
    _, kp = mano_forward(mano_model, torch.zeros((1, 48), dtype=beta.dtype,
                                                 device=beta.device), betas=beta)
    return handkp2palmkp(kp)


@torch.inference_mode()
def track_hand_sequence(handnet: HandTrackNet, mano_model: ManoModel,
                        frames: dict, iknet=None, use_opt: bool = False,
                        shape_mode=False) -> HandTrackResult:
    """Track one sequence. `frames` holds (T, ...) tensors on the model's
    device (prepare_batch output): hand_points (T, N, 3) and
    jittered_hand_kp (T, 21, 3)."""
    if iknet is not None:
        raise NotImplementedError(_SLICE_TODO.format("iknet"))
    if use_opt:
        raise NotImplementedError(_SLICE_TODO.format("use_opt"))
    if shape_mode:
        raise NotImplementedError(_SLICE_TODO.format("shape_mode"))
    points = frames["hand_points"]
    init_kp = frames["jittered_hand_kp"]
    t_total = points.shape[0]
    zero_beta = torch.zeros((1, 10), dtype=points.dtype, device=points.device)
    palm = _rest_palm_template(mano_model, zero_beta)

    pred, rot, trans = [], [], []
    last_kp = None
    for i in range(t_total):
        hand_points = points[i:i + 1]
        cloud_mean = torch.mean(hand_points, dim=-2, keepdim=True)
        jittered_kp = init_kp[i:i + 1] if i == 0 else last_kp + cloud_mean
        ret = handnet(hand_points, jittered_kp, palm)
        last_kp = ret["pred_kp"] - cloud_mean
        pred.append(ret["pred_kp"][0])
        rot.append(ret["canon_pose"].rotation[0])
        trans.append(ret["canon_pose"].translation[0])

    pred_kp = torch.stack(pred)
    rotation, translation = torch.stack(rot), torch.stack(trans)
    return HandTrackResult(
        pred_kp=pred_kp, baseline_pred_kp=pred_kp,
        canon_rotation=rotation, canon_translation=translation,
        global_rotation=rotation, global_translation=translation,
        mano_theta=torch.zeros((t_total, 45), dtype=points.dtype,
                               device=points.device),
        pred_beta=zero_beta)
