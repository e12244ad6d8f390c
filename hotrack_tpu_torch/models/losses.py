"""Generic pose, segmentation and NOCS losses (port of
hotrack_tpu/models/losses.py).

The shipped configs use only the losses inside models/hand_network.py; these
are the rest of the reference's loss library. Channels-last like the JAX
package: per-point predictions (B, N, C). The symmetric NOCS loss samples
part-0 points at random: from an explicit `torch.Generator`, or from
injected indices (`idxs`), so that a test can feed both packages the same
draws.
"""

from __future__ import annotations

import torch

from ..pose.part_dof import pose_with_part
from ..pose.rotations import matrix_to_rotvec

EPS = 1e-6


def vector_loss(x: torch.Tensor, loss: str = "l2") -> torch.Tensor:
    """(..., D) -> (...) vector norm."""
    if loss == "l2":
        return torch.linalg.norm(x, dim=-1)
    if loss == "l1":
        return torch.sum(torch.abs(x), dim=-1)
    raise ValueError(loss)


def choose_coord_by_label(x: torch.Tensor, labels, last_dim: int = 3) -> torch.Tensor:
    """Per-part coordinate predictions selected by label: x (B, N,
    last_dim * P), labels (B, N) -> (B, N, last_dim). Labels P and P + 1
    select zeros (two zero parts padded, as the reference pads them)."""
    if labels is None:
        return x
    p = x.shape[-1] // last_dim
    x = x.reshape(*x.shape[:-1], p, last_dim)
    x = torch.cat([x, torch.zeros_like(x[..., :2, :])], dim=-2)
    idx = labels.long().clamp(0, p + 1)[..., None, None].expand(*labels.shape, 1, last_dim)
    return torch.gather(x, -2, idx)[..., 0, :]


def compute_nocs_loss(nocs_per_part, nocs_gt, labels=None, confidence=None, loss: str = "l2",
                      self_supervise: bool = True, per_instance: bool = False,
                      sym: bool = False, pwm_num: int = 128,
                      generator: torch.Generator | None = None, idxs=None):
    """NOCS regression loss with confidence weighting: nocs_per_part (B, N,
    3P), nocs_gt (B, N, 3). With sym, the rotation-symmetric loss."""
    conf = (confidence if (confidence is not None and self_supervise)
            else torch.ones(nocs_gt.shape[:-1], dtype=nocs_gt.dtype, device=nocs_gt.device))
    mask = None
    if labels is not None and nocs_per_part.shape[-1] > 3:
        nocs_pred = choose_coord_by_label(nocs_per_part, labels)
        mask = (labels < nocs_per_part.shape[-1] // 3).to(nocs_gt.dtype)
    else:
        nocs_pred = nocs_per_part
    if sym:
        return compute_sym_nocs_loss(nocs_pred, nocs_gt, labels, pwm_num=pwm_num,
                                     generator=generator, idxs=idxs)
    raw = vector_loss(nocs_pred - nocs_gt, loss=loss) * conf
    if mask is None:
        ret = torch.mean(raw)
    else:
        ret = torch.sum(raw * mask) / torch.clamp(torch.sum(mask), min=1.0)
    ret = ret - 0.1 * torch.mean(torch.log(conf))
    return (ret, raw) if per_instance else ret


def compute_sym_nocs_loss(nocs_pred, nocs_gt, labels, pwm_num: int = 128,
                          generator: torch.Generator | None = None, idxs=None):
    """Rotation-symmetric NOCS loss: the y and radial distance on part 0, and
    a pairwise-distance consistency term on pwm_num part-0 points drawn a
    row (with replacement; any point where a row has none). `idxs` (B,
    pwm_num) replaces the draw. Returns (dist_loss, pwm)."""
    xg, yg, zg = nocs_gt[..., 0], nocs_gt[..., 1], nocs_gt[..., 2]
    xp, yp, zp = nocs_pred[..., 0], nocs_pred[..., 1], nocs_pred[..., 2]
    dist = torch.sqrt((yg - yp) ** 2 + torch.abs(xg ** 2 + zg ** 2 - xp ** 2 - zp ** 2) + 1e-8)
    mask = (labels == 0).to(dist.dtype)
    valid = (torch.sum(mask, dim=-1) > 0).to(dist.dtype)
    dist_loss = torch.sum(dist * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if idxs is None:
        weights = (mask + 1e-9).to(generator.device if generator is not None else "cpu")
        idxs = torch.multinomial(weights / torch.sum(weights, -1, keepdim=True), pwm_num,
                                 replacement=True, generator=generator)
    idxs = torch.as_tensor(idxs, device=nocs_gt.device).long()[..., None].expand(-1, -1, 3)
    sg, sp = torch.gather(nocs_gt, 1, idxs), torch.gather(nocs_pred, 1, idxs)

    def dist_mat(pts):
        return torch.linalg.norm(pts[:, :, None] - pts[:, None, :], dim=-1)

    pwm = torch.mean(torch.abs(dist_mat(sg) - dist_mat(sp)), dim=(-1, -2))
    pwm = torch.sum(pwm * valid) / torch.clamp(torch.sum(valid), min=1.0)
    return dist_loss, pwm


def _one_hot(labels, c: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels.long(), c).to(dtype)


def compute_miou_loss(pred, labels, per_instance: bool = False):
    """Soft mIoU segmentation loss: pred (B, N, P) probabilities, labels
    (B, N)."""
    gt = _one_hot(labels, pred.shape[-1], pred.dtype)
    inter = torch.sum(pred * gt, dim=-2)
    miou = inter / (torch.sum(pred + gt, dim=-2) - inter + EPS)
    loss = 1.0 - torch.mean(miou)
    return (loss, miou) if per_instance else loss


def compute_hard_miou_loss(pred, gt, num_parts: int, per_instance: bool = False):
    """mIoU of hard labels: pred / gt (B, N)."""
    po = _one_hot(pred, num_parts, torch.float32)
    go = _one_hot(gt, num_parts, torch.float32)
    inter = torch.sum(po * go, dim=-2)
    miou = inter / (torch.sum(po + go, dim=-2) - inter + EPS)
    loss = 1.0 - torch.mean(miou)
    return (loss, miou) if per_instance else loss


def compute_focal_loss(inputs, targets):
    """Binary focal loss, gamma 2, on logits."""
    bce = torch.clamp(inputs, min=0) - inputs * targets + torch.log1p(
        torch.exp(-torch.abs(inputs)))
    pt = torch.exp(-bce)
    return torch.mean((1 - pt) ** 2 * bce)


def rot_trace_loss(rot1, rot2, metric: str = "l1"):
    """Rotation losses on the trace (l1, l2), the Frobenius norm (frob) or
    rotation vectors (exp_l1, exp_l2); 'raw' gives zeros."""
    if "exp" in metric:
        diff = matrix_to_rotvec(rot1) - matrix_to_rotvec(rot2)
        return diff ** 2 if metric == "exp_l2" else torch.abs(diff)
    if metric == "frob":
        d = rot1 - rot2
        m = torch.matmul(d, d.transpose(-1, -2))
        return m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m = torch.matmul(rot1, rot2.transpose(-1, -2))
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    if metric == "l2":
        return (tr - 3.0) ** 2
    if metric == "l1":
        return torch.abs(tr - 3.0)
    if "raw" in metric:
        return torch.zeros_like(tr)
    raise ValueError(metric)


def rot_yaxis_loss(rot1, rot2, metric: str = "l2"):
    """The y axis alone, for symmetric parts."""
    diff = rot1[..., 1] - rot2[..., 1]
    if metric == "l2":
        return torch.sum(diff ** 2, dim=-1)
    if metric == "l1":
        return torch.linalg.norm(diff, dim=-1)
    raise ValueError(metric)


def trans_loss(t1, t2, metric: str = "l1"):
    """t (..., 3, 1)."""
    d = t1 - t2
    if metric == "l2":
        return torch.sum(d ** 2, dim=(-1, -2))
    if metric == "l1":
        return torch.linalg.norm(d[..., 0], dim=-1)
    raise ValueError(metric)


def scale_loss(s1, s2, metric: str = "l1"):
    return (s1 - s2) ** 2 if metric == "l2" else torch.abs(s1 - s2)


def compute_point_pose_loss(gt_pose: dict, pred_pose: dict, pts, metric: str = "l1"):
    """Pose loss through posed canonical points -> (mean, per point)."""
    diff = pose_with_part(gt_pose, pts) - pose_with_part(pred_pose, pts)
    dist = torch.sum(diff ** 2, -1) if metric == "l2" else torch.linalg.norm(diff, dim=-1)
    return torch.mean(dist), dist


def compute_part_dof_loss(gt: dict, pred: dict, pose_loss_type: dict, collapse: bool = True):
    loss_dict = {
        "sloss": scale_loss(gt["scale"], pred["scale"], pose_loss_type["s"]),
        "tloss": trans_loss(gt["translation"], pred["translation"], pose_loss_type["t"]),
        "rloss": rot_trace_loss(gt["rotation"], pred["rotation"], pose_loss_type["r"]),
    }
    if collapse:
        loss_dict = {k: torch.mean(v) for k, v in loss_dict.items()}
    return loss_dict
