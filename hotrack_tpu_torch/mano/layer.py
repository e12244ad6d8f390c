"""MANO forward (linear blend skinning) in PyTorch.

Port of hotrack_tpu/mano/layer.py: axis-angle -> rotations with the
reference's +1e-8 norm shift, shape and pose blendshapes, the explicit
3-level kinematic chain, LBS skinning, 5 fingertip vertices, the 21-kp
reorder and the wrist-centred output convention. Batched over a leading axis.
`mano_skin_inputs` gives the fused skinning + energy kernel
(ops/hand_energy_skin.py) what it needs per candidate, without the vertices.
`mano_forward`'s `channels_first` output of the JAX package is a TPU layout
device and is not carried over.
"""

from __future__ import annotations

import torch

from .model import (KP_REORDER, LEV1_IDXS, LEV2_IDXS, LEV3_IDXS, REORDER_IDXS, ManoModel,
                    index_tensor)


def mano_rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3). The angle is the norm of
    (axisang + 1e-8), a componentwise shift, and the axis divides the
    unshifted vector by it."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    w = torch.cos(half)[..., 0]
    xyz = torch.sin(half) * axis
    x, y, z = xyz.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(*axisang.shape[:-1], 3, 3)


def pca_comps2pose(model: ManoModel, pca: torch.Tensor, ncomps: int = 10) -> torch.Tensor:
    """PCA coefficients (..., ncomps) -> 45-dof axis-angle pose."""
    return torch.matmul(pca, model.hands_components[:ncomps])


def shape_hand(model: ManoModel, betas: torch.Tensor):
    """Shape blend: betas (B, 10) -> (v_shaped (B, 778, 3), joints (B, 16, 3))."""
    v_shaped = torch.einsum("vcs,bs->bvc", model.shapedirs, betas) + model.v_template
    joints = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    return v_shaped, joints


def _rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """A per-shape tensor (B', ...) for b rows: as it is for B' = b, expanded
    for B' = 1, else each row repeated b / B' times (B' shapes of b / B'
    candidates each, shape-major)."""
    if x.shape[0] == b:
        return x
    if x.shape[0] == 1:
        return x.expand(b, *x.shape[1:])
    if b % x.shape[0]:
        raise ValueError(f"{x.shape[0]} shapes for {b} rows")
    return x.repeat_interleave(b // x.shape[0], dim=0)


def _kinematic_chain(rot_mats: torch.Tensor, joints: torch.Tensor):
    """Base-to-tips chain, 3 levels of 5 fingers. Returns (r_all (B,16,3,3),
    t_all (B,16,3) posed joints, t_rel (B,16,3) = t_all - r_all @ rest)."""
    def compose(rp, tp, rl, tl):
        r = torch.sum(rp[..., :, :, None] * rl[..., None, :, :], dim=-2)
        t = torch.sum(rp * tl[..., None, :], dim=-1) + tp
        return r, t

    root_rot = rot_mats[:, 0]
    root_j = joints[:, 0]
    device = rot_mats.device
    lev1, lev2, lev3 = (index_tensor(ids, device) for ids in (LEV1_IDXS, LEV2_IDXS, LEV3_IDXS))
    r1, t1 = compose(root_rot[:, None], root_j[:, None],
                     rot_mats[:, lev1], joints[:, lev1] - root_j[:, None])
    r2, t2 = compose(r1, t1, rot_mats[:, lev2], joints[:, lev2] - joints[:, lev1])
    r3, t3 = compose(r2, t2, rot_mats[:, lev3], joints[:, lev3] - joints[:, lev2])
    order = index_tensor(REORDER_IDXS, device)
    r_all = torch.cat([root_rot[:, None], r1, r2, r3], dim=1)[:, order]
    t_all = torch.cat([root_j[:, None], t1, t2, t3], dim=1)[:, order]
    t_rel = t_all - torch.sum(r_all * joints[..., None, :], dim=-1)
    return r_all, t_all, t_rel


def mano_forward(model: ManoModel, pose_coeffs: torch.Tensor,
                 betas: torch.Tensor | None = None,
                 trans: torch.Tensor | None = None,
                 shaped=None, original_version: bool = False,
                 root_palm: bool = False):
    """pose_coeffs (B, 48) = 3 global + 45 joint axis-angle -> (verts
    (B, 778, 3), keypoints (B, 21, 3)), wrist-centred unless
    `original_version`; `shaped` is a precomputed `shape_hand` result whose
    batch dim may be 1 or B, or S dividing B (S shapes of B / S rows each)."""
    b = pose_coeffs.shape[0]
    rot_mats = mano_rodrigues(pose_coeffs.reshape(b, 16, 3))
    eye = torch.eye(3, dtype=pose_coeffs.dtype, device=pose_coeffs.device)
    pose_map = (rot_mats[:, 1:] - eye).reshape(b, 135)

    if shaped is not None:
        v_shaped, joints = shaped
        v_shaped, joints = _rows(v_shaped, b), _rows(joints, b)
    else:
        if betas is None:
            betas = torch.zeros((1, model.shapedirs.shape[-1]),
                                dtype=pose_coeffs.dtype, device=pose_coeffs.device)
        if betas.shape[0] == 1 and b > 1:
            betas = betas.expand(b, betas.shape[-1])
        v_shaped, joints = shape_hand(model, betas)

    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model.posedirs, pose_map)
    r_all, t_all, t_rel = _kinematic_chain(rot_mats, joints)

    skin_r = torch.einsum("vj,bjxy->bvxy", model.weights, r_all)
    skin_t = torch.einsum("vj,bjx->bvx", model.weights, t_rel)
    verts = torch.einsum("bvxy,bvy->bvx", skin_r, v_posed) + skin_t

    jtr = t_all
    tips = verts[:, model.tips]
    if root_palm:
        palm = (verts[:, 95] + verts[:, 22])[:, None] / 2.0
        jtr = torch.cat([palm, jtr[:, 1:]], dim=1)
    jtr = torch.cat([jtr, tips], dim=1)[:, index_tensor(KP_REORDER, jtr.device)]

    if not original_version:
        center = jtr[:, :1]
        jtr = jtr - center
        verts = verts - center
    if trans is not None:
        jtr = jtr + trans[:, None]
        verts = verts + trans[:, None]
    return verts, jtr


def mano_skin_inputs(model: ManoModel, pose_coeffs: torch.Tensor,
                     trans: torch.Tensor, shaped):
    """Keypoints and the per-candidate skinning inputs of the fused
    skinning + energy kernel (ops/hand_energy_skin.py), which computes
    verts(v) = R_skin(v) vp(v) + t_skin(v) + offset with
    vp = v_shaped + posedirs @ pose_map and [R_skin | t_skin] the per-vertex
    weight blend of (r_all, t_rel): mano_forward's LBS. offset = trans -
    wrist centre gives the wrist-centred, translated convention.

    pose_coeffs (B, 48), trans (B, 3), shaped = shape_hand(...) with batch 1,
    B, or S dividing B (S shapes of B / S candidates each) -> (kp (B, 21, 3),
    pose_map (B, 135), rt_flat (B * 12, 16): row 12 b + r holds role r (9
    rotation entries row-major, then 3 of t_rel) of the 16 joints, offset
    (B, 3)). The fingertips come from a 5-vertex mini-skin with the full
    path's per-element products."""
    b = pose_coeffs.shape[0]
    rot_mats = mano_rodrigues(pose_coeffs.reshape(b, 16, 3))
    eye = torch.eye(3, dtype=pose_coeffs.dtype, device=pose_coeffs.device)
    pose_map = (rot_mats[:, 1:] - eye).reshape(b, 135)

    v_shaped, joints = shaped
    joints = _rows(joints, b)
    r_all, t_all, t_rel = _kinematic_chain(rot_mats, joints)

    w5 = model.weights[model.tips]      # (5, 16)
    pd5 = model.posedirs[model.tips]    # (5, 3, 135)
    vp5 = _rows(v_shaped[:, model.tips], b) + torch.einsum("vcp,bp->bvc", pd5, pose_map)
    r5 = torch.einsum("vj,bjxy->bvxy", w5, r_all)
    t5 = torch.einsum("vj,bjx->bvx", w5, t_rel)
    tips = torch.einsum("bvxy,bvy->bvx", r5, vp5) + t5

    jtr = torch.cat([t_all, tips], dim=1)[:, index_tensor(KP_REORDER, tips.device)]
    center = jtr[:, :1]
    kp = jtr - center + trans[:, None]
    offset = trans - center[:, 0]

    rt = torch.cat([r_all.reshape(b, 16, 9), t_rel], dim=-1)      # (B, 16, 12)
    rt_flat = rt.transpose(1, 2).reshape(b * 12, 16)
    return kp, pose_map, rt_flat, offset


def mano_keypoints(model: ManoModel, pose_coeffs, betas=None, trans=None, shaped=None):
    """The 21 keypoints alone (the vertices dropped)."""
    return mano_forward(model, pose_coeffs, betas, trans, shaped)[1]


def template_keypoints(model: ManoModel, betas: torch.Tensor | None = None):
    """Rest-pose 21 keypoints (wrist-centred): the source of the trackers'
    palm template."""
    if betas is None:
        betas = torch.zeros((1, model.shapedirs.shape[-1]), dtype=model.v_template.dtype,
                            device=model.v_template.device)
    pose = torch.zeros((betas.shape[0], 48), dtype=model.v_template.dtype,
                       device=model.v_template.device)
    return mano_forward(model, pose, betas)[1]
