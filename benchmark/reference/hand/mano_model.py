"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/mano/model.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

MANO model assets as PyTorch tensors.

Port of hotrack_tpu/mano/model.py. `ManoModel` is an immutable tuple of
tensors with `.to(device)`; `synthetic_mano_model` draws everything from
`np.random.RandomState(seed)` in the JAX package's order, so both packages
build the same rig bit for bit. (The licensed pickle's reader is
not copied: the benchmark runs the synthetic rig.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_VERTS = 778
N_JOINTS = 16
N_POSE = 45  # 15 articulated joints x 3 axis-angle dofs
N_BETAS = 10

# MANO joint order: 0 wrist; 1-3 index; 4-6 middle; 7-9 pinky; 10-12 ring;
# 13-15 thumb. Parents of joints 1..15.
KINTREE_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

# fingertip vertex ids appended as extra keypoints
TIPS_RIGHT = (745, 317, 444, 556, 673)
TIPS_LEFT = (745, 317, 445, 556, 673)

# level-wise kinematic chain composition order
LEV1_IDXS = (1, 4, 7, 10, 13)
LEV2_IDXS = (2, 5, 8, 11, 14)
LEV3_IDXS = (3, 6, 9, 12, 15)
# concat([root, lev1, lev2, lev3]) -> MANO joint order
REORDER_IDXS = (0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15)

# 16 joints + 5 tips -> the 21-keypoint convention used downstream:
# wrist, thumb(4), index(4), middle(4), ring(4), pinky(4)
KP_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)

# palm keypoint ids within the 21-kp convention
PALM_KP_IDS = (0, 1, 5, 9, 13, 17)


class ManoModel(NamedTuple):
    """Immutable MANO rig of tensors on one device."""

    v_template: torch.Tensor       # (778, 3)
    shapedirs: torch.Tensor        # (778, 3, 10)
    posedirs: torch.Tensor         # (778, 3, 135)
    j_regressor: torch.Tensor      # (16, 778)
    weights: torch.Tensor          # (778, 16) LBS skinning weights
    hands_components: torch.Tensor  # (45, 45) PCA basis rows
    hands_mean: torch.Tensor       # (45,) the pkl's mean, for PCA conversion only
    faces: torch.Tensor            # (F, 3) int64
    tips: torch.Tensor             # (5,) int64 fingertip vertex ids

    def to(self, device) -> "ManoModel":
        return ManoModel(*(t.to(device) for t in self))


def _model(v_template, shapedirs, posedirs, j_regressor, weights, comps,
           hands_mean, faces, tips, dtype) -> ManoModel:
    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    return ManoModel(
        v_template=f(v_template), shapedirs=f(shapedirs), posedirs=f(posedirs),
        j_regressor=f(j_regressor), weights=f(weights),
        hands_components=f(comps), hands_mean=f(hands_mean),
        faces=torch.as_tensor(np.asarray(faces, np.int64)),
        tips=torch.as_tensor(np.asarray(tips, np.int64)))


def synthetic_mano_model(seed: int = 0, dtype=torch.float32) -> ManoModel:
    """Deterministic fake rig with real MANO dimensions (the JAX package's
    `synthetic_mano_model`, same draws in the same order)."""
    rng = np.random.RandomState(seed)

    joints = np.zeros((N_JOINTS, 3))
    finger_roots = {1: -0.02, 4: 0.0, 7: 0.04, 10: 0.02, 13: -0.04}
    for chain_start, x_off in finger_roots.items():
        base = np.array([x_off, 0.09, 0.0])
        step = np.array([x_off * 0.2, 0.025, 0.002])
        joints[chain_start] = base
        joints[chain_start + 1] = base + step
        joints[chain_start + 2] = base + 2 * step

    owner = rng.randint(0, N_JOINTS, size=N_VERTS)
    v_template = joints[owner] + rng.randn(N_VERTS, 3) * 0.012

    d2 = ((v_template[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    logits = -d2 / 0.0004
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    weights = w / w.sum(axis=1, keepdims=True)

    jr = np.exp(-d2.T / 0.0002)
    j_regressor = jr / jr.sum(axis=1, keepdims=True)

    shapedirs = rng.randn(N_VERTS, 3, N_BETAS) * 0.003
    posedirs = rng.randn(N_VERTS, 3, 135) * 0.0005
    comps = rng.randn(N_POSE, N_POSE) * 0.3
    faces = rng.randint(0, N_VERTS, size=(1538, 3))

    return _model(v_template, shapedirs, posedirs, j_regressor, weights, comps,
                  np.zeros(N_POSE), faces, TIPS_RIGHT, dtype)


