"""MANO model assets as PyTorch tensors.

Port of hotrack_tpu/mano/model.py. `ManoModel` is an immutable tuple of
tensors with `.to(device)`; `synthetic_mano_model` draws everything from
`np.random.RandomState(seed)` in the JAX package's order, so both packages
build the same rig bit for bit. `load_mano_pkl` reads the licensed
MANO_*.pkl without chumpy.
"""

from __future__ import annotations

import functools
import io
import os
import pickle
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


@functools.lru_cache(maxsize=None)
def index_tensor(ids: tuple, device: torch.device) -> torch.Tensor:
    """The int64 tensor of a tuple of ids on `device`, made once per (ids,
    device). Indexing a card tensor with it gathers what the Python list of
    the ids gathers, in the same order, without the list's copy to the card
    and the wait for it at every use. Made outside inference mode, so that
    autograd may save it as the index of a gather."""
    with torch.inference_mode(False):
        return torch.tensor(ids, dtype=torch.int64, device=device)


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


class _Stub:
    """Catch-all placeholder for unpicklable classes (chumpy)."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _Stub
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    """Unwrap chumpy stubs / scipy sparse / arrays to a plain ndarray."""
    if isinstance(x, _Stub):
        for key in ("x", "a", "_data"):
            if key in x.__dict__:
                return _to_np(x.__dict__[key])
        raise ValueError(f"cannot unwrap chumpy stub with keys {list(x.__dict__)}")
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


def load_mano_pkl(path: str, dtype=torch.float32) -> ManoModel:
    """Load MANO_RIGHT.pkl / MANO_LEFT.pkl without chumpy (the licensed
    asset; only files this program's users supply are unpickled)."""
    with open(path, "rb") as f:
        data = _TolerantUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    side = "left" if "LEFT" in os.path.basename(path).upper() else "right"
    comps = _to_np(data["hands_components"]).astype(np.float64)
    hands_mean = _to_np(data.get("hands_mean", np.zeros(comps.shape[1])))
    return _model(_to_np(data["v_template"]), _to_np(data["shapedirs"]),
                  _to_np(data["posedirs"]), _to_np(data["J_regressor"]),
                  _to_np(data["weights"]), comps, hands_mean,
                  _to_np(data["f"]), TIPS_RIGHT if side == "right" else TIPS_LEFT,
                  dtype)


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


def get_mano_model(mano_root: str | None = None, side: str = "right",
                   dtype=torch.float32) -> ManoModel:
    """The licensed asset if present under mano_root, else the synthetic rig."""
    if mano_root:
        path = os.path.join(mano_root, f"MANO_{side.upper()}.pkl")
        if os.path.exists(path):
            return load_mano_pkl(path, dtype)
    return synthetic_mano_model(dtype=dtype)
