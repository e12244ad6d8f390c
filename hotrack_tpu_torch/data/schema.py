"""Frame schema shared by all dataset readers.

The reference loaders do GPU work inside DataLoader workers (CUDA FPS + MANO
forward in __getitem__, SimGrasp_dataset.py:60-96), forcing spawn-mode
multiprocessing. The TPU build splits the pipeline:

  host (numpy, thin):   file read -> hand/object split -> random presubsample
                        -> pad to fixed shapes (+ valid masks)
  device (one jit):     FPS -> gather -> MANO ground truth -> jitter
                        (prepare_batch in pipeline.py)

`RawFrame` is the host->device boundary: fixed-shape numpy arrays only, so
frames stack into batches and sequences without ragged shapes. String metadata
(file_name, category) travels separately on the host.

The device-side output dict mirrors the reference's `full_data` schema
(SimGrasp_dataset.py:110-128) so the model/tracker layer reads the same keys.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# host-side presubsample factor: FPS sees at most 5x num_points candidates
# (the reference's loader trick, data_utils.py:234-241)
PRESUBSAMPLE_FACTOR = 5


class RawFrame(NamedTuple):
    """Fixed-shape host frame. P = presubsample budget (5 * num_points)."""

    hand_points: np.ndarray      # (P, 3) float32, zero-padded
    hand_valid: np.ndarray       # (P,) bool
    obj_points: np.ndarray       # (P, 3) float32
    obj_valid: np.ndarray        # (P,) bool
    mano_pose: np.ndarray        # (48,) float32 axis-angle (3 global + 45)
    mano_trans: np.ndarray       # (3,) float32
    mano_beta: np.ndarray        # (10,) float32
    obj_rotation: np.ndarray     # (3, 3) float32 gt object pose
    obj_translation: np.ndarray  # (3, 1) float32
    obj_scale: np.ndarray        # () float32
    pred_obj_rotation: np.ndarray     # (3, 3) float32 (identity if unused)
    pred_obj_translation: np.ndarray  # (3, 1) float32
    projection: np.ndarray       # (6,) float32 [fx, fy, cx, cy, w, h]
    valid: np.ndarray            # () bool — False for unrecoverable frames
    # datasets with direct keypoint annotations (HO3D/DexYCB) fill these and
    # set has_annot_kp; SimGrasp derives gt from MANO on device instead
    annot_hand_kp: np.ndarray    # (21, 3) float32
    annot_palm_template: np.ndarray  # (6, 3) float32
    has_annot_kp: np.ndarray     # () bool


def frame_rng(seed: int, index: int, fresh: bool = False):
    """Host RNG for a reader's per-frame presubsample (pad_points).

    Default: deterministic per (seed, frame index) — thread-safe and
    iteration-order independent, so eval runs reproduce exactly. `fresh`
    (config `presample: fresh`) redraws from OS entropy on every call,
    which is the reference GPU pipeline's behavior: its >5*num_points
    presubsample uses the global np.random stream, so every epoch trains
    on a DIFFERENT subset of each large cloud (data_utils.py:234-241) —
    per-epoch augmentation. Use for training parity on real datasets whose
    clouds exceed the 5*num_points budget; keep the default for eval."""
    if fresh:
        return np.random.RandomState()  # OS-entropy seeded, thread-safe
    return np.random.RandomState((seed * 1000003 + index) % (2**31))


def pad_points(points: np.ndarray, budget: int, rng: np.random.RandomState):
    """Random-permute, take at most `budget`, zero-pad; returns (pts, valid).
    Mirrors the loader-side shuffle + presubsample
    (SimGrasp_dataset.py:47-51, data_utils.py:234-241)."""
    n = len(points)
    take = min(n, budget)
    idx = rng.permutation(n)[:take]
    out = np.zeros((budget, 3), np.float32)
    valid = np.zeros((budget,), bool)
    out[:take] = points[idx]
    valid[:take] = True
    return out, valid


def empty_frame(budget: int) -> RawFrame:
    """An all-invalid placeholder (the reference returns None and repairs the
    sequence later, dataset.py:86-99; fixed shapes require a real frame)."""
    return RawFrame(
        hand_points=np.zeros((budget, 3), np.float32),
        hand_valid=np.zeros((budget,), bool),
        obj_points=np.zeros((budget, 3), np.float32),
        obj_valid=np.zeros((budget,), bool),
        mano_pose=np.zeros((48,), np.float32),
        mano_trans=np.zeros((3,), np.float32),
        mano_beta=np.zeros((10,), np.float32),
        obj_rotation=np.eye(3, dtype=np.float32),
        obj_translation=np.zeros((3, 1), np.float32),
        obj_scale=np.float32(1.0),
        pred_obj_rotation=np.eye(3, dtype=np.float32),
        pred_obj_translation=np.zeros((3, 1), np.float32),
        projection=np.zeros((6,), np.float32),
        valid=np.bool_(False),
        annot_hand_kp=np.zeros((21, 3), np.float32),
        annot_palm_template=np.zeros((6, 3), np.float32),
        has_annot_kp=np.bool_(False),
    )


def stack_frames(frames) -> RawFrame:
    """Stack a list of RawFrames into a batched RawFrame (leading axis B)."""
    return RawFrame(*(np.stack([getattr(f, k) for f in frames])
                      for k in RawFrame._fields))
