"""Synthetic SimGrasp-format dataset generator, on the port's MANO.

Port of hotrack_tpu/data/synthetic.py: the same numpy draws in the same
order, with the hand surface from this package's `mano_forward`, so both
packages write the same frames to MANO's float32 rounding. Writes
preproc/<cat>/seq/<ins>_<frame>.npz frames with an `all_dict` of
points/labels/obj_pose/hand_pose/file_name, the layout the SimGrasp reader
consumes, so the tracking path runs without the licensed datasets.
"""

from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np
import torch

from ..mano.layer import mano_forward
from ..mano.model import ManoModel, synthetic_mano_model


def _smooth_noise(rng, t_steps, dim, scale, smoothing=0.9):
    """Smooth random walk: OU-ish accumulated noise."""
    out = np.zeros((t_steps, dim))
    v = np.zeros(dim)
    for t in range(1, t_steps):
        v = smoothing * v + rng.randn(dim) * scale
        out[t] = out[t - 1] + v
    return out


def _box_points(rng, n, half):
    half = np.asarray(half)
    pts = rng.uniform(-1, 1, (n, 3)) * half
    face = rng.randint(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    pts[np.arange(n), face] = sign * half[face]
    return pts


def _rotvec_to_mat(rv):
    angle = np.linalg.norm(rv)
    if angle < 1e-12:
        return np.eye(3)
    axis = rv / angle
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def generate_sequence(mano_model: ManoModel, rng: np.random.RandomState,
                      num_frames: int = 100, points_per_part: int = 900,
                      box_half=(0.035, 0.05, 0.025), motion_scale: float = 1.0):
    """Yields per-frame dicts with the SimGrasp `all_dict` schema; the MANO
    forward runs on the CPU."""
    mano_model = mano_model.to("cpu")
    beta = rng.randn(10).astype(np.float32) * 0.5
    base_trans = np.array([0.0, 0.0, 0.5]) + rng.randn(3) * 0.05

    obj_rv = _smooth_noise(rng, num_frames, 3, 0.015 * motion_scale)
    obj_rv += rng.randn(3) * 0.5
    obj_tr = _smooth_noise(rng, num_frames, 3, 0.002 * motion_scale) + base_trans
    hand_pose_traj = _smooth_noise(rng, num_frames, 48, 0.004 * motion_scale)
    hand_pose_traj[:, :3] += rng.randn(3) * 0.4
    hand_pose_traj[:, 3:] += rng.randn(45) * 0.15

    box_template = _box_points(rng, points_per_part, box_half)

    for t in range(num_frames):
        obj_r = _rotvec_to_mat(obj_rv[t])
        obj_t = obj_tr[t]
        # the wrist rides just "behind" the object
        mano_trans = (obj_t + obj_r @ np.array([0.0, -0.09, 0.0])
                      + rng.randn(3) * 0.001).astype(np.float32)
        mano_pose = hand_pose_traj[t].astype(np.float32)

        with torch.inference_mode():
            verts, _ = mano_forward(
                mano_model, torch.from_numpy(mano_pose)[None],
                betas=torch.from_numpy(beta)[None],
                trans=torch.from_numpy(mano_trans)[None], original_version=True)
        verts = verts[0].numpy()
        hand_sample = verts[rng.permutation(len(verts))[:points_per_part]]
        hand_sample = hand_sample + rng.randn(*hand_sample.shape) * 0.001

        obj_sample = box_template @ obj_r.T + obj_t
        obj_sample = obj_sample + rng.randn(*obj_sample.shape) * 0.001

        points = np.concatenate([obj_sample, hand_sample]).astype(np.float32)
        labels = np.concatenate([np.zeros(len(obj_sample), np.int64),
                                 np.ones(len(hand_sample), np.int64)])
        yield {
            "points": points,
            "labels": labels,
            "obj_pose": {"rotation": obj_r.astype(np.float32),
                         "translation": obj_t.astype(np.float32),
                         "scale": np.float32(1.0)},
            "hand_pose": {"mano_pose": mano_pose,
                          "mano_trans": mano_trans,
                          "mano_beta": beta},
            "file_name": None,  # filled by the writer
        }


def generate_simgrasp_dataset(root: str, category: str = "bottle_sim",
                              num_instances: int = 4, num_frames: int = 100,
                              seed: int = 0,
                              mano_model: ManoModel | None = None,
                              points_per_part: int = 900,
                              motion_scale: float = 1.0):
    """Write a synthetic dataset under <root>/SimGrasp/... and return its
    basepath. Instances < num_instances-1 are train, the last is test."""
    mano_model = mano_model or synthetic_mano_model()
    base = pjoin(root, "SimGrasp")
    read_folder = pjoin(base, "preproc", category, "seq")
    splits_folder = pjoin(base, "splits", category, "seq")
    os.makedirs(read_folder, exist_ok=True)
    os.makedirs(splits_folder, exist_ok=True)

    train_files, test_files = [], []
    for ins in range(num_instances):
        rng = np.random.RandomState(seed + ins)
        for t, frame in enumerate(generate_sequence(
                mano_model, rng, num_frames, points_per_part,
                motion_scale=motion_scale)):
            name = f"{ins:05d}_{t:03d}.npz"
            frame["file_name"] = f"{category}_{ins:05d}_{t:03d}"
            np.savez_compressed(pjoin(read_folder, name), all_dict=frame)
            (test_files if ins == num_instances - 1 else train_files).append(name)

    with open(pjoin(splits_folder, "train.txt"), "w") as f:
        f.write("\n".join(train_files))
    with open(pjoin(splits_folder, "test.txt"), "w") as f:
        f.write("\n".join(test_files))
    return base
