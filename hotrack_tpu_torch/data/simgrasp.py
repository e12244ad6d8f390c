"""SimGrasp dataset reader (host side).

Parity: the reference's datasets/SimGrasp_dataset.py. Reads the preprocessed
.npz frames (`all_dict` with points/labels/obj_pose/hand_pose/file_name),
splits hand (label == num_parts) from object points, presubsamples and pads to
fixed shapes. All GPU work of the reference's __getitem__ (FPS, MANO) happens
later on device (pipeline.prepare_batch).

Directory layout (SimGrasp_dataset.py:17-30):
    <basepath>/preproc/<category>/seq/<ins>_<frame>.npz
    <basepath>/splits/<category>/seq/{train,test}.txt
"""

from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np

from .schema import (PRESUBSAMPLE_FACTOR, RawFrame, empty_frame,
                     frame_rng, pad_points)

# SimGrasp fixed camera intrinsics (SimGrasp_dataset.py:127)
SIMGRASP_PROJECTION = np.array(
    [-1.4343544 * 512 / 2.0, 1.7320507 * 424 / 2.0, 512 / 2, 424 / 2, 512, 424],
    np.float32)  # fx, fy, cx, cy, w, h


def split_dataset(split_folder, read_folder, test_ins_lst, train_ins_lst=None):
    """Write train/test split files by instance prefix (data_utils.py:204-224)."""
    os.makedirs(split_folder, exist_ok=True)
    all_path = sorted(os.listdir(read_folder))
    if train_ins_lst is None:
        train = [i for i in all_path if i.split("_")[0] not in test_ins_lst]
        test = [i for i in all_path if i.split("_")[0] in test_ins_lst]
    else:
        train = [i for i in all_path if i.split("_")[0] in train_ins_lst]
        test = [i for i in all_path if i.split("_")[0] in test_ins_lst]
    with open(pjoin(split_folder, "train.txt"), "w") as f:
        f.write("\n".join(train))
    with open(pjoin(split_folder, "test.txt"), "w") as f:
        f.write("\n".join(test))


class SimGraspDataset:
    """Indexable host reader -> (RawFrame, meta dict)."""

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.root = cfg["data_cfg"]["basepath"]
        self.num_points = cfg["num_points"]
        self.budget = PRESUBSAMPLE_FACTOR * self.num_points
        self.load_pred_obj_pose = cfg.get("use_pred_obj_pose", False)
        self.pred_obj_pose_dir = cfg.get("pred_obj_pose_dir")
        self.seed = cfg.get("seed", 0)  # per-frame RNGs: thread-safe + order-deterministic
        # presample: fresh -> redraw the 5*num_points presubsample every
        # draw (the reference GPU pipeline's per-epoch augmentation)
        self.fresh_presample = cfg.get("presample") == "fresh"

        self.file_list = []
        self.num_parts = {}
        for cat in cfg["obj_category"]:
            self.num_parts[cat] = cfg["data_cfg"][cat]["num_parts"]
            read_folder = pjoin(self.root, "preproc", cat, "seq")
            splits_folder = pjoin(self.root, "splits", cat, "seq")
            use_txt = pjoin(splits_folder, f"{mode}.txt")
            if not os.path.exists(use_txt):
                split = self.cfg["data_cfg"][cat].get("train_val_split")
                if split is not None:
                    train_ins = ["%05d" % i for i in range(split[0])]
                    test_ins = ["%05d" % i for i in range(split[0], split[0] + split[1])]
                else:
                    train_ins = None
                    test_ins = self.cfg["data_cfg"][cat]["test_list"]
                split_dataset(splits_folder, read_folder, test_ins, train_ins)
            with open(use_txt, "r", errors="replace") as fp:
                self.file_list.extend(pjoin(read_folder, l.strip())
                                      for l in fp.readlines() if l.strip())
        print(f"mode: {mode}, data number: {len(self.file_list)}, "
              f"obj_lst: {cfg['obj_category']}")

    def __len__(self):
        return len(self.file_list)

    def _load_pred_obj_pose(self, path: str, category: str):
        """Read the object stage's saved trajectory pickle
        (SimGrasp_dataset.py:130-141)."""
        name = os.path.basename(path)[:-8]
        pkl = pjoin(self.pred_obj_pose_dir, f"{category}_{name}.pkl")
        with open(pkl, "rb") as f:
            pred = pickle.load(f)
        frame_id = int(os.path.basename(path)[-7:-4])
        pose = pred["pred_obj_poses"][frame_id]
        return (np.asarray(pose["rotation"], np.float32).reshape(3, 3),
                np.asarray(pose["translation"], np.float32).reshape(3, 1))

    def __getitem__(self, index: int):
        path = self.file_list[index]
        category = path.split("/")[-3]
        num_parts = self.num_parts[category]
        meta = {"file_name": None, "category": category, "path": path}

        cloud_dict = np.load(path, allow_pickle=True)["all_dict"].item()
        cam = np.asarray(cloud_dict["points"], np.float32)
        label = np.asarray(cloud_dict["labels"])
        meta["file_name"] = cloud_dict.get("file_name", os.path.basename(path))
        if len(cam) == 0:
            return empty_frame(self.budget), meta

        hand_id = num_parts
        hand = cam[label == hand_id]
        obj = cam[label != hand_id]
        if len(hand) == 0 or len(obj) == 0:
            return empty_frame(self.budget), meta

        rng = frame_rng(self.seed, index, self.fresh_presample)
        hand_pts, hand_valid = pad_points(hand, self.budget, rng)
        obj_pts, obj_valid = pad_points(obj, self.budget, rng)

        obj_pose = cloud_dict["obj_pose"]
        if num_parts == 1 and not isinstance(obj_pose, (list, tuple)):
            obj_pose = [obj_pose]
        op = obj_pose[0]

        hp = cloud_dict["hand_pose"]
        pred_r, pred_t = np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)
        if self.load_pred_obj_pose and self.pred_obj_pose_dir:
            pred_r, pred_t = self._load_pred_obj_pose(path, category)

        return RawFrame(
            hand_points=hand_pts, hand_valid=hand_valid,
            obj_points=obj_pts, obj_valid=obj_valid,
            mano_pose=np.asarray(hp["mano_pose"], np.float32).reshape(48),
            mano_trans=np.asarray(hp["mano_trans"], np.float32).reshape(3),
            mano_beta=np.asarray(hp["mano_beta"], np.float32).reshape(10),
            obj_rotation=np.asarray(op["rotation"], np.float32).reshape(3, 3),
            obj_translation=np.asarray(op["translation"], np.float32).reshape(3, 1),
            obj_scale=np.float32(np.asarray(op.get("scale", 1.0)).reshape(())),
            pred_obj_rotation=pred_r, pred_obj_translation=pred_t,
            projection=SIMGRASP_PROJECTION.copy(),
            valid=np.bool_(True),
            annot_hand_kp=np.zeros((21, 3), np.float32),
            annot_palm_template=np.zeros((6, 3), np.float32),
            has_annot_kp=np.bool_(False),
        ), meta
