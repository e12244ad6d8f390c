"""DexYCB dataset reader, host side (port of hotrack_tpu/data/dexycb.py).

Reads the YAML camera intrinsics, decodes the 16-bit aligned depth (mm -> m)
with `data/image.py` (no Pillow), splits the hand (label 255) and the
grasped object (the scene's ycb_grasp_ind id) by the per-frame seg labels,
back-projects at a pixel stride of 2 and radius-filters around the object's
translation and the middle-finger MCP in the native library (`native/`), and
converts the PCA hand-pose annotation (use_pca=True, ncomps=45,
flat_hand_mean=False) to axis-angle with the pkl's hands_mean. The MCP comes
from a host MANO call on the port's `mano/layer.py`, on the CPU in float32.
Invalid sequences are blacklisted; a frame that fails to read yields an
invalid RawFrame that SequenceData repairs.
"""

from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np
import torch
import yaml

from .. import native
from ..mano.layer import mano_forward
from ..mano.model import ManoModel, get_mano_model
from .image import read_png
from .schema import PRESUBSAMPLE_FACTOR, RawFrame, empty_frame, frame_rng, pad_points

WIDTH, HEIGHT = 640, 480

INVALID_SEQUENCES = {
    "20200820-subject-03+20200820_143206+839512060362",
    "20200820-subject-03+20200820_143206+840412060917",
    "20200820-subject-03+20200820_143206+932122061900",
    "20201002-subject-08+20201002_111616+841412060263",
    "20201002-subject-08+20201002_111616+839512060362",
    "20201002-subject-08+20201002_111616+840412060917",
    "20201022-subject-10+20201022_113502+839512060362",
    "20200820-subject-03+20200820_141302+841412060263",
    "20200820-subject-03+20200820_141302+840412060917",
    "20200908-subject-05+20200908_143832+839512060362",
    "20200908-subject-05+20200908_143832+932122060857",
    "20200908-subject-05+20200908_145430+932122062010",
    "20200928-subject-07+20200928_145424+836212060125",
    "20201002-subject-08+20201002_110425+841412060263",
    "20201015-subject-09+20201015_143338+841412060263",
    "20201015-subject-09+20201015_144651+841412060263",
    "20201015-subject-09+20201015_143338+932122062010",
    "20201015-subject-09+20201015_143338+932122060861",
    "20201015-subject-09+20201015_143338+839512060362",
    "20200928-subject-07+20200928_145204+836212060125",
}

YCB_CLASSES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
    17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
    20: "052_extra_large_clamp", 21: "061_foam_brick",
}


def depth_to_cloud_strided(depth: np.ndarray, mask: np.ndarray, k, stride=2):
    """Back-project the masked depth pixels at a pixel stride."""
    d = depth[::stride, ::stride]
    m = mask[::stride, ::stride]
    rows, cols = np.nonzero(m & (d > 1e-6))
    z = d[rows, cols].astype(np.float32)
    x = (cols * stride - k[0][2]) * z / k[0][0]
    y = (rows * stride - k[1][2]) * z / k[1][1]
    return np.stack([x, y, z], axis=1)


def pca_pose_to_axisangle(mano_model: ManoModel, pose48: np.ndarray) -> np.ndarray:
    """manopth(use_pca=True, ncomps=45, flat_hand_mean=False) annotation ->
    48-dof axis-angle: theta = hands_mean + pca @ components."""
    comps = mano_model.hands_components.detach().cpu().numpy()
    mean = mano_model.hands_mean.detach().cpu().numpy()
    theta = mean + pose48[3:48] @ comps
    return np.concatenate([pose48[:3], theta]).astype(np.float32)


class DexYCBDataset:
    """Indexable host reader -> (RawFrame, meta); exposes `seq_start`."""

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.root = cfg["data_cfg"]["basepath"]
        self.num_points = cfg["num_points"]
        self.budget = PRESUBSAMPLE_FACTOR * self.num_points
        self.load_pred_obj_pose = cfg.get("use_pred_obj_pose", False)
        self.pred_obj_pose_dir = cfg.get("pred_obj_pose_dir")
        self.seed = cfg.get("seed", 0)  # per-frame generators: order-independent
        # presample: fresh -> redraw the presubsample on every read
        self.fresh_presample = cfg.get("presample") == "fresh"
        self.mano = get_mano_model(cfg.get("mano_root"))  # on the CPU, float32

        self.seq_name_lst, self.id_lst, self.start_frame_lst = [], [], []
        self.seq_start = []
        cnt = 0
        for category in cfg["obj_category"]:
            split = np.load(pjoin(self.root, f"splits/{mode}_{category}.npy"),
                            allow_pickle=True).item()
            for filename, frames in split.items():
                if filename in INVALID_SEQUENCES:
                    continue
                self.seq_start.append(cnt)
                start = int(frames[0].split(".")[0])
                for frame in frames:
                    self.seq_name_lst.append(filename.replace("+", "/"))
                    self.id_lst.append(int(frame.split(".")[0]))
                    self.start_frame_lst.append(start)
                    cnt += 1
        print(f"DexYCB mode {mode}: {cnt} frames, "
              f"{len(self.seq_start)} sequences")

    def __len__(self):
        return len(self.id_lst)

    def __getitem__(self, index: int):
        seq = self.seq_name_lst[index]
        fid = self.id_lst[index]
        meta = {"file_name": f"{seq}/{fid:06d}".replace("/", "+"),
                "category": None, "path": None}
        try:
            return self._load(seq, fid, index, meta)
        except Exception as e:
            print(f"DexYCB frame {seq}/{fid} failed: {e}")
            return empty_frame(self.budget), meta

    def _load(self, seq: str, fid: int, index: int, meta: dict):
        serial = seq.split("/")[-1]
        subject, scene = seq.split("/")[0], seq.split("/")[1]
        anno = np.load(pjoin(self.root, f"{seq}/labels_{fid:06d}.npz"))
        with open(pjoin(self.root, f"{subject}/{scene}/meta.yml")) as f:
            scene_cfg = yaml.load(f, Loader=yaml.FullLoader)
        idx = scene_cfg["ycb_grasp_ind"]
        obj_id = scene_cfg["ycb_ids"][idx]
        obj_name = YCB_CLASSES[obj_id]
        meta["category"] = obj_name

        with open(pjoin(self.root,
                        f"calibration/intrinsics/{serial}_640x480.yml")) as f:
            intr = yaml.load(f, Loader=yaml.FullLoader)["color"]
        k = [[intr["fx"], 0, intr["ppx"]], [0, intr["fy"], intr["ppy"]],
             [0, 0, 1]]

        obj_trans = anno["pose_y"][idx][:, 3].astype(np.float32)
        obj_rot = anno["pose_y"][idx][:, :3].astype(np.float32)
        scale = np.float32(1.0)
        scale_pth = pjoin(self.root, "../YCB/SDF/NormalizationParameters",
                          obj_name, "textured_simple.npz")
        if os.path.exists(scale_pth):
            scale = np.float32(2.0 / np.load(scale_pth)["scale"][0])

        pose_m = np.asarray(anno["pose_m"][0], np.float32)
        mano_pose = pca_pose_to_axisangle(self.mano, pose_m[:48])
        mano_trans = pose_m[48:51]
        with open(pjoin(self.root, "calibration",
                        f"mano_{scene_cfg['mano_calib'][0]}", "mano.yml")) as f:
            mano_beta = np.asarray(yaml.load(f, Loader=yaml.FullLoader)["betas"],
                                   np.float32)

        # the hand's centre (middle MCP) for the radius filter, by a host MANO call
        with torch.no_grad():
            _, kp = mano_forward(self.mano, torch.from_numpy(mano_pose)[None],
                                 betas=torch.from_numpy(mano_beta)[None],
                                 trans=torch.from_numpy(np.ascontiguousarray(mano_trans))[None],
                                 original_version=True)
        kp = kp[0].numpy()

        depth = (read_png(pjoin(self.root, f"{seq}/aligned_depth_to_color_{fid:06d}.png"))
                 / 1000.0).astype(np.float32)
        labels = anno["seg"].astype(np.uint8)
        # back-projection, label split and radius filter at stride 2, fused
        obj_pcd = native.backproject_filter(
            depth, labels, int(obj_id), k[0][0], k[1][1], k[0][2], k[1][2],
            center=obj_trans, radius=float(scale / 2), stride=2)
        hand_pcd = native.backproject_filter(
            depth, labels, 255, k[0][0], k[1][1], k[0][2], k[1][2],
            center=kp[9], radius=0.15, stride=2)
        if len(hand_pcd) == 0 or len(obj_pcd) == 0:
            return empty_frame(self.budget), meta

        rng = frame_rng(self.seed, index, self.fresh_presample)
        hand_pts, hand_valid = pad_points(hand_pcd.astype(np.float32),
                                          self.budget, rng)
        obj_pts, obj_valid = pad_points(obj_pcd.astype(np.float32),
                                        self.budget, rng)

        pred_r, pred_t = np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)
        if self.load_pred_obj_pose and self.pred_obj_pose_dir:
            pkl = pjoin(self.pred_obj_pose_dir, "%s+%06d.pkl" % (
                seq.replace("/", "+"), self.start_frame_lst[index]))
            with open(pkl, "rb") as f:
                pred = pickle.load(f)
            pose = pred["pred_obj_poses"][fid - self.start_frame_lst[index]]
            pred_r = np.asarray(pose["rotation"], np.float32).reshape(3, 3)
            pred_t = np.asarray(pose["translation"], np.float32).reshape(3, 1)

        return RawFrame(
            hand_points=hand_pts, hand_valid=hand_valid,
            obj_points=obj_pts, obj_valid=obj_valid,
            mano_pose=mano_pose,
            mano_trans=mano_trans,
            mano_beta=mano_beta,
            obj_rotation=obj_rot, obj_translation=obj_trans[:, None],
            obj_scale=scale,
            pred_obj_rotation=pred_r, pred_obj_translation=pred_t,
            projection=np.array([intr["fx"], intr["fy"], intr["ppx"],
                                 intr["ppy"], WIDTH, HEIGHT], np.float32),
            valid=np.bool_(True),
            annot_hand_kp=kp.astype(np.float32),
            annot_palm_template=np.zeros((6, 3), np.float32),
            has_annot_kp=np.bool_(True),
        ), meta
