"""HO3D dataset reader, host side (port of hotrack_tpu/data/ho3d.py).

Decodes HO3D's two-channel PNG depth (depth = (R + G * 256) * scale),
back-projects it to a camera-frame cloud with the y and z signs flipped,
splits hand and object by the seg mask (blue channel the hand, green the
object; stored at a smaller size and resized to 480 x 640 by the nearest
pixel), rejects outliers by their distance to the object's translation and
to the middle-finger MCP, and reads the sequence segments of the
finalv2_test_<cat>.npy split dicts. The depth decode and the fused
back-projection run in the native library (`native/`), the PNG files are
read by `data/image.py`: neither OpenCV nor Pillow is needed. Downsampling,
jitter and MANO run on the device (pipeline.prepare_batch with
template_with_theta=True).
"""

from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np

from .. import native
from .image import imread, resize_nearest
from .schema import PRESUBSAMPLE_FACTOR, RawFrame, empty_frame, frame_rng, pad_points

HEIGHT, WIDTH = 480, 640
DEPTH_SCALE = 0.00012498664727900177
# annotation joints -> the 21-keypoint convention
KP_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
OBJ_RADIUS_M, HAND_RADIUS_M = 0.25, 0.15   # outlier rejection


def read_depth_img(path: str) -> np.ndarray:
    """HO3D's depth PNG -> (H, W) float32 metres, (R + G * 256) * scale,
    decoded as `_clouds` decodes it (the native library, in float32)."""
    return native.decode_ho3d_depth(imread(path), DEPTH_SCALE)


def get_intrinsics(path: str) -> np.ndarray:
    """fx / fy / ppx / ppy from the first line of a calibration file."""
    with open(path, "r") as f:
        items = f.readline().strip().split(",")
    vals = {}
    for item in items:
        for key in ("fx", "fy", "ppx", "ppy"):
            if key in item:
                vals[key] = float(item.split(":")[1].strip())
    return np.array([[vals["fx"], 0, vals["ppx"]],
                     [0, vals["fy"], vals["ppy"]], [0, 0, 1]])


def depth_to_cloud(dpt: np.ndarray, k: np.ndarray):
    """Back-project depth to the camera cloud: (cld (M, 3), choose (M,)),
    x from the column against cx / fx, y from the row against cy / fy."""
    if dpt.ndim > 2:
        dpt = dpt[:, :, 0]
    mask = dpt > 1e-6
    choose = mask.flatten().nonzero()[0]
    if len(choose) < 1:
        return None, None
    rows, cols = np.divmod(choose, dpt.shape[1])
    z = dpt.flatten()[choose].astype(np.float32)
    x = (cols.astype(np.float32) - k[0][2]) * z / k[0][0]
    y = (rows.astype(np.float32) - k[1][2]) * z / k[1][1]
    return np.stack([x, y, z], axis=1), choose


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(rvec)
    if angle < 1e-12:
        return np.eye(3)
    axis = np.asarray(rvec).reshape(3) / angle
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def read_seg_mask(path: str) -> np.ndarray:
    """A seg PNG resized to 480 x 640 by the nearest pixel: (480, 640, 3)
    uint8, BGR (channel 0 the hand, channel 1 the object)."""
    return resize_nearest(imread(path), (WIDTH, HEIGHT))


class HO3DDataset:
    """Indexable host reader -> (RawFrame, meta). `seq_start` lets
    SequenceData group the frames by annotated segment."""

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

        self.seq_lst, self.fid_lst, self.start_frame_lst = [], [], []
        self.seq_start = []
        test_data = {}
        for category in cfg["obj_category"]:
            split_pth = pjoin(self.root, "splits", f"finalv2_test_{category}.npy")
            test_data.update(np.load(split_pth, allow_pickle=True).item())
        for seq, segments in test_data.items():
            for segment, idx_lst in segments.items():
                self.seq_start.append(len(self.fid_lst))
                self.seq_lst.extend([seq] * len(idx_lst))
                self.fid_lst.extend(idx_lst)
                self.start_frame_lst.extend([idx_lst[0]] * len(idx_lst))
        print(f"HO3D mode {mode}: {len(self.fid_lst)} frames")

    def __len__(self):
        return len(self.fid_lst)

    def _anno(self, seq: str, fid: str) -> dict:
        with open(pjoin(self.root, f"train/{seq}/meta/{fid}.pkl"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    def _clouds(self, seq: str, fid: str):
        """(hand cloud, object cloud, camera matrix, annotation) of a frame."""
        anno = self._anno(seq, fid)
        if seq[-2].isnumeric():
            calib = pjoin(self.root, "calibration", seq[:-1], "calibration",
                          f"cam_{seq[-1]}_intrinsics.txt")
            k = get_intrinsics(calib).tolist()
        else:
            k = anno["camMat"]
        depth = read_depth_img(pjoin(self.root, f"train/{seq}/depth/{fid}.png"))
        mask = read_seg_mask(pjoin(self.root, f"train/{seq}/seg/{fid}.png"))
        fx, fy = k[0][0], k[1][1]
        cx, cy = k[0][2], k[1][2]
        hand_mask = (mask[:, :, 0] == 255).astype("uint8")
        obj_mask = (mask[:, :, 1] == 255).astype("uint8")
        hand = native.backproject_filter(depth, hand_mask, 1, fx, fy, cx, cy,
                                         sign_y=-1.0, sign_z=-1.0)
        obj = native.backproject_filter(depth, obj_mask, 1, fx, fy, cx, cy,
                                        sign_y=-1.0, sign_z=-1.0)
        return hand, obj, k, anno

    def _load_pred_obj_pose(self, seq, start_frame, cur_frame):
        pkl = pjoin(self.pred_obj_pose_dir,
                    "%s_%04d.pkl" % (seq.replace("/", "_"), start_frame))
        with open(pkl, "rb") as f:
            pred = pickle.load(f)
        pose = pred["pred_obj_poses"][cur_frame - start_frame]
        return (np.asarray(pose["rotation"], np.float32).reshape(3, 3),
                np.asarray(pose["translation"], np.float32).reshape(3, 1))

    def __getitem__(self, index: int):
        seq = self.seq_lst[index]
        fid = "%04d" % self.fid_lst[index]
        meta = {"file_name": f"{seq}/{fid}", "category": None, "path": None}
        try:
            hand, obj, k, anno = self._clouds(seq, fid)
        except Exception as e:  # missing or corrupt frame -> repairable invalid
            print(f"HO3D frame {seq}/{fid} failed: {e}")
            return empty_frame(self.budget), meta
        meta["category"] = anno["objName"]
        if hand is None or len(hand) == 0 or obj is None or len(obj) == 0:
            return empty_frame(self.budget), meta

        obj_rot = _rodrigues(np.asarray(anno["objRot"]).reshape(3))
        obj_trans = np.asarray(anno["objTrans"], np.float32).reshape(3, 1)
        kp = np.asarray(anno["handJoints3D"], np.float32)[list(KP_REORDER)]

        obj = obj[np.linalg.norm(obj - obj_trans.T, axis=-1) < OBJ_RADIUS_M]
        hand = hand[np.linalg.norm(hand - kp[9], axis=-1) < HAND_RADIUS_M]
        if len(hand) == 0 or len(obj) == 0:
            return empty_frame(self.budget), meta

        rng = frame_rng(self.seed, index, self.fresh_presample)
        hand_pts, hand_valid = pad_points(hand.astype(np.float32), self.budget, rng)
        obj_pts, obj_valid = pad_points(obj.astype(np.float32), self.budget, rng)

        # the object's scale from its SDF normalisation
        scale = np.float32(1.0)
        scale_pth = pjoin(self.root, "../YCB/SDF/NormalizationParameters",
                          anno["objName"], "textured_simple.npz")
        if os.path.exists(scale_pth):
            scale = np.float32(2.0 / np.load(scale_pth)["scale"][0])

        pred_r, pred_t = np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)
        if self.load_pred_obj_pose and self.pred_obj_pose_dir:
            pred_r, pred_t = self._load_pred_obj_pose(
                seq, self.start_frame_lst[index], self.fid_lst[index])

        cam_fx, cam_fy = k[0][0], k[1][1]
        cam_cx, cam_cy = k[0][2], k[1][2]
        return RawFrame(
            hand_points=hand_pts, hand_valid=hand_valid,
            obj_points=obj_pts, obj_valid=obj_valid,
            mano_pose=np.asarray(anno["handPose"], np.float32).reshape(48),
            mano_trans=np.asarray(anno["handTrans"], np.float32).reshape(3),
            mano_beta=np.asarray(anno["handBeta"], np.float32).reshape(10),
            obj_rotation=obj_rot.astype(np.float32),
            obj_translation=obj_trans,
            obj_scale=scale,
            pred_obj_rotation=pred_r, pred_obj_translation=pred_t,
            # fx negated, as the reference's projection dict holds it
            projection=np.array([-cam_fx, cam_fy, cam_cx, cam_cy,
                                 WIDTH, HEIGHT], np.float32),
            valid=np.bool_(True),
            annot_hand_kp=kp,
            annot_palm_template=np.zeros((6, 3), np.float32),
            has_annot_kp=np.bool_(True),
        ), meta
