"""HO3D- and DexYCB-layout dataset trees, written from a synthetic scene, so
that the real-data readers and the pipelines behind them run without the
licensed datasets (tests, chip_smoke.py).

A scene is the synthetic generator's (data/synthetic.py) hand and object
motion: a MANO hand whose wrist rides behind an object, both seen by one
pinhole camera about 0.5 m away. Its points are z-buffered into 480 x 640
depth and label images, which are written in each dataset's encoding:

- HO3D (`write_ho3d_tree`): train/<seq>/depth/<fid>.png in the two-channel
  encoding (R the low byte of depth / DEPTH_SCALE, G the high byte),
  train/<seq>/seg/<fid>.png at HO3D's stored 240 x 320 (blue the hand,
  green the object), meta/<fid>.pkl with the annotation keys, the camera's
  calibration file, splits/finalv2_test_<cat>.npy; annotations in HO3D's
  frame (y and z of the camera frame negated).
- DexYCB (`write_dexycb_tree`): the 16-bit aligned depth in millimetres,
  labels_<fid>.npz (seg labels, pose_y, pose_m with the hand pose as 45 PCA
  coefficients), meta.yml, the intrinsics and MANO calibration YAML files,
  splits/test_<cat>.npy.

With a DeepSDF decoder (`decoder_object`), the HO3D object is the decoder's
own shape: a randomly initialised decoder describes no object, so the
closed zero level set around an interior minimum of its field is taken as
the object's surface, and its last layer is rescaled and shifted so that
the field is zero there with a unit gradient. The decoder is saved in the
reference layout (`module.`-prefixed `model_state_dict`) with its
normalisation, the predicted latent codes and YCB/CatPose2InsPose.npy, at
the paths sdf/assets.load_obj_for_opt resolves. PNG files are written by
data/image.py; nothing here needs OpenCV, Pillow or JAX.
"""

from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np
import torch
import yaml
from scipy.spatial.transform import Rotation

from ..mano.layer import mano_forward
from ..mano.model import ManoModel, synthetic_mano_model
from .ho3d import DEPTH_SCALE, KP_REORDER
from .image import write_png
from .synthetic import generate_sequence

HW = (480, 640)
HO3D_SEG_HW = (240, 320)
# one camera of HO3D's kind
INTRINSICS = {"fx": 617.343, "fy": 617.343, "cx": 312.42, "cy": 241.42}
HO3D_OBJECT = "006_mustard_bottle"
DEXYCB_SUBJECT, DEXYCB_SCENE, DEXYCB_SERIAL = ("20200709-subject-01", "20200709_141754",
                                               "836212060125")
# 021_bleach_cleanser in DexYCB's YCB list: another object than HO3D's, so that
# the two trees under one root keep their own normalisations
DEXYCB_OBJECT_ID = 12
FLIP = np.diag([1.0, -1.0, -1.0])   # the camera frame <-> HO3D's annotation frame


HAND_COPIES = 6      # jittered copies of each MANO vertex in the hand's cloud


def scene(mano: ManoModel, num_frames: int, seed: int) -> list:
    """Per frame, in the camera frame (z forward, metres): the object pose
    (rotation (3, 3), translation (3,)), the hand's MANO parameters, its 21
    keypoints and a dense cloud around its 778 vertices (each vertex and
    HAND_COPIES copies jittered by 2 mm, so that the z-buffer sees a
    surface)."""
    rng = np.random.RandomState(seed)
    mano = mano.to("cpu")
    frames = []
    for f in generate_sequence(mano, rng, num_frames, points_per_part=16):
        hp = f["hand_pose"]
        with torch.no_grad():
            verts, kp = mano_forward(mano, torch.from_numpy(hp["mano_pose"])[None],
                                     betas=torch.from_numpy(hp["mano_beta"])[None],
                                     trans=torch.from_numpy(hp["mano_trans"])[None],
                                     original_version=True)
        verts = verts[0].numpy().astype(np.float64)
        cloud = np.concatenate([verts] + [verts + rng.randn(*verts.shape) * 0.002
                                          for _ in range(HAND_COPIES)])
        frames.append({"obj_rotation": f["obj_pose"]["rotation"].astype(np.float64),
                       "obj_translation": f["obj_pose"]["translation"].astype(np.float64),
                       "mano_pose": hp["mano_pose"], "mano_trans": hp["mano_trans"],
                       "mano_beta": hp["mano_beta"], "hand_kp": kp[0].numpy(),
                       "hand_cloud": cloud})
    return frames


def box_surface(rng, n: int = 20000) -> np.ndarray:
    """Points on the synthetic generator's box, its own frame."""
    half = np.array([0.035, 0.05, 0.025])
    pts = rng.uniform(-1, 1, (n, 3)) * half
    face = rng.randint(0, 3, n)
    pts[np.arange(n), face] = rng.choice([-1.0, 1.0], n) * half[face]
    return pts


def render(parts, splat: int = 1):
    """Z-buffer camera-frame point sets through INTRINSICS: parts is a list of
    (points (N, 3), label); returns depth (H, W) float64 metres (0 where
    nothing lies) and the label (H, W) uint8 of the nearest point (0
    background). Each point covers the (2 splat + 1)^2 pixels around its
    own."""
    h, w = HW
    k = INTRINSICS
    pts = np.concatenate([p for p, _ in parts])
    lab = np.concatenate([np.full(len(p), label, np.uint8) for p, label in parts])
    keep = pts[:, 2] > 1e-3
    pts, lab = pts[keep], lab[keep]
    u = np.floor(k["fx"] * pts[:, 0] / pts[:, 2] + k["cx"]).astype(np.int64)
    v = np.floor(k["fy"] * pts[:, 1] / pts[:, 2] + k["cy"]).astype(np.int64)
    us, vs, zs, ls = [], [], [], []
    for du in range(-splat, splat + 1):
        for dv in range(-splat, splat + 1):
            us.append(u + du), vs.append(v + dv), zs.append(pts[:, 2]), ls.append(lab)
    u, v, z, lab = map(np.concatenate, (us, vs, zs, ls))
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat, z, lab = (v * w + u)[inside], z[inside], lab[inside]
    depth = np.full(h * w, np.inf)
    np.minimum.at(depth, flat, z)
    labels = np.zeros(h * w, np.uint8)
    front = z == depth[flat]
    labels[flat[front]] = lab[front]
    depth[np.isinf(depth)] = 0.0
    return depth.reshape(h, w), labels.reshape(h, w)


# --------------------------------------------------------------------------
# the object of a DeepSDF decoder

OBJECT_SIZE_M = 0.08        # the object's largest extent
GRID, FINE_GRID = 41, 64     # the field's samples: the cube, then the object's box


def _field(decoder, latent, xyz, chunk: int = 1 << 16) -> np.ndarray:
    """The decoder's value before its final tanh, float64, at (N, 3)
    instance-frame points."""
    device = latent.device
    out = []
    with torch.no_grad():
        for s in range(0, len(xyz), chunk):
            p = torch.as_tensor(xyz[s:s + chunk], dtype=torch.float32, device=device)
            inp = torch.cat([latent.reshape(1, -1).expand(len(p), -1), p], dim=-1)
            out.append(decoder(inp)[:, 0].double().cpu().numpy())
    return np.arctanh(np.clip(np.concatenate(out), -1 + 1e-12, 1 - 1e-12))


def _grid(lo, hi, n):
    axes = [np.linspace(lo[i], hi[i], n) for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def decoder_object(decoder, latent: torch.Tensor):
    """Make the decoder's field describe an object and return it.

    On a grid over [-1, 1]^3 (the instance frame) the decoder's field f is
    sampled; of the components of its sublevel sets {f < th} around its
    interior local minima that stay clear of the grid's border, the largest
    is the object (where none does, the median's level set, open). The decoder's last
    layer is changed in place so that it computes tanh(k (f - th)), k the
    inverse of the field's median gradient on the component's border: zero
    on the surface, a unit gradient across it. Returns (normalisation
    {'offset' (3,), 'scale' (1,)} with the component's centre at the
    category frame's origin and its largest extent OBJECT_SIZE_M, surface
    points (M, 3) in the category frame, metres)."""
    from scipy import ndimage
    grid, fine = GRID, FINE_GRID
    xyz = _grid((-1.0,) * 3, (1.0,) * 3, grid)
    f = _field(decoder, latent, xyz).reshape(grid, grid, grid)
    def closed_component(m, th):
        """The component of {f < th} that holds grid point m, or None where
        it reaches the grid's border."""
        lab, _ = ndimage.label(f < th)
        comp = lab == lab[m]
        idx = np.argwhere(comp)
        return None if idx.min() <= 1 or idx.max() >= grid - 2 else comp

    # every interior local minimum, deepest first: the largest closed
    # sublevel component around one of them (bisection on the level)
    minima = np.argwhere((ndimage.minimum_filter(f, size=3) == f)[2:-2, 2:-2, 2:-2]) + 2
    best = None
    for m in sorted(map(tuple, minima), key=lambda i: f[i])[:16]:
        lo, hi = float(f[m]), float(f.max())
        for _ in range(16):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if closed_component(m, mid) is not None else (lo, mid)
        th = float(f[m]) + 0.8 * (lo - float(f[m]))
        comp = closed_component(m, th)
        if comp is not None and comp.sum() > 1 and (best is None or comp.sum() > best[1].sum()):
            best = (th, comp)
    if best is None:   # no closed component: the median's open level set
        th = float(np.median(f))
        best = (th, f < th)
    th, comp = best

    spacing = 2.0 / (grid - 1)
    grad = np.linalg.norm(np.stack(np.gradient(f, spacing)), axis=0)
    border = comp & ~ndimage.binary_erosion(comp)
    k = 1.0 / max(float(np.median(grad[border])), 1e-12)
    last = getattr(decoder, f"lin{decoder.num_layers - 2}")
    with torch.no_grad():
        w = last.weight_g if hasattr(last, "weight_g") else last.weight
        w.mul_(k)
        last.bias.copy_(k * (last.bias - th))

    # the surface on a finer grid over the component's box: crossings of
    # the zero level between neighbours, each inside the component's box
    idx = np.argwhere(comp)
    lo = np.maximum(-1.0 + (idx.min(0) - 1) * spacing, -1.0)
    hi = np.minimum(-1.0 + (idx.max(0) + 1) * spacing, 1.0)
    xyz = _grid(lo, hi, fine)
    g = _field(decoder, latent, xyz).reshape(fine, fine, fine)
    pts = []
    for axis in range(3):
        a = np.moveaxis(g, axis, 0)
        p = np.moveaxis(xyz.reshape(fine, fine, fine, 3), axis, 0)
        cross = np.sign(a[:-1]) != np.sign(a[1:])
        t = a[:-1][cross] / (a[:-1][cross] - a[1:][cross])
        pts.append(p[:-1][cross] + t[:, None] * (p[1:][cross] - p[:-1][cross]))
    surface = np.concatenate(pts)
    # keep the crossings of this component: the nearest coarse voxel is in
    # it or next to it
    near = np.clip(np.rint((surface + 1.0) / spacing).astype(np.int64), 0, grid - 1)
    surface = surface[ndimage.binary_dilation(comp)[near[:, 0], near[:, 1], near[:, 2]]]
    centre = surface.mean(0)
    scale = float((surface.max(0) - surface.min(0)).max()) / OBJECT_SIZE_M
    normalization = {"offset": (centre / scale).astype(np.float32),
                     "scale": np.array([scale], np.float32)}
    return normalization, surface / scale - centre / scale


def save_decoder(path: str, decoder) -> str:
    """A DeepSDF checkpoint in the reference layout: {'model_state_dict':
    the state dict under a DataParallel wrapper's `module.` prefix}."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 2000, "model_state_dict": {
        "module." + key: value.detach().cpu() for key, value in decoder.state_dict().items()}},
        path)
    return path


# --------------------------------------------------------------------------
# HO3D

def write_ho3d_tree(root: str, num_frames: int, seqs=("ABF10",), decoder=None,
                    latent=None) -> dict:
    """Write <root>/HO3D (one segment a sequence, frames 0 .. num_frames-1)
    and, with a decoder, its SDF assets under <root>/SimGrasp, <root>/YCB
    and <root>/HO3D/SDF. A sequence whose name's second-last character is a
    digit reads its intrinsics from calibration/, the others from the
    annotation's camMat. Without a decoder the object is the synthetic box
    (scale 1). Returns {'basepath', 'normalization', 'object' (the category
    frame's surface points), 'frames' {seq: the scene}}."""
    mano = synthetic_mano_model()
    obj_name = HO3D_OBJECT
    base = pjoin(root, "HO3D")
    k = INTRINSICS
    cam_mat = np.array([[k["fx"], 0, k["cx"]], [0, k["fy"], k["cy"]], [0, 0, 1]])
    rng = np.random.RandomState(0)
    if decoder is not None:
        normalization, obj_surface = decoder_object(decoder, latent)
        save_decoder(pjoin(root, "SimGrasp/SDF/examples/bottle_sim/ModelParameters/2000.pth"),
                     decoder)
    else:
        normalization = {"offset": np.zeros(3, np.float32), "scale": np.array([2.0], np.float32)}
        obj_surface = box_surface(rng)
    norm_dir = pjoin(root, "YCB/SDF/NormalizationParameters", obj_name)
    os.makedirs(norm_dir, exist_ok=True)
    np.savez(pjoin(norm_dir, "textured_simple.npz"), **normalization)
    np.save(pjoin(root, "YCB", "CatPose2InsPose.npy"),
            {obj_name: {"rotation": np.eye(3, dtype=np.float32),
                        "translation": np.zeros(3, np.float32)}})

    inv_reorder = np.argsort(np.asarray(KP_REORDER))
    split, scenes = {}, {}
    for n, seq in enumerate(seqs):
        frames = scene(mano, num_frames, n)
        scenes[seq] = frames
        for d in ("depth", "seg", "meta"):
            os.makedirs(pjoin(base, "train", seq, d), exist_ok=True)
        for fid, fr in enumerate(frames):
            name = "%04d" % fid
            obj = obj_surface @ fr["obj_rotation"].T + fr["obj_translation"]
            depth, labels = render([(fr["hand_cloud"], 1), (obj, 2)])
            counts = np.rint(depth / DEPTH_SCALE).astype(np.int64)
            rgb = np.zeros(HW + (3,), np.uint8)
            rgb[..., 0] = counts % 256
            rgb[..., 1] = counts // 256
            write_png(pjoin(base, "train", seq, "depth", name + ".png"), rgb, filters=(2,))
            small = labels[::HW[0] // HO3D_SEG_HW[0], ::HW[1] // HO3D_SEG_HW[1]]
            seg = np.zeros(HO3D_SEG_HW + (3,), np.uint8)
            seg[..., 2][small == 1] = 255     # blue: the hand
            seg[..., 1][small == 2] = 255     # green: the object
            write_png(pjoin(base, "train", seq, "seg", name + ".png"), seg, filters=(2,))
            # HO3D's frame turns the camera's by pi about x: the rotation
            # vector's angle lies near pi, where only a full conversion is exact
            rotvec = Rotation.from_matrix(FLIP @ fr["obj_rotation"]).as_rotvec()
            anno = {"camMat": cam_mat, "objName": obj_name,
                    "objRot": rotvec.reshape(3, 1),
                    "objTrans": FLIP @ fr["obj_translation"],
                    "handJoints3D": (fr["hand_kp"].astype(np.float64) @ FLIP)[inv_reorder],
                    "handPose": fr["mano_pose"].astype(np.float64),
                    "handTrans": fr["mano_trans"].astype(np.float64),
                    "handBeta": fr["mano_beta"].astype(np.float64)}
            with open(pjoin(base, "train", seq, "meta", name + ".pkl"), "wb") as f:
                pickle.dump(anno, f)
            if latent is not None:
                code = pjoin(base, "SDF/2000/Codes/pred", f"{seq}_{name}.pth")
                os.makedirs(os.path.dirname(code), exist_ok=True)
                torch.save(latent.detach().cpu().reshape(1, -1), code)
        if seq[-2].isnumeric():
            calib = pjoin(base, "calibration", seq[:-1], "calibration")
            os.makedirs(calib, exist_ok=True)
            with open(pjoin(calib, f"cam_{seq[-1]}_intrinsics.txt"), "w") as f:
                f.write(f"fx:{k['fx']}, fy:{k['fy']}, ppx:{k['cx']}, ppy:{k['cy']}\n")
        split[seq] = {0: list(range(num_frames))}
    os.makedirs(pjoin(base, "splits"), exist_ok=True)
    np.save(pjoin(base, "splits", "finalv2_test_bottle.npy"), split)
    return {"basepath": base, "normalization": normalization, "object": obj_surface,
            "frames": scenes}


# --------------------------------------------------------------------------
# DexYCB

def write_dexycb_tree(root: str, num_frames: int) -> dict:
    """Write <root>/DexYCB with one sequence of num_frames frames (the
    synthetic box as the grasped object) and the object's normalisation
    under <root>/YCB. Returns {'basepath', 'sequence', 'frames'}."""
    from .dexycb import YCB_CLASSES
    mano = synthetic_mano_model()
    base = pjoin(root, "DexYCB")
    seq_dir = pjoin(base, DEXYCB_SUBJECT, DEXYCB_SCENE, DEXYCB_SERIAL)
    os.makedirs(seq_dir, exist_ok=True)
    box = box_surface(np.random.RandomState(0))
    comps = mano.hands_components.double().cpu().numpy()
    mean = mano.hands_mean.double().cpu().numpy()
    frames = scene(mano, num_frames, 0)
    for fid, fr in enumerate(frames):
        obj = box @ fr["obj_rotation"].T + fr["obj_translation"]
        depth, labels = render([(fr["hand_cloud"], 255), (obj, DEXYCB_OBJECT_ID)])
        write_png(pjoin(seq_dir, "aligned_depth_to_color_%06d.png" % fid),
                  np.rint(depth * 1000.0).astype(np.uint16), filters=(2,))
        pose_y = np.zeros((2, 3, 4), np.float32)
        pose_y[1, :, :3] = fr["obj_rotation"]
        pose_y[1, :, 3] = fr["obj_translation"]
        pose_m = np.zeros((1, 51), np.float32)
        pose_m[0, :3] = fr["mano_pose"][:3]
        pose_m[0, 3:48] = np.linalg.solve(comps.T, fr["mano_pose"][3:] - mean)
        pose_m[0, 48:51] = fr["mano_trans"]
        np.savez(pjoin(seq_dir, "labels_%06d.npz" % fid), seg=labels, pose_y=pose_y,
                 pose_m=pose_m)
    with open(pjoin(base, DEXYCB_SUBJECT, DEXYCB_SCENE, "meta.yml"), "w") as f:
        yaml.safe_dump({"ycb_ids": [3, DEXYCB_OBJECT_ID], "ycb_grasp_ind": 1,
                        "mano_calib": ["subject-01"]}, f)
    k = INTRINSICS
    os.makedirs(pjoin(base, "calibration", "intrinsics"), exist_ok=True)
    with open(pjoin(base, "calibration", "intrinsics", f"{DEXYCB_SERIAL}_640x480.yml"),
              "w") as f:
        yaml.safe_dump({"color": {"fx": k["fx"], "fy": k["fy"], "ppx": k["cx"],
                                  "ppy": k["cy"]}}, f)
    os.makedirs(pjoin(base, "calibration", "mano_subject-01"), exist_ok=True)
    with open(pjoin(base, "calibration", "mano_subject-01", "mano.yml"), "w") as f:
        yaml.safe_dump({"betas": frames[0]["mano_beta"].astype(float).tolist()}, f)
    seq = f"{DEXYCB_SUBJECT}+{DEXYCB_SCENE}+{DEXYCB_SERIAL}"
    os.makedirs(pjoin(base, "splits"), exist_ok=True)
    np.save(pjoin(base, "splits", "test_bottle.npy"),
            {seq: ["%06d.jpg" % i for i in range(num_frames)]})
    norm_dir = pjoin(root, "YCB/SDF/NormalizationParameters", YCB_CLASSES[DEXYCB_OBJECT_ID])
    os.makedirs(norm_dir, exist_ok=True)
    np.savez(pjoin(norm_dir, "textured_simple.npz"), offset=np.zeros(3, np.float32),
             scale=np.array([2.0], np.float32))
    return {"basepath": base, "sequence": seq, "frames": frames}
