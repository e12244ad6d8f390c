"""Hand tracking runner: sequence loop, evaluation and trajectory pickles
(port of hotrack_tpu/train/run_hand_track.py).

`track: hand` runs HandTrackNet alone; `track: hand_IKNet` adds IKNet, the
MANO shape optimiser (`use_pred_hand_shape`: 0 annotated shape, 1 optimised
on frame 0, 2 again every 10 frames, 3 every 10 frames on the history) and,
with `use_optimization: True`, the per-frame pose optimiser against the
object's SDF (a 151^3 volume at 3 mm) and the background silhouette.

Checkpoints are reference-format `.pt` files: HandTrackNet's latest (or
`resume_epoch`'s) under `<experiment_dir>/ckpt`, IKNet's under
`<IKNet_dir>/ckpt`. With none, a warning and a seeded random init, as the
JAX runner does.

Config keys beyond the JAX package's, which chooses by backend and
environment variables:

- `sdf_query`: distilled | volume. Default by device: `distilled` on a CUDA
  device (the volume is distilled per sequence and queried in the
  hand-written kernels), `volume` on the CPU (the nearest-voxel lookup).
- `hand_energy`: skin | fused | separate, default skin. How the distilled
  route computes the per-vertex terms (opt/hand_pose.py): skinning and energy
  in one kernel, `mano_forward` and the fused energy kernel, or the SDF MLP
  and the mask lookup as kernels of their own.

`eval_batch_seqs` > 1 (JAX `_run_batched`) tracks the test sequences in
chunks of at most that many sequences of equal length, each chunk through one
frame loop (`track/hand.track_hand_sequences_batched`), with a volume, masks
(padded to the chunk's largest image by edge replication) and a distilled
model a sequence; on the card the batched kernels. Every sequence is prepared
in the unbatched runner's order, from the same generator draws, so S and 1
track the same inputs.
"""

from __future__ import annotations

import glob
import os
import pickle
import time
from os.path import join as pjoin

import numpy as np
import torch

from ..data import get_dataloader, prepare_batch
from ..mano.model import get_mano_model
from ..models.hand_network import HandTrackNet, IKNet
from ..opt import load_contact_zones, presample_particles
from ..opt.hand_pose import HAND_ENERGY_ROUTES
from ..pose.rotations import mano_quat2axisang, matrix_to_unit_quaternion
from ..sdf.distill import distill_sdf_volume, distilled_to
from ..track.eval import eval_hand_sequence
from ..track.hand import track_hand_sequence, track_hand_sequences_batched
from ..utils.convert import load_reference_checkpoint
from .run_obj_track import _sequence_assets
from .trainer import build_model

HAND_VOLUME_SIZE = 151
HAND_VOXEL_SCALE = 0.003
NUM_PARTICLES = 5120
TRACK_ROUTES = ("hand", "hand_IKNet")


def build_handnet(cfg, device) -> HandTrackNet:
    """HandTrackNet at the config's width, initialised from `cfg['seed']`."""
    net = cfg["network"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.get("seed", 0)))
        model = HandTrackNet(cfg["pointnet"]["camera"],
                             backbone_out_dim=net["backbone_out_dim"],
                             handframe=net.get("handframe", "kp"),
                             use_attention=net.get("use_attention", False),
                             procrustes_solver=net.get("procrustes_solver"))
    return model.to(device).eval()


def build_iknet(cfg, device) -> IKNet:
    """IKNet as the trainer initialises it from `cfg['seed']`."""
    sub = dict(cfg, network=dict(cfg["network"], type="iknet"))
    return build_model(sub).to(device).eval()


def find_checkpoint(cfg, experiment_dir: str | None = None) -> str | None:
    ckpt_dir = pjoin(experiment_dir or cfg["experiment_dir"], "ckpt")
    want = int(cfg.get("resume_epoch") or -1)
    if want > 0:
        path = pjoin(ckpt_dir, f"model_{want:04d}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint {path}")
        return path
    ckpts = sorted(glob.glob(pjoin(ckpt_dir, "model_*.pt")))
    return ckpts[-1] if ckpts else None


def _resume(model, cfg, experiment_dir: str):
    path = find_checkpoint(cfg, experiment_dir)
    if path is None:
        print(f"WARNING: no checkpoint found in {experiment_dir}/ckpt; "
              f"using random init")
    else:
        epoch = load_reference_checkpoint(model, path)
        print(f"resumed from {path} (epoch {epoch})")
    return model


def load_handnet(cfg, device) -> HandTrackNet:
    return _resume(build_handnet(cfg, device), cfg, cfg["experiment_dir"])


def load_iknet(cfg, device) -> IKNet:
    return _resume(build_iknet(cfg, device), cfg,
                   cfg.get("IKNet_dir", cfg["experiment_dir"]))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_background_masks(cfg, metas) -> np.ndarray:
    """The per-frame background silhouette masks of one sequence, (T, H, W)
    bool, True = background pixel, read once per sequence. A dataset that
    ships no masks (the synthetic SimGrasp set) gives the (T, 1, 1) all-False
    stack: no silhouette term. OpenCV is imported only where an image file
    is read."""
    ds = cfg["data_cfg"]["dataset_name"]
    root = cfg["data_cfg"]["basepath"]

    masks = []
    for meta in metas:
        fname = meta["file_name"]
        if ds == "HO3D":
            import cv2
            seq, fid = fname.split("/")
            img = cv2.imread(pjoin(root, f"train/{seq}/seg/{fid}.png"))
            img = cv2.resize(img, (640, 480), interpolation=cv2.INTER_NEAREST)
            masks.append(img.sum(axis=-1) == 0)
        elif ds == "SimGrasp":
            path = pjoin(root, "masks/%s/seq/%s.png" % (meta["category"], fname))
            if os.path.exists(path):
                import cv2
                masks.append(cv2.imread(path).sum(axis=-1) == 0)
            else:
                masks.append(np.zeros((1, 1), bool))
        elif ds == "DexYCB":
            parts = fname.split("+")
            lbl = np.load(pjoin(root, "%s/%s/%s/labels_%s.npz"
                                % (parts[0], parts[1], parts[2], parts[3])))
            masks.append(lbl["seg"] == 0)
        else:
            masks.append(np.zeros((1, 1), bool))
    h = max(m.shape[0] for m in masks)
    w = max(m.shape[1] for m in masks)
    out = np.zeros((len(masks), h, w), bool)
    for i, m in enumerate(masks):
        out[i, :m.shape[0], :m.shape[1]] = m
    return out


def _hand_volume(cfg, meta0, device) -> torch.Tensor:
    """The 151^3 volume at 3 mm the hand optimiser queries: the analytic box
    of the synthetic set, or the sequence's DeepSDF decoder baked over it."""
    return _sequence_assets(cfg, meta0, device, HAND_VOLUME_SIZE, HAND_VOXEL_SCALE)["volume"]


def run_hand_tracking(cfg, save_flag: bool = False, distilled: list | None = None):
    """Track every test sequence on cfg['device']. Returns (mean metrics,
    stats): stats holds fps_all / fps_network (frames per second of wall
    time, with and without the per-sequence set-up) and, per sequence, the
    tracked keypoints and poses, the frame-0 FPS indices of the clouds, the
    metric means and the seconds of set-up, distillation and tracking; with
    the optimisers also the particle banks and the distilled model (on the
    CPU). `distilled`: one DistilledSDF per sequence, used instead of
    distilling (a rerun on another device or route with the same fit)."""
    track = cfg["track"]
    if track not in TRACK_ROUTES:
        raise ValueError(f"run_hand_tracking takes track in {TRACK_ROUTES}, got {track!r}")
    if cfg.get("debug") or cfg.get("debug_save"):
        raise NotImplementedError(
            "debug / debug_save figures wait for utils/vis.py: ROADMAP.md, queue 1, slice 5")
    device = torch.device(cfg.get("device", "cuda"))
    use_iknet = track == "hand_IKNet"
    use_opt = bool(cfg.get("use_optimization", False)) and use_iknet
    shape_mode = int(cfg.get("use_pred_hand_shape", False) or 0) if use_iknet else 0
    sdf_query = cfg.get("sdf_query") or ("distilled" if device.type == "cuda" else "volume")
    if sdf_query not in ("distilled", "volume"):
        raise ValueError(f"sdf_query must be distilled or volume, got {sdf_query!r}")
    hand_energy = cfg.get("hand_energy") or "skin"
    if hand_energy not in HAND_ENERGY_ROUTES:
        raise ValueError(f"hand_energy must be one of {HAND_ENERGY_ROUTES}, "
                         f"got {hand_energy!r}")

    loader = get_dataloader(cfg, "test")
    mano = get_mano_model(cfg.get("mano_root")).to(device)
    # every draw on the host: the same banks, jitter and fit draws on any device
    generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    hj = cfg["hand_jitter_cfg"]
    handnet = load_handnet(cfg, device)
    iknet = load_iknet(cfg, device) if use_iknet else None

    opt_kwargs, banks = {}, {}
    if use_iknet and shape_mode:
        banks["shape_particles"] = presample_particles(NUM_PARTICLES, 10, generator,
                                                       device=device)
    if use_opt:
        banks["pose_particles"] = presample_particles(NUM_PARTICLES, 16, generator,
                                                      device=device)
        zones_path = cfg.get("contact_zones_path")
        opt_kwargs = dict(
            zones=load_contact_zones(zones_path if zones_path and os.path.exists(zones_path)
                                     else None, device=device),
            energy_weight={k: float(v) for k, v in cfg["opt"]["energy_weight"].items()},
            use_pred_obj_pose=bool(cfg.get("use_pred_obj_pose", False)),
            sdf_voxel_scale=HAND_VOXEL_SCALE, hand_energy=hand_energy)

    def prepare(seq_idx):
        """Sequence seq_idx's batch and assets, drawn from the generator in
        sequence order: (batch, metas, volume, model, masks, setup and
        distillation seconds)."""
        t0 = time.perf_counter()
        raw, metas = loader[seq_idx]
        batch = prepare_batch(mano, raw, cfg["num_points"], generator=generator,
                              hand_jitter_scale=hj["rand_scale"],
                              jitter_kind=hj["rand_type"],
                              sample_kind=cfg.get("point_sample", "fps"),
                              device=device)
        volume = model = masks = None
        distill_s = 0.0
        if use_opt:
            volume = _hand_volume(cfg, metas[0], device)
            if sdf_query == "distilled":
                _sync(device)
                td = time.perf_counter()
                if distilled is not None:
                    model = distilled_to(distilled[seq_idx], device)
                else:
                    model = distill_sdf_volume(volume, HAND_VOXEL_SCALE, generator)
                _sync(device)
                distill_s = time.perf_counter() - td
            masks = load_background_masks(cfg, metas)
        _sync(device)
        return batch, metas, volume, model, masks, time.perf_counter() - t0, distill_s

    total, sequences = {}, [None] * len(loader)

    def record(seq_idx, result, batch, metas, model, setup_s, distill_s, net_s):
        metrics = eval_hand_sequence(result, batch["gt_hand_kp"],
                                     batch["gt_hand_pose"]["palm_template"][0])
        means = {k[5:]: float(v) for k, v in metrics.items() if k.startswith("mean/")}
        for k, v in means.items():
            total[k] = total.get(k, 0.0) + v
        sequences[seq_idx] = {"pred_kp": result.pred_kp.cpu().numpy(),
                              "global_translation": result.global_translation.cpu().numpy(),
                              "mano_theta": result.mano_theta.cpu().numpy(),
                              "pred_beta": result.pred_beta.cpu().numpy(),
                              "hand_idx0": batch["hand_idx"][0].cpu().numpy(),
                              "obj_idx0": batch["obj_idx"][0].cpu().numpy(),
                              "distilled": None if model is None else distilled_to(model, "cpu"),
                              "means": means, "setup_seconds": setup_s,
                              "distill_seconds": distill_s, "net_seconds": net_s}
        print(f"seq {seq_idx}: {({k: round(v, 5) for k, v in means.items()})}")
        if save_flag:
            _save_sequence(cfg, metas, result, batch, metrics, use_iknet)

    track_kwargs = dict(iknet=iknet, use_opt=use_opt, shape_mode=shape_mode, **banks,
                        **opt_kwargs)
    batch_seqs = int(cfg.get("eval_batch_seqs", 1))
    n_frames, net_time, data_time = 0, 0.0, 0.0
    t_start = time.perf_counter()
    if batch_seqs <= 1:
        for seq_idx in range(len(loader)):
            batch, metas, volume, model, masks, setup_s, distill_s = prepare(seq_idx)
            if use_opt:
                opt_kwargs_seq = dict(sdf_volume=volume, distilled=model,
                                      background_masks=torch.from_numpy(masks).to(device))
            else:
                opt_kwargs_seq = {}
            t1 = time.perf_counter()
            result = track_hand_sequence(handnet, mano, batch, **track_kwargs, **opt_kwargs_seq)
            _sync(device)
            net_s = time.perf_counter() - t1
            data_time += setup_s
            net_time += net_s
            n_frames += batch["hand_points"].shape[0]
            record(seq_idx, result, batch, metas, model, setup_s, distill_s, net_s)
        fps_all = n_frames / max(net_time + data_time, 1e-9)
    else:
        # every sequence prepared first, in the unbatched runner's order; then
        # chunks of at most batch_seqs sequences of one length, in order
        prepared = [prepare(i) for i in range(len(loader))]
        data_time = sum(p[5] for p in prepared)
        groups = {}
        for seq_idx, p in enumerate(prepared):
            groups.setdefault(p[0]["hand_points"].shape[0], []).append(seq_idx)
        chunks = [idxs[k:k + batch_seqs] for idxs in groups.values()
                  for k in range(0, len(idxs), batch_seqs)]
        for chunk in chunks:
            parts = [prepared[i] for i in chunk]
            stacked = _stack_tree([p[0] for p in parts])
            opt_kwargs_seq = {}
            if use_opt:
                opt_kwargs_seq = dict(
                    sdf_volumes=torch.stack([p[2] for p in parts]),
                    distilled=None if parts[0][3] is None else [p[3] for p in parts],
                    background_masks=torch.from_numpy(_pad_edge([p[4] for p in parts]))
                    .to(device))
            t1 = time.perf_counter()
            results = track_hand_sequences_batched(handnet, mano, stacked, **track_kwargs,
                                                   **opt_kwargs_seq)
            _sync(device)
            net_s = time.perf_counter() - t1
            net_time += net_s
            for k, (seq_idx, part) in enumerate(zip(chunk, parts)):
                batch, metas, _, model, _, setup_s, distill_s = part
                n_frames += batch["hand_points"].shape[0]
                record(seq_idx, type(results)(*(x[k] for x in results)), batch, metas, model,
                       setup_s, distill_s, net_s)
        # the whole wall time, as the JAX runner counts a batched run
        fps_all = n_frames / max(time.perf_counter() - t_start, 1e-9)

    avg = {k: v / max(len(loader), 1) for k, v in total.items()}
    fps_net = n_frames / max(net_time, 1e-9)
    print(f"frames {n_frames}  FPS(all) {fps_all:.1f}  FPS(network) {fps_net:.1f}"
          f"  device {device}" + (f"  batched({batch_seqs})" if batch_seqs > 1 else "")
          + (f"  sdf_query {sdf_query}  hand_energy {hand_energy}" if use_opt else ""))
    print("overall:", {k: round(v, 5) for k, v in avg.items()})
    return avg, {"fps_all": fps_all, "fps_network": fps_net,
                 "n_frames": n_frames, "net_seconds": net_time,
                 "data_seconds": data_time, "sequences": sequences,
                 **{k: v.cpu().numpy() for k, v in banks.items()}}


def _stack_tree(trees: list):
    """Stack equal-shaped nested dicts of tensors along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _pad_edge(masks: list) -> np.ndarray:
    """Per-sequence (T, H_s, W_s) masks padded to the largest H and W by
    edge replication (JAX `_run_batched`): the optimiser clips a pixel to the
    padded image, so a vertex past a smaller mask's border must read the
    border's pixel, as the unbatched clip gives it, not a padded zero."""
    h = max(m.shape[1] for m in masks)
    w = max(m.shape[2] for m in masks)
    return np.stack([np.pad(m, ((0, 0), (0, h - m.shape[1]), (0, w - m.shape[2])), mode="edge")
                     for m in masks])


def _save_sequence(cfg, metas, result, batch, metrics, use_iknet: bool = False):
    """Trajectory pickle, as the JAX runner writes it."""
    t = result.pred_kp.shape[0]
    gt = batch["gt_hand_kp"].cpu().numpy()
    pred = result.pred_kp.cpu().numpy()
    save_dict = {
        "gt_hand_kp": [gt[i] for i in range(t)],
        "pred_hand_kp": [pred[i] for i in range(t)],
        "file_name": [m["file_name"] for m in metas],
        "kp_error": metrics["hand_pred_kp_diff"].cpu().numpy(),
        "r_error": metrics["hand_pred_r_diff"].cpu().numpy(),
        "t_error": metrics["hand_pred_t_diff"].cpu().numpy(),
    }
    if use_iknet:
        global_aa = mano_quat2axisang(matrix_to_unit_quaternion(result.global_rotation))
        save_dict["pred_hand_poses"] = {
            "mano_pose": torch.cat([global_aa, result.mano_theta], dim=-1).cpu().numpy(),
            "mano_trans": result.global_translation[..., 0].cpu().numpy(),
            "mano_beta": result.pred_beta.cpu().numpy(),
        }
        baseline = result.baseline_pred_kp.cpu().numpy()
        save_dict["baseline_pred_kp"] = [baseline[i] for i in range(t)]

    ds = cfg["data_cfg"]["dataset_name"]
    if ds in ("HO3D", "DexYCB", "HOI4D"):
        name = metas[0]["file_name"].replace("/", "_") + ".pkl"
        if ds == "HOI4D":
            name = name.replace("_preprocess", "")
        save_dict["CAD_ID"] = metas[0]["category"]
    else:
        name = metas[0]["category"] + "_" + metas[0]["file_name"][:-4] + ".pkl"
    os.makedirs(cfg["save_dir"], exist_ok=True)
    with open(pjoin(cfg["save_dir"], name), "wb") as f:
        pickle.dump(save_dict, f)
