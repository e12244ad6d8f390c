"""Hand tracking runner: sequence loop + eval (+ trajectory pickles).

Port of hotrack_tpu/train/run_hand_track.py for track='hand' (HandTrackNet
without IKNet or optimisers). Loads the latest reference-format checkpoint
`<experiment_dir>/ckpt/model_*.pt` (or `model_{resume_epoch:04d}.pt`); with
none, warns and runs a seeded random init, as the JAX runner does.
"""

from __future__ import annotations

import glob
import os
import pickle
import time
from os.path import join as pjoin

import torch

from ..data import get_dataloader, prepare_batch
from ..mano.model import get_mano_model
from ..models.hand_network import HandTrackNet
from ..track.eval import eval_hand_sequence
from ..track.hand import track_hand_sequence
from ..utils.convert import load_reference_checkpoint


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


def find_checkpoint(cfg) -> str | None:
    ckpt_dir = pjoin(cfg["experiment_dir"], "ckpt")
    want = int(cfg.get("resume_epoch") or -1)
    if want > 0:
        path = pjoin(ckpt_dir, f"model_{want:04d}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint {path}")
        return path
    ckpts = sorted(glob.glob(pjoin(ckpt_dir, "model_*.pt")))
    return ckpts[-1] if ckpts else None


def load_handnet(cfg, device) -> HandTrackNet:
    model = build_handnet(cfg, device)
    path = find_checkpoint(cfg)
    if path is None:
        print(f"WARNING: no checkpoint found in {cfg['experiment_dir']}/ckpt; "
              f"using random init")
    else:
        epoch = load_reference_checkpoint(model, path)
        print(f"resumed from {path} (epoch {epoch})")
    return model


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_hand_tracking(cfg, save_flag: bool = False):
    """Track every test sequence on cfg['device']. Returns (mean metrics,
    stats): stats holds fps_all / fps_network (frames per second of wall
    time, with and without data preparation) and, per sequence, pred_kp,
    the frame-0 FPS indices of the hand cloud and the metric means."""
    if cfg["track"] != "hand":
        raise NotImplementedError(
            f"track={cfg['track']!r} is not ported yet (ROADMAP.md, queue 1)")
    device = torch.device(cfg.get("device", "cuda"))
    loader = get_dataloader(cfg, "test")
    mano = get_mano_model(cfg.get("mano_root")).to(device)
    # jitter is drawn on the host: the same keypoint noise on every device
    generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    hj = cfg["hand_jitter_cfg"]
    handnet = load_handnet(cfg, device)

    total, sequences = {}, []
    n_frames, net_time, data_time = 0, 0.0, 0.0
    for seq_idx in range(len(loader)):
        t0 = time.perf_counter()
        raw, metas = loader[seq_idx]
        batch = prepare_batch(mano, raw, cfg["num_points"], generator=generator,
                              hand_jitter_scale=hj["rand_scale"],
                              jitter_kind=hj["rand_type"],
                              sample_kind=cfg.get("point_sample", "fps"),
                              device=device)
        _sync(device)
        t1 = time.perf_counter()
        result = track_hand_sequence(handnet, mano, batch)
        _sync(device)
        t2 = time.perf_counter()
        data_time += t1 - t0
        net_time += t2 - t1
        n_frames += batch["hand_points"].shape[0]

        metrics = eval_hand_sequence(result, batch["gt_hand_kp"],
                                     batch["gt_hand_pose"]["palm_template"][0])
        means = {k[5:]: float(v) for k, v in metrics.items() if k.startswith("mean/")}
        for k, v in means.items():
            total[k] = total.get(k, 0.0) + v
        sequences.append({"pred_kp": result.pred_kp.cpu().numpy(),
                          "hand_idx0": batch["hand_idx"][0].cpu().numpy(),
                          "obj_idx0": batch["obj_idx"][0].cpu().numpy(),
                          "means": means, "net_seconds": t2 - t1})
        print(f"seq {seq_idx}: {({k: round(v, 5) for k, v in means.items()})}")
        if save_flag:
            _save_sequence(cfg, metas, result, batch, metrics)

    avg = {k: v / max(len(sequences), 1) for k, v in total.items()}
    fps_all = n_frames / max(net_time + data_time, 1e-9)
    fps_net = n_frames / max(net_time, 1e-9)
    print(f"frames {n_frames}  FPS(all) {fps_all:.1f}  FPS(network) {fps_net:.1f}"
          f"  device {device}")
    print("overall:", {k: round(v, 5) for k, v in avg.items()})
    return avg, {"fps_all": fps_all, "fps_network": fps_net,
                 "n_frames": n_frames, "net_seconds": net_time,
                 "data_seconds": data_time, "sequences": sequences}


def _save_sequence(cfg, metas, result, batch, metrics):
    """Trajectory pickle, as the JAX runner writes it for SimGrasp."""
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
    name = metas[0]["category"] + "_" + metas[0]["file_name"][:-4] + ".pkl"
    os.makedirs(cfg["save_dir"], exist_ok=True)
    with open(pjoin(cfg["save_dir"], name), "wb") as f:
        pickle.dump(save_dict, f)
