#!/usr/bin/env python3
"""Where the time of hotrack_tpu_torch's tracking loop goes, on one CUDA card.

    python3 scripts/profile_torch_track.py [--runs 7] [--out DIR]

Runs chip_smoke.py's operating point: the 100-frame synthetic SimGrasp
sequence of bench.py's hand_tracking stage, handtracknet_test_SimGrasp.yml at
full width, batch 1, seeded random weights with the delta head's output
layer scaled by --head_scale (chip_smoke.py's HEAD_SCALE). Prints:

  - prepare_batch ms per sequence (clouds already read from disk) and
    tracking ms/frame, each over --runs runs timed with cuda.synchronize
    (median and quartiles, after one warm-up);
  - one sequence under torch.profiler: device events per frame, device busy
    time (the sum of the device events' durations), and the idle share = 1 - busy / (median unprofiled tracking wall
    time); the top entries by device time (the whole table goes to
    --out/profile_torch_track.txt);
  - drift: the largest per-frame keypoint change when the input clouds are
    scaled by (1 + 1e-7), and the MPJPE, at head scale 1 and --head_scale.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hotrack_tpu_torch.data import get_dataloader, prepare_batch  # noqa: E402
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset  # noqa: E402
from hotrack_tpu_torch.mano.model import get_mano_model  # noqa: E402
from hotrack_tpu_torch.track.hand import track_hand_sequence  # noqa: E402
from hotrack_tpu_torch.train.cli import load_config  # noqa: E402
from hotrack_tpu_torch.train.run_hand_track import build_handnet  # noqa: E402

CONFIG = "handtracknet_test_SimGrasp.yml"


def _timed(fn, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _stats(xs) -> str:
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return f"median {med:.3f} (quartiles {q1:.3f}-{q3:.3f}; runs {[round(x, 3) for x in xs]})"


def _net(cfg, device, scale: float):
    net = build_handnet(cfg, device)
    with torch.no_grad():
        net.final_mlp[2].weight.mul_(scale)
        net.final_mlp[2].bias.mul_(scale)
    return net


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--head_scale", type=float, default=0.01)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_track: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")

    with tempfile.TemporaryDirectory(prefix="hotrack_profile_") as root:
        os.environ["HOTRACK_DATA_ROOT"] = root
        generate_simgrasp_dataset(root, num_instances=2, num_frames=100,
                                  points_per_part=900)
        cfg = load_config(["--config", CONFIG])
        raw, _ = get_dataloader(cfg, "test")[0]
        mano = get_mano_model(cfg.get("mano_root")).to(device)
    hj = cfg["hand_jitter_cfg"]

    def prep():
        return prepare_batch(mano, raw, cfg["num_points"],
                             generator=torch.Generator().manual_seed(0),
                             hand_jitter_scale=hj["rand_scale"],
                             jitter_kind=hj["rand_type"], device=device)

    batch = prep()
    n_frames = batch["hand_points"].shape[0]
    prep_ms = [1000.0 * _timed(prep, device) for _ in range(args.runs)]
    print(f"prepare_batch ms/sequence: {_stats(prep_ms)} | {card}", flush=True)

    net = _net(cfg, device, args.head_scale)

    def track():
        return track_hand_sequence(net, mano, batch)

    track()  # warm-up
    track_ms = [1000.0 * _timed(track, device) / n_frames for _ in range(args.runs)]
    print(f"tracking ms/frame: {_stats(track_ms)} | {card}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _timed(track, device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    # the device events themselves (kernels, copies, sets): the operator rows
    # of key_averages() count their kernels' time a second time
    busy_ms = sum(e.device_time_total for e in events) / 1000.0
    wall_ms = float(np.median(track_ms)) * n_frames
    print(f"profiled: wall {1000.0 * wall:.3f} ms, device events {len(events)} "
          f"({len(events) / n_frames:.1f}/frame), device busy {busy_ms:.3f} ms "
          f"({busy_ms / n_frames:.4f} ms/frame); idle share {1 - busy_ms / wall_ms:.4f} "
          f"of the unprofiled loop ({1 - busy_ms / (1000.0 * wall):.4f} under the "
          f"profiler) | {card}", flush=True)
    print("\n".join(table.splitlines()[:20]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_track.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")

    gt = batch["gt_hand_kp"]
    nudged = dict(batch, hand_points=batch["hand_points"] * (1 + 1e-7))
    for scale in (1.0, args.head_scale):
        net = _net(cfg, device, scale)
        a = track_hand_sequence(net, mano, batch).pred_kp
        b = track_hand_sequence(net, mano, nudged).pred_kp
        d = (a - b).abs().reshape(n_frames, -1).amax(1).cpu()
        mpjpe = float((a - gt).norm(dim=-1).mean())
        print(f"drift at head scale {scale}: MPJPE {mpjpe:.6f} m; keypoint change "
              f"from a 1e-7 relative input change: frame 0 {float(d[0]):.3e} m, "
              f"frame {n_frames - 1} {float(d[-1]):.3e} m, max {float(d.max()):.3e} m",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
