#!/usr/bin/env python3
"""Where the time of hotrack_tpu_torch's full hand pipeline goes, on one CUDA
card.

    python3 scripts/profile_torch_hand.py [--runs 5] [--frames 40] [--out DIR]

Runs chip_smoke.py's hand operating point: a synthetic SimGrasp sequence,
handopt_test_SimGrasp_synth.yml at 512 points, seeded random HandTrackNet
(delta head scaled by 0.01) and IKNet, the 151^3 box volume at 3 mm distilled
with the full budget into the 21-128-128-128-1 MLP, seeded 480 x 640 masks;
per frame HandTrackNet -> IKNet -> 5 iterations x 5120 particles x 778
vertices of the pose optimiser; the shape optimiser (20 iterations x 5120
particles) on frame 0. Prints:

  - set-up: prepare_batch and the volume, the distillation, in seconds; the
    frame-0 shape optimiser alone, in ms;
  - tracking ms/frame of the default `skin` route over --runs unprofiled runs
    timed with cuda.synchronize (median and quartiles, after one warm-up),
    with the card's SM clock and power draw sampled while they run, and the
    kernels' launches per frame;
  - the `fused`, `separate` and volume routes on --short_frames frames, in
    turns with the skin route;
  - the host alone: the skin loop with the fused kernel replaced by a
    stand-in that does no work on the card, so that the wall time is what
    the host needs to enqueue a frame;
  - one skin run under torch.profiler: device events per frame, device busy
    time (the sum of the device events' durations), idle share = 1 - busy /
    (median unprofiled wall time), the fused kernel's mean duration inside
    the loop and its share of device busy time, and the top entries by device
    time (the whole table goes to --out/profile_torch_hand.txt).
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

from profile_torch_obj import ClockSampler, _stats, _timed  # noqa: E402

from hotrack_tpu_torch.data import get_dataloader, prepare_batch  # noqa: E402
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset  # noqa: E402
from hotrack_tpu_torch.mano.model import get_mano_model  # noqa: E402
from hotrack_tpu_torch.ops import kernels  # noqa: E402
from hotrack_tpu_torch.opt import (  # noqa: E402
    hand_pose,
    kp2length,
    load_contact_zones,
    optimize_hand_shape,
    presample_particles,
)
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup  # noqa: E402
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume  # noqa: E402
from hotrack_tpu_torch.track import track_hand_sequence  # noqa: E402
from hotrack_tpu_torch.train.cli import load_config  # noqa: E402
from hotrack_tpu_torch.train.run_hand_track import (  # noqa: E402
    HAND_VOLUME_SIZE,
    HAND_VOXEL_SCALE,
    NUM_PARTICLES,
    build_handnet,
    build_iknet,
)

CONFIG = "handopt_test_SimGrasp_synth.yml"
NUM_POINTS = 512
POINTS_PER_PART = 900
HEAD_SCALE = 0.01  # the random delta head, scaled as chip_smoke.py scales it
HW = (480, 640)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--short_frames", type=int, default=10)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_hand: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")

    with tempfile.TemporaryDirectory(prefix="hotrack_profile_hand_") as root:
        os.environ["HOTRACK_DATA_ROOT"] = root
        generate_simgrasp_dataset(root, num_instances=2, num_frames=args.frames,
                                  points_per_part=POINTS_PER_PART)
        cfg = load_config(["--config", CONFIG, "--num_points", str(NUM_POINTS)])
        raw, _ = get_dataloader(cfg, "test")[0]
        mano = get_mano_model(cfg.get("mano_root")).to(device)
    handnet, iknet = build_handnet(cfg, device), build_iknet(cfg, device)
    with torch.no_grad():
        handnet.final_mlp[2].weight.mul_(HEAD_SCALE)
        handnet.final_mlp[2].bias.mul_(HEAD_SCALE)
    generator = torch.Generator().manual_seed(0)
    hj = cfg["hand_jitter_cfg"]

    t0 = time.perf_counter()
    batch = prepare_batch(mano, raw, NUM_POINTS, generator=generator,
                          hand_jitter_scale=hj["rand_scale"], jitter_kind=hj["rand_type"],
                          device=device)
    volume = synthetic_box_sdf_setup(HAND_VOLUME_SIZE, HAND_VOXEL_SCALE, device=device)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    model = distill_sdf_volume(volume, HAND_VOXEL_SCALE, generator)
    torch.cuda.synchronize(device)
    prep_s, distill_s = t1 - t0, time.perf_counter() - t1
    n_frames = batch["hand_points"].shape[0]
    masks = torch.from_numpy(np.random.RandomState(13).rand(n_frames, *HW) > 0.5).to(device)
    common = dict(
        iknet=iknet, use_opt=True, shape_mode=1,
        shape_particles=presample_particles(NUM_PARTICLES, 10, generator, device=device),
        pose_particles=presample_particles(NUM_PARTICLES, 16, generator, device=device),
        zones=load_contact_zones(device=device), sdf_volume=volume,
        energy_weight={k: float(v) for k, v in cfg["opt"]["energy_weight"].items()},
        sdf_voxel_scale=HAND_VOXEL_SCALE)
    print(f"set-up: prepare_batch and volume {prep_s:.2f} s (first call, {n_frames} frames), "
          f"distillation {distill_s:.2f} s | {card}", flush=True)

    def track(route="skin", frames=n_frames):
        sub = {k: (v[:frames] if torch.is_tensor(v) else
                   {kk: vv[:frames] for kk, vv in v.items()}) for k, v in batch.items()}
        return track_hand_sequence(
            handnet, mano, sub, background_masks=masks[:frames],
            distilled=None if route == "volume" else model,
            hand_energy="skin" if route == "volume" else route, **common)

    track(frames=2)  # warm-up: builds and loads the kernels
    lengths = kp2length(batch["gt_hand_kp"][:1])
    shape_ms = [1000.0 * _timed(lambda: optimize_hand_shape(
        mano, common["shape_particles"], lengths), device) for _ in range(3)]
    print(f"frame-0 shape optimiser alone (20 iterations x {NUM_PARTICLES}), ms: "
          f"{_stats(shape_ms)} | {card}", flush=True)

    kernels.reset_launch_counts()
    sampler = ClockSampler()
    sampler.start()
    track_ms = [1000.0 * _timed(track, device) / n_frames for _ in range(args.runs)]
    clocks = sampler.stop()
    per_frame = {k: v / (args.runs * n_frames) for k, v in kernels.launch_counts.items() if v}
    print(f"skin route, tracking ms/frame (the frame-0 shape optimiser included): "
          f"{_stats(track_ms)}; kernel launches per frame {per_frame}; {clocks} | {card}",
          flush=True)

    # the four routes on a short sequence, in turns
    short = min(args.short_frames, n_frames)
    turns = {"skin": [], "fused": [], "separate": [], "volume": []}
    for name in turns:
        track(name, 2)
    for r in range(3):
        for name in (list(turns) if r % 2 == 0 else list(turns)[::-1]):
            turns[name].append(1000.0 * _timed(lambda: track(name, short), device) / short)
    for name, xs in turns.items():
        print(f"{name} route, {short} frames, ms/frame: {_stats(xs)} | {card}", flush=True)

    # the host alone: no work on the card for the per-vertex energy
    real = hand_pose.fused_hand_energy_skin

    def stand_in(distilled, mask_bits, frame, pose_map, rt_flat, offset, consts, hw,
                 packed=None):
        n = consts.weights_t.shape[1]
        value = (offset[:, :1] + pose_map[:, :1]).expand(-1, n)
        return value, value

    hand_pose.fused_hand_energy_skin = stand_in
    try:
        track(frames=2)
        host_ms = [1000.0 * _timed(track, device) / n_frames for _ in range(3)]
    finally:
        hand_pose.fused_hand_energy_skin = real
    print(f"host alone (fused kernel replaced by a stand-in), ms/frame: {_stats(host_ms)} "
          f"| {card}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: track(frames=short), device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    # the device events themselves (kernels, copies, sets): the operator rows
    # of key_averages() count their kernels' time a second time
    busy_ms = sum(e.device_time_total for e in events) / 1000.0
    skin = [e.device_time_total / 1000.0 for e in events if "hand_energy_skin" in e.name]
    hand_kernels = {name: sum(e.device_time_total for e in events if name in e.name) / 1000.0
                    for name in ("hand_energy_skin", "fps_kernel", "gather_rows")}
    wall_ms = float(np.median(turns["skin"])) * short  # the same window, unprofiled
    print(f"profiled ({short} frames, the frame-0 shape optimiser included): wall "
          f"{1000.0 * wall:.3f} ms, device events {len(events)} ({len(events) / short:.1f}/frame), "
          f"device busy {busy_ms:.3f} ms ({busy_ms / short:.4f} ms/frame); idle share "
          f"{1 - busy_ms / wall_ms:.4f} of the unprofiled loop "
          f"({1 - busy_ms / (1000.0 * wall):.4f} under the profiler); hand_energy_skin_kernel "
          f"{len(skin)} launches, mean {np.mean(skin):.4f} ms (min {np.min(skin):.4f}, max "
          f"{np.max(skin):.4f}), {sum(skin) / busy_ms:.4f} of device busy time; by kernel, ms "
          f"{ {k: round(v, 3) for k, v in hand_kernels.items()} } | {card}", flush=True)
    print("\n".join(table.splitlines()[:28]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_hand.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
