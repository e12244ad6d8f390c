#!/usr/bin/env python3
"""Where the time of hotrack_tpu_torch's object tracking loop goes, on one
CUDA card.

    python3 scripts/profile_torch_obj.py [--runs 7] [--frames 100] [--out DIR]

Runs chip_smoke.py's object operating point: a synthetic SimGrasp sequence,
objopt_test_SimGrasp_synth.yml with num_points 1024, the 201^3 box volume at
2 mm distilled with the full budget into the 21-128-128-128-1 MLP, 2048
particles x 10 iterations a frame. Prints:

  - set-up: prepare_batch, the volume and the distillation, in seconds;
  - tracking ms/frame of the fused route over --runs unprofiled runs timed
    with cuda.synchronize (median and quartiles, after one warm-up), with the
    card's SM clock and power draw sampled while they run, and the kernels'
    launches per frame;
  - the composed and the volume route on --short_frames frames, in turns with
    the fused route;
  - the host alone: the same loop with the energy kernel replaced by a
    stand-in that does no work on the card, so that the wall time is what
    the host needs to enqueue a frame;
  - one fused run under torch.profiler: device events per frame, device busy
    time (the sum of the device events' durations), idle share = 1 - busy /
    (median unprofiled wall time), the energy kernel's mean duration inside
    the loop, and the top entries by device time (the whole table goes to
    --out/profile_torch_obj.txt).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hotrack_tpu_torch.data import get_dataloader, prepare_batch  # noqa: E402
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset  # noqa: E402
from hotrack_tpu_torch.mano.model import get_mano_model  # noqa: E402
from hotrack_tpu_torch.ops import kernels  # noqa: E402
from hotrack_tpu_torch.opt import obj_pose, presample_particles  # noqa: E402
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup  # noqa: E402
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume  # noqa: E402
from hotrack_tpu_torch.track.obj import track_obj_sequence  # noqa: E402
from hotrack_tpu_torch.train.cli import load_config  # noqa: E402
from hotrack_tpu_torch.train.run_obj_track import (  # noqa: E402
    NUM_PARTICLES,
    VOLUME_SIZE,
    VOXEL_SCALE,
)

CONFIG = "objopt_test_SimGrasp_synth.yml"
NUM_POINTS = 1024
POINTS_PER_PART = 1200  # >= NUM_POINTS valid object points in every frame


def _timed(fn, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _stats(xs) -> str:
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return f"median {med:.3f} (quartiles {q1:.3f}-{q3:.3f}; runs {[round(x, 3) for x in xs]})"


class ClockSampler:
    """Samples the card's SM clock (MHz) and power draw (W) every 0.2 s in a
    thread, through nvidia-smi, between start() and stop()."""

    def __init__(self):
        self.samples, self._stop, self._thread = [], threading.Event(), None

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True).stdout.strip().splitlines()
            if out:
                self.samples.append(tuple(float(v) for v in out[0].split(",")))
            self._stop.wait(0.2)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> str:
        self._stop.set()
        self._thread.join()
        if not self.samples:
            return "no clock samples"
        clk, pwr = np.array(self.samples).T
        return (f"SM clock {clk.min():.0f}-{clk.max():.0f} MHz (median {np.median(clk):.0f}), "
                f"power draw {pwr.min():.0f}-{pwr.max():.0f} W (median {np.median(pwr):.0f}), "
                f"{len(clk)} samples")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--short_frames", type=int, default=20)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_obj: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")

    with tempfile.TemporaryDirectory(prefix="hotrack_profile_obj_") as root:
        os.environ["HOTRACK_DATA_ROOT"] = root
        generate_simgrasp_dataset(root, num_instances=2, num_frames=args.frames,
                                  points_per_part=POINTS_PER_PART)
        cfg = load_config(["--config", CONFIG, "--num_points", str(NUM_POINTS)])
        raw, _ = get_dataloader(cfg, "test")[0]
        mano = get_mano_model(cfg.get("mano_root")).to(device)
    oj = cfg["obj_jitter_cfg"]
    jitter = {"rotation": float(np.deg2rad(oj["r"])), "translation": oj["t"], "scale": oj["s"]}
    generator = torch.Generator().manual_seed(0)
    particles = presample_particles(NUM_PARTICLES, 6, generator, device=device)

    t0 = time.perf_counter()
    batch = prepare_batch(mano, raw, NUM_POINTS, generator=generator, obj_jitter=jitter,
                          obj_jitter_kind=oj["type"], device=device)
    volume = synthetic_box_sdf_setup(VOLUME_SIZE, VOXEL_SCALE, device=device)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    model = distill_sdf_volume(volume, VOXEL_SCALE, generator)
    torch.cuda.synchronize(device)
    prep_s, distill_s = t1 - t0, time.perf_counter() - t1
    pts = batch["obj_points"]
    n_frames = pts.shape[0]
    init_r = batch["jittered_obj_pose"]["rotation"][0]
    init_t = batch["jittered_obj_pose"]["translation"][0]
    print(f"set-up: prepare_batch and volume {prep_s:.2f} s (first call, {n_frames} frames), "
          f"distillation {distill_s:.2f} s | {card}", flush=True)

    def track(route="fused", frames=n_frames):
        return track_obj_sequence(
            volume, particles, pts[:frames], init_r, init_t, voxel_scale=VOXEL_SCALE,
            bbox_res=VOLUME_SIZE, distilled=None if route == "volume" else model,
            obj_energy="composed" if route == "composed" else "fused")

    track(frames=2)  # warm-up: builds and loads the kernel
    kernels.reset_launch_counts()
    sampler = ClockSampler()
    sampler.start()
    track_ms = [1000.0 * _timed(track, device) / n_frames for _ in range(args.runs)]
    clocks = sampler.stop()
    per_frame = {k: v / (args.runs * n_frames) for k, v in kernels.launch_counts.items() if v}
    print(f"fused route, tracking ms/frame: {_stats(track_ms)}; kernel launches per frame "
          f"{per_frame}; {clocks} | {card}", flush=True)

    # the three routes on a short sequence, in turns
    short = min(args.short_frames, n_frames)
    turns = {"fused": [], "composed": [], "volume": []}
    for name in turns:
        track(name, 2)
    for r in range(3):
        for name in (list(turns) if r % 2 == 0 else list(turns)[::-1]):
            turns[name].append(1000.0 * _timed(lambda: track(name, short), device) / short)
    for name, xs in turns.items():
        print(f"{name} route, {short} frames, ms/frame: {_stats(xs)} | {card}", flush=True)

    # the host alone: no work on the card for the energy
    real = obj_pose.fused_obj_sdf_energy

    def stand_in(distilled, pcld_t, new_r, new_t, packed=None):
        return new_t.abs().sum(-1) + new_r[:, 0, 0]

    obj_pose.fused_obj_sdf_energy = stand_in
    try:
        track(frames=2)
        host_ms = [1000.0 * _timed(track, device) / n_frames for _ in range(3)]
    finally:
        obj_pose.fused_obj_sdf_energy = real
    print(f"host alone (energy kernel replaced by a stand-in), ms/frame: {_stats(host_ms)} "
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
    energy = [e.device_time_total / 1000.0 for e in events if "obj_energy" in e.name]
    wall_ms = float(np.median(track_ms)) * short
    print(f"profiled ({short} frames): wall {1000.0 * wall:.3f} ms, device events "
          f"{len(events)} ({len(events) / short:.1f}/frame), device busy {busy_ms:.3f} ms "
          f"({busy_ms / short:.4f} ms/frame); idle share {1 - busy_ms / wall_ms:.4f} of the "
          f"unprofiled loop ({1 - busy_ms / (1000.0 * wall):.4f} under the profiler); "
          f"obj_energy_kernel {len(energy)} launches, mean {np.mean(energy):.4f} ms "
          f"(min {np.min(energy):.4f}, max {np.max(energy):.4f}), "
          f"{sum(energy) / busy_ms:.4f} of device busy time | {card}", flush=True)
    print("\n".join(table.splitlines()[:24]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_obj.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
