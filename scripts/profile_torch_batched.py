#!/usr/bin/env python3
"""Several sequences through one loop against one at a time, on one CUDA
card: what a leading sequence axis S buys the hand and the object trackers.

    python3 scripts/profile_torch_batched.py [--frames 10] [--seqs 1 2 4] [--out DIR]

Runs chip_smoke.py's operating points on a generated set of max(--seqs)
sequences: the hand pipeline (handopt_test_SimGrasp_synth.yml at 512 points,
seeded random HandTrackNet with its delta head scaled by 0.01 and IKNet,
shape mode 1, 5 iterations x 5120 particles x 778 vertices a frame, the
skin route, seeded 480 x 640 masks) and the object tracker (2048 particles x
1024 points x 10 iterations, the fused route). Each sequence's SDF is the
same distilled fit of the box volume (BATCH_FIT_STEPS Adam steps: the fit's
quality does not enter the time); the batched kernels still read one packed
model a sequence. For each S, in turns (S ascending, then descending): S = 1
is the unbatched tracker (kernels #7, #4), S > 1 the batched one (#7b, #4b).
Prints, per tracker and S:

  - ms a chunk-frame (S frames, one of each sequence; the hand's frame-0
    shape optimiser included), median over the turns, and the aggregate
    frames/s (S x 1000 / ms);
  - peak device memory of a run (`max_memory_allocated`);
  - one run under torch.profiler: device events and device busy time per
    chunk-frame (the sum of the device events' durations), and the idle
    share = 1 - busy / (the median unprofiled wall time); the profiler's
    tables go to --out/profile_torch_batched.txt.
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

from profile_torch_obj import _stats, _timed  # noqa: E402

from hotrack_tpu_torch.data import get_dataloader, prepare_batch  # noqa: E402
from hotrack_tpu_torch.data.simgrasp import split_dataset  # noqa: E402
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset  # noqa: E402
from hotrack_tpu_torch.mano.model import get_mano_model  # noqa: E402
from hotrack_tpu_torch.opt import load_contact_zones, presample_particles  # noqa: E402
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup  # noqa: E402
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume  # noqa: E402
from hotrack_tpu_torch.track import (  # noqa: E402
    track_hand_sequence,
    track_hand_sequences_batched,
    track_obj_sequence,
    track_obj_sequences_batched,
)
from hotrack_tpu_torch.train import run_hand_track, run_obj_track  # noqa: E402
from hotrack_tpu_torch.train.cli import load_config  # noqa: E402

HAND_CONFIG, OBJ_CONFIG = "handopt_test_SimGrasp_synth.yml", "objopt_test_SimGrasp_synth.yml"
HAND_POINTS, OBJ_POINTS = 512, 1024
HEAD_SCALE = 0.01   # the random delta head, scaled as chip_smoke.py scales it
HW = (480, 640)
BATCH_FIT_STEPS = 500


def _generate(root: str, sequences: int, frames: int, points_per_part: int) -> None:
    """A set whose test split holds `sequences` sequences of `frames` frames."""
    base = generate_simgrasp_dataset(root, num_instances=sequences + 1, num_frames=frames,
                                     points_per_part=points_per_part)
    split_dataset(os.path.join(base, "splits", "bottle_sim", "seq"),
                  os.path.join(base, "preproc", "bottle_sim", "seq"),
                  [f"{i:05d}" for i in range(sequences)])


def _device_busy(fn, device):
    """One run of fn under torch.profiler: (device events, busy ms, the
    profiler's table)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _timed(fn, device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1000.0
    return len(events), busy, prof.key_averages().table(sort_by="self_cuda_time_total",
                                                        row_limit=25)


def _in_turns(name: str, runs: dict, frames: int, seqs, device, card, tables: list) -> None:
    """runs: S -> a function tracking S sequences of `frames` frames."""
    for s in seqs:
        runs[s]()  # warm-up
    times, peaks = {s: [] for s in seqs}, {}
    for order in (list(seqs), list(seqs)[::-1]):
        for s in order:
            torch.cuda.reset_peak_memory_stats(device)
            times[s].append(1000.0 * _timed(runs[s], device) / frames)
            peaks[s] = torch.cuda.max_memory_allocated(device)
    for s in seqs:
        ms = float(np.median(times[s]))
        n_events, busy, table = _device_busy(runs[s], device)
        tables.append(f"{name}, S={s}\n{table}")
        print(f"{name}, S={s} ({'unbatched' if s == 1 else 'batched'}): ms a chunk-frame "
              f"{_stats(times[s])}; aggregate {s * 1000.0 / ms:.3f} frames/s; peak memory "
              f"{peaks[s] / 2**20:.1f} MiB; under the profiler {n_events / frames:.1f} device "
              f"events and {busy / frames:.4f} ms device busy a chunk-frame, idle share "
              f"{1 - busy / (ms * frames):.4f} | {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--seqs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_batched: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")
    n_seq, frames, seqs = max(args.seqs), args.frames, sorted(args.seqs)
    generator = torch.Generator().manual_seed(0)
    tables = []

    with tempfile.TemporaryDirectory(prefix="hotrack_profile_batched_") as root:
        os.environ["HOTRACK_DATA_ROOT"] = root
        _generate(root, n_seq, frames, 1200)
        extra = ["--data_cfg/num_frames", str(frames)]
        hcfg = load_config(["--config", HAND_CONFIG, "--num_points", str(HAND_POINTS), *extra])
        ocfg = load_config(["--config", OBJ_CONFIG, "--num_points", str(OBJ_POINTS), *extra])
        mano = get_mano_model(hcfg.get("mano_root")).to(device)
        hj = hcfg["hand_jitter_cfg"]
        t0 = time.perf_counter()
        hand_loader, obj_loader = get_dataloader(hcfg, "test"), get_dataloader(ocfg, "test")
        hand_raw = [hand_loader[i][0] for i in range(n_seq)]
        obj_raw = [obj_loader[i][0] for i in range(n_seq)]
        hand = [prepare_batch(mano, raw, HAND_POINTS, generator=generator,
                              hand_jitter_scale=hj["rand_scale"], jitter_kind=hj["rand_type"],
                              device=device) for raw in hand_raw]
        obj = [prepare_batch(mano, raw, OBJ_POINTS, generator=generator, device=device)
               for raw in obj_raw]
    print(f"set-up: {n_seq} sequences of {frames} frames prepared in "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)

    # the hand pipeline
    hvol = synthetic_box_sdf_setup(run_hand_track.HAND_VOLUME_SIZE,
                                   run_hand_track.HAND_VOXEL_SCALE, device=device)
    hfit = distill_sdf_volume(hvol, run_hand_track.HAND_VOXEL_SCALE, generator,
                              steps=BATCH_FIT_STEPS)
    handnet = run_hand_track.build_handnet(hcfg, device)
    with torch.no_grad():
        handnet.final_mlp[2].weight.mul_(HEAD_SCALE)
        handnet.final_mlp[2].bias.mul_(HEAD_SCALE)
    masks = torch.from_numpy(np.random.RandomState(13).rand(n_seq, frames, *HW) > 0.5).to(device)
    common = dict(
        iknet=run_hand_track.build_iknet(hcfg, device), use_opt=True, shape_mode=1,
        shape_particles=presample_particles(run_hand_track.NUM_PARTICLES, 10, generator,
                                            device=device),
        pose_particles=presample_particles(run_hand_track.NUM_PARTICLES, 16, generator,
                                           device=device),
        zones=load_contact_zones(device=device),
        energy_weight={k: float(v) for k, v in hcfg["opt"]["energy_weight"].items()},
        sdf_voxel_scale=run_hand_track.HAND_VOXEL_SCALE)

    def hand_run(s):
        if s == 1:
            return lambda: track_hand_sequence(handnet, mano, hand[0], sdf_volume=hvol,
                                               background_masks=masks[0], distilled=hfit,
                                               **common)
        stacked = run_hand_track._stack_tree(hand[:s])
        return lambda: track_hand_sequences_batched(
            handnet, mano, stacked, sdf_volumes=torch.stack([hvol] * s),
            background_masks=masks[:s], distilled=[hfit] * s, **common)

    _in_turns("hand pipeline, skin route", {s: hand_run(s) for s in seqs}, frames, seqs,
              device, card, tables)

    # the object tracker
    ovol = synthetic_box_sdf_setup(run_obj_track.VOLUME_SIZE, run_obj_track.VOXEL_SCALE,
                                   device=device)
    ofit = distill_sdf_volume(ovol, run_obj_track.VOXEL_SCALE, generator, steps=BATCH_FIT_STEPS)
    bank = presample_particles(run_obj_track.NUM_PARTICLES, 6, generator, device=device)
    points = torch.stack([b["obj_points"] for b in obj])
    init_r = torch.stack([b["gt_obj_pose"]["rotation"][0] for b in obj])
    init_t = torch.stack([b["gt_obj_pose"]["translation"][0] + 0.01 for b in obj])
    scale = dict(voxel_scale=run_obj_track.VOXEL_SCALE, bbox_res=run_obj_track.VOLUME_SIZE)

    def obj_run(s):
        if s == 1:
            return lambda: track_obj_sequence(None, bank, points[0], init_r[0], init_t[0],
                                              distilled=ofit, **scale)
        return lambda: track_obj_sequences_batched(None, bank, points[:s], init_r[:s],
                                                   init_t[:s], distilled=[ofit] * s, **scale)

    _in_turns("object tracker, fused route", {s: obj_run(s) for s in seqs}, frames, seqs,
              device, card, tables)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_batched.txt"), "w") as f:
        f.write(card + "\n" + "\n\n".join(tables) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
