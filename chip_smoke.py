#!/usr/bin/env python3
"""Smoke test of hotrack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, HandTrackNet sequence tracking through the
`python -m hotrack_tpu_torch.test` entry, at the shipped width (512 points,
384-d features, the 100-frame synthetic SimGrasp sequence of bench.py's
hand_tracking stage) on `cuda`, with seeded random weights. Phases, each of
which raises on failure:

  1. device: require CUDA, print the card's name and power limit, pin fp32
     (no TF32 in matmuls or convolutions);
  2. build: compile every kernel of the path from csrc/ (the FPS kernel);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the path gives it, index-exact, with both times;
  4. main path: launch counters reset, one tracked sequence on the card
     after a warm-up one, counters read; the same entry on the CPU (plain
     FPS) must pick the same frame-0 FPS indices and keypoints within
     PRED_KP_BOUND_M of the card's; neither JAX nor the JAX package
     (hotrack_tpu) may have been imported.

The line before the last is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is missing or any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIG = "handtracknet_test_SimGrasp.yml"
NUM_FRAMES = 100        # bench.py hand_tracking: 2 instances x 100 frames,
POINTS_PER_PART = 900   # 900 points per part; the last instance is the test set
# The delta head's output layer of the random net is scaled by this, so its
# per-frame corrections are millimetres, as a trained tracker's are. At the
# raw init they move the keypoints by decimetres per frame, and the closed
# tracking loop amplifies float32 rounding frame after frame, so that no
# card-vs-CPU bound over 100 frames would mean anything (PERF.md, Findings).
HEAD_SCALE = 0.01
# card vs CPU keypoints, any frame: the two runs differ only by float32
# summation order (cuBLAS vs the CPU's matmuls) and pick the same FPS
# indices; 1e-4 m is 1/100 of the 1 cm keypoint jitter
PRED_KP_BOUND_M = 1e-4

FPS_SOURCE = "hotrack_tpu_torch/csrc/fps.cu"
FPS_REPLACES = "hotrack_tpu/ops/pallas/fps.py:35"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    return card


def phase_build():
    from hotrack_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    lib = kernels.build("fps")
    kernels.fps_cuda(torch.zeros((1, 4, 3), device="cuda"), 2)  # loads and launches
    torch.cuda.synchronize()
    print(f"[build] fps: {time.perf_counter() - t0:.3f} s -> {lib}", flush=True)
    print(open(str(lib) + ".log").read().strip(), flush=True)


def _grid_cloud(rng, b, n):
    base = rng.randint(0, 6, size=(b, n // 4, 3)).astype(np.float32)
    return np.ascontiguousarray(np.repeat(base, 4, axis=1)[:, rng.permutation(n)])


def _time_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels() -> dict:
    """FPS kernel vs plain version on the card. Tolerance: index-exact."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _farthest_point_sample_torch as plain
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")

    def cloud(b, n):
        return torch.from_numpy((rng.randn(b, n, 3) * 0.05).astype(np.float32)).to(dev)

    pipe_mask = torch.from_numpy(rng.rand(100, 2560) < 0.7).to(dev)
    cases = [  # (name, xyz, npoint, mask, timed)
        ("prepare_batch (100,2560,3)->512 masked", cloud(100, 2560), 512, pipe_mask, True),
        ("sa1 (1,512,3)->256", cloud(1, 512), 256, None, True),
        ("sa2 (1,256,3)->128", cloud(1, 256), 128, None, True),
        ("tie-heavy grid (1,512,3)->256",
         torch.from_numpy(_grid_cloud(rng, 1, 512)).to(dev), 256, None, False),
        ("masked, point 0 invalid (4,2560,3)->512", cloud(4, 2560), 512,
         torch.from_numpy(np.concatenate([np.zeros((4, 1), bool),
                                          rng.rand(4, 2559) < 0.5], 1)).to(dev), False),
    ]
    max_err, times = 0, {}
    for name, xyz, npoint, mask, timed in cases:
        got = kernels.fps_cuda(xyz, npoint, mask)
        want = plain(xyz, npoint, mask)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"[kernels] fps {name}: {int((got != want).sum())} "
                                 f"indices differ from the plain version")
        line = f"[kernels] fps {name}: index-exact"
        if timed:
            # in turns on one card: plain, kernel, kernel, plain
            p1 = _time_ms(lambda: plain(xyz, npoint, mask), 3)
            k1 = _time_ms(lambda: kernels.fps_cuda(xyz, npoint, mask), 50)
            k2 = _time_ms(lambda: kernels.fps_cuda(xyz, npoint, mask), 50)
            p2 = _time_ms(lambda: plain(xyz, npoint, mask), 3)
            times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            line += f"; kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms"
        print(line, flush=True)
    pipeline_ms, pipeline_plain_ms = times[cases[0][0]]
    return {"max_abs_err": max_err, "ms": pipeline_ms, "plain_ms": pipeline_plain_ms}


def _write_checkpoint(cfg) -> str:
    from hotrack_tpu_torch.train.run_hand_track import build_handnet
    from hotrack_tpu_torch.utils.convert import save_reference_checkpoint
    net = build_handnet(cfg, "cpu")
    with torch.no_grad():
        net.final_mlp[2].weight.mul_(HEAD_SCALE)
        net.final_mlp[2].bias.mul_(HEAD_SCALE)
    return save_reference_checkpoint(
        net, os.path.join(cfg["experiment_dir"], "ckpt", "model_0001.pt"))


def phase_main_path(card: str) -> int:
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config, test_main

    root = tempfile.mkdtemp(prefix="hotrack_smoke_")
    os.environ["HOTRACK_DATA_ROOT"] = root
    try:
        t0 = time.perf_counter()
        generate_simgrasp_dataset(root, num_instances=2, num_frames=NUM_FRAMES,
                                  points_per_part=POINTS_PER_PART)
        argv = ["--config", CONFIG, "--device", "cuda"]
        ckpt = _write_checkpoint(load_config(argv))
        print(f"[main] data + checkpoint {time.perf_counter() - t0:.1f} s: {ckpt}",
              flush=True)

        test_main(argv)  # warm-up sequence
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        avg, stats = test_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()

        seq = stats["sequences"][0]
        pred = seq["pred_kp"]
        if pred.shape != (NUM_FRAMES, 21, 3) or not np.isfinite(pred).all():
            raise AssertionError(f"[main] pred_kp shape {pred.shape}, finite "
                                 f"{bool(np.isfinite(pred).all())}")
        if not all(math.isfinite(v) for v in avg.values()):
            raise AssertionError(f"[main] non-finite metrics {avg}")
        want = 2 + 2 * NUM_FRAMES  # hand + object clouds, then sa1 + sa2 per frame
        if launches["fps"] < want:
            raise AssertionError(f"[main] fps kernel launched {launches['fps']} "
                                 f"times, expected >= {want}")
        ms_frame = 1000.0 * stats["net_seconds"] / stats["n_frames"]
        prep_ms = 1000.0 * stats["data_seconds"]
        print(f"[main] cuda: {stats['n_frames']} frames, tracking {ms_frame:.3f} "
              f"ms/frame (data preparation excluded: {prep_ms:.1f} ms for the "
              f"sequence), peak memory {peak / 2**20:.1f} MiB, fps launches "
              f"{launches['fps']}, metrics {avg} | {card}", flush=True)

        cpu_avg, cpu_stats = test_main(["--config", CONFIG, "--device", "cpu"])
        cpu_seq = cpu_stats["sequences"][0]
        for key in ("hand_idx0", "obj_idx0"):
            if not np.array_equal(cpu_seq[key], seq[key]):
                raise AssertionError(f"[main] frame-0 FPS indices ({key}) differ "
                                     f"between cuda and cpu")
        diff = np.abs(cpu_seq["pred_kp"] - pred).reshape(NUM_FRAMES, -1).max(1)
        print(f"[main] cpu vs cuda: frame-0 FPS indices identical; max |pred_kp| "
              f"diff {diff.max():.3e} m (frame 0 {diff[0]:.3e}, frame "
              f"{NUM_FRAMES - 1} {diff[-1]:.3e}; bound {PRED_KP_BOUND_M} m); "
              f"cpu MPJPE {cpu_avg['hand_pred_kp_diff']:.6f} vs cuda "
              f"{avg['hand_pred_kp_diff']:.6f} m", flush=True)
        if not diff.max() <= PRED_KP_BOUND_M:
            raise AssertionError(f"[main] cuda vs cpu pred_kp differ by "
                                 f"{diff.max():.3e} m > {PRED_KP_BOUND_M} m")
        return launches["fps"]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_no_jax() -> None:
    bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu")
                 or m.startswith(("jax.", "jaxlib", "flax", "hotrack_tpu.")))
    if bad:
        raise AssertionError(f"the port imported JAX or the JAX package: {bad}")


def main() -> int:
    card = phase_device()
    phase_build()
    fps_numbers = phase_kernels()
    fps_launches = phase_main_path(card)
    check_no_jax()
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fps", "route": "cuda", "source": FPS_SOURCE,
        "replaces": FPS_REPLACES, "launches": fps_launches, **fps_numbers}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
