#!/usr/bin/env python3
"""Where the time of hotrack_tpu_torch's train step goes, on one CUDA card.

    python3 scripts/profile_torch_train.py [--runs 7] [--out DIR]

Runs chip_smoke.py's training operating point: handtracknet_train_SimGrasp.yml
at full width (512 points, batch 32, 384-d features), seeded random weights, a
generated SimGrasp set. Prints:

  - prepare_batch ms per batch and train-step ms (forward, loss, backward,
    Adam) over --runs unprofiled steps timed with cuda.synchronize (median
    and quartiles, after two warm-up steps), samples/s, peak memory, and the
    same steps split into forward / backward / optimizer;
  - the step with index_points on the hand-written kernels against the step
    with index_points on torch.gather (whose backward PyTorch runs with
    atomics), one step each in turns within this one process;
  - three steps under torch.profiler: device events per step, device busy
    time (the sum of the device events' durations), the idle share = 1 -
    busy / (median unprofiled step), the three hand-written kernels' launches
    per step and shares of device time, and the top entries by device time
    (the whole table goes to --out/profile_torch_train.txt).
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

from hotrack_tpu_torch.data import get_dataloader, pipeline  # noqa: E402
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset  # noqa: E402
from hotrack_tpu_torch.nn import pointnet2  # noqa: E402
from hotrack_tpu_torch.ops import kernels, pointops  # noqa: E402
from hotrack_tpu_torch.train.cli import load_config, prepare  # noqa: E402
from hotrack_tpu_torch.train.trainer import Trainer, summarize_losses  # noqa: E402

CONFIG = "handtracknet_train_SimGrasp.yml"
KERNEL_NAMES = {"fps": "fps_kernel", "gather_rows": "gather_rows_kernel",
                "scatter_rows_add": "scatter_rows_add_kernel"}


def _timed(fn, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _stats(xs) -> str:
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return f"median {med:.3f} (quartiles {q1:.3f}-{q3:.3f}; runs {[round(x, 3) for x in xs]})"


def _index_points_library(points, idx):
    """index_points as one torch.gather: the yardstick, used nowhere in the port."""
    b, _, c = points.shape
    flat = idx.reshape(b, -1).long()
    return torch.gather(points, 1, flat[..., None].expand(-1, -1, c)).reshape(*idx.shape, c)


def _set_index_points(fn) -> None:
    pointnet2.index_points = fn
    pipeline.index_points = fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda")

    with tempfile.TemporaryDirectory(prefix="hotrack_profile_") as root:
        os.environ["HOTRACK_DATA_ROOT"] = root
        generate_simgrasp_dataset(root, num_instances=3, num_frames=70,
                                  points_per_part=900)
        cfg = load_config(["--config", CONFIG], "train")
        loader = get_dataloader(cfg, "train")
        raws = [raw for raw, _ in loader if raw.hand_points.shape[0] == cfg["batch_size"]]
        trainer = Trainer(cfg, device)  # pins fp32
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)  # dropout

    def prep(i=0):
        return prepare(trainer, raws[i % len(raws)], gen, cfg)

    batches = [prep(i) for i in range(len(raws))]
    b = batches[0]["hand_points"].shape[0]
    print(f"{len(batches)} batches of {b} x {batches[0]['hand_points'].shape[1]} points, "
          f"backbone_out_dim {cfg['network']['backbone_out_dim']}", flush=True)
    prep_ms = [1000.0 * _timed(prep, device) for _ in range(args.runs)]
    print(f"prepare_batch ms/batch: {_stats(prep_ms)} | {card}", flush=True)

    step_i = [0]

    def step():
        step_i[0] += 1
        return trainer.update(batches[step_i[0] % len(batches)])

    def steps_ms(n):
        return [1000.0 * _timed(step, device) for _ in range(n)]

    steps_ms(2)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ms = steps_ms(args.runs)
    per_step = {k: v / args.runs for k, v in kernels.launch_counts.items()}
    med = float(np.median(ms))
    print(f"train step ms: {_stats(ms)}; {1e3 * b / med:.1f} samples/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; kernel launches per "
          f"step {per_step} | {card}", flush=True)

    fwd, bwd, opt = [], [], []
    for i in range(args.runs):
        trainer.model.train()
        out = {}

        def forward():
            out["total"], _ = summarize_losses(
                trainer._losses(batches[i % len(batches)]), trainer.loss_weights)

        fwd.append(1000.0 * _timed(forward, device))
        trainer.optimizer.zero_grad(set_to_none=True)
        bwd.append(1000.0 * _timed(out["total"].backward, device))
        opt.append(1000.0 * _timed(trainer.optimizer.step, device))
    print(f"forward + loss ms: {_stats(fwd)}\nbackward ms: {_stats(bwd)}\n"
          f"optimizer ms: {_stats(opt)} | {card}", flush=True)

    # in turns, one step each: library, kernels, kernels, library, ... so that
    # a slow spell of the shared host falls on both alike
    ab = {"library": [], "kernels": []}
    for r in range(2 * args.runs):
        for name in (("library", "kernels") if r % 2 == 0 else ("kernels", "library")):
            _set_index_points(_index_points_library if name == "library"
                              else pointops.index_points)
            ab[name] += steps_ms(1)
    _set_index_points(pointops.index_points)
    print(f"train step ms with index_points on the kernels: {_stats(ab['kernels'])}\n"
          f"train step ms with index_points on torch.gather: {_stats(ab['library'])} "
          f"| {card}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: steps_ms(n_prof), device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50)
    busy_ms = sum(e.device_time_total for e in events) / 1000.0 / n_prof
    print(f"profiled {n_prof} steps: wall {1000.0 * wall / n_prof:.3f} ms/step, device "
          f"events {len(events) / n_prof:.1f}/step, device busy {busy_ms:.3f} ms/step; "
          f"idle share {1 - busy_ms / med:.4f} of the unprofiled step "
          f"({1 - busy_ms / (1000.0 * wall / n_prof):.4f} under the profiler) | {card}",
          flush=True)
    for name, needle in KERNEL_NAMES.items():
        mine = [e for e in events if needle in e.name]
        t = sum(e.device_time_total for e in mine) / 1000.0 / n_prof
        print(f"  {name}: {len(mine) / n_prof:.1f} launches/step, {t:.4f} ms/step, "
              f"{100 * t / busy_ms:.2f}% of device time", flush=True)
    print("\n".join(table.splitlines()[:24]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_train.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
