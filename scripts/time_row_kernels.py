#!/usr/bin/env python3
"""Check and time the FPS kernel (#1), the scatter-add (#2b) and the host
cost of `index_points`, on one CUDA card, for one checkout of the port.

    python3 scripts/time_row_kernels.py [--repo DIR] [--out FILE]

Runs this checkout's chip_smoke.py phases for them on the hotrack_tpu_torch
of `--repo` (default: this checkout), so that two versions are held and
timed alike on one card within one call: run parent, change, change,
parent. Each checkout builds its own kernels (`<repo>/build/kernels`). The
phases raise on any failed check:

  - `phase_kernels_fps`: index-exact against the plain version at every
    shape the paths launch, the N = 1024 / 1025 boundary, tie-heavy grids
    and point 0 invalid; times in turns with the plain version at batch 1,
    32 and 100, with the design-independent latency bound;
  - `phase_kernels_scatter`: within the float64 bound, bitwise equal on a
    second launch and bitwise the plain version in float32 (and bf16) on the
    CPU, unselected rows exactly 0, out-of-range indices and a misaligned
    view; times at the train step's shapes against `index_add_`;
  - `phase_index_points_host`: host microseconds a call of `index_points`
    at the tracking path's shapes under inference mode, the kernel against
    one torch.gather, in turns.

Prints the phases' lines, then one JSON line of their numbers with the
checkout, the compiler's resource reports and the card's name and power
limit (appended to --out too).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    smoke = _chip_smoke()
    card = smoke.phase_device()  # raises without a card
    from hotrack_tpu_torch.ops import kernels
    if not kernels.__file__.startswith(repo + os.sep):
        raise SystemExit(f"time_row_kernels: imported {kernels.__file__}, not {repo}'s")
    t0 = time.perf_counter()
    ptxas = {}
    for name in ("fps", "gather_rows"):
        with open(str(kernels.build(name)) + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f.read().splitlines()
                           if "registers" in ln or "spill" in ln or "error" in ln.lower()]
    line = {"repo": repo, "build_s": time.perf_counter() - t0, "ptxas": ptxas,
            "fps": smoke.phase_kernels_fps(), "scatter_rows_add": smoke.phase_kernels_scatter(),
            "index_points_host": smoke.phase_index_points_host(), "card": card}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
