#!/usr/bin/env python3
"""Check and time the distilled-SDF MLP kernel (#3, and its batched form #3b)
on one CUDA card, for one checkout of the port.

    python3 scripts/time_sdf_mlp.py [--repo DIR] [--out FILE] [--unbatched-only] [--atol X]

Runs this checkout's chip_smoke.py phases for the kernel on the
hotrack_tpu_torch of `--repo` (default: this checkout), so that two versions
are held and timed alike on one card within one call: run parent, change,
change, parent. Each checkout builds its own kernels (`<repo>/build/kernels`).
The phases raise on any failed check:

  - `phase_kernels_sdf_mlp`: #3 against its plain version and its 3xTF32
    emulation within TC_SDF_ATOL a value at both clamps, a second launch
    bitwise the first, at the object path's composed-route shape
    (2048, 3, 1024), the hand path's separate-route shape (5120, 778, 3),
    ragged counts about a round, depth 1 to 8 and a narrow net; the timed
    shapes in turns with the plain version, beside the matmul chain's time,
    the 3xTF32 bound and its share, and TFLOP/s;
  - `phase_kernels_sdf_mlp_batched` (unless --unbatched-only): #3b likewise
    at the batched paths' shapes, each sequence bitwise an unbatched launch.

--atol holds a value to another bound than chip_smoke.py's TC_SDF_ATOL, for an
earlier kernel held to its own (the float32 FMA kernel was held to 5e-7).
--digest adds a SHA-256 of the kernel's outputs on seeded inputs at each
path shape (and of #3b's unless --unbatched-only): two checkouts whose
digests agree compute bitwise alike.

Prints the phases' lines, then one JSON line of their numbers with the
checkout, the compiler's resource report and the card's name and power
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

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digests(smoke, batched: bool) -> dict:
    """SHA-256 of the SDF MLP kernel's outputs (float32 bytes) on seeded
    models and points at the paths' shapes."""
    import hashlib

    import numpy as np
    import torch

    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled, pack_distilled_batched
    rng = np.random.RandomState(11)
    cases = [(shape, cf, None) for shape, cf in smoke.SDF_MLP_SHAPES]
    cases += [((smoke.OBJ_PARTICLES, 3, 256), True, None), ((37, 3), False, None)]
    if batched:
        cases += [(shape, cf, shape[0]) for shape, cf in smoke.SDF_MLP_BATCHED_SHAPES]
    out = {}
    for shape, cf, n_seq in cases:
        models = [smoke._random_sdf(rng, smoke.MLP_WIDTHS) for _ in range(n_seq or 1)]
        pts = torch.from_numpy((rng.randn(*shape) * 0.08).astype(np.float32)).cuda()
        if n_seq:
            got = kernels.sdf_mlp_batched_cuda(pts, pack_distilled_batched(models), cf)
        else:
            got = kernels.sdf_mlp_cuda(pts, pack_distilled(models[0]), cf)
        out[str(shape)] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--unbatched-only", action="store_true")
    ap.add_argument("--atol", type=float, default=None)
    ap.add_argument("--digest", action="store_true")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    smoke = _chip_smoke()
    if args.atol is not None:
        smoke.TC_SDF_ATOL = args.atol
    card = smoke.phase_device()  # raises without a card
    from hotrack_tpu_torch.ops import kernels
    if not kernels.__file__.startswith(repo + os.sep):
        raise SystemExit(f"time_sdf_mlp: imported {kernels.__file__}, not {repo}'s")
    t0 = time.perf_counter()
    ptxas = smoke._ptxas_report("sdf_mlp")
    line = {"repo": repo, "build_s": time.perf_counter() - t0, "ptxas": ptxas,
            "atol": smoke.TC_SDF_ATOL, "sdf_mlp": smoke.phase_kernels_sdf_mlp(), "card": card}
    if not args.unbatched_only:
        line["sdf_mlp_batched"] = smoke.phase_kernels_sdf_mlp_batched()
    if args.digest:
        line["digests"] = _digests(smoke, not args.unbatched_only)
        print(f"[digest] {line['digests']}", flush=True)
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
