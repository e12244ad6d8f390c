"""Readings that the limits of a cell's `correct` are set from: for each
seed, one call of the port as the cell runs it and one with the port's own
lower-precision path on (the control), each checked against the plain
reference as a run checks its window.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--out FILE]

Prints, per seed and per number compared, the widest gap over the sample
(what a run holds to the limit) for the port and for the control, and
writes every sampled gap to --out as JSON. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import core  # noqa: E402
from benchmark.reference import plain_float32  # noqa: E402


def readings(workload: str, seed: int, device, here: Path = core.HERE,
             config_override: dict | None = None) -> dict:
    """{'port': {number: gaps}, 'control': {number: gaps}} for one seed."""
    plain_float32()
    cell = core.resolve_cell(core.load_spec(here.parent), workload, here)
    config, traffic = dict(cell["config"]), dict(cell["traffic"])
    if config_override:
        config.update(config_override.get("config", {}))
        traffic.update(config_override.get("traffic", {}))
    system = core.system_module(config, here).System(config, traffic, seed, device)
    system.setup({})
    port = [system.call(0)]
    system.control(True)
    try:
        control = [system.call(0)]
    finally:
        system.control(False)
    system.free_program()
    return {"port": system.check(port), "control": system.check(control)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    dump = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, device)
        dump[str(seed)] = {side: {k: v.tolist() for k, v in nums.items()}
                           for side, nums in r.items()}
        line = "  ".join(
            f"{k}: port {float(r['port'][k].max()):.6g} (median "
            f"{float(r['port'][k].median()):.3g}) control {float(r['control'][k].max()):.6g} "
            f"(median {float(r['control'][k].median()):.3g})" for k in r["port"])
        print(f"seed {seed} ({time.perf_counter() - t0:.1f} s): {line}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dump, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
