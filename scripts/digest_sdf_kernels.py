#!/usr/bin/env python3
"""Digests of the SDF kernels' outputs on one CUDA card, for one checkout of
the port: whether two checkouts compute bitwise alike.

    python3 scripts/digest_sdf_kernels.py [--repo DIR] [--bf16] [--time] [--ptxas]

Imports the hotrack_tpu_torch of `--repo` (default: this checkout), which
builds its own kernels under `<repo>/build/kernels`, and prints one JSON line:
a SHA-256 (first 16 hex digits) of the float32 bytes of each kernel's output
on seeded models and inputs at the shapes the paths give it: #3 (2048, 3,
1024) and (5120, 778, 3), #3b (4, 2048, 3, 1024), #4 (2048, 1024), #4b (4,
2048, 1024), #6 (5120, 778, 3) on a 480 x 640 mask, #7 (5120, 135, 778) and
#7b (4, 5120, 135, 778) on 480 x 640 masks; and the card's name and power
limit. Run two checkouts in one call (parent, change): equal digests mean the
kernels' outputs did not change. `--bf16` digests the bf16 instantiations
instead (compute_dtype torch.bfloat16; a checkout that has them).

`--time` adds each digested kernel's device time at those shapes, in the
digest's precision (with `--bf16`: the bf16 #3, #3b, #4, #4b, #6, #7, #7b), from
CUDA events around each launch after two warm-up launches: the mean and the
least of 20, in ms, under "ms". Two checkouts are timed alike in turns by
running this script on each within one call: parent, change, change, parent.

`--ptxas` adds, under "ptxas", the compiler's report of each SDF source's
library (csrc/sdf_mlp.cu, obj_energy.cu, hand_energy.cu, hand_energy_skin.cu):
a line a kernel with its registers and spill bytes, so that two checkouts show
whether a change moved a spill.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def _digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def _device_ms(fn, reps: int = 20) -> dict:
    """{"mean", "min"} ms of one launch of fn by CUDA events, after two
    warm-up launches."""
    import torch
    fn(), fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"mean": sum(times) / reps, "min": min(times)}


def _ptxas(lib) -> list:
    """A line a kernel of the library's ptxas report: its mangled name, then
    what the compiler said of its registers, stack and spills."""
    out, name = [], None
    for ln in Path(str(lib) + ".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "bytes spill" in ln or "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


def _model(rng, device):
    """A seeded 21-128-128-128-1 model with He-scaled weights and a small
    output layer (a quarter of the values near the 0.05 clamp)."""
    import torch

    from hotrack_tpu_torch.sdf.distill import DistilledSDF
    dims = [21, 128, 128, 128, 1]
    ws = [rng.randn(dims[i], dims[i + 1]).astype(np.float32) * np.sqrt(2.0 / dims[i])
          for i in range(4)]
    ws[-1] *= 0.05
    bs = [rng.randn(dims[i + 1]).astype(np.float32) * 0.02 for i in range(4)]
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return DistilledSDF(tuple(t(w) for w in ws), tuple(t(b) for b in bs),
                        t(np.pi * 2.0 ** np.arange(3)), t(5.0), t(0.05))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    from hotrack_tpu_torch.mano.layer import mano_skin_inputs, shape_hand
    from hotrack_tpu_torch.mano.model import synthetic_mano_model
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.hand_energy import hand_frame
    from hotrack_tpu_torch.ops.hand_energy_skin import skin_consts
    from hotrack_tpu_torch.ops.mask_lookup import pack_mask
    from hotrack_tpu_torch.ops.obj_energy import obj_rts
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled, pack_distilled_batched
    from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix

    if not torch.cuda.is_available():
        raise SystemExit("digest_sdf_kernels: no CUDA card")
    dev = "cuda"
    extra = {"compute_dtype": torch.bfloat16} if args.bf16 else {}
    rng = np.random.RandomState(0)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    models = [_model(rng, dev) for _ in range(4)]
    one, four = pack_distilled(models[0]), pack_distilled_batched(models)
    out, timed = {}, {}   # name -> digest; name -> a launch on the digested inputs

    def run(name, fn):
        res = fn()
        out[name] = _digest(torch.stack(res) if isinstance(res, tuple) else res)
        timed[name] = fn

    for shape, cf in (((2048, 3, 1024), True), ((5120, 778, 3), False)):
        pts = cuda(rng.randn(*shape) * 0.08)
        run(f"#3 {shape}", lambda pts=pts, cf=cf: kernels.sdf_mlp_cuda(pts, one, cf, **extra))
    pts_b = cuda(rng.randn(4, 2048, 3, 1024) * 0.08)
    run("#3b (4, 2048, 3, 1024)",
        lambda: kernels.sdf_mlp_batched_cuda(pts_b, four, True, **extra))

    def poses(lead):
        rot = unit_quaternion_to_matrix(normalize_quat(cuda(rng.randn(*lead, 4))))
        return obj_rts(rot, cuda(rng.randn(*lead, 3) * 0.03)).contiguous()

    obj_args = (cuda(rng.randn(3, 1024) * 0.06), poses((2048,)), one)
    run("#4 (2048, 1024)", lambda: kernels.obj_sdf_energy_cuda(*obj_args, **extra))
    objb_args = (cuda(rng.randn(4, 3, 1024) * 0.06), poses((4, 2048)), four)
    run("#4b (4, 2048, 1024)", lambda: kernels.obj_sdf_energy_batched_cuda(*objb_args, **extra))

    hw = (480, 640)
    mask = lambda: pack_mask(torch.from_numpy(rng.rand(*hw) > 0.5).to(dev))  # noqa: E731

    def frame():
        rot = unit_quaternion_to_matrix(normalize_quat(cuda(rng.randn(4))))
        return hand_frame(rot, torch.tensor([0.01, -0.02, 0.45], device=dev), 600.0, 590.0,
                          320.0, 240.0)

    verts = rng.randn(5120, 778, 3).astype(np.float32) * 0.08
    verts[..., :2] *= 4.0
    verts[..., 2] = np.abs(verts[..., 2]) + 0.3
    hand_args = (cuda(verts), frame(), mask(), hw, one)
    run("#6 (5120, 778, 3)", lambda: kernels.hand_energy_cuda(*hand_args, **extra))

    mano = synthetic_mano_model().to(dev)

    def skin(p):
        pose, trans = cuda(rng.randn(p, 48) * 0.2), cuda(rng.randn(p, 3) * 0.02 + [0, 0, 0.45])
        shaped = shape_hand(mano, cuda(rng.randn(1, 10) * 0.3))
        return (*mano_skin_inputs(mano, pose, trans, shaped)[1:], skin_consts(mano, shaped))

    pose_map, rt_flat, offset, consts = skin(5120)
    skin_args = (pose_map, rt_flat, offset, *consts, frame(), mask(), hw, one)
    run("#7 (5120, 135, 778)", lambda: kernels.hand_energy_skin_cuda(*skin_args, **extra))
    seqs = [skin(5120) for _ in range(4)]
    stack = lambda i: torch.stack([q[i] for q in seqs]).contiguous()  # noqa: E731
    vshaped = torch.stack([q[3].vshaped_cf for q in seqs]).contiguous()
    skinb_args = (stack(0), stack(1), stack(2), seqs[0][3].posedirs_cf, vshaped,
                  seqs[0][3].weights_t, torch.stack([frame() for _ in range(4)]),
                  torch.stack([mask() for _ in range(4)]), hw, four)
    run("#7b (4, 5120, 135, 778)",
        lambda: kernels.hand_energy_skin_batched_cuda(*skinb_args, **extra))
    torch.cuda.synchronize()
    ms = {name: _device_ms(fn) for name, fn in timed.items()} if args.time else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip().splitlines()
    line = {"repo": args.repo, "bf16": args.bf16, "card": card[0] if card else None,
            "digests": out}
    if ms is not None:
        line["ms"] = ms
    if args.ptxas:
        line["ptxas"] = {name: _ptxas(kernels.build(name))
                         for name in ("sdf_mlp", "obj_energy", "hand_energy", "hand_energy_skin")}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
