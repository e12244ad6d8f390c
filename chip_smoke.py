#!/usr/bin/env python3
"""Smoke test of hotrack_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's two main paths at the shipped width (512 points, 384-d
features, pointnet2_camera_shallow1.yml) on `cuda`, with seeded random
weights: HandTrackNet sequence tracking through the `python -m
hotrack_tpu_torch.test` entry (the 100-frame synthetic SimGrasp sequence of
bench.py's hand_tracking stage, batch 1), and HandTrackNet training through
the `python -m hotrack_tpu_torch.train` entry (one epoch of
handtracknet_train_SimGrasp.yml on a generated set, batch 32). Phases, each
of which raises on failure:

  1. device: require CUDA, print the card's name and power limit, pin fp32
     (no TF32 in matmuls or convolutions);
  2. build: compile every kernel source of csrc/, one nvcc each, started
     together, and print the compiler's resource reports;
  3. kernels: each kernel against its plain PyTorch version on the card at
     every shape the paths below give it (FPS index-exact; the row gather bitwise;
     its scatter-add adjoint against a float64 oracle, and bitwise equal on a
     second launch), timed in turns with the plain version and, where one
     PyTorch call computes the same function, that call;
  4. tracking path: launch counters reset, one tracked sequence on the card
     after a warm-up one, counters read; the same entry on the CPU (plain
     versions) must pick the same frame-0 FPS indices and keypoints within
     PRED_KP_BOUND_M of the card's;
  5. train path: counters reset, one epoch of `train_main` on the card,
     counters read; finite losses; then one forward + backward of the same
     weights on the same prepared batch: on the card with the
     kernels, on the card with their plain versions (same loss bitwise,
     every gradient within STEP_GRAD_BOUND; a second step with the kernels
     bitwise the same), and on the CPU (in float64 with the plain versions
     on both devices: the same picks, loss and gradients); then the
     checkpoint that training wrote is tracked by the test entry on the card;
  6. the shapes the kernels' wrappers were given on those paths, noted while
     they ran, must be exactly the shapes phase 3 checked;
  7. neither JAX nor the JAX package (hotrack_tpu) may have been imported.

The line before the last is a JSON object describing the kernels; the last
is {"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is missing or any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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

TRAIN_CONFIG = "handtracknet_train_SimGrasp.yml"
TRAIN_FRAMES = 70       # 2 training instances x 70 frames = 4 batches of 32 and a
BATCH = 32              # tail of 12; the third instance is the test split
# One train step, dropout off, compared three ways (phase 5).
# Kernels against their plain versions on the card: the forward is bitwise
# the same, the gradients differ by the order of float32 sums in the row
# gather's adjoint; the bound is 20 times what the card showed (5.6e-6).
STEP_GRAD_BOUND = 1e-4  # |dg|_inf <= bound * (|g|_inf + STEP_GRAD_FLOOR)
STEP_GRAD_FLOOR = 1e-5
# Card against CPU in float64, plain versions (the kernels take float32 and
# bfloat16): the same function on both devices, every index pick included;
# the card showed 1.9e-14 on the loss and 1.4e-10 on the worst gradient.
F64_LOSS_RTOL = 1e-10
F64_GRAD_BOUND = 1e-8
# In float32 the two devices are not comparable gradient by gradient: the
# hand-frame coordinates come out of a matmul and differ in the last bits
# between cuBLAS and the CPU, so a neighbour whose distance to a centre lies
# within rounding of the ball's radius falls inside on one device and outside
# on the other, and train-mode BatchNorm couples the whole batch to that
# cloud (PERF.md, Findings). The float32 kernels are held against their plain
# versions on the card instead.
# biases whose gradient is mathematically zero, so that what is computed is
# cancellation residue (1e-7 .. 1e-3 beside a largest gradient of 50, and
# different on every run of the plain versions): those that feed straight
# into a BatchNorm, and the bias of sa3's last BatchNorm, which shifts the
# global feature of every cloud alike (its ReLU is open at the max-pool's
# pick) ahead of fp3's BatchNorm over the batch
DEAD_BIAS = (r"(conv_blocks\.\d+\.\d+|mlp_convs\.\d+|bhand\.conv1|r1\.linear"
             r"|bhand\.sa3\.mlp_bns\.2)\.bias$")

# the card's published peaks (NVIDIA H100 SXM data sheet): the bounds below
# are the least time the card could take, whatever its power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "fps": ("hotrack_tpu_torch/csrc/fps.cu", "hotrack_tpu/ops/pallas/fps.py:35"),
    "gather_rows": ("hotrack_tpu_torch/csrc/gather_rows.cu",
                    "hotrack_tpu/ops/pallas/gather_mm.py:93"),
    "scatter_rows_add": ("hotrack_tpu_torch/csrc/gather_rows.cu",
                         "hotrack_tpu/ops/pallas/gather_mm.py:103"),
}
# launches per call of the model: index_points runs 15 times in a HandTrackNet
# forward (sa1 2, sa2 3, fp2 1, fp1 1, q1 4, q2 4), 7 of them on feature
# sources, whose backward is the scatter-add; FPS runs in sa1 and sa2.
# prepare_batch samples (FPS) and gathers the hand and the object cloud.
GATHERS_PER_FORWARD, SCATTERS_PER_BACKWARD, FPS_PER_FORWARD, PER_PREPARE = 15, 7, 2, 2

# The batch sizes the paths give the kernels. The model runs on one frame
# when tracking, on full batches and on the ragged tails of the train and the
# test split when training; prepare_batch also takes a whole sequence at once
# when tracking (the tracking path's and the train path's test sequence).
TAILS = (2 * TRAIN_FRAMES % BATCH, TRAIN_FRAMES % BATCH)
MODEL_BATCHES = (1, BATCH, *TAILS)
BACKWARD_BATCHES = (BATCH, TAILS[0])
PREPARE_BATCHES = (NUM_FRAMES, TRAIN_FRAMES, BATCH, *TAILS)
RAW_POINTS = 2560       # points of a raw hand or object cloud, padding included
# (name, N, C, S) of the index_points calls of one HandTrackNet forward; the
# sources of C = 3 are coordinates (no gradient), the others features
FORWARD_GATHERS = [
    ("sa1 centres", 512, 3, 256), ("sa1 group xyz", 512, 3, 8192),
    ("sa2 centres", 256, 3, 128), ("sa2 group xyz", 256, 3, 4096),
    ("sa2 group feats", 256, 64, 4096), ("fp2", 128, 256, 768),
    ("fp1", 256, 128, 1536), ("q xyz k=16", 512, 3, 336),
    ("q xyz k=64", 512, 3, 1344), ("q feats k=16", 512, 384, 336),
    ("q feats k=64", 512, 384, 1344),
]
# (name, B, N, C, S) of every gather the paths launch; its adjoint runs for
# the feature sources in the train step's backward
GATHER_SHAPES = [(name, b, n, c, s) for b in (BATCH, 1, *TAILS)
                 for name, n, c, s in FORWARD_GATHERS] \
    + [("prepare_batch", b, RAW_POINTS, 3, 512) for b in PREPARE_BATCHES]
SCATTER_SHAPES = [(name, b, n, c, s) for b in BACKWARD_BATCHES
                  for name, n, c, s in FORWARD_GATHERS if c != 3]
# (name, B, N, npoint, masked) of every FPS the paths launch
FPS_SHAPES = [("prepare_batch", b, RAW_POINTS, 512, True) for b in PREPARE_BATCHES] \
    + [(name, b, n, npoint, False) for b in MODEL_BATCHES
       for name, n, npoint in (("sa1", 512, 256), ("sa2", 256, 128))]
TIMED_FPS_BATCHES = (NUM_FRAMES, 1, BATCH)
TIMED_SHAPES = ("q feats k=64", "sa2 group feats")  # the two largest outputs, at BATCH


def _seen_shape(name: str, args: tuple) -> tuple:
    if name == "fps":
        xyz, npoint, *mask = args
        return (*xyz.shape[:2], npoint, bool(mask) and mask[0] is not None)
    if name == "gather_rows":
        points, flat_idx = args
        return (*points.shape, flat_idx.shape[1])
    dout, flat_idx, n = args
    return (dout.shape[0], n, dout.shape[2], flat_idx.shape[1])


@contextlib.contextmanager
def noting_shapes(seen: dict):
    """While a path runs, note into `seen` (kernel name -> set) the shapes each
    kernel's wrapper is given: (B, N, npoint, masked) for FPS, (B, N, C, S)
    for the row gather and its adjoint. The wrappers themselves run as they
    are."""
    from hotrack_tpu_torch.ops import kernels
    real = {name: getattr(kernels, name + "_cuda") for name in KERNELS}

    def noting(name):
        def wrapper(*args):
            seen[name].add(_seen_shape(name, args))
            return real[name](*args)
        return wrapper

    for name in real:
        setattr(kernels, name + "_cuda", noting(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(kernels, name + "_cuda", fn)


def check_seen_shapes(seen: dict) -> None:
    """The kernels phase must have held each kernel at every shape the paths
    gave it, and at no shape that was assumed rather than seen."""
    checked = {"fps": {sh[1:] for sh in FPS_SHAPES},
               "gather_rows": {sh[1:] for sh in GATHER_SHAPES},
               "scatter_rows_add": {sh[1:] for sh in SCATTER_SHAPES}}
    for name in KERNELS:
        print(f"[shapes] {name}: the paths gave it {len(seen[name])} shapes: "
              f"{sorted(seen[name])}", flush=True)
        if seen[name] != checked[name]:
            raise AssertionError(
                f"[shapes] {name}: seen on the paths but not checked "
                f"{sorted(seen[name] - checked[name])}; checked but not seen "
                f"{sorted(checked[name] - seen[name])}")


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
    libs = kernels.build_all()
    # load each library and launch each kernel once
    kernels.fps_cuda(torch.zeros((1, 4, 3), device="cuda"), 2)
    rows = kernels.gather_rows_cuda(torch.zeros((1, 4, 3), device="cuda"),
                                    torch.zeros((1, 2), dtype=torch.int32, device="cuda"))
    kernels.scatter_rows_add_cuda(rows, torch.zeros((1, 2), dtype=torch.int32,
                                                    device="cuda"), 4)
    torch.cuda.synchronize()
    print(f"[build] {sorted(libs)}: {time.perf_counter() - t0:.3f} s", flush=True)
    for name, lib in libs.items():
        with open(str(lib) + ".log") as f:
            report = [ln for ln in f.read().splitlines()
                      if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        print(f"[build] {name} -> {lib}\n" + "\n".join(report), flush=True)


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


def _in_turns(kernel, plain, library, reps=50, slow_reps=3) -> dict:
    """Times on one card, in turns: plain, kernel, library, library, kernel,
    plain (each one warmed by the comparison that came before)."""
    lib = [] if library is None else [library]
    order = [plain, kernel, *lib, *lib, kernel, plain]
    t = [_time_ms(fn, slow_reps if fn is plain else reps) for fn in order]
    out = {"ms": (t[1] + t[-2]) / 2, "plain_ms": (t[0] + t[-1]) / 2,
           "library_ms": None if library is None else (t[2] + t[3]) / 2}
    return out


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once) over
    the HBM rate and its float32 operations over the float32 peak."""
    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / FP32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def _fps_latency_bound_ms(n: int, npoint: int, clock_hz: float) -> float:
    """FPS is a chain of npoint - 1 dependent steps inside one block, so the
    bytes and operations of `_bound` say little: a step cannot be shorter than
    its chain of dependent operations. With assumed latencies of 30 cycles
    for a shared-memory load or a barrier, 25 for a warp shuffle and 4 for a
    dependent float32 operation, a step of csrc/fps.cu is at least:
      30              the picked point's coordinates from shared memory
      30 + 6 * 4      a point's loads, then sub, mul, add, add, min, compare
      14 * p * w      scheduler slots of the pass: 14 operations a point, p points
                      a thread, w warps on each of the SM's 4 schedulers
      5 * (25 + 8)    the warp's shuffle reduction of (value, index)
      30              the barrier
      30 + 5 * 33     every warp reads the slots and reduces them."""
    threads = 256 if n <= 1024 else 512  # csrc/fps.cu: hotrack_fps
    cycles = 30 + 54 + 14 * -(-n // threads) * (threads // 128) + 165 + 30 + 195
    return 1e3 * (npoint - 1) * cycles / clock_hz


def _headline(timed: list) -> dict:
    """The timed case with the most work: the one whose numbers stand for the
    kernel in the result line (all of them are under "cases")."""
    return max(timed, key=lambda case: case["bound_ms"])


def _fmt(case: dict) -> str:
    lib = "none" if case["library_ms"] is None else f"{case['library_ms']:.4f} ms"
    return (f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, library "
            f"{lib}, bound {case['bound_ms']:.5f} ms ({case['bound_by']})")


def phase_kernels_fps() -> dict:
    """FPS kernel vs plain version on the card. Tolerance: index-exact.
    No single PyTorch call computes FPS, so there is no library time."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _farthest_point_sample_torch as plain
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")

    def cloud(b, n):
        return torch.from_numpy((rng.randn(b, n, 3) * 0.05).astype(np.float32)).to(dev)

    clock_hz = _sm_clock_hz()
    cases = [  # (name, xyz, npoint, mask, timed): the paths' shapes, then two more
        (f"{name} ({b},{n},3)->{npoint}" + " masked" * masked, cloud(b, n), npoint,
         torch.from_numpy(rng.rand(b, n) < 0.7).to(dev) if masked else None,
         b in TIMED_FPS_BATCHES)
        for name, b, n, npoint, masked in FPS_SHAPES]
    cases += [
        ("tie-heavy grid (1,512,3)->256",
         torch.from_numpy(_grid_cloud(rng, 1, 512)).to(dev), 256, None, False),
        ("masked, point 0 invalid (4,2560,3)->512", cloud(4, 2560), 512,
         torch.from_numpy(np.concatenate([np.zeros((4, 1), bool),
                                          rng.rand(4, 2559) < 0.5], 1)).to(dev), False),
    ]
    max_err, timed = 0, []
    for name, xyz, npoint, mask, is_timed in cases:
        got = kernels.fps_cuda(xyz, npoint, mask)
        want = plain(xyz, npoint, mask)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"[kernels] fps {name}: {int((got != want).sum())} "
                                 f"indices differ from the plain version")
        line = f"[kernels] fps {name}: index-exact"
        if is_timed:
            b, n, _ = xyz.shape
            case = _in_turns(lambda: kernels.fps_cuda(xyz, npoint, mask),
                             lambda: plain(xyz, npoint, mask), None)
            # each of the npoint - 1 steps: 3 subtractions, 3 products, 2 sums,
            # a minimum and a comparison for every point
            case.update(_bound(b * n * (12 + (mask is not None)) + b * npoint * 4,
                               10.0 * b * n * (npoint - 1)))
            case["latency_bound_ms"] = _fps_latency_bound_ms(n, npoint, clock_hz)
            case["shape"] = name
            timed.append(case)
            line += (f"; {_fmt(case)}; latency bound {case['latency_bound_ms']:.4f} ms "
                     f"at {clock_hz / 1e6:.0f} MHz")
        print(line, flush=True)
    return {"max_abs_err": max_err, **timed[0], "cases": timed}


def _rows_case(rng, b, n, c, s, dtype=torch.float32, hi=None):
    src = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dtype).cuda()
    idx = torch.from_numpy(rng.randint(0, hi or n, (b, s))).cuda()
    return src, idx


def phase_kernels_gather() -> dict:
    """Row gather vs plain version: bitwise. Library call: torch.gather."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _gather_rows_torch as plain
    rng = np.random.RandomState(1)
    timed = []
    cases = [(*shape, torch.float32) for shape in GATHER_SHAPES]
    cases.append(("q feats k=64 bf16", BATCH, 512, 384, 1344, torch.bfloat16))
    cases.append(("odd bf16 row, int32 index", 3, 100, 5, 77, torch.bfloat16))
    for name, b, n, c, s, dtype in cases:
        src, idx = _rows_case(rng, b, n, c, s, dtype)
        if "int32" in name:
            idx = idx.int()
        got = kernels.gather_rows_cuda(src, idx)
        want = plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[kernels] gather_rows {name}: differs from the plain "
                                 f"version in {int((got != want).sum())} elements")
        line = f"[kernels] gather_rows {name} ({b},{n},{c})x({b},{s}) {dtype}: bitwise"
        if name in TIMED_SHAPES and b == BATCH:
            expanded = idx[..., None].expand(-1, -1, c)
            case = _in_turns(lambda: kernels.gather_rows_cuda(src, idx),
                             lambda: plain(src, idx),
                             lambda: torch.gather(src, 1, expanded))
            case.update(_bound(src.numel() * 4 + idx.numel() * 8 + got.numel() * 4, 0))
            case["shape"] = f"{name} ({b},{n},{c})x({b},{s})"
            timed.append(case)
            line += "; " + _fmt(case)
        print(line, flush=True)
    # an index outside [0, N): a zero row, nothing read outside the tensor
    src, idx = _rows_case(rng, 2, 10, 8, 4)
    idx[0, 1], idx[1, 2] = -1, 10
    got = kernels.gather_rows_cuda(src, idx)
    torch.cuda.synchronize()
    if float(got[0, 1].abs().sum()) != 0 or float(got[1, 2].abs().sum()) != 0 \
            or not torch.equal(got[0, 0], src[0, idx[0, 0]]):
        raise AssertionError("[kernels] gather_rows: out-of-range index is not a zero row")
    print("[kernels] gather_rows out-of-range index: zero row", flush=True)
    # a bf16 view that starts 2 bytes off a 4-byte boundary, rows of 4 and 16 bytes
    for c in (2, 8):
        store, idx = _rows_case(rng, 1, 1, 1 + 3 * 20 * c, 9, torch.bfloat16, hi=20)
        src = store.reshape(-1)[1:].view(3, 20, c)
        idx = idx.reshape(3, 3)
        got = kernels.gather_rows_cuda(src, idx)
        torch.cuda.synchronize()
        if src.data_ptr() % 4 != 2 or not torch.equal(got, plain(src, idx)):
            raise AssertionError(f"[kernels] gather_rows: bf16 view at an odd offset, C={c}")
    print("[kernels] gather_rows bf16 view at an odd storage offset: bitwise", flush=True)
    return {"max_abs_err": 0.0, **_headline(timed), "cases": timed}


def phase_kernels_scatter() -> dict:
    """Scatter-add adjoint vs the plain version accumulated in float64 (on
    the card index_add_ uses atomics in no fixed order; in float64 that
    cannot show). Tolerances: index sets like the path's (a row collects
    S / N terms) at rtol 1e-6, atol 1e-5; duplicate-heavy sets (7 distinct
    rows, so hundreds of float32 terms per row) within the bound of a
    sequential float32 sum, (terms * sum|x| + |result|) * 2^-24; a second
    launch bitwise equal to the first. Library call: one index_add_ over the
    flattened rows, which is not deterministic."""
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.ops.pointops import _scatter_rows_add_torch as plain
    rng = np.random.RandomState(2)
    max_err, timed = 0.0, []
    for name, b, n, c, s in SCATTER_SHAPES:
        for kind, hi in (("path-like", None), ("7 distinct rows", 7), ("single row", 1)):
            dout, idx = _rows_case(rng, b, s, c, s, hi=hi or n)
            got = kernels.scatter_rows_add_cuda(dout, idx, n)
            again = kernels.scatter_rows_add_cuda(dout, idx, n)
            want = plain(dout.double(), idx, n, torch.float64)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"[kernels] scatter_rows_add {name} {kind}: two "
                                     f"launches differ")
            err = (got.double() - want).abs()
            if hi is None:
                ok = bool((err <= 1e-6 * want.abs() + 1e-5).all())
            else:
                terms = plain(torch.ones_like(dout[..., :1]).double(), idx, n, torch.float64)
                ok = bool((err <= (terms * plain(dout.abs().double(), idx, n, torch.float64)
                                   + want.abs()) * 2.0 ** -24).all())
                ok = ok and bool((got[:, hi:] == 0).all())  # unselected rows exactly 0
            if not ok:
                raise AssertionError(f"[kernels] scatter_rows_add {name} {kind}: max error "
                                     f"{float(err.max()):.3e} is outside the bound")
            max_err = max(max_err, float(err.max()))
            line = (f"[kernels] scatter_rows_add {name} ({b},{s},{c})->({b},{n},{c}) {kind}: "
                    f"max error {float(err.max()):.3e}, relaunch bitwise equal")
            if name in TIMED_SHAPES and b == BATCH and hi is None:
                flat = (idx + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)
                rows = dout.reshape(b * s, c)
                case = _in_turns(
                    lambda: kernels.scatter_rows_add_cuda(dout, idx, n),
                    lambda: plain(dout, idx, n),
                    lambda: torch.zeros((b * n, c), device=dout.device).index_add_(0, flat, rows))
                case.update(_bound(dout.numel() * 4 + idx.numel() * 8 + got.numel() * 4,
                                   float(dout.numel())))
                case["shape"] = f"{name} ({b},{s},{c})->({b},{n},{c})"
                timed.append(case)
                line += "; " + _fmt(case)
            print(line, flush=True)
    # bf16: float32 accumulation, one rounding at the end
    dout, idx = _rows_case(rng, 4, 300, 64, 300, torch.bfloat16, hi=40)
    got = kernels.scatter_rows_add_cuda(dout, idx, 50)
    want = plain(dout.double(), idx, 50, torch.float64)
    torch.cuda.synchronize()
    if not bool(((got.double() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-4).all()):
        raise AssertionError("[kernels] scatter_rows_add bf16 is outside one bf16 rounding")
    print("[kernels] scatter_rows_add bf16: within one rounding of the float64 sum",
          flush=True)
    # torch.sort(stable=True) decides kNN / 3-NN ties by index: confirm on the card
    d = torch.from_numpy(np.repeat(rng.rand(4, 8, 16).astype(np.float32), 4, -1)).cuda()
    if not torch.equal(torch.sort(d, dim=-1, stable=True).indices.cpu(),
                       torch.sort(d.cpu(), dim=-1, stable=True).indices):
        raise AssertionError("[kernels] torch.sort(stable=True) is not stable on the card")
    return {"max_abs_err": max_err, **_headline(timed), "cases": timed}


def _write_checkpoint(cfg) -> str:
    from hotrack_tpu_torch.train.run_hand_track import build_handnet
    from hotrack_tpu_torch.utils.convert import save_reference_checkpoint
    net = build_handnet(cfg, "cpu")
    with torch.no_grad():
        net.final_mlp[2].weight.mul_(HEAD_SCALE)
        net.final_mlp[2].bias.mul_(HEAD_SCALE)
    return save_reference_checkpoint(
        net, os.path.join(cfg["experiment_dir"], "ckpt", "model_0001.pt"))


def _require_launches(tag: str, launches: dict, want: dict) -> None:
    for name, least in want.items():
        if launches[name] < least:
            raise AssertionError(f"[{tag}] kernel {name} launched {launches[name]} "
                                 f"times on this path, expected >= {least}")


def phase_tracking_path(card: str, seen: dict) -> dict:
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
        print(f"[track] data + checkpoint {time.perf_counter() - t0:.1f} s: {ckpt}",
              flush=True)

        test_main(argv)  # warm-up sequence
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with noting_shapes(seen):
            avg, stats = test_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()

        seq = stats["sequences"][0]
        pred = seq["pred_kp"]
        if pred.shape != (NUM_FRAMES, 21, 3) or not np.isfinite(pred).all():
            raise AssertionError(f"[track] pred_kp shape {pred.shape}, finite "
                                 f"{bool(np.isfinite(pred).all())}")
        if not all(math.isfinite(v) for v in avg.values()):
            raise AssertionError(f"[track] non-finite metrics {avg}")
        _require_launches("track", launches, {
            "fps": PER_PREPARE + FPS_PER_FORWARD * NUM_FRAMES,
            "gather_rows": PER_PREPARE + GATHERS_PER_FORWARD * NUM_FRAMES})
        ms_frame = 1000.0 * stats["net_seconds"] / stats["n_frames"]
        prep_ms = 1000.0 * stats["data_seconds"]
        print(f"[track] cuda: {stats['n_frames']} frames, tracking {ms_frame:.3f} "
              f"ms/frame (data preparation excluded: {prep_ms:.1f} ms for the "
              f"sequence), peak memory {peak / 2**20:.1f} MiB, launches {launches}, "
              f"metrics {avg} | {card}", flush=True)

        cpu_avg, cpu_stats = test_main(["--config", CONFIG, "--device", "cpu"])
        cpu_seq = cpu_stats["sequences"][0]
        for key in ("hand_idx0", "obj_idx0"):
            if not np.array_equal(cpu_seq[key], seq[key]):
                raise AssertionError(f"[track] frame-0 FPS indices ({key}) differ "
                                     f"between cuda and cpu")
        diff = np.abs(cpu_seq["pred_kp"] - pred).reshape(NUM_FRAMES, -1).max(1)
        print(f"[track] cpu vs cuda: frame-0 FPS indices identical; max |pred_kp| "
              f"diff {diff.max():.3e} m (frame 0 {diff[0]:.3e}, frame "
              f"{NUM_FRAMES - 1} {diff[-1]:.3e}; bound {PRED_KP_BOUND_M} m); "
              f"cpu MPJPE {cpu_avg['hand_pred_kp_diff']:.6f} vs cuda "
              f"{avg['hand_pred_kp_diff']:.6f} m", flush=True)
        if not diff.max() <= PRED_KP_BOUND_M:
            raise AssertionError(f"[track] cuda vs cpu pred_kp differ by "
                                 f"{diff.max():.3e} m > {PRED_KP_BOUND_M} m")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _to_device(tree, device, dtype=torch.float32):
    """The batch on `device`, its floating-point tensors as `dtype`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype if tree.is_floating_point() else None)


def _plain_index_points(points, idx):
    """index_points on the plain row gather, whose backward is PyTorch's own."""
    from hotrack_tpu_torch.ops.pointops import _gather_rows_torch
    b, _, c = points.shape
    return _gather_rows_torch(points, idx.reshape(b, -1)).reshape(*idx.shape, c)


def _step_gradients(cfg, batch, device: str, plain: bool = False,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Forward + backward of the seeded initial weights on `batch`, dropout
    off. With plain=True the model's FPS and index_points are the kernels'
    plain PyTorch versions (on a CUDA tensor: no kernel runs). Records the
    indices index_points was given and the FPS indices."""
    from hotrack_tpu_torch.nn import pointnet2
    from hotrack_tpu_torch.ops import pointops
    from hotrack_tpu_torch.train.trainer import Trainer, summarize_losses

    trainer = Trainer(cfg, device)  # seeded: the same weights every time
    trainer.model.to(dtype)
    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trainer.model.train()
    fps_idx, group_idx = [], []
    fps = pointops._farthest_point_sample_torch if plain else pointops.farthest_point_sample
    gather = _plain_index_points if plain else pointops.index_points

    def recording_fps(xyz, npoint, valid_mask=None):
        fps_idx.append(fps(xyz, npoint, valid_mask).cpu())
        return fps_idx[-1].to(xyz.device)

    def recording_gather(points, idx):
        group_idx.append(idx.cpu().long())
        return gather(points, idx)

    pointnet2.farthest_point_sample, pointnet2.index_points = recording_fps, recording_gather
    try:
        total, _ = summarize_losses(
            trainer._losses(_to_device(batch, device, dtype)), trainer.loss_weights)
        total.backward()
    finally:
        pointnet2.farthest_point_sample = pointops.farthest_point_sample
        pointnet2.index_points = pointops.index_points
    return {"loss": float(total.detach()), "picks": fps_idx + group_idx,
            "grads": {k: None if p.grad is None else p.grad.detach().cpu()
                      for k, p in trainer.model.named_parameters()}}


def _picks_differ(a: dict, b: dict) -> int:
    """How many index picks (FPS, neighbourhoods, 3-NN) differ between two steps."""
    return sum(int((x != y).sum()) for x, y in zip(a["picks"], b["picks"], strict=True))


def _worst_gradient(got: dict, want: dict):
    """(largest |dg|_inf / (|g|_inf + floor) over the live parameters, its
    name, cosine of the two whole gradients)."""
    worst, dot, n2a, n2b = (0.0, ""), 0.0, 0.0, 0.0
    for k, g in want.items():
        if (g is None) != (got[k] is None):
            raise AssertionError(f"[train] {k} has a gradient in one run only")
        if g is None:
            continue
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"[train] non-finite gradient of {k}")
        dot += float((got[k].double() * g.double()).sum())
        n2a += float(got[k].double().pow(2).sum())
        n2b += float(g.double().pow(2).sum())
        if not re.search(DEAD_BIAS, k):
            err = float((got[k] - g).abs().max())
            worst = max(worst, (err / (float(g.abs().max()) + STEP_GRAD_FLOOR), k))
    return worst[0], worst[1], dot / math.sqrt(n2a * n2b)


def _one_step_checks(cfg) -> None:
    """One train step (forward + backward, dropout off) of the same initial
    weights on the same prepared batch (prepared once on the CPU, copied):
    on the card with the kernels, on the card with their plain versions, and
    in float64 on the card and on the CPU."""
    from hotrack_tpu_torch.data import get_dataloader
    from hotrack_tpu_torch.train.cli import prepare
    from hotrack_tpu_torch.train.trainer import Trainer

    raw, _ = next(iter(get_dataloader(cfg, "train")))
    batch = prepare(Trainer(cfg, "cpu"), raw, torch.Generator().manual_seed(0), cfg)
    card = _step_gradients(cfg, batch, "cuda")
    card_again = _step_gradients(cfg, batch, "cuda")
    card_plain = _step_gradients(cfg, batch, "cuda", plain=True)

    frozen = sorted(k for k, g in card["grads"].items() if g is None)
    if not frozen or not all(k.startswith(("transt.s12.", "transt.c12.")) for k in frozen):
        raise AssertionError(f"[train] unexpected parameters without gradient: {frozen}")

    # the scatter-add sums in a fixed order, so a second step on the card
    # gives bitwise the same gradients (the plain versions' atomics do not)
    moved = sorted(k for k, g in card["grads"].items()
                   if g is not None and not torch.equal(g, card_again["grads"][k]))
    if moved or card["loss"] != card_again["loss"]:
        raise AssertionError(f"[train] two steps on the card differ bitwise in {moved}")
    print(f"[train] two steps on the card with the kernels: all "
          f"{len(card['grads']) - len(frozen)} gradients bitwise equal", flush=True)

    # kernels vs their plain versions inside the step, on the card: the same
    # FPS indices and bitwise the same gathers give bitwise the same forward;
    # the gradients differ only by the order of float32 sums in the gather's
    # adjoint (the kernel's fixed order against index_add_'s atomics)
    worst, where, cos = _worst_gradient(card["grads"], card_plain["grads"])
    print(f"[train] one step on the card, kernels vs plain versions: total_loss "
          f"{card['loss']:.7f} vs {card_plain['loss']:.7f}; worst gradient {worst:.2e} "
          f"of its max at {where} (bound {STEP_GRAD_BOUND}); cosine {cos:.8f}", flush=True)
    if card["loss"] != card_plain["loss"] or worst > STEP_GRAD_BOUND \
            or _picks_differ(card, card_plain):
        raise AssertionError("[train] the step with the kernels differs from the step "
                             "with their plain versions")

    # card vs CPU in float64, plain versions: the same function on both
    card64 = _step_gradients(cfg, batch, "cuda", plain=True, dtype=torch.float64)
    cpu64 = _step_gradients(cfg, batch, "cpu", dtype=torch.float64)
    worst, where, _ = _worst_gradient(card64["grads"], cpu64["grads"])
    rel = abs(card64["loss"] - cpu64["loss"]) / abs(cpu64["loss"])
    flips = _picks_differ(card64, cpu64)
    print(f"[train] one step in float64, plain versions, card vs cpu: {flips} index "
          f"picks differ; total_loss {card64['loss']:.12f} vs {cpu64['loss']:.12f} "
          f"(relative {rel:.2e}, bound {F64_LOSS_RTOL}); worst gradient {worst:.2e} of "
          f"its max at {where} (bound {F64_GRAD_BOUND})", flush=True)
    if flips or rel > F64_LOSS_RTOL or worst > F64_GRAD_BOUND:
        raise AssertionError("[train] card vs cpu in float64 differ")


def phase_train_path(card: str, seen: dict) -> dict:
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    from hotrack_tpu_torch.ops import kernels
    from hotrack_tpu_torch.train.cli import load_config, test_main, train_main

    root = tempfile.mkdtemp(prefix="hotrack_smoke_train_")
    os.environ["HOTRACK_DATA_ROOT"] = root
    try:
        t0 = time.perf_counter()
        generate_simgrasp_dataset(root, num_instances=3, num_frames=TRAIN_FRAMES,
                                  points_per_part=POINTS_PER_PART)
        print(f"[train] data {time.perf_counter() - t0:.1f} s", flush=True)
        argv = ["--config", TRAIN_CONFIG, "--device", "cuda", "--epochs", "1"]

        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with noting_shapes(seen):
            trainer = train_main(argv)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()

        cfg, hist = trainer.cfg, trainer.history[0]
        steps = len(hist["step_seconds"])
        n_test = -(-TRAIN_FRAMES // BATCH)
        if (cfg["num_points"], cfg["batch_size"], cfg["network"]["backbone_out_dim"]) \
                != (512, BATCH, 384) or steps != -(-2 * TRAIN_FRAMES // BATCH):
            raise AssertionError(f"[train] not the full-width config: {steps} steps")
        for split in ("train", "test"):
            bad = {k: v for k, v in hist[split].items() if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"[train] non-finite {split} losses {bad}")
        _require_launches("train", launches, {
            "fps": (steps + n_test) * (PER_PREPARE + FPS_PER_FORWARD),
            "gather_rows": (steps + n_test) * (PER_PREPARE + GATHERS_PER_FORWARD),
            "scatter_rows_add": steps * SCATTERS_PER_BACKWARD})
        full = np.array(hist["step_seconds"][1:-1])  # not the first, not the ragged tail
        prep = np.array(hist["data_seconds"][1:-1])
        ms_step = 1000.0 * float(np.median(full))
        print(f"[train] cuda: {steps} steps of batch {BATCH} (tail "
              f"{2 * TRAIN_FRAMES % BATCH}) + {n_test} test batches; step "
              f"{ms_step:.3f} ms (median of steps 2-{steps - 1}; first step "
              f"{1000 * hist['step_seconds'][0]:.1f} ms), {BATCH / ms_step * 1e3:.1f} "
              f"samples/s, batch preparation {1000 * float(np.median(prep)):.3f} ms, "
              f"peak memory {peak / 2**20:.1f} MiB, launches {launches}, train "
              f"total_loss {hist['train']['total_loss']:.5f}, test MPJPE "
              f"{hist['test']['hand_pred_kp_diff']:.5f} m | {card}", flush=True)

        _one_step_checks(load_config(argv, "train"))

        # the test entry tracks with the checkpoint that training wrote
        with noting_shapes(seen):
            avg, stats = test_main(["--config", CONFIG, "--device", "cuda",
                                    "--experiment_dir",
                                    os.path.basename(cfg["experiment_dir"]),
                                    "--resume_epoch", "1"])
        pred = stats["sequences"][0]["pred_kp"]
        if pred.shape != (TRAIN_FRAMES, 21, 3) or not np.isfinite(pred).all():
            raise AssertionError(f"[train] tracking with the trained checkpoint: "
                                 f"pred_kp {pred.shape}")
        print(f"[train] test entry tracked {stats['n_frames']} frames with "
              f"{cfg['experiment_dir']}/ckpt/model_0001.pt: MPJPE "
              f"{avg['hand_pred_kp_diff']:.5f} m", flush=True)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_no_jax() -> None:
    bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu")
                 or m.startswith(("jax.", "jaxlib", "flax", "optax", "hotrack_tpu.")))
    if bad:
        raise AssertionError(f"the port imported JAX or the JAX package: {bad}")


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    numbers = {"fps": phase_kernels_fps(), "gather_rows": phase_kernels_gather(),
               "scatter_rows_add": phase_kernels_scatter()}
    seen = {name: set() for name in KERNELS}
    track_launches = phase_tracking_path(card, seen)
    train_launches = phase_train_path(card, seen)
    check_seen_shapes(seen)
    check_no_jax()
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": train_launches[name],
        "launches_by_path": {"tracking": track_launches[name],
                             "train": train_launches[name]},
        **numbers[name]} for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
