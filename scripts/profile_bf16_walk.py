#!/usr/bin/env python3
"""Where the bf16 MLP walk's time goes, on one CUDA card: variants of
csrc/sdf_mlp_wgmma.cuh timed in turns on the bf16 distilled-SDF MLP (#3) and
the bf16 fused hand energy (#6).

    python3 scripts/profile_bf16_walk.py [--tree LABEL=DIR ...] [--reps 20] [--sass] [--phases]

Nsight Compute does not run on the card machine, so this profile is by
ablation. Each variant is a copy of a checkout's csrc/ with one part of the
bf16 walk taken out, built with the port's nvcc flags in a temporary
directory (one nvcc a source, all started together) and timed in turns with
the others in one process:

  full          the header as it is;
  no products   the bf16 wgmma instruction taken out (its asm keeps its
                operands): the CUDA-core work, the barriers and the waits alone;
  no sincosf    every sincosf replaced by a copy of its argument: the rest
                without the features' trigonometry;
  twice the products  every bf16 product issued twice (a second wgmma in its
                asm): the same CUDA-core work and twice the tensor-core work, so
                the step from `full` is what one tensor pass adds where it is
                not hidden;
  head in device memory  (where the header keeps the bf16 model's head in
                shared memory) the head left in device memory, as 3xTF32 reads it;
  ping-pong turns  the two consumer warpgroups taking turns at the tensor cores
                by two named barriers, a layer's products at a time.

Only `full` computes the function. For it the script prints a SHA-256 (first
16 hex digits) of each output, so that two checkouts show whether they compute
bitwise alike. Each --tree names a checkout to take the variants of (default:
this one, as `change`); the parent commit unpacked where .gitignore lists it
goes beside it as `--tree parent=DIR --tree change=.`. Every tree is packed by
this checkout's `pack_distilled` and called through its wrappers (the wg16
image and the entry points are the same). Cases: #3 at (2048, 3, 1024) channels
first and at (5120, 778, 3), #6 at (5120, 778, 3) on a 480 x 640 mask, on
seeded models and inputs. Every variant is timed twice, in a forward then a
reversed pass over the variants, the CUDA-event mean of --reps launches after
a warm-up. Prints one JSON line: the card's name and power limit, each case's
bf16 bound, the times, the digests and the ptxas report of each variant's bf16
kernels (registers, spills, and any wgmma-serialisation warning). --sass adds,
for the bf16 #3 kernel of each variant, the count of each SASS opcode in its
code (cuobjdump; static counts, not executed ones). --phases adds, for each
variant of a header that keeps the bf16 model's head in shared memory (but the
ping-pong turns, whose barriers pair up only in the walk; and so
has the pieces: first_fragments16, first_pair16, bias_relu16, hidden_layer16,
pack_bf16, bf16_lo / bf16_hi, net_in), a phase clock: a kernel of this script
that runs the shipped net's round on those pieces (all 18 tiles and the
model's head in shared memory, points read as scaled (m, 3) floats,
mlp_rows16's output layer, #3's store) at (2048, 3, 1024) and sums clock64()
between the phases in every consumer warp: the SM cycles a round spends
reading its points, on the features, in layer 0 (products and wait), each
epilogue (bias, ReLU, conversion), each hidden layer, the output layer and the
store, beside the kernel's CUDA-event time.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

from hotrack_tpu_torch.ops import kernels  # noqa: E402
from hotrack_tpu_torch.ops.mask_lookup import pack_mask  # noqa: E402
from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled  # noqa: E402

HEADER = "sdf_mlp_wgmma.cuh"
SOURCES = ("sdf_mlp", "hand_energy")
_OP16 = "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
_TAIL16 = '"{%64, %65, %66, %67}, %68, p, 1, 1, 0;\\n}\\n"'   # the bf16 product's last line
# the two consumer warpgroups taking turns at the tensor cores (ping-pong): warpgroup i
# waits on named barrier 3 + i before it issues a layer's products and arrives on the
# other's once they are issued; warpgroup 1 passes the first turn, 0 takes the last
_TURNS = [
    ("__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & "
     "0xFFFF0000u); }\n",
     "__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & "
     "0xFFFF0000u); }\n"
     "__device__ __forceinline__ void turn_take(int i) {\n"
     "  asm volatile(\"bar.sync %0, %1;\\n\" ::\"r\"(3 + i), \"n\"(256) : \"memory\");\n}\n"
     "__device__ __forceinline__ void turn_pass(int i) {\n"
     "  asm volatile(\"bar.arrive %0, %1;\\n\" ::\"r\"(4 - i), \"n\"(256) : \"memory\");\n}\n"),
    ("    first_pair16(d, f, s, w, ks);\n  }\n  wgmma_wait<0>();\n",
     "    fence_a(f);\n    if (ks == 0) turn_take(threadIdx.x >> 7);\n"
     "    first_pair16(d, f, s, w, ks);\n  }\n  turn_pass(threadIdx.x >> 7);\n"
     "  wgmma_wait<0>();\n"),
    ("  int held = -1;   // the previous k-step's ring slot\n  if (first_tile",
     "  fence_a(a);\n  fence_acc(d);\n  turn_take(threadIdx.x >> 7);\n"
     "  int held = -1;   // the previous k-step's ring slot\n  if (first_tile"),
    ("  wgmma_wait<0>();\n  fence_acc(d);\n  fence_a(a);\n  release(w, held);\n",
     "  turn_pass(threadIdx.x >> 7);\n"
     "  wgmma_wait<0>();\n  fence_acc(d);\n  fence_a(a);\n  release(w, held);\n"),
    ("  const int g = lane >> 2;\n  uint32_t reloads = 0, taken = 0;\n",
     "  const int g = lane >> 2;\n  uint32_t reloads = 0, taken = 0;\n"
     "  if constexpr (kBf16) {\n    if ((threadIdx.x >> 7) == 1) turn_pass(1);\n  }\n"),
    ("job.store(s, base + lane, lane < 8 ? lo : hi);\n    }\n  }\n}\n",
     "job.store(s, base + lane, lane < 8 ? lo : hi);\n    }\n  }\n"
     "  if constexpr (kBf16) {\n    if ((threadIdx.x >> 7) == 0) turn_take(0);\n  }\n}\n"),
]
# variant -> [(text of a source, its replacement)]; a variant whose text no
# source of a checkout has is not built for that checkout
VARIANTS = {
    "full": [],
    "no products": [(f'"{_OP16}"', '"// "')],
    "no sincosf": [("#include <stdint.h>\n",
                    "#include <stdint.h>\n#define sincosf(x, s, c) (*(s) = (x), *(c) = (x))\n")],
    "twice the products": [(_TAIL16, _TAIL16.replace("\\n}\\n", "\\n") + '\n      "' + _OP16
                            + "{" + ", ".join(f"%{i}" for i in range(64)) + "}, "
                            + _TAIL16[1:])],
    "head in device memory": [("s.head = 4 * tiles_offset(s);", "s.head = 0;"),
                              ("if constexpr (kBf16) net = net_in(head, shape);", "")],
    "ping-pong turns": _TURNS,
}


PHASES = r"""
#include "sdf_mlp_wgmma.cuh"
using namespace hotrack;

constexpr int kPhases = 9;   // load, features, layer 0, epilogue 1, layer 1, epilogue 2, layer 2,
                             // output layer, store; then the rounds

extern "C" __global__ void __launch_bounds__(wg::kThreads, 1)
bf16_phases(const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ packed, long long m, wg::Shape shape,
            unsigned long long* __restrict__ cycles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  wg::Tiles w;
  w.pinned_base = wg::smem_addr(smem);
  w.ring_base = w.full = w.empty = w.pinned_base + shape.tiles * wg::kTileBytes;
  w.pinned = shape.tiles;
  w.next = 0;
  const uint32_t pin = w.ring_base;
  float* head = reinterpret_cast<float*>(smem + shape.tiles * wg::kTileBytes + 16);
  if (threadIdx.x == 0) {
    wg::mbar_init(pin, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= wg::kConsumerWarps) {
    if (warp == wg::kProducerWarp) {
      if (lane == 0) wg::mbar_expect_tx(pin, shape.tiles * wg::kTileBytes + shape.head);
      __syncwarp();
      for (int t = lane; t < shape.tiles; t += 32)
        wg::bulk_copy(w.pinned_base + t * wg::kTileBytes,
                      packed + wg::tiles_offset(shape) + static_cast<long long>(t) * wg::kTileFloats,
                      wg::kTileBytes, pin);
      if (lane == 0) wg::bulk_copy(wg::smem_addr(head), packed, shape.head, pin);
    }
    return;
  }
  wg::mbar_wait(pin, 0);
  const wg::Net net = wg::net_in(head, shape);
  const int g = lane >> 2, t = lane & 3;
  unsigned long long acc[kPhases + 1] = {};
  const long long rounds = (m + wg::kRoundPoints - 1) / wg::kRoundPoints;
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    long long clk[kPhases + 1];
    clk[0] = clock64();
    const long long row = r * wg::kRoundPoints + warp * 16 + g;
    float xa[3], xb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xa[c] = row < m ? x[3 * row + c] : 0.0f;
      xb[c] = row + 8 < m ? x[3 * row + 24 + c] : 0.0f;
    }
    clk[1] = clock64();
    uint32_t f[2][4], a[wg::kMaxKSteps / 2][4];
    float d[64];
    wg::first_fragments16(f[0], xa, xb, net.freqs, shape, 0);
    wg::first_fragments16(f[1], xa, xb, net.freqs, shape, 1);
    wg::fence_a(f);
    clk[2] = clock64();
    wg::first_pair16(d, f, shape, w, 0);
    wg::wgmma_wait<0>();
    wg::fence_acc(d);
    wg::fence_a(f);
    clk[3] = clock64();
    wg::bias_relu16(a, d, net.bias, t);
    wg::fence_a(a);
    clk[4] = clock64();
    wg::hidden_layer16(d, a, shape.first_tiles, w);
    clk[5] = clock64();
    wg::bias_relu16(a, d, net.bias + wg::kUnits, t);
    wg::fence_a(a);
    clk[6] = clock64();
    wg::hidden_layer16(d, a, shape.first_tiles + wg::kMaxKSteps / 2, w);
    clk[7] = clock64();
    // mlp_rows16's output layer
    const float2* bt = reinterpret_cast<const float2*>(net.bias + 2 * wg::kUnits + 2 * t);
    const float2* wt = reinterpret_cast<const float2*>(net.wout + 2 * t);
    float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int j = 0; j < wg::kMaxKSteps; ++j) {
      const float2 b = bt[4 * j], wo = wt[4 * j];
      const uint32_t r0 = wg::pack_bf16(fmaxf(d[4 * j] + b.x, 0.0f), fmaxf(d[4 * j + 1] + b.y, 0.0f));
      const uint32_t r1 =
          wg::pack_bf16(fmaxf(d[4 * j + 2] + b.x, 0.0f), fmaxf(d[4 * j + 3] + b.y, 0.0f));
      p0 = fmaf(wg::bf16_lo(r0), wo.x, p0);
      p0 = fmaf(wg::bf16_hi(r0), wo.y, p0);
      p1 = fmaf(wg::bf16_lo(r1), wo.x, p1);
      p1 = fmaf(wg::bf16_hi(r1), wo.y, p1);
    }
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    const float ob = net.wout[wg::kUnits];
    const float2 sdf = make_float2(fminf(fmaxf(p0 + ob, -net.clamp), net.clamp),
                                   fminf(fmaxf(p1 + ob, -net.clamp), net.clamp));
    clk[8] = clock64();
    const long long base = r * wg::kRoundPoints + warp * 16;
    const float lo = __shfl_sync(0xffffffffu, sdf.x, 4 * (lane & 7));
    const float hi = __shfl_sync(0xffffffffu, sdf.y, 4 * (lane & 7));
    if (lane < 16 && base + lane < m) out[base + lane] = lane < 8 ? lo : hi;
    clk[9] = clock64();
#pragma unroll
    for (int i = 0; i < kPhases; ++i) acc[i] += clk[i + 1] - clk[i];
    acc[kPhases] += 1;
  }
  if (lane == 0)
    for (int i = 0; i <= kPhases; ++i)
      cycles[(blockIdx.x * wg::kConsumerWarps + warp) * (kPhases + 1) + i] = acc[i];
}

extern "C" int bf16_phases_launch(const void* x, void* out, const void* packed, long long m,
                                  int n_freqs, int n_hidden, const int* widths, int blocks,
                                  void* cycles, void* stream) {
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, true);
  const int smem = shape.tiles * wg::kTileBytes + 16 + shape.head;
  cudaError_t err = cudaFuncSetAttribute(bf16_phases, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bf16_phases<<<blocks, wg::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float*>(packed), m,
      shape, static_cast<unsigned long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
"""
PHASE_NAMES = ("load", "features", "layer 0", "epilogue 1", "layer 1", "epilogue 2", "layer 2",
               "output layer", "store")


def _phases(csrc: str, model, packed, reps: int) -> dict:
    """The phase clock (PHASES) built against csrc's header and run on #3's
    (2048, 3, 1024) points: SM cycles a round a consumer warp, by phase, and
    the kernel's CUDA-event mean."""
    src = os.path.join(csrc, "bf16_phases.cu")
    with open(src, "w") as f:
        f.write(PHASES)
    lib_path = os.path.join(csrc, "libbf16_phases.so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", csrc, "-o", lib_path, src],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise SystemExit(f"nvcc failed on the phase clock:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.bf16_phases_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.bf16_phases_launch.restype = ctypes.c_int
    rng = np.random.RandomState(18)
    pts = torch.from_numpy((rng.randn(2048 * 1024, 3) * 0.08).astype(np.float32)).cuda()
    x = (pts * model.scale).contiguous()
    out = torch.empty(x.shape[0], device="cuda")
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = torch.zeros(blocks * 8 * (len(PHASE_NAMES) + 1), dtype=torch.int64, device="cuda")
    widths = (ctypes.c_int * len(packed.widths))(*packed.widths)

    def run():
        kernels._check_status(lib.bf16_phases_launch(
            x.data_ptr(), out.data_ptr(), packed.wg16.data_ptr(), x.shape[0], packed.n_freqs,
            len(packed.widths) - 1, widths, blocks, cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "phase clock")

    run()
    ms = smoke._time_ms(run, reps)
    per_warp = cycles.view(blocks * 8, len(PHASE_NAMES) + 1).double()
    rounds = per_warp[:, -1].sum()
    return {"ms": ms, "cycles a round": {name: float(per_warp[:, i].sum() / rounds)
                                        for i, name in enumerate(PHASE_NAMES)}}


def _variant_csrc(label: str, tree: str, variant: str, tmp: str) -> str | None:
    """A copy of tree's csrc/ with the variant's replacements made in every
    source that has their text, or None where no source has one of them."""
    src = os.path.join(tree, "hotrack_tpu_torch", "csrc")
    texts = {n: open(os.path.join(src, n)).read() for n in os.listdir(src)
             if n.endswith((".cu", ".cuh"))}
    for old, new in VARIANTS[variant]:
        if not any(old in t for t in texts.values()):
            return None
        texts = {n: t.replace(old, new) for n, t in texts.items()}
    dst = os.path.join(tmp, f"{label}-{variant.replace(' ', '_')}")
    shutil.copytree(src, dst)
    for n, t in texts.items():
        with open(os.path.join(dst, n), "w") as f:
            f.write(t)
    return dst


def _build(csrc: str, name: str) -> tuple:
    """(library path, its bf16 kernels' ptxas lines)."""
    lib = os.path.join(csrc, f"lib{name}.so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                          os.path.join(csrc, f"{name}.cu")],
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {csrc}/{name}.cu:\n{res.stdout}\n{res.stderr}")
    report, entry = [], ""
    for ln in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "ILb1E" in entry and ("registers" in ln or "spill" in ln):
            report.append(ln.split(":", 1)[-1].strip())
        if any(c in ln for c in ("C7520", "C7513", "C7508")):
            report.append(ln.strip())
    return lib, report


def _sass_counts(lib: str) -> dict:
    """{opcode: count} of the bf16 sdf_mlp kernel's SASS in lib, the
    opcode without its modifiers, most frequent first."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    counts, inside = {}, False
    for ln in out.splitlines():
        if "Function :" in ln:
            inside = "sdf_mlp_kernelILb1E" in ln
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", ln)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def _digest(t) -> str:
    return hashlib.sha256(torch.stack(t).cpu().numpy().tobytes() if isinstance(t, tuple)
                          else t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR of a checkout (repeatable; default change=<this checkout>)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS),
                    help="which variants to build (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_bf16_walk: no CUDA card")
    trees = [(t.split("=", 1)[0], os.path.abspath(t.split("=", 1)[1])) for t in args.tree] \
        or [("change", REPO)]
    tmp = tempfile.mkdtemp(prefix="bf16_walk_")
    try:
        builds = {}
        for label, tree in trees:
            for variant in args.variants:
                csrc = _variant_csrc(label, tree, variant, tmp)
                if csrc is not None:
                    builds[f"{label} {variant}"] = csrc
        jobs = [(key, name) for key in builds for name in SOURCES]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            built = dict(zip(jobs, pool.map(lambda j: _build(builds[j[0]], j[1]), jobs)))
        libs, ptxas = {}, {}
        for key in builds:
            s_lib, h_lib = ctypes.CDLL(built[key, "sdf_mlp"][0]), \
                ctypes.CDLL(built[key, "hand_energy"][0])
            kernels._bind_sdf_mlp(s_lib)
            kernels._bind_hand_energy(h_lib)
            kernels._check_status(s_lib.hotrack_sdf_mlp_init(), f"{key} sdf_mlp set-up")
            kernels._check_status(h_lib.hotrack_hand_energy_init(), f"{key} hand_energy set-up")
            libs[key] = {"sdf_mlp": s_lib, "hand_energy": h_lib}
            ptxas[key] = built[key, "sdf_mlp"][1] + built[key, "hand_energy"][1]

        device = torch.cuda.current_device()
        kernels._ready.update({("sdf_mlp", device), ("hand_energy", device)})

        def use(key):
            kernels._libs.update(libs[key])

        rng = np.random.RandomState(17)
        bf16 = torch.bfloat16
        model = smoke._random_sdf(rng, smoke.MLP_WIDTHS)
        packed = pack_distilled(model)
        pts_cf = torch.from_numpy((rng.randn(2048, 3, 1024) * 0.08).astype(np.float32)).cuda()
        pts = torch.from_numpy((rng.randn(5120, 778, 3) * 0.08).astype(np.float32)).cuda()
        hw = smoke.HAND_HW
        bits, frame = pack_mask(smoke._seeded_mask(rng, hw)), smoke._seeded_frame(rng, hw)
        verts = smoke._camera_points(rng, (5120, 778))
        cases = {
            "#3 (2048, 3, 1024)": (lambda: kernels.sdf_mlp_cuda(pts_cf, packed, True,
                                                                compute_dtype=bf16), 2048 * 1024, 0),
            "#3 (5120, 778, 3)": (lambda: kernels.sdf_mlp_cuda(pts, packed, False,
                                                               compute_dtype=bf16), 5120 * 778, 0),
            "#6 (5120, 778, 3)": (lambda: kernels.hand_energy_cuda(verts, frame, bits, hw, packed,
                                                                   compute_dtype=bf16),
                                  5120 * 778, 27),
        }
        order = list(libs)
        ms = {key: {case: [] for case in cases} for key in order}
        digests = {}
        for key in order + order[::-1]:
            use(key)
            for case, (fn, _, _) in cases.items():
                if key.endswith(" full") and (key, case) not in digests:
                    digests[key, case] = _digest(fn())
                fn()
                ms[key][case].append(smoke._time_ms(fn, args.reps))
        bounds = {case: smoke._bound(0.0, ops * m, smoke._mlp_ops(smoke.MLP_WIDTHS, m),
                                     bf16=True)["bound_ms"]
                  for case, (_, m, ops) in cases.items()}
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=False).stdout.strip().splitlines()
        line = {"card": card[0] if card else None, "reps": args.reps, "bound_ms": bounds,
                "ms": ms, "digests": {f"{k} {c}": d for (k, c), d in digests.items()},
                "ptxas": ptxas}
        if args.sass:
            line["sass"] = {key: _sass_counts(built[key, "sdf_mlp"][0]) for key in builds}
        if args.phases:
            line["phases"] = {key: _phases(csrc, model, packed, args.reps)
                              for key, csrc in builds.items()
                              if "s.head = 4 * tiles_offset(s);" in
                              open(os.path.join(csrc, HEADER)).read()
                              and not key.endswith("turns")}   # its barriers pair in the walk
        print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
