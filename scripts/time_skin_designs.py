#!/usr/bin/env python3
"""The designs of the 3xTF32 skinned hand energy (#7, #7b) in turns on one CUDA
card: the shipped one against the fused designs that lost.

    python3 scripts/time_skin_designs.py [--reps 10]

The shipped kernel (csrc/hand_energy_skin.cu, entry hotrack_hand_energy_skin)
runs a skinning pre-pass that writes the vertices to device memory, then the
3xTF32 wgmma walk on them. The fused designs put the skinning on the walk's
three spare warps, as the bf16 kernel does: they instantiate that bf16 job
(`Skinned`, its 2-slot stage, its staged columns) on the 3xTF32 walk, with the
setmaxnreg split of the consumer and producer warpgroups as the one knob:

  - fused 232 / 40: the 3xTF32 consumers' 232 registers, the aside warps at 40;
  - fused 208 / 88: 2 x 128 x 208 + 128 x 88 = 64,512, more for the aside.

setmaxnreg moves registers only within what the launch gave the block
(384 x 168 = 64,512 of the SM's 65,536): a split above that, 208 / 96 for
one, waits at its setmaxnreg.inc for registers that never come (on the card
that launch never finished), so the script refuses one at compile time.

Their kernels are not in the port: this script appends them to a copy of the
source in a temporary directory, builds that with the port's nvcc flags, and
binds them beside the shipped entry. For each design it prints the compiler's
registers and spills, the tiles the walk pins beside the job's shared memory,
whether its sdf and hit are bitwise the shipped kernel's (the vertices are
built by the same arithmetic, and a row's MLP depends on its vertex and the
model only), the shipped design's device time a kernel (its pre-pass and its
walk, by torch.profiler), and the CUDA-event mean of --reps launches at the hand path's
shapes, (5120, 135, 778) and (4, 5120, 135, 778) on 480 x 640 masks, in turns:
shipped, fused 232 / 40, fused 208 / 88, then back. Prints the card's name and
power limit with each line.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

from hotrack_tpu_torch.mano.layer import mano_skin_inputs  # noqa: E402
from hotrack_tpu_torch.ops import kernels  # noqa: E402
from hotrack_tpu_torch.ops.hand_energy_skin import skin_consts  # noqa: E402
from hotrack_tpu_torch.ops.mask_lookup import pack_mask  # noqa: E402
from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled, pack_distilled_batched  # noqa: E402

# (name, consumer registers, producer registers)
FUSED = (("fused 232 / 40", 232, 40), ("fused 208 / 88", 208, 88))

TRIAL = r"""
namespace {

// The bf16 job on the 3xTF32 walk with the setmaxnreg split <C, P>.
template <int C, int P>
struct FusedTf32 : Skinned {
  static_assert(2 * 128 * C + 128 * P <= wg::kThreads * wg::kLaunchRegs,
                "setmaxnreg cannot hand out more registers than the launch gave the block");
  static constexpr int kConsumerRegs = C;
  static constexpr int kProducerRegs = P;
};

template <int C, int P>
__global__ void __launch_bounds__(wg::kThreads, 1)
fused_tf32_kernel(const __grid_constant__ FusedTf32<C, P> job, const float* __restrict__ packed,
                  long long rounds, long long items, wg::Shape shape, int pinned, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  wg::walk<false>(job, smem, packed, job.seq.packed, rounds, items, shape, pinned, ring);
}

template <int C, int P>
int launch_fused(const void* pose_map, const void* rt, const void* offset, const void* posedirs,
                 const void* v_shaped, const void* weights, const void* frame, const void* mask,
                 const void* packed, void* sdf, void* hit, int p, int k, int n, int h, int w,
                 int n_seq, const long long* seq_strides, int n_freqs, int n_hidden,
                 const int* widths, int* pinned_out, void* stream) {
  static wg::Grid grid_of;
  static int limit = 0;
  cudaError_t err = wg::opt_in(fused_tf32_kernel<C, P>, limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths);
  const int tiles = (n + kTile - 1) / kTile, quads = (p + kQuad - 1) / kQuad;
  const long long rounds = static_cast<long long>(tiles) * quads;
  if (shape.tiles == 0 || bad_args(p, k, n, h, w, n_seq))
    return static_cast<int>(cudaErrorInvalidValue);
  FusedTf32<C, P> job{};
  static_cast<Skinned&>(job) = Skinned{
      {}, static_cast<const float*>(pose_map), static_cast<const float*>(rt),
      static_cast<const float*>(offset), static_cast<const float*>(posedirs),
      static_cast<const float*>(v_shaped), static_cast<const float*>(weights),
      static_cast<const float*>(frame), static_cast<const unsigned char*>(mask),
      static_cast<float*>(sdf), static_cast<float*>(hit), strides_of(seq_strides),
      rounds * wg::kRoundPoints, p, k, n, h, w, tiles, quads};
  int pinned = 0, ring = 0;
  long long smem = 0;
  unsigned grid = 0;
  err = wg::plan_launch(fused_tf32_kernel<C, P>, shape, limit, rounds * n_seq, grid_of, pinned,
                        ring, smem, grid, wg::job_bytes(job));
  if (err != cudaSuccess) return static_cast<int>(err);
  *pinned_out = pinned;
  fused_tf32_kernel<C, P><<<grid, wg::kThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      job, static_cast<const float*>(packed), rounds, rounds * n_seq, shape, pinned, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int skin_fused_tf32(int design, const void* pose_map, const void* rt,
                               const void* offset, const void* posedirs, const void* v_shaped,
                               const void* weights, const void* frame, const void* mask,
                               const void* packed, void* sdf, void* hit, int p, int k, int n,
                               int h, int w, int n_seq, const long long* seq_strides,
                               int n_freqs, int n_hidden, const int* widths, int* pinned_out,
                               void* stream) {
  return (design == 0 ? launch_fused<%d, %d> : launch_fused<%d, %d>)(
      pose_map, rt, offset, posedirs, v_shaped, weights, frame, mask, packed, sdf, hit, p, k, n,
      h, w, n_seq, seq_strides, n_freqs, n_hidden, widths, pinned_out, stream);
}
""" % (FUSED[0][1], FUSED[0][2], FUSED[1][1], FUSED[1][2])


def _build_trial(tmp: str) -> tuple:
    """The shipped source with the fused kernels appended, built with the
    port's flags: (the library, its ptxas report)."""
    src = os.path.join(tmp, "skin_designs.cu")
    with open(src, "w") as f:
        f.write(f'#include "{kernels.CSRC_DIR / "hand_energy_skin.cu"}"\n' + TRIAL)
    lib = os.path.join(tmp, "libskin_designs.so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
                          "-o", lib, src], capture_output=True, text=True, check=False)
    if res.returncode:
        raise SystemExit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    report, name = {}, None
    for ln in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("spill" in ln or "Used" in ln):
            report.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return ctypes.CDLL(lib), report


def _inputs(rng, s: int):
    """Seeded candidates, models and masks of the hand path; s = 0 for one
    unbatched sequence."""
    p, hw = smoke.HAND_PARTICLES, smoke.HAND_HW
    seqs = []
    for _ in range(max(s, 1)):
        mano, pose, trans, shaped = smoke._skin_candidates(rng, p)
        _, pose_map, rt_flat, offset = mano_skin_inputs(mano, pose, trans, shaped)
        seqs.append((pose_map, rt_flat, offset, skin_consts(mano, shaped),
                     smoke._seeded_frame(rng, hw), pack_mask(smoke._seeded_mask(rng, hw)),
                     smoke._random_sdf(rng, smoke.MLP_WIDTHS)))
    if s == 0:
        pose_map, rt_flat, offset, consts, frame, mask, model = seqs[0]
        return (pose_map, rt_flat, offset, *consts, frame, mask, hw, pack_distilled(model))
    st = lambda i: torch.stack([q[i] for q in seqs]).contiguous()  # noqa: E731
    return (st(0), st(1), st(2), seqs[0][3].posedirs_cf,
            torch.stack([q[3].vshaped_cf for q in seqs]).contiguous(), seqs[0][3].weights_t,
            st(4), st(5), hw, pack_distilled_batched([q[6] for q in seqs]))


def _fused(lib, design: int, args: tuple, batched: bool):
    """A launch of fused design `design` on the shipped wrapper's arguments:
    (sdf, hit, pinned tiles)."""
    pose_map, rt_flat, offset, posedirs, vshaped, weights, frame, mask, hw, packed = args
    n_seq = pose_map.shape[0] if batched else 1
    p, k = pose_map.shape[-2:]
    n = posedirs.shape[-1]
    lead = (n_seq,) if batched else ()
    sdf = torch.empty((*lead, p, n), device="cuda")
    hit = torch.empty((*lead, p, n), device="cuda")
    strides = [0 if t.dim() == d else t[0].numel()
               for t, d in ((posedirs, 3), (vshaped, 2), (weights, 2), (frame, 1), (mask, 2),
                            (packed.wg, 1))]
    widths = (ctypes.c_int * len(packed.widths))(*packed.widths)
    pinned = ctypes.c_int(0)
    err = lib.skin_fused_tf32(
        design, *(t.data_ptr() for t in (pose_map, rt_flat, offset, posedirs, vshaped, weights,
                                          frame, mask, packed.wg, sdf, hit)),
        p, k, n, hw[0], hw[1], n_seq, (ctypes.c_longlong * 6)(*strides), packed.n_freqs,
        len(packed.widths) - 1, widths, ctypes.byref(pinned),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused design {design}: CUDA error {err}")
    return sdf, hit, pinned.value


def _kernel_ms(fn, reps: int) -> dict:
    """Device ms a call of fn spends in each CUDA kernel it launches, by
    torch.profiler over `reps` calls (the shipped design: the pre-pass and
    the walk)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = next((k for k in ("skin_vertices_kernel", "hand_energy_rows_kernel")
                         if k in e.key), e.key[:40])
            out[name] = out.get(name, 0.0) + e.device_time_total / 1000.0 / reps
    return out


def _ms(fn, reps: int) -> float:
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_skin_designs: needs a CUDA card")
    card = smoke.card_line()
    print(card, flush=True)
    rng = np.random.RandomState(31)
    with tempfile.TemporaryDirectory(prefix="hotrack_skin_designs_") as tmp:
        lib, report = _build_trial(tmp)
        i, vp = ctypes.c_int, ctypes.c_void_p
        lib.skin_fused_tf32.argtypes = [i] + [vp] * 11 + [i] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), i, i, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), vp]
        lib.skin_fused_tf32.restype = i
        for name, lines in report.items():
            print(f"[ptxas] {name}: {'; '.join(lines)}", flush=True)
        for s in (0, 4):
            batched = s > 0
            case = _inputs(rng, s)
            shipped = kernels.hand_energy_skin_batched_cuda if batched else \
                kernels.hand_energy_skin_cuda
            want = shipped(*case)
            fns = {"shipped (pre-pass + walk)": lambda: shipped(*case)}
            split = _kernel_ms(fns["shipped (pre-pass + walk)"], args.reps)
            print(f"[split] the shipped design's kernels at {'S=%d ' % s if batched else ''}"
                  f"(5120,135,778), device ms a launch by torch.profiler: " + "; ".join(
                      f"{name} {ms:.4f}" for name, ms in split.items()) + f" | {card}",
                  flush=True)
            for d, (name, _, _) in enumerate(FUSED):
                sdf, hit, pinned = _fused(lib, d, case, batched)
                torch.cuda.synchronize()
                same = torch.equal(sdf, want[0]) and torch.equal(hit, want[1])
                print(f"[design] {name} at {'S=%d ' % s if batched else ''}(5120,135,778): "
                      f"{pinned} tiles pinned; sdf and hit bitwise the shipped kernel's: "
                      f"{same} | {card}", flush=True)
                fns[name] = lambda d=d: _fused(lib, d, case, batched)
            order = list(fns) + list(fns)[::-1]
            times = {name: [] for name in fns}
            for name in order:
                times[name].append(_ms(fns[name], args.reps))
            shape = f"({s},5120,135,778)" if batched else "(5120,135,778)"
            print(f"[time] {shape} on 480 x 640, ms a launch in turns: " + "; ".join(
                f"{name} {', '.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items())
                + f" | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
