#!/usr/bin/env python3
"""Latencies, in SM cycles, of the dependent steps that bound one step of
farthest point sampling (chip_smoke.py `_fps_latency_bound_ms`), measured on
one CUDA card.

    python3 scripts/warp_latency.py [--out FILE]

Each chain is one kernel launch of one block that runs 4096 dependent rounds
and reads `clock64()` before and after; the least of 7 launches, over the
rounds, is printed (the loop's own counter and branch overlap the chain):

  - fp32 add+mul: `__fadd_rn(__fmul_rn(v, a), b)`, two float32 operations;
  - fp32 add+min: `fminf(__fadd_rn(v, a), b)`;
  - shfl: one `shfl.sync.bfly.b32` of the value it returned;
  - shuffle round: one round of a butterfly argmax of (value, index) with
    ties to the lower index: two shuffles, a compare and two selects;
  - redux: one `redux.sync.max.u32` of the value it returned;
  - warp winner: the largest order key by `redux.sync.max`, then the lowest
    index of the lanes that hold it by `redux.sync.min` (csrc/fps.cu
    `warp_winner`), plus one integer add to carry the chain;
  - shared round, 2 to 16 warps: a store to shared memory, a block barrier
    and a load of another warp's value (plus one integer add).

Prints one JSON object of cycles a round, with the card's name and power
limit. The source is compiled with nvcc for sm_90a into build/kernels/ and
loaded with ctypes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ROUNDS = 4096
SOURCE = r'''
#include <climits>
#include <cuda_runtime.h>

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRounds = 4096;

__device__ __forceinline__ unsigned shfl_bfly(unsigned v, int m) {
  unsigned r;
  asm volatile("shfl.sync.bfly.b32 %0, %1, %2, 0x1f, 0xffffffff;" : "=r"(r) : "r"(v), "r"(m));
  return r;
}

__device__ __forceinline__ unsigned redux_max(unsigned v) {
  unsigned r;
  asm volatile("redux.sync.max.u32 %0, %1, 0xffffffff;" : "=r"(r) : "r"(v));
  return r;
}

__device__ __forceinline__ unsigned redux_min(unsigned v) {
  unsigned r;
  asm volatile("redux.sync.min.u32 %0, %1, 0xffffffff;" : "=r"(r) : "r"(v));
  return r;
}

__global__ void chain(int kind, long long* cycles, unsigned* sink, float a, float b) {
  __shared__ unsigned slot[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float v = a * static_cast<float>(threadIdx.x + 1);
  unsigned u = 0x9e3779b9u * (threadIdx.x + 1);
  int idx = threadIdx.x;
  __syncthreads();
  const long long t0 = clock64();
  switch (kind) {
    case 0:
#pragma unroll 16
      for (int r = 0; r < kRounds; ++r) v = __fadd_rn(__fmul_rn(v, a), b);
      break;
    case 1:
#pragma unroll 16
      for (int r = 0; r < kRounds; ++r) v = fminf(__fadd_rn(v, a), b);
      break;
    case 2:
#pragma unroll 16
      for (int r = 0; r < kRounds; ++r) u = shfl_bfly(u, 1 << (r % 5));
      break;
    case 3:
#pragma unroll 15
      for (int r = 0; r < kRounds; ++r) {
        const int m = 16 >> (r % 5);
        const float ov = __uint_as_float(shfl_bfly(__float_as_uint(v), m));
        const int oi = static_cast<int>(shfl_bfly(static_cast<unsigned>(idx), m));
        const bool better = (ov > v) | ((ov == v) & (oi < idx));
        v = better ? ov : v;
        idx = better ? oi : idx;
      }
      break;
    case 4:
#pragma unroll 16
      for (int r = 0; r < kRounds; ++r) u = redux_max(u);
      break;
    case 5:
#pragma unroll 16
      for (int r = 0; r < kRounds; ++r) {
        const unsigned top = redux_max(u);
        const unsigned w = redux_min(u == top ? static_cast<unsigned>(idx) : UINT_MAX);
        u += w;
      }
      break;
    default:
      for (int r = 0; r < kRounds; ++r) {
        const int buf = r & 1;
        if (lane == 0) slot[buf][warp] = u;
        __syncthreads();
        u = slot[buf][(warp + 1) % warps] + 1u;
      }
      break;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
  sink[threadIdx.x] = u ^ __float_as_uint(v) ^ static_cast<unsigned>(idx);
}

extern "C" int warp_latency(int kind, int threads, long long* cycles, unsigned* sink, void* stream) {
  chain<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(kind, cycles, sink, 0.999f, 1e-3f);
  return static_cast<int>(cudaGetLastError());
}
'''
CHAINS = [("fp32 add+mul", 0, 32), ("fp32 add+min", 1, 32), ("shfl", 2, 32),
          ("shuffle round", 3, 32), ("redux", 4, 32), ("warp winner", 5, 32),
          ("shared round, 2 warps", 6, 64), ("shared round, 4 warps", 6, 128),
          ("shared round, 8 warps", 6, 256), ("shared round, 16 warps", 6, 512)]


def _build() -> ctypes.CDLL:
    from hotrack_tpu_torch.ops import kernels
    out_dir = kernels.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "warp_latency.cu", out_dir / "libwarp_latency.so"
    src.write_text(SOURCE)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.warp_latency.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    dll.warp_latency.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="append the JSON line here too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dll = _build()
    stream = torch.cuda.current_stream().cuda_stream
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(512, dtype=torch.int32, device="cuda")
    result = {"card": card, "cycles_a_round": {}}
    for name, kind, threads in CHAINS:
        best = None
        for _ in range(7):
            if dll.warp_latency(kind, threads, cycles.data_ptr(), sink.data_ptr(), stream):
                raise RuntimeError(f"warp_latency launch failed: {name}")
            torch.cuda.synchronize()
            per = int(cycles.item()) / ROUNDS
            best = per if best is None else min(best, per)
        result["cycles_a_round"][name] = best
        print(f"{name}: {best:.2f} cycles a round", flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
