#!/usr/bin/env python3
"""The rate one CUDA card gives `mma.sync.aligned.m16n8k8` with TF32
operands and float32 accumulators, the sm_80 instruction that the 3xTF32 object
and skinned hand energy kernels ran on until they moved to the wgmma walk
(hotrack_tpu_torch/csrc/sdf_mlp_wgmma.cuh), against the data sheet's dense TF32
peak (495 TFLOP/s on an H100 SXM, which wgmma reaches): why they moved.

    python3 scripts/mma_sync_rate.py [--iters 4096]

A kernel with no memory traffic: every warp issues `--iters` rounds of
`chains` independent m16n8k8 products, each chain on its own accumulators.
It runs with 8 warps an SM (the SDF kernels' occupancy: one block of 256
threads, at about 210-250 registers a thread) and with 32, and with 4, 8 and
16 chains a warp. Prints TFLOP/s (2 x 16 x 8 x 8 operations a product) for
each, and the card's name, power limit and SM clock. The source is compiled
with nvcc for sm_90a into build/kernels/ and loaded with ctypes.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

template <int kChains>
__global__ void mma_loop(float* out, int iters) {
  const uint32_t a[4] = {0x3f800000u + threadIdx.x, 0x3f000000u, 0x3e800000u, 0x3f400000u};
  const uint32_t b0 = 0x3f800000u + (threadIdx.x << 13), b1 = 0x3f100000u;
  float d[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(float* out, int blocks, int threads, int chains, int iters,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chains == 4) mma_loop<4><<<blocks, threads, 0, st>>>(out, iters);
  else if (chains == 8) mma_loop<8><<<blocks, threads, 0, st>>>(out, iters);
  else mma_loop<16><<<blocks, threads, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
'''


def _build() -> ctypes.CDLL:
    from hotrack_tpu_torch.ops import kernels
    out_dir = kernels.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_sync_rate.cu", out_dir / "libmma_sync_rate.so"
    src.write_text(SOURCE)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.mma_rate.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    dll = _build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for warps_per_sm in (8, 32):
        for chains in (4, 8, 16):
            blocks, threads = sms * warps_per_sm // 8, 256
            out = torch.empty(blocks * threads, device="cuda")
            run = lambda: dll.mma_rate(out.data_ptr(), blocks, threads, chains,  # noqa: E731
                                       args.iters, stream)
            if run() != 0:
                raise RuntimeError("mma_rate launch failed")
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / 5
            flops = 2.0 * 16 * 8 * 8 * blocks * (threads // 32) * chains * args.iters
            print(f"mma.sync m16n8k8 tf32: {warps_per_sm} warps an SM, {chains} chains a warp: "
                  f"{flops / ms / 1e9:.1f} TFLOP/s ({ms:.3f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
