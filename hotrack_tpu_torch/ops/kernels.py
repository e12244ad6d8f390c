"""Build, bind and launch the hand-written CUDA kernels of `csrc/`.

Each kernel source is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface, at first use, and loaded with `ctypes`. Libraries
are keyed by a hash of the source and the flags, under `build/kernels/` at the
repository root (or `HOTRACK_KERNEL_BUILD_DIR`), so an edited source rebuilds
and an unchanged one loads in milliseconds.

A wrapper here checks its inputs and raises on anything its kernel does not
take, allocates the output with `torch.empty`, launches on the current
stream, checks the launch status, and does not synchronise. It counts its
launches in `launch_counts`, so a run can show that it went through the
kernel. Nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC_DIR.parent.parent
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last reset; only the kernel wrappers add
launch_counts = {"fps": 0}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def build_dir() -> Path:
    return Path(os.environ.get("HOTRACK_KERNEL_BUILD_DIR",
                               REPO_ROOT / "build" / "kernels"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of hotrack_tpu_torch/csrc are built at first use")
    return found


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same source and flags
    exists; returns the library's path. The compiler's resource report
    (registers, shared memory, spills) is kept beside it as <lib>.log."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    out.with_name(out.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _load(name: str, bind) -> ctypes.CDLL:
    """Build (if needed), load and bind csrc/<name>.cu once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _libs[name] = lib
    return lib


def _bind_fps(lib: ctypes.CDLL) -> None:
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.hotrack_fps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.hotrack_fps.restype = ctypes.c_int
    lib.hotrack_fps_init.restype = ctypes.c_int
    # shared memory above 48 KB (clouds above 3072 points), opted in once for
    # the device current at load: the port runs on one card per process
    _check_status(lib.hotrack_fps_init(), "fps set-up")


def _check_status(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def fps_cuda(xyz: torch.Tensor, npoint: int,
             valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Farthest point sampling on the card (csrc/fps.cu).

    xyz (B, N, 3) float32 contiguous tensor on the current CUDA device,
    N <= 14336 (the cloud is held in one block's shared memory; the launch
    returns CUDA error 1, invalid value, above that); valid_mask (B, N) bool
    or uint8 on the same device, or None -> idx (B, npoint) int32."""
    if not xyz.is_cuda or xyz.device.index != torch.cuda.current_device():
        raise ValueError(f"fps_cuda takes a CUDA tensor on the current device, "
                         f"got one on {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    b, n, _ = xyz.shape
    if npoint < 1 or n < 1 or b < 1:
        raise ValueError(f"empty FPS problem: B={b} N={n} npoint={npoint}")
    lib = _load("fps", _bind_fps)
    mask_ptr = None
    if valid_mask is not None:
        if valid_mask.device != xyz.device:
            raise ValueError("valid_mask must be on the device of xyz")
        if valid_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"valid_mask must be bool or uint8, got "
                             f"{valid_mask.dtype}")
        if tuple(valid_mask.shape) != (b, n) or not valid_mask.is_contiguous():
            raise ValueError(f"valid_mask must be contiguous (B, N) = {(b, n)}, "
                             f"got {tuple(valid_mask.shape)}")
        mask_ptr = valid_mask.data_ptr()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.hotrack_fps(xyz.data_ptr(), mask_ptr, out.data_ptr(),
                          b, n, npoint, stream)
    _check_status(err, f"fps launch (B={b}, N={n}, npoint={npoint})")
    launch_counts["fps"] += 1
    return out
