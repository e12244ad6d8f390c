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
launch_counts = {"fps": 0, "gather_rows": 0, "scatter_rows_add": 0}
SOURCES = ("fps", "gather_rows")  # csrc/<name>.cu

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


def build_all() -> dict[str, Path]:
    """Compile every source of `SOURCES`, one nvcc each, all started
    together; returns {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


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


def _bind_gather_rows(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hotrack_gather_rows.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, p]
    lib.hotrack_gather_rows.restype = i
    lib.hotrack_scatter_rows_add.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.hotrack_scatter_rows_add.restype = i


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


_ROW_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(name: str, t: torch.Tensor, flat_idx: torch.Tensor) -> None:
    """The checks the two row kernels share: `t` (B, *, C) f32 or bf16 and
    flat_idx (B, S) int32 or int64, both contiguous on the current card."""
    if not t.is_cuda or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} takes a CUDA tensor on the current device, "
                         f"got one on {t.device}")
    if t.dtype not in _ROW_DTYPES or t.dim() != 3:
        raise ValueError(f"{name} takes a (B, rows, C) float32 or bfloat16 "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")
    if flat_idx.device != t.device or flat_idx.dim() != 2 or \
            flat_idx.shape[0] != t.shape[0] or \
            flat_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} takes (B, S) int32 or int64 indices on the "
                         f"tensor's device, got {tuple(flat_idx.shape)} "
                         f"{flat_idx.dtype} on {flat_idx.device}")
    if not t.is_contiguous() or not flat_idx.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")
    if min(*t.shape, flat_idx.shape[1]) < 1:
        raise ValueError(f"empty {name} problem: {tuple(t.shape)} by "
                         f"{tuple(flat_idx.shape)}")


def gather_rows_cuda(points: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Row gather on the card (csrc/gather_rows.cu): points (B, N, C) f32 or
    bf16, flat_idx (B, S) int32 or int64 -> (B, S, C), bitwise the selected
    rows. An index outside [0, N) gives a zero row (the TPU kernel's rule for
    its -1 padding) and reads nothing outside the tensor."""
    _check_rows("gather_rows_cuda", points, flat_idx)
    b, n, c = points.shape
    s = flat_idx.shape[1]
    lib = _load("gather_rows", _bind_gather_rows)
    out = torch.empty((b, s, c), dtype=points.dtype, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.hotrack_gather_rows(
        points.data_ptr(), flat_idx.data_ptr(), out.data_ptr(), b * s, s, n,
        c * points.element_size(), int(flat_idx.dtype == torch.int64), stream)
    _check_status(err, f"gather_rows launch (B={b}, N={n}, C={c}, S={s})")
    launch_counts["gather_rows"] += 1
    return out


def scatter_rows_add_cuda(dout: torch.Tensor, flat_idx: torch.Tensor,
                          n: int) -> torch.Tensor:
    """The row gather's adjoint on the card: dout (B, S, C) f32 or bf16,
    flat_idx (B, S) -> dsrc (B, n, C) of dout's dtype, with
    dsrc[b, i] = sum of dout[b, s] over idx[b, s] == i. The sum is f32, taken
    in ascending s with no atomics, so two launches agree bitwise; rows that
    no index selects are exactly 0; indices outside [0, n) are skipped."""
    _check_rows("scatter_rows_add_cuda", dout, flat_idx)
    b, s, c = dout.shape
    if flat_idx.shape[1] != s or n < 1:
        raise ValueError(f"scatter_rows_add_cuda: dout {tuple(dout.shape)} "
                         f"against indices {tuple(flat_idx.shape)}, n={n}")
    lib = _load("gather_rows", _bind_gather_rows)
    dsrc = torch.empty((b, n, c), dtype=dout.dtype, device=dout.device)
    stream = torch.cuda.current_stream(dout.device).cuda_stream
    err = lib.hotrack_scatter_rows_add(
        dout.data_ptr(), flat_idx.data_ptr(), dsrc.data_ptr(), b, s, n, c,
        int(dout.dtype == torch.bfloat16), int(flat_idx.dtype == torch.int64),
        stream)
    _check_status(err, f"scatter_rows_add launch (B={b}, N={n}, C={c}, S={s})")
    launch_counts["scatter_rows_add"] += 1
    return dsrc
