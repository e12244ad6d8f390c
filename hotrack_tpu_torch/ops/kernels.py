"""Build, bind and launch the hand-written CUDA kernels of `csrc/`.

Each kernel source is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface, at first use, and loaded with `ctypes`. Libraries
are keyed by a hash of the source, of every file of `csrc/` that it includes
(directly or through another header) and of the flags, under `build/kernels/`
at the repository root (or `HOTRACK_KERNEL_BUILD_DIR`), so an edited source
or header rebuilds and an unchanged one loads in milliseconds.

A wrapper here checks its inputs and raises on anything its kernel does not
take, allocates the output with `torch.empty`, launches on the current
stream, checks the launch status, and does not synchronise. It counts its
launches in `launch_counts` (under a lock: the sharded trackers launch from
several threads), so a run can show that it went through the kernel. Nothing
here falls back to another implementation. A library is loaded once per
process; its set-up (shared memory opted in above 48 KB, the SM count) runs
once for each card a kernel of it launches on.

Four kernels also take a leading sequence axis S, for several sequences
tracked in one loop (`*_batched_cuda`, each with its own launch counter): a
launch covers every sequence, sequence s reads its own per-sequence inputs,
and an input given without the axis is shared (a stride of 0). The unbatched
wrapper launches the same kernel body with one sequence, so sequence s of a
batched launch is bitwise an unbatched launch on s's inputs.

The four kernels that run the distilled-SDF MLP (#3, #4, #6, #7, and the
batched #3b, #4b, #7b) each have two instantiations: float32-class (3xTF32)
and bf16 (`compute_dtype=torch.bfloat16`, ops/sdf_mlp.py). All of them run
the persistent wgmma walk of csrc/sdf_mlp_wgmma.cuh, the 3xTF32 ones on
`PackedSDF.wg`, the bf16 ones on `PackedSDF.wg16`. A wrapper given bf16
launches the bf16 one and counts it apart (`<name>_bf16` in `launch_counts`);
it never takes the other precision.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import re
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
launch_counts = {"fps": 0, "gather_rows": 0, "scatter_rows_add": 0,
                 "sdf_mlp": 0, "obj_sdf_energy": 0, "packed_mask_lookup": 0,
                 "hand_energy": 0, "hand_energy_skin": 0, "sdf_mlp_batched": 0,
                 "obj_sdf_energy_batched": 0, "packed_mask_lookup_batched": 0,
                 "hand_energy_skin_batched": 0}
# the SDF kernels' bf16 instantiations, counted apart
SDF_KERNELS = ("sdf_mlp", "sdf_mlp_batched", "obj_sdf_energy", "obj_sdf_energy_batched",
               "hand_energy", "hand_energy_skin", "hand_energy_skin_batched")
launch_counts.update({f"{name}_bf16": 0 for name in SDF_KERNELS})
SOURCES = ("fps", "gather_rows", "sdf_mlp", "obj_energy", "mask_lookup",
           "hand_energy", "hand_energy_skin")  # csrc/<name>.cu
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_libs: dict[str, ctypes.CDLL] = {}
_ready: set[tuple[str, int]] = set()   # (library, device) pairs set up
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


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


def source_files(name: str) -> list[Path]:
    """csrc/<name>.cu and every file of csrc/ it includes with quotes,
    through other headers too, each once, in the order found."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())
                 if (path.parent / inc).exists()]
    return files


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library lies: the name carries a hash of the
    source, its included headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same sources and flags
    exists; returns the library's path. The compiler's resource report
    (registers, shared memory, spills) is kept beside it as <lib>.log."""
    src = CSRC_DIR / f"{name}.cu"
    out = library_path(name)
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


# each library's set-up function, run once for every card a kernel of it
# launches on: the SM count, and shared memory above 48 KB opted in for that card
_SETUP = {"fps": "hotrack_fps_init", "sdf_mlp": "hotrack_sdf_mlp_init",
          "obj_energy": "hotrack_obj_energy_init", "hand_energy": "hotrack_hand_energy_init",
          "hand_energy_skin": "hotrack_hand_energy_skin_init"}


def _load(name: str, bind) -> ctypes.CDLL:
    """Build (if needed), load and bind csrc/<name>.cu once per process, and
    run its set-up function (`_SETUP`) once for the current device. A library
    ready on this device is a dictionary lookup; the lock is taken only to
    load or set up."""
    setup = _SETUP.get(name)
    key = None if setup is None else (name, torch._C._cuda_getDevice())
    lib = _libs.get(name)
    if lib is not None and (key is None or key in _ready):
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _libs[name] = lib
        if key is not None and key not in _ready:
            _check_status(getattr(lib, setup)(), f"{name} set-up")
            _ready.add(key)
    return lib


# The row kernels' wrappers read the current device with
# `torch._C._cuda_getDevice()` and the raw handle of its current stream with
# `torch._C._cuda_getCurrentRawStream(device)`: what
# `torch.cuda.current_stream(device).cuda_stream` gives (it follows
# `torch.cuda.stream(...)`), without building a Stream object, as PyTorch's
# own generated code reads it. A CPU-only build of torch has neither; the
# wrappers reach them only with a CUDA tensor in hand.


def _bind_fps(lib: ctypes.CDLL) -> None:
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.hotrack_fps.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.hotrack_fps.restype = ctypes.c_int
    lib.hotrack_fps_scratch.argtypes = [ctypes.c_int] * 2
    lib.hotrack_fps_scratch.restype = ctypes.c_longlong
    # hotrack_fps_init: the SM count, and shared memory above 48 KB for clouds
    # above 8192 points, read and opted in for the current device
    lib.hotrack_fps_init.restype = ctypes.c_int


def _bind_gather_rows(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hotrack_gather_rows.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, p]
    lib.hotrack_gather_rows.restype = i
    lib.hotrack_scatter_rows_add.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.hotrack_scatter_rows_add.restype = i
    lib.hotrack_scatter_rows_add_scratch.argtypes = [i] * 5
    lib.hotrack_scatter_rows_add_scratch.restype = ctypes.c_longlong


def _bind_sdf_mlp(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.hotrack_sdf_mlp, lib.hotrack_sdf_mlp_bf16):   # one signature
        fn.argtypes = [p, p, p, ll, ll, ll, ll, ll, i, ll, ll, i, i,
                       ctypes.POINTER(ctypes.c_int), p]
        fn.restype = i
    # hotrack_sdf_mlp_init: as much dynamic shared memory as a block may have,
    # opted in for the current device (both instantiations)
    lib.hotrack_sdf_mlp_init.restype = i


def _bind_obj_energy(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.hotrack_obj_energy, lib.hotrack_obj_energy_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, ll, ll, i, i, ctypes.POINTER(ctypes.c_int), p]
        fn.restype = i
    lib.hotrack_obj_energy_init.restype = i


def _bind_mask_lookup(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hotrack_mask_lookup.argtypes = [p, p, p, p, ll, i, ll, i, i, p]
    lib.hotrack_mask_lookup.restype = i


def _bind_hand_energy(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.hotrack_hand_energy, lib.hotrack_hand_energy_bf16):
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i,
                       ctypes.POINTER(ctypes.c_int), p]
        fn.restype = i
    # hotrack_hand_energy_init: as much dynamic shared memory as a block may
    # have (csrc/sdf_mlp_wgmma.cuh plan), opted in for the current device
    lib.hotrack_hand_energy_init.restype = i


def _bind_hand_energy_skin(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 6 + [ctypes.POINTER(ctypes.c_longlong), i, i, ctypes.POINTER(ctypes.c_int), p]
    # the 3xTF32 entry takes the pre-pass's vertex scratch after hit
    lib.hotrack_hand_energy_skin.argtypes = [p] * 12 + tail
    lib.hotrack_hand_energy_skin_bf16.argtypes = [p] * 11 + tail
    for fn in (lib.hotrack_hand_energy_skin, lib.hotrack_hand_energy_skin_bf16):
        fn.restype = i
    lib.hotrack_hand_energy_skin_init.restype = i


def _check_status(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def fps_cuda(xyz: torch.Tensor, npoint: int,
             valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Farthest point sampling on the card (csrc/fps.cu).

    xyz (B, N, 3) float32 contiguous tensor on the current CUDA device, any
    N; valid_mask (B, N) bool or uint8 on the same device, or None -> idx
    (B, npoint) int32. The kernel chooses its launch layout from N: above
    14336 points (csrc/fps.cu kMaxPoints) the cloud stays in device memory,
    with a (B, N) float32 scratch for the running minima allocated here."""
    if not xyz.is_cuda or xyz.get_device() != torch._C._cuda_getDevice():
        raise ValueError(f"fps_cuda takes a CUDA tensor on the current device, "
                         f"got one on {xyz.device}")
    shape = xyz.shape
    if xyz.dtype != torch.float32 or len(shape) != 3 or shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3) float32, got "
                         f"{tuple(shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("xyz must be contiguous")
    b, n, _ = shape
    if npoint < 1 or n < 1 or b < 1:
        raise ValueError(f"empty FPS problem: B={b} N={n} npoint={npoint}")
    lib = _load("fps", _bind_fps)
    mask_ptr = None
    if valid_mask is not None:
        if valid_mask.get_device() != xyz.get_device():
            raise ValueError("valid_mask must be on the device of xyz")
        if valid_mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"valid_mask must be bool or uint8, got "
                             f"{valid_mask.dtype}")
        if valid_mask.shape != shape[:2] or not valid_mask.is_contiguous():
            raise ValueError(f"valid_mask must be contiguous (B, N) = {(b, n)}, "
                             f"got {tuple(valid_mask.shape)}")
        mask_ptr = valid_mask.data_ptr()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    floats = lib.hotrack_fps_scratch(b, n)
    scratch = torch.empty(floats, dtype=torch.float32, device=xyz.device) if floats else None
    err = lib.hotrack_fps(xyz.data_ptr(), mask_ptr,
                          None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                          b, n, npoint, torch._C._cuda_getCurrentRawStream(xyz.get_device()))
    if err:
        _check_status(err, f"fps launch (B={b}, N={n}, npoint={npoint})")
    _count("fps")
    return out


# the row kernels' element types, each with its code in csrc/gather_rows.cu
_ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_IDX_DTYPES = (torch.int32, torch.int64)


def _check_rows(name: str, t: torch.Tensor, flat_idx: torch.Tensor) -> tuple:
    """The checks the two row kernels share: `t` (B, *, C) f32, bf16 or fp16 and
    flat_idx (B, S) int32 or int64, both contiguous on the current card.
    Returns (t's shape, S, the device index)."""
    shape, ishape = t.shape, flat_idx.shape
    dev = t.get_device() if t.is_cuda else -1
    if dev < 0 or dev != torch._C._cuda_getDevice():
        raise ValueError(f"{name} takes a CUDA tensor on the current device, "
                         f"got one on {t.device}")
    if t.dtype not in _ROW_DTYPES or len(shape) != 3:
        raise ValueError(f"{name} takes a (B, rows, C) float32, bfloat16 or "
                         f"float16 tensor, got {tuple(shape)} {t.dtype}")
    if flat_idx.get_device() != dev or len(ishape) != 2 or ishape[0] != shape[0] or \
            flat_idx.dtype not in _IDX_DTYPES:
        raise ValueError(f"{name} takes (B, S) int32 or int64 indices on the "
                         f"tensor's device, got {tuple(ishape)} "
                         f"{flat_idx.dtype} on {flat_idx.device}")
    if not (t.is_contiguous() and flat_idx.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if min(*shape, ishape[1]) < 1:
        raise ValueError(f"empty {name} problem: {tuple(shape)} by "
                         f"{tuple(ishape)}")
    return shape, ishape[1], dev


def gather_rows_cuda(points: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Row gather on the card (csrc/gather_rows.cu): points (B, N, C) f32,
    bf16 or fp16, flat_idx (B, S) int32 or int64 -> (B, S, C), bitwise the selected
    rows. An index outside [0, N) gives a zero row (the TPU kernel's rule for
    its -1 padding) and reads nothing outside the tensor."""
    (b, n, c), s, dev = _check_rows("gather_rows_cuda", points, flat_idx)
    lib = _load("gather_rows", _bind_gather_rows)
    out = torch.empty((b, s, c), dtype=points.dtype, device=points.device)
    err = lib.hotrack_gather_rows(
        points.data_ptr(), flat_idx.data_ptr(), out.data_ptr(), b * s, s, n,
        c * points.element_size(), flat_idx.dtype == torch.int64,
        torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _check_status(err, f"gather_rows launch (B={b}, N={n}, C={c}, S={s})")
    _count("gather_rows")
    return out


def scatter_rows_add_cuda(dout: torch.Tensor, flat_idx: torch.Tensor,
                          n: int) -> torch.Tensor:
    """The row gather's adjoint on the card: dout (B, S, C) f32, bf16 or fp16,
    flat_idx (B, S) -> dsrc (B, n, C) of dout's dtype, with
    dsrc[b, i] = sum of dout[b, s] over idx[b, s] == i. The sum is f32, taken
    in ascending s, one term after another, with no atomics: two launches
    agree bitwise, and so does the plain version in float32 on the CPU; rows
    that no index selects are exactly 0; indices outside [0, n) are
    skipped."""
    (b, s, c), s_idx, dev = _check_rows("scatter_rows_add_cuda", dout, flat_idx)
    if s_idx != s or n < 1:
        raise ValueError(f"scatter_rows_add_cuda: dout {tuple(dout.shape)} "
                         f"against indices {tuple(flat_idx.shape)}, n={n}")
    lib = _load("gather_rows", _bind_gather_rows)
    dsrc = torch.empty((b, n, c), dtype=dout.dtype, device=dout.device)
    code = _ROW_DTYPES[dout.dtype]
    # bf16 or fp16 above one chunk of positions: the float32 sum between chunks
    floats = lib.hotrack_scatter_rows_add_scratch(b, s, n, c, code) if code else 0
    partial = torch.empty(floats, dtype=torch.float32, device=dout.device) if floats else None
    err = lib.hotrack_scatter_rows_add(
        dout.data_ptr(), flat_idx.data_ptr(), dsrc.data_ptr(),
        None if partial is None else partial.data_ptr(), b, s, n, c, code,
        flat_idx.dtype == torch.int64, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _check_status(err, f"scatter_rows_add launch (B={b}, N={n}, C={c}, S={s})")
    _count("scatter_rows_add")
    return dsrc


def _check_f32(name: str, what: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} takes CUDA tensors on the current device, "
                         f"got {what} on {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous float32, got "
                         f"{t.dtype}, contiguous={t.is_contiguous()}")


def _seq_stride(name: str, what: str, t: torch.Tensor, shape, n_seq: int | None) -> int:
    """For an input of one sequence's `shape`: 0 when `t` has that shape (one
    input for every sequence), its element count when `t` is the stack of
    n_seq of them (n_seq None: unbatched, one input only)."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return 0
    if n_seq is not None and tuple(t.shape) == (n_seq, *shape):
        return math.prod(shape)
    raise ValueError(f"{name}: {what} must be {shape}"
                     + ("" if n_seq is None else f" or {(n_seq, *shape)}")
                     + f", got {tuple(t.shape)}")


def _precision(name: str, compute_dtype) -> str:
    """"" for float32-class (compute_dtype None), "_bf16" for torch.bfloat16:
    the suffix of the instantiation's C entry point and launch counter; raises
    on any other compute_dtype."""
    if compute_dtype is None:
        return ""
    if compute_dtype == torch.bfloat16:
        return "_bf16"
    raise ValueError(f"{name} computes in float32 (compute_dtype None) or torch.bfloat16, "
                     f"got {compute_dtype!r}")


def _mlp_args(name: str, packed, like: torch.Tensor, n_seq: int | None, layout: str):
    """The packed model's arguments for a launch (ops/sdf_mlp.PackedSDF): its
    buffer in the wgmma walk's layout of the launch's precision (`wg` for
    3xTF32, `wg16` for bf16: csrc/sdf_mlp_wgmma.cuh), frequency count, hidden
    depth, widths and the floats from one sequence's model to the next (a
    stack (S, n) of `pack_distilled_batched`, or 0)."""
    buf = getattr(packed, layout)
    _check_f32(name, "the packed model", buf)
    if buf.device != like.device:
        raise ValueError(f"{name}: the packed model is on {buf.device}, "
                         f"the points on {like.device}")
    stride = _seq_stride(name, "the packed model", buf, buf.shape[-1:], n_seq)
    widths = (ctypes.c_int * len(packed.widths))(*packed.widths)
    return buf, packed.n_freqs, len(packed.widths) - 1, widths, stride


def _sdf_mlp(name: str, counter: str, points: torch.Tensor, packed, channels_first: bool,
             batched: bool, compute_dtype) -> torch.Tensor:
    bf16 = _precision(name, compute_dtype)
    _check_f32(name, "points", points)
    if torch.is_grad_enabled() and points.requires_grad:
        raise ValueError(f"{name} has no backward: query under "
                         "torch.no_grad() or detach the points")
    n_seq = points.shape[0] if batched and points.dim() else 1
    inner = tuple(points.shape[1:] if batched else points.shape)
    lead = "(S, ...," if batched else "(...,"
    if channels_first:
        if len(inner) < 2 or inner[-2] != 3:
            raise ValueError(f"points must be {lead} 3, N), got {tuple(points.shape)}")
        n = inner[-1]
        shape = (*inner[:-2], n)
        strides = (n, 3 * n, n, 1)  # n_inner, batch, channel, point
    else:
        if len(inner) < 1 or inner[-1] != 3:
            raise ValueError(f"points must be {lead} 3), got {tuple(points.shape)}")
        shape = inner[:-1]
        strides = (max(math.prod(inner) // 3, 1), 0, 1, 3)
    m = math.prod(inner) // 3
    if m < 1 or n_seq < 1:
        raise ValueError(f"empty sdf_mlp problem: {tuple(points.shape)}")
    buf, n_freqs, n_hidden, widths, packed_seq = _mlp_args(
        name, packed, points, n_seq if batched else None, layout="wg16" if bf16 else "wg")
    lib = _load("sdf_mlp", _bind_sdf_mlp)
    out = torch.empty((n_seq, *shape) if batched else shape, dtype=torch.float32,
                      device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    launch = lib.hotrack_sdf_mlp_bf16 if bf16 else lib.hotrack_sdf_mlp
    err = launch(points.data_ptr(), buf.data_ptr(), out.data_ptr(), m, *strides, n_seq,
                 3 * m if batched else 0, packed_seq, n_freqs, n_hidden, widths, stream)
    _check_status(err, f"{counter}{bf16} launch (points {tuple(points.shape)}, "
                       f"widths {packed.widths})")
    _count(counter + bf16)
    return out


def sdf_mlp_cuda(points: torch.Tensor, packed, channels_first: bool,
                 compute_dtype=None) -> torch.Tensor:
    """The distilled-SDF MLP on the card (csrc/sdf_mlp.cu, the hidden layers
    on the tensor cores through wgmma, in 3xTF32 or, with compute_dtype
    torch.bfloat16, in bf16): points (..., 3, N) (channels_first) or (..., 3),
    contiguous float32, and a `PackedSDF` on the same device (its `wg` or
    `wg16` layout is read) -> clamped sdf (..., N) or (...,). Gradient-free;
    two launches agree bitwise."""
    return _sdf_mlp("sdf_mlp_cuda", "sdf_mlp", points, packed, channels_first, False,
                    compute_dtype)


def sdf_mlp_batched_cuda(points: torch.Tensor, packed, channels_first: bool,
                         compute_dtype=None) -> torch.Tensor:
    """The SDF MLP with a model a sequence, in one launch (csrc/sdf_mlp.cu):
    points (S, ..., 3, N) (channels_first) or (S, ..., 3), contiguous float32,
    and a `PackedSDF` of S models (buffers (S, n), `pack_distilled_batched`) or
    of one model for all -> sdf (S, ..., N) or (S, ...). Sequence s is bitwise
    `sdf_mlp_cuda` on its points and model, in either precision. Gradient-free."""
    return _sdf_mlp("sdf_mlp_batched_cuda", "sdf_mlp_batched", points, packed, channels_first,
                    True, compute_dtype)


def _obj_energy(name: str, counter: str, pcld_cf: torch.Tensor, rts: torch.Tensor, packed,
                batched: bool, compute_dtype) -> torch.Tensor:
    bf16 = _precision(name, compute_dtype)
    _check_f32(name, "pcld_cf", pcld_cf)
    _check_f32(name, "rts", rts)
    if rts.device != pcld_cf.device or rts.dim() != 2 + batched or rts.shape[-1] != 12 \
            or pcld_cf.dim() < 2 or pcld_cf.shape[-2] != 3:
        raise ValueError(f"{name} takes pcld_cf {'(S, 3, N) or ' * batched}(3, N) and rts "
                         f"{'(S, P, 12)' if batched else '(P, 12)'} on one device, got "
                         f"{tuple(pcld_cf.shape)} and {tuple(rts.shape)}")
    n_seq = rts.shape[0] if batched else 1
    p, n = rts.shape[-2], pcld_cf.shape[-1]
    pcld_seq = _seq_stride(name, "pcld_cf", pcld_cf, (3, n), n_seq if batched else None)
    if p < 1 or n < 1 or n_seq < 1:
        raise ValueError(f"empty obj_sdf_energy problem: S={n_seq} P={p} N={n}")
    buf, n_freqs, n_hidden, widths, packed_seq = _mlp_args(
        name, packed, pcld_cf, n_seq if batched else None, layout="wg16" if bf16 else "wg")
    lib = _load("obj_energy", _bind_obj_energy)
    out = torch.empty(rts.shape[:-1], dtype=torch.float32, device=pcld_cf.device)
    stream = torch.cuda.current_stream(pcld_cf.device).cuda_stream
    launch = lib.hotrack_obj_energy_bf16 if bf16 else lib.hotrack_obj_energy
    err = launch(pcld_cf.data_ptr(), rts.data_ptr(), buf.data_ptr(), out.data_ptr(), p, n,
                 n_seq, pcld_seq, packed_seq, n_freqs, n_hidden, widths, stream)
    _check_status(err, f"{counter}{bf16} launch (S={n_seq}, P={p}, N={n}, "
                       f"widths {packed.widths})")
    _count(counter + bf16)
    return out


def obj_sdf_energy_cuda(pcld_cf: torch.Tensor, rts: torch.Tensor, packed,
                        compute_dtype=None) -> torch.Tensor:
    """The fused object-pose energy on the card (csrc/obj_energy.cu, the
    MLP on the tensor cores through wgmma on the persistent walk, in 3xTF32
    or, with compute_dtype torch.bfloat16, in bf16): pcld_cf (3, N), rts
    (P, 12) (ops/obj_energy.obj_rts), both contiguous float32, and a
    `PackedSDF` (its `wg` or `wg16` layout is read) -> (P,) sums over the
    cloud of |sdf|. No atomics: two launches agree bitwise, and a candidate's
    per-point |sdf| is `sdf_mlp_cuda`'s on its object-frame points."""
    return _obj_energy("obj_sdf_energy_cuda", "obj_sdf_energy", pcld_cf, rts, packed, False,
                       compute_dtype)


def obj_sdf_energy_batched_cuda(pcld_cf: torch.Tensor, rts: torch.Tensor,
                                packed, compute_dtype=None) -> torch.Tensor:
    """The fused object-pose energy of S sequences in one launch
    (csrc/obj_energy.cu, grid (P, S)): pcld_cf (S, 3, N) (or (3, N) for all),
    rts (S, P, 12), contiguous float32, and a `PackedSDF` of S models (or of
    one) -> (S, P). Sequence s is bitwise `obj_sdf_energy_cuda` on its
    inputs, in either precision; no atomics."""
    return _obj_energy("obj_sdf_energy_batched_cuda", "obj_sdf_energy_batched", pcld_cf, rts,
                       packed, True, compute_dtype)


def _check_mask(name: str, mask: torch.Tensor, hw, like: torch.Tensor,
                n_seq: int | None = None) -> tuple:
    """A packed mask (ops/mask_lookup.pack_mask) for image size hw on the
    device of `like`, or n_seq of them stacked; returns (H, W, the bytes from
    one sequence's mask to the next)."""
    h, w = int(hw[0]), int(hw[1])
    stride = None
    if mask.device == like.device and mask.dtype == torch.uint8 and mask.is_contiguous() \
            and h >= 1 and w >= 1:
        with contextlib.suppress(ValueError):
            stride = _seq_stride(name, "mask", mask, (h, (w + 7) // 8), n_seq)
    if stride is None:
        raise ValueError(f"{name}: the packed mask must be contiguous uint8 "
                         f"{'(S, ) ' if n_seq else ''}(H, ceil(W / 8)) for hw={tuple(hw)} on "
                         f"{like.device}, got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    return h, w, stride


def _mask_lookup(name: str, counter: str, mask: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor, hw, batched: bool) -> torch.Tensor:
    for what, t in (("iy", iy), ("ix", ix)):
        if not t.is_cuda or t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name} takes CUDA tensors on the current "
                             f"device, got {what} on {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous int32, "
                             f"got {t.dtype}, contiguous={t.is_contiguous()}")
    if iy.shape != ix.shape or ix.device != iy.device or iy.numel() < 1 \
            or (batched and iy.dim() < 1):
        raise ValueError(f"{name}: iy {tuple(iy.shape)} and ix {tuple(ix.shape)} must be one "
                         f"non-empty shape{' with a leading S' * batched} on one device")
    n_seq = iy.shape[0] if batched else 1
    h, w, mask_seq = _check_mask(name, mask, hw, iy, n_seq if batched else None)
    lib = _load("mask_lookup", _bind_mask_lookup)
    out = torch.empty(iy.shape, dtype=torch.float32, device=iy.device)
    stream = torch.cuda.current_stream(iy.device).cuda_stream
    err = lib.hotrack_mask_lookup(mask.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                                  out.data_ptr(), iy.numel() // n_seq, n_seq, mask_seq, h, w,
                                  stream)
    _check_status(err, f"{counter} launch ({tuple(iy.shape)} queries, mask {h}x{w})")
    _count(counter)
    return out


def packed_mask_lookup_cuda(mask: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                            hw) -> torch.Tensor:
    """The background-mask bit at integer pixels on the card
    (csrc/mask_lookup.cu): mask uint8 (H, ceil(W / 8)) from `pack_mask`,
    iy and ix int32 of one shape, contiguous, inside [0, H) and [0, W)
    -> float32 in {0, 1} of that shape. An index outside the image reads the
    nearest pixel inside it, never memory outside the mask."""
    return _mask_lookup("packed_mask_lookup_cuda", "packed_mask_lookup", mask, iy, ix, hw,
                        False)


def packed_mask_lookup_batched_cuda(mask: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                                    hw) -> torch.Tensor:
    """The mask lookup with a mask a sequence, in one launch
    (csrc/mask_lookup.cu): mask uint8 (S, H, ceil(W / 8)) (or one mask for
    all), iy and ix int32 (S, ...) -> float32 (S, ...); sequence s reads its
    own mask, exactly as `packed_mask_lookup_cuda` on its inputs."""
    return _mask_lookup("packed_mask_lookup_batched_cuda", "packed_mask_lookup_batched", mask,
                        iy, ix, hw, True)


def _check_frame(name: str, frame: torch.Tensor, like: torch.Tensor,
                 n_seq: int | None = None) -> int:
    _check_f32(name, "frame", frame)
    stride = None
    if frame.device == like.device:
        with contextlib.suppress(ValueError):
            stride = _seq_stride(name, "frame", frame, (16,), n_seq)
    if stride is None:
        raise ValueError(f"{name}: frame must be {'(S, 16) or ' if n_seq else ''}(16,) on "
                         f"{like.device} (ops/hand_energy.hand_frame), got "
                         f"{tuple(frame.shape)} on {frame.device}")
    return stride


def hand_energy_cuda(points: torch.Tensor, frame: torch.Tensor, mask: torch.Tensor,
                     hw, packed, compute_dtype=None) -> tuple:
    """The fused per-vertex hand energy on the card (csrc/hand_energy.cu, the
    MLP of `sdf_mlp_cuda` on the tensor cores through wgmma, in 3xTF32 or in
    bf16): points (..., 3) contiguous float32 camera-frame vertices, frame
    (16,) from `hand_frame`, the packed mask for image size hw and a
    `PackedSDF` (its `wg` or `wg16` layout is read) -> (sdf (...), hit (...))
    float32. `sdf` is bitwise `sdf_mlp_cuda` of the same precision on
    `object_frame(points, frame)`, `hit` bitwise `packed_mask_lookup_cuda` at
    `pixel_coords(points, frame, hw)`; two launches agree bitwise.
    Gradient-free."""
    bf16 = _precision("hand_energy_cuda", compute_dtype)
    _check_f32("hand_energy_cuda", "points", points)
    if points.dim() < 1 or points.shape[-1] != 3 or points.numel() < 3:
        raise ValueError(f"points must be a non-empty (..., 3), got {tuple(points.shape)}")
    if torch.is_grad_enabled() and points.requires_grad:
        raise ValueError("hand_energy_cuda has no backward: call it under "
                         "torch.no_grad() or detach the points")
    _check_frame("hand_energy_cuda", frame, points)
    h, w, _ = _check_mask("hand_energy_cuda", mask, hw, points)
    buf, n_freqs, n_hidden, widths, _ = _mlp_args("hand_energy_cuda", packed, points, None,
                                                  layout="wg16" if bf16 else "wg")
    lib = _load("hand_energy", _bind_hand_energy)
    shape = tuple(points.shape[:-1])
    sdf = torch.empty(shape, dtype=torch.float32, device=points.device)
    hit = torch.empty(shape, dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    launch = lib.hotrack_hand_energy_bf16 if bf16 else lib.hotrack_hand_energy
    err = launch(points.data_ptr(), frame.data_ptr(), mask.data_ptr(), buf.data_ptr(),
                 sdf.data_ptr(), hit.data_ptr(), points.numel() // 3, h, w, n_freqs, n_hidden,
                 widths, stream)
    _check_status(err, f"hand_energy{bf16} launch (points {tuple(points.shape)}, "
                       f"mask {h}x{w}, widths {packed.widths})")
    _count("hand_energy" + bf16)
    return sdf, hit


SKIN_JOINTS = 16  # csrc/hand_energy_skin.cu blends this many joints a vertex


def _hand_energy_skin(name: str, counter: str, pose_map, rt_flat, offset, posedirs_cf,
                      vshaped_cf, weights_t, frame, mask, hw, packed, batched: bool,
                      compute_dtype) -> tuple:
    bf16 = _precision(name, compute_dtype)
    per_cand = {"pose_map": pose_map, "rt_flat": rt_flat, "offset": offset}
    per_call = {"posedirs_cf": posedirs_cf, "vshaped_cf": vshaped_cf, "weights_t": weights_t}
    for what, t in (*per_cand.items(), *per_call.items()):
        _check_f32(name, what, t)
        if t.device != pose_map.device:
            raise ValueError(f"{name}: {what} is on {t.device}, pose_map on {pose_map.device}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"{name} has no backward: call it under torch.no_grad()")
    if pose_map.dim() != 2 + batched or posedirs_cf.dim() < 3:
        raise ValueError(f"{name}: pose_map {tuple(pose_map.shape)}, posedirs_cf "
                         f"{tuple(posedirs_cf.shape)}")
    n_seq = pose_map.shape[0] if batched else 1
    p, k = pose_map.shape[-2:]
    n = posedirs_cf.shape[-1]
    lead = (n_seq,) if batched else ()
    want = {"rt_flat": (*lead, p * 12, SKIN_JOINTS), "offset": (*lead, p, 3)}
    for what, shape in want.items():
        if tuple(per_cand[what].shape) != shape:
            raise ValueError(f"{name}: {what} must be {shape} beside pose_map "
                             f"{tuple(pose_map.shape)}, got {tuple(per_cand[what].shape)}")
    one = n_seq if batched else None
    strides = [_seq_stride(name, what, per_call[what], shape, one) for what, shape in
               (("posedirs_cf", (3, k, n)), ("vshaped_cf", (3, n)),
                ("weights_t", (SKIN_JOINTS, n)))]
    if p < 1 or k < 1 or n < 1 or n_seq < 1:
        raise ValueError(f"empty {name} problem: S={n_seq} P={p} K={k} N={n}")
    strides.append(_check_frame(name, frame, pose_map, one))
    h, w, mask_seq = _check_mask(name, mask, hw, pose_map, one)
    buf, n_freqs, n_hidden, widths, packed_seq = _mlp_args(
        name, packed, pose_map, one, layout="wg16" if bf16 else "wg")
    seq_strides = (ctypes.c_longlong * 6)(*strides, mask_seq, packed_seq)
    lib = _load("hand_energy_skin", _bind_hand_energy_skin)
    sdf = torch.empty((*lead, p, n), dtype=torch.float32, device=pose_map.device)
    hit = torch.empty((*lead, p, n), dtype=torch.float32, device=pose_map.device)
    stream = torch.cuda.current_stream(pose_map.device).cuda_stream
    ptrs = [pose_map.data_ptr(), rt_flat.data_ptr(), offset.data_ptr(), posedirs_cf.data_ptr(),
            vshaped_cf.data_ptr(), weights_t.data_ptr(), frame.data_ptr(), mask.data_ptr(),
            buf.data_ptr(), sdf.data_ptr(), hit.data_ptr()]
    if bf16:
        launch = lib.hotrack_hand_energy_skin_bf16
    else:   # the skinning pre-pass's vertices, (S, P, N, 3), read by the walk
        launch = lib.hotrack_hand_energy_skin
        verts = torch.empty((n_seq, p, n, 3), dtype=torch.float32, device=pose_map.device)
        ptrs.append(verts.data_ptr())
    err = launch(*ptrs, p, k, n, h, w, n_seq, seq_strides, n_freqs, n_hidden, widths, stream)
    _check_status(err, f"{counter}{bf16} launch (S={n_seq}, P={p}, K={k}, N={n}, "
                       f"mask {h}x{w}, widths {packed.widths})")
    _count(counter + bf16)
    return sdf, hit


def hand_energy_skin_cuda(pose_map: torch.Tensor, rt_flat: torch.Tensor,
                          offset: torch.Tensor, posedirs_cf: torch.Tensor,
                          vshaped_cf: torch.Tensor, weights_t: torch.Tensor,
                          frame: torch.Tensor, mask: torch.Tensor, hw, packed,
                          compute_dtype=None) -> tuple:
    """MANO skinning fused with the per-vertex hand energy on the card
    (csrc/hand_energy_skin.cu, the MLP on the tensor cores through wgmma on
    the persistent walk: in 3xTF32 reading `PackedSDF.wg`, after a skinning
    pre-pass that writes the vertices to a (P, N, 3) scratch allocated here;
    with compute_dtype torch.bfloat16, in bf16 reading `PackedSDF.wg16`, the
    skinning on the walk's spare warps and the vertices never in device
    memory). Per candidate: pose_map (P, K), rt_flat (P * 12, 16), offset
    (P, 3) (mano/layer.mano_skin_inputs); per call: posedirs_cf (3, K, N),
    vshaped_cf (3, N), weights_t (16, N) (ops/hand_energy_skin.skin_consts);
    frame (16,), the packed mask for image size hw and a `PackedSDF`; all
    contiguous float32 on the current card -> (sdf (P, N), hit (P, N)). In
    3xTF32 the sdf and the hit are bitwise `hand_energy_cuda`'s on the same
    vertices and frame. Gradient-free."""
    return _hand_energy_skin("hand_energy_skin_cuda", "hand_energy_skin", pose_map, rt_flat,
                             offset, posedirs_cf, vshaped_cf, weights_t, frame, mask, hw,
                             packed, False, compute_dtype)


def hand_energy_skin_batched_cuda(pose_map: torch.Tensor, rt_flat: torch.Tensor,
                                  offset: torch.Tensor, posedirs_cf: torch.Tensor,
                                  vshaped_cf: torch.Tensor, weights_t: torch.Tensor,
                                  frame: torch.Tensor, mask: torch.Tensor, hw,
                                  packed, compute_dtype=None) -> tuple:
    """The fused skinning + energy of S sequences in one launch
    (csrc/hand_energy_skin.cu, grid (pairs, S)): per candidate pose_map
    (S, P, K), rt_flat (S, P * 12, 16), offset (S, P, 3); per call, each
    either per sequence (a leading S) or shared: posedirs_cf (3, K, N),
    vshaped_cf (3, N), weights_t (16, N), frame (16,), the packed mask
    (H, ceil(W / 8)) for the padded image size hw, and a `PackedSDF` of S
    models (or one) -> (sdf (S, P, N), hit (S, P, N)). Sequence s is bitwise
    `hand_energy_skin_cuda` on its inputs, in either precision. Gradient-free."""
    return _hand_energy_skin("hand_energy_skin_batched_cuda", "hand_energy_skin_batched",
                             pose_map, rt_flat, offset, posedirs_cf, vshaped_cf, weights_t,
                             frame, mask, hw, packed, True, compute_dtype)
