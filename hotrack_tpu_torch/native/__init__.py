"""ctypes bindings of the host-side point-cloud library (port of
hotrack_tpu/native).

`pointcloud.cc` (this package's own copy) fuses the HO3D depth decode, and
the back-projection, segmentation split and radius filter of a depth image,
into one pass each; `png.cc` reconstructs the filtered rows of a PNG file
(data/image.py). Both are compiled by g++ into one library at first use,
into `build/native/` at the repository root (or `HOTRACK_NATIVE_BUILD_DIR`),
keyed by a hash of the sources and the flags, and loaded with ctypes. A
failed build raises with the compiler's message: nothing falls back to
another implementation.

`decode_ho3d_depth_numpy` and `backproject_filter_numpy` are the plain numpy
versions of the two entry points (the JAX package's fallbacks). Only tests
call them, to hold the library against them. They compute the coordinates
in float64 where the library computes in float32.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ("pointcloud.cc", "png.cc"))
REPO_ROOT = SOURCES[0].parent.parent.parent
# No -march=native: on a host with FMA, GCC may contract the radius test's
# dx*dx + dy*dy + dz*dz into fused multiply-adds, so that a point within
# float32 rounding of the radius is kept on one machine and dropped on
# another. The x86-64 baseline has no FMA, and -ffp-contract=off keeps any
# target from contracting: every machine rounds each product and sum alike.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_lib = None
_lock = threading.Lock()


def build_dir() -> Path:
    return Path(os.environ.get("HOTRACK_NATIVE_BUILD_DIR", REPO_ROOT / "build" / "native"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES:
        digest.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"libhotrack_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same sources and flags
    exists; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except FileNotFoundError as e:
        raise RuntimeError(f"no C++ compiler to build {SOURCES} ({e}); set CXX") from e
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.decode_ho3d_depth.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_float, f32p]
            lib.decode_ho3d_depth.restype = None
            lib.backproject_filter.argtypes = [
                f32p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, f32p, ctypes.c_float, ctypes.c_int,
                f32p, ctypes.c_int]
            lib.backproject_filter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
    return _lib


def decode_ho3d_depth(img: np.ndarray, scale: float) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W) float32 depth (R + G * 256) * scale."""
    lib = _load()
    h, w = img.shape[:2]
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((h, w), np.float32)
    lib.decode_ho3d_depth(img, h, w, np.float32(scale), out)
    return out


def backproject_filter(depth: np.ndarray, mask: np.ndarray | None, label: int,
                       fx: float, fy: float, cx: float, cy: float,
                       sign_y: float = 1.0, sign_z: float = 1.0,
                       center=None, radius: float = -1.0,
                       stride: int = 1, max_out: int | None = None) -> np.ndarray:
    """Depth (H, W) -> the camera-frame cloud (K, 3) float32 of the pixels
    at `stride` whose depth is positive and whose mask label is `label`
    (every pixel without a mask), y and z multiplied by the signs, kept
    where the distance to `center` is below `radius` (radius <= 0: all),
    in row-major pixel order."""
    lib = _load()
    h, w = depth.shape
    depth = np.ascontiguousarray(depth, np.float32)
    mask_ptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask, np.uint8)
        mask_ptr = mask.ctypes.data
    c = np.zeros(3, np.float32) if center is None else np.asarray(center, np.float32)
    cap = max_out if max_out is not None else (h * w) // (stride * stride) + 1
    out = np.empty((cap, 3), np.float32)
    n = lib.backproject_filter(depth, mask_ptr, h, w, np.uint8(label),
                               np.float32(fx), np.float32(fy), np.float32(cx),
                               np.float32(cy), np.float32(sign_y),
                               np.float32(sign_z), np.ascontiguousarray(c.reshape(3)),
                               np.float32(radius), int(stride), out, cap)
    return out[:n].copy()


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Inflated PNG image data (h rows of a filter byte and `stride` bytes)
    -> the (h, stride) uint8 reconstructed rows."""
    lib = _load()
    src = np.frombuffer(raw, np.uint8)
    if src.size != h * (stride + 1):
        raise ValueError(f"PNG image data of {src.size} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    status = lib.png_unfilter(np.ascontiguousarray(src), h, stride, bpp, out)
    if status:
        raise ValueError(f"PNG row {-1 - status}: unknown filter type")
    return out


def decode_ho3d_depth_numpy(img: np.ndarray, scale: float) -> np.ndarray:
    """The plain version of `decode_ho3d_depth`."""
    return ((img[:, :, 2].astype(np.float32)
             + img[:, :, 1].astype(np.float32) * 256.0) * np.float32(scale))


def backproject_filter_numpy(depth, mask, label, fx, fy, cx, cy, sign_y=1.0, sign_z=1.0,
                             center=None, radius=-1.0, stride=1) -> np.ndarray:
    """The plain version of `backproject_filter` (x and y in float64)."""
    d = depth[::stride, ::stride]
    sel = d > 1e-6
    if mask is not None:
        sel &= (mask[::stride, ::stride] == label)
    rows, cols = np.nonzero(sel)
    z = d[rows, cols].astype(np.float32)
    x = (cols * stride - cx) * z / fx
    y = (rows * stride - cy) * z / fy * sign_y
    pts = np.stack([x, y, z * sign_z], axis=1)
    if radius > 0 and center is not None:
        pts = pts[np.linalg.norm(pts - np.asarray(center)[None], axis=-1) < radius]
    return pts
