"""PNG files and nearest-neighbour resizing with the standard library and
numpy, in place of OpenCV and Pillow, which the card machine lacks.

`read_png` decodes a non-interlaced PNG of 8-bit gray, RGB or RGBA, or
16-bit gray, every row filter (none, sub, up, average, Paeth)
included (the rows are reconstructed by native/png.cc), into the array
`np.array(PIL.Image.open(path))` gives: (H, W) for
gray, (H, W, C) in the file's channel order otherwise, uint8 or uint16.
`imread` returns what `cv2.imread(path)` returns: (H, W, 3) uint8 in BGR
order, gray replicated, alpha dropped, 16 bits cut to their high byte.
`resize_nearest` picks the source pixel `cv2.resize(img, (w, h),
interpolation=cv2.INTER_NEAREST)` picks. `write_png` writes such files (no
interlacing, one chosen filter a row), for the readers' test trees.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # PNG colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if interlace or colour not in _CHANNELS or depth not in (8, 16) \
            or (depth == 16 and colour != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}): 8-bit gray, RGB, RGBA and 16-bit gray "
                         f"are read")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.reshape(h, w, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]       # big-endian samples
        return img.astype(np.uint16)
    img = rows.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def imread(path: str) -> np.ndarray:
    """`cv2.imread(path)`: (H, W, 3) uint8, BGR."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def _nearest_index(src: int, dst: int) -> np.ndarray:
    # cv2's INTER_NEAREST: floor(dst_index * (src / dst)), in double, clipped
    return np.minimum(np.floor(np.arange(dst) * (src / dst)).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`; size is
    (width, height), as cv2 takes it."""
    w, h = size
    return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter the (h, stride) uint8 rows, row r by filters[r % len(filters)]."""
    h, stride = rows.shape
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    zeros = np.zeros(bpp, np.int32)
    for r in range(h):
        kind = filters[r % len(filters)]
        cur = rows[r].astype(np.int32)
        a = np.concatenate([zeros, cur[:-bpp]])
        c = np.concatenate([zeros, prev[:-bpp]])
        if kind == 0:
            pred = np.zeros(stride, np.int32)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) >> 1
        elif kind == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out.append(kind)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def write_png(path: str, img: np.ndarray, filters=(0,)) -> str:
    """Write (H, W) uint8 or uint16 gray, or (H, W, 3 | 4) uint8 RGB / RGBA
    in the file's channel order (the reverse of what `imread` returns), with
    row r filtered by filters[r % len(filters)]."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, colour = 16, 0
        rows = np.stack([img >> 8, img & 0xFF], axis=-1).astype(np.uint8)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[2] in (3, 4)):
        depth = 8
        colour = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
        rows = img
    else:
        raise ValueError(f"write_png takes uint8 gray / RGB / RGBA or uint16 gray, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bpp = _CHANNELS[colour] * depth // 8
    raw = _filtered(np.ascontiguousarray(rows).reshape(h, w * bpp), bpp, tuple(filters))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return path
