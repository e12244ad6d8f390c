"""Fused per-vertex hand energy terms: the plain PyTorch version and the
dispatch to the CUDA kernel (csrc/hand_energy.cu, kernel wrapper in
ops/kernels.py).

Replaces hotrack_tpu/ops/pallas/hand_energy.py (`fused_hand_energy`). For
every camera-frame hand vertex x, in one pass:

    obj = R^T x - R^T t                      the vertex in the object's frame
    sdf = clamp(MLP(fourier(scale * obj)))   the distilled SDF (ops/sdf_mlp.py)
    iy  = clip(int(x_y / x_z * fy + cy), 0, H - 1)    int() truncates toward 0
    ix  = clip(int(x_x / x_z * fx + cx), 0, W - 1)
    hit = the background mask's bit at (iy, ix)       (ops/mask_lookup.py)

The hand pose optimiser calls it with 5120 candidates x 778 vertices, 5
times a frame, on its `hand_energy: fused` route. Not carried over from the
TPU: the channels-first layouts, the two-level int8 mask contraction and the
double-angle recurrence.

Every step of the two per-vertex formulas is rounded on its own, in the
order written in `_hand_energy_torch` (no fused multiply-add), so on the
card the kernel's object-frame point and pixel equal the plain version's
exactly: `hit` is exact, and `sdf` is bitwise the SDF MLP kernel (#3,
`ops/sdf_mlp.py`) on `object_frame(points, frame)`. The MLP is #3's: its
hidden layers in 3xTF32 on the tensor cores through wgmma, whose float32 sums
truncate, so `sdf` lies within 2.5e-7 a value (TC_SDF_ATOL) of the plain
version's float32 matmuls and of the 3xTF32 emulation
(`_hand_energy_torch(..., mlp=ops/tf32.raw_sdf_mlp_3xtf32)`). A vertex with
x_z <= 0 projects to inf or NaN: the kernel's conversion saturates (NaN
gives 0) and the clip brings it into the image, the CPU's conversion gives
the most negative integer; keep z > 0 where the two are compared.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which is also the kernel's oracle. Bound on the card: operations,
the MLP's 71,168 operations a vertex at the shipped net as three TF32
passes at 495 TFLOP/s, and 27 float32 operations for the transform and the
projection (1.720 ms at 5120 x 778 vertices). With `compute_dtype=
torch.bfloat16` (HOTRACK_SDF_BF16) the sdf is #3's bf16 MLP (ops/sdf_mlp.py)
on the same object-frame points, one bf16 pass at 989 TFLOP/s (0.288 ms), and
`hit` is unchanged.

With a model, mask and object pose a sequence (several sequences tracked in
one loop), `fused_hand_energy_batched` follows the JAX package's `vmap` rule
(hotrack_tpu/ops/pallas/hand_energy.py `_fused_vmapped`): the object-frame
transform, the batched SDF MLP kernel (#3b) and the pixel, then the batched
mask lookup kernel (#5b). There is no batched form of this module's kernel.
"""

from __future__ import annotations

import torch

from . import kernels
from .mask_lookup import (_packed_mask_lookup_torch, packed_mask_lookup_batched)
from .sdf_mlp import (PackedSDF, _check_batch, _sdf_mlp_torch, check_compute_dtype,
                      fused_sdf_mlp_cf_batched, pack_distilled, raw_sdf_mlp)


def hand_frame(obj_rotation: torch.Tensor, obj_translation: torch.Tensor,
               fx, fy, cx, cy) -> torch.Tensor:
    """What is constant over a frame's energy calls, as the (16,) float32
    tensor the kernels read: R^T row-major (9), R^T t (3), fx, fy, cx, cy.
    obj_rotation (3, 3), obj_translation (3,) or (3, 1); the intrinsics are
    Python numbers or 0-d tensors. With a leading sequence axis, (S, 3, 3),
    (S, 3) and intrinsics of shape (S,) give (S, 16). Built without reading
    a device value."""
    lead = obj_rotation.shape[:-2]
    rot_t = obj_rotation.transpose(-1, -2)
    rt = torch.matmul(rot_t, obj_translation.reshape(*lead, 3, 1))
    like = dict(dtype=torch.float32, device=obj_rotation.device)
    cam = torch.stack([torch.as_tensor(v, **like).reshape(lead) for v in (fx, fy, cx, cy)],
                      dim=-1)
    return torch.cat([rot_t.reshape(*lead, 9).to(torch.float32),
                      rt.reshape(*lead, 3).to(torch.float32), cam], dim=-1).contiguous()


def _entry(frame: torch.Tensor, i: int, like: torch.Tensor) -> torch.Tensor:
    """frame[..., i], shaped to broadcast over `like`'s per-point axes."""
    return frame[..., i].reshape(*frame.shape[:-1], *(1,) * (like.dim() - frame.dim() + 1))


def pixel_coords(points: torch.Tensor, frame: torch.Tensor, hw):
    """(iy, ix) int32 of camera-frame points (..., 3): (a / z) * f + c, each
    step rounded on its own, truncated toward zero, clipped to the image.
    A frame (S, 16) projects the points (S, ..., 3) of sequence s by its own."""
    h, w = hw
    z = points[..., 2]
    f = [_entry(frame, i, z) for i in range(12, 16)]
    iy = torch.clamp((points[..., 1] / z * f[1] + f[3]).to(torch.int32), 0, h - 1)
    ix = torch.clamp((points[..., 0] / z * f[0] + f[2]).to(torch.int32), 0, w - 1)
    return iy, ix


def object_frame(points: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) in the object's frame, channels-first
    (..., 3, N) for the SDF: ((r_c0 x + r_c1 y) + r_c2 z) - (R^T t)_c. A
    frame (S, 16) moves the points (S, ..., 3) of sequence s by its own."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    f = [_entry(frame, i, x) for i in range(12)]
    return torch.stack([f[3 * c] * x + f[3 * c + 1] * y + f[3 * c + 2] * z - f[9 + c]
                        for c in range(3)], dim=-2)


@torch.no_grad()
def _hand_energy_torch(model, packed_mask: torch.Tensor, frame: torch.Tensor,
                       points: torch.Tensor, hw, mlp=raw_sdf_mlp, compute_dtype=None) -> tuple:
    """Plain version: points (..., N, 3) -> (sdf (..., N), hit (..., N)).
    `mlp` and `compute_dtype` as for `_sdf_mlp_torch`."""
    sdf = _sdf_mlp_torch(model, object_frame(points, frame), mlp=mlp,
                         compute_dtype=compute_dtype)
    iy, ix = pixel_coords(points, frame, hw)
    return sdf, _packed_mask_lookup_torch(packed_mask, iy, ix)


def fused_hand_energy(model, packed_mask: torch.Tensor, frame: torch.Tensor,
                      points: torch.Tensor, hw,
                      packed: PackedSDF | None = None, compute_dtype=None) -> tuple:
    """Camera-frame vertices (..., N, 3) float32 -> (sdf (..., N), background
    hit (..., N) in {0, 1}). model: sdf.distill.DistilledSDF; packed_mask:
    `pack_mask` of the (H, W) = hw background mask; frame: `hand_frame`;
    compute_dtype None or torch.bfloat16 (the SDF's precision, ops/sdf_mlp.py)."""
    check_compute_dtype(compute_dtype)
    if points.dim() < 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be (..., N, 3), got {tuple(points.shape)}")
    if points.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.hand_energy_cuda(points.contiguous(), frame, packed_mask, hw, packed,
                                        compute_dtype=compute_dtype)
    if points.device.type != "cpu":
        raise ValueError(f"no hand energy for device {points.device}")
    return _hand_energy_torch(model, packed_mask, frame, points, hw,
                              compute_dtype=compute_dtype)


def fused_hand_energy_batched(models, packed_masks: torch.Tensor, frames: torch.Tensor,
                              points: torch.Tensor, hw, packed: PackedSDF | None = None,
                              compute_dtype=None) -> tuple:
    """A model, mask and frame a sequence: camera-frame vertices (S, ..., N, 3),
    S models, packed masks (S, H, ceil(W / 8)) of masks padded to hw, frames
    (S, 16) -> (sdf (S, ..., N), hit (S, ..., N)). The object-frame transform,
    the batched SDF MLP (`packed` from `pack_distilled_batched`), the pixel
    and the batched mask lookup: kernels #3b and #5b on the card, their plain
    versions on the CPU."""
    _check_batch(models, points)
    if points.dim() < 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (S, ..., N, 3), got {tuple(points.shape)}")
    sdf = fused_sdf_mlp_cf_batched(models, object_frame(points, frames), packed, compute_dtype)
    return sdf, packed_mask_lookup_batched(packed_masks, *pixel_coords(points, frames, hw), hw)
