"""MANO skinning fused with the per-vertex hand energy: the plain PyTorch
version and the dispatch to the CUDA kernel (csrc/hand_energy_skin.cu,
kernel wrapper in ops/kernels.py).

Replaces hotrack_tpu/ops/pallas/hand_energy_skin.py
(`fused_hand_energy_skin`, `skin_reference`, and `_skin_impl_batched`, which
JAX's `vmap` reaches when several sequences are tracked, each with its shape,
object pose, mask and model: `fused_hand_energy_skin_batched` here). Per
candidate p and vertex v:

    vp   = v_shaped[v] + posedirs[v] @ pose_map[p]          (135 terms a coordinate)
    R|t  = sum_j weights[v, j] * [r_all | t_rel][p, j]      (16 joints, 12 numbers)
    x    = R vp + t + offset[p]                             the camera-frame vertex
    sdf, hit = the per-vertex energy of ops/hand_energy.py at x

which is `mano_forward`'s linear blend skinning followed by
`fused_hand_energy`, with the 5120 x 778 vertices never written to device
memory. The per-candidate inputs come from `mano.layer.mano_skin_inputs`,
the per-call constants from `skin_consts` below (vertex-minor layouts, so
neighbouring threads read neighbouring addresses). This is the hand pose
optimiser's default route (`hand_energy: skin`). Not carried over from the
TPU: the 778 -> 896 lane padding, the particle tiles and their role-major
slab, padding P by repeating particle 0.

The kernel sums a vertex in ascending index order with fused multiply-adds;
the plain version's einsums sum in the library's order. So the vertices
agree to float32 rounding (1e-6 m), `sdf` to the MLP's bound, and `hit`
wherever the plain version's pixel coordinate is not within that rounding
of an integer.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, `_hand_energy_skin_torch`, which is also the kernel's oracle.
Bound on the card: operations (the MLP's, plus 1,212 a vertex of skinning).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mano.model import ManoModel
from . import kernels
from .hand_energy import _hand_energy_torch
from .sdf_mlp import PackedSDF, _check_batch, pack_distilled, pack_distilled_batched


class SkinConsts(NamedTuple):
    """What is constant over an optimiser call, vertex-minor."""

    posedirs_cf: torch.Tensor   # (3, 135, N)
    vshaped_cf: torch.Tensor    # (3, N); (S, 3, N) with a shape a sequence
    weights_t: torch.Tensor     # (16, N)


def skin_consts(model: ManoModel, shaped, batched: bool = False) -> SkinConsts:
    """The per-call constants of the fused kernel from the rig and a
    `shape_hand` result of batch 1, or with `batched` of batch S (a shape a
    sequence: vshaped_cf (S, 3, N); the rig's tables are shared)."""
    v_shaped = shaped[0]
    if not batched and v_shaped.shape[0] != 1:
        raise ValueError(f"skin_consts takes one shape, got v_shaped {tuple(v_shaped.shape)}")
    vshaped_cf = v_shaped.transpose(1, 2) if batched else v_shaped[0].transpose(0, 1)
    return SkinConsts(model.posedirs.permute(1, 2, 0).contiguous(), vshaped_cf.contiguous(),
                      model.weights.transpose(0, 1).contiguous())


def skin_reference(pose_map: torch.Tensor, rt_flat: torch.Tensor, offset: torch.Tensor,
                   consts: SkinConsts) -> torch.Tensor:
    """The vertices the fused kernel builds, by library products: (B, N, 3)
    camera-frame. The JAX package's `skin_reference`, channels-last."""
    b = pose_map.shape[0]
    vp = torch.einsum("bp,cpv->bcv", pose_map, consts.posedirs_cf) + consts.vshaped_cf
    skin = torch.matmul(rt_flat, consts.weights_t).reshape(b, 12, -1)   # (B, 12, N)
    r = skin[:, :9].reshape(b, 3, 3, -1)
    verts = torch.einsum("bcyv,byv->bcv", r, vp) + skin[:, 9:] + offset[:, :, None]
    return verts.transpose(1, 2)


@torch.no_grad()
def _hand_energy_skin_torch(model, packed_mask: torch.Tensor, frame: torch.Tensor,
                            pose_map: torch.Tensor, rt_flat: torch.Tensor,
                            offset: torch.Tensor, consts: SkinConsts, hw) -> tuple:
    """Plain version: `skin_reference`, then the plain per-vertex energy."""
    verts = skin_reference(pose_map, rt_flat, offset, consts)
    return _hand_energy_torch(model, packed_mask, frame, verts, hw)


def fused_hand_energy_skin(model, packed_mask: torch.Tensor, frame: torch.Tensor,
                           pose_map: torch.Tensor, rt_flat: torch.Tensor,
                           offset: torch.Tensor, consts: SkinConsts, hw,
                           packed: PackedSDF | None = None) -> tuple:
    """Per-candidate (pose_map (B, 135), rt_flat (B * 12, 16), offset (B, 3))
    from `mano_skin_inputs` and the per-call `skin_consts` -> (sdf (B, N),
    hit (B, N)). frame: ops/hand_energy.hand_frame; packed_mask: `pack_mask`
    of the (H, W) = hw background mask."""
    if pose_map.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.hand_energy_skin_cuda(
            pose_map.contiguous(), rt_flat.contiguous(), offset.contiguous(),
            *consts, frame, packed_mask, hw, packed)
    if pose_map.device.type != "cpu":
        raise ValueError(f"no fused hand energy for device {pose_map.device}")
    return _hand_energy_skin_torch(model, packed_mask, frame, pose_map, rt_flat, offset,
                                   consts, hw)


@torch.no_grad()
def _hand_energy_skin_batched_torch(models, packed_masks: torch.Tensor, frames: torch.Tensor,
                                    pose_map: torch.Tensor, rt_flat: torch.Tensor,
                                    offset: torch.Tensor, consts: SkinConsts, hw) -> tuple:
    """Plain version of the batched kernel: the unbatched plain version on
    each sequence's candidates, shape, frame, mask and model."""
    out = [_hand_energy_skin_torch(models[s], packed_masks[s], frames[s], pose_map[s],
                                   rt_flat[s], offset[s],
                                   consts._replace(vshaped_cf=consts.vshaped_cf[s]), hw)
           for s in range(len(models))]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def fused_hand_energy_skin_batched(models, packed_masks: torch.Tensor, frames: torch.Tensor,
                                   pose_map: torch.Tensor, rt_flat: torch.Tensor,
                                   offset: torch.Tensor, consts: SkinConsts, hw,
                                   packed: PackedSDF | None = None) -> tuple:
    """S sequences at once: per candidate pose_map (S, P, 135), rt_flat
    (S, P * 12, 16), offset (S, P, 3); `skin_consts(..., batched=True)` of
    the S shapes; frames (S, 16), packed masks (S, H, ceil(W / 8)) of masks
    padded to hw, S models -> (sdf (S, P, N), hit (S, P, N)). On the card one
    launch of the kernel on a (pairs, S) grid (`packed` from
    `pack_distilled_batched`), sequence s bitwise what the unbatched kernel
    gives on its inputs; on the CPU the plain version."""
    _check_batch(models, pose_map)
    if pose_map.dim() != 3 or consts.vshaped_cf.dim() != 3:
        raise ValueError(f"pose_map must be (S, P, 135) beside vshaped_cf (S, 3, N), got "
                         f"{tuple(pose_map.shape)} and {tuple(consts.vshaped_cf.shape)}")
    if pose_map.is_cuda:
        packed = packed if packed is not None else pack_distilled_batched(models)
        return kernels.hand_energy_skin_batched_cuda(
            pose_map.contiguous(), rt_flat.contiguous(), offset.contiguous(), *consts, frames,
            packed_masks, hw, packed)
    if pose_map.device.type != "cpu":
        raise ValueError(f"no fused hand energy for device {pose_map.device}")
    return _hand_energy_skin_batched_torch(models, packed_masks, frames, pose_map, rt_flat,
                                           offset, consts, hw)
