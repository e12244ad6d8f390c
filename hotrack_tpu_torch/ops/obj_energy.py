"""Fused object-pose SDF energy: the plain PyTorch version and the dispatch
to the CUDA kernel (csrc/obj_energy.cu, kernel wrapper in ops/kernels.py).

Replaces hotrack_tpu/ops/pallas/obj_energy.py (`fused_obj_sdf_energy`, and
`_obj_impl_batched`, which JAX's `vmap` reaches with a model a sequence:
`fused_obj_sdf_energy_batched` here): for every candidate pose p,

    out[p] = sum over n of | SDF( R_p^T x_n - R_p^T t_p ) |

over the observed cloud x (3, N), with the distilled-SDF MLP of
ops/sdf_mlp.py. The object pose optimiser calls it with 2048 candidates on
1024 points, 10 times a frame; divide by N for its mean-|sdf| energy. On the
card the transformed cloud (P, 3, N) and the (P, N) sdf never reach device
memory, and the sum over N is taken in a fixed order with no atomics: two
launches agree bitwise.

Bound on the card: operations (P * N * 71,168 float32 operations at the
shipped net, 149.2 GFLOP at 2048 x 1024, against 116 KB of traffic).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, `_obj_sdf_energy_torch`, which is also the kernel's oracle.
"""

from __future__ import annotations

import torch

from . import kernels
from .sdf_mlp import (PLAIN_CHUNK, PackedSDF, _check_batch, _sdf_mlp_torch, pack_distilled,
                      pack_distilled_batched)


def obj_rts(rotations: torch.Tensor, translations: torch.Tensor) -> torch.Tensor:
    """Per candidate (R (..., P, 3, 3), t (..., P, 3, 1) or (..., P, 3)) ->
    rts (..., P, 12): the row-major R^T followed by R^T t."""
    lead = rotations.shape[:-2]
    rot_t = rotations.transpose(-1, -2)
    t = translations.reshape(*lead, 3, 1)
    rt = torch.matmul(rot_t, t)[..., 0]
    return torch.cat([rot_t.reshape(*lead, 9), rt], dim=-1)


@torch.no_grad()
def _obj_sdf_energy_torch(model, pcld_cf: torch.Tensor, rts: torch.Tensor,
                          chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version: pcld_cf (3, N), rts (P, 12) -> (P,) sums of |sdf|.
    The transform is summed as the kernels sum it, ((-rt_c + r_c0 x) + r_c1 y)
    + r_c2 z; candidates go through `chunk` points at a time."""
    p, n = rts.shape[0], pcld_cf.shape[1]
    r = rts[:, :9].reshape(p, 3, 3, 1)
    out = torch.empty(p, dtype=pcld_cf.dtype, device=pcld_cf.device)
    step = max(1, chunk // n)
    for lo in range(0, p, step):
        rr = r[lo:lo + step]
        obj = -rts[lo:lo + step, 9:, None]                      # (p', 3, 1)
        for y in range(3):
            obj = obj + rr[:, :, y] * pcld_cf[y]                # (p', 3, N)
        sdf = _sdf_mlp_torch(model, obj, chunk)
        out[lo:lo + step] = torch.sum(torch.abs(sdf), dim=-1)
    return out


def fused_obj_sdf_energy(model, pcld_cf: torch.Tensor, rotations: torch.Tensor,
                         translations: torch.Tensor,
                         packed: PackedSDF | None = None) -> torch.Tensor:
    """Sum over n of |clamped SDF(R_p^T (x_n - t_p))| per candidate pose ->
    (P,). pcld_cf: the observed cloud channels-first (3, N) float32;
    rotations (P, 3, 3); translations (P, 3) or (P, 3, 1)."""
    if pcld_cf.dim() != 2 or pcld_cf.shape[0] != 3:
        raise ValueError(f"pcld_cf must be (3, N), got {tuple(pcld_cf.shape)}")
    rts = obj_rts(rotations, translations)
    if pcld_cf.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.obj_sdf_energy_cuda(pcld_cf.contiguous(), rts.contiguous(), packed)
    if pcld_cf.device.type != "cpu":
        raise ValueError(f"no object energy for device {pcld_cf.device}")
    return _obj_sdf_energy_torch(model, pcld_cf, rts)


def _obj_sdf_energy_batched_torch(models, pcld_cf: torch.Tensor,
                                  rts: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched kernel: the unbatched plain version on
    each sequence's cloud (S, 3, N) and candidates (S, P, 12) -> (S, P)."""
    return torch.stack([_obj_sdf_energy_torch(m, c, r) for m, c, r in zip(models, pcld_cf, rts)])


def fused_obj_sdf_energy_batched(models, pcld_cf: torch.Tensor, rotations: torch.Tensor,
                                 translations: torch.Tensor,
                                 packed: PackedSDF | None = None) -> torch.Tensor:
    """A model a sequence: pcld_cf (S, 3, N), rotations (S, P, 3, 3),
    translations (S, P, 3) or (S, P, 3, 1) and S models -> (S, P) sums of
    |sdf|. On the card one launch on a (P, S) grid (`packed` from
    `pack_distilled_batched`); on the CPU the plain version."""
    _check_batch(models, pcld_cf)
    if pcld_cf.dim() != 3 or pcld_cf.shape[1] != 3 or rotations.shape[0] != pcld_cf.shape[0]:
        raise ValueError(f"pcld_cf must be (S, 3, N) beside rotations (S, P, 3, 3), got "
                         f"{tuple(pcld_cf.shape)} and {tuple(rotations.shape)}")
    rts = obj_rts(rotations, translations)
    if pcld_cf.is_cuda:
        packed = packed if packed is not None else pack_distilled_batched(models)
        return kernels.obj_sdf_energy_batched_cuda(pcld_cf.contiguous(), rts.contiguous(),
                                                   packed)
    if pcld_cf.device.type != "cpu":
        raise ValueError(f"no object energy for device {pcld_cf.device}")
    return _obj_sdf_energy_batched_torch(models, pcld_cf, rts)
