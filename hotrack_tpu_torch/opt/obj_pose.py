"""Object 6-DoF pose optimiser: gradient-free particle search over an SDF
(port of hotrack_tpu.opt.obj_pose).

Per frame: 10 iterations x 2048 particles; each particle perturbs the
current pose by a small quaternion and a translation; the energy is the mean
|SDF| of the observed cloud transformed into the object frame, x500; the
particles better than "no change" are averaged and applied, and the rotation
is put back onto SO(3) by ortho-6d Gram-Schmidt.

Three energy routes:

- `distilled` given, obj_energy 'fused' (the default): one call of
  ops/obj_energy.fused_obj_sdf_energy per iteration; on the card that is the
  kernel of csrc/obj_energy.cu, and the transformed cloud and the (P, N) sdf
  never reach device memory;
- `distilled` given, obj_energy 'composed': `torch.matmul` into (P, 3, N),
  `eval_distilled_sdf_cf` (on the card the kernel of csrc/sdf_mlp.cu), mean
  of |sdf|;
- no `distilled`: the trilinear volume lookup, with `bbox_min` derived from
  the grid (the reference's -0.2 at 201^3 x 2 mm).

Several sequences at once (the JAX package's `vmap` of this optimiser):
clouds (S, N, 3), poses (S, 3, 3) and (S, 3, 1), a volume (S, V, V, V) or a
list of S distilled models, with the shared bank; the routes become the
batched kernels #4b (fused) and #3b (composed) and a trilinear lookup in each
sequence's own volume.
"""

from __future__ import annotations

import torch

from ..ops.obj_energy import fused_obj_sdf_energy, fused_obj_sdf_energy_batched
from ..ops.sdf_mlp import fused_sdf_mlp_cf_batched, pack_distilled, pack_distilled_batched
from ..pose.rotations import (
    compute_rotation_matrix_from_ortho6d,
    unit_quaternion_to_matrix,
)
from ..sdf.distill import eval_distilled_sdf_cf
from ..sdf.volume import trilinear_sdf
from .particle import (
    ParticleSpec,
    normalize_quat_head,
    quat_extend,
    run_particle_opt,
)

OBJ_SPEC = ParticleSpec(iterations=10, scaling_coefficient2=2.0, beta=0.9,
                        weight_eps=1e-5)
SCALING_COEFFICIENT1 = 0.02  # initial search size
OBJ_ENERGY_ROUTES = ("fused", "composed")


def _reproject_so3(r: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt the first two rows back onto SO(3): ortho6d of
    reshape(9)[:6], transposed. Returned contiguous: a library matrix product
    may round a transposed operand's sums in another order, and the pose of
    one frame is the next frame's input."""
    return compute_rotation_matrix_from_ortho6d(
        r.reshape(*r.shape[:-2], 9)[..., :6]).transpose(-1, -2).contiguous()


def _trilinear_batched(volumes: torch.Tensor, points: torch.Tensor, voxel_scale: float,
                       bbox_res: int) -> torch.Tensor:
    """`trilinear_sdf` of each sequence's points (S, ...) in its own volume."""
    return torch.stack([trilinear_sdf(v, p, voxel_scale, bbox_res,
                                      bbox_min=-(bbox_res // 2) * voxel_scale)
                        for v, p in zip(volumes, points)])


@torch.no_grad()
def optimize_obj_pose(
    sdf_volume: torch.Tensor | None,  # (V, V, V) instance-frame SDF (volume route)
    presampled: torch.Tensor,         # (P, 6) fixed particle bank
    pcld: torch.Tensor,               # (N, 3) observed object points (camera frame)
    rotation: torch.Tensor,           # (3, 3) initial pose (the last frame's)
    translation: torch.Tensor,        # (3, 1)
    voxel_scale: float = 0.002,
    bbox_res: int = 201,
    iterations: int = OBJ_SPEC.iterations,
    distilled=None,                   # DistilledSDF: SDF queries through the MLP
    obj_energy: str = "fused",
    packed=None,                      # ops/sdf_mlp.PackedSDF of `distilled`
    trace: list | None = None,
):
    """Returns (rotation (3, 3), translation (3, 1), final sdf energy ()).
    All tensors on one device; nothing here waits for the device.

    S sequences at once: pcld (S, N, 3), rotation (S, 3, 3), translation
    (S, 3, 1), sdf_volume (S, V, V, V) or `distilled` a list of S models
    (`packed` then from `pack_distilled_batched`) -> (S, 3, 3), (S, 3, 1),
    (S,); the bank is shared."""
    if obj_energy not in OBJ_ENERGY_ROUTES:
        raise ValueError(f"obj_energy must be one of {OBJ_ENERGY_ROUTES}, "
                         f"got {obj_energy!r}")
    spec = OBJ_SPEC._replace(iterations=iterations)
    batch = tuple(pcld.shape[:-2])
    if distilled is not None and hasattr(distilled, "weights") == bool(batch):
        raise ValueError(f"clouds {tuple(pcld.shape)} take "
                         f"{'a list of models, one a sequence' if batch else 'one model'}")
    # the same values give the same result bitwise whatever layout they came in
    rotation, translation = rotation.contiguous(), translation.contiguous()
    n = pcld.shape[-2]
    pcld_t = pcld.transpose(-1, -2).contiguous()  # (*b, 3, N), once per frame
    if distilled is not None and packed is None and pcld.is_cuda:
        packed = (pack_distilled_batched if batch else pack_distilled)(distilled)

    def energy_fn(params, sample_ext):
        r, t = params
        new_r = torch.matmul(r.unsqueeze(-3), unit_quaternion_to_matrix(sample_ext[..., :4]))
        new_t = t.unsqueeze(-3) + sample_ext[..., 4:, None]  # (*b, P, 3, 1)
        if distilled is not None and obj_energy == "fused":
            fused = fused_obj_sdf_energy_batched if batch else fused_obj_sdf_energy
            sdf_energy = fused(distilled, pcld_t, new_r, new_t[..., 0], packed) / n
            return sdf_energy * 500.0, sdf_energy
        if distilled is not None:
            flat_cf = torch.matmul(new_r.transpose(-1, -2), pcld_t.unsqueeze(-3) - new_t)
            sdf = (fused_sdf_mlp_cf_batched(distilled, flat_cf, packed) if batch
                   else eval_distilled_sdf_cf(distilled, flat_cf, packed))  # (*b, P, N)
        else:
            flat = torch.matmul(pcld.unsqueeze(-3) - new_t.transpose(-1, -2), new_r)
            sdf = (_trilinear_batched(sdf_volume, flat, voxel_scale, bbox_res) if batch
                   else trilinear_sdf(sdf_volume, flat, voxel_scale, bbox_res,
                                      bbox_min=-(bbox_res // 2) * voxel_scale))
        sdf_energy = torch.mean(torch.abs(sdf), dim=-1)
        return sdf_energy * 500.0, sdf_energy

    def apply_mean(params, mean_ext):
        r, t = params
        r = _reproject_so3(torch.matmul(r, unit_quaternion_to_matrix(mean_ext[..., :4])))
        return r, t + mean_ext[..., 4:7, None]

    (rotation, translation), last_energy = run_particle_opt(
        spec, presampled, SCALING_COEFFICIENT1, (rotation, translation),
        energy_fn, apply_mean, extend_sample=quat_extend,
        postprocess_mean=normalize_quat_head, search_slice=lambda m: m[..., 1:],
        trace=trace, batch=batch)
    return rotation, translation, last_energy
