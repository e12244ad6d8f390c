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
"""

from __future__ import annotations

import torch

from ..ops.obj_energy import fused_obj_sdf_energy
from ..ops.sdf_mlp import pack_distilled
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
    All tensors on one device; nothing here waits for the device."""
    if obj_energy not in OBJ_ENERGY_ROUTES:
        raise ValueError(f"obj_energy must be one of {OBJ_ENERGY_ROUTES}, "
                         f"got {obj_energy!r}")
    spec = OBJ_SPEC._replace(iterations=iterations)
    # the same values give the same result bitwise whatever layout they came in
    rotation, translation = rotation.contiguous(), translation.contiguous()
    n = pcld.shape[0]
    pcld_t = pcld.transpose(0, 1).contiguous()  # (3, N), once per frame
    if distilled is not None and packed is None and pcld.is_cuda:
        packed = pack_distilled(distilled)

    def energy_fn(params, sample_ext):
        r, t = params
        new_r = torch.matmul(r, unit_quaternion_to_matrix(sample_ext[:, :4]))
        new_t = t[None] + sample_ext[:, 4:, None]  # (P, 3, 1)
        if distilled is not None and obj_energy == "fused":
            sums = fused_obj_sdf_energy(distilled, pcld_t, new_r, new_t[..., 0], packed)
            sdf_energy = sums / n
            return sdf_energy * 500.0, sdf_energy
        if distilled is not None:
            flat_cf = torch.matmul(new_r.transpose(-1, -2), pcld_t[None] - new_t)
            sdf = eval_distilled_sdf_cf(distilled, flat_cf, packed)  # (P, N)
        else:
            flat = torch.matmul(pcld[None] - new_t.transpose(-1, -2), new_r)
            sdf = trilinear_sdf(sdf_volume, flat, voxel_scale, bbox_res,
                                bbox_min=-(bbox_res // 2) * voxel_scale)
        sdf_energy = torch.mean(torch.abs(sdf), dim=-1)
        return sdf_energy * 500.0, sdf_energy

    def apply_mean(params, mean_ext):
        r, t = params
        r = _reproject_so3(torch.matmul(r, unit_quaternion_to_matrix(mean_ext[:4])))
        return r, t + mean_ext[4:7, None]

    (rotation, translation), last_energy = run_particle_opt(
        spec, presampled, SCALING_COEFFICIENT1, (rotation, translation),
        energy_fn, apply_mean, extend_sample=quat_extend,
        postprocess_mean=normalize_quat_head, search_slice=lambda m: m[1:],
        trace=trace)
    return rotation, translation, last_energy
