"""MANO shape (beta) optimiser from predicted keypoint bone lengths (port of
hotrack_tpu.opt.hand_shape).

20 iterations x 5120 particles over the 10-d beta; the energy is the mean
|bone-length difference| between a candidate shape's rest-pose bones and the
rows of predicted bone lengths it is given (one row, or a history of rows:
accumulating them across re-optimisations is the caller's concern). S
sequences at once take lengths (S, H, 15) and give shapes (S, 1, 10), the
stack of the single sequence's (1, 10), with the bank shared.
"""

from __future__ import annotations

import math

import torch

from ..mano.layer import mano_forward
from ..mano.model import ManoModel
from .particle import ParticleSpec, run_particle_opt

SHAPE_SPEC = ParticleSpec(iterations=20, scaling_coefficient2=2000.0, beta=0.9)
INITIAL_SCALE = 5.0

# the 15 non-tip bones of the 21-keypoint skeleton and their parents
BONE_IDX = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19)
BONE_PARENT = (0, 1, 2, 0, 5, 6, 0, 9, 10, 0, 13, 14, 0, 17, 18)


def kp2length(kp: torch.Tensor) -> torch.Tensor:
    """(..., 21, 3) keypoints -> (..., 15) bone lengths."""
    bones = kp[..., list(BONE_IDX), :] - kp[..., list(BONE_PARENT), :]
    return torch.linalg.norm(bones, dim=-1)


@torch.no_grad()
def optimize_hand_shape(
    mano_model: ManoModel,
    presampled: torch.Tensor,                # (P, 10) fixed particle bank
    pred_lengths: torch.Tensor,              # (H, 15) bone-length targets; (S, H, 15)
    init_shape: torch.Tensor | None = None,  # (1, 10), default zeros; (S, 1, 10)
    iterations: int = SHAPE_SPEC.iterations,
    trace: list | None = None,
):
    """Returns (hand_shape (1, 10), final_energy ()), or for S sequences
    ((S, 1, 10), (S,)). All tensors on one device; nothing here waits for
    the device."""
    spec = SHAPE_SPEC._replace(iterations=iterations)
    batch = tuple(pred_lengths.shape[:-2])
    p = presampled.shape[0]
    like = dict(dtype=presampled.dtype, device=presampled.device)
    if init_shape is None:
        init_shape = torch.zeros((*batch, 1, 10), **like)
    zero_pose = torch.zeros((math.prod(batch) * p, 48), **like)

    def energy_fn(params, sample_ext):
        betas = params[0] + sample_ext  # (*b, P, 10)
        _, kp = mano_forward(mano_model, zero_pose, betas=betas.reshape(-1, 10))
        lengths = kp2length(kp).reshape(*batch, p, 1, 15)
        diff = torch.abs(lengths - pred_lengths[..., None, :, :])
        energy = torch.mean(diff, dim=(-1, -2))
        return energy, energy

    def apply_mean(params, mean_ext):
        return (params[0] + mean_ext[..., None, :],)

    (shape,), last_energy = run_particle_opt(
        spec, presampled, INITIAL_SCALE, (init_shape,), energy_fn, apply_mean,
        trace=trace, batch=batch)
    return shape, last_energy
