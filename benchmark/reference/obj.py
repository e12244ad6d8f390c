"""Plain reference of the object pose optimiser: the gradient-free particle
search of the paper's object tracker (arXiv:2209.12009), in float32 PyTorch.

Per frame, from the last frame's pose (R, t): `iterations` rounds of
  - candidates: the fixed bank (P, 6), row 0 zero ("no change"), scaled by
    the search size; a candidate's quaternion is (sqrt(1 - |q|^2), q) and its
    pose (R q_R, t + dt);
  - energy: 500 x the mean over the cloud of |SDF(R_p^T (x - t_p))|;
  - candidates strictly better than row 0 weighted by their improvement;
    their weighted mean delta (its quaternion normalised) applied to the
    pose, the rotation put back on SO(3) by Gram-Schmidt of its first two
    rows; nothing applied where none is better;
  - the search size from the weighted raw energy and the mean delta's
    direction, with momentum 0.9 over consecutive successes.
Returns the pose and the last round's weighted raw energy. Any number of
independent items at once: a leading batch axis B of clouds and poses.
"""

from __future__ import annotations

import torch

from . import sdf as ref_sdf

SEARCH0 = 0.02     # initial search size
GAIN = 2.0         # search-size gain
BETA = 0.9         # search-size momentum
WEIGHT_EPS = 1e-5
ENERGY_SCALE = 500.0


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    m = torch.stack([1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
                     2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
                     2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
                    dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def _unit(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mag = torch.linalg.norm(v, dim=-1, keepdim=True)
    out = v / torch.clamp(mag, min=eps)
    backup = torch.zeros_like(v)
    backup[..., 0] = 1.0
    return torch.where(mag > eps, out, backup)


def reproject(r: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt of the rotation's first two rows, back onto SO(3)."""
    a, b = r[..., 0, :], r[..., 1, :]
    x = _unit(a)
    z = _unit(torch.linalg.cross(x, b, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def energies(model, clouds: torch.Tensor, rot: torch.Tensor,
             trans: torch.Tensor) -> torch.Tensor:
    """Mean |SDF| of each item's cloud (B, N, 3) in each candidate's object
    frame: rot (B, P, 3, 3), trans (B, P, 3) -> (B, P)."""
    out = []
    for b in range(clouds.shape[0]):
        local = torch.matmul(clouds[b][None] - trans[b][:, None, :], rot[b])   # (P, N, 3)
        out.append(torch.mean(torch.abs(ref_sdf.sdf(model, local)), dim=-1))
    return torch.stack(out)


@torch.no_grad()
def optimise(model, bank: torch.Tensor, clouds: torch.Tensor, rotation: torch.Tensor,
             translation: torch.Tensor, iterations: int = 10):
    """clouds (B, N, 3), rotation (B, 3, 3), translation (B, 3) ->
    (rotation (B, 3, 3), translation (B, 3), energy (B,))."""
    n_items = clouds.shape[0]
    search = torch.full((n_items, bank.shape[1]), SEARCH0, dtype=torch.float32,
                        device=bank.device)
    prev_search = search
    prev_success = torch.ones(n_items, dtype=torch.bool, device=bank.device)
    mean_raw = torch.zeros(n_items, device=bank.device)
    r, t = rotation, translation
    for _ in range(iterations):
        scaled = bank[None] * search[:, None, :]                               # (B, P, 6)
        qw = torch.sqrt(torch.clamp(1.0 - torch.sum(scaled[..., :3] ** 2, -1), min=0.0))
        ext = torch.cat([qw[..., None], scaled], dim=-1)                       # (B, P, 7)
        cand_r = torch.matmul(r[:, None], quat_to_matrix(ext[..., :4]))
        cand_t = t[:, None] + ext[..., 4:]
        raw = energies(model, clouds, cand_r, cand_t)
        energy = raw * ENERGY_SCALE
        better = energy < energy[:, :1]
        weight = torch.where(better, energy[:, :1] - energy, torch.zeros_like(energy))
        weight_sum = weight.sum(-1) + WEIGHT_EPS
        success = better.any(-1)
        mean_raw = torch.where(success, (raw * weight).sum(-1) / weight_sum, raw[:, 0])
        mean = (ext * weight[..., None]).sum(1) / weight_sum[:, None]
        q = mean[:, :4] / (torch.linalg.norm(mean[:, :4], dim=-1, keepdim=True) + 1e-8)
        mean = torch.where(success[:, None], torch.cat([q, mean[:, 4:]], -1),
                           torch.zeros_like(mean))
        new_r = reproject(torch.matmul(r, quat_to_matrix(mean[:, :4])))
        r = torch.where(success[:, None, None], new_r, r)
        t = torch.where(success[:, None], t + mean[:, 4:], t)
        s = torch.abs(mean[:, 1:]) + 1e-3
        new_search = mean_raw[:, None] * GAIN * s / torch.linalg.norm(s, dim=-1,
                                                                      keepdim=True) + 1e-3
        both = (prev_success & success)[:, None]
        search = torch.where(both, BETA * new_search + (1 - BETA) * prev_search, new_search)
        prev_search = torch.where(success[:, None], search, prev_search)
        prev_success = success
    return r, t, mean_raw
