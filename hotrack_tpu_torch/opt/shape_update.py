"""Online DeepSDF shape-code refinement from tracked observations (port of
hotrack_tpu/opt/shape_update.py).

After each frame's pose solve the object runner keeps the observed points
whose |SDF| is below 2 cm, moves them into the DeepSDF instance frame and
mixes them into a fixed-size merged cloud (`merge_observations`: 1/merge_num
of the buffer is replaced), with normals from local PCA oriented toward the
camera (`estimate_normals`). Every 10 merges `update_shape` refines the latent
code by Adam against pseudo-SDF samples along the normals: outside p + n
U(0, 0.1) at +mu, the surface at 0, inside p - n U(0, 0.05) at -mu; a soft L1
clamped to +-0.2 with the weight 1 + 0.5 sign(gt) sign(gt - pred), plus
1e-4 of the code's mean square; lr 1e-3, halved from the halfway iteration.

Adam is written out as the JAX package inlines it (bias correction with a
float32 step count), not `torch.optim.Adam`, whose arithmetic rounds
otherwise. Every random number comes from an explicit `torch.Generator`, or,
for the tests, from injected draws.
"""

from __future__ import annotations

import torch

from ..ops.pointops import knn_point

B1, B2, EPS = 0.9, 0.999, 1e-8


def estimate_normals(points: torch.Tensor, camera: torch.Tensor, k: int = 30) -> torch.Tensor:
    """Local-PCA normals oriented toward the camera: points (N, 3), camera
    (3,) -> normals (N, 3). A point's neighbourhood is its k nearest points,
    itself included (ties to the lower index); the normal is the covariance's
    eigenvector of the smallest eigenvalue, flipped to face the camera."""
    _, idx = knn_point(k, points[None], points[None])
    nbrs = points[idx[0]]                                   # (N, k, 3)
    centered = nbrs - torch.mean(nbrs, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    _, eigvecs = torch.linalg.eigh(cov)                     # ascending
    normals = eigvecs[..., 0]
    toward = torch.sum(normals * (camera - points), dim=-1, keepdim=True)
    one = torch.ones((), dtype=points.dtype, device=points.device)
    return normals * torch.where(toward > 0, one, -one)


def update_shape(decoder, latent: torch.Tensor, obj_pc: torch.Tensor, normals: torch.Tensor,
                 generator: torch.Generator | None = None, num_iterations: int = 100,
                 clamp_dist: float = 0.2, lr: float = 1e-3, l2reg: bool = True,
                 draws: list | None = None) -> torch.Tensor:
    """Refine the latent code against pseudo-SDF samples of the merged cloud;
    returns the new latent (latent's shape flattened). obj_pc, normals (N, 3)
    in the DeepSDF instance frame. `decoder` must be in eval mode (its dropout
    off, as the JAX decoder's apply is deterministic); the gradient goes to
    the latent only. `draws`: num_iterations pairs (mu_pos, mu_neg) instead of
    the generator's."""
    if decoder.training:
        raise ValueError("update_shape needs the decoder in eval mode (no dropout)")
    n = obj_pc.shape[0]
    lat = latent.reshape(-1).detach().clone()
    dim = lat.shape[0]
    if draws is not None and len(draws) != num_iterations:
        raise ValueError(f"{len(draws)} draws for {num_iterations} iterations")
    f = dict(dtype=obj_pc.dtype, device=obj_pc.device)
    gen = dict(generator=generator, dtype=obj_pc.dtype,
               device=generator.device if generator is not None else "cpu")
    m, v = torch.zeros_like(lat), torch.zeros_like(lat)
    zeros = torch.zeros((n,), **f)
    for e in range(num_iterations):
        if draws is None:   # on the generator's device, then moved
            mu_pos = torch.rand((n, 1), **gen).to(obj_pc.device) * 0.1
            mu_neg = torch.rand((n, 1), **gen).to(obj_pc.device) * 0.05
        else:
            mu_pos, mu_neg = (torch.as_tensor(d, **f) for d in draws[e])
        with torch.enable_grad():
            lat_g = lat.requires_grad_(True)
            xyz = torch.cat([obj_pc + normals * mu_pos, obj_pc, obj_pc - normals * mu_neg])
            sdf_gt = torch.clamp(torch.cat([mu_pos[:, 0], zeros, -mu_neg[:, 0]]),
                                 -clamp_dist, clamp_dist)
            inp = torch.cat([lat_g.expand(xyz.shape[0], dim), xyz], dim=-1)
            pred = torch.clamp(decoder(inp)[:, 0], -clamp_dist, clamp_dist)
            loss = torch.clamp(torch.abs(pred - sdf_gt), 0.0, 100.0)
            loss = loss * (1.0 + 0.5 * torch.sign(sdf_gt) * torch.sign(sdf_gt - pred))
            total = torch.mean(loss)
            if l2reg:
                total = total + 1e-4 * torch.mean(lat_g ** 2)
            (g,) = torch.autograd.grad(total, lat_g)
        lat = lat.detach()
        cur_lr = lr / 2.0 if e >= num_iterations // 2 else lr
        m = B1 * m + (1 - B1) * g
        v = B2 * v + (1 - B2) * g ** 2
        t = torch.tensor(e + 1, dtype=torch.float32, device=lat.device).to(lat.dtype)
        one = torch.ones((), dtype=lat.dtype, device=lat.device)
        mhat = m / (1 - (B1 * one) ** t)
        vhat = v / (1 - (B2 * one) ** t)
        lat = lat - cur_lr * mhat / (torch.sqrt(vhat) + EPS)
    return lat


def merge_observations(merged_pc: torch.Tensor, merged_normals: torch.Tensor,
                       new_pc: torch.Tensor, new_normals: torch.Tensor,
                       new_valid: torch.Tensor, merge_num: int,
                       generator: torch.Generator | None = None, draws: tuple | None = None):
    """Mix a frame's instance-frame observations into the fixed-size merged
    buffer: int(n / merge_num) of its n slots, those whose rank in a random
    permutation is lowest, take random valid new points. merged_pc/normals
    (n, 3); new_pc/normals (M, 3) with validity new_valid (M,); merge_num
    counts this merge. `draws`: (candidate indices (n,), permutation (n,))
    instead of the generator's. Returns (merged_pc, merged_normals)."""
    n = merged_pc.shape[0]
    choose = int(n / merge_num)
    if draws is None:   # on the generator's device
        gen_device = generator.device if generator is not None else "cpu"
        w = new_valid.to(device=gen_device, dtype=torch.float32) + 1e-9
        draws = (torch.multinomial(w / torch.sum(w), n, replacement=True, generator=generator),
                 torch.randperm(n, generator=generator, device=gen_device))
    new_idx, slot_order = draws
    new_idx = torch.as_tensor(new_idx, device=new_pc.device).long()
    ranks = torch.argsort(torch.as_tensor(slot_order, device=new_pc.device))
    replace = (ranks < choose)[:, None]
    return (torch.where(replace, new_pc[new_idx], merged_pc),
            torch.where(replace, new_normals[new_idx], merged_normals))
