"""The general generator: every input of a run, made on the device from the
run's seed and the parameters of a configuration and a traffic mix.

Synthetic SimGrasp-like sequences (the real set is licensed): a box object
whose pose follows a smooth random walk (the configuration's rotation and
translation steps a frame, smoothed by 0.9, about 0.5 m in front of the
camera), observed as `points` fresh surface points a frame with 1 mm noise.
The same seed gives the same inputs; every seed gives inputs of the same
sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed (any
    non-negative integer, 64 bits or more)."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, seed >> 64, *[int(p) for p in path]]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *path) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *path))


def rodrigues(rv: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (..., 3) -> matrices (..., 3, 3)."""
    angle = torch.linalg.norm(rv, dim=-1, keepdim=True).clamp(min=1e-12)
    kx, ky, kz = (rv / angle).unbind(-1)
    zero = torch.zeros_like(kx)
    km = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero], -1).reshape(
        *rv.shape[:-1], 3, 3)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device).expand_as(km)
    return eye + s * km + (1 - c) * (km @ km)


def smooth_walk(g: torch.Generator, n: int, frames: int, dim: int, scale: float,
                smoothing: float = 0.9) -> torch.Tensor:
    """(n, frames, dim) random walks from 0 whose steps are smoothed noise."""
    noise = torch.randn((n, frames, dim), generator=g, device=g.device) * scale
    out = torch.zeros_like(noise)
    v = torch.zeros_like(noise[:, 0])
    for t in range(1, frames):
        v = smoothing * v + noise[:, t]
        out[:, t] = out[:, t - 1] + v
    return out


def box_surface(g: torch.Generator, shape: tuple, half) -> torch.Tensor:
    """(*shape, 3) points uniform on the faces of a box of half-extents half."""
    half_t = torch.tensor(half, dtype=torch.float32, device=g.device)
    pts = (torch.rand((*shape, 3), generator=g, device=g.device) * 2 - 1) * half_t
    face = torch.randint(0, 3, shape, generator=g, device=g.device)
    sign = torch.randint(0, 2, shape, generator=g, device=g.device).float() * 2 - 1
    on_face = torch.nn.functional.one_hot(face, 3).bool()
    return torch.where(on_face, sign[..., None] * half_t, pts)


def object_sequences(g: torch.Generator, n_seq: int, frames: int, points: int,
                     motion: dict, half) -> dict:
    """n_seq sequences of the object: its pose a frame (rotation (n, T, 3, 3),
    translation (n, T, 3)) and its observed cloud (n, T, points, 3)."""
    dev = g.device
    rv = smooth_walk(g, n_seq, frames, 3, motion["rot_step"]) \
        + torch.randn((n_seq, 1, 3), generator=g, device=dev) * 0.5
    base = torch.tensor([0.0, 0.0, 0.5], device=dev) \
        + torch.randn((n_seq, 1, 3), generator=g, device=dev) * 0.05
    tr = smooth_walk(g, n_seq, frames, 3, motion["trans_step"]) + base
    rot = rodrigues(rv)
    local = box_surface(g, (n_seq, frames, points), half)
    cloud = torch.matmul(local, rot.transpose(-1, -2)) + tr[:, :, None] \
        + torch.randn((n_seq, frames, points, 3), generator=g, device=dev) * motion["noise"]
    return {"rotation": rot, "translation": tr, "cloud": cloud}


def jittered_start(g: torch.Generator, rotation: torch.Tensor, translation: torch.Tensor,
                   jitter: dict) -> tuple:
    """Frame 0's pose (n, 3, 3), (n, 3) jittered: a rotation of N(0, r deg)
    about each axis, a translation of N(0, t m) along each."""
    n = rotation.shape[0]
    rv = torch.randn((n, 3), generator=g, device=g.device) * math.radians(jitter["r_deg"])
    dt = torch.randn((n, 3), generator=g, device=g.device) * jitter["t_m"]
    return torch.matmul(rotation, rodrigues(rv)), translation + dt


def particle_bank(g: torch.Generator, particles: int, dim: int) -> torch.Tensor:
    """The fixed unit-Gaussian bank (P, dim), row 0 zero ("no change")."""
    bank = torch.randn((particles, dim), generator=g, device=g.device)
    bank[0] = 0.0
    return bank
