"""Shared gradient-free particle-optimiser machinery (port of
hotrack_tpu.opt.particle).

One update scheme serves all the reference's optimisers:

  1. scale a fixed pre-sampled Gaussian particle bank by the current
     per-dimension search size (particle 0 is pinned to zero: "no change");
  2. extend each scaled sample to its applied form (the pose optimisers
     prepend the derived quaternion w = sqrt(1 - |qxyz|^2));
  3. evaluate an energy for every candidate;
  4. keep the particles strictly better than particle 0, weight them by their
     improvement, and apply the weighted-mean extended delta;
  5. adapt the search size to the weighted energy and the mean delta's
     direction, with momentum 0.9 on consecutive successes; on failure the
     parameters stay as they were.

The loop body is branch-free, as in the JAX package: `torch.where` on the
success flag, a tensor that is never read on the host, so the loop enqueues
its iterations without waiting for the device.

Several sequences at once (the JAX package's `vmap` of an optimiser) are a
leading batch axis written out: `batch=(S,)` gives the search sizes (S, D),
the candidates (S, P, De), the energies (S, P) and the success flags (S,),
each sequence's parameters with a leading S; the bank (P, D) is shared, as
JAX closes over it. `batch=()` is the single sequence.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ParticleSpec(NamedTuple):
    """Static configuration of a particle optimiser."""

    iterations: int
    scaling_coefficient2: float      # search-size gain
    beta: float = 0.9                # search-size momentum
    weight_eps: float = 0.0          # added to the weight sum (obj opt: 1e-5)


def presample_particles(particle_size: int, dim: int,
                        generator: torch.Generator | None = None,
                        draw: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """The fixed unit-Gaussian particle bank (P, D) with particle 0 zeroed,
    on `device`. Drawn on the generator's device (a host generator gives the
    same bank for every device); `draw` (P, D) replaces the draw."""
    if draw is None:
        draw = torch.randn((particle_size, dim), generator=generator,
                           device=generator.device if generator is not None else None)
    p = torch.as_tensor(draw, dtype=torch.float32).clone().to(device)
    p[0] = 0.0
    return p


def quat_extend(scaled: torch.Tensor) -> torch.Tensor:
    """Prepend qw = sqrt(1 - qx^2 - qy^2 - qz^2) to (..., P, 3 + k) pose samples."""
    qw = torch.sqrt(torch.clamp(1.0 - torch.sum(scaled[..., :3] ** 2, dim=-1), min=0.0))
    return torch.cat([qw[..., None], scaled], dim=-1)


def normalize_quat_head(mean_ext: torch.Tensor) -> torch.Tensor:
    """Normalise the leading 4 components of (..., De)."""
    q = mean_ext[..., :4] / (torch.linalg.norm(mean_ext[..., :4], dim=-1, keepdim=True) + 1e-8)
    return torch.cat([q, mean_ext[..., 4:]], dim=-1)


def _per_batch(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-sequence flag (*batch) shaped to select whole parameters `like`
    (*batch, ...): a reshape, never a broadcast along another axis."""
    return flag.reshape(*flag.shape, *(1,) * (like.dim() - flag.dim()))


@torch.no_grad()
def run_particle_opt(
    spec: ParticleSpec,
    presampled: torch.Tensor,         # (P, D) fixed bank, row 0 == 0
    initial_scale,                    # scalar or (D,)
    params: tuple,                    # tuple of tensors: the current parameters
    energy_fn: Callable,              # (params, sample_ext (*b, P, De)) -> ((*b, P), (*b, P))
    apply_mean: Callable,             # (params, mean_ext (*b, De)) -> params
    extend_sample: Callable = lambda s: s,       # (*b, P, D) -> (*b, P, De)
    postprocess_mean: Callable | None = None,    # (*b, De) -> (*b, De)
    search_slice: Callable = lambda m: m,        # (*b, De) -> (*b, D)
    trace: list | None = None,
    batch: tuple = (),                # the leading batch shape b: () or (S,)
):
    """Run the shared particle loop; returns (params, last_mean_energy).

    `energy_fn` returns (energy, aux): the better-mask and the weights use
    `energy`, the search-size update the weighted `aux` (the object optimiser
    ranks on the x500 energy and adapts on the raw one). `trace`, a list,
    receives each iteration's (energy, success, mean_ext) tensors."""
    batch = tuple(batch)
    dim = presampled.shape[1]
    like = dict(dtype=presampled.dtype, device=presampled.device)
    search = torch.as_tensor(initial_scale, **like).expand(*batch, dim).clone()
    prev_search = search
    prev_success = torch.ones(batch, dtype=torch.bool, device=presampled.device)
    mean_aux = torch.zeros(batch, **like)

    for _ in range(spec.iterations):
        sample_ext = extend_sample(presampled * search[..., None, :])  # (*b, P, De)
        energy, aux = energy_fn(params, sample_ext)

        origin = energy[..., :1]
        better = energy < origin
        weight = torch.where(better, origin - energy, torch.zeros_like(energy))
        weight_sum = torch.sum(weight, dim=-1) + spec.weight_eps
        success = torch.any(better, dim=-1)
        safe_sum = torch.where(weight_sum > 0, weight_sum, torch.ones_like(weight_sum))

        mean_aux = torch.where(success, torch.sum(aux * weight, dim=-1) / safe_sum, aux[..., 0])
        mean_ext = torch.sum(sample_ext * weight[..., None], dim=-2) / safe_sum[..., None]
        if postprocess_mean is not None:
            mean_ext = postprocess_mean(mean_ext)
        mean_ext = torch.where(success[..., None], mean_ext, torch.zeros_like(mean_ext))
        if trace is not None:
            trace.append((energy, success, mean_ext))

        new_params = apply_mean(params, mean_ext)
        params = tuple(torch.where(_per_batch(success, old), new, old)
                       for new, old in zip(new_params, params))

        # search = E * c2 * |m| / ||m|| + 1e-3
        s = torch.abs(search_slice(mean_ext)) + 1e-3
        new_search = mean_aux[..., None] * spec.scaling_coefficient2 * s \
            / torch.linalg.norm(s, dim=-1, keepdim=True) + 1e-3
        both = torch.logical_and(prev_success, success)[..., None]
        search = torch.where(
            both, spec.beta * new_search + (1 - spec.beta) * prev_search, new_search)
        prev_search = torch.where(success[..., None], search, prev_search)
        prev_success = success
    return params, mean_aux
