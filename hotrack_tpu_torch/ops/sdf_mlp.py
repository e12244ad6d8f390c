"""Distilled-SDF MLP evaluation: the plain PyTorch version and the dispatch
to the CUDA kernel (csrc/sdf_mlp.cu, kernel wrapper in ops/kernels.py).

Replaces hotrack_tpu/ops/pallas/sdf_mlp.py (`fused_sdf_mlp`,
`fused_sdf_mlp_cf`, and `_cf_impl_batched`, which JAX's `vmap` reaches with
a model a sequence: `fused_sdf_mlp_batched` / `fused_sdf_mlp_cf_batched`
here, with the S models packed into one (S, n) buffer). Per point: Fourier
features s*x | sin(f*s*x) | cos(f*s*x) (axis-major, frequency-minor; 3 + 6F
values) -> Dense + ReLU hidden layers -> Dense to one value -> clamp to
[-clamp, clamp]. Gradient-free, as on the TPU:
the particle optimisers never differentiate an SDF query, and the
distillation trains through `raw_sdf_mlp`, which is plain autograd.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, `_sdf_mlp_torch`, which is also the kernel's oracle. `model` is any
object with the fields of `sdf.distill.DistilledSDF`: weights ((in, h),
(h, h), ..., (h, 1)), biases, freqs (F,), scale (), clamp ().

Bound on the card: operations, 2 * (K0*H + H*H*(depth-1) + H) float32
operations a point (71,168 at the shipped 21-128-128-128-1) against 16 bytes.
The kernel computes in float32 FMA with float32 accumulation, no tensor
cores; the plain version's matmuls are float32 too (`pin_fp32`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels

MAX_WIDTH = 128   # widest layer the kernels take (csrc/sdf_mlp_core.cuh)
MAX_HIDDEN = 8
PLAIN_CHUNK = 1 << 18  # points per pass of the plain version: 128 MiB an activation


class PackedSDF(NamedTuple):
    """A model's parameters as the kernels read them: one float32 buffer and
    the layer widths (see csrc/sdf_mlp_core.cuh for the layout)."""

    packed: torch.Tensor    # (n,) float32 on the card; (S, n) for S models
    n_freqs: int
    widths: tuple           # (3 + 6F, hidden widths...)


def fourier_features(points: torch.Tensor, freqs: torch.Tensor, scale) -> torch.Tensor:
    """(..., 3) -> (..., 3 + 6F): x | sin axis-major frequency-minor | cos."""
    x = points * scale
    ang = x[..., None] * freqs  # (..., 3, F)
    lead = x.shape[:-1]
    return torch.cat([x, torch.sin(ang).reshape(*lead, -1),
                      torch.cos(ang).reshape(*lead, -1)], dim=-1)


def raw_sdf_mlp(model, points: torch.Tensor) -> torch.Tensor:
    """Unclamped MLP output at points (..., 3) -> (...,), differentiable:
    what the distillation trains (a clamp at train time would zero the
    gradient wherever the init lands outside the band)."""
    h = fourier_features(points, model.freqs, model.scale)
    last = len(model.weights) - 1
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        h = torch.matmul(h, w) + b
        if i < last:
            h = torch.relu(h)
    return h[..., 0]


@torch.no_grad()
def _sdf_mlp_torch(model, points_cf: torch.Tensor, chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain version: points_cf (..., 3, N) -> clamped sdf (..., N). Runs
    `chunk` points at a time, so the (points, 128) activations stay bounded
    at the optimiser's 2M points a call."""
    pts = points_cf.transpose(-1, -2)  # (..., N, 3)
    shape = pts.shape[:-1]
    flat = pts.reshape(-1, 3)
    out = torch.empty(flat.shape[0], dtype=flat.dtype, device=flat.device)
    for start in range(0, flat.shape[0], chunk):
        sdf = raw_sdf_mlp(model, flat[start:start + chunk])
        out[start:start + chunk] = torch.clamp(sdf, -model.clamp, model.clamp)
    return out.reshape(shape)


def check_model(model) -> tuple:
    """The layer widths (3 + 6F, hidden...) of a model the kernels take;
    raises on one they do not."""
    n_freqs = int(model.freqs.shape[0])
    widths = [3 + 6 * n_freqs] + [int(w.shape[1]) for w in model.weights[:-1]]
    if len(model.weights) < 2 or len(model.weights) - 1 > MAX_HIDDEN:
        raise ValueError(f"the SDF kernels take 1 to {MAX_HIDDEN} hidden layers, "
                         f"got {len(model.weights) - 1}")
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"the SDF kernels take layers up to {MAX_WIDTH} wide "
                         f"(features included), got {widths}")
    dims = widths + [1]
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        if tuple(w.shape) != (dims[i], dims[i + 1]) or tuple(b.shape) != (dims[i + 1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not chain as {dims}")
    return tuple(widths)


@torch.no_grad()
def pack_distilled(model) -> PackedSDF:
    """The model as one float32 buffer on its device, in the layout of
    csrc/sdf_mlp_core.cuh: [scale, clamp, 0, 0], the frequencies padded to a
    multiple of 4, each hidden layer's weights (in, out) with the outputs
    padded to 128 columns and then its bias padded to 128, the output layer's
    weights padded to 128, its bias, 0 0 0. Weights keep their (in, out)
    layout: no transpose. Built without a host synchronise; pack once per
    sequence and hand it to every call."""
    widths = check_model(model)
    f32 = dict(dtype=torch.float32, device=model.freqs.device)

    def pad(t, n):
        return torch.nn.functional.pad(t.to(torch.float32), (0, n - t.shape[-1]))

    n_freqs = widths[0] // 6
    parts = [model.scale.reshape(1).to(torch.float32), model.clamp.reshape(1).to(torch.float32),
             torch.zeros(2, **f32), pad(model.freqs, (n_freqs + 3) // 4 * 4)]
    for w, b in zip(model.weights[:-1], model.biases[:-1]):
        parts += [pad(w, MAX_WIDTH).reshape(-1), pad(b, MAX_WIDTH)]
    parts += [pad(model.weights[-1][:, 0], MAX_WIDTH), model.biases[-1].to(torch.float32),
              torch.zeros(3, **f32)]
    return PackedSDF(torch.cat(parts).contiguous(), n_freqs, widths)


@torch.no_grad()
def pack_distilled_batched(models) -> PackedSDF:
    """S models as one PackedSDF with packed (S, n), for the batched
    kernels. Raises unless every model has the same widths and frequency
    count, as stacking them in the JAX package would."""
    packs = [pack_distilled(m) for m in models]
    if not packs or any(p.widths != packs[0].widths for p in packs):
        raise ValueError(f"pack_distilled_batched takes one or more models of equal widths, "
                         f"got {[p.widths for p in packs]}")
    return PackedSDF(torch.stack([p.packed for p in packs]), packs[0].n_freqs, packs[0].widths)


def _check_batch(models, points: torch.Tensor) -> None:
    if points.dim() < 1 or len(models) != points.shape[0]:
        raise ValueError(f"{len(models)} models for points {tuple(points.shape)}: the "
                         f"leading axis is the sequence")


def _sdf_mlp_batched_torch(models, points_cf: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched kernel: the unbatched plain version on
    each sequence's points (S, ..., 3, N) with its own model -> (S, ..., N)."""
    return torch.stack([_sdf_mlp_torch(m, p) for m, p in zip(models, points_cf)])


def fused_sdf_mlp_cf_batched(models, points_cf: torch.Tensor,
                             packed: PackedSDF | None = None) -> torch.Tensor:
    """A model a sequence: points_cf (S, ..., 3, N) float32 and S models ->
    sdf (S, ..., N). On the card one launch for every sequence (`packed`
    from `pack_distilled_batched`); on the CPU the plain version."""
    _check_batch(models, points_cf)
    if points_cf.dim() < 3 or points_cf.shape[-2] != 3:
        raise ValueError(f"points_cf must be (S, ..., 3, N), got {tuple(points_cf.shape)}")
    if points_cf.is_cuda:
        packed = packed if packed is not None else pack_distilled_batched(models)
        return kernels.sdf_mlp_batched_cuda(points_cf.contiguous(), packed, channels_first=True)
    if points_cf.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points_cf.device}")
    return _sdf_mlp_batched_torch(models, points_cf)


def fused_sdf_mlp_batched(models, points: torch.Tensor,
                          packed: PackedSDF | None = None) -> torch.Tensor:
    """A model a sequence, channels-last: points (S, ..., 3) -> (S, ...)."""
    _check_batch(models, points)
    if points.dim() < 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be (S, ..., 3), got {tuple(points.shape)}")
    if points.is_cuda:
        packed = packed if packed is not None else pack_distilled_batched(models)
        return kernels.sdf_mlp_batched_cuda(points.contiguous(), packed, channels_first=False)
    if points.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points.device}")
    return _sdf_mlp_batched_torch(models, points.transpose(-1, -2))


def fused_sdf_mlp_cf(model, points_cf: torch.Tensor,
                     packed: PackedSDF | None = None) -> torch.Tensor:
    """Channels-first entry: points_cf (..., 3, N) float32 -> sdf (..., N).
    On the card one kernel launch over all the points (`packed` saves
    packing the model again); on the CPU the plain version."""
    if points_cf.shape[-2] != 3:
        raise ValueError(f"points_cf must be (..., 3, N), got {tuple(points_cf.shape)}")
    if points_cf.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.sdf_mlp_cuda(points_cf.contiguous(), packed, channels_first=True)
    if points_cf.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points_cf.device}")
    return _sdf_mlp_torch(model, points_cf)


def fused_sdf_mlp(model, points: torch.Tensor,
                  packed: PackedSDF | None = None) -> torch.Tensor:
    """points (..., 3) float32 -> sdf (...,). The kernel reads the
    channels-last layout through strides: no transpose on the card."""
    if points.shape[-1] != 3:
        raise ValueError(f"points must be (..., 3), got {tuple(points.shape)}")
    if points.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.sdf_mlp_cuda(points.contiguous(), packed, channels_first=False)
    if points.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points.device}")
    return _sdf_mlp_torch(model, points.transpose(-1, -2))
