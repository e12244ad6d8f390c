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

Two precisions, as in the JAX package. By default (`compute_dtype` None)
the results are float32-class: the kernel runs the hidden layers on the
tensor cores in 3xTF32 (three TF32 passes, the float32 sums of the tensor
cores; `ops/tf32.raw_sdf_mlp_3xtf32` emulates the arithmetic), the output
layer and the clamp in float32; the plain version's matmuls are float32
(`pin_fp32`). With `compute_dtype=torch.bfloat16` (the optimisers pass it
when HOTRACK_SDF_BF16 is set: `sdf.distill.sdf_compute_dtype`) every layer's
input activations and weights, the output layer's included, are rounded to
bf16 (to nearest, ties to even) before its product; the products are exact
and summed in float32, and the bias, ReLU and clamp stay float32. The kernel
then runs one bf16 tensor-core pass a layer; the plain version rounds with
`.to(torch.bfloat16)` and multiplies in float32.

Bound on the card: operations, 2 * (K0*H + H*H*(depth-1) + H) operations a
point (71,168 at the shipped 21-128-128-128-1) against 16 bytes, at TF32's
495 TFLOP/s three times over in 3xTF32, at bf16's 989 TFLOP/s once in bf16.

`pack_distilled` packs a model twice, once a precision, for the one core
that runs the MLP in every SDF kernel (this one, the fused object energy,
the fused hand energy and the fused skinning + hand energy): the persistent
wgmma walk of csrc/sdf_mlp_wgmma.cuh, its weights as tiles in their
shared-memory image, `PackedSDF.wg` in 3xTF32 and `PackedSDF.wg16` in bf16.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import kernels

MAX_WIDTH = 128   # widest layer the kernels take (csrc/sdf_mlp_wgmma.cuh kUnits)
MAX_HIDDEN = 8
PLAIN_CHUNK = 1 << 18  # points per pass of the plain version: 128 MiB an activation


class PackedSDF(NamedTuple):
    """A model's parameters as the kernels read them: the layer widths and
    one float32 buffer a precision, both in the layout of the wgmma walk
    (csrc/sdf_mlp_wgmma.cuh's header describes it; the bf16 image holds two
    bf16 a float32 word)."""

    n_freqs: int
    widths: tuple           # (3 + 6F, hidden widths...)
    wg: torch.Tensor        # 3xTF32 (`_pack_wg`), (k,); (S, k) for S models
    wg16: torch.Tensor      # bf16 (`_pack_wg16`), likewise


COMPUTE_DTYPES = (None, torch.bfloat16)   # float32-class, and the bf16 of HOTRACK_SDF_BF16


def check_compute_dtype(compute_dtype):
    """compute_dtype itself, or ValueError for one the SDF kernels do not take."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"the SDF kernels compute in float32 (compute_dtype None) or "
                         f"torch.bfloat16, got {compute_dtype!r}")
    return compute_dtype


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to bf16 (to nearest, ties to even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def fourier_features(points: torch.Tensor, freqs: torch.Tensor, scale) -> torch.Tensor:
    """(..., 3) -> (..., 3 + 6F): x | sin axis-major frequency-minor | cos."""
    x = points * scale
    ang = x[..., None] * freqs  # (..., 3, F)
    lead = x.shape[:-1]
    return torch.cat([x, torch.sin(ang).reshape(*lead, -1),
                      torch.cos(ang).reshape(*lead, -1)], dim=-1)


def raw_sdf_mlp(model, points: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Unclamped MLP output at points (..., 3) -> (...,), differentiable:
    what the distillation trains (a clamp at train time would zero the
    gradient wherever the init lands outside the band). compute_dtype
    bfloat16: each layer's input and weights rounded to bf16, the product in
    float32 (exact products, float32 sums), as the JAX package's `_raw_sdf`."""
    h = fourier_features(points, model.freqs, model.scale)
    bf16 = check_compute_dtype(compute_dtype) is not None
    last = len(model.weights) - 1
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        h = torch.matmul(bf16_round(h), bf16_round(w)) + b if bf16 else torch.matmul(h, w) + b
        if i < last:
            h = torch.relu(h)
    return h[..., 0]


@torch.no_grad()
def _sdf_mlp_torch(model, points_cf: torch.Tensor, chunk: int = PLAIN_CHUNK,
                   mlp=raw_sdf_mlp, compute_dtype=None) -> torch.Tensor:
    """Plain version: points_cf (..., 3, N) -> clamped sdf (..., N). Runs
    `chunk` points at a time, so the (points, 128) activations stay bounded
    at the optimiser's 2M points a call. `mlp`: the unclamped MLP
    (`ops/tf32.raw_sdf_mlp_3xtf32` emulates the 3xTF32 tensor-core kernels);
    compute_dtype bfloat16 takes `raw_sdf_mlp` in bf16."""
    if check_compute_dtype(compute_dtype) is not None:
        if mlp is not raw_sdf_mlp:
            raise ValueError("compute_dtype bfloat16 is raw_sdf_mlp's: pass no other mlp")
        mlp = functools.partial(raw_sdf_mlp, compute_dtype=compute_dtype)
    pts = points_cf.transpose(-1, -2)  # (..., N, 3)
    shape = pts.shape[:-1]
    flat = pts.reshape(-1, 3)
    out = torch.empty(flat.shape[0], dtype=flat.dtype, device=flat.device)
    for start in range(0, flat.shape[0], chunk):
        sdf = mlp(model, flat[start:start + chunk])
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
    """The model as the kernels read it, on its device: `wg` and `wg16` for
    the wgmma walk in 3xTF32 and bf16 (`_pack_wg`, `_pack_wg16`). Built
    without a host synchronise; pack once per sequence and hand it to every
    call."""
    widths = check_model(model)
    return PackedSDF(widths[0] // 6, widths, _pack_wg(model, widths), _pack_wg16(model, widths))


def _header(model, widths) -> list:
    """[scale, clamp, 0, 0] and the frequencies padded to a multiple of 4."""
    f32 = dict(dtype=torch.float32, device=model.freqs.device)
    n_freqs = widths[0] // 6
    return [model.scale.reshape(1).to(torch.float32), model.clamp.reshape(1).to(torch.float32),
            torch.zeros(2, **f32),
            torch.nn.functional.pad(model.freqs.to(torch.float32), (0, -n_freqs % 4))]


def _wg_tiles(w: torch.Tensor) -> torch.Tensor:
    """A layer's (K, 128) weight halves, K a multiple of 8, as the wgmma
    kernel's shared-memory tiles, one a k-step: [k-step][nb][kb][r][c], the
    weight of k-slot 8 k-step + 4 kb + c and unit 8 nb + r; core matrix
    (nb, kb) of a tile lies nb * 256 + kb * 128 bytes in (csrc/sdf_mlp_wgmma.cuh
    kSbo, kLbo)."""
    k = w.shape[0]
    # (k-step, kb, c, nb, r) -> (k-step, nb, kb, r, c)
    return w.reshape(k // 8, 2, 4, 16, 8).permute(0, 3, 1, 4, 2).reshape(k // 8, -1)


def _wg_rows(l: int, widths, device=None) -> torch.Tensor:
    """For layer l's k-slots in the wgmma kernel, the input rows they hold, -1
    for a zero row. Layer 0 pairs each angle's sine and cosine in one lane:
    with A = 3F angles (features 3 + j and 3 + A + j), k-slot t of k-step ks
    holds the sine of angle 4 ks + t and k-slot t + 4 its cosine; past the
    angles, k-slots t hold the 3 coordinates and the rest are 0 (ks0 = (A + 6)
    // 4 k-steps). Later layers: units 0 2 4 6 1 3 5 7 of each k-block of 8, so
    that one layer's wgmma accumulators are the next one's A fragments (a
    lane's accumulators hold units 8 j + 2 t and 8 j + 2 t + 1 of k-block j,
    its A fragment wants k-slots t and t + 4). Made on `device`: no copy from
    the host."""
    if l:
        slot = torch.arange(MAX_WIDTH, device=device)
        j = slot % 8
        return slot - j + (j % 4) * 2 + j // 4
    angles = 3 * (widths[0] // 6)
    slot = torch.arange(8 * ((angles + 6) // 4), device=device)
    j = 4 * (slot // 8) + slot % 4
    cos = slot % 8 >= 4
    rows = torch.where(cos, 3 + angles + j, 3 + j)
    rows = torch.where(j >= angles, torch.where(cos | (j >= angles + 3), -1, j - angles), rows)
    return rows


def _pack_wg(model, widths) -> torch.Tensor:
    """The layout of csrc/sdf_mlp_wgmma.cuh: [scale, clamp, 0, 0], the
    frequencies padded to a multiple of 4, every hidden layer's bias padded
    to 128, the output layer's 128 weights, its bias, 0 0 0; then the tiles in
    the order the kernel consumes them: per hidden layer (its rows in
    `_wg_rows`' order; 128 columns) and k-step, the big halves' tile, then the
    small halves' (both TF32 values as float32 words, `ops/tf32.tf32_split`)."""
    from .tf32 import tf32_split
    f32 = dict(dtype=torch.float32, device=model.freqs.device)
    pad = lambda t, n: torch.nn.functional.pad(t.to(torch.float32), (0, n - t.shape[-1]))  # noqa: E731
    parts = _header(model, widths) + [pad(b, MAX_WIDTH) for b in model.biases[:-1]]
    parts += [pad(model.weights[-1][:, 0], MAX_WIDTH), model.biases[-1].to(torch.float32),
              torch.zeros(3, **f32)]
    for l, w in enumerate(model.weights[:-1]):
        full = torch.zeros((MAX_WIDTH + 1, MAX_WIDTH), **f32)   # the last row stays 0
        full[:w.shape[0], :w.shape[1]] = w
        big, small = tf32_split(full[_wg_rows(l, widths, full.device)])
        parts.append(torch.stack([_wg_tiles(big), _wg_tiles(small)], 1).reshape(-1))
    return torch.cat(parts).contiguous()


def _output_layer16(model) -> list:
    """The output layer's 128 weights rounded to bf16 (as float32), its bias,
    0 0 0: the bf16 kernels' float32 FMA takes the rounded weights."""
    wout = bf16_round(model.weights[-1][:, 0].to(torch.float32))
    return [torch.nn.functional.pad(wout, (0, MAX_WIDTH - wout.shape[0])),
            model.biases[-1].to(torch.float32), torch.zeros(3, dtype=torch.float32,
                                                            device=wout.device)]


def _bf16_words(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor of an even count as float32 words, two bf16 a word (the
    first in the low half)."""
    return t.contiguous().reshape(-1).view(torch.float32)


def _wg16_tiles(w: torch.Tensor) -> torch.Tensor:
    """A layer's (K, 128) bf16 weights, K a multiple of 16, as the bf16 wgmma
    walk's shared-memory tiles, one a k-step of 16: [k-step][nb][kb][r][c],
    the weight of k-slot 16 k-step + 8 kb + c and unit 8 nb + r; core matrix
    (nb, kb) of a tile lies nb * 256 + kb * 128 bytes in (kSbo, kLbo), as the
    TF32 tiles (a tile is 4096 bytes in both)."""
    k = w.shape[0]
    # (k-step, kb, c, nb, r) -> (k-step, nb, kb, r, c)
    return w.reshape(k // 16, 2, 8, 16, 8).permute(0, 3, 1, 4, 2).reshape(k // 16, -1)


def _wg16_rows(widths, device=None) -> torch.Tensor:
    """Layer 0's input rows for the k-slots of the bf16 wgmma walk, -1 for a
    zero row. A lane (g, t) holds k-slots 2 t, 2 t + 1, 2 t + 8 and 2 t + 9 of a
    k-step; each pair is one angle's sine and cosine: with A = 3F angles
    (features 3 + j and 3 + A + j), k-slots 2 t and 2 t + 1 of k-step ks hold
    angle 8 ks + t, k-slots 2 t + 8 and 2 t + 9 angle 8 ks + 4 + t; past the
    angles, the first of a pair holds the 3 coordinates and the rest are 0
    (ks0 = (A + 10) // 8 k-steps). The later layers take their rows in order."""
    angles = 3 * (widths[0] // 6)
    slot = torch.arange(16 * ((angles + 10) // 8), device=device)
    c = slot % 16
    j = 8 * (slot // 16) + (c % 8) // 2 + 4 * (c // 8)
    cos = c % 2 == 1
    rows = torch.where(cos, 3 + angles + j, 3 + j)
    return torch.where(j >= angles, torch.where(cos | (j >= angles + 3), -1, j - angles), rows)


def _pack_wg16(model, widths) -> torch.Tensor:
    """The bf16 layout of csrc/sdf_mlp_wgmma.cuh: the header, every hidden
    layer's float32 bias padded to 128, the output layer (`_output_layer16`);
    then the tiles in the order the walk consumes them, one a k-step of 16:
    per hidden layer (layer 0's rows in `_wg16_rows`' order, the others' in
    theirs; 128 columns) the weights rounded to bf16 (`_wg16_tiles`)."""
    pad = lambda t, n: torch.nn.functional.pad(t.to(torch.float32), (0, n - t.shape[-1]))  # noqa: E731
    parts = _header(model, widths) + [pad(b, MAX_WIDTH) for b in model.biases[:-1]]
    parts += _output_layer16(model)
    for l, w in enumerate(model.weights[:-1]):
        full = torch.zeros((MAX_WIDTH + 1, MAX_WIDTH), dtype=torch.bfloat16, device=w.device)
        full[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)   # the last row stays 0
        rows = _wg16_rows(widths, w.device) if l == 0 else slice(0, MAX_WIDTH)
        parts.append(_bf16_words(_wg16_tiles(full[rows])))
    return torch.cat(parts).contiguous()


@torch.no_grad()
def pack_distilled_batched(models) -> PackedSDF:
    """S models as one PackedSDF with buffers (S, n), for the batched
    kernels. Raises unless every model has the same widths and frequency
    count, as stacking them in the JAX package would."""
    packs = [pack_distilled(m) for m in models]
    if not packs or any(p.widths != packs[0].widths for p in packs):
        raise ValueError(f"pack_distilled_batched takes one or more models of equal widths, "
                         f"got {[p.widths for p in packs]}")
    return PackedSDF(packs[0].n_freqs, packs[0].widths,
                     *(torch.stack([getattr(p, f) for p in packs])
                       for f in ("wg", "wg16")))


def _check_batch(models, points: torch.Tensor) -> None:
    if points.dim() < 1 or len(models) != points.shape[0]:
        raise ValueError(f"{len(models)} models for points {tuple(points.shape)}: the "
                         f"leading axis is the sequence")


def _sdf_mlp_batched_torch(models, points_cf: torch.Tensor,
                           compute_dtype=None) -> torch.Tensor:
    """Plain version of the batched kernel: the unbatched plain version on
    each sequence's points (S, ..., 3, N) with its own model -> (S, ..., N)."""
    return torch.stack([_sdf_mlp_torch(m, p, compute_dtype=compute_dtype)
                        for m, p in zip(models, points_cf)])


# Every entry below takes compute_dtype None (float32-class) or torch.bfloat16
# (module docstring); on the card each launches the kernel of that precision.


def fused_sdf_mlp_cf_batched(models, points_cf: torch.Tensor,
                             packed: PackedSDF | None = None,
                             compute_dtype=None) -> torch.Tensor:
    """A model a sequence: points_cf (S, ..., 3, N) float32 and S models ->
    sdf (S, ..., N). On the card one launch for every sequence (`packed`
    from `pack_distilled_batched`); on the CPU the plain version."""
    _check_batch(models, points_cf)
    check_compute_dtype(compute_dtype)
    if points_cf.dim() < 3 or points_cf.shape[-2] != 3:
        raise ValueError(f"points_cf must be (S, ..., 3, N), got {tuple(points_cf.shape)}")
    if points_cf.is_cuda:
        packed = packed if packed is not None else pack_distilled_batched(models)
        return kernels.sdf_mlp_batched_cuda(points_cf.contiguous(), packed, channels_first=True,
                                            compute_dtype=compute_dtype)
    if points_cf.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points_cf.device}")
    return _sdf_mlp_batched_torch(models, points_cf, compute_dtype)


def fused_sdf_mlp_batched(models, points: torch.Tensor,
                          packed: PackedSDF | None = None, compute_dtype=None) -> torch.Tensor:
    """A model a sequence, channels-last: points (S, ..., 3) -> (S, ...)."""
    _check_batch(models, points)
    check_compute_dtype(compute_dtype)
    if points.dim() < 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be (S, ..., 3), got {tuple(points.shape)}")
    if points.is_cuda:
        packed = packed if packed is not None else pack_distilled_batched(models)
        return kernels.sdf_mlp_batched_cuda(points.contiguous(), packed, channels_first=False,
                                            compute_dtype=compute_dtype)
    if points.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points.device}")
    return _sdf_mlp_batched_torch(models, points.transpose(-1, -2), compute_dtype)


def fused_sdf_mlp_cf(model, points_cf: torch.Tensor,
                     packed: PackedSDF | None = None, compute_dtype=None) -> torch.Tensor:
    """Channels-first entry: points_cf (..., 3, N) float32 -> sdf (..., N).
    On the card one kernel launch over all the points (`packed` saves
    packing the model again); on the CPU the plain version."""
    check_compute_dtype(compute_dtype)
    if points_cf.shape[-2] != 3:
        raise ValueError(f"points_cf must be (..., 3, N), got {tuple(points_cf.shape)}")
    if points_cf.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.sdf_mlp_cuda(points_cf.contiguous(), packed, channels_first=True,
                                    compute_dtype=compute_dtype)
    if points_cf.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points_cf.device}")
    return _sdf_mlp_torch(model, points_cf, compute_dtype=compute_dtype)


def fused_sdf_mlp(model, points: torch.Tensor,
                  packed: PackedSDF | None = None, compute_dtype=None) -> torch.Tensor:
    """points (..., 3) float32 -> sdf (...,). The kernel reads the
    channels-last layout through strides: no transpose on the card."""
    check_compute_dtype(compute_dtype)
    if points.shape[-1] != 3:
        raise ValueError(f"points must be (..., 3), got {tuple(points.shape)}")
    if points.is_cuda:
        packed = packed if packed is not None else pack_distilled(model)
        return kernels.sdf_mlp_cuda(points.contiguous(), packed, channels_first=False,
                                    compute_dtype=compute_dtype)
    if points.device.type != "cpu":
        raise ValueError(f"no SDF MLP for device {points.device}")
    return _sdf_mlp_torch(model, points.transpose(-1, -2), compute_dtype=compute_dtype)
