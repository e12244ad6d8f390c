"""Background-mask lookup at integer pixels: the packed mask, the plain
PyTorch version and the dispatch to the CUDA kernel (csrc/mask_lookup.cu,
kernel wrapper in ops/kernels.py).

Replaces hotrack_tpu/ops/pallas/mask_lookup.py (`pack_mask`,
`packed_mask_lookup`, and `_lookup_impl_batched`, which JAX's `vmap` reaches
with a mask a sequence: `packed_mask_lookup_batched` here). The hand pose
optimiser asks, for 5120 candidates x 778 vertices an iteration, whether a
vertex's pixel lies on the background.
On the TPU that gather is rewritten as one-hot matrix products over float
words; on a card a lookup is one byte load and a shift, so none of that is
carried over. What is kept is the packing: 8 pixels of a row to a word,
little-endian, so the mask is 38,400 bytes at 480 x 640 and stays in cache.

`pack_mask` gives uint8 (H, ceil(W / 8)): bit b of byte k of a row is pixel
8 k + b, 0 beyond W. Its values equal the JAX `pack_mask`'s float words.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, `_packed_mask_lookup_torch`, which is also the kernel's oracle.
Bound on the card: bytes (two int32 in and one float32 out a query).
"""

from __future__ import annotations

import torch

from . import kernels

BITS = 8


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) bool or 0/1 -> (H, ceil(W / 8)) uint8, little-endian bits."""
    if mask.dim() != 2:
        raise ValueError(f"mask must be (H, W), got {tuple(mask.shape)}")
    h, w = mask.shape
    wp = (w + BITS - 1) // BITS
    m = torch.nn.functional.pad((mask != 0).to(torch.int32), (0, wp * BITS - w))
    weights = 2 ** torch.arange(BITS, dtype=torch.int32, device=mask.device)
    return torch.sum(m.reshape(h, wp, BITS) * weights, dim=-1).to(torch.uint8).contiguous()


def _packed_mask_lookup_torch(packed: torch.Tensor, iy: torch.Tensor,
                              ix: torch.Tensor) -> torch.Tensor:
    """Plain version: the bit of pixel (iy, ix) as float32, by indexing."""
    iy, ix = iy.long(), ix.long()
    word = packed[iy, ix >> 3].to(torch.int32)
    return ((word >> (ix & 7).to(torch.int32)) & 1).to(torch.float32)


def packed_mask_lookup(packed: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                       hw) -> torch.Tensor:
    """packed from `pack_mask` for an image of hw = (H, W); iy, ix int32 of
    any equal shape, already clipped to [0, H) and [0, W) -> the mask's
    values there, float32 in {0, 1}, of that shape."""
    if iy.shape != ix.shape:
        raise ValueError(f"iy {tuple(iy.shape)} and ix {tuple(ix.shape)} differ in shape")
    if iy.is_cuda:
        return kernels.packed_mask_lookup_cuda(packed, iy.contiguous(), ix.contiguous(), hw)
    if iy.device.type != "cpu":
        raise ValueError(f"no mask lookup for device {iy.device}")
    return _packed_mask_lookup_torch(packed, iy, ix)


def _packed_mask_lookup_batched_torch(packed: torch.Tensor, iy: torch.Tensor,
                                      ix: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched kernel: each sequence's queries (S, ...)
    in its own mask (S, H, ceil(W / 8))."""
    return torch.stack([_packed_mask_lookup_torch(m, y, x) for m, y, x in zip(packed, iy, ix)])


def packed_mask_lookup_batched(packed: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                               hw) -> torch.Tensor:
    """A mask a sequence: packed (S, H, ceil(W / 8)) from `pack_mask` of
    masks padded to one hw = (H, W); iy, ix int32 (S, ...), clipped to the
    padded image -> float32 (S, ...) in {0, 1}."""
    if iy.shape != ix.shape or iy.dim() < 1 or packed.dim() != 3 \
            or packed.shape[0] != iy.shape[0]:
        raise ValueError(f"packed_mask_lookup_batched takes masks (S, H, WP) and iy, ix of one "
                         f"shape (S, ...), got {tuple(packed.shape)}, {tuple(iy.shape)} and "
                         f"{tuple(ix.shape)}")
    if iy.is_cuda:
        return kernels.packed_mask_lookup_batched_cuda(packed, iy.contiguous(), ix.contiguous(),
                                                       hw)
    if iy.device.type != "cpu":
        raise ValueError(f"no mask lookup for device {iy.device}")
    return _packed_mask_lookup_batched_torch(packed, iy, ix)
