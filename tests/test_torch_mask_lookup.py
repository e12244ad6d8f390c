"""Port parity for the packed background-mask lookup
(hotrack_tpu_torch.ops.mask_lookup) against hotrack_tpu.ops.pallas.mask_lookup
on the CPU: the same numpy mask and the same integer pixels through both.

Tolerance: none. `pack_mask`'s bytes equal the JAX package's float words, and
the plain lookup equals the Pallas kernel (interpret mode) and `mask[iy, ix]`
exactly, on image widths that are and are not multiples of 8 and on the
1 x 1 mask a sequence without silhouettes gets.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.ops.pallas import mask_lookup as jax_mask_lookup
from hotrack_tpu_torch.ops import mask_lookup

SIZES = [(64, 80), (37, 53), (1, 1), (5, 8), (3, 9), (480, 640)]


def _mask(hw, seed=0):
    return np.random.RandomState(seed).rand(*hw) > 0.5


@pytest.mark.parametrize("hw", SIZES)
def test_pack_mask_bytes_equal_the_jax_words(hw):
    mask = _mask(hw)
    packed = mask_lookup.pack_mask(torch.from_numpy(mask))
    want = np.asarray(jax_mask_lookup.pack_mask(jnp.asarray(mask)))
    assert packed.dtype == torch.uint8 and packed.is_contiguous()
    assert tuple(packed.shape) == (hw[0], -(-hw[1] // 8)) == want.shape
    np.testing.assert_array_equal(packed.numpy().astype(np.float32), want)
    # 0/1 integers and floats pack like booleans; bits beyond W are 0
    for cast in (np.uint8, np.float32, np.int64):
        assert torch.equal(mask_lookup.pack_mask(torch.from_numpy(mask.astype(cast))), packed)
    if hw[1] % 8:
        assert int(packed[:, -1].max()) < 2 ** (hw[1] % 8)


@pytest.mark.parametrize("hw", SIZES[:5])
@pytest.mark.parametrize("shape", [(300,), (6, 50), (2, 3, 7)])
def test_lookup_equals_the_pallas_kernel_and_the_gather(hw, shape):
    rng = np.random.RandomState(sum(shape))
    mask = _mask(hw, 1)
    iy = rng.randint(0, hw[0], shape).astype(np.int32)
    ix = rng.randint(0, hw[1], shape).astype(np.int32)
    # every corner and edge among the queries
    iy.flat[:4], ix.flat[:4] = [0, 0, hw[0] - 1, hw[0] - 1], [0, hw[1] - 1, 0, hw[1] - 1]
    packed = mask_lookup.pack_mask(torch.from_numpy(mask))
    got = mask_lookup.packed_mask_lookup(packed, torch.from_numpy(iy), torch.from_numpy(ix), hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), mask[iy, ix].astype(np.float32))
    want = jax_mask_lookup.packed_mask_lookup(
        jax_mask_lookup.pack_mask(jnp.asarray(mask)), jnp.asarray(iy), jnp.asarray(ix),
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_every_pixel_of_a_mask_reads_back():
    hw = (9, 21)
    mask = _mask(hw, 2)
    iy, ix = np.meshgrid(np.arange(hw[0]), np.arange(hw[1]), indexing="ij")
    got = mask_lookup.packed_mask_lookup(
        mask_lookup.pack_mask(torch.from_numpy(mask)), torch.from_numpy(iy.astype(np.int32)),
        torch.from_numpy(ix.astype(np.int32)), hw)
    np.testing.assert_array_equal(got.numpy().astype(bool), mask)


def test_lookup_refuses_mismatched_shapes():
    packed = mask_lookup.pack_mask(torch.zeros((4, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="shape"):
        mask_lookup.packed_mask_lookup(packed, torch.zeros(3, dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32), (4, 4))
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        mask_lookup.pack_mask(torch.zeros((2, 4, 4), dtype=torch.bool))
