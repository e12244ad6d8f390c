"""The 3xTF32 arithmetic of the tensor-core SDF kernels (the wgmma walk of
csrc/sdf_mlp_wgmma.cuh, which every SDF kernel runs), on the CPU: the split
and the emulated MLP against the JAX package's distilled MLP. The walk's
packed layout (`PackedSDF.wg`) and its fragments are held in
test_torch_sdf_wgmma_layout.py; the kernels themselves on the card
(`chip_smoke.py`, the `gpu` tests).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.sdf import distill as jdistill
from hotrack_tpu_torch.ops import sdf_mlp, tf32
from torch_sdf_models import random_model

SDF_ATOL = 5e-7   # one sdf value: the 3xTF32 arithmetic against float32 or the JAX MLP
WIDTHS = [((21, 128, 128, 128), None), ((15, 32, 48), [1.0, 2.5]), ((9, 128), None)]


def _low_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_split_keeps_ten_mantissa_bits_and_sums_back():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096),
                        [1.0, -1.0, 2.0 ** -126, -3.5e-30, 1e38, 0.0]]).astype(np.float32)
    x = torch.from_numpy(x)
    big, small = tf32.tf32_split(x)
    assert not _low_bits(big).any() and not _low_bits(small).any()
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all()), float((err / x.abs()).max())
    # to nearest, ties away from zero: 1 + 2^-11 lies halfway between TF32 neighbours
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -20])
    assert tf32.tf32_round(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("widths,freqs", WIDTHS)
def test_emulated_3xtf32_mlp_matches_the_jax_distilled_mlp(widths, freqs):
    jmodel, tmodel = random_model(11, widths=widths, freqs=freqs)
    pts = (np.random.RandomState(12).randn(3, 257, 3) * 0.08).astype(np.float32)
    got = sdf_mlp._sdf_mlp_torch(tmodel, torch.from_numpy(pts).transpose(-1, -2),
                                 mlp=tf32.raw_sdf_mlp_3xtf32)
    want = np.asarray(jdistill.eval_distilled_sdf(jmodel, jnp.asarray(pts)))
    assert 0.02 < np.mean(np.abs(want) >= 0.05) < 0.9   # the clamp is exercised
    np.testing.assert_allclose(got.numpy(), want, atol=SDF_ATOL, rtol=0)
    raw = tf32.raw_sdf_mlp_3xtf32(tmodel, torch.from_numpy(pts))
    np.testing.assert_allclose(raw.numpy(), np.asarray(jdistill._raw_sdf(jmodel, jnp.asarray(pts))),
                               atol=2e-6, rtol=0)
