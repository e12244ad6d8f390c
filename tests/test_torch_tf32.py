"""The 3xTF32 arithmetic of the tensor-core SDF kernels (csrc/sdf_mlp_tc.cuh,
kernels #4 and #7 with their batched forms), on the CPU: the split, the
emulated MLP against the JAX package's distilled MLP, the packed layout
(`PackedSDF.tc`) against the model, and a lane-by-lane walk of the mma
fragments as the kernel reads them. The kernels themselves are held on the
card (`chip_smoke.py`, the `gpu` tests).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.sdf import distill as jdistill
from hotrack_tpu_torch.ops import sdf_mlp, tf32
from torch_sdf_models import random_model

SDF_ATOL = 5e-7   # one sdf value: the 3xTF32 arithmetic against float32 or the JAX MLP
WIDTHS = [((21, 128, 128, 128), None), ((15, 32, 48), [1.0, 2.5]), ((9, 128), None),
          ((39, 128, 128, 128, 128), None)]


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


@pytest.mark.parametrize("widths,freqs", WIDTHS[:3])
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


def _unpack_tc(tc: torch.Tensor, n_freqs: int, widths) -> tuple:
    """`PackedSDF.tc` of one model back to the model's shapes: (big halves,
    small halves as fp16 words of small * 2^12, biases) of the hidden layers
    ((in, out) each), and the output layer's (weights (h, 1), bias (1,)).
    The inverse of the packing."""
    dims, width = [*widths, 1], sdf_mlp.MAX_WIDTH
    pos = 4 + n_freqs + -n_freqs % 4
    bigs, smalls, biases = [], [], []
    for l in range(len(widths) - 1):   # the hidden layers
        k = sdf_mlp._tc_k(l, widths)
        rows = sdf_mlp._tc_rows(l, k, tc.device)
        big = torch.empty((k, width), dtype=tc.dtype, device=tc.device)
        # _fragment_order's (k-step, p, g, t, h, kh) back to (k-step, kh, t, p, h, g)
        big[rows] = tc[pos:pos + k * width].reshape(k // 8, 8, 8, 4, 2, 2) \
            .permute(0, 5, 3, 1, 4, 2).reshape(k, width)
        pos += k * width
        small = torch.empty((k, width), dtype=torch.float16, device=tc.device)
        small[rows] = tc[pos:pos + k * width // 2].contiguous().view(torch.float16) \
            .reshape(k // 8, 4, 8, 4, 4, 2).permute(0, 5, 3, 1, 4, 2).reshape(k, width)
        pos += k * width // 2
        bigs.append(big[:dims[l], :dims[l + 1]])
        smalls.append(small[:dims[l], :dims[l + 1]])
        biases.append(tc[pos:pos + dims[l + 1]])
        pos += width
    out = (tc[pos:pos + dims[-2]].reshape(-1, 1), tc[pos + width:pos + width + 1])
    return tuple(bigs), tuple(smalls), tuple(biases), out


@pytest.mark.parametrize("widths,freqs", WIDTHS)
def test_tensor_core_layout_unpacks_to_the_model_bitwise(widths, freqs):
    _, tmodel = random_model(13, widths=widths, freqs=freqs)
    packed = sdf_mlp.pack_distilled(tmodel)
    assert packed.tc.dtype == torch.float32 and packed.tc.numel() % 4 == 0
    n_hidden = len(widths) - 1
    k0 = widths[0] + -widths[0] % 8
    header = 4 + packed.n_freqs + -packed.n_freqs % 4
    assert packed.tc.numel() == header + 192 * k0 + 128 + (n_hidden - 1) * (192 * 128 + 128) + 132
    assert packed.tc[0] == tmodel.scale and packed.tc[1] == tmodel.clamp
    assert torch.equal(packed.tc[4:4 + packed.n_freqs], tmodel.freqs)
    bigs, smalls, biases, (wout, bout) = _unpack_tc(packed.tc, packed.n_freqs,
                                                           packed.widths)
    for w, big, small, b, want_b in zip(tmodel.weights, bigs, smalls, biases, tmodel.biases):
        want_big, want_small = tf32.weight_split(w)
        assert torch.equal(big, want_big) and torch.equal(small, want_small)
        assert torch.equal(b, want_b)
        # within 2^-21 |w|, or half an fp16 subnormal step of the small half
        # (2^-25 / 2^12) where a weight below about 2^-14 makes it subnormal
        back = big.double() + small.double() / tf32.SMALL_SCALE
        bound = 2.0 ** -21 * w.double().abs() + 2.0 ** -25 / tf32.SMALL_SCALE
        assert bool(((back - w.double()).abs() <= bound).all())
    assert torch.equal(wout, tmodel.weights[-1]) and torch.equal(bout, tmodel.biases[-1])
    two = sdf_mlp.pack_distilled_batched([tmodel, tmodel])
    assert two.tc.shape == (2, packed.tc.numel()) and torch.equal(two.tc[1], packed.tc)


# -- a lane-by-lane walk of csrc/sdf_mlp_tc.cuh's fragments ------------------

LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def _split(x: np.ndarray) -> tuple:
    big = tf32.tf32_round(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    small = tf32.tf32_round(torch.from_numpy(np.ascontiguousarray(x, np.float32)) - big)
    return big.double().numpy(), small.double().numpy()


def _mma(acc, a, b0, b1):
    """acc (tiles, 32, 4) += A (16 x 8, from a (tiles, 32, 4)) @ B (8 x 8, from
    b0, b1 (tiles, 32)) with the m16n8k8 fragment positions of the PTX ISA."""
    tiles = acc.shape[0]
    A = np.zeros((tiles, 16, 8))
    A[:, G, T], A[:, G + 8, T], A[:, G, T + 4], A[:, G + 8, T + 4] = (a[..., i] for i in range(4))
    B = np.zeros((tiles, 8, 8))
    B[:, T, G], B[:, T + 4, G] = b0, b1
    D = A @ B
    acc[..., 0] += D[:, G, 2 * T]
    acc[..., 1] += D[:, G, 2 * T + 1]
    acc[..., 2] += D[:, G + 8, 2 * T]
    acc[..., 3] += D[:, G + 8, 2 * T + 1]


def _layer(acc, a_regs, big4, small8):
    """One layer: a_regs[ks] (tiles, 32, 4) float32 A fragments, big4 the
    layer's big halves as float4s and small8 its small halves as groups of
    8 fp16, in fragment order; 3xTF32 into acc (tiles, 16, 32, 4)."""
    for ks, a in enumerate(a_regs):
        ab, as_ = _split(a)
        for nt in range(16):
            bb = big4[(ks * 8 + nt // 2) * 32 + LANES][:, 2 * (nt % 2):2 * (nt % 2) + 2]
            bs = small8[(ks * 4 + nt // 4) * 32 + LANES][:, 2 * (nt % 4):2 * (nt % 4) + 2]
            bb, bs = bb.astype(np.float64), bs.astype(np.float64) / tf32.SMALL_SCALE
            part = np.zeros_like(acc[:, nt])
            for aa, b in ((as_, bb), (ab, bs), (ab, bb)):
                _mma(part, aa, np.broadcast_to(b[:, 0], aa.shape[:2]),
                     np.broadcast_to(b[:, 1], aa.shape[:2]))
            acc[:, nt] += part


def _fragment_walk(packed: sdf_mlp.PackedSDF, pts: np.ndarray) -> np.ndarray:
    """The clamped sdf of points (16 tiles, 3) computed from `packed.tc`
    lane by lane as the kernel reads it: layer 0's A fragments from the
    features, each later layer's from the accumulators (a0 a1 a2 a3 = c0 c2
    c1 c3), every weight's halves from their 16-byte groups in fragment
    order, a k-step's part of a tile summed on its own, then added."""
    buf = packed.tc.numpy()
    n_freqs, widths = packed.n_freqs, packed.widths
    scale, clamp = buf[0], buf[1]
    freqs = buf[4:4 + n_freqs]
    pos = 4 + n_freqs + -n_freqs % 4
    x = (pts.reshape(-1, 16, 3) * scale).astype(np.float32)           # (tiles, 16, 3)
    ang = (x[..., None] * freqs).astype(np.float32)
    k0 = widths[0] + -widths[0] % 8
    feats = np.zeros((*x.shape[:2], k0), np.float32)
    feats[..., :widths[0]] = np.concatenate(
        [x, np.sin(ang).reshape(*x.shape[:2], -1), np.cos(ang).reshape(*x.shape[:2], -1)], -1)
    act = None
    for l in range(len(widths) - 1):
        k = k0 if l == 0 else 128
        big4 = buf[pos:pos + k * 128].reshape(-1, 4)
        small8 = buf[pos + k * 128:pos + k * 192].view(np.float16).reshape(-1, 8)
        bias = buf[pos + k * 192:pos + k * 192 + 128]
        pos += k * 192 + 128
        if l == 0:
            a_regs = [np.stack([feats[:, G, 8 * ks + T], feats[:, G + 8, 8 * ks + T],
                                feats[:, G, 8 * ks + T + 4], feats[:, G + 8, 8 * ks + T + 4]], -1)
                      for ks in range(k // 8)]
        else:
            a_regs = [act[:, ks][..., [0, 2, 1, 3]] for ks in range(16)]
        acc = np.zeros((x.shape[0], 16, 32, 4))
        _layer(acc, a_regs, big4, small8)
        cols = np.arange(16)[:, None] * 8 + 2 * T                       # (16, 32)
        b = np.stack([bias[cols], bias[cols + 1], bias[cols], bias[cols + 1]], -1)
        act = np.maximum(acc.astype(np.float32) + b, np.float32(0.0))
    wout = buf[pos:pos + 128]
    cols = np.arange(16)[:, None] * 8 + 2 * T
    p0 = (act[..., 0] * wout[cols] + act[..., 1] * wout[cols + 1]).sum(1)   # (tiles, 32)
    p1 = (act[..., 2] * wout[cols] + act[..., 3] * wout[cols + 1]).sum(1)
    rows = np.zeros((x.shape[0], 16))
    for lane in range(0, 32, 4):
        rows[:, lane // 4] = p0[:, lane:lane + 4].sum(-1)
        rows[:, lane // 4 + 8] = p1[:, lane:lane + 4].sum(-1)
    return np.clip(rows + buf[pos + 128], -clamp, clamp).reshape(-1)


@pytest.mark.parametrize("widths,freqs", WIDTHS)
def test_fragment_walk_of_the_packed_layout_computes_the_mlp(widths, freqs):
    _, tmodel = random_model(14, widths=widths, freqs=freqs)
    packed = sdf_mlp.pack_distilled(tmodel)
    pts = (np.random.RandomState(15).randn(32, 3) * 0.08).astype(np.float32)
    got = _fragment_walk(packed, pts)
    want = sdf_mlp._sdf_mlp_torch(tmodel, torch.from_numpy(pts).T,
                                  mlp=tf32.raw_sdf_mlp_3xtf32).numpy()
    # the walk and the emulation differ only in the order of exact float64 sums
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    plain = sdf_mlp._sdf_mlp_torch(tmodel, torch.from_numpy(pts).T).numpy()
    np.testing.assert_allclose(got, plain, atol=SDF_ATOL, rtol=0)
