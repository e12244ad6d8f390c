"""Port parity for the row gather and its scatter-add adjoint
(hotrack_tpu_torch/ops/pointops.py: index_points, _GatherRows and the plain
versions) against the JAX package's gather kernel
(hotrack_tpu/ops/pallas/gather_mm.py, run in Pallas interpret mode) and
`jnp.take_along_axis`.

Tolerances: the forward is bitwise (a gather copies values); the adjoint is
the same terms summed in another order than the JAX kernel sums them, so it
is held at rtol 1e-6 / atol 1e-5 (float32 round-off over the <= ~100 terms a
row collects here), as tests/test_gather_mm.py holds the JAX kernel against
the take_along_axis adjoint. Rows that no index selects are exactly 0.

The CUDA kernels (csrc/gather_rows.cu) run only on a card: their tests are
marked `gpu` and skip without one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.ops import pointops as jops
from hotrack_tpu.ops.pallas.gather_mm import gather_rows_mm
from hotrack_tpu_torch.ops import kernels
from hotrack_tpu_torch.ops import pointops as tops


def _case(seed, b, n, c, s, hi=None, scale=1.0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, n, c) * scale).astype(np.float32)
    idx = rng.randint(0, hi or n, (b, s)).astype(np.int32)
    return pts, idx


@pytest.mark.parametrize("b,n,c,s", [(2, 200, 64, 700), (3, 512, 3, 512),
                                     (1, 64, 384, 1344)])
def test_plain_gather_bitwise_f32(b, n, c, s):
    pts, idx = _case(0, b, n, c, s, scale=100.0)
    got = tops._gather_rows_torch(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(gather_rows_mm(jnp.asarray(pts), jnp.asarray(idx), True)))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.take_along_axis(jnp.asarray(pts), jnp.asarray(idx)[..., None],
                                            axis=1)))


def test_plain_gather_bitwise_bf16():
    pts, idx = _case(1, 2, 128, 32, 300)
    jpts = jnp.asarray(pts, jnp.bfloat16)
    tpts = torch.from_numpy(pts).to(torch.bfloat16)
    # both packages round float32 -> bfloat16 to nearest even
    np.testing.assert_array_equal(tpts.float().numpy(), np.asarray(jpts, np.float32))
    got = tops.index_points(tpts, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    want = gather_rows_mm(jpts, jnp.asarray(idx), True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_plain_adjoint_matches_jax_grad_with_duplicates():
    b, n, c, s = 2, 96, 48, 640
    pts, idx = _case(2, b, n, c, s, hi=7)  # 7 distinct rows, like pad-with-first
    cot = np.random.RandomState(3).randn(b, s, c).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(
        gather_rows_mm(p, jnp.asarray(idx), True) * jnp.asarray(cot)))(jnp.asarray(pts))
    got = tops._scatter_rows_add_torch(torch.from_numpy(cot), torch.from_numpy(idx), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    # and through autograd, which is how the models reach it
    tpts = torch.from_numpy(pts).requires_grad_(True)
    (tops.index_points(tpts, torch.from_numpy(idx)) * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(tpts.grad, got)


def test_plain_adjoint_unselected_rows_zero():
    idx = torch.full((1, 520), 5, dtype=torch.int32)
    pts = torch.randn(1, 40, 16, generator=torch.Generator().manual_seed(3),
                      requires_grad=True)
    tops.index_points(pts, idx).sum().backward()
    g = pts.grad.numpy()
    assert np.all(g[0, :5] == 0) and np.all(g[0, 6:] == 0)
    np.testing.assert_allclose(g[0, 5], 520.0, rtol=1e-6)


def test_plain_adjoint_bf16_is_cast_at_the_end():
    """f32 accumulation, one rounding to the source's dtype at the end, as
    the JAX backward (`_gather_bwd`) does."""
    rng = np.random.RandomState(4)
    cot = torch.from_numpy(rng.randn(1, 300, 8).astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.randint(0, 3, (1, 300)).astype(np.int64))
    got = tops._scatter_rows_add_torch(cot, idx, 5)
    assert got.dtype == torch.bfloat16
    want = torch.zeros(5, 8).index_add_(0, idx[0], cot[0].float()).to(torch.bfloat16)
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_plain_adjoint_in_the_compute_dtypes_matches_the_pallas_adjoint(dtype):
    """HandTrackNet's bf16 and fp16 feature gathers (`network/compute_dtype`):
    the port's adjoint sums in float32 and rounds once, and so does the
    Pallas kernel's (`_gather_bwd_impl`, interpret mode); the two sum in
    another order, so a row's sum may round to the neighbouring value: held
    within one ulp of the dtype, at most 1% of the elements off bitwise."""
    b, n, c, s = 2, 96, 48, 640
    pts, idx = _case(6, b, n, c, s, hi=7)  # hundreds of terms a row
    cot = np.random.RandomState(7).randn(b, s, c).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jcot = jnp.asarray(cot, jd)
    want = jax.vjp(lambda p: gather_rows_mm(p, jnp.asarray(idx), True),
                   jnp.asarray(pts, jd))[1](jcot)[0]
    assert want.dtype == jd
    tpts = torch.from_numpy(pts).to(td).requires_grad_(True)
    tops.index_points(tpts, torch.from_numpy(idx)).backward(torch.from_numpy(cot).to(td))
    got = tpts.grad.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(got), np.abs(want)))[1] - 1) \
        * (2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -10)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) <= 0.01
    assert np.all(got[:, 7:] == 0) and np.all(want[:, 7:] == 0)


def test_index_points_multi_dim_indices_match_jax():
    rng = np.random.RandomState(5)
    pts = rng.randn(3, 50, 7).astype(np.float32)
    idx = rng.randint(0, 50, (3, 6, 4))
    want = jops.index_points(jnp.asarray(pts), jnp.asarray(idx))
    for dtype in (torch.int64, torch.int32):
        got = tops.index_points(torch.from_numpy(pts), torch.from_numpy(idx).to(dtype))
        assert tuple(got.shape) == (3, 6, 4, 7)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_rows_gradcheck_cpu_float64():
    gen = torch.Generator().manual_seed(6)
    pts = torch.randn(2, 9, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    idx = torch.randint(0, 9, (2, 14), generator=gen)
    idx[:, :6] = 2  # duplicates
    assert torch.autograd.gradcheck(lambda p: tops._GatherRows.apply(p, idx), (pts,))


def test_no_gradient_for_sources_that_need_none():
    """xyz sources need no gradient: the backward returns None for them
    without computing a scatter."""
    pts = torch.randn(2, 9, 3)
    feats = torch.randn(2, 9, 5, requires_grad=True)
    idx = torch.randint(0, 9, (2, 4))
    out = tops.index_points(pts, idx)
    assert not out.requires_grad
    tops.index_points(feats, idx).sum().backward()
    assert feats.grad is not None


def test_index_points_rejects_other_devices():
    with pytest.raises(ValueError, match="no row gather"):
        tops.index_points(torch.zeros(1, 4, 3, device="meta"),
                          torch.zeros(1, 2, dtype=torch.long, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: a CPU tensor is an error there
    (index_points is what dispatches on the device)."""
    pts, idx = torch.zeros(1, 4, 3), torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gather_rows_cuda(pts, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.scatter_rows_add_cuda(torch.zeros(1, 2, 3), idx, 4)
    assert kernels.launch_counts["gather_rows"] == 0 or torch.cuda.is_available()


# ---- the CUDA kernels: need a card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/gather_rows.cu runs only on the card")
    return torch.device("cuda")


# (B, N, C, S) of the train step at batch 32: sa1 centres, sa2 group feats,
# fp1, q2 feats; and an odd shape
GATHER_SHAPES = [(32, 512, 3, 256), (32, 256, 64, 4096), (32, 256, 128, 1536),
                 (32, 512, 384, 1344), (3, 100, 5, 77)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gather_kernel_bitwise(cuda_device, shape, dtype):
    b, n, c, s = shape
    pts, idx = _case(7, b, n, c, s)
    tp = torch.from_numpy(pts).to(dtype).to(cuda_device)
    for itype in (torch.int32, torch.int64):
        ti = torch.from_numpy(idx).to(itype).to(cuda_device)
        got = kernels.gather_rows_cuda(tp, ti)
        torch.cuda.synchronize()
        assert torch.equal(got, tops._gather_rows_torch(tp, ti))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GATHER_SHAPES[1:], ids=lambda s: "x".join(map(str, s)))
def test_scatter_kernel_matches_float64_oracle(cuda_device, shape):
    b, n, c, s = shape
    _, idx = _case(8, b, n, c, s)
    dout = torch.from_numpy(np.random.RandomState(9).randn(b, s, c).astype(np.float32))
    dout, ti = dout.to(cuda_device), torch.from_numpy(idx).to(cuda_device)
    got = kernels.scatter_rows_add_cuda(dout, ti, n)
    again = kernels.scatter_rows_add_cuda(dout, ti, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # fixed order, no atomics
    want = tops._scatter_rows_add_torch(dout.double(), ti, n, torch.float64)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
def test_scatter_kernel_duplicates_and_single_row(cuda_device):
    b, n, c, s = 2, 96, 48, 640
    _, idx = _case(10, b, n, c, s, hi=7)
    dout = torch.from_numpy(np.random.RandomState(11).randn(b, s, c).astype(np.float32))
    dout, ti = dout.to(cuda_device), torch.from_numpy(idx).to(cuda_device)
    got = kernels.scatter_rows_add_cuda(dout, ti, n)
    want = tops._scatter_rows_add_torch(dout.double(), ti, n, torch.float64)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-5)
    # the CPU plain version adds in the same order: bitwise
    assert torch.equal(got.cpu(), tops._scatter_rows_add_torch(dout.cpu(), ti.cpu(), n))
    one = kernels.scatter_rows_add_cuda(torch.ones(1, 520, 16, device=cuda_device),
                                        torch.full((1, 520), 5, device=cuda_device), 40)
    torch.cuda.synchronize()
    assert float(one[0, 5].min()) == 520.0 and float(one.sum()) == 520.0 * 16


@pytest.mark.gpu
def test_out_of_range_index_gives_zero_row(cuda_device):
    src = torch.randn(2, 10, 8, device=cuda_device)
    idx = torch.tensor([[0, -1, 10, 9], [3, 100, -5, 2]], device=cuda_device)
    out = kernels.gather_rows_cuda(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(out[0, 0], src[0, 0]) and torch.equal(out[1, 3], src[1, 2])
    assert float(out[0, 1:3].abs().sum()) == 0 and float(out[1, 1:3].abs().sum()) == 0
    d = kernels.scatter_rows_add_cuda(torch.ones(2, 4, 8, device=cuda_device), idx, 10)
    torch.cuda.synchronize()
    assert float(d.sum()) == 4 * 8  # the four in-range positions, nothing else


@pytest.mark.gpu
@pytest.mark.parametrize("c", [2, 8], ids=["4-byte rows", "16-byte rows"])
def test_gather_kernel_bf16_view_at_an_odd_storage_offset(cuda_device, c):
    """A contiguous bf16 view that starts 2 bytes off a 4-byte boundary must
    be copied in 2-byte units, whatever its row size."""
    store = torch.randn(1 + 3 * 20 * c, device=cuda_device).to(torch.bfloat16)
    src = store[1:].view(3, 20, c)
    assert src.is_contiguous() and src.data_ptr() % 4 == 2
    idx = torch.randint(0, 20, (3, 9), device=cuda_device)
    got = kernels.gather_rows_cuda(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, tops._gather_rows_torch(src, idx))


@pytest.mark.gpu
def test_index_points_on_the_card_runs_both_kernels(cuda_device):
    kernels.reset_launch_counts()
    x = torch.randn(4, 50, 16, device=cuda_device, requires_grad=True)
    xyz = torch.randn(4, 50, 3, device=cuda_device)
    idx = torch.randint(0, 50, (4, 6, 5), device=cuda_device)
    (tops.index_points(x, idx) ** 2).sum().backward()
    tops.index_points(xyz, idx)
    assert kernels.launch_counts["gather_rows"] == 2
    assert kernels.launch_counts["scatter_rows_add"] == 1
    xc = x.detach().cpu().requires_grad_(True)
    (tops.index_points(xc, idx.cpu()) ** 2).sum().backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tops.index_points(x.detach().double(), idx)
