"""Port parity: hotrack_tpu_torch.ops.pointops against hotrack_tpu.ops.pointops.

Inputs are made from a seed with numpy and go through the JAX function and
its PyTorch counterpart. Index ops are held index-exact; distances to 1e-6
(float32 rounding of the same expanded-form arithmetic). FPS is held against
both JAX paths: the XLA fori_loop and the Pallas kernel in interpret mode.
The CUDA kernel's own tests need a card and skip without one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.ops import pointops as jops
from hotrack_tpu.ops.pallas.fps import farthest_point_sample_pallas
from hotrack_tpu_torch.ops import kernels
from hotrack_tpu_torch.ops import pointops as tops

DIST_TOL = 1e-6  # float32 rounding of the same arithmetic, m


def _grid_cloud(rng, b, n):
    """Tie-heavy cloud: integer grid points, each repeated several times."""
    base = rng.randint(0, 4, size=(b, n // 4, 3)).astype(np.float32)
    return np.ascontiguousarray(np.repeat(base, 4, axis=1)[:, rng.permutation(n)])


def _fps_case(name):
    rng = np.random.RandomState(7)
    if name == "random":
        return rng.randn(3, 200, 3).astype(np.float32), None, 64
    if name == "masked":
        mask = rng.rand(2, 160) > 0.3
        mask[:, 0] = True
        return rng.randn(2, 160, 3).astype(np.float32), mask, 32
    if name == "masked_seed_invalid":
        mask = rng.rand(2, 160) > 0.3
        mask[:, 0] = False
        return rng.randn(2, 160, 3).astype(np.float32), mask, 32
    if name == "duplicates":
        return _grid_cloud(rng, 2, 256), None, 48
    if name == "duplicates_masked":
        mask = rng.rand(2, 256) > 0.5
        return _grid_cloud(rng, 2, 256), mask, 40
    if name == "pipeline_like":
        # the prepare_batch layout: valid points first, zero padding after
        xyz = np.zeros((2, 640, 3), np.float32)
        mask = np.zeros((2, 640), bool)
        xyz[:, :450] = rng.randn(2, 450, 3) * 0.05 + [0.0, 0.0, 0.5]
        mask[:, :450] = True
        return xyz, mask, 128
    raise KeyError(name)


FPS_CASES = ["random", "masked", "masked_seed_invalid", "duplicates",
             "duplicates_masked", "pipeline_like"]


@pytest.mark.parametrize("case", FPS_CASES)
def test_fps_matches_jax_xla_and_pallas(case):
    xyz, mask, npoint = _fps_case(case)
    jmask = None if mask is None else jnp.asarray(mask)
    want_xla = np.asarray(jops._farthest_point_sample_xla(jnp.asarray(xyz), npoint, jmask))
    want_pallas = np.asarray(farthest_point_sample_pallas(
        jnp.asarray(xyz), npoint, jmask, interpret=True))
    np.testing.assert_array_equal(want_pallas, want_xla)
    got = tops.farthest_point_sample(torch.from_numpy(xyz), npoint,
                                     None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and tuple(got.shape) == (xyz.shape[0], npoint)
    np.testing.assert_array_equal(got.numpy(), want_xla)


def test_fps_cpu_dispatch_uses_plain_version():
    rng = np.random.RandomState(3)
    xyz = torch.from_numpy(rng.randn(2, 90, 3).astype(np.float32))
    before = kernels.launch_counts["fps"]
    a = tops.farthest_point_sample(xyz, 20)
    b = tops._farthest_point_sample_torch(xyz, 20)
    assert torch.equal(a, b)
    assert kernels.launch_counts["fps"] == before  # no kernel launch on the CPU


def test_fps_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.fps_cuda(torch.zeros(1, 8, 3), 4)


def test_square_distance():
    rng = np.random.RandomState(0)
    a = rng.randn(2, 17, 3).astype(np.float32)
    b = rng.randn(2, 11, 3).astype(np.float32)
    want = np.asarray(jops.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = tops.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=DIST_TOL, rtol=0)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_knn_point(k):
    rng = np.random.RandomState(1)
    query = rng.randn(2, 21, 3).astype(np.float32)
    data = rng.randn(2, 96, 3).astype(np.float32)
    want_d, want_i = jops.knn_point(k, jnp.asarray(query), jnp.asarray(data))
    got_d, got_i = tops.knn_point(k, torch.from_numpy(query), torch.from_numpy(data))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=DIST_TOL, rtol=0)
    assert not got_d.requires_grad


def test_knn_ties_go_to_lower_index():
    data = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, 0, 2.0]]])
    _, idx = tops.knn_point(3, torch.zeros(1, 1, 3), data)
    assert idx.tolist() == [[[0, 1, 2]]]


def test_three_nn_and_interpolate():
    rng = np.random.RandomState(2)
    query = rng.randn(2, 40, 3).astype(np.float32)
    data = rng.randn(2, 12, 3).astype(np.float32)
    want_d, want_i = jops.three_nn(jnp.asarray(query), jnp.asarray(data))
    got_d, got_i = tops.three_nn(torch.from_numpy(query), torch.from_numpy(data))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=DIST_TOL, rtol=0)
    feats = rng.randn(2, 5, 12).astype(np.float32)
    w = rng.rand(2, 40, 3).astype(np.float32)
    want = jops.three_interpolate(jnp.asarray(feats), want_i, jnp.asarray(w))
    got = tops.three_interpolate(torch.from_numpy(feats), got_i, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_query_ball_point(masked):
    rng = np.random.RandomState(4)
    xyz = (rng.randn(2, 128, 3) * 0.2).astype(np.float32)
    centers = (rng.randn(2, 24, 3) * 0.2).astype(np.float32)
    centers[:, -1] = 10.0  # a centre with no hits -> all index 0
    mask = rng.rand(2, 128) > 0.3 if masked else None
    want = jops.query_ball_point(0.1, 16, jnp.asarray(xyz), jnp.asarray(centers),
                                 None if mask is None else jnp.asarray(mask))
    got = tops.query_ball_point(0.1, 16, torch.from_numpy(xyz), torch.from_numpy(centers),
                                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, -1] == 0).all()


def test_index_gather_group_and_group_all():
    rng = np.random.RandomState(5)
    pts = rng.randn(2, 30, 6).astype(np.float32)
    idx = rng.randint(0, 30, size=(2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.index_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy(),
        np.asarray(jops.index_points(jnp.asarray(pts), jnp.asarray(idx))))
    feat_cf = np.ascontiguousarray(pts.transpose(0, 2, 1))
    np.testing.assert_array_equal(
        tops.gather_operation(torch.from_numpy(feat_cf), torch.from_numpy(idx[:, :, 0])).numpy(),
        np.asarray(jops.gather_operation(jnp.asarray(feat_cf), jnp.asarray(idx[:, :, 0]))))
    np.testing.assert_array_equal(
        tops.group_operation(torch.from_numpy(feat_cf), torch.from_numpy(idx)).numpy(),
        np.asarray(jops.group_operation(jnp.asarray(feat_cf), jnp.asarray(idx))))
    xyz, feats = pts[..., :3], pts[..., 3:]
    want_xyz, want_g = jops.sample_and_group_all(jnp.asarray(xyz), jnp.asarray(feats))
    got_xyz, got_g = tops.sample_and_group_all(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


# ---- the CUDA kernel: needs a card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/fps.cu runs only on the card")
    return torch.device("cuda")


# the three shapes of the tracking path: prepare_batch, sa1, sa2
KERNEL_SHAPES = [(100, 2560, 512, True), (1, 512, 256, False), (1, 256, 128, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=["pipeline", "sa1", "sa2"])
def test_fps_kernel_matches_plain_version(cuda_device, shape):
    b, n, npoint, masked = shape
    rng = np.random.RandomState(n)
    xyz = torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)).to(cuda_device)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.rand(b, n) > 0.4).to(cuda_device)
    got = kernels.fps_cuda(xyz, npoint, mask)
    want = tops._farthest_point_sample_torch(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_fps_kernel_tie_heavy_cloud(cuda_device):
    rng = np.random.RandomState(11)
    xyz = torch.from_numpy(_grid_cloud(rng, 4, 1024)).to(cuda_device)
    got = kernels.fps_cuda(xyz, 60)
    want = tops._farthest_point_sample_torch(xyz, 60)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_fps_kernel_large_cloud_and_capacity(cuda_device):
    # 8192 points take 128 KB of shared memory: above the 48 KB a launch may
    # take without the opt-in that the library makes at load
    rng = np.random.RandomState(13)
    xyz = torch.from_numpy(rng.randn(2, 8192, 3).astype(np.float32)).to(cuda_device)
    got = kernels.fps_cuda(xyz, 64)
    want = tops._farthest_point_sample_torch(xyz, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # above the shared copy's 14336 points the cloud stays in device memory
    kernels.reset_launch_counts()
    xyz = torch.from_numpy(rng.randn(2, 14337, 3).astype(np.float32)).to(cuda_device)
    got = kernels.fps_cuda(xyz, 64)
    assert kernels.launch_counts["fps"] == 1
    assert torch.equal(got, tops._farthest_point_sample_torch(xyz, 64))


# the large clouds of the global-memory path (csrc/fps.cu above kMaxPoints):
# the boundary, masked, a tie-heavy grid, and a reconstructed mesh's size
LARGE_SHAPES = [(4, 14336, 256, False), (4, 14337, 256, False), (4, 14336, 256, True),
                (4, 14337, 256, True), (1, 40000, 2048, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LARGE_SHAPES, ids=lambda s: "x".join(map(str, s[:3]))
                         + "m" * s[3])
def test_fps_kernel_large_clouds(cuda_device, shape):
    b, n, npoint, masked = shape
    rng = np.random.RandomState(n + masked)
    xyz = torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.rand(b, n) > 0.4).to(cuda_device) if masked else None
    got = kernels.fps_cuda(xyz, npoint, mask)
    want = tops._farthest_point_sample_torch(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_fps_kernel_large_tie_heavy_cloud(cuda_device):
    rng = np.random.RandomState(17)
    xyz = torch.from_numpy(_grid_cloud(rng, 2, 16384)).to(cuda_device)
    got = kernels.fps_cuda(xyz, 300)
    want = tops._farthest_point_sample_torch(xyz, 300)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
