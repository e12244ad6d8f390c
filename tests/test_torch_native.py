"""The port's native point-cloud library (hotrack_tpu_torch/native) against
the JAX package's (hotrack_tpu/native) and against its own numpy versions.

Both libraries compile the same C++ (the port's copy of pointcloud.cc), the
JAX package's with -march=native, the port's without and with
-ffp-contract=off. Bounds:
- the depth decode: bitwise the JAX library's, and bitwise its numpy
  version (an integer sum times one float32 scale);
- the back-projection: bitwise the JAX library's; against the numpy
  version, which computes x and y in float64 (given the intrinsics rounded
  to float32, as the library takes them), within 2 float32 roundings of
  each coordinate (NUMPY_RTOL), with the same points kept;
- the radius filter: bitwise, with the points whose squared distance lies
  within RADIUS_MARGIN (relative) of the squared radius kept out of the test
  data (`_clear_of_radius`): a library that contracts dx*dx + dy*dy + dz*dz
  into FMAs may keep one of them where the other drops it.
"""

import numpy as np
import pytest

from hotrack_tpu import native as jax_native
from hotrack_tpu_torch import native

H, W = 48, 64
# cx and cy are not float32 numbers: the library takes the intrinsics in
# float32, so the numpy version is given them rounded (F32_INTRINSICS)
FX, FY, CX, CY = 600.0, 610.3, 31.42, 23.17
F32_INTRINSICS = tuple(float(np.float32(v)) for v in (FX, FY, CX, CY))
NUMPY_RTOL = 2 * np.finfo(np.float32).eps
RADIUS_MARGIN = 1e-5


def _scene(seed):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.3, 0.6, (H, W)).astype(np.float32)
    depth[rng.rand(H, W) < 0.2] = 0.0
    labels = rng.randint(0, 3, (H, W)).astype(np.uint8)
    return depth, labels


def _clear_of_radius(depth, center, radius, stride, sign_y=1.0, sign_z=1.0):
    """Zero the pixels whose point lies within rounding of the radius."""
    rows, cols = np.mgrid[0:H, 0:W]
    z = depth.astype(np.float64)
    p = np.stack([(cols - CX) * z / FX, (rows - CY) * z / FY * sign_y, z * sign_z], -1)
    d2 = ((p - np.asarray(center, np.float64)) ** 2).sum(-1)
    near = np.abs(d2 - radius ** 2) <= RADIUS_MARGIN * radius ** 2
    out = depth.copy()
    out[near] = 0.0
    return out


@pytest.fixture(scope="module")
def jax_lib():
    if not jax_native.available():
        pytest.fail("the JAX package's native library did not build")
    return jax_native


def test_decode_ho3d_depth_matches_the_jax_library_and_numpy(jax_lib):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    got = native.decode_ho3d_depth(img, 0.00012498664727900177)
    assert got.dtype == np.float32 and got.shape == (H, W)
    np.testing.assert_array_equal(got, jax_lib.decode_ho3d_depth(img, 0.00012498664727900177))
    np.testing.assert_array_equal(got, native.decode_ho3d_depth_numpy(img, 0.00012498664727900177))
    # channel 2 is the low byte, channel 1 the high one (BGR of R + G * 256)
    one = np.zeros((1, 2, 3), np.uint8)
    one[0, 0, 2], one[0, 1, 1] = 1, 1
    np.testing.assert_array_equal(native.decode_ho3d_depth(one, 1.0), [[1.0, 256.0]])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("radius", [-1.0, 0.12])
def test_backproject_filter_matches_the_jax_library_and_numpy(jax_lib, stride, masked, radius):
    depth, labels = _scene(stride + 2 * masked)
    center = np.array([0.01, -0.02, -0.45], np.float32)
    kwargs = dict(sign_y=-1.0, sign_z=-1.0, stride=stride)
    if radius > 0:
        depth = _clear_of_radius(depth, center, radius, stride, -1.0, -1.0)
        kwargs.update(center=center, radius=radius)
    mask = labels if masked else None
    got = native.backproject_filter(depth, mask, 1, FX, FY, CX, CY, **kwargs)
    want = jax_lib.backproject_filter(depth, mask, 1, FX, FY, CX, CY, **kwargs)
    assert got.dtype == np.float32 and got.shape[1] == 3 and len(got) > 50
    np.testing.assert_array_equal(got, want)
    plain = native.backproject_filter_numpy(depth, mask, 1, *F32_INTRINSICS, **kwargs)
    assert plain.shape == got.shape
    np.testing.assert_allclose(got, plain, rtol=NUMPY_RTOL, atol=0)
    if radius > 0:  # the filter kept some points and dropped others
        full = native.backproject_filter(depth, mask, 1, FX, FY, CX, CY, sign_y=-1.0,
                                         sign_z=-1.0, stride=stride)
        assert 0 < len(got) < len(full)


def test_backproject_filter_caps_its_output_and_builds_once():
    depth, _ = _scene(7)
    full = native.backproject_filter(depth, None, 0, FX, FY, CX, CY)
    np.testing.assert_array_equal(
        native.backproject_filter(depth, None, 0, FX, FY, CX, CY, max_out=10), full[:10])
    lib = native.library_path()
    assert lib.exists() and "-march=native" not in native.CXX_FLAGS
    assert native.build() == lib


def test_a_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setenv("HOTRACK_NATIVE_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
