"""Port parity for the distilled SDF (hotrack_tpu_torch/sdf/distill.py and
ops/sdf_mlp.py) against hotrack_tpu/sdf/distill.py and its Pallas kernel
(ops/pallas/sdf_mlp.py, run in interpret mode), on the CPU at small sizes.

On the CPU `eval_distilled_sdf(_cf)` is the plain version of the CUDA kernel
(`_sdf_mlp_torch`), so holding it holds the kernel's oracle.

Tolerances: features 1e-6 (sinf / cosf of float32 angles up to 4 pi); the
clamped sdf 2e-6 against the XLA path (float32 products summed in another
order, values <= 0.05) and 2e-5 against the Pallas kernel (the JAX package's
own bound for it); distillation after 21 Adam steps on injected draws 1e-5
on weights of order 0.1 to 1 (the two runs differ by up to 1.2e-7 on the
first layer and stay below 2e-6 on every leaf; Adam divides by
sqrt(v) + 1e-8, so the float32 rounding of a gradient that is nearly zero is
magnified, which is why the bound is not an ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.ops.pallas import sdf_mlp as jax_kernel
from hotrack_tpu.sdf import distill as jdistill
from hotrack_tpu.sdf.volume import trilinear_sdf as jax_trilinear
from hotrack_tpu_torch.ops import kernels, sdf_mlp
from hotrack_tpu_torch.sdf import distill
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.volume import trilinear_sdf
from hotrack_tpu_torch.utils.convert import distilled_from_numpy, distilled_to_numpy
from torch_sdf_models import random_model


def test_feature_order_matches_jax():
    rng = np.random.RandomState(0)
    pts = (rng.randn(7, 11, 3) * 0.1).astype(np.float32)
    freqs = np.array([np.pi, 2 * np.pi, 4 * np.pi], np.float32)
    got = distill._features(torch.from_numpy(pts), torch.from_numpy(freqs), 5.0)
    want = np.asarray(jdistill._features(jnp.asarray(pts), jnp.asarray(freqs), 5.0))
    assert tuple(got.shape) == (7, 11, 21)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # x | sin axis-major, frequency-minor | cos likewise
    x = pts[0, 0] * 5.0
    np.testing.assert_allclose(got[0, 0, 3:6].numpy(), np.sin(x[0] * freqs), atol=1e-6)
    np.testing.assert_allclose(got[0, 0, 12:15].numpy(), np.cos(x[0] * freqs), atol=1e-6)
    np.testing.assert_allclose(got[0, 0, 9:12].numpy(), np.sin(x[2] * freqs), atol=1e-6)


MODELS = {
    "shipped width": dict(widths=(21, 128, 128, 128)),
    "6 frequencies, depth 4": dict(widths=(39, 128, 128, 128, 128)),
    "narrow, depth 1": dict(widths=(15, 32)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("shape", [(37, 3), (4, 300, 3)])
def test_plain_sdf_mlp_matches_xla_and_pallas(name, shape):
    jmodel, tmodel = random_model(1, **MODELS[name])
    pts = (np.random.RandomState(2).randn(*shape) * 0.08).astype(np.float32)
    got = distill.eval_distilled_sdf(tmodel, torch.from_numpy(pts))
    assert tuple(got.shape) == shape[:-1] and got.dtype == torch.float32
    xla = np.asarray(jdistill.eval_distilled_sdf(jmodel, jnp.asarray(pts)))
    assert 0.02 < np.mean(np.abs(xla) >= 0.05) < 0.9  # the clamp is exercised
    np.testing.assert_allclose(got.numpy(), xla, atol=2e-6, rtol=0)
    pallas = np.asarray(jax_kernel.fused_sdf_mlp(
        jmodel.weights, jmodel.biases, jmodel.freqs, jmodel.scale, jmodel.clamp,
        jnp.asarray(pts), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=0)
    raw = sdf_mlp.raw_sdf_mlp(tmodel, torch.from_numpy(pts))
    np.testing.assert_allclose(raw.numpy(), np.asarray(jdistill._raw_sdf(jmodel, jnp.asarray(pts))),
                               atol=1e-5, rtol=0)
    assert float(raw.abs().max()) > 0.05  # unclamped


def test_plain_sdf_mlp_channels_first_matches_xla_and_pallas():
    jmodel, tmodel = random_model(3, widths=(21, 64, 64, 64))
    pts_cf = (np.random.RandomState(4).randn(5, 3, 130) * 0.08).astype(np.float32)
    got = distill.eval_distilled_sdf_cf(tmodel, torch.from_numpy(pts_cf))
    assert tuple(got.shape) == (5, 130)
    xla = np.asarray(jdistill.eval_distilled_sdf_cf(jmodel, jnp.asarray(pts_cf)))
    np.testing.assert_allclose(got.numpy(), xla, atol=2e-6, rtol=0)
    pallas = np.asarray(jax_kernel.fused_sdf_mlp_cf(
        jmodel.weights, jmodel.biases, jmodel.freqs, jmodel.scale, jmodel.clamp,
        jnp.asarray(pts_cf), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=0)
    # the channels-last entry on the transposed cloud is the same function
    last = distill.eval_distilled_sdf(tmodel, torch.from_numpy(pts_cf).transpose(-1, -2))
    assert torch.equal(last, got)
    # chunked evaluation is the same function (a matrix product of another
    # height may sum in another order: 1e-7)
    chunked = sdf_mlp._sdf_mlp_torch(tmodel, torch.from_numpy(pts_cf), chunk=97)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), atol=1e-7, rtol=0)


def test_plain_sdf_mlp_takes_non_geometric_frequencies():
    jmodel, tmodel = random_model(5, widths=(15, 32, 48), freqs=[1.0, 2.5])
    pts = (np.random.RandomState(6).randn(129, 3) * 0.2).astype(np.float32)
    got = distill.eval_distilled_sdf(tmodel, torch.from_numpy(pts))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdistill.eval_distilled_sdf(jmodel, jnp.asarray(pts))),
        atol=2e-6, rtol=0)


def test_distilled_model_round_trips_through_numpy():
    jmodel, tmodel = random_model(7)
    arrays = distilled_to_numpy(tmodel)
    from_jax = distilled_to_numpy(jmodel)
    assert set(arrays) == set(from_jax) == set(tmodel._fields)
    for w, v in zip(arrays["weights"], from_jax["weights"]):
        assert w.dtype == np.float32 and w.shape == v.shape  # (in, out) in both
        np.testing.assert_array_equal(w, v)
    back = distilled_from_numpy(jmodel)  # straight from the JAX package's tuple
    for a, b in zip(back.weights + back.biases + (back.freqs, back.scale, back.clamp),
                    tmodel.weights + tmodel.biases + (tmodel.freqs, tmodel.scale, tmodel.clamp)):
        assert torch.equal(a, b)
    moved = distill.distilled_to(tmodel, "cpu", torch.float64)
    assert moved.weights[0].dtype == torch.float64 and moved.scale.dtype == torch.float64


def test_models_the_kernels_do_not_take_raise():
    _, wide = random_model(10, widths=(21, 160, 32))
    with pytest.raises(ValueError, match="128 wide"):
        sdf_mlp.check_model(wide)
    _, deep = random_model(10, widths=(9,) + (8,) * 9)
    with pytest.raises(ValueError, match="hidden layers"):
        sdf_mlp.check_model(deep)
    _, ok = random_model(10)
    broken = ok._replace(weights=(ok.weights[0][:-1],) + ok.weights[1:])
    with pytest.raises(ValueError, match="do not chain"):
        sdf_mlp.check_model(broken)
    with pytest.raises(ValueError, match=r"\(\.\.\., 3, N\)"):
        sdf_mlp.fused_sdf_mlp_cf(ok, torch.zeros(4, 2, 5))
    with pytest.raises(ValueError, match=r"\(\.\.\., 3\)"):
        sdf_mlp.fused_sdf_mlp(ok, torch.zeros(4, 2))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never computes on the CPU: only the dispatch in
    ops/sdf_mlp.py sends a CPU tensor to the plain version."""
    _, tmodel = random_model(11)
    before = kernels.launch_counts["sdf_mlp"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sdf_mlp_cuda(torch.zeros(2, 3, 8), sdf_mlp.pack_distilled(tmodel), True)
    assert kernels.launch_counts["sdf_mlp"] == before


# ----------------------------------------------------------------------------
# distillation

V, VOXEL = 17, 0.012
STEPS, BATCH, HIDDEN, DEPTH, POOL = 21, 256, 32, 2, 4


@pytest.fixture(scope="module")
def box():
    vol = synthetic_box_sdf_setup(V, VOXEL, half=(0.04, 0.06, 0.03))
    return vol, jnp.asarray(vol.numpy())


def _jax_draw_near(jvol, ka, kb, n, clamp=0.05):
    """hotrack_tpu/sdf/distill.py's draw_near, outside its jit."""
    half = V // 2
    flat = jnp.clip(jvol.reshape(-1), -clamp, clamp)
    near_w = (jnp.abs(flat) < clamp * 0.98).astype(jnp.float32) + 1e-6
    near_cdf = jnp.cumsum(near_w / jnp.sum(near_w))
    u = jax.random.uniform(ka, (n,))
    idx = jnp.clip(jnp.searchsorted(near_cdf, u), 0, V ** 3 - 1)
    centres = jnp.stack([(idx // (V * V)) - half, (idx // V) % V - half, idx % V - half],
                        axis=-1).astype(jnp.float32) * VOXEL
    return u, idx, centres + jax.random.uniform(kb, centres.shape, minval=-VOXEL, maxval=VOXEL)


def _init_draws(key):
    """Standard normals per layer, as distill_sdf_volume draws its weights."""
    n_freqs = min(jdistill.MAX_FREQS, max(2, int(np.log2(max(V // 2 / 2.0, 4.0))) + 1))
    dims = [3 + 6 * n_freqs] + [HIDDEN] * DEPTH + [1]
    keys = jax.random.split(key, len(dims))
    return tuple(np.asarray(jax.random.normal(keys[i], (dims[i], dims[i + 1])))
                 for i in range(len(dims) - 1))


def _assert_models_close(tmodel, jmodel, atol):
    assert len(tmodel.weights) == len(jmodel.weights) == DEPTH + 1
    for got, want in zip(tmodel.weights + tmodel.biases, jmodel.weights + jmodel.biases):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    np.testing.assert_array_equal(tmodel.freqs.numpy(), np.asarray(jmodel.freqs))
    np.testing.assert_array_equal(tmodel.scale.numpy(), np.asarray(jmodel.scale))
    np.testing.assert_array_equal(tmodel.clamp.numpy(), np.asarray(jmodel.clamp))


def test_near_surface_draw_matches_jax_on_a_small_volume(box):
    tvol, jvol = box
    u, idx, _ = _jax_draw_near(jvol, jax.random.PRNGKey(1), jax.random.PRNGKey(2), 4000)
    flat = torch.clamp(tvol.reshape(-1), -0.05, 0.05)
    got = distill.near_surface_indices(flat, 0.05, torch.from_numpy(np.array(u)))
    # a float32 cumulative sum over 4913 voxels: where the two frameworks round
    # a step of the cdf apart, a draw that falls between moves to the next
    # near-surface voxel (the voxels between weigh 1e-6 and add nothing)
    assert np.mean(got.numpy() != np.asarray(idx)) < 0.002
    near = flat.abs()[got] < 0.05 * 0.98
    assert float(near.float().mean()) > 0.99


def test_pooled_distillation_matches_jax_on_injected_draws(box):
    tvol, jvol = box
    key = jax.random.PRNGKey(7)
    jmodel = jdistill.distill_sdf_volume(jvol, VOXEL, key, steps=STEPS, batch=BATCH,
                                         hidden=HIDDEN, depth=DEPTH, pool_batches=POOL)
    # the draws, as hotrack_tpu/sdf/distill.py splits its key
    hb, hp = BATCH // 2, POOL * (BATCH // 2)
    k, ku, kn1, kn2 = jax.random.split(key, 4)
    extent = V // 2 * VOXEL
    pool_u = jax.random.uniform(ku, (hp, 3), minval=-extent, maxval=extent)
    _, _, pool_n = _jax_draw_near(jvol, kn1, kn2, hp)
    offsets = []
    for _ in range(STEPS):
        k, k1, k2 = jax.random.split(k, 3)
        offsets.append([int(jax.random.randint(k1, (), 0, hp - hb + 1)),
                        int(jax.random.randint(k2, (), 0, hp - hb + 1))])
    tmodel = distill.distill_sdf_volume(
        tvol, VOXEL, steps=STEPS, batch=BATCH, hidden=HIDDEN, depth=DEPTH, pool_batches=POOL,
        draws={"init": _init_draws(key), "pool_u": np.asarray(pool_u),
               "pool_n": np.asarray(pool_n), "offsets": np.asarray(offsets)})
    _assert_models_close(tmodel, jmodel, atol=1e-5)
    moved = max(float((w - torch.from_numpy(i) * float(np.sqrt(np.float32(2.0 / i.shape[0])))
                       * (0.01 if i.shape[1] == 1 else 1.0)).abs().max())
                for w, i in zip(tmodel.weights, _init_draws(key)))
    assert moved > 5e-3  # 21 steps of lr 2e-3 .. 5e-4 did move the weights


def test_fresh_sample_distillation_matches_jax_on_injected_draws(box):
    tvol, jvol = box
    key = jax.random.PRNGKey(8)
    jmodel = jdistill.distill_sdf_volume(jvol, VOXEL, key, steps=STEPS, batch=BATCH,
                                         hidden=HIDDEN, depth=DEPTH, pool_batches=0)
    hb, extent, k, coords = BATCH // 2, V // 2 * VOXEL, key, []
    for _ in range(STEPS):
        k, k1, k2, k3 = jax.random.split(k, 4)
        uni = jax.random.uniform(k1, (hb, 3), minval=-extent, maxval=extent)
        coords.append(np.concatenate([np.asarray(uni),
                                      np.asarray(_jax_draw_near(jvol, k2, k3, hb)[2])]))
    tmodel = distill.distill_sdf_volume(
        tvol, VOXEL, steps=STEPS, batch=BATCH, hidden=HIDDEN, depth=DEPTH, pool_batches=0,
        draws={"init": _init_draws(key), "coords": np.stack(coords)})
    _assert_models_close(tmodel, jmodel, atol=1e-5)


def test_distillation_draws_come_from_the_generator(box):
    tvol, _ = box

    def run(seed, pool):
        return distill.distill_sdf_volume(
            tvol, VOXEL, torch.Generator().manual_seed(seed), steps=6, batch=64,
            hidden=16, depth=2, pool_batches=pool)

    for pool in (2, 0):
        a, b, c = run(1, pool), run(1, pool), run(2, pool)
        assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
        assert not torch.equal(a.weights[0], c.weights[0])
    assert not a.weights[0].requires_grad


def test_too_few_steps_raise(box):
    """The JAX package divides by steps // 3 in its schedule; the port says so."""
    with pytest.raises(ValueError, match="steps >= 3"):
        distill.distill_sdf_volume(box[0], VOXEL, torch.Generator().manual_seed(0), steps=2)


@pytest.mark.parametrize("pool", [16, 0])
def test_distilled_fit_quality_at_a_small_budget(pool):
    """tests/test_distill.py::test_distill_accuracy holds the mean error
    under one voxel (4 mm at 65^3) after 1200 steps of 4096; scaled to this
    33^3 grid at 6 mm: under one voxel after 400 steps of 1024, near the
    surface and over the cube, on both sampling paths."""
    size, scale = 33, 0.006
    vol = synthetic_box_sdf_setup(size, scale, half=(0.03, 0.05, 0.02))
    model = distill.distill_sdf_volume(vol, scale, torch.Generator().manual_seed(5),
                                       steps=400, batch=1024, hidden=64, pool_batches=pool)
    pts = np.random.RandomState(3).uniform(-0.08, 0.08, (2000, 3)).astype(np.float32)
    want = trilinear_sdf(vol, torch.from_numpy(pts), scale, size,
                         bbox_min=-(size // 2) * scale).numpy()
    # the target is the function the JAX package fits
    np.testing.assert_allclose(want, np.asarray(jax_trilinear(
        jnp.asarray(vol.numpy()), jnp.asarray(pts), scale, size,
        bbox_min=-(size // 2) * scale)), atol=1e-7, rtol=0)
    err = np.abs(distill.eval_distilled_sdf(model, torch.from_numpy(pts)).numpy() - want)
    near = np.abs(want) < 0.02
    assert err[near].mean() < scale, err[near].mean()
    assert err.mean() < scale, err.mean()
