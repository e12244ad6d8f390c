"""Port parity for the particle optimiser (hotrack_tpu_torch.opt.particle)
and the object pose optimiser (opt.obj_pose) against hotrack_tpu.opt, fed
the same particle bank, on the CPU at a small size: a 41^3 box volume at
5 mm, a 21-32-32-1 distilled fit carried across by utils/convert.py, 128
particles on 96 points.

The JAX package runs its composed route (XLA) and its volume route on the
CPU by itself; its fused route is run here by patching `_use_fused_obj` and
sending the Pallas kernel to interpret mode, inside the test only.

Tolerances. Energies of iteration 0 (the mean of 96 |sdf| values x 500, of
order 1 to 10): rtol 5e-6 against the XLA routes, 5e-5 against the Pallas
kernel (its own bound). After 10 iterations the runs are closed loops of
ten dependent steps, each a weighted mean over the particles that beat
particle 0: rotation 2e-5 (matrix entries), translation 2e-6 m, last energy
rtol 2e-4. A particle within rounding of particle 0's energy may enter the
mean in one run only; it enters with a weight near 0, but the quaternion
head of the mean is normalised, so where very few particles are better the
step is not continuous in the set. The seeds here keep clear of that; the
bounds say how far ordinary rounding moves the result.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.ops.pallas import obj_energy as jax_obj_kernel
from hotrack_tpu.opt import obj_pose as jax_obj_pose
from hotrack_tpu.opt import particle as jparticle
from hotrack_tpu.pose.rotations import rotvec_to_matrix as jax_rotvec_to_matrix
from hotrack_tpu.pose.rotations import unit_quaternion_to_matrix as jax_quat_to_matrix
from hotrack_tpu.sdf import distill as jdistill
from hotrack_tpu.sdf.volume import trilinear_sdf as jax_trilinear
from hotrack_tpu_torch.opt import obj_pose, particle
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.utils.convert import distilled_to_numpy
from torch_sdf_models import jax_model

SIZE, SCALE = 41, 0.005
HALF = np.array([0.035, 0.05, 0.025])
P, N = 128, 96


def _bank(seed, p=P, d=6):
    bank = np.random.RandomState(seed).randn(p, d).astype(np.float32)
    bank[0] = 0.0
    return bank


def test_presampled_bank_and_helpers_match_jax():
    bank = particle.presample_particles(64, 6, torch.Generator().manual_seed(3))
    again = particle.presample_particles(64, 6, torch.Generator().manual_seed(3))
    assert tuple(bank.shape) == (64, 6) and bank.dtype == torch.float32
    assert torch.equal(bank, again) and bool((bank[0] == 0).all())
    assert 0.8 < float(bank[1:].std()) < 1.2
    draw = np.random.RandomState(0).randn(8, 6)
    given = particle.presample_particles(8, 6, draw=draw)
    np.testing.assert_array_equal(given[1:].numpy(), draw[1:].astype(np.float32))
    assert bool((given[0] == 0).all()) and draw[0].any()  # the caller's array is left alone

    scaled = _bank(1, 32) * 0.3
    scaled[5, :3] = 0.9  # |q_xyz| > 1: the clamp of qw at 0
    np.testing.assert_allclose(particle.quat_extend(torch.from_numpy(scaled)).numpy(),
                               np.asarray(jparticle.quat_extend(jnp.asarray(scaled))),
                               atol=1e-7, rtol=0)
    mean = np.random.RandomState(2).randn(7).astype(np.float32)
    np.testing.assert_allclose(
        particle.normalize_quat_head(torch.from_numpy(mean)).numpy(),
        np.asarray(jparticle.normalize_quat_head(jnp.asarray(mean))), atol=1e-7, rtol=0)
    r = np.array(jax_rotvec_to_matrix(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    r = r + np.random.RandomState(3).randn(3, 3).astype(np.float32) * 0.01
    np.testing.assert_allclose(obj_pose._reproject_so3(torch.from_numpy(r)).numpy(),
                               np.asarray(jax_obj_pose._reproject_so3(jnp.asarray(r))),
                               atol=1e-6, rtol=0)
    assert obj_pose.OBJ_SPEC == particle.ParticleSpec(*jax_obj_pose.OBJ_SPEC)
    assert obj_pose.SCALING_COEFFICIENT1 == jax_obj_pose.SCALING_COEFFICIENT1


def _quadratic(target):
    """energy = |x + sample - target|^2 for both packages; aux = 2 x energy."""
    def jax_energy(params, sample):
        e = jnp.sum((params[0][None] + sample - jnp.asarray(target)) ** 2, axis=1)
        return e, 2.0 * e

    def torch_energy(params, sample):
        e = torch.sum((params[0][None] + sample - torch.from_numpy(target)) ** 2, dim=1)
        return e, 2.0 * e

    return jax_energy, torch_energy


@pytest.mark.parametrize("case", ["descent", "at the optimum", "mixed"])
def test_run_particle_opt_matches_jax_on_a_quadratic(case):
    """The shared loop on an energy both packages compute exactly alike:
    successes with momentum, a run in which no particle is ever better (the
    parameters stay, the energy is particle 0's), and a run that has both."""
    dim = 5
    target = np.array([0.3, -0.2, 0.1, 0.0, 0.25], np.float32)
    start = {"descent": np.zeros(dim, np.float32), "at the optimum": target.copy(),
             "mixed": target + np.float32(0.02)}[case]
    bank = _bank(4, 48, dim)
    if case == "mixed":
        bank[1:] += 3.0 * np.sign(bank[1:])  # coarse steps only: fine moves fail
    jspec = jparticle.ParticleSpec(iterations=8, scaling_coefficient2=2.0, weight_eps=1e-5)
    tspec = particle.ParticleSpec(*jspec)
    jax_energy, torch_energy = _quadratic(target)
    (jx,), jlast = jparticle.run_particle_opt(
        jspec, jnp.asarray(bank), 0.05, (jnp.asarray(start),), jax_energy,
        lambda params, mean: (params[0] + mean,))
    trace = []
    (tx,), tlast = particle.run_particle_opt(
        tspec, torch.from_numpy(bank), 0.05, (torch.from_numpy(start),), torch_energy,
        lambda params, mean: (params[0] + mean,), trace=trace)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tlast), float(jlast), rtol=1e-5, atol=1e-9)
    successes = [bool(s) for _, s, _ in trace]
    assert len(trace) == 8 and all(e.shape == (48,) for e, _, _ in trace)
    if case == "descent":
        assert all(successes)
        assert float(torch.sum((tx - torch.from_numpy(target)) ** 2)) < 0.1 * float(
            np.sum(target ** 2))
    elif case == "at the optimum":
        assert not any(successes)
        assert torch.equal(tx, torch.from_numpy(start))  # parameters untouched
        assert float(tlast) == 0.0                       # aux of particle 0
        assert all(bool((m == 0).all()) for _, _, m in trace)
    else:
        assert any(successes) and not all(successes)


# ----------------------------------------------------------------------------
# the object pose optimiser

@pytest.fixture(scope="module")
def scene():
    """Volume, distilled fit (both packages), one observed cloud with its
    ground-truth and initial pose."""
    vol = synthetic_box_sdf_setup(SIZE, SCALE)
    tmodel = distill_sdf_volume(vol, SCALE, torch.Generator().manual_seed(0), steps=300,
                                batch=1024, hidden=32, depth=2, pool_batches=16)
    jmodel = jax_model(distilled_to_numpy(tmodel))
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1, 1, (N, 3)) * HALF
    face = rng.randint(0, 3, N)
    pts[np.arange(N), face] = rng.choice([-1.0, 1.0], N) * HALF[face]
    gt_r = np.array(jax_rotvec_to_matrix(jnp.asarray(rng.randn(3) * 0.4, jnp.float32)))
    gt_t = (rng.randn(3, 1) * 0.02).astype(np.float32)
    cam = (pts @ gt_r.T + gt_t[:, 0]).astype(np.float32)
    init_r = gt_r @ np.array(jax_rotvec_to_matrix(jnp.asarray([0.07, -0.05, 0.04], jnp.float32)))
    init_t = gt_t + np.array([[0.008], [-0.01], [0.009]], np.float32)
    return {"vol": vol, "jvol": jnp.asarray(vol.numpy()), "tmodel": tmodel, "jmodel": jmodel,
            "cam": cam, "gt_r": gt_r, "gt_t": gt_t, "init_r": init_r.astype(np.float32),
            "init_t": init_t, "bank": _bank(5)}


def _torch_run(scene, route, iterations=10, trace=None):
    distilled = None if route == "volume" else scene["tmodel"]
    return obj_pose.optimize_obj_pose(
        scene["vol"], torch.from_numpy(scene["bank"]), torch.from_numpy(scene["cam"]),
        torch.from_numpy(scene["init_r"]), torch.from_numpy(scene["init_t"]),
        voxel_scale=SCALE, bbox_res=SIZE, iterations=iterations, distilled=distilled,
        obj_energy="composed" if route == "composed" else "fused", trace=trace)


def _jax_run(scene, route, iterations=10):
    return jax_obj_pose.optimize_obj_pose(
        scene["jvol"], jnp.asarray(scene["bank"]), jnp.asarray(scene["cam"]),
        jnp.asarray(scene["init_r"]), jnp.asarray(scene["init_t"]), voxel_scale=SCALE,
        bbox_res=SIZE, iterations=iterations,
        distilled=None if route == "volume" else scene["jmodel"])


def _jax_energies_at_iteration_0(scene, route):
    """hotrack_tpu.opt.obj_pose's energy_fn on the first candidates."""
    sample = jparticle.quat_extend(jnp.asarray(scene["bank"]) * jax_obj_pose.SCALING_COEFFICIENT1)
    r, t = jnp.asarray(scene["init_r"]), jnp.asarray(scene["init_t"])
    pcld = jnp.asarray(scene["cam"])
    new_r = jnp.matmul(r, jax_quat_to_matrix(sample[:, :4]))
    new_t = t[None] + sample[:, 4:, None]
    if route == "fused":
        sums = jax_obj_kernel.fused_obj_sdf_energy(scene["jmodel"], pcld.T, new_r,
                                                   new_t[..., 0], interpret=True)
        return np.asarray(sums / N * 500.0)
    if route == "composed":
        flat_cf = jnp.matmul(jnp.swapaxes(new_r, -1, -2), pcld.T[None] - new_t)
        sdf = jdistill.eval_distilled_sdf_cf(scene["jmodel"], flat_cf)
    else:
        flat = jnp.matmul(pcld[None] - jnp.swapaxes(new_t, -1, -2), new_r)
        sdf = jax_trilinear(scene["jvol"], flat, SCALE, SIZE, bbox_min=-(SIZE // 2) * SCALE)
    return np.asarray(jnp.mean(jnp.abs(sdf), axis=-1) * 500.0)


@pytest.fixture
def jax_fused_route(monkeypatch):
    """The JAX optimiser on its fused route on the CPU: the Pallas kernel in
    interpret mode. The jit cache holds traces of whichever route was
    current, so it is cleared on the way in and out."""
    real = jax_obj_kernel.fused_obj_sdf_energy
    monkeypatch.setattr(jax_obj_pose, "_use_fused_obj", lambda: True)
    monkeypatch.setattr(jax_obj_kernel, "fused_obj_sdf_energy",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    jax_obj_pose.optimize_obj_pose.clear_cache()
    yield
    jax_obj_pose.optimize_obj_pose.clear_cache()


@pytest.mark.parametrize("route", ["fused", "composed", "volume"])
def test_energies_at_iteration_0_match_jax(scene, route):
    trace = []
    _torch_run(scene, route, iterations=1, trace=trace)
    energy, success, _ = trace[0]
    want = _jax_energies_at_iteration_0(scene, route)
    assert tuple(energy.shape) == (P,) and bool(success)
    assert 0.5 < want.min() and want.max() < 25.0
    np.testing.assert_allclose(energy.numpy(), want, rtol=5e-5 if route == "fused" else 5e-6,
                               atol=0)


def _hold_run(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-6, rtol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=2e-4, atol=1e-8)


@pytest.mark.parametrize("route", ["composed", "volume"])
def test_pose_after_10_iterations_matches_jax(scene, route):
    got = _torch_run(scene, route)
    _hold_run(got, _jax_run(scene, route))
    assert tuple(got[0].shape) == (3, 3) and tuple(got[1].shape) == (3, 1) and got[2].dim() == 0
    # and the optimiser did its work: closer to the ground truth than it began
    assert float(torch.linalg.norm(got[1] - torch.from_numpy(scene["gt_t"]))) \
        < 0.3 * float(np.linalg.norm(scene["init_t"] - scene["gt_t"]))
    np.testing.assert_allclose((got[0] @ got[0].T).numpy(), np.eye(3), atol=1e-6)


def test_fused_route_after_10_iterations_matches_jax(scene, jax_fused_route):
    """Port fused route (plain version of the CUDA kernel) against the JAX
    fused route (Pallas kernel, interpret mode), and against the port's own
    composed route: the same function by another order of operations."""
    got = _torch_run(scene, "fused")
    _hold_run(got, _jax_run(scene, "fused"))
    _hold_run(got, _torch_run(scene, "composed"))


def test_an_iteration_in_which_no_particle_is_better_matches_jax(scene):
    """From the ground-truth pose with a bank of coarse steps only (five
    times the usual spread) no candidate beats 'no change' at first: the
    pose stays, the energy returned is particle 0's, and the search goes on."""
    start = dict(scene, init_r=scene["gt_r"].astype(np.float32), init_t=scene["gt_t"],
                 bank=np.where(np.arange(P)[:, None] == 0, 0.0,
                               scene["bank"] + 5.0 * np.sign(scene["bank"])).astype(np.float32))
    for route in ("fused", "volume"):
        trace = []
        got = _torch_run(start, route, iterations=3, trace=trace)
        assert not bool(trace[0][1])
        assert bool((trace[0][2] == 0).all())
        one = _torch_run(start, route, iterations=1)
        assert torch.equal(one[0], torch.from_numpy(start["init_r"]))
        assert torch.equal(one[1], torch.from_numpy(start["init_t"]))
        assert float(one[2]) == pytest.approx(float(trace[0][0][0]) / 500.0, rel=1e-6)
        _hold_run(got, _jax_run(start, "composed" if route == "fused" else route,
                                iterations=3))


def test_unknown_energy_route_raises(scene):
    with pytest.raises(ValueError, match="obj_energy"):
        obj_pose.optimize_obj_pose(
            None, torch.from_numpy(scene["bank"]), torch.from_numpy(scene["cam"]),
            torch.from_numpy(scene["init_r"]), torch.from_numpy(scene["init_t"]),
            distilled=scene["tmodel"], obj_energy="xla")
