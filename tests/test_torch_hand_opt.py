"""Port parity for the MANO shape and pose particle optimisers
(hotrack_tpu_torch.opt.hand_shape, opt.hand_pose) against hotrack_tpu.opt on
the CPU: the bit-identical synthetic rig, shared particle banks injected as
numpy arrays, a 41^3 box volume at 3 mm with a 21-32-32-1 distilled fit
carried across by utils/convert.py, a 64 x 80 seeded mask, 48 pose particles
and 2 iterations.

The JAX package runs its XLA routes on the CPU (the distilled SDF through
XLA and the mask gather; the nearest-voxel volume). The port's `skin`,
`fused` and `separate` routes, here on their plain versions, all compute
that same energy and are each held against the JAX distilled route; the
port's volume route against the JAX volume route.

Tolerances. Iteration-0 energies (of order 0.1 to 1; read from the JAX
function by swapping its particle loop for one evaluation, inside the test
only): 2e-6 absolute (measured 2e-7), with a candidate excused by FLIP = 0.1 / 778 for every
vertex whose float64 pixel lies within 1e-4 pixels of an integer (the routes'
vertices differ by 1e-7 m, 2e-5 pixels at a focal length of 75 pixels) (one
flipped silhouette bit moves a candidate's energy by exactly that much;
most cases have none). After 2 iterations, from the same start: keypoints
2e-5 m, theta 2e-4 rad, rotation 2e-5, translation 2e-5 m, energy 1e-4; the
seeds keep clear of near-ties between a candidate and particle 0 (ROADMAP
queue 3). The shape optimiser with 128 particles is held over its first 8
iterations: beta 1e-3 (of a search that starts at scale 5; measured 2e-4),
energy rtol 1e-3. Past that only one or two candidates still beat particle 0,
one of them within rounding of it, and two correct runs part by a whole step
(0.16 in beta at iteration 20, where the energies are 2.5e-4 and 2.3e-4): the
full 20 iterations are held to what the optimiser is for, the bone lengths.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import mask_of
from hotrack_tpu.mano import layer as jax_layer
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.opt import hand_pose as jax_hand_pose
from hotrack_tpu.opt import hand_shape as jax_hand_shape
from hotrack_tpu.pose.rotations import rotvec_to_matrix as jax_rotvec_to_matrix
from hotrack_tpu_torch.mano import layer
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.opt import hand_pose, hand_shape, particle
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.utils.convert import distilled_to_numpy
from torch_sdf_models import jax_model

SIZE, SCALE = 41, 0.003
HW = (64, 80)
INTR = {"fx": 75.0, "fy": 75.0, "cx": 40.0, "cy": 32.0}
WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
           "vis_regu_loss": 10.0, "invis_regu_loss": 0.5, "temporal_smooth": 1.0}
P = 48
FLIP = 0.1 / 778


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bank(seed, p, d):
    bank = np.random.RandomState(seed).randn(p, d).astype(np.float32)
    bank[0] = 0.0
    return bank


# ------------------------------------------------------------------ shape

def test_kp2length_and_constants_match_jax():
    kp = np.random.RandomState(0).randn(3, 21, 3).astype(np.float32)
    np.testing.assert_allclose(hand_shape.kp2length(_t(kp)).numpy(),
                               np.asarray(jax_hand_shape.kp2length(jnp.asarray(kp))),
                               atol=1e-7, rtol=0)
    assert tuple(hand_shape.kp2length(_t(kp[0])).shape) == (15,)
    assert hand_shape.SHAPE_SPEC == particle.ParticleSpec(*jax_hand_shape.SHAPE_SPEC)
    assert hand_shape.INITIAL_SCALE == jax_hand_shape.INITIAL_SCALE
    assert hand_shape.BONE_IDX == jax_hand_shape.BONE_IDX
    assert hand_shape.BONE_PARENT == jax_hand_shape.BONE_PARENT
    assert hand_pose.POSE_SPEC == particle.ParticleSpec(*jax_hand_pose.POSE_SPEC)
    for name in ("INITIAL_SCALE", "THETA_SCALE", "NCOMPS", "TIP_KP_IDS"):
        assert getattr(hand_pose, name) == getattr(jax_hand_pose, name), name


@pytest.mark.parametrize("rows", [1, 5])
def test_optimize_hand_shape_recovers_bone_lengths_and_matches_jax(rows):
    """One target row, and a history of rows around it (shape modes 1-2, 3)."""
    tm, jm = synthetic_mano_model(), jax_mano()
    rng = np.random.RandomState(2)
    gt_beta = (rng.randn(1, 10) * 2.0).astype(np.float32)
    _, gt_kp = layer.mano_forward(tm, torch.zeros(1, 48), betas=_t(gt_beta))
    target = hand_shape.kp2length(gt_kp).numpy()
    target = target + (rng.randn(rows, 15) * 1e-3 * (rows > 1)).astype(np.float32)
    bank = _bank(3, 128, 10)

    trace = []
    shape, energy = hand_shape.optimize_hand_shape(tm, _t(bank), _t(target), iterations=8,
                                                   trace=trace)
    jshape, jenergy = jax_hand_shape.optimize_hand_shape(jm, jnp.asarray(bank),
                                                         jnp.asarray(target), iterations=8)
    assert tuple(shape.shape) == (1, 10) and energy.dim() == 0 and len(trace) == 8
    np.testing.assert_allclose(shape.numpy(), np.asarray(jshape), atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(energy), float(jenergy), rtol=1e-3, atol=1e-7)
    shape, energy = hand_shape.optimize_hand_shape(tm, _t(bank), _t(target))
    _, jenergy = jax_hand_shape.optimize_hand_shape(jm, jnp.asarray(bank), jnp.asarray(target))
    assert 0.5 < float(energy) / float(jenergy) < 2.0

    def bone_error(beta):
        _, kp = layer.mano_forward(tm, torch.zeros(1, 48), betas=beta)
        return float(torch.mean(torch.abs(hand_shape.kp2length(kp) - _t(target))))

    assert bone_error(shape) < 0.5 * bone_error(torch.zeros(1, 10))
    # a start other than zero is taken as given
    again, _ = hand_shape.optimize_hand_shape(tm, _t(bank), _t(target), init_shape=shape,
                                              iterations=2)
    assert bone_error(again) <= bone_error(shape) + 1e-9


# ------------------------------------------------------------------ zones

def test_load_contact_zones_matches_jax(tmp_path):
    import pickle
    got, want = hand_pose.load_contact_zones(None), jax_hand_pose.load_contact_zones(None)
    np.testing.assert_array_equal(got.tips_idx.numpy(), np.asarray(want.tips_idx))
    np.testing.assert_array_equal(got.tips_mask.numpy(), np.asarray(want.tips_mask))
    assert got.tips_idx.dtype == torch.int64 and tuple(got.tips_idx.shape) == (5, 16)
    # the Obman pickle: zones 1..5, ragged, padded with masked zeros
    zones = {i: list(range(10 * i, 10 * i + 3 + i)) for i in range(6)}
    path = tmp_path / "contact_zones.pkl"
    with open(path, "wb") as f:
        pickle.dump({"contact_zones": zones}, f)
    got, want = hand_pose.load_contact_zones(str(path)), jax_hand_pose.load_contact_zones(str(path))
    np.testing.assert_array_equal(got.tips_idx.numpy(), np.asarray(want.tips_idx))
    np.testing.assert_array_equal(got.tips_mask.numpy(), np.asarray(want.tips_mask))
    assert tuple(got.tips_idx.shape) == (5, 8) and int(got.tips_mask.sum()) == 4 + 5 + 6 + 7 + 8


def test_world2point2d_matches_jax():
    xyz = np.random.RandomState(1).randn(4, 7, 3).astype(np.float32) + np.float32([0, 0, 3])
    np.testing.assert_allclose(
        hand_pose.world2point2d(_t(xyz), 600.0, 590.0, 320.0, 240.0).numpy(),
        np.asarray(jax_hand_pose.world2point2d(jnp.asarray(xyz), 600.0, 590.0, 320.0, 240.0)),
        rtol=1e-6, atol=1e-4)


# ------------------------------------------------------------------- pose

@pytest.fixture(scope="module")
def scene():
    """A hand 0.45 m in front of the camera around the box, a perturbed
    start, a network prediction near the truth with three hidden keypoints."""
    vol = synthetic_box_sdf_setup(SIZE, SCALE)
    tmodel = distill_sdf_volume(vol, SCALE, torch.Generator().manual_seed(0), steps=300,
                                batch=1024, hidden=32, depth=2, pool_batches=16)
    tm = synthetic_mano_model()
    rng = np.random.RandomState(4)
    gt_theta = (rng.randn(1, 45) * 0.2).astype(np.float32)
    gt_r = np.array(jax_rotvec_to_matrix(jnp.asarray(rng.randn(1, 3) * 0.3, jnp.float32)))
    gt_t = np.array([[[0.02], [-0.01], [0.45]]], np.float32)
    beta = (rng.randn(1, 10) * 0.3).astype(np.float32)
    from hotrack_tpu_torch.pose.rotations import matrix_to_rotvec
    pose = torch.cat([matrix_to_rotvec(_t(gt_r)), _t(gt_theta)], dim=-1)
    _, gt_kp = layer.mano_forward(tm, pose, betas=_t(beta), trans=_t(gt_t[..., 0]))
    init_r = gt_r @ np.array(jax_rotvec_to_matrix(jnp.asarray([[0.05, 0.03, -0.04]], jnp.float32)))
    vis = np.ones((1, 21), bool)
    vis[0, [8, 12, 20]] = False   # two invisible fingertips and one more
    return dict(
        vol=vol, tmodel=tmodel, jmodel=jax_model(distilled_to_numpy(tmodel)),
        beta=beta, init_r=init_r.astype(np.float32), init_t=gt_t + np.float32(0.01),
        init_theta=gt_theta + np.float32(0.1),
        pred_kp=gt_kp.numpy() + (rng.randn(1, 21, 3) * 2e-3).astype(np.float32),
        gt_kp=gt_kp.numpy(), vis=vis,
        last_kp=gt_kp.numpy() + (rng.randn(1, 21, 3) * 3e-3).astype(np.float32),
        obj_r=np.array(jax_rotvec_to_matrix(jnp.asarray([0.2, -0.1, 0.3], jnp.float32))),
        obj_t=np.array([0.0, 0.0, 0.47], np.float32), mask=mask_of(HW, 6),
        bank=_bank(5, P, 16))


def _torch_run(scene, route, iterations=2, trace=None, has_last=1.0, mask=None):
    mask = scene["mask"] if mask is None else mask
    return hand_pose.optimize_hand_pose(
        synthetic_mano_model(), _t(scene["bank"]), hand_pose.load_contact_zones(None),
        scene["vol"], _t(scene["beta"]), _t(scene["init_r"]), _t(scene["init_t"]),
        _t(scene["init_theta"]), _t(scene["pred_kp"]), _t(scene["vis"]), _t(scene["last_kp"]),
        has_last, _t(scene["obj_r"]), _t(scene["obj_t"]), _t(mask), INTR, WEIGHTS,
        voxel_scale=SCALE, iterations=iterations,
        distilled=None if route == "volume" else scene["tmodel"],
        hand_energy="skin" if route == "volume" else route, trace=trace)


def _jax_run(scene, route, iterations=2, has_last=1.0, mask=None):
    mask = scene["mask"] if mask is None else mask
    return jax_hand_pose.optimize_hand_pose(
        jax_mano(), jnp.asarray(scene["bank"]), jax_hand_pose.load_contact_zones(None),
        jnp.asarray(scene["vol"].numpy()), jnp.asarray(scene["beta"]),
        jnp.asarray(scene["init_r"]), jnp.asarray(scene["init_t"]),
        jnp.asarray(scene["init_theta"]), jnp.asarray(scene["pred_kp"]),
        jnp.asarray(scene["vis"]), jnp.asarray(scene["last_kp"]), jnp.asarray(has_last),
        jnp.asarray(scene["obj_r"]), jnp.asarray(scene["obj_t"]), jnp.asarray(mask), INTR,
        WEIGHTS, voxel_scale=SCALE, iterations=iterations,
        distilled=None if route == "volume" else scene["jmodel"])


@pytest.fixture(scope="module")
def jax_first_energies(scene):
    """The JAX function's energies of iteration 0, per JAX route: its
    particle loop swapped for one evaluation of its own energy closure."""
    real = jax_hand_pose.run_particle_opt

    def first_energies(spec, presampled, initial_scale, params, energy_fn, apply_mean,
                       extend_sample, **_):
        energy, _ = energy_fn(params, extend_sample(presampled * initial_scale))
        return params, energy

    jax_hand_pose.run_particle_opt = first_energies
    jax_hand_pose.optimize_hand_pose.clear_cache()
    try:
        out = {route: np.asarray(_jax_run(scene, route, iterations=1)[4])
               for route in ("separate", "volume")}
    finally:
        jax_hand_pose.run_particle_opt = real
        jax_hand_pose.optimize_hand_pose.clear_cache()
    return out


def _near_integer_pixels(scene):
    """Per candidate of iteration 0: how many vertices have a float64 pixel
    coordinate within 1e-4 pixels of an integer."""
    tm = synthetic_mano_model()
    sample = particle.quat_extend(_t(scene["bank"]) * hand_pose.INITIAL_SCALE)
    from hotrack_tpu_torch.pose.rotations import (mano_quat2axisang, matrix_to_unit_quaternion,
                                                  unit_quaternion_to_matrix)
    r = torch.matmul(_t(scene["init_r"]), unit_quaternion_to_matrix(sample[:, :4]))
    t = _t(scene["init_t"]) + sample[:, 4:7, None]
    theta = _t(scene["init_theta"]) + layer.pca_comps2pose(tm, sample[:, 7:]) * 30.0
    pose = torch.cat([mano_quat2axisang(matrix_to_unit_quaternion(r)), theta], dim=-1)
    verts, _ = layer.mano_forward(tm, pose, trans=t[..., 0],
                                  shaped=layer.shape_hand(tm, _t(scene["beta"])))
    v = verts.double()
    px = torch.stack([v[..., 1] / v[..., 2] * INTR["fy"] + INTR["cy"],
                      v[..., 0] / v[..., 2] * INTR["fx"] + INTR["cx"]])
    return ((px - torch.round(px)).abs() < 1e-4).any(dim=0).sum(dim=-1).numpy()


@pytest.mark.parametrize("route", ["skin", "fused", "separate", "volume"])
def test_energies_at_iteration_0_match_jax(scene, jax_first_energies, route):
    trace = []
    _torch_run(scene, route, iterations=1, trace=trace)
    energy = trace[0][0].numpy()
    want = jax_first_energies["volume" if route == "volume" else "separate"]
    assert energy.shape == (P,) and np.isfinite(energy).all()
    assert want.max() - want.min() > 1e-3            # the candidates do differ
    excused = FLIP * _near_integer_pixels(scene)
    assert (excused == 0).mean() > 0.5
    assert (np.abs(energy - want) <= 2e-6 + excused).all(), np.abs(energy - want).max()


def _hold_run(got, want):
    for g, w, atol in zip(got, want, (2e-5, 2e-4, 2e-5, 2e-5, 1e-4)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("route", ["skin", "fused", "separate", "volume"])
def test_pose_after_2_iterations_matches_jax(scene, route):
    got = _torch_run(scene, route)
    want = _jax_run(scene, "volume" if route == "volume" else "separate")
    assert [tuple(g.shape) for g in got] == [(1, 21, 3), (1, 45), (1, 3, 3), (1, 3, 1), ()]
    _hold_run([g.numpy() for g in got], want)
    np.testing.assert_allclose((got[2][0] @ got[2][0].T).numpy(), np.eye(3), atol=1e-6)


def test_pose_optimiser_improves_the_keypoints(scene):
    """More particles and the shipped 5 iterations on the default route: the
    keypoints end nearer the truth than they began."""
    big = dict(scene, bank=_bank(7, 256, 16))
    final_kp, theta, r, t, energy = _torch_run(big, "skin", iterations=5)
    from hotrack_tpu_torch.pose.rotations import matrix_to_rotvec
    pose = torch.cat([matrix_to_rotvec(_t(scene["init_r"])), _t(scene["init_theta"])], dim=-1)
    _, init_kp = layer.mano_forward(synthetic_mano_model(), pose, betas=_t(scene["beta"]),
                                    trans=_t(scene["init_t"][..., 0]))
    err0 = float(torch.mean(torch.linalg.norm(init_kp - _t(scene["gt_kp"]), dim=-1)))
    err1 = float(torch.mean(torch.linalg.norm(final_kp - _t(scene["gt_kp"]), dim=-1)))
    assert err1 < 0.7 * err0 and np.isfinite(float(energy))


def test_first_frame_and_missing_silhouette_match_jax(scene):
    """has_last = 0 (frame 0: no smoothness term) with the 1 x 1 all-False
    mask a sequence without silhouettes gets."""
    none = np.zeros((1, 1), bool)
    got = _torch_run(scene, "skin", has_last=0.0, mask=none)
    _hold_run([g.numpy() for g in got], _jax_run(scene, "separate", has_last=0.0, mask=none))


def test_routes_and_inputs_are_checked(scene):
    with pytest.raises(ValueError, match="hand_energy"):
        _torch_run(scene, "xla")
    with pytest.raises(ValueError, match="SDF"):
        _torch_run(dict(scene, vol=None), "volume")
