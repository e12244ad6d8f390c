"""Port parity: MANO, rotations, Procrustes and the hand frame of
hotrack_tpu_torch against hotrack_tpu, on the synthetic rig.

Tolerances: the rig is bit-identical (same numpy draws, same float32
rounding); MANO keypoints and vertices agree to 1e-6 m (float32 reassociation
in the blend-shape contractions); rotations to 1e-5 and translations to
1e-6 m (Procrustes on float32 sums; Horn's power iteration is the same
branch-free sequence in both packages).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.mano import layer as jlayer
from hotrack_tpu.mano import model as jmodel
from hotrack_tpu.models import hand_utils as jhu
from hotrack_tpu.pose import procrustes as jproc
from hotrack_tpu.pose import rotations as jrot
from hotrack_tpu_torch.mano import layer as tlayer
from hotrack_tpu_torch.mano import model as tmodel
from hotrack_tpu_torch.models import hand_utils as thu
from hotrack_tpu_torch.pose import procrustes as tproc
from hotrack_tpu_torch.pose import rotations as trot

MANO_TOL = 1e-6   # m
ROT_TOL = 1e-5
T_TOL = 1e-6      # m


@pytest.fixture(scope="module")
def rigs():
    return jmodel.synthetic_mano_model(), tmodel.synthetic_mano_model()


def _pose_batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    pose = (rng.randn(b, 48) * 0.4).astype(np.float32)
    beta = (rng.randn(b, 10) * 0.5).astype(np.float32)
    trans = (rng.randn(b, 3) * 0.1 + [0, 0, 0.5]).astype(np.float32)
    return pose, beta, trans


def test_synthetic_rig_is_bit_identical(rigs):
    jm, tm = rigs
    for name in jmodel.ManoModel._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), err_msg=name)


@pytest.mark.parametrize("original_version,root_palm,with_trans",
                         [(False, False, False), (True, False, True),
                          (False, True, True)])
def test_mano_forward(rigs, original_version, root_palm, with_trans):
    jm, tm = rigs
    pose, beta, trans = _pose_batch()
    jv, jk = jlayer.mano_forward(jm, jnp.asarray(pose), jnp.asarray(beta),
                                 jnp.asarray(trans) if with_trans else None,
                                 original_version=original_version,
                                 root_palm=root_palm)
    tv, tk = tlayer.mano_forward(tm, torch.from_numpy(pose), torch.from_numpy(beta),
                                 torch.from_numpy(trans) if with_trans else None,
                                 original_version=original_version,
                                 root_palm=root_palm)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=MANO_TOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=MANO_TOL, rtol=0)


def test_mano_forward_shaped_and_rodrigues(rigs):
    jm, tm = rigs
    pose, beta, _ = _pose_batch(1)
    j_sh = jlayer.shape_hand(jm, jnp.asarray(beta[:1]))
    t_sh = tlayer.shape_hand(tm, torch.from_numpy(beta[:1]))
    for a, b in zip(t_sh, j_sh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MANO_TOL, rtol=0)
    _, jk = jlayer.mano_forward(jm, jnp.asarray(pose), shaped=j_sh)
    _, tk = tlayer.mano_forward(tm, torch.from_numpy(pose), shaped=t_sh)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=MANO_TOL, rtol=0)
    aa = pose.reshape(-1, 3)
    np.testing.assert_allclose(tlayer.mano_rodrigues(torch.from_numpy(aa)).numpy(),
                               np.asarray(jlayer.mano_rodrigues(jnp.asarray(aa))),
                               atol=1e-6, rtol=0)


def test_rotation_conversions():
    rng = np.random.RandomState(2)
    rv = (rng.randn(16, 3) * 1.2).astype(np.float32)
    rv[0] = 0.0  # the zero-angle branch
    jm = jrot.rotvec_to_matrix(jnp.asarray(rv))
    tm = trot.rotvec_to_matrix(torch.from_numpy(rv))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        trot.matrix_to_unit_quaternion(tm).numpy(),
        np.asarray(jrot.matrix_to_unit_quaternion(jm)), atol=1e-5, rtol=0)


def _palm_problem(seed, b=6):
    """Palm template (6, 3) and rigidly moved, noisy 21-kp hands (B, 21, 3)."""
    rng = np.random.RandomState(seed)
    tmpl = (rng.randn(6, 3) * 0.04).astype(np.float32)
    kp = (rng.randn(b, 21, 3) * 0.04).astype(np.float32)
    rot = np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rng.randn(b, 3) * 1.5,
                                                         jnp.float32)))
    palm = tmpl @ np.swapaxes(rot, -1, -2) + rng.randn(b, 1, 3) * 0.2
    kp[:, list(jmodel.PALM_KP_IDS)] = palm + rng.randn(b, 6, 3) * 0.002
    return tmpl, kp.astype(np.float32)


@pytest.mark.parametrize("solver", ["svd", "horn"])
def test_procrustes_solvers(solver):
    tmpl, kp = _palm_problem(3)
    y = kp[:, list(jmodel.PALM_KP_IDS)]
    jfn = {"svd": jproc.solve_rot_and_trans, "horn": jproc.solve_rot_and_trans_fast}[solver]
    tfn = {"svd": tproc.solve_rot_and_trans, "horn": tproc.solve_rot_and_trans_fast}[solver]
    jr, jt = jfn(jnp.asarray(tmpl), jnp.asarray(y))
    tr, tt = tfn(torch.from_numpy(tmpl), torch.from_numpy(y))
    assert tuple(tr.shape) == (6, 3, 3) and tuple(tt.shape) == (6, 3, 1)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ROT_TOL, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=T_TOL, rtol=0)


def test_horn_agrees_with_svd():
    tmpl, kp = _palm_problem(4)
    y = torch.from_numpy(kp[:, list(jmodel.PALM_KP_IDS)])
    r_svd, t_svd = tproc.solve_rot_and_trans(torch.from_numpy(tmpl), y)
    r_horn, t_horn = tproc.solve_rot_and_trans_fast(torch.from_numpy(tmpl), y)
    torch.testing.assert_close(r_horn, r_svd, atol=ROT_TOL, rtol=0)
    torch.testing.assert_close(t_horn, t_svd, atol=T_TOL, rtol=0)


@pytest.mark.parametrize("exact_env", [False, True])
def test_hand_frame_and_canonicalize(exact_env, monkeypatch):
    if exact_env:
        monkeypatch.setenv("HOTRACK_EXACT_PROCRUSTES", "1")
    else:
        monkeypatch.delenv("HOTRACK_EXACT_PROCRUSTES", raising=False)
    tmpl, kp = _palm_problem(5)
    jpose = jhu.solve_hand_frame(jnp.asarray(tmpl), jnp.asarray(kp))
    tpose = thu.solve_hand_frame(torch.from_numpy(tmpl), torch.from_numpy(kp))
    np.testing.assert_allclose(tpose.rotation.numpy(), np.asarray(jpose.rotation),
                               atol=ROT_TOL, rtol=0)
    np.testing.assert_array_equal(tpose.scale.numpy(), np.asarray(jpose.scale))
    jc = jhu.canonicalize(jnp.asarray(kp), jpose)
    tc = thu.canonicalize(torch.from_numpy(kp), tpose)
    # hand-frame units (metres / 0.2): the rotation's 1e-6 rounding, scaled
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    back = thu.decanonicalize(tc, tpose)
    np.testing.assert_allclose(back.numpy(), kp, atol=1e-6, rtol=0)


# ---- additions of the training slice ----

def test_quaternion_algebra_and_mano_conversions_match_jax():
    rng = np.random.RandomState(20)
    q = rng.randn(5, 4).astype(np.float32)
    r = rng.randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(
        trot.quat_multiply(torch.from_numpy(q), torch.from_numpy(r)).numpy(),
        np.asarray(jrot.quat_multiply(jnp.asarray(q), jnp.asarray(r))), atol=1e-6)
    aa = (rng.randn(4, 48) * 0.6).astype(np.float32)
    aa[0, :3] = 0.0  # the zero rotation goes through the regularised axis
    jq = jrot.mano_axisang2quat(jnp.asarray(aa))
    tq = trot.mano_axisang2quat(torch.from_numpy(aa))
    assert tuple(tq.shape) == (4, 64)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(trot.mano_quat2axisang(tq).numpy(),
                               np.asarray(jrot.mano_quat2axisang(jq)), atol=1e-5)
    m = np.array(jrot.rotvec_to_matrix(jnp.asarray(aa[:, 3:6])))
    np.testing.assert_allclose(trot.matrix_to_rotvec(torch.from_numpy(m)).numpy(),
                               np.asarray(jrot.matrix_to_rotvec(jnp.asarray(m))), atol=1e-5)


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_noisy_rot_matrix_matches_jax_on_the_same_draws(kind):
    import jax
    key = jax.random.PRNGKey(5)
    ka, kb = jax.random.split(key)
    rng = np.random.RandomState(21)
    m = np.array(jrot.rotvec_to_matrix(jnp.asarray(rng.randn(6, 3).astype(np.float32))))
    want = jrot.noisy_rot_matrix(key, jnp.asarray(m), 0.3, kind)
    unit = jax.random.uniform if kind == "uniform" else jax.random.normal
    draws = (torch.from_numpy(np.array(unit(ka, (6,)))),
             torch.from_numpy(np.array(jax.random.normal(kb, (6, 4)))))
    got = trot.noisy_rot_matrix(torch.from_numpy(m), 0.3, kind, draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # from a generator: seeded, a rotation, and turned by at most a few rad-scales
    a = trot.noisy_rot_matrix(torch.from_numpy(m), 0.3, kind,
                              generator=torch.Generator().manual_seed(1))
    b = trot.noisy_rot_matrix(torch.from_numpy(m), 0.3, kind,
                              generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, torch.from_numpy(m))
    np.testing.assert_allclose(torch.linalg.det(a).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        trot.noisy_rot_matrix(torch.from_numpy(m), 0.3, "cauchy")


def test_kp_bones_and_bone_lengths_match_jax():
    kp = np.random.RandomState(22).randn(3, 21, 3).astype(np.float32)
    assert thu.KP_PARENT == jhu.KP_PARENT
    np.testing.assert_array_equal(thu.kp_bones(torch.from_numpy(kp)).numpy(),
                                  np.asarray(jhu.kp_bones(jnp.asarray(kp))))
    np.testing.assert_allclose(thu.kp2bone_lengths(torch.from_numpy(kp)).numpy(),
                               np.asarray(jhu.kp2bone_lengths(jnp.asarray(kp))), atol=1e-6)
