"""The library code that no entry calls, in both packages: the port's
pose/procrustes.py, pose/rotations.py, pose/pose_fit.py, pose/bbox.py,
models/losses.py, models/hand_utils.jitter_hand_mano and utils/dicts.py
against the JAX package's, on seeded inputs, with the cases the JAX tests
name (tests/test_procrustes.py, test_rotations.py, test_losses.py, and the
reference-parity cases of test_reference_parity.py).

Tolerances: float32 functions of the same arithmetic through two
frameworks' kernels, FLOAT_ATOL on values of order 1; SVD-based fits
SVD_ATOL (LAPACK's float32 SVDs of the same matrix differ in the last bits,
which the fits' products carry); voxel IoUs exactly (boolean counts of the
same grid, the grid's points within float32 rounding of the boxes' faces
excluded by construction: the boxes are seeded away from the sample
points); integer outputs exactly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.models import hand_utils as jhand
from hotrack_tpu.models import losses as jlosses
from hotrack_tpu.pose import bbox as jbbox
from hotrack_tpu.pose import pose_fit as jfit
from hotrack_tpu.pose import procrustes as jproc
from hotrack_tpu.pose import rotations as jrot
from hotrack_tpu.utils import dicts as jdicts
from hotrack_tpu_torch.models import hand_utils, losses
from hotrack_tpu_torch.pose import bbox, pose_fit, procrustes, rotations
from hotrack_tpu_torch.utils import dicts


class _Jitted:
    """A JAX module whose functions run under jax.jit (strings, bools and
    ints static): one compile a function, where eager dispatch compiles each
    primitive, which costs this file most of its time."""

    def __init__(self, module, static=()):
        self._module, self._static = module, static

    def __getattr__(self, name):
        import inspect
        fn = getattr(self._module, name)
        params = inspect.signature(fn).parameters
        return jax.jit(fn, static_argnames=[a for a in self._static if a in params])


jproc = _Jitted(jproc, ("sym",))
jrot = _Jitted(jrot)
jfit = _Jitted(jfit, ("num_parts", "sym"))
jlosses_eager = jlosses
jlosses = _Jitted(jlosses, ("loss", "per_instance", "sym", "pwm_num", "metric",
                            "last_dim", "num_parts", "self_supervise", "collapse"))

FLOAT_ATOL = 2e-6
SVD_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small operations: one intra-op thread, which does not contend with the
    suite's other workers. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=FLOAT_ATOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), atol=atol, rtol=0)


def _rots(rng, *shape):
    q = rng.standard_normal((*shape, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return rotations.unit_quaternion_to_matrix(_t(q.astype(np.float32))).numpy()


# ------------------------------------------------------------------ procrustes

def _similarity(seed, b=4, n=32, noise=0.0, dims=3):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, n, dims)).astype(np.float32)
    if dims == 3:
        rot = _rots(rng, b)
    else:
        th = rng.uniform(-np.pi, np.pi, b)
        rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                        np.stack([np.sin(th), np.cos(th)], -1)], -2).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (b,)).astype(np.float32)
    trans = rng.standard_normal((b, dims)).astype(np.float32)
    tgt = (scale[:, None, None] * np.einsum("bij,bnj->bni", rot, src) + trans[:, None]
           + noise * rng.standard_normal((b, n, dims))).astype(np.float32)
    return src, tgt, rot, scale, trans


@pytest.mark.parametrize("sym", [False, True])
def test_transform_pts_matches_jax(sym):
    src, tgt, rot, scale, trans = _similarity(2, noise=0.01)
    want = jproc.transform_pts(jnp.asarray(src), jnp.asarray(tgt), sym=sym)
    got = procrustes.transform_pts(_t(src), _t(tgt), sym=sym)
    _close(got, want, SVD_ATOL)
    if not sym:   # the JAX test's case: the exact similarity is recovered
        _close(got[0], rot, 1e-2)
        _close(got[1], scale, 1e-2)
    # the pieces, and a given rotation and scale
    sc = src - src.mean(1, keepdims=True)
    tc = tgt - tgt.mean(1, keepdims=True)
    _close(procrustes.rotate_pts(_t(sc), _t(tc)), jproc.rotate_pts(jnp.asarray(sc),
                                                                   jnp.asarray(tc)), SVD_ATOL)
    _close(procrustes.scale_pts(_t(sc), _t(tc)), jproc.scale_pts(jnp.asarray(sc),
                                                                 jnp.asarray(tc)))
    _close(procrustes.translate_pts(_t(sc).transpose(1, 2), _t(tc).transpose(1, 2)),
           jproc.translate_pts(jnp.asarray(sc).swapaxes(1, 2), jnp.asarray(tc).swapaxes(1, 2)))
    given = procrustes.transform_pts(_t(src), _t(tgt), given_scale=_t(scale), rotation=_t(rot))
    _close(given, jproc.transform_pts(jnp.asarray(src), jnp.asarray(tgt),
                                      given_scale=jnp.asarray(scale),
                                      rotation=jnp.asarray(rot)))


def test_2d_fits_and_the_yaw_embedding_match_jax():
    src, tgt, rot, _, _ = _similarity(4, b=4, n=16, dims=2)
    tgt = np.einsum("bij,bnj->bni", rot, src).astype(np.float32)   # rigid, no offset
    want = jproc.transform_pts_2d(jnp.asarray(src), jnp.asarray(tgt))
    got = procrustes.transform_pts_2d(_t(src), _t(tgt))
    _close(got, want, SVD_ATOL)
    _close(got[0], rot, 1e-4)
    # a degenerate problem (all points alike) falls back to the identity
    flat = np.zeros((1, 8, 2), np.float32)
    _close(procrustes.rotate_pts_2d(_t(flat), _t(flat)),
           jproc.rotate_pts_2d(jnp.asarray(flat), jnp.asarray(flat)))
    _close(procrustes.rot_around_yaxis_to_3d(_t(rot)),
           jproc.rot_around_yaxis_to_3d(jnp.asarray(rot)))


@pytest.mark.parametrize("sym", [False, True])
def test_masked_fits_match_jax(sym):
    src, tgt, rot, _, trans = _similarity(3, b=2, n=64)
    tgt = (np.einsum("bij,bnj->bni", rot, src) + trans[:, None]).astype(np.float32)
    tgt[:, -16:] += 100.0                  # the JAX test's outliers, masked out
    mask = np.ones((2, 64, 1), np.float32)
    mask[:, -16:] = 0.0
    weights = (mask * np.random.RandomState(0).uniform(0.5, 1.5, (2, 64, 1))).astype(np.float32)
    ones = np.ones((2,), np.float32)
    for w, gs in ((mask, ones), (weights, None)):
        want = jproc.transform_pts_mask(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
                                        jnp.asarray(w), None if gs is None else jnp.asarray(gs),
                                        sym=sym)
        got = procrustes.transform_pts_mask(_t(src), _t(tgt), _t(mask), _t(w),
                                            None if gs is None else _t(gs), sym=sym)
        _close(got, want, SVD_ATOL)
    if not sym:
        _close(got[0], rot, 1e-3)
    _close(procrustes.transform_pts_2d_mask(_t(src[..., [0, 2]]), _t(tgt[..., [0, 2]]), _t(mask)),
           jproc.transform_pts_2d_mask(jnp.asarray(src[..., [0, 2]]),
                                       jnp.asarray(tgt[..., [0, 2]]), jnp.asarray(mask)),
           SVD_ATOL)
    _close(procrustes._masked_center(_t(src), _t(mask)),
           jproc._masked_center(jnp.asarray(src), jnp.asarray(mask)))


def test_part_fit_st_no_ransac_matches_jax():
    """The reference-parity test's case: two parts a row, known rotations."""
    rng = np.random.RandomState(15)
    n = 64
    labels = rng.randint(0, 2, (2, n))
    source = (rng.randn(2, n, 3) * 0.05).astype(np.float32)
    rot = _rots(np.random.default_rng(1), 2, 2)
    scale_true = (rng.rand(2, 2) + 0.5).astype(np.float32)
    target = np.zeros_like(source)
    for bi in range(2):
        for pi in range(2):
            m = labels[bi] == pi
            target[bi, m] = scale_true[bi, pi] * source[bi, m] @ rot[bi, pi].T + 0.02 * pi
    for sym in (False, True):
        want = jfit.part_fit_st_no_ransac(jnp.asarray(labels), jnp.asarray(source),
                                          jnp.asarray(target), jnp.asarray(rot), 2, sym=sym)
        got = pose_fit.part_fit_st_no_ransac(_t(labels), _t(source), _t(target), _t(rot), 2,
                                             sym=sym)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], SVD_ATOL)
    got = pose_fit.part_fit_st_no_ransac(_t(labels), _t(source), _t(target), _t(rot), 2)
    _close(got["scale"], scale_true, 1e-4)


# ------------------------------------------------------------------ rotations

def test_rotation_functions_match_jax():
    rng = np.random.RandomState(14)
    rotvec = (rng.randn(32, 3) * 1.2).astype(np.float32)
    # the gimbal-lock-adjacent cases of the reference-parity test, and both locks
    rotvec[0] = [0.0, 0.0, np.pi / 2 - 1e-4]
    rotvec[1] = [0.0, 0.0, -(np.pi / 2 - 1e-4)]
    rotvec[2] = [0.0, 0.0, np.pi / 2 + 0.05]
    rotvec[3] = [0.0, 0.0, -(np.pi / 2 + 0.05)]
    rotvec[4] = 0.0
    want = jrot.rotvec_to_euler(jnp.asarray(rotvec))
    got = rotations.rotvec_to_euler(_t(rotvec))
    _close(got, want, 1e-5)
    back = rotations.euler_to_rotvec(got)
    _close(back, jrot.euler_to_rotvec(want), 1e-5)
    # away from the locks (rows 0-3) the round trip gives the rotation back
    _close(rotations.rotvec_to_matrix(back)[4:], jrot.rotvec_to_matrix(jnp.asarray(rotvec))[4:],
           1e-4)
    q = rng.randn(16, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.randn(16, 3).astype(np.float32)
    _close(rotations.quat_conjugate(_t(q)), jrot.quat_conjugate(jnp.asarray(q)))
    _close(rotations.quat_rotate(_t(q), _t(v)), jrot.quat_rotate(jnp.asarray(q), jnp.asarray(v)))
    # the JAX test's case: quat_rotate is the matrix's product
    _close(rotations.quat_rotate(_t(q), _t(v)),
           np.einsum("bij,bj->bi", rotations.unit_quaternion_to_matrix(_t(q)).numpy(), v), 1e-5)
    m = rotations.unit_quaternion_to_matrix(_t(q))
    _close(rotations.matrix_to_axis_theta(m), jrot.matrix_to_axis_theta(jnp.asarray(m.numpy())),
           1e-5)
    pts, pivot = rng.randn(4, 10, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32)
    rot = _rots(np.random.default_rng(2), 4)
    _close(rotations.rotate_around_point(_t(pts), _t(rot), _t(pivot)),
           jrot.rotate_around_point(jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(pivot)))


# ------------------------------------------------------------------ bbox

def _boxes(rng, b, p):
    corners = np.sort(rng.randn(b, p, 2, 3).astype(np.float32) * 0.05, axis=2)
    return corners, corners + rng.randn(b, p, 2, 3).astype(np.float32) * 0.01


def test_bbox_functions_match_jax():
    rng = np.random.RandomState(16)
    corners, pcorners = _boxes(rng, 2, 1)
    _close(bbox.bbox_from_corners(_t(corners)), jbbox.bbox_from_corners(jnp.asarray(corners)))
    b1 = bbox.bbox_from_corners(_t(corners))[0, 0]
    b2 = bbox.bbox_from_corners(_t(pcorners))[0, 0]
    jb1, jb2 = jnp.asarray(b1.numpy()), jnp.asarray(b2.numpy())
    pts = rng.randn(200, 3).astype(np.float32) * 0.05
    np.testing.assert_array_equal(bbox.pts_inside_box(_t(pts), b1).numpy(),
                                  np.asarray(jbbox.pts_inside_box(jnp.asarray(pts), jb1)))
    assert float(bbox.iou_3d(b1, b2, nres=20)) == pytest.approx(
        float(jax.jit(jbbox.iou_3d, static_argnames="nres")(jb1, jb2, nres=20)), abs=1e-6)
    assert float(bbox.iou_3d(b1, b1, nres=20)) == 1.0
    _close(bbox.aabb_iou_3d(b1, b2), jbbox.aabb_iou_3d(jb1, jb2))
    far = b2 + 1.0     # disjoint boxes
    _close(bbox.aabb_iou_3d(b1, far), jbbox.aabb_iou_3d(jb1, jnp.asarray(far.numpy())))


@pytest.mark.parametrize("nocs,sym", [(False, False), (True, False), (False, True)])
def test_eval_single_part_iou_matches_jax(nocs, sym):
    rng = np.random.RandomState(17)
    corners, pcorners = _boxes(rng, 2, 1)
    rot = _rots(np.random.default_rng(3), 2, 1)
    pose_g = {"rotation": rot, "scale": (rng.rand(2, 1) + 0.5).astype(np.float32),
              "translation": (rng.randn(2, 1, 3, 1) * 0.05).astype(np.float32)}
    pose_p = dict(pose_g, rotation=_rots(np.random.default_rng(4), 2, 1))
    want = jbbox.eval_single_part_iou(jnp.asarray(corners), jnp.asarray(pcorners),
                                      jax.tree.map(jnp.asarray, pose_g),
                                      jax.tree.map(jnp.asarray, pose_p), nocs=nocs, sym=sym)
    got = bbox.eval_single_part_iou(_t(corners), _t(pcorners),
                                    {k: _t(v) for k, v in pose_g.items()},
                                    {k: _t(v) for k, v in pose_p.items()}, nocs=nocs, sym=sym)
    assert set(got) == set(want) == {"npcs_iou", "iou", "gt_bbox_iou"}
    for k in want:
        assert got[k].shape == (2, 1) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], atol=FLOAT_ATOL, rtol=0, err_msg=k)


# ------------------------------------------------------------------ losses

def test_losses_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 6).astype(np.float32)
    labels = np.array([[0, 1, 0, 1, 2], [1, 1, 0, 3, 1]])   # 2 and 3: the zero parts
    for kind in ("l1", "l2"):
        _close(losses.vector_loss(_t(x), kind), jlosses.vector_loss(jnp.asarray(x), kind))
    _close(losses.choose_coord_by_label(_t(x), _t(labels)),
           jlosses.choose_coord_by_label(jnp.asarray(x), jnp.asarray(labels)))
    gt = rng.randn(2, 5, 3).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, (2, 5)).astype(np.float32)
    for kw in ({}, {"labels": labels}, {"confidence": conf, "loss": "l1"},
               {"labels": labels, "confidence": conf, "per_instance": True}):
        targs = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        jargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        pred = x if "labels" in kw else x[..., :3]      # per part, or one part
        _close(losses.compute_nocs_loss(_t(pred), _t(gt), **targs),
               jlosses.compute_nocs_loss(jnp.asarray(pred), jnp.asarray(gt), **jargs))
    assert float(losses.compute_nocs_loss(_t(gt), _t(gt))) < 1e-6
    prob = rng.rand(2, 8, 3).astype(np.float32)
    seg = rng.randint(0, 3, (2, 8))
    for per in (False, True):
        _close(losses.compute_miou_loss(_t(prob), _t(seg), per),
               jlosses.compute_miou_loss(jnp.asarray(prob), jnp.asarray(seg), per))
        _close(losses.compute_hard_miou_loss(_t(seg[::-1].copy()), _t(seg), 3, per),
               jlosses.compute_hard_miou_loss(jnp.asarray(seg[::-1]), jnp.asarray(seg), 3, per))
    logits, targets = rng.randn(10).astype(np.float32), (rng.rand(10) > 0.5).astype(np.float32)
    _close(losses.compute_focal_loss(_t(logits), _t(targets)),
           jlosses.compute_focal_loss(jnp.asarray(logits), jnp.asarray(targets)))


def test_sym_nocs_loss_matches_jax_on_injected_draws():
    """The JAX test's case (a rotation about y costs ~0) and a perturbed one,
    with the JAX key's sampled indices injected."""
    rng = np.random.RandomState(2)
    gt = rng.randn(2, 64, 3).astype(np.float32)
    th = 0.7
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                   np.float32)
    labels = (rng.rand(2, 64) > 0.3).astype(np.int64)
    key = jax.random.PRNGKey(0)
    w = jnp.asarray(labels == 0, jnp.float32) + 1e-9
    idxs = np.array(jax.vmap(lambda k, wr: jax.random.choice(k, 64, (32,), p=wr / jnp.sum(wr)))(
        jax.random.split(key, 2), w))
    for pred in (gt @ rot.T, gt + rng.randn(2, 64, 3).astype(np.float32) * 0.05):
        want = jlosses.compute_sym_nocs_loss(jnp.asarray(pred), jnp.asarray(gt),
                                             jnp.asarray(labels), pwm_num=32, key=key)
        got = losses.compute_sym_nocs_loss(_t(pred), _t(gt), _t(labels), pwm_num=32, idxs=idxs)
        _close(got, want, 1e-5)
    assert float(got[1]) > 1e-3 and float(want[1]) > 1e-3
    # through compute_nocs_loss, and with the generator's own draw
    _close(losses.compute_nocs_loss(_t(pred), _t(gt), _t(labels), sym=True, pwm_num=32,
                                    idxs=idxs), want, 1e-5)
    own = losses.compute_sym_nocs_loss(_t(pred), _t(gt), _t(labels), 32,
                                       torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in own)


def test_pose_losses_match_jax():
    rng = np.random.RandomState(4)
    r1, r2 = _rots(np.random.default_rng(5), 2), _rots(np.random.default_rng(6), 2)
    t1, t2 = rng.randn(2, 3, 1).astype(np.float32), rng.randn(2, 3, 1).astype(np.float32)
    for metric in ("l1", "l2", "frob", "exp_l1", "exp_l2", "raw"):
        _close(losses.rot_trace_loss(_t(r1), _t(r2), metric),
               jlosses.rot_trace_loss(jnp.asarray(r1), jnp.asarray(r2), metric), 2e-5)
    for metric in ("l1", "l2"):
        _close(losses.rot_yaxis_loss(_t(r1), _t(r2), metric),
               jlosses.rot_yaxis_loss(jnp.asarray(r1), jnp.asarray(r2), metric))
        _close(losses.trans_loss(_t(t1), _t(t2), metric),
               jlosses.trans_loss(jnp.asarray(t1), jnp.asarray(t2), metric))
        _close(losses.scale_loss(_t(t1[:, 0, 0]), _t(t2[:, 0, 0]), metric),
               jlosses.scale_loss(jnp.asarray(t1[:, 0, 0]), jnp.asarray(t2[:, 0, 0]), metric))
    gt = {"rotation": r1[:, None], "translation": t1[:, None],
          "scale": rng.rand(2, 1).astype(np.float32) + 0.5}
    pred = {"rotation": r2[:, None], "translation": t2[:, None],
            "scale": rng.rand(2, 1).astype(np.float32) + 0.5}
    pts = rng.randn(2, 1, 32, 3).astype(np.float32)
    tg, tp = ({k: _t(v) for k, v in d.items()} for d in (gt, pred))
    jg, jp = (jax.tree.map(jnp.asarray, d) for d in (gt, pred))
    for metric in ("l1", "l2"):
        _close(losses.compute_point_pose_loss(tg, tp, _t(pts), metric),
               jlosses.compute_point_pose_loss(jg, jp, jnp.asarray(pts), metric), 1e-5)
    kinds = {"s": "l1", "t": "l2", "r": "l1"}
    for collapse in (True, False):
        got = losses.compute_part_dof_loss(tg, tp, kinds, collapse)
        want = jlosses_eager.compute_part_dof_loss(jg, jp, kinds, collapse)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 2e-5)


# ------------------------------------------------------------------ hand_utils, dicts

def test_jitter_hand_mano_matches_jax_on_injected_draws():
    rng = np.random.RandomState(6)
    rot = _rots(np.random.default_rng(7), 1)[0]
    theta = (rng.randn(45) * 0.2).astype(np.float32)
    trans, beta = rng.randn(3).astype(np.float32), rng.randn(10).astype(np.float32)
    cfg = {"global_rotation": 0.1, "global_translation": 0.01, "beta": 0.3,
           "x": 0.05, "y": 0.1, "z": 0.2}
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda *a: jhand.jitter_hand_mano(*a, cfg))(
        key, jnp.asarray(rot), jnp.asarray(theta), jnp.asarray(trans), jnp.asarray(beta))
    # the JAX draws, as it splits its key
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ka, kb = jax.random.split(k1)
    draws = {"rotation": (_t(jax.random.normal(ka, ())), _t(jax.random.normal(kb, (4,)))),
             "trans": _t(jax.random.normal(k2, (3,))), "beta": _t(jax.random.normal(k3, (10,))),
             "theta": _t(jax.random.normal(k4, (45,)))}
    got = hand_utils.jitter_hand_mano(_t(rot), _t(theta), _t(trans), _t(beta), cfg, draws=draws)
    assert [tuple(g.shape) for g in got] == [(48,), (3,), (10,)]
    _close(got, want, 1e-5)
    own = hand_utils.jitter_hand_mano(_t(rot), _t(theta), _t(trans), _t(beta), cfg,
                                      torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(g).all()) for g in own)


def test_dicts_match_jax(capsys):
    new = {"a": torch.tensor([1.0, 3.0]), "b": {"c": torch.tensor(2.0)}}
    got, want = dicts.detach_dict(new), jdicts.detach_dict({"a": np.array([1.0, 3.0]),
                                                           "b": {"c": np.float32(2.0)}})
    np.testing.assert_array_equal(got["a"], want["a"])
    assert float(got["b"]["c"]) == float(want["b"]["c"])
    store, jstore = {}, {}
    for i in range(3):
        dicts.merge_dict(store, {"x": i, "y": -i})
        jdicts.merge_dict(jstore, {"x": i, "y": -i})
    assert store == jstore == {"x": [0, 1, 2], "y": [0, -1, -2]}
    off = dicts.Timer(on=False)
    assert off.tick("never") == 0.0 and jdicts.Timer(on=False).tick() == 0.0
    timer = dicts.Timer()
    assert timer.tick() >= 0.0 and timer.tick("step") >= 0.0
    assert "[timer] step:" in capsys.readouterr().out
