"""Port parity for the SDF modules (hotrack_tpu_torch/sdf/volume.py,
decoder.py, assets.py) and the pose helpers the object slice added
(pose/rotations.py, pose/metrics.py, pose/part_dof.py) against hotrack_tpu,
on seeded numpy inputs at small sizes, on the CPU.

Tolerances: `volume_coords` and `nearest_sdf` exact (integer arithmetic and
one float32 product); `trilinear_sdf` 1e-7 on values clamped to 0.05 (the
same float32 operations in the same order; XLA may contract a multiply-add);
the decoder 2e-6 on tanh outputs (float32 matrix products summed in another
order over up to 300 terms); rotations 1e-6, angles in degrees 2e-3 (arccos
near 1 amplifies a float32 ulp of the trace to about 1e-3 degrees).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.pose import metrics as jmetrics
from hotrack_tpu.pose import part_dof as jpart
from hotrack_tpu.pose import rotations as jrot
from hotrack_tpu.sdf import assets as jassets
from hotrack_tpu.sdf import volume as jvolume
from hotrack_tpu.sdf.decoder import SDFDecoder as JaxSDFDecoder
from hotrack_tpu_torch.pose import metrics, part_dof, rotations
from hotrack_tpu_torch.sdf import assets, volume
from hotrack_tpu_torch.sdf.decoder import SDFDecoder
from hotrack_tpu_torch.utils.convert import sdf_decoder_state_dict_from_flax


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("size", [5, 8])
def test_volume_coords_match_jax(size):
    got = volume.volume_coords(size, 0.003)
    want = np.asarray(jvolume.volume_coords(size, 0.003))
    assert got.dtype == torch.float32 and tuple(got.shape) == (size ** 3, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _lookup_points(rng, res, scale):
    """Points inside the cube, outside it on every side, on voxel boundaries
    and in the last cell of each axis, where the neighbour indices run past
    the axis and are clamped into the flattened array only."""
    half = res // 2 * scale
    inside = rng.uniform(-half, half, (400, 3))
    outside = rng.uniform(-2.0 * half, 2.0 * half, (200, 3))
    lattice = (rng.randint(0, res, (100, 3)) - res // 2) * scale
    top = rng.uniform(-half, half, (90, 3))
    for axis in range(3):
        top[30 * axis:30 * (axis + 1), axis] = rng.uniform(half - scale, half + scale, 30)
    corner = np.full((1, 3), half)
    return np.concatenate([inside, outside, lattice, top, corner]).astype(np.float32)


@pytest.mark.parametrize("res,scale", [(21, 0.004), (16, 0.01)])
def test_trilinear_sdf_matches_jax(res, scale):
    rng = np.random.RandomState(res)
    vol = (rng.randn(res, res, res) * 0.03).astype(np.float32)  # some beyond the clamp
    pts = _lookup_points(rng, res, scale)
    bbox_min = -(res // 2) * scale
    got = volume.trilinear_sdf(_t(vol), _t(pts), scale, res, bbox_min=bbox_min)
    want = np.asarray(jvolume.trilinear_sdf(jnp.asarray(vol), jnp.asarray(pts), scale, res,
                                            bbox_min=bbox_min))
    assert np.abs(want).max() == np.float32(0.05)  # the clamp is reached
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    # leading axes are kept
    got2 = volume.trilinear_sdf(_t(vol), _t(pts[:60].reshape(4, 15, 3)), scale, res,
                                bbox_min=bbox_min, clamp=0.02)
    want2 = np.asarray(jvolume.trilinear_sdf(
        jnp.asarray(vol), jnp.asarray(pts[:60].reshape(4, 15, 3)), scale, res,
        bbox_min=bbox_min, clamp=0.02))
    assert tuple(got2.shape) == (4, 15)
    np.testing.assert_allclose(got2.numpy(), want2, atol=1e-7, rtol=0)


def test_trilinear_sdf_upper_boundary_reads_the_flattened_neighbour():
    """At the last index of z the '+1' neighbour is the next row's first
    voxel (or, at the very end, the last voxel again), not a per-axis clamp;
    its weight there is 0, so the value is the voxel's own."""
    res, scale = 5, 0.01
    vol = np.arange(res ** 3, dtype=np.float32).reshape(res, res, res) * 1e-4
    pts = np.array([[0.0, 0.0, 0.02], [0.02, 0.02, 0.02], [0.5, 0.5, 0.5]], np.float32)
    got = volume.trilinear_sdf(_t(vol), _t(pts), scale, res, bbox_min=-0.02)
    np.testing.assert_allclose(got.numpy(), [vol[2, 2, 4], vol[4, 4, 4], vol[4, 4, 4]],
                               atol=1e-7, rtol=0)


def test_nearest_sdf_matches_jax():
    size, scale = 11, 0.003
    rng = np.random.RandomState(1)
    vol = rng.randn(size, size, size).astype(np.float32)
    pts = np.concatenate([rng.uniform(-0.03, 0.03, (300, 3)),
                          (rng.randint(-7, 8, (60, 3)) * scale)]).astype(np.float32)
    got = volume.nearest_sdf(_t(vol), _t(pts.reshape(6, 60, 3)), scale, size)
    want = np.asarray(jvolume.nearest_sdf(jnp.asarray(vol),
                                          jnp.asarray(pts.reshape(6, 60, 3)), scale, size))
    np.testing.assert_array_equal(got.numpy(), want)


DECODERS = {
    "weight_norm": dict(latent_size=8, dims=(24, 24, 24, 24), dropout=(0, 1, 2, 3),
                        norm_layers=(0, 1, 2, 3), latent_in=(2,), weight_norm=True),
    "layer_norm": dict(latent_size=8, dims=(24, 24, 24), dropout=(0, 1, 2),
                       norm_layers=(0, 2), latent_in=(1,), weight_norm=False,
                       use_tanh=True),
}


def _decoder_pair(spec, seed):
    """A flax decoder with random parameters (biases and gains too) and the
    port's module holding the converted state."""
    jdec = JaxSDFDecoder(**spec)
    in_dim = spec["latent_size"] + 3
    params = jdec.init(jax.random.PRNGKey(seed), jnp.zeros((2, in_dim)))["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.1, params)
    tdec = SDFDecoder(**spec).eval()
    tdec.load_state_dict(sdf_decoder_state_dict_from_flax(params), strict=True)
    return jdec, {"params": params}, tdec


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_decoder_with_converted_weights_matches_jax(kind):
    spec = DECODERS[kind]
    jdec, variables, tdec = _decoder_pair(spec, 3)
    x = np.random.RandomState(4).randn(50, spec["latent_size"] + 3).astype(np.float32)
    want = np.asarray(jdec.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tdec(_t(x))
    assert tuple(got.shape) == (50, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # the weight-norm split survives the conversion: g and v separately
    if spec["weight_norm"]:
        sd = tdec.state_dict()
        np.testing.assert_array_equal(sd["lin0.weight_g"].numpy(),
                                      variables["params"]["lin0"]["g"])
        np.testing.assert_array_equal(sd["lin0.weight_v"].numpy(),
                                      variables["params"]["lin0"]["v"])


def test_bake_sdf_volume_matches_jax():
    spec = DECODERS["weight_norm"]
    jdec, variables, tdec = _decoder_pair(spec, 5)
    size, scale, norm_scale = 9, 0.02, 1.7
    latent = np.random.RandomState(6).randn(spec["latent_size"]).astype(np.float32)
    normalization = {"offset": np.array([0.01, -0.02, 0.005], np.float32),
                     "scale": np.array([norm_scale], np.float32)}
    jcoords = jassets.cat_to_ins_coords(jvolume.volume_coords(size, scale), normalization)
    tcoords = assets.cat_to_ins_coords(volume.volume_coords(size, scale), normalization)
    np.testing.assert_allclose(tcoords.numpy(), np.asarray(jcoords), atol=1e-7, rtol=0)
    want = np.asarray(jvolume.bake_sdf_volume(jdec.apply, variables, jnp.asarray(latent),
                                              jcoords, size, norm_scale, chunk=256))
    got = volume.bake_sdf_volume(tdec, _t(latent), tcoords, size, norm_scale, chunk=100)
    assert tuple(got.shape) == (size, size, size)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_cat_to_ins_coords_with_instance_pose_matches_jax():
    rng = np.random.RandomState(7)
    coords = rng.randn(40, 3).astype(np.float32)
    normalization = {"offset": rng.randn(3).astype(np.float32),
                     "scale": np.array([2.5], np.float32)}
    rot = np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rng.randn(3), jnp.float32)))
    trans = rng.randn(3).astype(np.float32)
    want = np.asarray(jassets.cat_to_ins_coords(jnp.asarray(coords), normalization, rot, trans))
    got = assets.cat_to_ins_coords(_t(coords), normalization, rot, trans)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_reference_checkpoint_loads_into_both_packages(tmp_path):
    """A DeepSDF checkpoint as the reference writes it (DataParallel prefix,
    weight_g / weight_v / bias) loads into the port's module key for key and
    gives what the JAX package's loader gives."""
    specs = {"dims": [300, 300, 32], "dropout": [0, 1, 2], "dropout_prob": 0.2,
             "norm_layers": [0, 1, 2], "latent_in": [1], "xyz_in_all": False,
             "use_tanh": False, "latent_dropout": False, "weight_norm": True}
    torch.manual_seed(0)
    src = assets.build_decoder(specs)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    path = str(tmp_path / "2000.pth")
    torch.save({"epoch": 2000, "model_state_dict": {
        "module." + k: v for k, v in src.state_dict().items()}}, path)
    tdec = assets.load_torch_decoder(path, specs)
    assert not tdec.training
    jdec, variables = jassets.load_torch_decoder(path, specs)
    x = np.random.RandomState(8).randn(20, 259).astype(np.float32) * 0.3
    with torch.no_grad():
        got = tdec(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdec.apply(variables, jnp.asarray(x))),
                               atol=2e-6, rtol=0)
    # the flax params go back into the same state dict
    back = sdf_decoder_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert set(back) == set(tdec.state_dict())
    for k, v in tdec.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)

    code = torch.randn(1, 1, 256)
    for saved in (code, [code]):
        torch.save(saved, str(tmp_path / "code.pth"))
        got = assets.load_torch_latent(str(tmp_path / "code.pth"))
        want = np.asarray(jassets.load_torch_latent(str(tmp_path / "code.pth")))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,scale", [(21, 0.01), (16, 0.007)])
def test_synthetic_box_sdf_setup_matches_jax(size, scale):
    got = assets.synthetic_box_sdf_setup(size, scale)
    want = np.asarray(jassets.synthetic_box_sdf_setup(size, scale))
    assert tuple(got.shape) == (size, size, size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    assert float(got.min()) < 0 < float(got.max())


@pytest.mark.parametrize("dataset,source,frame,instance", [
    ("SimGrasp", "pred", "00001_0007.npz", "bottle"),
    ("SimGrasp", "gt", "00001_0007.npz", "bottle_sim"),
    ("HO3D", "pred", "MC1/0005", "006_mustard_bottle"),
    ("HO3D", "gt", "MC1/0005", "006_mustard_bottle"),
    ("DexYCB", "pred", "subj+seq+0003", "024_bowl"),
    ("DexYCB", "gt", "subj+seq+0003", "003_cracker_box"),
])
def test_load_obj_for_opt_resolves_the_same_paths(tmp_path, monkeypatch, dataset, source,
                                                  frame, instance):
    seen = []

    def fake_load(path):
        seen.append(path)
        return {"offset": np.zeros(3, np.float32), "scale": np.ones(1, np.float32)}

    monkeypatch.setattr(np, "load", fake_load)
    root = os.path.join(str(tmp_path), dataset)
    got = assets.load_obj_for_opt(root, dataset, source, frame, instance)
    want = jassets.load_obj_for_opt(root, dataset, source, frame, instance)
    assert seen[0] == seen[1]
    assert got._fields == want._fields
    for name in ("latent_code_pth", "model_pth", "gt_mesh_path", "recon_mesh_path"):
        assert getattr(got, name) == getattr(want, name), name
    with pytest.raises(NotImplementedError):
        assets.load_obj_for_opt(root, "HOI4D", source, frame, instance)


def _rotations(rng, n):
    return np.array(jrot.rotvec_to_matrix(jnp.asarray(rng.randn(n, 3), jnp.float32)))


def test_rotation_helpers_match_jax():
    rng = np.random.RandomState(9)
    six = rng.randn(30, 6).astype(np.float32)
    six[0, :3] = 0.0        # a zero first vector: the [1, 0, 0] backup
    six[1, 3:] = six[1, :3]  # parallel vectors: a zero cross product
    np.testing.assert_allclose(
        rotations.compute_rotation_matrix_from_ortho6d(_t(six)).numpy(),
        np.asarray(jrot.compute_rotation_matrix_from_ortho6d(jnp.asarray(six))),
        atol=1e-6, rtol=0)
    vec = rng.randn(4, 5, 3).astype(np.float32)
    vec[0, 0] = 0.0
    np.testing.assert_allclose(rotations.normalize_vector(_t(vec)).numpy(),
                               np.asarray(jrot.normalize_vector(jnp.asarray(vec))),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        rotations.compute_rotation_matrix_from_3d(_t(vec)).numpy(),
        np.asarray(jrot.compute_rotation_matrix_from_3d(jnp.asarray(vec))), atol=1e-6, rtol=0)
    nine = (_rotations(rng, 12) + rng.randn(12, 3, 3) * 0.05).astype(np.float32)
    np.testing.assert_allclose(
        rotations.compute_rotation_matrix_from_9d(_t(nine)).numpy(),
        np.asarray(jrot.compute_rotation_matrix_from_9d(jnp.asarray(nine))), atol=1e-5, rtol=0)
    r1, r2 = _rotations(rng, 12), _rotations(rng, 12)
    np.testing.assert_allclose(rotations.rot_diff_rad(_t(r1), _t(r2)).numpy(),
                               np.asarray(jrot.rot_diff_rad(jnp.asarray(r1), jnp.asarray(r2))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        rotations.rot_diff_degree(_t(r1), _t(r2)).numpy(),
        np.asarray(jrot.rot_diff_degree(jnp.asarray(r1), jnp.asarray(r2))), atol=2e-3, rtol=0)


@pytest.mark.parametrize("axis", [0, 1, 2, 3, -1, 4])
@pytest.mark.parametrize("up_down", [False, True])
def test_symmetry_aware_rotation_error_matches_jax(axis, up_down):
    rng = np.random.RandomState(10 + axis)
    r1, r2 = _rotations(rng, 40), _rotations(rng, 40)
    got = metrics.rot_diff_degree(_t(r1), _t(r2), axis, up_down)
    want = np.asarray(jmetrics.rot_diff_degree(jnp.asarray(r1), jnp.asarray(r2), axis, up_down))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_scalar_metrics_match_jax():
    rng = np.random.RandomState(11)
    a, b = rng.randn(6, 3).astype(np.float32), rng.randn(6, 3).astype(np.float32)
    np.testing.assert_allclose(metrics.trans_diff(_t(a), _t(b)).numpy(),
                               np.asarray(jmetrics.trans_diff(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6, rtol=0)
    for fn in ("scale_diff", "theta_diff"):
        np.testing.assert_array_equal(
            getattr(metrics, fn)(_t(a), _t(b)).numpy(),
            np.asarray(getattr(jmetrics, fn)(jnp.asarray(a), jnp.asarray(b))))


def _poses(rng, lead):
    n = int(np.prod(lead))
    return {"rotation": _rotations(rng, n).reshape(*lead, 3, 3),
            "translation": (rng.randn(*lead, 3, 1) * 0.04).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.rand(*lead)).astype(np.float32)}


def _both(pose):
    return ({k: _t(v) for k, v in pose.items()}, {k: jnp.asarray(v) for k, v in pose.items()})


@pytest.mark.parametrize("axis,up_down", [(1, False), (3, True), (-1, False)])
def test_eval_part_full_matches_jax(axis, up_down):
    rng = np.random.RandomState(12)
    gt = _poses(rng, (9, 2))
    pred = _poses(rng, (9, 2))
    pred["rotation"][:5] = gt["rotation"][:5]          # some inside 5 deg 5 cm
    pred["translation"][:5] = gt["translation"][:5] + 0.01
    (tgt, jgt), (tpred, jpred) = _both(gt), _both(pred)
    tmean, tper = part_dof.eval_part_full(tgt, tpred, axis, up_down, per_instance=True)
    jmean, jper = jpart.eval_part_full(jgt, jpred, axis, up_down, per_instance=True)
    assert set(tmean) == set(jmean) and set(tper) == set(jper)
    assert 0.0 < float(tmean["5deg5cm_0"]) < 1.0
    for k in jmean:
        tol = 2e-3 if k.startswith("rdiff") else 1e-6
        np.testing.assert_allclose(tmean[k].numpy(), np.asarray(jmean[k]), atol=tol, rtol=0)
        np.testing.assert_allclose(tper[k].numpy(), np.asarray(jper[k]), atol=tol, rtol=0)
    assert part_dof.eval_part_full(tgt, tpred, axis, up_down)[1] == {}


def test_part_pose_helpers_match_jax():
    rng = np.random.RandomState(13)
    init, final, canon = _poses(rng, (4, 2)), _poses(rng, (4, 2)), _poses(rng, (4,))
    (ti, ji), (tf, jf), (tc, jc) = _both(init), _both(final), _both(canon)
    got = part_dof.compute_parts_delta_pose(ti, tf, tc)
    want = jpart.compute_parts_delta_pose(ji, jf, jc)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-6, rtol=0)
    src = rng.randn(4, 2, 7, 3).astype(np.float32)
    np.testing.assert_allclose(part_dof.pose_with_part(tf, _t(src)).numpy(),
                               np.asarray(jpart.pose_with_part(jf, jnp.asarray(src))),
                               atol=1e-6, rtol=0)
    raw = rng.randn(5, 9).astype(np.float32)
    for sym, kind, width in ((True, "6d", 3), (False, "6d", 6), (False, "9d", 9)):
        np.testing.assert_allclose(
            part_dof.convert_pred_rtvec_to_matrix(_t(raw[:, :width]), sym, kind).numpy(),
            np.asarray(jpart.convert_pred_rtvec_to_matrix(jnp.asarray(raw[:, :width]), sym,
                                                          kind)), atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError):
        part_dof.convert_pred_rtvec_to_matrix(_t(raw), False, "quat")
