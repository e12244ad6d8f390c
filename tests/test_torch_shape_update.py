"""hotrack_tpu_torch/opt/shape_update.py and
track/obj.track_obj_with_shape_update against the JAX package's, on the CPU
at a toy size: a decoder of latent 8 and four layers of 32, 64-point clouds,
a 21^3 volume at 2 cm, 128 particles, 10 frames with an update every 5.

The JAX functions draw from `jax.random` keys inside jit; the test redraws
the same numbers outside it, with the same split schedule, and injects them
into the port.

Tolerances:
- normals: local PCA of the same neighbours through each framework's eigh in
  float32; on well-conditioned clouds (the smallest eigenvalue 5x to 40x
  below the next) the eigenvector is unique up to sign, and both packages
  flip it the same way. The float32 covariance of 30 points 0.1 m from the
  origin with a 2 cm spread rounds its smallest direction by up to 0.047 deg
  in either package against float64 (seen), so NORMAL_DEG holds the angle
  between the packages, and against float64.
- update_shape: float32 gradients of the same function differ by rounding;
  Adam's first step is lr-sized whatever the gradient's size, so the code
  moves alike wherever no component's gradient is near 0: LATENT_ATOL after
  6 iterations.
- the tracker runs in float64 on both sides (the JAX package with x64 on
  and `jnp.float32` patched to float64 while it traces, as the train-step
  tests do). In float32 the 100 Adam iterations of an update amplify the
  rounding of near-zero gradient components (Adam divides by their size):
  the two latents parted by 2.6e-3 and the re-baked volumes by 2.7e-5 m,
  after which the closed loop took another step of the search (6e-3 on a
  rotation entry). In float64: poses, the iteration-0 energies on the
  re-baked volume and the final latent at F64_* below.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.opt import shape_update as jshape
from hotrack_tpu.opt import particle as jparticle
from hotrack_tpu.pose.rotations import rotvec_to_matrix as jax_rotvec_to_matrix
from hotrack_tpu.pose.rotations import unit_quaternion_to_matrix as jax_quat_to_matrix
from hotrack_tpu.opt import obj_pose as jax_obj_pose
from hotrack_tpu.sdf import assets as jassets
from hotrack_tpu.sdf import volume as jvolume
from hotrack_tpu.sdf.decoder import SDFDecoder as JaxSDFDecoder
from hotrack_tpu.sdf.volume import trilinear_sdf as jax_trilinear
from hotrack_tpu.track import obj as jtrack
from hotrack_tpu_torch.opt import obj_pose, shape_update
from hotrack_tpu_torch.sdf import assets, mesh, volume
from hotrack_tpu_torch.sdf.decoder import SDFDecoder
from hotrack_tpu_torch.track.obj import track_obj_with_shape_update
from hotrack_tpu_torch.utils.convert import sdf_decoder_state_dict_from_flax

NORMAL_DEG = 0.1
LATENT_ATOL = 2e-6
F64_ROT_ATOL, F64_TRANS_ATOL, F64_ENERGY_RTOL, F64_LATENT_ATOL = 1e-9, 1e-10, 1e-9, 1e-9
SPEC = dict(latent_size=8, dims=(32, 32, 32, 32), dropout=(), norm_layers=(0, 1, 2, 3),
            latent_in=(2,), weight_norm=True)
SIZE, SCALE = 21, 0.02          # the volume spans the optimiser's [-0.2, 0.2]^3
NORM_SCALE = 5.0                # category metres -> instance frame
P, N, T, EVERY = 128, 64, 10, 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small operations: one intra-op thread, which does not contend with
    the suite's other workers. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere(n, seed, radius=0.1, squash=(1.0, 1.0, 1.0)):
    d = np.random.RandomState(seed).randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * radius * np.asarray(squash)).astype(np.float32)


def _angle_deg(a, b):
    cos = np.abs(np.sum(a * b, -1)) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


@pytest.mark.parametrize("cloud", ["sphere", "ellipsoid"])
def test_estimate_normals_matches_jax(cloud):
    pts = _sphere(400, 0, squash=(1.0, 1.0, 1.0) if cloud == "sphere" else (1.4, 1.0, 0.7))
    camera = np.array([0.02, -0.01, 0.5], np.float32)
    want = np.asarray(jshape.estimate_normals(jnp.asarray(pts), jnp.asarray(camera), k=30))
    got = shape_update.estimate_normals(_t(pts), _t(camera), k=30).numpy()
    worst = _angle_deg(got, want).max()
    # float64 PCA of the same neighbourhoods
    d = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    nbrs = pts.astype(np.float64)[np.argsort(d, 1, kind="stable")[:, :30]]
    c = nbrs - nbrs.mean(1, keepdims=True)
    ref = np.linalg.eigh(np.einsum("nki,nkj->nij", c, c) / 30)[1][..., 0]
    print(f"estimate_normals ({cloud}): worst angle {worst:.3e} deg between the packages, "
          f"{_angle_deg(got, ref).max():.3e} deg to float64; "
          f"{(_angle_deg(got, want) == 0).mean():.2f} of them equal")
    assert worst < NORMAL_DEG and _angle_deg(got, ref).max() < NORMAL_DEG
    # the same orientation: both face the camera, the same way
    assert (np.sum(got * want, -1) > 0).all()
    assert (np.sum(got * (camera - pts), -1) > 0).all()


def _decoder_pair(seed, median_grid=12):
    """A flax decoder and the port's with the same seeded weights (numpy, no
    flax init), the last layer shifted so that the field's median over
    [-0.5, 0.5]^3 is its zero level (a random field then has a surface
    there)."""
    rng = np.random.RandomState(seed)
    dims = [SPEC["latent_size"] + 3, *SPEC["dims"], 1]
    params = {}
    for l in range(len(dims) - 1):
        out = dims[l + 1] - (dims[0] if l + 1 in SPEC["latent_in"] else 0)
        if l in SPEC["norm_layers"]:
            params[f"lin{l}"] = {"v": rng.randn(out, dims[l]) / np.sqrt(dims[l]),
                                 "g": 1.0 + 0.1 * rng.randn(out, 1),
                                 "bias": 0.1 * rng.randn(out)}
        else:
            params[f"lin{l}"] = {"kernel": rng.randn(dims[l], out) / np.sqrt(dims[l]),
                                 "bias": np.zeros(out)}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    latent = (rng.randn(SPEC["latent_size"]) * 0.1).astype(np.float32)
    tdec = SDFDecoder(**SPEC).eval()
    tdec.load_state_dict(sdf_decoder_state_dict_from_flax(params), strict=True)
    grid = np.stack(np.meshgrid(*[np.linspace(-0.5, 0.5, median_grid)] * 3, indexing="ij"), -1)
    x = np.concatenate([np.broadcast_to(latent, (median_grid ** 3, 8)),
                        grid.reshape(-1, 3)], -1).astype(np.float32)
    with torch.no_grad():
        field = np.arctanh(tdec(_t(x)).numpy())
    last = f"lin{len(dims) - 2}"
    params[last]["bias"] = (params[last]["bias"] - np.median(field)).astype(np.float32)
    tdec.load_state_dict(sdf_decoder_state_dict_from_flax(params), strict=True)
    return JaxSDFDecoder(**SPEC), {"params": params}, tdec, latent


def _jax_update_draws(key, n, iterations):
    """update_shape's uniforms, redrawn with its split schedule."""
    out, k0 = [], key
    for _ in range(iterations):
        k0, k1, k2 = jax.random.split(k0, 3)
        out.append((np.array(jax.random.uniform(k1, (n, 1)) * 0.1),
                    np.array(jax.random.uniform(k2, (n, 1)) * 0.05)))
    return out


def _jax_merge_draws(key, n, valid):
    """merge_observations' candidate indices and permutation."""
    k1, k2 = jax.random.split(key)
    w = jnp.asarray(valid).astype(jnp.float32) + 1e-9
    idx = jax.random.choice(k1, len(valid), (n,), p=w / jnp.sum(w))
    return np.array(idx), np.array(jax.random.permutation(k2, n))


def test_update_shape_matches_jax_on_injected_draws():
    jdec, variables, tdec, latent = _decoder_pair(0)
    pts = _sphere(48, 1, radius=0.3)
    normals = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    key, iterations = jax.random.PRNGKey(3), 6
    want = np.asarray(jshape.update_shape(jdec.apply, variables, jnp.asarray(latent),
                                          jnp.asarray(pts), jnp.asarray(normals), key,
                                          num_iterations=iterations))
    draws = _jax_update_draws(key, len(pts), iterations)
    got = shape_update.update_shape(tdec, _t(latent), _t(pts), _t(normals),
                                    num_iterations=iterations, draws=draws).numpy()
    print(f"update_shape: latent moved {np.abs(want - latent).max():.3e}, "
          f"ports differ by {np.abs(got - want).max():.3e}")
    assert np.abs(want - latent).max() > 1e-3      # the code moved: a few lr-sized steps
    np.testing.assert_allclose(got, want, atol=LATENT_ATOL, rtol=0)
    # the generator path runs and draws its own numbers; eval mode is required
    gen = shape_update.update_shape(tdec, _t(latent), _t(pts), _t(normals),
                                    torch.Generator().manual_seed(0), num_iterations=2)
    assert gen.shape == (8,) and torch.isfinite(gen).all()
    with pytest.raises(ValueError, match="eval mode"):
        shape_update.update_shape(tdec.train(), _t(latent), _t(pts), _t(normals),
                                  num_iterations=1, draws=draws[:1])
    tdec.eval()


@pytest.mark.parametrize("merge_num", [2, 3, 7])
def test_merge_observations_matches_jax_on_injected_draws(merge_num):
    rng = np.random.RandomState(merge_num)
    merged, merged_n = rng.randn(64, 3).astype(np.float32), rng.randn(64, 3).astype(np.float32)
    new, new_n = rng.randn(40, 3).astype(np.float32), rng.randn(40, 3).astype(np.float32)
    valid = rng.rand(40) > 0.3
    key = jax.random.PRNGKey(merge_num)
    want = jshape.merge_observations(jnp.asarray(merged), jnp.asarray(merged_n), jnp.asarray(new),
                                     jnp.asarray(new_n), jnp.asarray(valid),
                                     jnp.asarray(merge_num), key)
    draws = _jax_merge_draws(key, 64, valid)
    assert valid[draws[0]].all()                   # only valid points are drawn
    got = shape_update.merge_observations(_t(merged), _t(merged_n), _t(new), _t(new_n),
                                          _t(valid), merge_num, draws=draws)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    replaced = (got[0].numpy() != merged).any(-1).sum()
    assert replaced == 64 // merge_num
    # the generator path: the same count replaced, only valid points
    out, _ = shape_update.merge_observations(_t(merged), _t(merged_n), _t(new), _t(new_n),
                                             _t(valid), merge_num,
                                             torch.Generator().manual_seed(0))
    changed = (out.numpy() != merged).any(-1)
    assert changed.sum() == 64 // merge_num
    assert all((new[valid] == row).all(-1).any() for row in out.numpy()[changed])


def _x64():
    """The JAX package in float64 while it traces."""
    stack = jax.enable_x64(True)
    patch = mock.patch.object(jnp, "float32", jnp.float64)
    stack.__enter__(), patch.__enter__()
    return lambda: (patch.__exit__(None, None, None), stack.__exit__(None, None, None))


@pytest.fixture(scope="module")
def tracked():
    """Both packages' shape-update trackers on the same decoder, cloud,
    particle bank and draws, in float64; every volume each one baked."""
    done = _x64()
    try:
        yield _tracked()
    finally:
        done()


def _tracked():
    jdec, variables, tdec, latent = _decoder_pair(2)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    tdec = tdec.double()
    latent = latent.astype(np.float64)
    norm = {"offset": np.zeros(3), "scale": np.array([NORM_SCALE])}
    # the object: surface points of the decoder's field near the origin
    with torch.no_grad():
        field = volume.bake_sdf_volume(tdec, _t(latent), volume.volume_coords(
            33, 1.0 / 16, torch.float64), 33, 1.0).numpy()
    verts, _ = mesh.marching_tetrahedra(field, 1.0 / 16, -1.0)
    verts = verts[np.linalg.norm(verts, axis=-1) < 0.4]
    rng = np.random.RandomState(4)
    obj = verts / NORM_SCALE                     # category frame, metres
    rots = [np.asarray(jax_rotvec_to_matrix(jnp.asarray([0.1 + 0.02 * f, -0.05, 0.03 * f],
                                                         jnp.float64))) for f in range(T)]
    trans = [np.array([0.003 * f, -0.002 * f, 0.001 * f]) for f in range(T)]
    clouds = np.stack([obj[rng.choice(len(obj), N)] @ r.T + t for r, t in zip(rots, trans)])
    clouds = clouds.astype(np.float64)
    init_r = (rots[0] @ np.asarray(jax_rotvec_to_matrix(jnp.asarray([0.05, -0.04, 0.03],
                                                                      jnp.float64))))
    init_t = (trans[0] + np.array([0.006, -0.008, 0.005]))[:, None]
    bank = rng.randn(P, 6)
    bank[0] = 0.0

    jcoords = jassets.cat_to_ins_coords(jvolume.volume_coords(SIZE, SCALE, jnp.float64), norm)
    tcoords = assets.cat_to_ins_coords(volume.volume_coords(SIZE, SCALE, torch.float64), norm)
    baked = {"jax": [], "port": []}

    def jax_bake(lat):
        baked["jax"].append(np.asarray(jvolume.bake_sdf_volume(
            jdec.apply, variables, lat, jcoords, SIZE, NORM_SCALE)))
        return jnp.asarray(baked["jax"][-1])

    def port_bake(lat):
        baked["port"].append(volume.bake_sdf_volume(tdec, lat, tcoords, SIZE, NORM_SCALE))
        return baked["port"][-1]

    key = jax.random.PRNGKey(9)
    jres, jlat = jtrack.track_obj_with_shape_update(
        jdec.apply, variables, jnp.asarray(latent), jax_bake,
        lambda p: jassets.cat_to_ins_coords(p, norm), jnp.asarray(bank), jnp.asarray(clouds),
        jnp.asarray(init_r), jnp.asarray(init_t), voxel_scale=SCALE, bbox_res=SIZE,
        update_every=EVERY, key=key)

    # the JAX draws, with its split schedule: each frame's merge, then the
    # chunk's update; a merge's weights are the JAX run's own good points
    merges, updates, k = [], [], key
    for start in range(0, T, EVERY):
        vol = jnp.asarray(baked["jax"][start // EVERY])
        for f in range(start, start + EVERY):
            r, t = jres.rotation[f], jres.translation[f]
            frame = jnp.matmul(jnp.asarray(clouds[f]) - t[:, 0], r)
            good = np.asarray(jnp.abs(jax_trilinear(vol, frame, SCALE, SIZE)) < 0.02)
            k, k1 = jax.random.split(k)
            merges.append(_jax_merge_draws(k1, N, good))
        k, k2 = jax.random.split(k)
        updates.append(_jax_update_draws(k2, N, 100))
    tres, tlat = track_obj_with_shape_update(
        tdec, _t(latent), port_bake, lambda p: assets.cat_to_ins_coords(p, norm), _t(bank),
        _t(clouds), _t(init_r), _t(init_t), voxel_scale=SCALE, bbox_res=SIZE,
        update_every=EVERY, draws={"merges": merges, "updates": updates})
    return {"jres": jres, "jlat": np.asarray(jlat), "tres": tres, "tlat": tlat.numpy(),
            "latent": latent, "baked": baked, "clouds": clouds, "bank": bank,
            "trans": trans}


def test_shape_update_tracker_matches_jax(tracked):
    jres, tres = tracked["jres"], tracked["tres"]
    assert tuple(tres.rotation.shape) == (T, 3, 3) and tuple(tres.translation.shape) == (T, 3, 1)
    assert tres.rotation.dtype == torch.float64
    np.testing.assert_allclose(tres.rotation.numpy(), np.asarray(jres.rotation),
                               atol=F64_ROT_ATOL, rtol=0)
    np.testing.assert_allclose(tres.translation.numpy(), np.asarray(jres.translation),
                               atol=F64_TRANS_ATOL, rtol=0)
    moved = np.abs(tracked["jlat"] - tracked["latent"]).max()
    gap = np.abs(tracked["tlat"] - tracked["jlat"]).max()
    print(f"shape-update tracker: latent moved {moved:.3e}, ports differ by {gap:.3e}")
    assert moved > 1e-2
    np.testing.assert_allclose(tracked["tlat"], tracked["jlat"], atol=F64_LATENT_ATOL, rtol=0)
    # one bake at the start and one a chunk: the volume was re-baked twice
    assert len(tracked["baked"]["port"]) == len(tracked["baked"]["jax"]) == 1 + T // EVERY
    # frame 0 pulls the jittered start in
    err = np.linalg.norm(tres.translation.numpy()[0, :, 0] - tracked["trans"][0])
    assert err < 0.5 * np.linalg.norm([0.006, -0.008, 0.005])


def test_shape_update_energies_at_iteration_0_on_the_rebaked_volume(tracked):
    """Frame EVERY is the first tracked on a re-baked volume: from the same
    start (the JAX run's previous pose), the candidates' energies of
    iteration 0 on each package's own re-baked volume."""
    done = _x64()
    try:
        _hold_energies_at_iteration_0(tracked)
    finally:
        done()


def _hold_energies_at_iteration_0(tracked):
    f = EVERY
    jres = tracked["jres"]
    r, t = np.asarray(jres.rotation[f - 1]), np.asarray(jres.translation[f - 1])
    jvol = jnp.asarray(tracked["baked"]["jax"][1])
    sample = jparticle.quat_extend(jnp.asarray(tracked["bank"])
                                   * jax_obj_pose.SCALING_COEFFICIENT1)
    new_r = jnp.matmul(jnp.asarray(r), jax_quat_to_matrix(sample[:, :4]))
    new_t = jnp.asarray(t)[None] + sample[:, 4:, None]
    pcld = jnp.asarray(tracked["clouds"][f])
    flat = jnp.matmul(pcld[None] - jnp.swapaxes(new_t, -1, -2), new_r)
    want = np.asarray(jnp.mean(jnp.abs(jax_trilinear(jvol, flat, SCALE, SIZE,
                                                     bbox_min=-(SIZE // 2) * SCALE)),
                               axis=-1) * 500.0)
    trace = []
    obj_pose.optimize_obj_pose(tracked["baked"]["port"][1], _t(tracked["bank"]), _t(pcld),
                               _t(r), _t(t), voxel_scale=SCALE, bbox_res=SIZE, iterations=1,
                               trace=trace)
    got = trace[0][0].numpy()
    assert got.shape == (P,) and want.min() > 0.0
    np.testing.assert_allclose(got, want, rtol=F64_ENERGY_RTOL, atol=0)
