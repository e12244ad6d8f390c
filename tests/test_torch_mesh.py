"""hotrack_tpu_torch/sdf/mesh.py against hotrack_tpu/sdf/mesh.py.

The numpy functions (marching tetrahedra, PLY / OBJ input and output,
surface sampling) are copies and are held bitwise; `create_mesh` bakes
through the port's decoder and is held on the mesh of the same weights;
`chamfer_distance` is torch and is held at float32 rounding."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.sdf import mesh as jmesh
from hotrack_tpu.sdf.decoder import SDFDecoder as JaxSDFDecoder
from hotrack_tpu_torch.sdf import mesh
from hotrack_tpu_torch.sdf.decoder import SDFDecoder
from hotrack_tpu_torch.utils.convert import sdf_decoder_state_dict_from_flax

# chamfer: two means of float32 norms of float32 differences, summed in
# another order by each framework: a few float32 roundings of the result
CHAMFER_RTOL = 1e-6
# create_mesh's vertices across packages (test_create_mesh_matches_jax)
MESH_VERT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small operations: one intra-op thread, which does not contend with the
    suite's other workers. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sphere_volume(n, radius):
    r = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    return np.sqrt(x ** 2 + y ** 2 + z ** 2) - radius, 2.0 / (n - 1)


def _box_volume(n, half):
    r = np.linspace(-1, 1, n)
    p = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
    q = np.abs(p) - np.asarray(half)
    return (np.linalg.norm(np.clip(q, 0, None), axis=-1) + np.clip(q.max(-1), None, 0.0),
            2.0 / (n - 1))


VOLUMES = {"sphere": lambda: _sphere_volume(24, 0.4),
           "box": lambda: _box_volume(20, (0.5, 0.3, 0.4)),
           "off-centre sphere": lambda: _sphere_volume(32, 0.55)}


@pytest.mark.parametrize("kind", sorted(VOLUMES))
def test_numpy_functions_are_the_jax_modules(kind, tmp_path):
    vol, voxel = VOLUMES[kind]()
    verts, faces = mesh.marching_tetrahedra(vol, voxel_size=voxel, origin=-1.0)
    jverts, jfaces = jmesh.marching_tetrahedra(vol, voxel_size=voxel, origin=-1.0)
    assert len(verts) > 100
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    # surface samples from the same RandomState: bitwise
    np.testing.assert_array_equal(
        mesh.sample_surface(verts, faces, 300, np.random.RandomState(3)),
        jmesh.sample_surface(jverts, jfaces, 300, np.random.RandomState(3)))
    np.testing.assert_array_equal(mesh.sample_surface(verts, faces, 64),
                                  jmesh.sample_surface(jverts, jfaces, 64))
    # PLY written by one package reads back alike in both
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    mesh.write_ply(ours, verts, faces)
    jmesh.write_ply(theirs, jverts, jfaces)
    assert open(ours).read() == open(theirs).read()
    for read in (mesh.read_ply, jmesh.read_ply, mesh.load_mesh, jmesh.load_mesh):
        v, f = read(ours)
        np.testing.assert_allclose(v, verts, atol=1e-6, rtol=0)   # written at 6 decimals
        np.testing.assert_array_equal(f, faces)


def test_obj_reader_fans_polygons_like_the_jax_module(tmp_path):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write("# a quad and a triangle\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf 1 2 5\n")
    for got in (mesh.read_obj(path), mesh.load_mesh(path)):
        want = jmesh.read_obj(path)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert mesh.read_obj(path)[1].tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 4]]


@pytest.mark.parametrize("shape", [(300, 200), (2048, 40)])
def test_chamfer_distance_matches_jax(shape):
    rng = np.random.RandomState(shape[0])
    a = (rng.randn(shape[0], 3) * 0.05).astype(np.float32)
    b = (rng.randn(shape[1], 3) * 0.05 + 0.01).astype(np.float32)
    want = float(jmesh.chamfer_distance(jnp.asarray(a), jnp.asarray(b)))
    got = float(mesh.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(want, rel=CHAMFER_RTOL, abs=0)
    assert float(mesh.chamfer_distance(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_create_mesh_matches_jax():
    """The same decoder weights in both packages give the same mesh: the
    baked values differ by float32 rounding (within the decoder's 2e-6 hold,
    tests/test_torch_sdf.py), no voxel changes sign on this seed, so the
    faces are equal. A vertex is interpolated at v_a / (v_a - v_b) along a
    0.13-long edge, so a rounding of the values moves it by the edge times
    that rounding over |v_a - v_b|: MESH_VERT_ATOL (3.1e-5 seen)."""
    spec = dict(latent_size=8, dims=(24, 24, 24, 24), dropout=(0, 1, 2, 3),
                norm_layers=(0, 1, 2, 3), latent_in=(2,), weight_norm=True)
    jdec = JaxSDFDecoder(**spec)
    params = jdec.init(jax.random.PRNGKey(0), jnp.zeros((2, 11)))["params"]
    latent = np.random.RandomState(1).randn(8).astype(np.float32)
    # shift the last layer so that the field's median is its zero level: a
    # random field has a surface there
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, 16)] * 3, indexing="ij"), -1)
    x = np.concatenate([np.broadcast_to(latent, (16 ** 3, 8)), grid.reshape(-1, 3)], -1)
    field = np.arctanh(np.asarray(jdec.apply({"params": params}, jnp.asarray(x))))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lin4"]["bias"] = (params["lin4"]["bias"] - np.median(field)).astype(np.float32)
    tdec = SDFDecoder(**spec).eval()
    tdec.load_state_dict(sdf_decoder_state_dict_from_flax(params), strict=True)
    want_v, want_f = jmesh.create_mesh(jdec.apply, {"params": params}, jnp.asarray(latent),
                                       n=16, max_batch=1000)
    got_v, got_f = mesh.create_mesh(tdec, torch.from_numpy(latent), n=16, max_batch=1000)
    assert len(got_f) > 50
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, atol=MESH_VERT_ATOL, rtol=0)
