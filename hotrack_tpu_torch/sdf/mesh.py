"""SDF -> mesh extraction and mesh utilities (port of hotrack_tpu/sdf/mesh.py).

Iso-surface extraction is marching tetrahedra (each voxel split into 6
tetrahedra; a tet's 16 sign configurations reduce to 0, 1 or 2 triangles by
symmetry, with vertices linearly interpolated along the crossing edges),
PLY / OBJ input and output, uniform surface sampling and the symmetric
chamfer distance the object runner reports. The numpy functions are the JAX
package's own, carried over with only this docstring changed (held bitwise
by tests/test_torch_mesh.py); `create_mesh` bakes through this package's
`sdf/volume.bake_sdf_volume` and `chamfer_distance` is torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .volume import bake_sdf_volume

# the 6-tetrahedra decomposition of a cube; vertex ids are the cube corners
# in (dx, dy, dz) binary order: 0=(0,0,0) .. 7=(1,1,1)
_CUBE_TETS = ((0, 5, 1, 3), (0, 5, 3, 6), (0, 5, 6, 4),
              (5, 3, 6, 7), (1, 3, 5, 7), (0, 1, 3, 2))
_CORNER_OFFSETS = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1]
                            for i in range(8)])


def _tet_triangles(p, v):
    """Triangles of the zero iso-surface inside one tetrahedron.

    p (4, 3) vertex positions, v (4,) sdf values. Returns list of (3, 3)."""
    inside = v < 0
    n = int(inside.sum())
    if n == 0 or n == 4:
        return []
    idx_in = np.nonzero(inside)[0]
    idx_out = np.nonzero(~inside)[0]

    def cross(a, b):
        t = v[a] / (v[a] - v[b])
        return p[a] + t * (p[b] - p[a])

    if n == 1:
        a = idx_in[0]
        pts = [cross(a, b) for b in idx_out]
        return [np.stack(pts)]
    if n == 3:
        a = idx_out[0]
        pts = [cross(b, a) for b in idx_in]
        return [np.stack(pts)]
    # n == 2: quad -> two triangles
    a0, a1 = idx_in
    b0, b1 = idx_out
    q = [cross(a0, b0), cross(a0, b1), cross(a1, b1), cross(a1, b0)]
    return [np.stack([q[0], q[1], q[2]]), np.stack([q[0], q[2], q[3]])]


def marching_tetrahedra(volume: np.ndarray, voxel_size=1.0, origin=0.0):
    """Extract the zero iso-surface of a dense SDF volume.

    Returns (verts (V, 3), faces (F, 3)). Coordinates = origin + idx*voxel.
    Vectorized over candidate voxels (those with a sign change), per-voxel
    python only on the surface shell."""
    volume = np.asarray(volume)
    sign = volume < 0
    # voxels whose 8 corners are not all the same sign
    s = sign
    corner_stack = np.stack([
        s[:-1, :-1, :-1], s[1:, :-1, :-1], s[:-1, 1:, :-1], s[1:, 1:, :-1],
        s[:-1, :-1, 1:], s[1:, :-1, 1:], s[:-1, 1:, 1:], s[1:, 1:, 1:]], 0)
    any_in = corner_stack.any(0)
    all_in = corner_stack.all(0)
    active = np.argwhere(any_in & ~all_in)

    tris = []
    voxel_size = np.asarray(voxel_size, np.float64)
    origin = np.asarray(origin, np.float64)
    for ijk in active:
        i, j, k = ijk
        corners = ijk + _CORNER_OFFSETS  # (8, 3)
        vals = volume[corners[:, 0], corners[:, 1], corners[:, 2]]
        pos = origin + corners * voxel_size
        for tet in _CUBE_TETS:
            tris.extend(_tet_triangles(pos[list(tet)], vals[list(tet)]))
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri = np.asarray(tris)  # (F, 3, 3)
    # weld vertices
    flat = tri.reshape(-1, 3)
    rounded = np.round(flat / (np.max(voxel_size) * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(rounded, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=len(uniq))[:, None]
    verts /= counts
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


@torch.no_grad()
def create_mesh(decoder, latent_code: torch.Tensor, n: int = 128,
                max_batch: int = 1 << 18):
    """Dense n^3 decode over [-1, 1]^3 (voxel 2 / (n - 1)) on the latent's
    device, then iso-surface extraction -> (verts (V, 3), faces (F, 3))."""
    voxel = 2.0 / (n - 1)
    r = np.arange(n) * voxel - 1.0
    x, y, z = np.meshgrid(r, r, r, indexing="ij")
    coords = torch.tensor(np.stack([x, y, z], -1).reshape(-1, 3), dtype=torch.float32,
                          device=latent_code.device)
    sdf = bake_sdf_volume(decoder, latent_code, coords, n, norm_scale=1.0, chunk=max_batch)
    return marching_tetrahedra(sdf.cpu().numpy(), voxel_size=voxel, origin=-1.0)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """ASCII PLY export (replaces plyfile, DeepSDF mesh.py:76-144)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def read_ply(path: str):
    """Minimal ASCII/with-fallback PLY vertex reader (replaces trimesh.load
    for chamfer eval, track_network.py:394-399)."""
    verts, faces = [], []
    with open(path, "r") as f:
        line = f.readline()
        assert line.startswith("ply")
        n_v = n_f = 0
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        for _ in range(n_v):
            verts.append([float(t) for t in f.readline().split()[:3]])
        for _ in range(n_f):
            toks = f.readline().split()
            faces.append([int(t) for t in toks[1:4]])
    return np.asarray(verts), np.asarray(faces, np.int64)


def read_obj(path: str):
    """Minimal Wavefront OBJ vertex/face reader (replaces trimesh.load for
    chamfer eval against gt meshes, track_network.py:396-399)."""
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts), np.asarray(faces, np.int64)


def load_mesh(path: str):
    """Dispatch .obj / .ply."""
    if path.endswith(".obj"):
        return read_obj(path)
    return read_ply(path)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """Uniform surface sampling (replaces trimesh.sample.sample_surface,
    track_network.py:398)."""
    rng = rng or np.random.RandomState(0)
    tri = verts[faces]  # (F, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    probs = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(faces), size=n, p=probs)
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return tri[idx, 0] + u * e1[idx] + v * e2[idx]


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance: the mean nearest-neighbour distance from a
    to b plus from b to a. Each distance is the norm of the difference, as
    the JAX package computes it (not torch.cdist, whose default switches to
    the |a|^2 + |b|^2 - 2ab formula above 25 rows and loses digits)."""
    d = torch.linalg.norm(a[:, None, :] - b[None, :, :], dim=-1)
    return torch.mean(torch.min(d, dim=1).values) + torch.mean(torch.min(d, dim=0).values)
