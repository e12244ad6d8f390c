"""Object tracking loop: per-frame SDF particle optimisation (port of
hotrack_tpu/track/obj.py: track_obj_sequence, track_obj_sequences_batched
and track_obj_with_shape_update).

Per frame the gradient-free pose optimiser starts from the previous frame's
pose (the jittered ground truth on frame 0). The JAX package's `lax.scan` is
a Python loop here; nothing in it reads a device value, so the host runs
ahead of the card. The SDF volume is baked, and distilled, once per sequence.
Several sequences of equal length go through one loop with a leading
sequence axis (the JAX package's `vmap` of the per-sequence scan);
`track_obj_sequences_sharded` splits the sequences over devices
(track/shards.py), that loop on each.
"""

from __future__ import annotations

import time

import torch

from ..opt.obj_pose import optimize_obj_pose
from ..opt.shape_update import estimate_normals, merge_observations, update_shape
from ..ops.sdf_mlp import pack_distilled, pack_distilled_batched
from ..sdf.volume import trilinear_sdf
from ..utils.trace import span
from . import shards
from .types import ObjTrackResult


@torch.no_grad()
def track_obj_sequence(
    sdf_volume: torch.Tensor | None,  # (V, V, V); may be None with `distilled`
    presampled: torch.Tensor,         # (P, 6) particle bank
    obj_points: torch.Tensor,         # (T, N, 3) per-frame observed clouds
    init_rotation: torch.Tensor,      # (3, 3) jittered gt pose of frame 0
    init_translation: torch.Tensor,   # (3, 1)
    voxel_scale: float = 0.002,
    bbox_res: int = 201,
    distilled=None,                   # DistilledSDF (sdf/distill.py)
    obj_energy: str = "fused",
) -> ObjTrackResult:
    packed = None
    if distilled is not None and obj_points.is_cuda:
        with span("track.obj.init"):
            packed = pack_distilled(distilled)  # once per sequence
    r, t = init_rotation, init_translation
    rs, ts, energies = [], [], []
    for pcld in obj_points:
        with span("track.obj.frame"):
            r, t, energy = optimize_obj_pose(
                sdf_volume, presampled, pcld, r, t, voxel_scale=voxel_scale,
                bbox_res=bbox_res, distilled=distilled, obj_energy=obj_energy,
                packed=packed)
            rs.append(r), ts.append(t), energies.append(energy)
    return ObjTrackResult(rotation=torch.stack(rs), translation=torch.stack(ts),
                          sdf_energy=torch.stack(energies))


@torch.no_grad()
def track_obj_sequences_batched(
    sdf_volumes: torch.Tensor | None,  # (S, V, V, V); may be None with `distilled`
    presampled: torch.Tensor,          # (P, 6) particle bank, shared
    obj_points: torch.Tensor,          # (S, T, N, 3) per-sequence, per-frame clouds
    init_rotations: torch.Tensor,      # (S, 3, 3)
    init_translations: torch.Tensor,   # (S, 3, 1)
    voxel_scale: float = 0.002,
    bbox_res: int = 201,
    distilled=None,                    # a list of S DistilledSDF
    obj_energy: str = "fused",
) -> ObjTrackResult:
    """S sequences of T frames in one frame loop: every frame one call of the
    optimiser over (S, N, 3) clouds, each sequence with its own volume or
    model; on the card the batched kernels (#4b fused, #3b composed).
    Returns rotation (S, T, 3, 3), translation (S, T, 3, 1), sdf_energy
    (S, T)."""
    if distilled is not None and len(distilled) != obj_points.shape[0]:
        raise ValueError(f"{len(distilled)} models for {obj_points.shape[0]} sequences")
    packed = None
    if distilled is not None and obj_points.is_cuda:
        with span("track.obj.init"):
            packed = pack_distilled_batched(distilled)  # once per chunk of sequences
    r, t = init_rotations, init_translations
    rs, ts, energies = [], [], []
    for f in range(obj_points.shape[1]):
        with span("track.obj.frame"):
            r, t, energy = optimize_obj_pose(
                sdf_volumes, presampled, obj_points[:, f], r, t, voxel_scale=voxel_scale,
                bbox_res=bbox_res, distilled=distilled, obj_energy=obj_energy, packed=packed)
            rs.append(r), ts.append(t), energies.append(energy)
    return ObjTrackResult(rotation=torch.stack(rs, 1), translation=torch.stack(ts, 1),
                          sdf_energy=torch.stack(energies, 1))


def track_obj_sequences_sharded(
    sdf_volumes: torch.Tensor | None,  # (S, V, V, V); may be None with `distilled`
    presampled: torch.Tensor,          # (P, 6) particle bank, replicated
    obj_points: torch.Tensor,          # (S, T, N, 3)
    init_rotations: torch.Tensor,      # (S, 3, 3)
    init_translations: torch.Tensor,   # (S, 3, 1)
    devices=None,
    **kwargs,
) -> ObjTrackResult:
    """Several devices' object tracking (port of the JAX package's
    `track_obj_sequences_sharded`): S splits into len(devices) equal
    contiguous shares (S must divide by D), and each share runs
    `track_obj_sequences_batched` on its device, in a thread of its own. The
    volumes, clouds, initial poses and `distilled` (a list of S models) are
    per sequence; the particle bank and the other `kwargs` are replicated.
    `devices` defaults to every visible card and may repeat one. Returns the
    result of all S sequences on devices[0], in sequence order."""
    devices = shards.resolve_devices(devices)
    bounds = shards.share_bounds(obj_points.shape[0], len(devices))
    distilled = kwargs.pop("distilled", None)
    move = shards.Mover()
    jobs = []
    for device, sl in zip(devices, bounds):
        share_kwargs = dict(move(kwargs, device))
        if distilled is not None:
            share_kwargs["distilled"] = move(list(distilled[sl]), device)
        jobs.append((None if sdf_volumes is None else move(sdf_volumes[sl], device),
                     move(presampled, device), move(obj_points[sl], device),
                     move(init_rotations[sl], device), move(init_translations[sl], device),
                     share_kwargs))
    results = shards.run_shares(
        lambda device, job: track_obj_sequences_batched(*job[:5], **job[5]), devices, jobs)
    return shards.concat_results(results, devices[0])


def track_obj_with_shape_update(
    decoder, latent: torch.Tensor,
    bake_fn,                          # (latent) -> (V, V, V) sdf volume
    cat_to_ins,                       # (points (.., 3)) -> the instance frame
    presampled: torch.Tensor,         # (P, 6) particle bank
    obj_points: torch.Tensor,         # (T, N, 3)
    init_rotation: torch.Tensor, init_translation: torch.Tensor,
    camera_origin: torch.Tensor | None = None,   # (3,) in the camera frame
    voxel_scale: float = 0.002, bbox_res: int = 201, update_every: int = 10,
    generator: torch.Generator | None = None, draws: dict | None = None,
    timings: dict | None = None):
    """Object tracking with online shape refinement. Frame by frame: the pose
    optimiser on the volume route, then the frame's points with |sdf| < 2 cm
    merged into the instance-frame buffer (seeded with frame 0 at the
    initial pose). After every `update_every` frames the latent is refined on
    the buffer (`update_shape`, its 100 Adam steps) and the volume
    re-baked with `bake_fn`. Returns (ObjTrackResult, final latent).

    Random numbers are drawn in the JAX package's order: each frame's merge,
    then the chunk's update. `draws` replaces them: {'merges': one
    (candidate indices, permutation) a frame, 'updates': one list of
    100 (mu_pos, mu_neg) a chunk}. `timings`, where given,
    collects the seconds of the first bake, of each update and of each
    re-bake (the device synchronised around each)."""
    device = obj_points.device
    camera = (torch.zeros(3, dtype=obj_points.dtype, device=device) if camera_origin is None
              else torch.as_tensor(camera_origin, dtype=obj_points.dtype, device=device))
    merges = None if draws is None else list(draws["merges"])
    updates = None if draws is None else list(draws["updates"])

    def timed(name, fn, *args):
        if timings is None:
            return fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    sdf_volume = timed("bake_seconds", bake_fn, latent)
    r, t = init_rotation, init_translation
    obj0 = cat_to_ins(torch.matmul(obj_points[0] - t[:, 0], r))
    cam0 = cat_to_ins(torch.matmul(camera[None] - t[:, 0], r))[0]
    merged_pc, merged_normals = obj0, estimate_normals(obj0, cam0)
    merge_num = 1
    rs, ts, energies = [], [], []
    for start in range(0, obj_points.shape[0], update_every):
        for pcld in obj_points[start:start + update_every]:
            with torch.no_grad():
                r, t, energy = optimize_obj_pose(sdf_volume, presampled, pcld, r, t,
                                                 voxel_scale=voxel_scale, bbox_res=bbox_res)
            rs.append(r), ts.append(t), energies.append(energy)
            obj_frame = torch.matmul(pcld - t[:, 0], r)
            good = torch.abs(trilinear_sdf(sdf_volume, obj_frame, voxel_scale, bbox_res)) < 0.02
            ins_pts = cat_to_ins(obj_frame)
            cam = cat_to_ins(torch.matmul(camera[None] - t[:, 0], r))[0]
            merge_num += 1
            merged_pc, merged_normals = merge_observations(
                merged_pc, merged_normals, ins_pts, estimate_normals(ins_pts, cam), good,
                merge_num, generator, None if merges is None else merges.pop(0))
        latent = timed("update_seconds", lambda lat: update_shape(
            decoder, lat, merged_pc, merged_normals, generator,
            draws=None if updates is None else updates.pop(0)), latent)
        sdf_volume = timed("rebake_seconds", bake_fn, latent)
    result = ObjTrackResult(rotation=torch.stack(rs), translation=torch.stack(ts),
                            sdf_energy=torch.stack(energies))
    return result, latent
