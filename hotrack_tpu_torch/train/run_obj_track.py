"""Object tracking runner: per-sequence SDF set-up, frame loop, evaluation
and trajectory pickles (port of hotrack_tpu/train/run_obj_track.py).

Per sequence: resolve the SDF volume (the analytic box of the synthetic set,
or a DeepSDF decoder baked over the 201^3 grid), distil it into the small MLP
where `sdf_query` says so, run the particle optimiser frame by frame from the
jittered ground-truth pose, evaluate the symmetry-aware pose errors, and with
--save write the trajectory pickle the hand stage reads.

Config keys beyond the JAX package's:

- `sdf_query`: distilled | volume. Default by device: `distilled` on a CUDA
  device (the queries run in the hand-written kernels), `volume` on the CPU
  (the exact trilinear lookup).
- `obj_energy`: fused | composed, default fused. How the distilled route
  computes an iteration's energy: one fused kernel (csrc/obj_energy.cu), or
  matmul + the SDF MLP kernel (csrc/sdf_mlp.cu) + mean.

With `opt/updateobjshape: True` and a DeepSDF decoder (HO3D, DexYCB), a
sequence is tracked with online shape refinement
(track/obj.track_obj_with_shape_update): the volume route on a volume
re-baked from the refined latent every 10 frames, as the JAX runner tracks
it (no distilled model is fitted for it), and the refined shape is written
beside the reconstruction as `*_update.ply`. Where the gt and reconstructed
meshes exist, the chamfer distances (mm) join the metrics.
"""

from __future__ import annotations

import os
import pickle
import time
from os.path import join as pjoin

import numpy as np
import torch

from ..data import get_dataloader, prepare_batch
from ..mano.model import get_mano_model
from ..opt import presample_particles
from ..opt.obj_pose import OBJ_ENERGY_ROUTES
from ..sdf.assets import (
    cat_to_ins_coords,
    load_obj_for_opt,
    load_torch_decoder,
    load_torch_latent,
    synthetic_box_sdf_setup,
)
from ..ops.pointops import farthest_point_sample
from ..sdf.distill import distill_sdf_volume, distilled_to
from ..sdf.mesh import chamfer_distance, create_mesh, load_mesh, sample_surface, write_ply
from ..sdf.volume import bake_sdf_volume, volume_coords
from ..track.eval import eval_obj_sequence
from ..track.obj import track_obj_sequence, track_obj_with_shape_update

VOLUME_SIZE = 201
VOXEL_SCALE = 0.002
NUM_PARTICLES = 2048
UPDATED_MESH_RES = 128   # the refined shape's mesh grid (create_mesh)


def _sequence_assets(cfg, meta0, device, size: int | None = None,
                     scale: float | None = None, bake: bool = True) -> dict:
    """The per-sequence SDF assets on `device`: the size^3 volume at `scale`
    (default: the object optimiser's 201^3 at 2 mm) and, where the DeepSDF
    checkpoints exist, the decoder and latent code it was baked from, the
    bake as a function of the latent and the category -> instance frame
    change of points. `bake=False` leaves the decoder's volume out (None):
    the shape-update tracker bakes its own."""
    size = VOLUME_SIZE if size is None else size
    scale = VOXEL_SCALE if scale is None else scale
    source = cfg.get("sdf_code_source", "pred")
    if source == "synthetic":
        return {"volume": synthetic_box_sdf_setup(size, scale, device=device),
                "decoder": None}
    assets = load_obj_for_opt(cfg["data_cfg"]["basepath"],
                              cfg["data_cfg"]["dataset_name"], source,
                              meta0["file_name"], meta0["category"])
    decoder = load_torch_decoder(assets.model_pth, cfg["opt"]["NetworkSpecs"]).to(device)
    latent = load_torch_latent(assets.latent_code_pth).to(device)
    coords = volume_coords(size, scale, device=device)
    ins_coords = cat_to_ins_coords(coords, assets.normalization)
    norm_scale = float(assets.normalization["scale"][0])

    def bake_fn(lat):
        return bake_sdf_volume(decoder, lat, ins_coords, size, norm_scale)

    def cat_to_ins(points):
        return cat_to_ins_coords(points, assets.normalization)

    return {"volume": bake_fn(latent) if bake else None, "decoder": decoder, "latent": latent,
            "bake_fn": bake_fn, "cat_to_ins": cat_to_ins, "assets": assets}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_obj_tracking(cfg, save_flag: bool = False, distilled: list | None = None):
    """Track every test sequence on cfg['device']. Returns (mean metrics
    keyed 'mean/...', stats): stats holds fps_all / fps_network (frames per
    second of wall time with and without the per-sequence set-up), and per
    sequence the poses, the initial pose, the sampled clouds, the metric
    means, the distilled model (on the CPU) and the seconds of set-up,
    distillation and tracking; 'particles' is the bank every sequence used.
    A sequence tracked with shape refinement also holds its final latent
    ('latent', on the CPU), the written mesh's path ('updated_mesh') and the
    seconds of its first bake, each update, each re-bake and the mesh export,
    all within its tracking seconds, as the JAX runner times them.

    `distilled`: one DistilledSDF per sequence, used instead of distilling
    (a rerun on another device with the same fit)."""
    device = torch.device(cfg.get("device", "cuda"))
    sdf_query = cfg.get("sdf_query") or ("distilled" if device.type == "cuda" else "volume")
    if sdf_query not in ("distilled", "volume"):
        raise ValueError(f"sdf_query must be distilled or volume, got {sdf_query!r}")
    obj_energy = cfg.get("obj_energy") or "fused"
    if obj_energy not in OBJ_ENERGY_ROUTES:
        raise ValueError(f"obj_energy must be one of {OBJ_ENERGY_ROUTES}, got {obj_energy!r}")

    loader = get_dataloader(cfg, "test")
    # every draw on the host: the same bank, jitter and fit draws on any device
    generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    particles = presample_particles(NUM_PARTICLES, 6, generator, device=device)
    oj = cfg["obj_jitter_cfg"]
    obj_jitter = {"rotation": float(np.deg2rad(oj["r"])), "translation": oj["t"],
                  "scale": oj["s"]}
    mano = get_mano_model(cfg.get("mano_root")).to(device)

    total, sequences = {}, []
    n_frames, net_time, data_time = 0, 0.0, 0.0
    for seq_idx in range(len(loader)):
        t0 = time.perf_counter()
        raw, metas = loader[seq_idx]
        batch = prepare_batch(mano, raw, cfg["num_points"], generator=generator,
                              obj_jitter=obj_jitter, obj_jitter_kind=oj["type"],
                              sample_kind=cfg.get("point_sample", "fps"), device=device)
        update = bool(cfg.get("opt", {}).get("updateobjshape"))
        seq_assets = _sequence_assets(cfg, metas[0], device, bake=not update)
        volume = seq_assets["volume"]
        update = update and seq_assets["decoder"] is not None
        model, distill_s = None, 0.0
        if sdf_query == "distilled" and not update:
            _sync(device)
            td = time.perf_counter()
            if distilled is not None:
                model = distilled_to(distilled[seq_idx], device)
            else:
                model = distill_sdf_volume(volume, VOXEL_SCALE, generator)
            _sync(device)
            distill_s = time.perf_counter() - td
        init_r = batch["jittered_obj_pose"]["rotation"][0]
        init_t = batch["jittered_obj_pose"]["translation"][0]
        _sync(device)
        t1 = time.perf_counter()
        shape = {}
        if update:
            # online shape refinement on the re-baked volume (the volume route)
            timings = {}
            result, latent = track_obj_with_shape_update(
                seq_assets["decoder"], seq_assets["latent"], seq_assets["bake_fn"],
                seq_assets["cat_to_ins"], particles, batch["obj_points"], init_r, init_t,
                voxel_scale=VOXEL_SCALE, bbox_res=VOLUME_SIZE, generator=generator,
                timings=timings)
            # the export inside the tracking window, as the JAX runner times it
            path, export_s = _export_updated_mesh(seq_assets, latent)
            _sync(device)
            t2 = time.perf_counter()
            shape = {"latent": latent.cpu(), "updated_mesh": path,
                     "export_seconds": export_s, **timings}
        else:
            result = track_obj_sequence(volume, particles, batch["obj_points"], init_r,
                                        init_t, voxel_scale=VOXEL_SCALE,
                                        bbox_res=VOLUME_SIZE, distilled=model,
                                        obj_energy=obj_energy)
            _sync(device)
            t2 = time.perf_counter()
        data_time += t1 - t0
        net_time += t2 - t1
        n_frames += batch["obj_points"].shape[0]

        # 'can' / 'box' categories get the extra up/down flip at evaluation
        cat = metas[0]["category"] or ""
        up_down = ("can" in cat) or ("box" in cat)
        gt_r = batch["gt_obj_pose"]["rotation"]
        gt_t = batch["gt_obj_pose"]["translation"]
        result_eval = result
        fix = _cat2ins_fixup(cfg, cat, device)
        if fix is not None:
            # YCB category -> instance frame change before evaluation
            r_fix, t_fix = fix
            gt_r = torch.matmul(gt_r, r_fix.T)
            gt_t = gt_t - torch.matmul(gt_r, t_fix.reshape(1, 3, 1))
            pred_r = torch.matmul(result.rotation, r_fix.T)
            pred_t = result.translation - torch.matmul(pred_r, t_fix.reshape(1, 3, 1))
            result_eval = result._replace(rotation=pred_r, translation=pred_t)
        metrics = eval_obj_sequence(result_eval, gt_r, gt_t, cfg["obj_sym"],
                                    up_and_down_sym=up_down)
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        metrics.update(_chamfer_eval(cfg, metas[0], result, batch) or {})
        means = {k: float(v) for k, v in metrics.items() if k.startswith("mean/")}
        for k, v in means.items():
            total[k] = total.get(k, 0.0) + v
        sequences.append({
            "rotation": result.rotation.cpu().numpy(),
            "translation": result.translation.cpu().numpy(),
            "sdf_energy": result.sdf_energy.cpu().numpy(),
            "init_rotation": init_r.cpu().numpy(),
            "init_translation": init_t.cpu().numpy(),
            "gt_rotation": batch["gt_obj_pose"]["rotation"].cpu().numpy(),
            "gt_translation": batch["gt_obj_pose"]["translation"].cpu().numpy(),
            "obj_points": batch["obj_points"].cpu().numpy(),
            "rdiff": metrics["rdiff_0"], "tdiff": metrics["tdiff_0"],
            "means": means, "sdf_query": "volume" if update else sdf_query,
            "obj_energy": obj_energy, **shape,
            "distilled": None if model is None else distilled_to(model, "cpu"),
            "setup_seconds": t1 - t0, "distill_seconds": distill_s,
            "net_seconds": t2 - t1})
        print(f"seq {seq_idx}: {means}")
        if save_flag:
            _save_sequence(cfg, metas, result, batch, metrics)

    avg = {k: v / max(len(sequences), 1) for k, v in total.items()}
    fps_all = n_frames / max(net_time + data_time, 1e-9)
    fps_net = n_frames / max(net_time, 1e-9)
    routes = sorted({seq["sdf_query"] for seq in sequences}) or [sdf_query]
    print(f"frames {n_frames}  FPS(all) {fps_all:.1f}  FPS(network) {fps_net:.1f}"
          f"  device {device}  sdf_query {'/'.join(routes)}")
    print("overall:", {k: round(v, 5) for k, v in avg.items()})
    return avg, {"fps_all": fps_all, "fps_network": fps_net, "n_frames": n_frames,
                 "net_seconds": net_time, "data_seconds": data_time,
                 "particles": particles.cpu().numpy(), "sequences": sequences}


def _export_updated_mesh(seq_assets: dict, latent: torch.Tensor):
    """The refined shape as a marching-tetrahedra mesh of the decoder over a
    UPDATED_MESH_RES^3 grid, written beside the reconstruction as `*_update.ply`. Returns
    (the path or None, seconds). Without a reconstruction path the export is
    skipped; a failed write (OSError) is reported and skipped; a failure of
    the bake or of the mesh raises."""
    recon = seq_assets["assets"].recon_mesh_path
    if recon is None:
        print("mesh export skipped: the sequence has no reconstruction path")
        return None, 0.0
    t0 = time.perf_counter()
    verts, faces = create_mesh(seq_assets["decoder"], latent, n=UPDATED_MESH_RES)
    out = recon.replace(".ply", "_update.ply")
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        write_ply(out, verts, faces)
    except OSError as e:
        print(f"mesh export skipped: {e}")
        return None, time.perf_counter() - t0
    print(f"updated mesh written to {out}")
    return out, time.perf_counter() - t0


def _chamfer_eval(cfg, meta0, result, batch):
    """Chamfer distance (mm) of the reconstructed mesh to the gt mesh, raw
    and posed: 2048 gt surface samples (numpy's RandomState(0)) against the
    reconstruction's vertices, FPS-sampled to 2048 where there are more (on
    the card through the FPS kernel) and moved into the category frame; the
    posed distance is the mean over every max(T // 10, 1)-th frame of the
    two sets under the gt and the tracked pose. None for the synthetic set
    and where a mesh is missing."""
    source = cfg.get("sdf_code_source", "pred")
    if source == "synthetic":
        return None
    try:
        assets = load_obj_for_opt(cfg["data_cfg"]["basepath"],
                                  cfg["data_cfg"]["dataset_name"], source,
                                  meta0["file_name"], meta0["category"])
        gt_v, gt_f = load_mesh(assets.gt_mesh_path)
        pred_v, _ = load_mesh(assets.recon_mesh_path)
    except (FileNotFoundError, OSError):
        return None
    device = result.rotation.device
    gt_samples = torch.tensor(sample_surface(gt_v, gt_f, 2048), dtype=torch.float32,
                              device=device)
    pred_v = torch.tensor(pred_v, dtype=torch.float32, device=device)
    if len(pred_v) > 2048:
        pred_v = pred_v[farthest_point_sample(pred_v[None], 2048)[0].long()]
    if source != "gt":
        # instance -> category frame
        fix = _cat2ins_fixup(cfg, meta0["category"], device)
        if fix is not None:
            r_fix, t_fix = fix
            pred_v = torch.matmul(pred_v - t_fix, r_fix)
        norm = assets.normalization
        pred_v = (pred_v / torch.as_tensor(norm["scale"], device=device)
                  - torch.as_tensor(norm["offset"], device=device))
    raw = float(chamfer_distance(gt_samples, pred_v)) * 1000.0
    t_frames = result.rotation.shape[0]
    gt_r, gt_t = batch["gt_obj_pose"]["rotation"], batch["gt_obj_pose"]["translation"]
    posed = []
    for i in range(0, t_frames, max(t_frames // 10, 1)):
        g = gt_samples @ gt_r[i].T + gt_t[i][:, 0]
        p = pred_v @ result.rotation[i].T + result.translation[i][:, 0]
        posed.append(float(chamfer_distance(g, p)) * 1000.0)
    return {"mean/raw_obj_chamfer(mm)": np.float64(raw),
            "mean/pred_obj_chamfer(mm)": np.float64(np.mean(posed))}


def _cat2ins_fixup(cfg, instance: str, device=None):
    """Per-instance category -> instance frame change for HO3D / DexYCB
    evaluation, from <root>/YCB/CatPose2InsPose.npy. Returns (R (3, 3),
    T (3,)) tensors or None."""
    if cfg["data_cfg"]["dataset_name"] not in ("HO3D", "DexYCB"):
        return None
    path = pjoin(cfg["root_dir"], "YCB", "CatPose2InsPose.npy")
    if not os.path.exists(path):
        return None
    change = np.load(path, allow_pickle=True).item()
    if instance not in change:
        return None
    return (torch.as_tensor(change[instance]["rotation"], dtype=torch.float32, device=device),
            torch.as_tensor(change[instance]["translation"], dtype=torch.float32,
                            device=device))


def _save_sequence(cfg, metas, result, batch, metrics):
    """Trajectory pickle in the reference's format."""
    rot, trans = result.rotation.cpu().numpy(), result.translation.cpu().numpy()
    gt_rot = batch["gt_obj_pose"]["rotation"].cpu().numpy()
    gt_trans = batch["gt_obj_pose"]["translation"].cpu().numpy()
    t = rot.shape[0]
    save_dict = {
        "pred_obj_poses": [{"rotation": rot[i], "translation": trans[i]}
                           for i in range(t)],
        "gt_obj_poses": [{"rotation": gt_rot[i], "translation": gt_trans[i]}
                         for i in range(t)],
        "file_name": [m["file_name"] for m in metas],
        "r_error_0": np.asarray(metrics["rdiff_0"]),
        "t_error_0": np.asarray(metrics["tdiff_0"]),
        "CAD_ID": metas[0]["category"],
    }
    ds = cfg["data_cfg"]["dataset_name"]
    if ds in ("HO3D", "DexYCB", "HOI4D"):
        name = metas[0]["file_name"].replace("/", "_") + ".pkl"
    else:
        name = metas[0]["category"] + "_" + metas[0]["file_name"][:-4] + ".pkl"
    os.makedirs(cfg["save_dir"], exist_ok=True)
    with open(pjoin(cfg["save_dir"], name), "wb") as f:
        pickle.dump(save_dict, f)
