"""SDF asset resolution: DeepSDF checkpoints, latent codes, normalisation
(port of hotrack_tpu/sdf/assets.py).

`load_obj_for_opt` holds the per-dataset path logic for the decoder
checkpoint, the instance latent code, the normalisation parameters and the
gt / reconstructed meshes. A reference DeepSDF checkpoint loads into this
package's `SDFDecoder` key for key. Where the licensed assets are missing
(tests, the synthetic benchmarks), `synthetic_box_sdf_setup` builds the
analytic box SDF volume of the synthetic dataset generator's object.
"""

from __future__ import annotations

from os.path import join as pjoin
from typing import NamedTuple

import numpy as np
import torch

from .decoder import SDFDecoder
from .volume import volume_coords

_DECODER_SPECS = ("dims", "dropout", "dropout_prob", "norm_layers", "latent_in",
                  "weight_norm", "use_tanh")


class ObjSDFAssets(NamedTuple):
    latent_code_pth: str
    normalization: dict          # {'offset' (3,), 'scale' (1,)}
    model_pth: str
    gt_mesh_path: str | None
    recon_mesh_path: str | None


def load_obj_for_opt(root_dir: str, dataset_name: str, sdf_code_source: str,
                     seq_frame: str, instance: str) -> ObjSDFAssets:
    """Resolve the asset paths of one sequence."""
    if dataset_name == "HO3D":
        model_pth = pjoin(root_dir, "../SimGrasp/SDF/examples/bottle_sim/ModelParameters/2000.pth")
        norm_pth = pjoin(root_dir, f"../YCB/SDF/NormalizationParameters/{instance}/textured_simple.npz")
        gt_mesh = pjoin(root_dir, f"../YCB/models/{instance}/textured_simple.obj")
        if sdf_code_source == "gt":
            latent = pjoin(root_dir, f"../YCB/SDF/2000/Codes/gt/{instance}.pth")
            recon = gt_mesh
        else:
            latent = pjoin(root_dir, "SDF/2000/Codes/pred/%s.pth" % seq_frame.replace("/", "_"))
            recon = latent.replace("Codes", "Meshes").replace(".pth", ".ply")
    elif dataset_name == "SimGrasp":
        if "sim" not in instance:
            instance = instance + "_sim"
        latent_dir = pjoin(root_dir, f"SDF/Reconstructions/{instance}/2000/Codes")
        latent = pjoin(latent_dir, (seq_frame[:5] if sdf_code_source == "gt"
                                    else seq_frame) + ".pth")
        recon = latent.replace("Codes", "Meshes").replace(".pth", ".ply")
        norm_pth = pjoin(root_dir, f"SDF/NormalizationParameters/{instance}", seq_frame[:5] + ".npz")
        model_pth = pjoin(root_dir, f"SDF/examples/{instance}/ModelParameters/2000.pth")
        gt_mesh = pjoin(root_dir, f"objs/{instance}/{seq_frame[:5]}.obj")
    elif dataset_name == "DexYCB":
        gt_mesh = pjoin(root_dir, f"../YCB/models/{instance}/textured_simple.obj")
        if sdf_code_source == "gt":
            latent = pjoin(root_dir, f"../YCB/SDF/2000/Codes/gt/{instance}.pth")
            recon = gt_mesh
        else:
            latent = pjoin(root_dir, "SDF/2000/Codes/pred/%s.pth" % seq_frame.replace("+", "_"))
            recon = (latent.replace("Codes", "Meshes")
                     .replace("pred/", f"pred/{instance}_").replace(".pth", ".ply"))
        norm_pth = pjoin(root_dir, f"../YCB/SDF/NormalizationParameters/{instance}/textured_simple.npz")
        which = "bowl_sim" if "bowl" in instance else "bottle_sim"
        model_pth = pjoin(root_dir, f"../SimGrasp/SDF/examples/{which}/ModelParameters/2000.pth")
    else:
        raise NotImplementedError(dataset_name)
    norm = dict(np.load(norm_pth))
    return ObjSDFAssets(latent, norm, model_pth, gt_mesh, recon)


def build_decoder(network_specs: dict, latent_size: int = 256) -> SDFDecoder:
    """An `SDFDecoder` of the config's `opt/NetworkSpecs`."""
    return SDFDecoder(latent_size=latent_size, **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in network_specs.items() if k in _DECODER_SPECS})


def load_torch_decoder(model_pth: str, network_specs: dict) -> SDFDecoder:
    """A reference DeepSDF checkpoint into an `SDFDecoder` in eval mode: the
    `module.` prefix of its DataParallel wrapper is stripped, every other key
    (lin{i}.weight_g, lin{i}.weight_v, lin{i}.bias) is the module's own."""
    state = torch.load(model_pth, map_location="cpu",
                       weights_only=True)["model_state_dict"]
    decoder = build_decoder(network_specs)
    decoder.load_state_dict({k.replace("module.", ""): v for k, v in state.items()},
                            strict=True)
    return decoder.eval()


def load_torch_latent(latent_pth: str) -> torch.Tensor:
    code = torch.load(latent_pth, map_location="cpu", weights_only=True)
    if isinstance(code, (list, tuple)):
        code = code[0]
    return code.detach().reshape(-1)


def cat_to_ins_coords(coords: torch.Tensor, normalization: dict,
                      rotation=None, translation=None) -> torch.Tensor:
    """Category frame -> DeepSDF instance frame. For HO3D / DexYCB pass the
    per-instance R / T of CatPose2InsPose.npy."""
    def like(a):
        return torch.tensor(np.asarray(a), dtype=coords.dtype, device=coords.device)

    out = (coords + like(normalization["offset"])) * like(normalization["scale"])
    if rotation is not None:
        out = torch.matmul(out, like(rotation).transpose(-1, -2)) + like(translation)
    return out


def synthetic_box_sdf_setup(volume_size: int = 201, voxel_scale: float = 0.002,
                            half=(0.035, 0.05, 0.025), device=None) -> torch.Tensor:
    """Analytic box SDF volume of data/synthetic.py's object: the stand-in
    for the baked DeepSDF volume."""
    c = volume_coords(volume_size, voxel_scale, device=device)
    q = torch.abs(c) - torch.tensor(half, dtype=c.dtype, device=c.device)
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
    return (outside + inside).reshape(volume_size, volume_size, volume_size)
