"""The object tracker as the benchmark runs it (`track/obj.track_obj_sequences_batched`,
the loop of `--eval_batch_seqs S`): S sequences of T frames a call, each
frame 10 iterations of the particle search over P candidates and N points
against the distilled SDF (kernel #4b on the `fused` route).

Set-up makes the inputs (the box volume, `input_sets` sets of S sequences,
the particle bank), distils the volume through the port's
`sdf/distill.distill_sdf_volume` (the `distill_s` span), and warms the loop
up on three frames. A call tracks one set whole. The check replays sampled
frames in the plain reference from the pose the port reached on the frame
before, with the reference's own distillation of the same volume.
"""

from __future__ import annotations

import os
import time

import torch

from benchmark import core, inputs, work
from benchmark.reference import obj as ref_obj
from benchmark.reference import sdf as ref_sdf


def _angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rotation angle between rotations a, b (..., 3, 3), in degrees,
    from their chordal distance ||a - b|| = 2 sqrt(2) sin(angle / 2), which
    keeps its precision at small angles (an arccos of the trace does not)."""
    chord = torch.linalg.norm((a.double() - b.double()).flatten(-2), dim=-1)
    return torch.rad2deg(2.0 * torch.arcsin((chord / (2.0 * 2.0 ** 0.5)).clamp(max=1.0)))


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.S, self.T = traffic["sequences"], traffic["frames"]
        self.frames_per_call = self.S * self.T
        self.chunk_frames_per_call = self.T

    # -- set-up ----------------------------------------------------------------
    def make_inputs(self) -> None:
        cfg, dev = self.cfg, self.device
        vol = cfg["volume"]
        self.volume = ref_sdf.box_volume(vol["size"], vol["voxel_scale"], cfg["box_half"], dev)
        g = inputs.generator(self.seed, dev, 1)
        n_sets = self.traffic["input_sets"]
        seqs = inputs.object_sequences(g, n_sets * self.S, self.T, cfg["num_points"],
                                       cfg["motion"], cfg["box_half"])
        r0, t0 = inputs.jittered_start(g, seqs["rotation"][:, 0], seqs["translation"][:, 0],
                                       cfg["init_jitter"])
        self.clouds = seqs["cloud"].reshape(n_sets, self.S, self.T, cfg["num_points"], 3)
        self.init_r = r0.reshape(n_sets, self.S, 3, 3)
        self.init_t = t0.reshape(n_sets, self.S, 3)
        self.bank = inputs.particle_bank(g, cfg["num_particles"], 6)

    def setup(self, spans: dict) -> None:
        from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
        from hotrack_tpu_torch.track import track_obj_sequences_batched

        self.make_inputs()
        d = self.cfg["distill"]
        core.sync(self.device)
        t0 = time.perf_counter()
        self.model = distill_sdf_volume(
            self.volume, self.cfg["volume"]["voxel_scale"],
            inputs.generator(self.seed, self.device, 2), steps=d["steps"], batch=d["batch"],
            clamp=self.cfg["sdf_mlp"]["clamp"], lr=d["lr"], hidden=self.cfg["sdf_mlp"]["hidden"],
            depth=self.cfg["sdf_mlp"]["depth"], max_freqs=self.cfg["sdf_mlp"]["max_freqs"],
            pool_batches=d["pool_batches"])
        core.sync(self.device)
        spans["distill_s"] = time.perf_counter() - t0
        self.track = track_obj_sequences_batched
        self.call(0, frames=3)   # warm-up: every shape of the loop

    def call(self, k: int, frames: int | None = None):
        """Track input set k % input_sets whole (or its first `frames`)."""
        i = k % self.traffic["input_sets"]
        clouds = self.clouds[i] if frames is None else self.clouds[i, :, :frames]
        vol = self.cfg["volume"]
        out = self.track(None, self.bank, clouds, self.init_r[i], self.init_t[i][..., None],
                         voxel_scale=vol["voxel_scale"], bbox_res=vol["size"],
                         distilled=[self.model] * self.S, obj_energy=self.cfg["obj_energy"])
        return {"set": i, "rotation": out.rotation, "translation": out.translation[..., 0],
                "energy": out.sdf_energy}

    def free_program(self) -> None:
        self.model = self.track = None

    def control(self, on: bool) -> None:
        """The precision control: the port's own bf16 SDF path
        (HOTRACK_SDF_BF16, read at each optimiser call) on or off."""
        if on:
            os.environ["HOTRACK_SDF_BF16"] = "1"
        else:
            os.environ.pop("HOTRACK_SDF_BF16", None)

    # -- yardstick -------------------------------------------------------------
    def work_per_chunk_frame(self) -> dict:
        cfg = self.cfg
        energy = work.obj_energy_work(self.S, cfg["num_particles"], cfg["num_points"],
                                      cfg["sdf_mlp"])
        n = cfg["iterations"]
        least = n * work.least_seconds(**energy)
        return {"obj_energy": {"least_s": least}, "model": {"least_s": least}}

    def reference_model(self):
        """The reference's own distillation of the volume, made once."""
        if getattr(self, "_ref_model", None) is None:
            cfg, d, mlp = self.cfg, self.cfg["distill"], self.cfg["sdf_mlp"]
            self._ref_model = ref_sdf.distill(
                self.volume, cfg["volume"]["voxel_scale"],
                inputs.generator(self.seed, self.device, 2), steps=d["steps"],
                batch=d["batch"], clamp=mlp["clamp"], lr=d["lr"], hidden=mlp["hidden"],
                depth=mlp["depth"], max_freqs=mlp["max_freqs"], pool_batches=d["pool_batches"])
        return self._ref_model

    def check(self, records: list) -> dict:
        """Replay sampled frames of the window's calls in the plain reference,
        each from the port's pose on the frame before (frame 0 from the
        jittered start): {gap: one value a sampled frame} -- the rotation
        (deg), the translation (mm) and the relative energy between the
        port's answer and the reference's."""
        cfg = self.cfg
        items = [(c, s, f) for c in range(len(records)) for s in range(self.S)
                 for f in range(self.T)]
        pick = torch.randperm(len(items), generator=torch.Generator().manual_seed(
            inputs.sub_seed(self.seed, 3)))[:self.traffic["check_items"]]
        chosen = [items[j] for j in pick.tolist()]
        model = self.reference_model()
        gaps = {"rot_deg": [], "trans_mm": [], "energy_rel": []}
        block = self.traffic["check_block"]
        for lo in range(0, len(chosen), block):
            part = chosen[lo:lo + block]
            clouds, r0, t0, r1, t1, e1 = [], [], [], [], [], []
            for c, s, f in part:
                rec = records[c]
                clouds.append(self.clouds[rec["set"], s, f])
                if f == 0:
                    r0.append(self.init_r[rec["set"], s]), t0.append(self.init_t[rec["set"], s])
                else:
                    r0.append(rec["rotation"][s, f - 1]), t0.append(rec["translation"][s, f - 1])
                r1.append(rec["rotation"][s, f]), t1.append(rec["translation"][s, f])
                e1.append(rec["energy"][s, f])
            r, t, e = ref_obj.optimise(model, self.bank, torch.stack(clouds), torch.stack(r0),
                                       torch.stack(t0), cfg["iterations"])
            gaps["rot_deg"].append(_angle_deg(torch.stack(r1), r))
            gaps["trans_mm"].append(1e3 * torch.linalg.norm(torch.stack(t1) - t, dim=-1))
            gaps["energy_rel"].append((torch.stack(e1) - e).abs() / e.abs())
        return {k: torch.cat(v).double().cpu() for k, v in gaps.items()}
