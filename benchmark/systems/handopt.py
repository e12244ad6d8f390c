"""The hand pipeline as the benchmark runs it (`track/hand.track_hand_sequences_batched`,
the loop of `--eval_batch_seqs S` on `track: hand_IKNet`): S sequences of T
frames a call; per frame HandTrackNet, IKNet and the pose optimiser (5
iterations x P particles x 778 vertices against the distilled object SDF and
the silhouette: the `skin` route, kernel #7b); on frame 0 the shape
optimiser (shape mode 1). A mix whose `mode` is `online` streams one long
sequence instead through `track/stream.HandTracker.serve(depth=1)`, the
live-camera loop, with frame 0 (the shape optimiser's) before the served
frames; each call times the hand-out of every served frame.

Set-up makes the inputs (the synthetic MANO rig, `input_sets` sets of S
sequences with their masks, the banks, the nets' weights), distils the
object's volume through the port (the `distill_s` span), and warms the loop
up on three frames. The check replays sampled frames in the plain reference
(benchmark/reference/hand) from the port's state, stage by stage:
HandTrackNet from the keypoints the port carried into the frame; IKNet and
the pose optimiser from the port's HandTrackNet keypoints; the frame-0 shape
optimiser from the reference's own frame-0 HandTrackNet pass.
"""

from __future__ import annotations

import math
import os
import time

import torch

from benchmark import core, inputs, work
from benchmark.reference import sdf as ref_sdf
from benchmark.reference.hand import hand_network as ref_net
from benchmark.reference.hand import hand_pose as ref_pose
from benchmark.reference.hand import hand_shape as ref_shape
from benchmark.reference.hand import mano_layer as ref_mano
from benchmark.reference.hand import mano_model as ref_rig
from benchmark.reference.hand.hand_utils import handkp2palmkp


def seeded_weights(net: torch.nn.Module, g: torch.Generator, head_scale: float) -> dict:
    """A state dict for `net` from one draw: Linear weights N(0, 1/fan_in),
    biases N(0, 0.01/fan_in), norms' scales 1 + N(0, 0.01) and shifts N(0,
    0.01), running statistics 0 and 1; the delta head (`final_mlp.2`) scaled
    by head_scale, as random-init tracking needs."""
    state = net.state_dict()
    floats = [k for k, v in state.items() if v.is_floating_point()]
    draw = torch.randn(sum(state[k].numel() for k in floats), generator=g, device=g.device)
    out, at = {}, 0
    norms = {n for n, m in net.named_modules()
             if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.LayerNorm))}
    for key, value in state.items():
        if key not in floats:
            out[key] = value.to(g.device)
            continue
        r = draw[at:at + value.numel()].reshape(value.shape)
        at += value.numel()
        module, leaf = key.rsplit(".", 1)
        if leaf == "running_mean":
            out[key] = torch.zeros_like(r)
        elif leaf == "running_var":
            out[key] = torch.ones_like(r)
        elif module in norms:
            out[key] = (1.0 if leaf == "weight" else 0.0) + 0.1 * r
        else:
            fan_in = value.shape[1] if value.dim() == 2 else state[f"{module}.weight"].shape[1]
            out[key] = r / math.sqrt(fan_in) * (1.0 if leaf == "weight" else 0.1)
        if module == "final_mlp.2":
            out[key] = out[key] * head_scale
    return out


def silhouette_background(verts: torch.Tensor, projection, hw, radius: int,
                          chunk: int = 64) -> torch.Tensor:
    """Background masks (F, H, W) bool of hands (F, V, 3) in the camera frame:
    every pixel but those within `radius` pixels (a square) of a projected
    vertex, the hand's silhouette."""
    h, w = hw
    fx, fy, cx, cy = (float(v) for v in projection[:4])
    out = []
    for lo in range(0, verts.shape[0], chunk):
        v = verts[lo:lo + chunk]
        iy = torch.clamp((v[..., 1] / v[..., 2] * fy + cy).long(), 0, h - 1)
        ix = torch.clamp((v[..., 0] / v[..., 2] * fx + cx).long(), 0, w - 1)
        hit = torch.zeros((v.shape[0], h * w), dtype=torch.float16, device=v.device)
        hit.scatter_(1, iy * w + ix, 1.0)
        grown = torch.nn.functional.max_pool2d(hit.reshape(-1, 1, h, w), 2 * radius + 1,
                                               stride=1, padding=radius)
        out.append(grown[:, 0] == 0)
    return torch.cat(out)


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.S, self.T = traffic["sequences"], traffic["frames"]
        self.frames_per_call = self.S * self.T
        self.chunk_frames_per_call = self.T
        self.online = traffic.get("mode") == "online"

    # -- set-up ----------------------------------------------------------------
    def make_inputs(self) -> None:
        cfg, dev, S, T = self.cfg, self.device, self.S, self.T
        g = inputs.generator(self.seed, dev, 1)
        self.rig = ref_rig.synthetic_mano_model(inputs.sub_seed(self.seed, 4) % 2**32).to(dev)
        vol = cfg["volume"]
        self.volume = ref_sdf.box_volume(vol["size"], vol["voxel_scale"], cfg["box_half"], dev)
        n = self.traffic["input_sets"] * S
        motion = cfg["motion"]
        obj = inputs.object_sequences(g, n, T, 1, motion, cfg["box_half"])
        beta = torch.randn((n, 10), generator=g, device=dev) * 0.5
        pose = inputs.smooth_walk(g, n, T, 48, motion["hand_pose_step"])
        pose[..., :3] += torch.randn((n, 1, 3), generator=g, device=dev) * 0.4
        pose[..., 3:] += torch.randn((n, 1, 45), generator=g, device=dev) * 0.15
        wrist = torch.tensor([0.0, -0.09, 0.0], device=dev)
        trans = obj["translation"] + torch.matmul(obj["rotation"], wrist) \
            + torch.randn((n, T, 3), generator=g, device=dev) * 0.001
        verts, kp = ref_mano.mano_forward(
            self.rig, pose.reshape(-1, 48), betas=beta.repeat_interleave(T, 0),
            trans=trans.reshape(-1, 3), original_version=True)
        pick = torch.argsort(torch.rand((n * T, verts.shape[1]), generator=g, device=dev),
                             dim=-1)[:, :cfg["num_points"]]
        points = torch.gather(verts, 1, pick[..., None].expand(-1, -1, 3))
        points = points + torch.randn(points.shape, generator=g, device=dev) * motion["noise"]
        kp = kp.reshape(n, T, 21, 3)
        jittered = kp + torch.randn(kp.shape, generator=g, device=dev) * cfg["kp_jitter_m"]
        proj = torch.tensor(cfg["projection"], device=dev).expand(n, T, -1)
        masks = silhouette_background(verts, cfg["projection"], cfg["mask_hw"],
                                      cfg["silhouette_px"]).reshape(n, T, *cfg["mask_hw"])

        def sets(x):
            return x.reshape(self.traffic["input_sets"], S, *x.shape[1:])

        self.frames = [{"hand_points": p, "jittered_hand_kp": j, "projection": q,
                        "gt_obj_pose": {"rotation": r, "translation": t[..., None]}}
                       for p, j, q, r, t in zip(sets(points.reshape(n, T, -1, 3)),
                                                sets(jittered), sets(proj),
                                                sets(obj["rotation"]), sets(obj["translation"]))]
        self.masks = sets(masks)
        self.shape_bank = inputs.particle_bank(g, cfg["num_particles"], 10)
        self.pose_bank = inputs.particle_bank(g, cfg["num_particles"], 16)
        self.zones = ref_pose.contact_zones(dev)
        net_cfg = cfg["network"]
        ref_h = ref_net.HandTrackNet(cfg["pointnet"], net_cfg["backbone_out_dim"], handframe="kp")
        ref_i = ref_net.IKNet(layer_num=net_cfg["iknet_layers"], width=net_cfg["iknet_width"])
        gw = inputs.generator(self.seed, dev, 5)
        self.handnet_weights = seeded_weights(ref_h, gw, net_cfg["head_scale"])
        self.iknet_weights = seeded_weights(ref_i, gw, 1.0)

    def setup(self, spans: dict) -> None:
        from hotrack_tpu_torch.mano.model import ManoModel
        from hotrack_tpu_torch.models.hand_network import HandTrackNet, IKNet
        from hotrack_tpu_torch.opt.hand_pose import ContactZones
        from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
        from hotrack_tpu_torch.track import track_hand_sequences_batched

        cfg, dev = self.cfg, self.device
        self.make_inputs()
        d, mlp = cfg["distill"], cfg["sdf_mlp"]
        core.sync(dev)
        t0 = time.perf_counter()
        self.model = distill_sdf_volume(
            self.volume, cfg["volume"]["voxel_scale"], inputs.generator(self.seed, dev, 2),
            steps=d["steps"], batch=d["batch"], clamp=mlp["clamp"], lr=d["lr"],
            hidden=mlp["hidden"], depth=mlp["depth"], max_freqs=mlp["max_freqs"],
            pool_batches=d["pool_batches"])
        core.sync(dev)
        spans["distill_s"] = time.perf_counter() - t0
        net_cfg = cfg["network"]
        self.handnet = HandTrackNet(cfg["pointnet"], backbone_out_dim=net_cfg["backbone_out_dim"],
                                    handframe="kp", compute_dtype=net_cfg.get("compute_dtype"))
        self.handnet.load_state_dict(self.handnet_weights)
        self.handnet = self.handnet.to(dev).eval()
        self.iknet = IKNet(layer_num=net_cfg["iknet_layers"], width=net_cfg["iknet_width"])
        self.iknet.load_state_dict(self.iknet_weights)
        self.iknet = self.iknet.to(dev).eval()
        self.mano = ManoModel(*self.rig)
        self.track = track_hand_sequences_batched
        self.prog_zones = ContactZones(*self.zones)
        if self.online:
            from hotrack_tpu_torch.track.stream import HandTracker

            self.tracker = HandTracker(
                self.handnet, self.mano, iknet=self.iknet, use_opt=True,
                shape_mode=cfg["shape_mode"], shape_particles=self.shape_bank,
                pose_particles=self.pose_bank, zones=self.prog_zones,
                energy_weight=cfg["energy_weight"], sdf_voxel_scale=cfg["volume"]["voxel_scale"],
                distilled=self.model, hand_energy=cfg["hand_energy"])
        self.call(0, frames=3)   # warm-up: frame 0's prelude and the loop's shapes

    def _serve(self, i: int, frames: int | None):
        """One sequence of set i streamed: frame 0, then frames 1.. served at
        depth 1, each served frame's hand-out time on the host's clock."""
        fr, masks = self.frames[i], self.masks[i]
        n = self.T if frames is None else frames

        def inputs_of(f):
            return dict(hand_points=fr["hand_points"][0, f], background_mask=masks[0, f],
                        obj_rotation=fr["gt_obj_pose"]["rotation"][0, f],
                        obj_translation=fr["gt_obj_pose"]["translation"][0, f],
                        projection=fr["projection"][0, f])

        state = self.tracker.init_state(fr["hand_points"][0, 0], fr["jittered_hand_kp"][0, 0])
        beta = state["shape_code"]
        state, first = self.tracker.step(state, **inputs_of(0))
        kp, base, times = [first["pred_kp"]], [first["baseline_pred_kp"]], []
        t0 = time.perf_counter()
        for out in self.tracker.serve(state, (inputs_of(f) for f in range(1, n)),
                                      fetch=("pred_kp", "baseline_pred_kp")):
            times.append(time.perf_counter() - t0)
            kp.append(torch.as_tensor(out["pred_kp"], device=self.device))
            base.append(torch.as_tensor(out["baseline_pred_kp"], device=self.device))
        return {"set": i, "pred_kp": torch.stack(kp)[None], "baseline_kp": torch.stack(base)[None],
                "beta": beta[:, None], "served_s": times}

    def extra(self, records: list) -> dict:
        """Online mixes: the served frames' hand-out intervals (ms)."""
        if not self.online:
            return {}
        gaps = torch.tensor([b - a for r in records
                             for a, b in zip([0.0] + r["served_s"][:-1], r["served_s"])],
                            dtype=torch.float64) * 1e3
        return {"served_frames": int(gaps.numel()),
                "frame_ms": {q: float(torch.quantile(gaps, p)) for q, p in
                             (("p50", 0.5), ("p95", 0.95), ("max", 1.0))}}

    def call(self, k: int, frames: int | None = None):
        """Track input set k % input_sets whole (or its first `frames`)."""
        i = k % self.traffic["input_sets"]
        if self.online:
            return self._serve(i, frames)
        fr, masks = self.frames[i], self.masks[i]
        if frames is not None:
            fr = {key: ({kk: vv[:, :frames] for kk, vv in v.items()} if isinstance(v, dict)
                        else v[:, :frames]) for key, v in fr.items()}
            masks = masks[:, :frames]
        cfg = self.cfg
        out = self.track(
            self.handnet, self.mano, fr, iknet=self.iknet, use_opt=True,
            shape_mode=cfg["shape_mode"], shape_particles=self.shape_bank,
            pose_particles=self.pose_bank, zones=self.prog_zones,
            background_masks=masks, energy_weight=cfg["energy_weight"],
            sdf_voxel_scale=cfg["volume"]["voxel_scale"], distilled=[self.model] * self.S,
            hand_energy=cfg["hand_energy"])
        return {"set": i, "pred_kp": out.pred_kp, "baseline_kp": out.baseline_pred_kp,
                "beta": out.pred_beta}

    def free_program(self) -> None:
        self.model = self.handnet = self.iknet = self.track = self._handnet32 = None
        self.tracker = None

    def control(self, on: bool) -> None:
        """The precision control: the port's own bf16 paths on or off, the
        SDF queries' (HOTRACK_SDF_BF16) and HandTrackNet's
        (`network/compute_dtype` bfloat16)."""
        from hotrack_tpu_torch.models.hand_network import HandTrackNet

        if on:
            os.environ["HOTRACK_SDF_BF16"] = "1"
            self._handnet32 = self.handnet
            net_cfg = self.cfg["network"]
            net = HandTrackNet(self.cfg["pointnet"], backbone_out_dim=net_cfg["backbone_out_dim"],
                               handframe="kp", compute_dtype="bfloat16")
            net.load_state_dict(self.handnet_weights)
            self.handnet = net.to(self.device).eval()
        else:
            os.environ.pop("HOTRACK_SDF_BF16", None)
            self.handnet = self._handnet32 or self.handnet

    # -- yardstick -------------------------------------------------------------
    def work_per_chunk_frame(self) -> dict:
        cfg = self.cfg
        energy = work.skin_energy_work(self.S, cfg["num_particles"], 778, cfg["sdf_mlp"])
        n = cfg["pose_iterations"]
        least = n * work.least_seconds(**energy)
        return {"skin_energy": {"least_s": least}, "model": {"least_s": least}}

    def check(self, records: list) -> dict:
        """Sampled frames of the window's calls replayed in the reference:
        {number: per-item gaps} -- HandTrackNet's keypoints (mm), the frame's
        final keypoints after IKNet and the pose optimiser (mm), and the
        frame-0 shape as its rest-pose bone lengths (mm), a sequence each."""
        cfg, dev, S, T = self.cfg, self.device, self.S, self.T
        if getattr(self, "_ref", None) is None:
            d, mlp = cfg["distill"], cfg["sdf_mlp"]
            model = ref_sdf.distill(self.volume, cfg["volume"]["voxel_scale"],
                                    inputs.generator(self.seed, dev, 2), steps=d["steps"],
                                    batch=d["batch"], clamp=mlp["clamp"], lr=d["lr"],
                                    hidden=mlp["hidden"], depth=mlp["depth"],
                                    max_freqs=mlp["max_freqs"], pool_batches=d["pool_batches"])
            net_cfg = cfg["network"]
            handnet = ref_net.HandTrackNet(cfg["pointnet"], net_cfg["backbone_out_dim"],
                                           handframe="kp")
            handnet.load_state_dict(self.handnet_weights)
            iknet = ref_net.IKNet(layer_num=net_cfg["iknet_layers"],
                                  width=net_cfg["iknet_width"])
            iknet.load_state_dict(self.iknet_weights)
            self._ref = (model, handnet.to(dev).eval(), iknet.to(dev).eval())
        model, handnet, iknet = self._ref
        rig = self.rig

        def palm_of(beta):   # the rest-pose palm of shapes (B, 10)
            _, kp = ref_mano.mano_forward(rig, torch.zeros((beta.shape[0], 48), device=dev),
                                          betas=beta)
            return kp, handkp2palmkp(kp)

        gaps = {"kp_net_mm": [], "kp_mm": [], "shape_mm": []}
        with torch.inference_mode():
            # the frame-0 shape optimiser, each sequence of each call
            for rec in records:
                fr = self.frames[rec["set"]]
                zero_beta = torch.zeros((S, 10), device=dev)
                ret0 = handnet(fr["hand_points"][:, 0], fr["jittered_hand_kp"][:, 0],
                               palm_of(zero_beta)[1])
                lengths = ref_shape.kp2length(ret0["pred_kp"])[:, None]
                beta, _ = ref_shape.optimize_hand_shape(rig, self.shape_bank, lengths)
                ref_len = ref_shape.kp2length(palm_of(beta.reshape(S, 10))[0])
                prog_len = ref_shape.kp2length(palm_of(rec["beta"].reshape(S, 10))[0])
                gaps["shape_mm"].append(1e3 * (ref_len - prog_len).abs().amax(-1))

            items = [(c, s, f) for c in range(len(records)) for s in range(S) for f in range(T)]
            pick = torch.randperm(len(items), generator=torch.Generator().manual_seed(
                inputs.sub_seed(self.seed, 3)))[:self.traffic["check_items"]]
            chosen = [items[j] for j in pick.tolist()]
            block = self.traffic["check_block"]
            w = {k: float(v) for k, v in cfg["energy_weight"].items()}
            for lo in range(0, len(chosen), block):
                part = chosen[lo:lo + block]
                pts, jit, palm_beta, base, final, last, has_last, orot, otr, msk, intr = \
                    ([] for _ in range(11))
                for c, s, f in part:
                    rec, fr = records[c], self.frames[records[c]["set"]]
                    p = fr["hand_points"][s, f]
                    pts.append(p)
                    if f == 0:
                        jit.append(fr["jittered_hand_kp"][s, 0])
                    else:   # the port's last keypoints, re-centred on this cloud
                        prev = fr["hand_points"][s, f - 1]
                        jit.append(rec["pred_kp"][s, f - 1] - prev.mean(0) + p.mean(0))
                    palm_beta.append(rec["beta"][s].reshape(10))
                    base.append(rec["baseline_kp"][s, f])
                    final.append(rec["pred_kp"][s, f])
                    last.append(rec["baseline_kp"][s, 0] if f == 0 else jit[-1])
                    has_last.append(float(f > 0))
                    orot.append(fr["gt_obj_pose"]["rotation"][s, f])
                    otr.append(fr["gt_obj_pose"]["translation"][s, f, :, 0])
                    msk.append(self.masks[rec["set"]][s, f])
                    intr.append(fr["projection"][s, f, :4])
                beta = torch.stack(palm_beta)
                palm = palm_of(beta)[1]
                ret = handnet(torch.stack(pts), torch.stack(jit), palm)
                base_prog = torch.stack(base)
                gaps["kp_net_mm"].append(
                    1e3 * torch.linalg.norm(ret["pred_kp"] - base_prog, dim=-1).amax(-1))
                # the stage after: from the port's HandTrackNet keypoints
                vis = ref_net.knn_point(4, base_prog, torch.stack(pts))[0].mean(-1)
                discount = torch.zeros(21, device=dev)
                discount[:2] = 0.01
                vis = (vis - discount) < 0.02
                ik = iknet(base_prog, palm)
                kp, _, _, _ = ref_pose.optimise(
                    rig, model, self.pose_bank, self.zones, beta[:, None],
                    ik["global_pose"].rotation[:, None], ik["global_pose"].translation[:, None],
                    ik["MANO_theta"][:, None], base_prog[:, None], vis[:, None],
                    torch.stack(last)[:, None], torch.tensor(has_last, device=dev),
                    torch.stack(orot), torch.stack(otr), torch.stack(msk), torch.stack(intr), w)
                gaps["kp_mm"].append(
                    1e3 * torch.linalg.norm(kp[:, 0] - torch.stack(final), dim=-1).amax(-1))
        return {k: torch.cat(v).double().cpu() for k, v in gaps.items()}
