"""The port's sharded trackers (`track_hand_sequences_sharded`,
`track_obj_sequences_sharded`): S sequences split into equal contiguous
shares over a device list, each share through the batched tracker on its
device in a thread of its own, the results concatenated in sequence order.

On the CPU with devices ["cpu", "cpu"] (a device may repeat, as two shares
on one card do), four sequences in two shares: bitwise the batched tracker
run on each share's sequences (the same program), and against the batched
tracker on all four, where the library's products run over more rows
(float32 rounding), which the optimisers' near-ties and the closed loop
carry on. Held as tests/test_torch_batched_track.py holds the batched
trackers against the unbatched ones: on frame 0 the network's keypoints to
1e-5 m, the optimised ones finite and bounded (the shape optimiser may take
another step at a near-tie: 78 mm on one sequence of a 5-frame variant of
this rig, with betas 0.013 apart); object rotation entries 1e-4 and
translations 1e-5 m on frame 0, every frame finite and within the
closed-loop bound. Then
`per_seq_kwargs` against a stub (test_round2_fixes.py's check of the JAX
function), the split's refusal of S % D != 0, and the kernels' launch counts
under threads. The JAX sharded trackers are held in
test_torch_sharded_track_jax.py.

Sizes: a tiny HandTrackNet (48-d), IKNet at width 64, 64 points, 4 frames,
48-particle pose and 64-particle shape banks, 41^3 volumes with 21-32-32-1
fits, 48 x 64 masks; 128 object particles.
"""

import os
import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet, IKNet
from hotrack_tpu_torch.ops import kernels
from hotrack_tpu_torch.opt.hand_pose import load_contact_zones
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.track import (hand as hand_mod, track_hand_sequences_batched,
                                     track_hand_sequences_sharded,
                                     track_obj_sequences_batched, track_obj_sequences_sharded)
from hotrack_tpu_torch.train import run_hand_track

S, T, NUM_POINTS, DEVICES = 4, 4, 64, ["cpu", "cpu"]
SIZE, SCALE = 41, 0.005
SMALL_FIT = dict(steps=60, batch=512, hidden=32, depth=2, pool_batches=4)
NET_CFG = {
    "sa1": {"npoint": 32, "radius_list": [0.1], "nsample_list": [8],
            "mlp_list": [[16, 16, 32]]},
    "sa2": {"npoint": 16, "radius_list": [0.2], "nsample_list": [8],
            "mlp_list": [[32, 32, 64]]},
    "sa3": {"mlp": [64, 64, 128]},
    "fp3": {"mlp": [64, 64]}, "fp2": {"mlp": [64, 64]}, "fp1": {"mlp": [64, 64]},
}
OUT_DIM, IK_WIDTH, HEAD_SCALE, HW = 48, 64, 0.01, (48, 64)
OBJ_RUN_ROT, OBJ_RUN_TRANS_M = 2e-3, 1e-4
WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
           "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank(seed, p, d):
    bank = np.random.RandomState(seed).randn(p, d).astype(np.float32)
    bank[0] = 0.0
    return torch.from_numpy(bank)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """Four sequences (prepared batches, stacked), seeded nets, a volume, a
    fit and masks a sequence."""
    root = str(tmp_path_factory.mktemp("sharded"))
    generate_simgrasp_dataset(root, num_instances=S + 1, num_frames=T, points_per_part=300)
    cfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                        "bottle_sim": {"num_parts": 1}},
           "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    seqs = SequenceData(SimGraspDataset(cfg, "train"), T)
    mano = synthetic_mano_model()
    gen = torch.Generator().manual_seed(0)
    batches = [prepare_batch(mano, seqs[i][0], NUM_POINTS, generator=gen,
                             hand_jitter_scale=0.01) for i in range(S)]
    torch.manual_seed(0)
    hand = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    with torch.no_grad():
        hand.final_mlp[2].weight.mul_(HEAD_SCALE)
        hand.final_mlp[2].bias.mul_(HEAD_SCALE)
    ik = IKNet(width=IK_WIDTH).eval()
    box = synthetic_box_sdf_setup(SIZE, SCALE)
    vols = torch.stack([box - 0.001 * i for i in range(S)])
    models = [distill_sdf_volume(vols[i], SCALE, torch.Generator().manual_seed(20 + i),
                                 **SMALL_FIT) for i in range(S)]
    masks = torch.from_numpy(np.random.RandomState(5).rand(S, T, *HW) > 0.5)
    return dict(mano=mano, batch=run_hand_track._stack_tree(batches), hand=hand, ik=ik,
                vols=vols, models=models, masks=masks)


def _hand_kwargs(r):
    return dict(iknet=r["ik"], use_opt=True, shape_mode=1, shape_particles=_bank(1, 64, 10),
                pose_particles=_bank(2, 48, 16), zones=load_contact_zones(None),
                energy_weight=WEIGHTS, sdf_voxel_scale=SCALE, hand_energy="skin",
                distilled=r["models"])


def _per_share(run, n_dev=len(DEVICES)):
    """The batched tracker on each share's sequences, concatenated."""
    outs = [run(slice(i * S // n_dev, (i + 1) * S // n_dev)) for i in range(n_dev)]
    return type(outs[0])(*(torch.cat([getattr(o, f) for o in outs]) for f in outs[0]._fields))


def test_sharded_hand_tracker_matches_the_batched_one(rig):
    """Skin route, shape mode 1, IKNet and the pose optimiser with a volume,
    a fit and masks a sequence."""
    r = rig
    per_seq = {"sdf_volumes": r["vols"], "background_masks": r["masks"]}
    kw = _hand_kwargs(r)
    got = track_hand_sequences_sharded(r["hand"], r["mano"], r["batch"], devices=DEVICES,
                                       per_seq_kwargs=per_seq, **kw)
    shares = _per_share(lambda sl: track_hand_sequences_batched(
        r["hand"], r["mano"], {k: (v[sl] if torch.is_tensor(v) else
                                   {kk: vv[sl] for kk, vv in v.items()})
                               for k, v in r["batch"].items()},
        **{k: v[sl] for k, v in per_seq.items()}, **{**kw, "distilled": kw["distilled"][sl]}))
    want = track_hand_sequences_batched(r["hand"], r["mano"], r["batch"], **per_seq, **kw)
    for name in want._fields:
        a = getattr(got, name)
        assert a.shape == getattr(want, name).shape and a.device.type == "cpu", name
        assert bool(torch.isfinite(a).all()), name
        # each share is the batched loop on its sequences: the same program
        assert torch.equal(a, getattr(shares, name)), name
    # against all four in one loop: the network's frame 0 to 1e-5 m; after it
    # the shape and pose optimisers may take another step of their search at a
    # near-tie (the products over S = 4 round otherwise), so the keypoints are
    # held finite and bounded, as tests/test_end_to_end.py holds JAX's
    np.testing.assert_allclose(got.baseline_pred_kp[:, 0].numpy(),
                               want.baseline_pred_kp[:, 0].numpy(), atol=1e-5, rtol=0)
    assert float(got.pred_kp.abs().max()) < 100.0
    # the shares kept their sequences' order: four sequences, four answers
    assert min(float((got.pred_kp[0] - got.pred_kp[i]).abs().max()) for i in range(1, S)) > 1e-3


def test_sharded_object_tracker_matches_the_batched_one(rig):
    """The fused route (its plain version on the CPU), a fit a sequence."""
    r = rig
    b = r["batch"]
    points = b["obj_points"]
    init_r = b["gt_obj_pose"]["rotation"][:, 0]
    init_t = b["gt_obj_pose"]["translation"][:, 0] + 0.01
    bank = _bank(7, 128, 6)
    kw = dict(voxel_scale=SCALE, bbox_res=SIZE, distilled=r["models"], obj_energy="fused")
    got = track_obj_sequences_sharded(None, bank, points, init_r, init_t, devices=DEVICES, **kw)
    want = track_obj_sequences_batched(None, bank, points, init_r, init_t, **kw)
    assert tuple(got.rotation.shape) == (S, T, 3, 3) and tuple(got.sdf_energy.shape) == (S, T)
    rot = (got.rotation - want.rotation).abs().reshape(S, T, -1).max(-1).values
    trans = (got.translation - want.translation).abs().reshape(S, T, -1).max(-1).values
    assert float(rot[:, 0].max()) <= 1e-4 and float(trans[:, 0].max()) <= 1e-5, (rot, trans)
    assert float(rot.max()) <= OBJ_RUN_ROT and float(trans.max()) <= OBJ_RUN_TRANS_M
    assert all(bool(torch.isfinite(t).all()) for t in got)
    shares = _per_share(lambda sl: track_obj_sequences_batched(
        None, bank, points[sl], init_r[sl], init_t[sl],
        **{**kw, "distilled": r["models"][sl]}))
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(shares, name)), name
    # the volume route with the volumes split by share
    got_v = track_obj_sequences_sharded(r["vols"], bank, points, init_r, init_t,
                                        devices=DEVICES, voxel_scale=SCALE, bbox_res=SIZE)
    want_v = track_obj_sequences_batched(r["vols"], bank, points, init_r, init_t,
                                         voxel_scale=SCALE, bbox_res=SIZE)
    np.testing.assert_allclose(got_v.rotation[:, 0].numpy(), want_v.rotation[:, 0].numpy(),
                               atol=1e-4, rtol=0)


class _Echo(NamedTuple):
    echo: torch.Tensor


def test_sharded_per_seq_kwargs(monkeypatch):
    """per_seq_kwargs arrive sliced by share, plain kwargs whole, a
    per-sequence `distilled` list sliced; the shares come back in order."""
    calls = []

    def stub(handnet, mano_model, frames, **kw):
        calls.append(sorted(kw))
        assert kw["seq_offset"].shape == (2, 3)
        assert kw["shared_const"].shape == (S, 3)
        assert len(kw["distilled"]) == 2
        assert int(kw["distilled"][0][0]) in (0, 2)
        return _Echo(frames["x"] + kw["seq_offset"])

    monkeypatch.setattr(hand_mod, "track_hand_sequences_batched", stub)
    x = torch.arange(S * 3, dtype=torch.float32).reshape(S, 3)
    offsets = torch.arange(S * 3, dtype=torch.float32).reshape(S, 3) * 10
    out = track_hand_sequences_sharded(
        None, None, {"x": x}, devices=DEVICES, per_seq_kwargs={"seq_offset": offsets},
        shared_const=torch.ones(S, 3), distilled=[torch.tensor([i]) for i in range(S)])
    np.testing.assert_allclose(out.echo.numpy(), (x + offsets).numpy())
    assert calls == [["distilled", "seq_offset", "shared_const"]] * 2


def test_sharded_trackers_refuse_an_uneven_split(rig):
    r = rig
    with pytest.raises(ValueError, match="do not split"):
        track_hand_sequences_sharded(r["hand"], r["mano"], r["batch"],
                                     devices=["cpu", "cpu", "cpu"])
    with pytest.raises(ValueError, match="do not split"):
        track_obj_sequences_sharded(r["vols"], _bank(7, 16, 6), r["batch"]["obj_points"],
                                    r["batch"]["gt_obj_pose"]["rotation"][:, 0],
                                    r["batch"]["gt_obj_pose"]["translation"][:, 0],
                                    devices=["cpu"] * 3, voxel_scale=SCALE, bbox_res=SIZE)


def test_launch_counts_stay_exact_under_threads():
    """The kernels' wrappers count under a lock: the sharded trackers'
    threads launch concurrently."""
    kernels.reset_launch_counts()
    threads = [threading.Thread(target=lambda: [kernels._count("fps") for _ in range(20000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.launch_counts["fps"] == 8 * 20000
    kernels.reset_launch_counts()
