"""The port's sharded trackers against the JAX package's
(`track_hand_sequences_sharded`, `track_obj_sequences_sharded`) on two
virtual CPU devices, with the same weights, bank and inputs: four
sequences, two shares, on the port's side devices ["cpu", "cpu"].

Held as tests/test_torch_batched_track.py holds the batched trackers across
packages (tests/test_end_to_end.py holds the JAX sharded trackers against
its batched ones the same way): HandTrackNet's keypoints on frame 0 to 5e-3
m (the network's own output to 1e-4 m), every frame finite and within the
tracker's accuracy on this rig (RUN_KP_BOUND_M); the object's rotation
entries on frame 0 to 1e-4 and translations to 1e-5 m, every frame within
the closed-loop bound.

Sizes: a tiny HandTrackNet (48-d) alone (no IKNet: the JAX sharded scan
compiles in seconds), 64 points, 3 frames; the object on the volume route,
a 41^3 box, 64 particles, 2 frames.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.track.hand import track_hand_sequences_sharded as jax_hand_sharded
from hotrack_tpu.track.obj import track_obj_sequences_sharded as jax_obj_sharded
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.track import track_hand_sequences_sharded, track_obj_sequences_sharded
from hotrack_tpu_torch.train import run_hand_track
from hotrack_tpu_torch.utils.convert import handtracknet_state_dict_from_flax

S, T, NUM_POINTS, DEVICES = 4, 3, 64, ["cpu", "cpu"]
SIZE, SCALE = 41, 0.005
NET_CFG = {
    "sa1": {"npoint": 32, "radius_list": [0.1], "nsample_list": [8],
            "mlp_list": [[16, 16, 32]]},
    "sa2": {"npoint": 16, "radius_list": [0.2], "nsample_list": [8],
            "mlp_list": [[32, 32, 64]]},
    "sa3": {"mlp": [64, 64, 128]},
    "fp3": {"mlp": [64, 64]}, "fp2": {"mlp": [64, 64]}, "fp1": {"mlp": [64, 64]},
}
OUT_DIM, HEAD_SCALE = 48, 0.01
RUN_KP_BOUND_M = 0.2
OBJ_RUN_ROT, OBJ_RUN_TRANS_M = 2e-3, 1e-4


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_jax"))
    generate_simgrasp_dataset(root, num_instances=S + 1, num_frames=T, points_per_part=300)
    cfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                        "bottle_sim": {"num_parts": 1}},
           "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    seqs = SequenceData(SimGraspDataset(cfg, "train"), T)
    gen = torch.Generator().manual_seed(0)
    batches = [prepare_batch(synthetic_mano_model(), seqs[i][0], NUM_POINTS, generator=gen,
                             hand_jitter_scale=0.01) for i in range(S)]
    tbatch = run_hand_track._stack_tree(batches)
    jbatch = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tbatch)
    jhand = JaxHandTrackNet(net_cfg=_freeze(NET_CFG), backbone_out_dim=OUT_DIM)
    example = jax.tree.map(lambda a: a[0, :1], jbatch)
    hvars = jax.tree_util.tree_map(np.asarray, jax.jit(jhand.init)(
        jax.random.PRNGKey(0), example["hand_points"], example["jittered_hand_kp"],
        example["gt_hand_pose"]["palm_template"][0]))
    for leaf in ("kernel", "bias"):
        hvars["params"]["final_mlp_2"][leaf] = hvars["params"]["final_mlp_2"][leaf] * HEAD_SCALE
    thand = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    thand.load_state_dict(handtracknet_state_dict_from_flax(
        hvars["params"], hvars["batch_stats"]), strict=True)
    return dict(tbatch=tbatch, jbatch=jbatch, jhand=jhand, hvars=hvars, thand=thand)


def test_sharded_hand_tracker_matches_the_jax_sharded_tracker(rig):
    r = rig
    want = jax_hand_sharded(r["jhand"], r["hvars"], jax_mano(), r["jbatch"],
                            devices=jax.devices()[:2])
    got = track_hand_sequences_sharded(r["thand"], synthetic_mano_model(), r["tbatch"],
                                       devices=DEVICES)
    assert tuple(got.pred_kp.shape) == want.pred_kp.shape == (S, T, 21, 3)
    gap = np.abs(got.pred_kp.numpy() - np.asarray(want.pred_kp)).reshape(S, T, -1).max(-1)
    base = np.abs(got.baseline_pred_kp.numpy()[:, 0] - np.asarray(want.baseline_pred_kp)[:, 0])
    assert base.max() <= 1e-4 and gap[:, 0].max() <= 5e-3, (base.max(), gap)
    assert np.isfinite(got.pred_kp.numpy()).all() and gap.max() <= RUN_KP_BOUND_M, gap


def test_sharded_object_tracker_matches_the_jax_sharded_tracker(rig):
    b = rig["tbatch"]
    points = b["obj_points"][:, :2]
    init_r = b["gt_obj_pose"]["rotation"][:, 0]
    init_t = b["gt_obj_pose"]["translation"][:, 0] + 0.01
    box = synthetic_box_sdf_setup(SIZE, SCALE)
    vols = torch.stack([box - 0.001 * i for i in range(S)])
    bank = np.random.RandomState(7).randn(64, 6).astype(np.float32)
    bank[0] = 0.0
    want = jax_obj_sharded(jnp.asarray(vols.numpy()), jnp.asarray(bank),
                           jnp.asarray(points.numpy()), jnp.asarray(init_r.numpy()),
                           jnp.asarray(init_t.numpy()), devices=jax.devices()[:2],
                           voxel_scale=SCALE, bbox_res=SIZE)
    got = track_obj_sequences_sharded(vols, torch.from_numpy(bank), points, init_r, init_t,
                                      devices=DEVICES, voxel_scale=SCALE, bbox_res=SIZE)
    rot = np.abs(got.rotation.numpy() - np.asarray(want.rotation)).reshape(S, 2, -1).max(-1)
    trans = np.abs(got.translation.numpy()
                   - np.asarray(want.translation)).reshape(S, 2, -1).max(-1)
    assert rot[:, 0].max() <= 1e-4 and trans[:, 0].max() <= 1e-5, (rot, trans)
    assert rot.max() <= OBJ_RUN_ROT and trans.max() <= OBJ_RUN_TRANS_M, (rot, trans)
