"""Port parity for multi-sequence tracking: `track_obj_sequences_batched`
and `track_hand_sequences_batched` against the port's own unbatched trackers
run on each sequence, and against the JAX package's
`track_obj_sequences_batched` and `jax.vmap(track_hand_sequence)` (the JAX
runner's `_run_batched`) with the same weights, banks and inputs; then
`eval_batch_seqs` through the test entry, with masks of two sizes.

Two sequences a chunk, each with its own volume, distilled fit, masks, object
pose and shape, on the CPU (the batched plain versions). Sizes: 41^3 volumes,
21-32-32-1 fits, 48 to 128 particles, 64 points, 4 object frames and 11 hand
frames (shape modes 2 and 3 re-optimise on frame 10).

Tolerances. Batched against unbatched in the port: the batched kernels'
plain versions loop over the sequences, so what differs is the library's
products over S x P rows in place of P (float32 rounding, 1e-7), which the
closed loop carries from frame to frame: the object poses are held as the
unbatched tracker is held against JAX (rotation entries 1e-4, translations
1e-5 m, energies rtol 1e-3; measured 2e-5 on the rotations), the hand's
frame-0 baseline keypoints to 1e-5 m; the shape optimiser ends where candidates sit within
rounding of particle 0 (test_torch_hand_pipeline.py), so beta is held against
the unbatched optimiser on the batched run's own bone lengths, and the final
keypoints at 1e-2 m, the tracker's accuracy. Against the JAX package, as the
unbatched tests hold the unbatched trackers: object rotations 1e-4,
translations 1e-5 m; hand keypoints on frame 0 to 5e-3 m (the JAX package's
own batched-vs-single bound, tests/test_end_to_end.py), every frame to
1e-2 m.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import mask_of
from hotrack_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.models import IKNet as JaxIKNet
from hotrack_tpu.opt.hand_pose import load_contact_zones as jax_load_contact_zones
from hotrack_tpu.track.hand import track_hand_sequence as jax_track_hand
from hotrack_tpu.track.obj import track_obj_sequences_batched as jax_track_obj_batched
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset, split_dataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet, IKNet
from hotrack_tpu_torch.opt.hand_pose import load_contact_zones, optimize_hand_pose
from hotrack_tpu_torch.opt.hand_shape import kp2length, optimize_hand_shape
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.track import (track_hand_sequence, track_hand_sequences_batched,
                                     track_obj_sequence, track_obj_sequences_batched)
from hotrack_tpu_torch.train import cli, run_hand_track
from hotrack_tpu_torch.utils.convert import (distilled_to_numpy,
                                             handtracknet_state_dict_from_flax,
                                             iknet_state_dict_from_flax)
from test_torch_track_hand import NET_CFG, OUT_DIM
from torch_sdf_models import jax_model

S, NUM_POINTS = 2, 64
SIZE, SCALE = 41, 0.005
SMALL_FIT = dict(steps=60, batch=512, hidden=32, depth=2, pool_batches=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Thousands of operations on small tensors: one intra-op thread runs them
    faster than a pool, and does not contend with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank(seed, p, d):
    bank = np.random.RandomState(seed).randn(p, d).astype(np.float32)
    bank[0] = 0.0
    return bank


def _sequences(root, frames, instances=S + 1):
    """The training split of a generated set: `instances - 1` sequences of
    `frames` frames, raw."""
    generate_simgrasp_dataset(root, num_instances=instances, num_frames=frames,
                              points_per_part=300)
    cfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                        "bottle_sim": {"num_parts": 1}},
           "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    seqs = SequenceData(SimGraspDataset(cfg, "train"), frames)
    return [seqs[i][0] for i in range(len(seqs))]


def _distill(volume, seed):
    return distill_sdf_volume(volume, SCALE, torch.Generator().manual_seed(seed), **SMALL_FIT)


# ------------------------------------------------------------------ object

OBJ_T, OBJ_P = 4, 128
# the closed loop across packages: a rotation entry and a translation
OBJ_RUN_ROT, OBJ_RUN_TRANS_M = 2e-3, 1e-4


@pytest.fixture(scope="module")
def obj_rig(tmp_path_factory):
    """Two sequences, each with its own volume (the box, and the box grown
    by 4 mm) and its own fit; starts 3 degrees and 1 cm off the truth."""
    raws = _sequences(str(tmp_path_factory.mktemp("obj_batched")), OBJ_T)
    mano = synthetic_mano_model()
    batches = [prepare_batch(mano, raw, NUM_POINTS) for raw in raws]
    box = synthetic_box_sdf_setup(SIZE, SCALE)
    vols = torch.stack([box, box - 0.004])
    models = [_distill(vols[i], 10 + i) for i in range(S)]
    c, s = np.cos(np.deg2rad(3.0)), np.sin(np.deg2rad(3.0))
    turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    init_r = torch.stack([b["gt_obj_pose"]["rotation"][0] @ turn for b in batches])
    init_t = torch.stack([b["gt_obj_pose"]["translation"][0] + 0.01 for b in batches])
    return dict(points=torch.stack([b["obj_points"] for b in batches]), vols=vols,
                models=models, init_r=init_r, init_t=init_t, bank=_bank(7, OBJ_P, 6))


def _obj_kwargs(route, models):
    if route == "volume":
        return {}
    return dict(distilled=models, obj_energy="composed" if route == "composed" else "fused")


@pytest.mark.parametrize("route", ["volume", "fused", "composed"])
def test_batched_object_tracker_matches_the_unbatched_one(obj_rig, route):
    r = obj_rig
    bank = torch.from_numpy(r["bank"])
    got = track_obj_sequences_batched(r["vols"], bank, r["points"], r["init_r"], r["init_t"],
                                      voxel_scale=SCALE, bbox_res=SIZE,
                                      **_obj_kwargs(route, r["models"]))
    assert tuple(got.rotation.shape) == (S, OBJ_T, 3, 3)
    assert tuple(got.translation.shape) == (S, OBJ_T, 3, 1)
    assert tuple(got.sdf_energy.shape) == (S, OBJ_T)
    for i in range(S):
        kw = _obj_kwargs(route, r["models"])
        if "distilled" in kw:
            kw["distilled"] = kw["distilled"][i]
        one = track_obj_sequence(r["vols"][i], bank, r["points"][i], r["init_r"][i],
                                 r["init_t"][i], voxel_scale=SCALE, bbox_res=SIZE, **kw)
        np.testing.assert_allclose(got.rotation[i].numpy(), one.rotation.numpy(), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(got.translation[i].numpy(), one.translation.numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.sdf_energy[i].numpy(), one.sdf_energy.numpy(),
                                   rtol=1e-3, atol=1e-8)
    # each sequence tracked its own object: the two runs differ
    assert float((got.translation[0] - got.translation[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("route", ["volume", "composed"])
def test_batched_object_tracker_matches_the_jax_batched_tracker(obj_rig, route):
    """The JAX package's CPU routes (the trilinear volume; with the fits, the
    composed XLA route); the port's fused route is held against its composed
    one above and in test_torch_obj_track.py."""
    r = obj_rig
    distilled = route != "volume"
    jmodels = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[jax_model(distilled_to_numpy(m)) for m in r["models"]])
    want = jax_track_obj_batched(jnp.asarray(r["vols"].numpy()), jnp.asarray(r["bank"]),
                                 jnp.asarray(r["points"].numpy()),
                                 jnp.asarray(r["init_r"].numpy()),
                                 jnp.asarray(r["init_t"].numpy()), voxel_scale=SCALE,
                                 bbox_res=SIZE, distilled=jmodels if distilled else None)
    got = track_obj_sequences_batched(r["vols"], torch.from_numpy(r["bank"]), r["points"],
                                      r["init_r"], r["init_t"], voxel_scale=SCALE,
                                      bbox_res=SIZE, **_obj_kwargs(route, r["models"]))
    rot = np.abs(got.rotation.numpy() - np.asarray(want.rotation)).reshape(S, OBJ_T, -1).max(-1)
    trans = np.abs(got.translation.numpy()
                   - np.asarray(want.translation)).reshape(S, OBJ_T, -1).max(-1)
    # frame 0 from the same start as tightly as the unbatched tracker; the
    # closed loop after it to the tracker's accuracy
    assert rot[:, 0].max() <= 1e-4 and trans[:, 0].max() <= 1e-5, (rot, trans)
    assert rot.max() <= OBJ_RUN_ROT and trans.max() <= OBJ_RUN_TRANS_M, (rot, trans)
    np.testing.assert_allclose(got.sdf_energy.numpy()[:, 0], np.asarray(want.sdf_energy)[:, 0],
                               rtol=1e-3, atol=1e-8)


def test_batched_object_tracker_refuses_a_model_count_that_is_not_s(obj_rig):
    r = obj_rig
    with pytest.raises(ValueError, match="models for"):
        track_obj_sequences_batched(None, torch.from_numpy(r["bank"]), r["points"], r["init_r"],
                                    r["init_t"], distilled=r["models"][:1])


# -------------------------------------------------------------------- hand

HAND_T, JITTER, IK_WIDTH, HEAD_SCALE, HW = 11, 0.01, 64, 0.01, (48, 64)
# the final keypoints of two correct optimiser runs from the same start: a
# step of the search where a candidate is within rounding of particle 0
HAND_KP_BOUND_M = 2e-3
# after the first frame each run starts from its own last keypoints, and the
# random nets and the optimiser's near-ties amplify a step's difference frame
# by frame: the closed loop is held to the tracker's accuracy on this rig
# (random weights: 0.15 m from the ground truth)
RUN_KP_BOUND_M = 0.2
WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
           "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0}


@pytest.fixture(scope="module")
def hand_rig(tmp_path_factory):
    """Two sequences in both packages: the same raw frames and keypoint
    noise, the JAX nets' weights carried over (the delta head scaled), the
    same banks, a volume, fit and 48 x 64 masks a sequence."""
    raws = _sequences(str(tmp_path_factory.mktemp("hand_batched")), HAND_T)
    jbatches, tbatches = [], []
    for i, raw in enumerate(raws):
        key = jax.random.PRNGKey(3 + i)
        jbatches.append(jax_prepare_batch(jax_mano(), jax.tree.map(jnp.asarray, raw), key,
                                          NUM_POINTS, hand_jitter_scale=JITTER))
        noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (HAND_T, 21, 3)))
        tbatches.append(prepare_batch(synthetic_mano_model(), raw, NUM_POINTS,
                                      hand_jitter_scale=JITTER, kp_noise=torch.tensor(noise)))
    jhand = JaxHandTrackNet(net_cfg=_freeze(NET_CFG), backbone_out_dim=OUT_DIM)
    example = jax.tree.map(lambda a: a[:1], jbatches[0])
    palm = example["gt_hand_pose"]["palm_template"][0]
    hvars = jax.tree_util.tree_map(np.asarray, jhand.init(
        jax.random.PRNGKey(0), example["hand_points"], example["jittered_hand_kp"], palm))
    for leaf in ("kernel", "bias"):
        hvars["params"]["final_mlp_2"][leaf] = hvars["params"]["final_mlp_2"][leaf] * HEAD_SCALE
    thand = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    thand.load_state_dict(handtracknet_state_dict_from_flax(
        hvars["params"], hvars["batch_stats"]), strict=True)
    jik = JaxIKNet(width=IK_WIDTH)
    ivars = jax.tree_util.tree_map(np.asarray, jik.init(
        jax.random.PRNGKey(1), example["jittered_hand_kp"], palm))
    tik = IKNet(width=IK_WIDTH).eval()
    tik.load_state_dict(iknet_state_dict_from_flax(ivars["params"], ivars["batch_stats"]),
                        strict=True)
    box = synthetic_box_sdf_setup(SIZE, SCALE)
    vols = torch.stack([box, box - 0.003])
    models = [_distill(vols[i], 20 + i) for i in range(S)]
    masks = np.stack([np.stack([mask_of(HW, 100 * i + t) for t in range(HAND_T)])
                      for i in range(S)])
    return dict(jbatch=jax.tree.map(lambda *xs: jnp.stack(xs), *jbatches),
                tbatches=tbatches, tbatch=run_hand_track._stack_tree(tbatches), jhand=jhand,
                hvars=hvars, thand=thand, jik=jik, ivars=ivars, tik=tik, vols=vols, models=models,
                jmodels=jax.tree.map(lambda *xs: jnp.stack(xs),
                                     *[jax_model(distilled_to_numpy(m)) for m in models]),
                masks=masks, shape_bank=_bank(1, 64, 10), pose_bank=_bank(2, 48, 16))


def _port_kwargs(r, shape_mode, use_opt, iknet=True):
    return dict(iknet=r["tik"] if iknet else None, use_opt=use_opt, shape_mode=shape_mode,
                shape_particles=torch.from_numpy(r["shape_bank"]),
                pose_particles=torch.from_numpy(r["pose_bank"]),
                zones=load_contact_zones(None), energy_weight=WEIGHTS, sdf_voxel_scale=SCALE)


@pytest.mark.parametrize("shape_mode,use_opt,iknet", [
    (0, False, False), (1, True, True), (2, False, True), (3, True, True)])
def test_batched_hand_tracker_matches_the_unbatched_one(hand_rig, shape_mode, use_opt, iknet):
    r = hand_rig
    mano = synthetic_mano_model()
    kw = _port_kwargs(r, shape_mode, use_opt, iknet)
    got = track_hand_sequences_batched(r["thand"], mano, r["tbatch"], sdf_volumes=r["vols"],
                                       background_masks=torch.from_numpy(r["masks"]),
                                       distilled=r["models"], **kw)
    assert tuple(got.pred_kp.shape) == (S, HAND_T, 21, 3)
    assert tuple(got.global_translation.shape) == (S, HAND_T, 3, 1)
    assert tuple(got.pred_beta.shape) == (S, 1, 10)
    for i in range(S):
        one = track_hand_sequence(r["thand"], mano, r["tbatches"][i], sdf_volume=r["vols"][i],
                                  background_masks=torch.from_numpy(r["masks"][i]),
                                  distilled=r["models"][i], **kw)
        for name in one._fields:
            assert tuple(getattr(got, name)[i].shape) == tuple(getattr(one, name).shape), name
            assert bool(torch.isfinite(getattr(got, name)[i]).all()), name
        # frame 0's network output from the same start, its final keypoints
        # to a step of the search, the closed loop to the tracker's accuracy
        gap = (got.pred_kp[i] - one.pred_kp).abs().reshape(HAND_T, -1).max(-1).values
        np.testing.assert_allclose(got.baseline_pred_kp[i, 0].numpy(),
                                   one.baseline_pred_kp[0].numpy(), atol=1e-5, rtol=0)
        assert float(gap[0]) <= HAND_KP_BOUND_M and float(gap.max()) <= RUN_KP_BOUND_M, gap
        if not use_opt and shape_mode < 2:   # no optimiser step in the loop
            assert float(gap.max()) <= 1e-4, gap
        if shape_mode:
            # beta: the unbatched optimiser's answer to the batched run's lengths
            if shape_mode == 1:
                palm0 = torch.zeros(1, 10)
                from hotrack_tpu_torch.track.hand import _rest_palm_template
                ret0 = r["thand"](r["tbatches"][i]["hand_points"][:1],
                                  r["tbatches"][i]["jittered_hand_kp"][:1],
                                  _rest_palm_template(mano, palm0))
                lengths = kp2length(ret0["pred_kp"])
            elif shape_mode == 2:
                lengths = kp2length(got.baseline_pred_kp[i, 10:11])
            else:
                rows = kp2length(got.baseline_pred_kp[i, :11])
                lengths = torch.cat([rows, rows[-1:].expand(64 - 11, -1)])
            want, _ = optimize_hand_shape(mano, torch.from_numpy(r["shape_bank"]), lengths)
            np.testing.assert_allclose(got.pred_beta[i].numpy(), want.numpy(), atol=1e-5,
                                       rtol=0)
    if use_opt:  # two sequences, two answers
        assert float((got.pred_kp[0] - got.pred_kp[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("shape_mode,use_opt", [(0, False), (1, True)])
def test_batched_hand_tracker_matches_the_jax_vmap(hand_rig, shape_mode, use_opt):
    r = hand_rig
    opt = dict(use_opt=use_opt, shape_mode=shape_mode, energy_weight=WEIGHTS,
               sdf_voxel_scale=SCALE)
    want = jax.vmap(lambda b, vol, masks, dist: jax_track_hand(
        r["jhand"], r["hvars"], jax_mano(), b, iknet=r["jik"], ik_variables=r["ivars"],
        shape_particles=jnp.asarray(r["shape_bank"]), pose_particles=jnp.asarray(r["pose_bank"]),
        zones=jax_load_contact_zones(None), sdf_volume=vol, background_masks=masks,
        distilled=dist, **opt))(r["jbatch"], jnp.asarray(r["vols"].numpy()),
                                jnp.asarray(r["masks"]), r["jmodels"])
    got = track_hand_sequences_batched(
        r["thand"], synthetic_mano_model(), r["tbatch"], sdf_volumes=r["vols"],
        background_masks=torch.from_numpy(r["masks"]), distilled=r["models"],
        **_port_kwargs(r, shape_mode, use_opt))
    for name in got._fields:
        assert tuple(getattr(got, name).shape) == getattr(want, name).shape, name
    gap = np.abs(got.pred_kp.numpy() - np.asarray(want.pred_kp)).reshape(S, HAND_T, -1).max(-1)
    assert gap[:, 0].max() <= 5e-3 and gap.max() <= RUN_KP_BOUND_M, gap
    base = np.abs(got.baseline_pred_kp.numpy() - np.asarray(want.baseline_pred_kp))
    assert base[:, 0].max() <= 1e-4, base[:, 0].max()


def _pose_inputs(r, i=None):
    """Frame 0's inputs of the pose optimiser for all sequences (i None) or
    for sequence i alone, with a seeded shape and start."""
    b = r["tbatch"]
    g = torch.Generator().manual_seed(0)
    theta, shape = torch.randn(S, 45, generator=g) * 0.1, torch.randn(S, 10, generator=g) * 0.3
    vis = torch.ones(S, 21, dtype=torch.bool)
    vis[:, 18:] = False
    kp, proj = b["gt_hand_kp"][:, 0], b["projection"][:, 0]
    per_seq = dict(hand_shape=shape, init_rotation=b["gt_hand_pose"]["rotation"][:, 0],
                   init_translation=b["gt_hand_pose"]["translation"][:, 0], init_theta=theta,
                   pred_kp=kp, vis_mask=vis, last_frame_kp=kp)
    whole = dict(obj_rotation=b["gt_obj_pose"]["rotation"][:, 0],
                 obj_translation=b["gt_obj_pose"]["translation"][:, 0][..., 0],
                 background_mask=torch.from_numpy(r["masks"][:, 0]))
    intr = {k: proj[:, j] for j, k in enumerate(("fx", "fy", "cx", "cy"))}
    if i is None:
        return dict({k: v[:, None] for k, v in per_seq.items()}, **whole, intrinsics=intr)
    return dict({k: v[i:i + 1] for k, v in per_seq.items()},
                **{k: v[i] for k, v in whole.items()},
                intrinsics={k: v[i] for k, v in intr.items()})


@pytest.mark.parametrize("route", ["skin", "fused", "separate", "volume"])
def test_batched_pose_optimiser_matches_the_unbatched_one_open_loop(hand_rig, route):
    """One call from the same start: every iteration's energies to the
    rounding of a 778-vertex sum (measured 4e-7), the same success flags,
    the final keypoints to a step of the search (measured 5e-8)."""
    r = hand_rig
    mano, bank, zones = synthetic_mano_model(), torch.from_numpy(r["pose_bank"]), \
        load_contact_zones(None)
    common = dict(energy_weight=WEIGHTS, voxel_scale=SCALE, has_last=0.0,
                  hand_energy="skin" if route == "volume" else route)
    models = None if route == "volume" else r["models"]
    trace = []
    got = optimize_hand_pose(mano, bank, zones, r["vols"], **_pose_inputs(r), distilled=models,
                             trace=trace, **common)
    assert tuple(got[0].shape) == (S, 1, 21, 3) and tuple(got[2].shape) == (S, 1, 3, 3)
    assert tuple(got[4].shape) == (S,)
    for i in range(S):
        one_trace = []
        one = optimize_hand_pose(mano, bank, zones, r["vols"][i], **_pose_inputs(r, i),
                                 distilled=None if models is None else models[i],
                                 trace=one_trace, **common)
        for (e, ok, _), (e1, ok1, _) in zip(trace, one_trace):
            assert float((e[i] - e1).abs().max()) <= 2e-6 and bool(ok[i]) == bool(ok1)
        assert float((got[0][i] - one[0]).abs().max()) <= HAND_KP_BOUND_M


def test_batched_shape_optimiser_matches_the_unbatched_one(hand_rig):
    """Bone lengths a sequence (one row, or a history of rows): the first 8
    iterations, before the search ends among near-ties."""
    mano, bank = synthetic_mano_model(), torch.from_numpy(hand_rig["shape_bank"])
    lengths = kp2length(hand_rig["tbatch"]["gt_hand_kp"][:, :3])           # (S, 3, 15)
    got, energy = optimize_hand_shape(mano, bank, lengths, iterations=8)
    assert tuple(got.shape) == (S, 1, 10) and tuple(energy.shape) == (S,)
    for i in range(S):
        one, one_energy = optimize_hand_shape(mano, bank, lengths[i], iterations=8)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(energy[i]), float(one_energy), rtol=1e-5)
    assert float((got[0] - got[1]).abs().max()) > 1e-3


# ------------------------------------------------------------- the entry

CLI_T, CLI_PARTICLES = 4, 192
TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48"]
MASK_HW = {0: (40, 50), 1: (48, 64), 2: (48, 64)}


@pytest.fixture(scope="module")
def cli_set(tmp_path_factory):
    """A generated set whose test split holds three sequences of CLI_T frames
    (the split rewritten with split_dataset), the runner's banks cut to a
    size the CPU affords, and masks of two sizes (the synthetic set ships
    none: the reader is patched per test)."""
    root = str(tmp_path_factory.mktemp("batched_cli"))
    base = generate_simgrasp_dataset(root, num_instances=4, num_frames=CLI_T,
                                     points_per_part=200)
    split_dataset(os.path.join(base, "splits", "bottle_sim", "seq"),
                  os.path.join(base, "preproc", "bottle_sim", "seq"),
                  ["00000", "00001", "00002"])
    old_root, old_bank = os.environ.get("HOTRACK_DATA_ROOT"), run_hand_track.NUM_PARTICLES
    os.environ["HOTRACK_DATA_ROOT"] = root
    run_hand_track.NUM_PARTICLES = CLI_PARTICLES
    yield ["--config", "handopt_test_SimGrasp_synth.yml", "--device", "cpu",
           "--data_cfg/num_frames", str(CLI_T), *TINY]
    run_hand_track.NUM_PARTICLES = old_bank
    if old_root is None:
        os.environ.pop("HOTRACK_DATA_ROOT", None)
    else:
        os.environ["HOTRACK_DATA_ROOT"] = old_root


def _masks_of_two_sizes(cfg, metas):
    ins = int(metas[0]["file_name"].split("_")[-2])
    return np.stack([mask_of(MASK_HW[ins], 10 * ins + t) for t in range(len(metas))])


def test_eval_batch_seqs_tracks_the_same_inputs_as_one_at_a_time(cli_set, monkeypatch):
    monkeypatch.setattr(run_hand_track, "load_background_masks", _masks_of_two_sizes)
    one_avg, one = cli.test_main(cli_set)
    avg, two = cli.test_main([*cli_set, "--eval_batch_seqs", "2"])
    assert set(two) == set(one) and set(avg) == set(one_avg)
    assert two["n_frames"] == one["n_frames"] == 3 * CLI_T
    assert two["fps_network"] >= two["fps_all"] > 0
    assert all(np.isfinite(v) for v in avg.values())
    for a, b in zip(one["sequences"], two["sequences"]):
        assert set(a) == set(b)
        # the same generator draws in the same order: the same clouds and jitter
        np.testing.assert_array_equal(a["hand_idx0"], b["hand_idx0"])
        np.testing.assert_array_equal(a["obj_idx0"], b["obj_idx0"])
        assert a["pred_kp"].shape == b["pred_kp"].shape == (CLI_T, 21, 3)
        assert b["pred_beta"].shape == (1, 10) and np.isfinite(b["pred_kp"]).all()
        gap = np.abs(a["pred_kp"] - b["pred_kp"]).reshape(CLI_T, -1).max(-1)
        assert gap[0] <= 5e-3 and gap.max() <= 1e-2, gap
    np.testing.assert_array_equal(one["pose_particles"], two["pose_particles"])


def test_masks_are_padded_by_edge_replication():
    small = np.zeros((2, 3, 4), bool)
    small[:, -1, :] = True   # the last row
    small[:, :, -1] = True   # and the last column set
    big = np.zeros((2, 5, 6), bool)
    out = run_hand_track._pad_edge([small, big])
    assert out.shape == (2, 2, 5, 6)
    np.testing.assert_array_equal(out[0, :, :3, :4], small)
    assert out[0, :, 3:, :].all() and out[0, :, :, 4:].all()   # the border, repeated
    assert not out[1].any()
