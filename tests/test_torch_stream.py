"""Streaming tracking (hotrack_tpu_torch/track/stream.py), the counterparts
of tests/test_stream.py, on the CPU.

- `HandTracker` / `ObjTracker` fed one frame at a time are bitwise the
  offline trackers (`track_hand_sequence`, `track_obj_sequence`) on the same
  inputs: they run the same step (track/hand.HandStep, optimize_obj_pose).
  Held for HandTrackNet alone, for IKNet with the pose optimiser (masks, the
  distilled SDF) and for the shape modes 1-3, and for the object's volume
  and distilled routes.
- `serve` at depths 1, 2, 3 and 10 (longer than the clip), and
  `serve_combined`, are bitwise the explicit steps, in order.
- Against the JAX package's trackers on the same weights and frames (the
  hand rig below, as test_torch_hand_pipeline.py builds its own: the delta
  head scaled by 0.01; the object rig of test_torch_obj_track.py), for a few
  frames, at the bounds those files hold the offline trackers to: annotated
  shape, pose optimiser on, baseline keypoints 2e-4 m, final keypoints 1e-4
  m on frame 0 and 3e-3 m after; object rotation entries 1e-4, translation
  1e-5 m.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import mask_of
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.models import IKNet as JaxIKNet
from hotrack_tpu.opt.hand_pose import load_contact_zones as jax_load_contact_zones
from hotrack_tpu.track.stream import HandTracker as JaxHandTracker
from hotrack_tpu.track.stream import ObjTracker as JaxObjTracker
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet, IKNet
from hotrack_tpu_torch.opt.hand_pose import load_contact_zones
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.track import (HandTracker, ObjTracker, serve_combined,
                                     track_hand_sequence, track_obj_sequence)
from hotrack_tpu_torch.utils.convert import (distilled_to_numpy,
                                             handtracknet_state_dict_from_flax,
                                             iknet_state_dict_from_flax)
from test_torch_obj_track import SCALE as OBJ_SCALE
from test_torch_obj_track import SIZE as OBJ_SIZE
from test_torch_obj_track import assets, batches, dataset  # noqa: F401  (fixtures)
from test_torch_track_hand import NET_CFG, OUT_DIM
from torch_sdf_models import jax_model

T, NUM_POINTS, IK_WIDTH, HEAD_SCALE = 12, 64, 64, 0.01
SCALE = 0.003
HW = (64, 80)
WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
           "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small operations: the
    suite runs beside other processes, and threads that wait for work spin
    on the cores the others need. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _bank(seed, p, d):
    bank = np.random.RandomState(seed).randn(p, d).astype(np.float32)
    bank[0] = 0.0
    return bank


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """T synthetic frames (12: shape modes 2 and 3 re-optimise on frame 10),
    the JAX package's nets (initialised by a jitted `init`, the delta head
    scaled by HEAD_SCALE) and their weights in the port's, particle banks, a
    41^3 box volume with a 21-32-32-1 fit, seeded 64 x 80 masks."""
    root = str(tmp_path_factory.mktemp("stream"))
    generate_simgrasp_dataset(root, num_instances=2, num_frames=T, points_per_part=300)
    cfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                        "bottle_sim": {"num_parts": 1}},
           "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    raw, _ = SequenceData(SimGraspDataset(cfg, "test"), T)[0]
    tbatch = prepare_batch(synthetic_mano_model(), raw, NUM_POINTS, hand_jitter_scale=0.01,
                           generator=torch.Generator().manual_seed(3))
    kp = jnp.asarray(tbatch["jittered_hand_kp"][:1].numpy())
    palm = jnp.asarray(tbatch["gt_hand_pose"]["palm_template"][0].numpy())
    jhand = JaxHandTrackNet(net_cfg=_freeze(NET_CFG), backbone_out_dim=OUT_DIM)
    hvars = jax.tree_util.tree_map(np.asarray, jax.jit(jhand.init)(
        jax.random.PRNGKey(0), jnp.asarray(tbatch["hand_points"][:1].numpy()), kp, palm))
    for leaf in ("kernel", "bias"):
        hvars["params"]["final_mlp_2"][leaf] = hvars["params"]["final_mlp_2"][leaf] * HEAD_SCALE
    thand = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    thand.load_state_dict(handtracknet_state_dict_from_flax(
        hvars["params"], hvars["batch_stats"]), strict=True)
    jik = JaxIKNet(width=IK_WIDTH)
    ivars = jax.tree_util.tree_map(np.asarray, jax.jit(jik.init)(jax.random.PRNGKey(1), kp,
                                                                 palm))
    tik = IKNet(width=IK_WIDTH).eval()
    tik.load_state_dict(iknet_state_dict_from_flax(ivars["params"], ivars["batch_stats"]),
                        strict=True)
    vol = synthetic_box_sdf_setup(41, SCALE)
    tmodel = distill_sdf_volume(vol, SCALE, torch.Generator().manual_seed(0), steps=300,
                                batch=1024, hidden=32, depth=2, pool_batches=16)
    return dict(tbatch=tbatch, jhand=jhand, hvars=hvars, thand=thand, jik=jik, ivars=ivars,
                tik=tik, vol=vol, tmodel=tmodel, jmodel=jax_model(distilled_to_numpy(tmodel)),
                masks=np.stack([mask_of(HW, 10 + i) for i in range(T)]),
                shape_bank=_bank(1, 64, 10), pose_bank=_bank(2, 48, 16))


FIELDS = {"pred_kp": "pred_kp", "baseline_pred_kp": "baseline_pred_kp",
          "canon_rotation": "canon_rotation", "canon_translation": "canon_translation",
          "global_rotation": "global_rotation", "global_translation": "global_translation",
          "MANO_theta": "mano_theta"}


def _hand_kwargs(rig, shape_mode, use_opt):
    return dict(iknet=rig["tik"], use_opt=use_opt, shape_mode=shape_mode,
                shape_particles=torch.from_numpy(rig["shape_bank"]),
                pose_particles=torch.from_numpy(rig["pose_bank"]),
                zones=load_contact_zones(None), sdf_volume=rig["vol"],
                energy_weight=WEIGHTS, sdf_voxel_scale=SCALE, distilled=rig["tmodel"])


def _frame(rig, f, use_opt=True):
    b = rig["tbatch"]
    if not use_opt:
        return {"hand_points": b["hand_points"][f]}
    return {"hand_points": b["hand_points"][f],
            "background_mask": torch.from_numpy(rig["masks"][f]),
            "obj_rotation": b["gt_obj_pose"]["rotation"][f],
            "obj_translation": b["gt_obj_pose"]["translation"][f],
            "projection": b["projection"][f]}


def _stream(tracker, rig, frames, use_opt=True, mano_beta=None):
    b = rig["tbatch"]
    state = tracker.init_state(b["hand_points"][0], b["jittered_hand_kp"][0], mano_beta)
    outs = []
    for f in range(frames):
        state, out = tracker.step(state, **_frame(rig, f, use_opt))
        outs.append(out)
    return state, outs


def test_hand_stream_matches_offline_handtracknet_alone(rig):
    t = rig["tbatch"]["hand_points"].shape[0]
    offline = track_hand_sequence(rig["thand"], synthetic_mano_model(), rig["tbatch"])
    _, outs = _stream(HandTracker(rig["thand"], synthetic_mano_model()), rig, t, False)
    for key, field in FIELDS.items():
        np.testing.assert_array_equal(torch.stack([o[key] for o in outs]).numpy(),
                                      getattr(offline, field).numpy(), err_msg=key)


@pytest.mark.parametrize("shape_mode,use_opt", [(0, True), (1, True), (2, False), (3, True)])
def test_hand_stream_matches_offline_with_iknet(rig, shape_mode, use_opt):
    """IKNet, the shape modes and the pose optimiser (the seeded masks, the
    distilled SDF on its CPU route): every output of every frame bitwise,
    and the shape the state ends with."""
    kwargs = _hand_kwargs(rig, shape_mode, use_opt)
    b = rig["tbatch"]
    t = b["hand_points"].shape[0]
    offline = track_hand_sequence(rig["thand"], synthetic_mano_model(), b,
                                  background_masks=torch.from_numpy(rig["masks"]), **kwargs)
    beta = b["gt_hand_pose"]["mano_beta"][0] if shape_mode == 0 else None
    state, outs = _stream(HandTracker(rig["thand"], synthetic_mano_model(), **kwargs), rig, t,
                          use_opt, beta)
    for key, field in FIELDS.items():
        np.testing.assert_array_equal(torch.stack([o[key] for o in outs]).numpy(),
                                      getattr(offline, field).numpy(), err_msg=key)
    np.testing.assert_array_equal(state["shape_code"].numpy(), offline.pred_beta.numpy())
    assert state["i"] == t


@pytest.mark.parametrize("route", ["volume", "fused", "composed"])
def test_obj_stream_matches_offline(batches, assets, route):  # noqa: F811
    _, tbatch, _ = batches
    vol, tmodel, _, bank = assets
    kwargs = dict(voxel_scale=OBJ_SCALE, bbox_res=OBJ_SIZE,
                  distilled=None if route == "volume" else tmodel,
                  obj_energy="composed" if route == "composed" else "fused")
    r0 = tbatch["jittered_obj_pose"]["rotation"][0]
    t0 = tbatch["jittered_obj_pose"]["translation"][0]
    offline = track_obj_sequence(vol, torch.from_numpy(bank), tbatch["obj_points"], r0, t0,
                                 **kwargs)
    tracker = ObjTracker(vol, torch.from_numpy(bank), **kwargs)
    state = tracker.init_state(r0, t0)
    for f, pts in enumerate(tbatch["obj_points"]):
        state, out = tracker.step(state, pts)
        for key in ("rotation", "translation", "sdf_energy"):
            np.testing.assert_array_equal(out[key].numpy(), getattr(offline, key)[f].numpy())


def test_hand_serve_matches_step(rig):
    """serve: bitwise the steps, in order, one output a frame, for bare
    clouds from a lazy generator, dicts of step arguments, fetch=None, and
    depths up to longer than the clip."""
    tracker = HandTracker(rig["thand"], synthetic_mano_model())
    b = rig["tbatch"]
    t = b["hand_points"].shape[0]
    _, expect = _stream(tracker, rig, t, False)

    def fresh():
        return tracker.init_state(b["hand_points"][0], b["jittered_hand_kp"][0])

    got = list(tracker.serve(fresh(), (b["hand_points"][f] for f in range(t))))
    assert len(got) == t and all(set(g) == {"pred_kp"} for g in got)
    for g, e in zip(got, expect):
        assert isinstance(g["pred_kp"], np.ndarray)
        np.testing.assert_array_equal(g["pred_kp"], e["pred_kp"].numpy())
    full = list(tracker.serve(fresh(), [_frame(rig, f, False) for f in range(t)], fetch=None))
    assert set(full[0]) == set(FIELDS)
    for g, e in zip(full, expect):
        for key in FIELDS:
            np.testing.assert_array_equal(g[key], e[key].numpy())
    for depth in (2, 3, 10):
        got = list(tracker.serve(fresh(), (b["hand_points"][f] for f in range(t)), depth=depth))
        assert len(got) == t
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g["pred_kp"], e["pred_kp"].numpy())
    with pytest.raises(ValueError, match="depth"):
        list(tracker.serve(fresh(), [], depth=0))


def test_hand_serve_with_the_pose_optimiser_matches_step(rig):
    kwargs = _hand_kwargs(rig, 1, True)
    tracker = HandTracker(rig["thand"], synthetic_mano_model(), **kwargs)
    b = rig["tbatch"]
    _, expect = _stream(tracker, rig, 4)
    for depth in (1, 2):
        state = tracker.init_state(b["hand_points"][0], b["jittered_hand_kp"][0])
        got = list(tracker.serve(state, [_frame(rig, f) for f in range(4)],
                                 fetch=("pred_kp", "MANO_theta"), depth=depth))
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g["pred_kp"], e["pred_kp"].numpy())
            np.testing.assert_array_equal(g["MANO_theta"], e["MANO_theta"].numpy())


def test_obj_serve_matches_step(batches, assets):  # noqa: F811
    _, tbatch, _ = batches
    vol, tmodel, _, bank = assets
    tracker = ObjTracker(vol, torch.from_numpy(bank), voxel_scale=OBJ_SCALE, bbox_res=OBJ_SIZE,
                         distilled=tmodel)
    r0 = tbatch["jittered_obj_pose"]["rotation"][0]
    t0 = tbatch["jittered_obj_pose"]["translation"][0]
    pts = tbatch["obj_points"]
    state, expect = tracker.init_state(r0, t0), []
    for f in range(pts.shape[0]):
        state, out = tracker.step(state, pts[f])
        expect.append(out)
    for depth in (1, 2):
        got = list(tracker.serve(tracker.init_state(r0, t0), list(pts), depth=depth))
        assert len(got) == len(expect) and set(got[0]) == {"rotation", "translation"}
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g["rotation"], e["rotation"].numpy())
            np.testing.assert_array_equal(g["translation"], e["translation"].numpy())


@pytest.mark.parametrize("depth", [1, 2])
def test_serve_combined_matches_steps(rig, batches, assets, depth):  # noqa: F811
    _, tbatch, _ = batches
    vol, tmodel, _, bank = assets
    b = rig["tbatch"]
    t = min(4, tbatch["obj_points"].shape[0])
    hand = HandTracker(rig["thand"], synthetic_mano_model(), **_hand_kwargs(rig, 0, True))
    obj = ObjTracker(vol, torch.from_numpy(bank), voxel_scale=OBJ_SCALE, bbox_res=OBJ_SIZE,
                     distilled=tmodel)
    r0 = tbatch["jittered_obj_pose"]["rotation"][0]
    t0 = tbatch["jittered_obj_pose"]["translation"][0]
    beta = b["gt_hand_pose"]["mano_beta"][0]

    def states():
        return (hand.init_state(b["hand_points"][0], b["jittered_hand_kp"][0], beta),
                obj.init_state(r0, t0))

    h_state, o_state = states()
    expect = []
    for f in range(t):
        h_state, h_out = hand.step(h_state, **_frame(rig, f))
        o_state, o_out = obj.step(o_state, tbatch["obj_points"][f])
        expect.append({"pred_kp": h_out["pred_kp"], "obj_rotation": o_out["rotation"],
                       "obj_translation": o_out["translation"]})
    frames = ({**_frame(rig, f), "obj_points": tbatch["obj_points"][f]} for f in range(t))
    got = list(serve_combined(hand, obj, *states(), frames, depth=depth))
    assert len(got) == t and all(set(g) == set(expect[0]) for g in got)
    for g, e in zip(got, expect):
        for key in e:
            np.testing.assert_array_equal(g[key], e[key].numpy(), err_msg=key)


def test_hand_tracker_matches_the_jax_tracker(rig):
    """On the same frames (the port's prepared batch, as arrays) and weights."""
    frames = 4
    b = rig["tbatch"]
    jb = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), b)
    kwargs = _hand_kwargs(rig, 0, True)
    _, outs = _stream(HandTracker(rig["thand"], synthetic_mano_model(), **kwargs), rig, frames,
                      mano_beta=b["gt_hand_pose"]["mano_beta"][0])
    jtracker = JaxHandTracker(
        rig["jhand"], rig["hvars"], jax_mano(), iknet=rig["jik"], ik_variables=rig["ivars"],
        use_opt=True, shape_mode=0, shape_particles=jnp.asarray(rig["shape_bank"]),
        pose_particles=jnp.asarray(rig["pose_bank"]), zones=jax_load_contact_zones(None),
        sdf_volume=jnp.asarray(rig["vol"].numpy()), energy_weight=WEIGHTS,
        sdf_voxel_scale=SCALE, distilled=rig["jmodel"])
    state = jtracker.init_state(jb["hand_points"][0], jb["jittered_hand_kp"][0],
                                mano_beta=jb["gt_hand_pose"]["mano_beta"][0])
    jouts = []
    for f in range(frames):
        state, out = jtracker.step(state, jb["hand_points"][f],
                                   background_mask=jnp.asarray(rig["masks"][f]),
                                   obj_rotation=jb["gt_obj_pose"]["rotation"][f],
                                   obj_translation=jb["gt_obj_pose"]["translation"][f],
                                   projection=jb["projection"][f])
        jouts.append(out)

    def gap(key, sl=slice(None)):
        got = torch.stack([o[key] for o in outs]).numpy()[sl]
        want = np.stack([np.asarray(o[key]) for o in jouts])[sl]
        return float(np.abs(got - want).max())

    assert gap("baseline_pred_kp") <= 2e-4
    assert gap("pred_kp", slice(0, 1)) <= 1e-4
    assert gap("pred_kp") <= 3e-3


@pytest.mark.parametrize("route", ["volume", "distilled"])
def test_obj_tracker_matches_the_jax_tracker(batches, assets, route):  # noqa: F811
    jbatch, tbatch, _ = batches
    vol, tmodel, jmodel, bank = assets
    distilled = route == "distilled"
    tracker = ObjTracker(vol, torch.from_numpy(bank), voxel_scale=OBJ_SCALE, bbox_res=OBJ_SIZE,
                         distilled=tmodel if distilled else None)
    jtracker = JaxObjTracker(jnp.asarray(vol.numpy()), jnp.asarray(bank), voxel_scale=OBJ_SCALE,
                             bbox_res=OBJ_SIZE, distilled=jmodel if distilled else None)
    state = tracker.init_state(tbatch["jittered_obj_pose"]["rotation"][0],
                               tbatch["jittered_obj_pose"]["translation"][0])
    jstate = jtracker.init_state(jbatch["jittered_obj_pose"]["rotation"][0],
                                 jbatch["jittered_obj_pose"]["translation"][0])
    for f in range(tbatch["obj_points"].shape[0]):
        state, out = tracker.step(state, tbatch["obj_points"][f])
        jstate, jout = jtracker.step(jstate, jbatch["obj_points"][f])
        np.testing.assert_allclose(out["rotation"].numpy(), np.asarray(jout["rotation"]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(out["translation"].numpy(), np.asarray(jout["translation"]),
                                   atol=1e-5, rtol=0)
