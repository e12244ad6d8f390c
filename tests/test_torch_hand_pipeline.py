"""Port parity for the full hand pipeline as a whole: HandTrackNet with its
visibility output, the frame-0 (and periodic) MANO shape optimiser, IKNet
and the per-frame pose optimiser through `track_hand_sequence`, against the
JAX package's `lax.scan` on the CPU; then the `track: hand_IKNet` route of
the test entry and its trajectory pickle.

Both packages get the same 12 synthetic frames (so that shape modes 2 and 3
re-optimise once, on frame 10), the same keypoint noise, the JAX nets'
weights carried over by utils/convert.py (the random delta head scaled by
0.01, or the closed loop amplifies float32 rounding frame by frame), the same
particle banks (64 shape and 48 pose particles, as numpy arrays), a 41^3 box
volume with a carried 21-32-32-1 fit, and seeded 64 x 80 masks. The JAX side
runs its CPU routes (XLA distilled SDF, mask gather); the port its default
`skin` route on the plain versions.

Tolerances. With the annotated shape (mode 0) nothing but rounding parts
the runs: HandTrackNet's keypoints agree to 1e-5 m a frame and the loop
feeds them back, so baseline keypoints are held at 2e-4 m over the 12
frames, the final keypoints at 1e-4 m on frame 0 and 3e-3 m after. With a
shape mode on, the shape optimiser stands between: its 20 iterations with 64
particles end where one or two candidates beat particle 0, some within
rounding of it, so two correct runs part by a step of the search
(test_torch_hand_opt.py; here 8e-4 in beta in mode 2 and 0.86 in mode 3, from
keypoints 1e-3 m apart). So the final beta is held exactly, against the
port's own optimiser on the bone lengths the JAX scan's rule selects from
the port's keypoints (the optimiser itself is held against the JAX one in
test_torch_hand_opt.py), and the keypoints against the JAX scan at 1e-2 m,
the tracker's accuracy on this rig.
"""

import os
import pickle
import subprocess
import sys

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
from hotrack_tpu.track.hand import track_hand_sequence as jax_track
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet, IKNet
from hotrack_tpu_torch.opt.hand_pose import load_contact_zones
from hotrack_tpu_torch.opt.hand_shape import kp2length, optimize_hand_shape
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.track import hand as track_hand
from hotrack_tpu_torch.track import track_hand_sequence
from hotrack_tpu_torch.train import cli
from hotrack_tpu_torch.utils.convert import (distilled_to_numpy,
                                             handtracknet_state_dict_from_flax,
                                             iknet_state_dict_from_flax)
from test_torch_track_hand import NET_CFG, OUT_DIM
from torch_sdf_models import jax_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_POINTS, T, JITTER = 64, 12, 0.01
IK_WIDTH = 64
SIZE, SCALE = 41, 0.003
HW = (64, 80)
WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
           "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0}
HEAD_SCALE = 0.01
TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48"]


def _bank(seed, p, d):
    bank = np.random.RandomState(seed).randn(p, d).astype(np.float32)
    bank[0] = 0.0
    return bank


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """Frames, nets, banks and SDF for both packages."""
    root = str(tmp_path_factory.mktemp("simgrasp"))
    generate_simgrasp_dataset(root, num_instances=2, num_frames=T, points_per_part=300)
    cfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                        "bottle_sim": {"num_parts": 1}},
           "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    raw, _ = SequenceData(SimGraspDataset(cfg, "test"), T)[0]
    key = jax.random.PRNGKey(3)
    jbatch = jax_prepare_batch(jax_mano(), jax.tree.map(jnp.asarray, raw), key, NUM_POINTS,
                               hand_jitter_scale=JITTER)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (T, 21, 3)))
    tbatch = prepare_batch(synthetic_mano_model(), raw, NUM_POINTS, hand_jitter_scale=JITTER,
                           kp_noise=torch.tensor(noise))

    jhand = JaxHandTrackNet(net_cfg=_freeze(NET_CFG), backbone_out_dim=OUT_DIM)
    example = jax.tree.map(lambda a: a[:1], jbatch)
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

    vol = synthetic_box_sdf_setup(SIZE, SCALE)
    tmodel = distill_sdf_volume(vol, SCALE, torch.Generator().manual_seed(0), steps=300,
                                batch=1024, hidden=32, depth=2, pool_batches=16)
    masks = np.stack([mask_of(HW, 10 + i) for i in range(T)])
    return dict(jbatch=jbatch, tbatch=tbatch, jhand=jhand, hvars=hvars, thand=thand, jik=jik,
                ivars=ivars, tik=tik, vol=vol, tmodel=tmodel,
                jmodel=jax_model(distilled_to_numpy(tmodel)), masks=masks,
                shape_bank=_bank(1, 64, 10), pose_bank=_bank(2, 48, 16))


def test_visibility_mask_matches_jax(rig):
    """compute_visibility: the same booleans, at a cloud cut to the half
    nearer the camera so that both values occur."""
    pts = rig["tbatch"]["hand_points"][:4]
    kp = rig["tbatch"]["jittered_hand_kp"][:4]
    palm = rig["tbatch"]["gt_hand_pose"]["palm_template"][0]
    order = torch.argsort(pts[..., 2], dim=1)[:, :NUM_POINTS // 2]
    near = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3)).repeat(1, 2, 1)
    for cloud in (pts, near):
        got = rig["thand"](cloud, kp, palm, compute_visibility=True)
        want = rig["jhand"].apply(rig["hvars"], jnp.asarray(cloud.numpy()),
                                  jnp.asarray(kp.numpy()), jnp.asarray(palm.numpy()),
                                  compute_visibility=True, train=False)
        vis = got["pred_kp_vis_mask"]
        assert vis.dtype == torch.bool and tuple(vis.shape) == (4, 21)
        np.testing.assert_array_equal(vis.numpy(), np.asarray(want["pred_kp_vis_mask"]))
        assert "pred_kp_vis_mask" not in rig["thand"](cloud, kp, palm)
    assert 0 < int(vis.sum()) < vis.numel()


def _run_both(rig, shape_mode, use_opt):
    opt = dict(use_opt=use_opt, shape_mode=shape_mode, energy_weight=WEIGHTS,
               sdf_voxel_scale=SCALE)
    jres = jax_track(
        rig["jhand"], rig["hvars"], jax_mano(), rig["jbatch"], iknet=rig["jik"],
        ik_variables=rig["ivars"], shape_particles=jnp.asarray(rig["shape_bank"]),
        pose_particles=jnp.asarray(rig["pose_bank"]), zones=jax_load_contact_zones(None),
        sdf_volume=jnp.asarray(rig["vol"].numpy()), background_masks=jnp.asarray(rig["masks"]),
        distilled=rig["jmodel"], **opt)
    tres = track_hand_sequence(
        rig["thand"], synthetic_mano_model(), rig["tbatch"], iknet=rig["tik"],
        shape_particles=torch.from_numpy(rig["shape_bank"]),
        pose_particles=torch.from_numpy(rig["pose_bank"]), zones=load_contact_zones(None),
        sdf_volume=rig["vol"], background_masks=torch.from_numpy(rig["masks"]),
        distilled=rig["tmodel"], **opt)
    return jres, tres


@pytest.mark.parametrize("shape_mode,use_opt", [(0, False), (1, True), (2, False), (3, True),
                                                (0, True)])
def test_tracked_sequence_matches_the_jax_scan(rig, shape_mode, use_opt):
    jres, tres = _run_both(rig, shape_mode, use_opt)
    for name in tres._fields:
        assert tuple(getattr(tres, name).shape) == getattr(jres, name).shape, name
        assert bool(torch.isfinite(getattr(tres, name)).all()), name
    assert tuple(tres.pred_kp.shape) == (T, 21, 3) and tuple(tres.mano_theta.shape) == (T, 45)
    assert tuple(tres.global_translation.shape) == (T, 3, 1)
    assert tuple(tres.pred_beta.shape) == (1, 10)

    def gap(name, frames=slice(None)):
        return float(np.abs(getattr(tres, name).numpy()[frames]
                            - np.asarray(getattr(jres, name))[frames]).max())

    if shape_mode == 0:
        # the annotated shape on both sides: nothing but rounding parts the runs
        np.testing.assert_array_equal(tres.pred_beta.numpy(),
                                      rig["tbatch"]["gt_hand_pose"]["mano_beta"][:1].numpy())
        assert gap("baseline_pred_kp") <= 2e-4
        assert gap("pred_kp", slice(0, 1)) <= 1e-4
        assert gap("pred_kp") <= 3e-3
    else:
        # the shape the port ends with is the shape optimiser's answer to the
        # bone lengths the JAX scan would feed it from the port's own
        # keypoints: frame 0 before the template changes; frame 10 alone; or
        # the ring buffer of frames 0..10 padded with the newest row
        tm = synthetic_mano_model()
        if shape_mode == 1:
            palm0 = track_hand._rest_palm_template(tm, torch.zeros(1, 10))
            ret0 = rig["thand"](rig["tbatch"]["hand_points"][:1],
                                rig["tbatch"]["jittered_hand_kp"][:1], palm0)
            lengths = kp2length(ret0["pred_kp"])
        elif shape_mode == 2:
            lengths = kp2length(tres.baseline_pred_kp[10:11])
        else:
            rows = kp2length(tres.baseline_pred_kp[:11])
            lengths = torch.cat([rows, rows[-1:].expand(64 - 11, -1)])
        want_beta, _ = optimize_hand_shape(tm, torch.from_numpy(rig["shape_bank"]), lengths)
        np.testing.assert_allclose(tres.pred_beta.numpy(), want_beta.numpy(), atol=1e-6, rtol=0)
        assert gap("baseline_pred_kp") <= 1e-2
        assert gap("pred_kp") <= 1e-2
    assert gap("canon_rotation") <= 2e-2
    if shape_mode in (2, 3):
        # the re-optimisation on frame 10 did change the shape
        again = track_hand_sequence(
            rig["thand"], synthetic_mano_model(), rig["tbatch"], iknet=rig["tik"],
            shape_mode=1, shape_particles=torch.from_numpy(rig["shape_bank"]))
        assert not torch.equal(again.pred_beta, tres.pred_beta)
    if not use_opt:
        # IKNet's pose through MANO: the keypoints are a hand of the tracked shape
        assert float((tres.pred_kp - tres.baseline_pred_kp).abs().max()) > 1e-3


def test_tracker_checks_what_its_options_need(rig):
    base = dict(iknet=rig["tik"])
    with pytest.raises(ValueError, match="shape_particles"):
        track_hand_sequence(rig["thand"], synthetic_mano_model(), rig["tbatch"], shape_mode=1,
                            **base)
    with pytest.raises(ValueError, match="pose_particles"):
        track_hand_sequence(rig["thand"], synthetic_mano_model(), rig["tbatch"], use_opt=True,
                            **base)
    with pytest.raises(ValueError, match="shape_mode"):
        track_hand_sequence(rig["thand"], synthetic_mano_model(), rig["tbatch"], shape_mode=4)


# ---------------------------------------------------------------- the entry

CLI_PARTICLES = 192   # the runner's 5120-particle banks, at a size the CPU tests can afford


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    from hotrack_tpu_torch.train import run_hand_track
    root = str(tmp_path_factory.mktemp("handopt"))
    generate_simgrasp_dataset(root, num_instances=2, num_frames=3, points_per_part=200)
    old_root, old_bank = os.environ.get("HOTRACK_DATA_ROOT"), run_hand_track.NUM_PARTICLES
    os.environ["HOTRACK_DATA_ROOT"] = root
    run_hand_track.NUM_PARTICLES = CLI_PARTICLES
    yield ["--config", "handopt_test_SimGrasp_synth.yml", "--device", "cpu", *TINY], root
    run_hand_track.NUM_PARTICLES = old_bank
    if old_root is None:
        os.environ.pop("HOTRACK_DATA_ROOT", None)
    else:
        os.environ["HOTRACK_DATA_ROOT"] = old_root


def test_cli_tracks_hand_iknet_and_saves_the_pickle(runner, capsys):
    argv, root = runner
    avg, stats = cli.test_main([*argv, "--save"])
    out = capsys.readouterr().out
    assert out.count("using random init") == 2          # HandTrackNet and IKNet
    assert "sdf_query volume  hand_energy skin" in out  # the CPU's default route
    seq = stats["sequences"][0]
    assert seq["pred_kp"].shape == (3, 21, 3) and seq["mano_theta"].shape == (3, 45)
    assert seq["pred_beta"].shape == (1, 10) and np.abs(seq["pred_beta"]).max() > 0
    assert seq["distilled"] is None and stats["pose_particles"].shape == (CLI_PARTICLES, 16)
    assert stats["shape_particles"].shape == (CLI_PARTICLES, 10)
    assert all(np.isfinite(v) for v in avg.values())
    assert set(avg) == {"hand_pred_kp_diff", "hand_baseline_kp_diff", "hand_pred_r_diff",
                        "hand_pred_t_diff"}
    results = os.path.join(root, "exps", "handopt_synth_track", "results")
    (name,) = os.listdir(results)
    with open(os.path.join(results, name), "rb") as f:
        saved = pickle.load(f)
    assert set(saved) == {"gt_hand_kp", "pred_hand_kp", "file_name", "kp_error", "r_error",
                          "t_error", "pred_hand_poses", "baseline_pred_kp"}
    poses = saved["pred_hand_poses"]
    assert poses["mano_pose"].shape == (3, 48) and poses["mano_trans"].shape == (3, 3)
    assert poses["mano_beta"].shape == (1, 10) and len(saved["baseline_pred_kp"]) == 3
    np.testing.assert_array_equal(saved["pred_hand_kp"][1], seq["pred_kp"][1])


@pytest.mark.parametrize("extra,route", [
    (["--sdf_query", "distilled", "--hand_energy", "fused"], "distilled  hand_energy fused"),
    (["--use_optimization", "0", "--use_pred_hand_shape", "0"], None)])
def test_cli_routes(runner, capsys, monkeypatch, extra, route):
    """The distilled route on the CPU (a short fit, patched in), and IKNet
    alone with the annotated shape."""
    from hotrack_tpu_torch.train import run_hand_track
    real = run_hand_track.distill_sdf_volume
    monkeypatch.setattr(run_hand_track, "distill_sdf_volume",
                        lambda vol, scale, gen: real(vol, scale, gen, steps=30, batch=512,
                                                     hidden=32, depth=2, pool_batches=4))
    avg, stats = cli.test_main([*runner[0], *extra])
    out = capsys.readouterr().out
    seq = stats["sequences"][0]
    assert all(np.isfinite(v) for v in avg.values())
    if route:
        assert route in out and seq["distilled"] is not None
        again = run_hand_track.run_hand_tracking(cli.load_config([*runner[0], *extra]),
                                                 distilled=[seq["distilled"]])[1]
        np.testing.assert_array_equal(again["sequences"][0]["pred_kp"], seq["pred_kp"])
    else:
        assert "pose_particles" not in stats and "shape_particles" not in stats
        assert np.abs(seq["mano_theta"]).max() > 0


def test_cli_refuses_what_is_not_ported_and_checks_its_keys(runner):
    argv = runner[0]
    # several sequences through one loop are ported: the one test sequence
    # is a chunk of one (tests/test_torch_batched_track.py holds the chunks)
    avg, stats = cli.test_main([*argv, "--eval_batch_seqs", "2"])
    assert stats["n_frames"] == 3 and stats["sequences"][0]["pred_kp"].shape == (3, 21, 3)
    assert all(np.isfinite(v) for v in avg.values())
    # --debug_save is ported too: a figure a tracked frame (tests/test_torch_vis.py)
    cli.test_main([*argv, "--debug_save"])
    cfg = cli.load_config(argv)
    assert len(os.listdir(os.path.join(cfg["experiment_dir"], "debug"))) == 3
    with pytest.raises(ValueError, match="hand_energy"):
        cli.test_main([*argv, "--hand_energy", "xla"])
    with pytest.raises(ValueError, match="sdf_query"):
        cli.test_main([*argv, "--sdf_query", "nearest"])
    with pytest.raises(ValueError, match="track"):
        cli.test_main([*argv, "--track", "hand_obj"])


def test_cli_needs_a_card_unless_the_cpu_is_asked_for(runner):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [a for a in runner[0] if a not in ("--device", "cpu")]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        cli.test_main(argv)


_NO_JAX = r"""
import sys
from hotrack_tpu_torch.train import run_hand_track
from hotrack_tpu_torch.train.cli import test_main
run_hand_track.NUM_PARTICLES = 192
avg, stats = test_main(sys.argv[1:])
batched = test_main([*sys.argv[1:], "--eval_batch_seqs", "2"])[1]
assert batched["n_frames"] == stats["n_frames"]
bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu", "cv2")
             or m.startswith(("jax.", "jaxlib", "flax", "optax", "hotrack_tpu.")))
assert not bad, bad
print("NO_JAX_OK", stats["n_frames"])
"""


def test_cli_runs_the_slice_without_jax_or_opencv(runner):
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, HOTRACK_DATA_ROOT=runner[1], PYTHONPATH=path)
    out = subprocess.run([sys.executable, "-c", _NO_JAX, *runner[0]], cwd=runner[1], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK 3" in out.stdout
