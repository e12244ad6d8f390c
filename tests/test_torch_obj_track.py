"""Port parity for the object tracking slice as a whole: prepare_batch with
object jitter, track_obj_sequence and eval_obj_sequence of hotrack_tpu_torch
against hotrack_tpu on a generated SimGrasp sequence, with the same particle
bank, the same distilled weights (carried across by utils/convert.py) and the
same jitter draws; then the `track: obj_opt` route of the test entry on the
CPU end to end, its pickle, its config keys, and the command line in a
subprocess, which must import neither JAX nor the JAX package.

Sizes: a 41^3 volume at 5 mm, a 21-32-32-1 fit, 128 particles, 64 points,
5 frames. Tolerances: every frame starts from the last pose, so the
per-frame agreement of the optimiser (test_torch_obj_opt: 2e-5 on rotation
entries, 2e-6 m) may grow along the sequence; over 5 frames rotation 1e-4,
translation 1e-5 m, the per-frame rotation error 0.02 degrees (arccos of a
float32 dot product near 1) and translation error 1e-5 m, the accuracies
exact.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.track.eval import eval_obj_sequence as jax_eval
from hotrack_tpu.track.obj import track_obj_sequence as jax_track
from hotrack_tpu.track.types import ObjTrackResult as JaxObjTrackResult
from hotrack_tpu.train import run_obj_track as jax_runner
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.sdf import distill
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.track import ObjTrackResult, eval_obj_sequence, track_obj_sequence
from hotrack_tpu_torch.train import cli, run_obj_track
from hotrack_tpu_torch.utils.convert import distilled_to_numpy
from torch_sdf_models import jax_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SCALE = 41, 0.005
T, NUM_POINTS, P = 5, 64, 128
OBJ_JITTER = {"rotation": float(np.deg2rad(5.0)), "translation": 0.03, "scale": 0.0}
SMALL_FIT = dict(steps=200, batch=512, hidden=32, depth=2, pool_batches=16)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obj_track"))
    generate_simgrasp_dataset(root, num_instances=2, num_frames=T, points_per_part=300)
    return root


@pytest.fixture(scope="module")
def batches(dataset):
    """prepare_batch of both packages on the same raw frames, FPS sampling,
    the JAX package's own jitter draws injected into the port."""
    cfg = {"data_cfg": {"basepath": os.path.join(dataset, "SimGrasp"),
                        "bottle_sim": {"num_parts": 1}},
           "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    raw, metas = SequenceData(SimGraspDataset(cfg, "test"), T)[0]
    key = jax.random.PRNGKey(0)
    jbatch = jax_prepare_batch(jax_mano(), jax.tree.map(jnp.asarray, raw), key, NUM_POINTS,
                               obj_jitter=OBJ_JITTER, obj_jitter_kind="normal")
    # the draws, as hotrack_tpu/data/pipeline.py splits its key
    _, k_obj = jax.random.split(key)
    k1, k2, k3, k4 = jax.random.split(k_obj, 4)
    ka, kb = jax.random.split(k1)

    def t(a):
        return torch.from_numpy(np.array(a))

    tbatch = prepare_batch(
        synthetic_mano_model(), raw, NUM_POINTS, obj_jitter=OBJ_JITTER,
        obj_jitter_kind="normal",
        obj_draws={"theta": t(jax.random.normal(ka, (T,))),
                   "quat": t(jax.random.normal(kb, (T, 4))),
                   "scale": t(jax.random.normal(k2, (T,))),
                   "norm": t(jax.random.normal(k3, (T,))),
                   "direction": t(jax.random.normal(k4, (T, 3)))})
    return jbatch, tbatch, metas


@pytest.fixture(scope="module")
def assets():
    """The volume, a small distilled fit in both packages, the bank."""
    vol = synthetic_box_sdf_setup(SIZE, SCALE)
    tmodel = distill.distill_sdf_volume(vol, SCALE, torch.Generator().manual_seed(0),
                                        **SMALL_FIT)
    bank = np.random.RandomState(7).randn(P, 6).astype(np.float32)
    bank[0] = 0.0
    return vol, tmodel, jax_model(distilled_to_numpy(tmodel)), bank


def test_prepared_object_batch_matches_jax(batches):
    jbatch, tbatch, _ = batches
    np.testing.assert_array_equal(tbatch["obj_points"].numpy(), np.asarray(jbatch["obj_points"]))
    assert tuple(tbatch["obj_points"].shape) == (T, NUM_POINTS, 3)
    for name in ("gt_obj_pose", "jittered_obj_pose"):
        for k in ("rotation", "translation"):
            np.testing.assert_allclose(tbatch[name][k].numpy(), np.asarray(jbatch[name][k]),
                                       atol=1e-6, rtol=0, err_msg=f"{name}/{k}")
    moved = tbatch["jittered_obj_pose"]["translation"] - tbatch["gt_obj_pose"]["translation"]
    assert 1e-3 < float(moved.abs().max()) < 0.1


@pytest.mark.parametrize("route", ["volume", "fused", "composed"])
def test_track_and_eval_match_jax(batches, assets, route):
    """The JAX package tracks on its volume route and, with the distilled
    fit, on its composed route (what it runs on the CPU); the port's fused
    and composed routes are both held against the latter."""
    jbatch, tbatch, _ = batches
    vol, tmodel, jmodel, bank = assets
    distilled = route != "volume"
    jres = jax_track(jnp.asarray(vol.numpy()), jnp.asarray(bank), jbatch["obj_points"],
                     jbatch["jittered_obj_pose"]["rotation"][0],
                     jbatch["jittered_obj_pose"]["translation"][0], voxel_scale=SCALE,
                     bbox_res=SIZE, distilled=jmodel if distilled else None)
    tres = track_obj_sequence(vol, torch.from_numpy(bank), tbatch["obj_points"],
                              tbatch["jittered_obj_pose"]["rotation"][0],
                              tbatch["jittered_obj_pose"]["translation"][0], voxel_scale=SCALE,
                              bbox_res=SIZE, distilled=tmodel if distilled else None,
                              obj_energy="composed" if route == "composed" else "fused")
    assert isinstance(tres, ObjTrackResult) and ObjTrackResult._fields == JaxObjTrackResult._fields
    assert tuple(tres.rotation.shape) == (T, 3, 3) and tuple(tres.translation.shape) == (T, 3, 1)
    assert tuple(tres.sdf_energy.shape) == (T,)
    np.testing.assert_allclose(tres.rotation.numpy(), np.asarray(jres.rotation), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tres.translation.numpy(), np.asarray(jres.translation),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tres.sdf_energy.numpy(), np.asarray(jres.sdf_energy),
                               rtol=1e-3, atol=1e-8)

    gt = tbatch["gt_obj_pose"]
    tm = eval_obj_sequence(tres, gt["rotation"], gt["translation"], 1)
    jm = jax_eval(jres, jbatch["gt_obj_pose"]["rotation"], jbatch["gt_obj_pose"]["translation"], 1)
    assert set(tm) == set(jm) == {
        "mean/tdiff_0", "mean/rdiff_0", "mean/5deg5cm_0", "mean/10deg10cm_0",
        "tdiff_0", "rdiff_0", "5deg5cm_0", "10deg10cm_0"}
    for k in jm:
        tol = {"rdiff": 0.02, "tdiff": 1e-5}.get(k.split("/")[-1][:5], 0.0)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=tol, rtol=0, err_msg=k)
    # the tracker pulls the jittered pose in
    init_t = float(torch.linalg.norm(tbatch["jittered_obj_pose"]["translation"][0]
                                     - gt["translation"][0]))
    assert float(tm["mean/tdiff_0"]) < 0.5 * init_t
    # the symmetric evaluations run too and agree
    for axis, up_down in ((3, True), (-1, False)):
        tm = eval_obj_sequence(tres, gt["rotation"], gt["translation"], axis, up_down)
        jm = jax_eval(jres, jbatch["gt_obj_pose"]["rotation"],
                      jbatch["gt_obj_pose"]["translation"], axis, up_and_down_sym=up_down)
        np.testing.assert_allclose(tm["rdiff_0"].numpy(), np.asarray(jm["rdiff_0"]), atol=0.02)


# ----------------------------------------------------------------------------
# the entry point

@pytest.fixture
def small_runner(dataset, monkeypatch):
    """`track: obj_opt` at a size the CPU tests can afford: the runner's
    volume, particle count and distillation budget shrunk; nothing else."""
    monkeypatch.setenv("HOTRACK_DATA_ROOT", dataset)
    monkeypatch.setattr(run_obj_track, "VOLUME_SIZE", SIZE)
    monkeypatch.setattr(run_obj_track, "VOXEL_SCALE", SCALE)
    monkeypatch.setattr(run_obj_track, "NUM_PARTICLES", P)
    monkeypatch.setattr(run_obj_track, "distill_sdf_volume",
                        functools.partial(distill.distill_sdf_volume, **SMALL_FIT))
    return ["--config", "objopt_test_SimGrasp_synth.yml", "--device", "cpu",
            "--num_points", str(NUM_POINTS)]


def test_test_main_tracks_objects_on_the_cpu_and_saves_the_pickle(small_runner, dataset):
    avg, stats = cli.test_main([*small_runner, "--save"])
    seq = stats["sequences"][0]
    assert seq["sdf_query"] == "volume" and seq["distilled"] is None  # the CPU's default
    assert stats["n_frames"] == T and stats["fps_network"] >= stats["fps_all"] > 0
    assert seq["rotation"].shape == (T, 3, 3) and seq["translation"].shape == (T, 3, 1)
    assert set(avg) == {"mean/tdiff_0", "mean/rdiff_0", "mean/5deg5cm_0", "mean/10deg10cm_0"}
    assert all(np.isfinite(v) for v in avg.values())
    init_t = np.linalg.norm(seq["init_translation"] - seq["gt_translation"][0])
    assert seq["tdiff"].mean() < 0.5 * init_t and avg["mean/5deg5cm_0"] == 1.0

    cfg = cli.load_config(small_runner)
    files = os.listdir(cfg["save_dir"])
    assert len(files) == 1 and files[0].startswith("bottle_sim_") and files[0].endswith(".pkl")
    with open(os.path.join(cfg["save_dir"], files[0]), "rb") as f:
        saved = pickle.load(f)
    # the JAX package's writer on the same results gives the same pickle
    raw, metas = SequenceData(SimGraspDataset(cfg, "test"), T)[0]
    jres = JaxObjTrackResult(jnp.asarray(seq["rotation"]), jnp.asarray(seq["translation"]),
                             jnp.asarray(seq["sdf_energy"]))
    jbatch = {"gt_obj_pose": {"rotation": jnp.asarray(seq["gt_rotation"]),
                              "translation": jnp.asarray(seq["gt_translation"])}}
    jcfg = dict(cfg, save_dir=os.path.join(dataset, "jax_saved"))
    jax_runner._save_sequence(jcfg, metas, jres, jbatch,
                              {"rdiff_0": seq["rdiff"], "tdiff_0": seq["tdiff"]})
    with open(os.path.join(jcfg["save_dir"], files[0]), "rb") as f:
        want = pickle.load(f)
    assert set(saved) == set(want) == {"pred_obj_poses", "gt_obj_poses", "file_name",
                                      "r_error_0", "t_error_0", "CAD_ID"}
    assert saved["file_name"] == want["file_name"] and saved["CAD_ID"] == want["CAD_ID"]
    assert len(saved["pred_obj_poses"]) == T
    for key in ("pred_obj_poses", "gt_obj_poses"):
        for got, ref in zip(saved[key], want[key]):
            assert set(got) == {"rotation", "translation"}
            for k in got:
                assert isinstance(got[k], np.ndarray) and got[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(got[k], ref[k])
    for k in ("r_error_0", "t_error_0"):
        np.testing.assert_array_equal(saved[k], want[k])


@pytest.mark.parametrize("energy", ["fused", "composed"])
def test_test_main_distilled_routes_on_the_cpu(small_runner, energy):
    avg, stats = cli.test_main([*small_runner, "--sdf_query", "distilled", "--obj_energy",
                                energy])
    seq = stats["sequences"][0]
    assert seq["sdf_query"] == "distilled" and seq["obj_energy"] == energy
    assert seq["distill_seconds"] > 0 and seq["distilled"].weights[0].shape == (21, 32)
    assert avg["mean/10deg10cm_0"] == 1.0 and np.isfinite(seq["sdf_energy"]).all()
    # a rerun with the fit carried over tracks the same poses bitwise
    again = run_obj_track.run_obj_tracking(
        cli.load_config([*small_runner, "--sdf_query", "distilled", "--obj_energy", energy]),
        distilled=[seq["distilled"]])[1]["sequences"][0]
    np.testing.assert_array_equal(again["rotation"], seq["rotation"])
    np.testing.assert_array_equal(again["translation"], seq["translation"])


def test_config_keys_are_checked_and_shape_update_names_its_slice(small_runner):
    # the synthetic set has no DeepSDF decoder: with updateobjshape the
    # sequence tracks without refinement, as in the JAX runner
    avg, stats = cli.test_main([*small_runner, "--opt/updateobjshape", "True"])
    seq = stats["sequences"][0]
    assert seq["sdf_query"] == "volume" and "latent" not in seq
    assert set(avg) == {"mean/tdiff_0", "mean/rdiff_0", "mean/5deg5cm_0", "mean/10deg10cm_0"}
    with pytest.raises(ValueError, match="sdf_query"):
        cli.test_main([*small_runner, "--sdf_query", "nearest"])
    with pytest.raises(ValueError, match="obj_energy"):
        cli.test_main([*small_runner, "--obj_energy", "xla"])


def test_default_device_is_the_card_and_raises_without_one(small_runner):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [a for a in small_runner if a not in ("--device", "cpu")]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        cli.test_main(argv)


_CLI_CHECK = r"""
import runpy, sys
from hotrack_tpu_torch.train import run_obj_track
run_obj_track.VOLUME_SIZE, run_obj_track.VOXEL_SCALE, run_obj_track.NUM_PARTICLES = 41, 0.005, 64
sys.argv = ["hotrack_tpu_torch.test", *sys.argv[1:]]
runpy.run_module("hotrack_tpu_torch.test", run_name="__main__")
import hotrack_tpu_torch.opt.obj_pose, hotrack_tpu_torch.sdf.decoder, hotrack_tpu_torch.sdf.assets
import hotrack_tpu_torch.ops.obj_energy, hotrack_tpu_torch.ops.sdf_mlp
import hotrack_tpu_torch.pose.part_dof
import hotrack_tpu_torch.sdf.mesh, hotrack_tpu_torch.opt.shape_update, hotrack_tpu_torch.pose.bbox
import hotrack_tpu_torch.pose.pose_fit, hotrack_tpu_torch.models.losses
import hotrack_tpu_torch.nn.point_transformer
bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu")
             or m.startswith(("jax.", "jaxlib", "flax", "optax", "hotrack_tpu.")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_object_command_line_runs_without_jax(dataset, tmp_path):
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, HOTRACK_DATA_ROOT=dataset, PYTHONPATH=path)
    out = subprocess.run(
        [sys.executable, "-c", _CLI_CHECK, "--config", "objopt_test_SimGrasp_synth.yml",
         "--device", "cpu", "--num_points", "64", "--save_dir", "objopt_cli"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout and "sdf_query volume" in out.stdout
