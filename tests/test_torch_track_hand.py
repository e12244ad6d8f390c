"""Port parity for the tracking slice as a whole: the synthetic SimGrasp
generator, prepare_batch, track_hand_sequence and eval_hand_sequence of
hotrack_tpu_torch against hotrack_tpu, on the same weights, the same frames
and the same injected keypoint noise; the port's config loader against the
JAX package's; plus the slice's CLI in a subprocess, which must import
neither JAX nor the JAX package, and chip_smoke.py, which must refuse to run
without CUDA.

Tolerances: generated points 1e-6 m (the MANO forward's float32 rounding);
prepare_batch's FPS-gathered clouds exact and its MANO outputs 1e-6 m; the
tracked keypoints 1e-4 m on every frame of an 8-frame sequence and the mean
MPJPE 1e-5 m. The tracker feeds each prediction into the next frame, so the
1e-5 m per-frame agreement of HandTrackNet (test_torch_hand_tracknet) may
grow along the sequence; 1e-4 m is still 1/100 of the 1 cm keypoint jitter.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from hotrack_tpu.data.synthetic import generate_sequence as jax_generate_sequence
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.track.eval import eval_hand_sequence as jax_eval
from hotrack_tpu.track.hand import track_hand_sequence as jax_track
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_sequence, generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet
from hotrack_tpu_torch.track import eval_hand_sequence, track_hand_sequence
from hotrack_tpu_torch.utils.convert import handtracknet_state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_CFG = {
    "sa1": {"npoint": 32, "radius_list": [0.1], "nsample_list": [8],
            "mlp_list": [[16, 16, 32]]},
    "sa2": {"npoint": 16, "radius_list": [0.2], "nsample_list": [8],
            "mlp_list": [[32, 32, 64]]},
    "sa3": {"mlp": [64, 64, 128]},
    "fp3": {"mlp": [64, 64]},
    "fp2": {"mlp": [64, 64]},
    "fp1": {"mlp": [64, 64]},
}
OUT_DIM = 48
NUM_POINTS = 64
T = 8
JITTER = 0.01


def _cfg(root):
    return {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                         "bottle_sim": {"num_parts": 1}},
            "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """One T-frame synthetic test sequence as a stacked RawFrame."""
    root = str(tmp_path_factory.mktemp("simgrasp"))
    generate_simgrasp_dataset(root, num_instances=2, num_frames=T, points_per_part=300)
    raw, metas = SequenceData(SimGraspDataset(_cfg(root), "test"), T)[0]
    return raw, metas


@pytest.fixture(scope="module")
def batches(sequence):
    """prepare_batch of both packages on the same raw frames and noise."""
    raw, _ = sequence
    key = jax.random.PRNGKey(3)
    jbatch = jax_prepare_batch(jax_mano(), jax.tree.map(jnp.asarray, raw), key,
                               NUM_POINTS, hand_jitter_scale=JITTER)
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], (T, 21, 3)))
    tbatch = prepare_batch(synthetic_mano_model(), raw, NUM_POINTS,
                           hand_jitter_scale=JITTER, kp_noise=torch.tensor(noise))
    return jbatch, tbatch


def test_synthetic_generator_matches_jax():
    jframes = jax_generate_sequence(jax_mano(), np.random.RandomState(5), num_frames=3,
                                    points_per_part=200)
    tframes = generate_sequence(synthetic_mano_model(), np.random.RandomState(5),
                                num_frames=3, points_per_part=200)
    for jf, tf in zip(jframes, tframes):
        np.testing.assert_array_equal(tf["labels"], jf["labels"])
        np.testing.assert_allclose(tf["points"], jf["points"], atol=1e-6, rtol=0)
        for k in ("mano_pose", "mano_trans", "mano_beta"):
            np.testing.assert_array_equal(tf["hand_pose"][k], jf["hand_pose"][k])


def test_prepare_batch_matches_jax(batches):
    jbatch, tbatch = batches
    for k in ("hand_points", "obj_points", "hand_valid", "obj_valid"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    for k in ("gt_hand_kp", "jittered_hand_kp"):
        np.testing.assert_allclose(tbatch[k].numpy(), np.asarray(jbatch[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    for k in ("palm_template", "rotation", "translation"):
        np.testing.assert_allclose(tbatch["gt_hand_pose"][k].numpy(),
                                   np.asarray(jbatch["gt_hand_pose"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    # the sampled points are the raw points at the FPS indices
    assert tbatch["hand_idx"].dtype == torch.int32
    assert tuple(tbatch["hand_idx"].shape) == (T, NUM_POINTS)


def test_prepare_batch_generator_draw_is_seeded(sequence):
    raw, _ = sequence
    mano = synthetic_mano_model()

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return prepare_batch(mano, raw, NUM_POINTS, generator=gen,
                             hand_jitter_scale=JITTER)["jittered_hand_kp"]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


def test_track_and_eval_match_jax(batches):
    jbatch, tbatch = batches
    # a hashable config: the JAX tracker takes the module as a static argument
    jmodel = JaxHandTrackNet(net_cfg=_freeze(NET_CFG), backbone_out_dim=OUT_DIM)
    example = jax.tree.map(lambda a: a[:1], jbatch)
    variables = jmodel.init(jax.random.PRNGKey(0), example["hand_points"],
                            example["jittered_hand_kp"],
                            example["gt_hand_pose"]["palm_template"][0])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmodel = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    tmodel.load_state_dict(handtracknet_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)

    jres = jax_track(jmodel, variables, jax_mano(), jbatch)
    tres = track_hand_sequence(tmodel, synthetic_mano_model(), tbatch)
    assert tuple(tres.pred_kp.shape) == (T, 21, 3)
    np.testing.assert_allclose(tres.pred_kp.numpy(), np.asarray(jres.pred_kp),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tres.canon_rotation.numpy(),
                               np.asarray(jres.canon_rotation), atol=1e-4, rtol=0)

    palm = tbatch["gt_hand_pose"]["palm_template"][0]
    tm = eval_hand_sequence(tres, tbatch["gt_hand_kp"], palm)
    jm = jax_eval(jres, jbatch["gt_hand_kp"], jbatch["gt_hand_pose"]["palm_template"][0])
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["mean/hand_pred_kp_diff"]),
                               float(jm["mean/hand_pred_kp_diff"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm["hand_pred_kp_diff"].numpy(),
                               np.asarray(jm["hand_pred_kp_diff"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kwargs", [{"iknet": object(), "shape_mode": 1},
                                    {"iknet": object(), "use_opt": True},
                                    {"shape_mode": 7}])
def test_tracker_options_of_later_slices_raise(batches, kwargs):
    """IKNet, the optimisers and the shape modes are ported (held against the
    JAX scan in test_torch_hand_pipeline.py); what raises now is an option
    without what it needs (a particle bank, the zones, an SDF) and a shape
    mode neither package knows."""
    _, tbatch = batches
    model = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    with pytest.raises(ValueError, match="shape_particles|pose_particles|shape_mode"):
        track_hand_sequence(model, synthetic_mano_model(), tbatch, **kwargs)


@pytest.mark.parametrize("kwargs", [{"sample_kind": "grid"},
                                    {"sample_kind": "random", "num_points": 10**6},
                                    {"obj_jitter": {"rotation": 0.1}}])
def test_prepare_batch_options_of_later_slices_raise(sequence, kwargs):
    """The training slice ported random sampling, object jitter and the OBB
    pose (held against the JAX package below); what still raises is a value
    neither package knows: an unknown sampler, more points than the cloud
    has, a jitter config without its translation and scale."""
    raw, _ = sequence
    kwargs = dict(kwargs)
    num_points = kwargs.pop("num_points", NUM_POINTS)
    with pytest.raises((ValueError, RuntimeError, KeyError)):
        prepare_batch(synthetic_mano_model(), raw, num_points, **kwargs)


OBJ_JITTER = {"rotation": float(np.deg2rad(10.0)), "translation": 0.03, "scale": 0.05}


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_prepare_batch_random_sampling_and_object_jitter_match_jax(sequence, kind):
    """sample_kind='random' and object-pose jitter with the JAX package's own
    draws injected: the subset indices (so the gathered clouds) exact, the
    jittered pose to 1e-6, and the jitter of the size the config asks for."""
    raw, _ = sequence
    key = jax.random.PRNGKey(11)
    jbatch = jax_prepare_batch(jax_mano(), jax.tree.map(jnp.asarray, raw), key,
                               NUM_POINTS, hand_jitter_scale=JITTER, jitter_kind=kind,
                               obj_jitter=OBJ_JITTER, obj_jitter_kind=kind,
                               sample_kind="random")
    # the draws, as hotrack_tpu/data/pipeline.py splits its key
    k_kp, k_obj = jax.random.split(key)
    k_kp, k_s1, k_s2 = jax.random.split(k_kp, 3)
    k1, k2, k3, k4 = jax.random.split(k_obj, 4)
    ka, kb = jax.random.split(k1)
    unit = jax.random.uniform if kind == "uniform" else jax.random.normal
    n_raw = raw.hand_points.shape[1]

    def t(a):
        return torch.from_numpy(np.array(a))

    tbatch = prepare_batch(
        synthetic_mano_model(), raw, NUM_POINTS, hand_jitter_scale=JITTER,
        jitter_kind=kind, obj_jitter=OBJ_JITTER, obj_jitter_kind=kind,
        sample_kind="random", kp_noise=t(unit(k_kp, (T, 21, 3))),
        sample_scores=(t(jax.random.uniform(k_s1, (T, n_raw))),
                       t(jax.random.uniform(k_s2, (T, raw.obj_points.shape[1])))),
        obj_draws={"theta": t(unit(ka, (T,))), "quat": t(jax.random.normal(kb, (T, 4))),
                   "scale": t(unit(k2, (T,))), "norm": t(unit(k3, (T,))),
                   "direction": t(unit(k4, (T, 3)))})
    for k in ("hand_points", "obj_points", "hand_valid", "obj_valid"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    assert not np.array_equal(tbatch["hand_idx"].numpy(), batches_fps_idx(raw))
    np.testing.assert_allclose(tbatch["jittered_hand_kp"].numpy(),
                               np.asarray(jbatch["jittered_hand_kp"]), atol=1e-6, rtol=0)
    for k in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(tbatch["jittered_obj_pose"][k].numpy(),
                                   np.asarray(jbatch["jittered_obj_pose"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    # rotation angle, translation norm and scale change against the draws
    rel = torch.matmul(tbatch["gt_obj_pose"]["rotation"].transpose(-1, -2),
                       tbatch["jittered_obj_pose"]["rotation"])
    angle = torch.arccos(torch.clamp((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1))
    theta = np.asarray(unit(ka, (T,)))
    want_angle = np.abs(theta) * OBJ_JITTER["rotation"]
    np.testing.assert_allclose(angle.numpy(), want_angle, atol=2e-4)
    signed = (lambda a: np.asarray(a) * 2 - 1) if kind == "uniform" else np.asarray
    dt = (tbatch["jittered_obj_pose"]["translation"]
          - tbatch["gt_obj_pose"]["translation"])[..., 0]
    np.testing.assert_allclose(torch.linalg.norm(dt, dim=-1).numpy(),
                               np.abs(signed(unit(k3, (T,)))) * OBJ_JITTER["translation"],
                               atol=1e-6)
    np.testing.assert_allclose(
        (tbatch["jittered_obj_pose"]["scale"] - tbatch["gt_obj_pose"]["scale"]).numpy(),
        signed(unit(k2, (T,))) * OBJ_JITTER["scale"], atol=1e-6)


def batches_fps_idx(raw):
    return prepare_batch(synthetic_mano_model(), raw, NUM_POINTS)["hand_idx"].numpy()


def test_prepare_batch_random_sampling_from_a_generator(sequence):
    """Drawn from a generator: seeded, a fresh subset on every call, only
    valid points while enough are valid, no point twice."""
    raw, _ = sequence
    mano = synthetic_mano_model()

    def run(gen):
        return prepare_batch(mano, raw, NUM_POINTS, generator=gen, sample_kind="random",
                             obj_jitter=OBJ_JITTER)

    gen = torch.Generator().manual_seed(4)
    a, b = run(gen), run(gen)
    c = run(torch.Generator().manual_seed(4))
    assert torch.equal(a["hand_idx"], c["hand_idx"])
    assert torch.equal(a["jittered_obj_pose"]["rotation"], c["jittered_obj_pose"]["rotation"])
    assert not torch.equal(a["hand_idx"], b["hand_idx"])
    assert bool(a["hand_valid"].all())
    assert all(len(set(row.tolist())) == NUM_POINTS for row in a["hand_idx"])


def test_prepare_batch_obb_pose_matches_jax(batches, sequence):
    """include_obb: scale and translation to 1e-6; the principal axes up to
    the sign the eigen-solver gives each (1e-4: eigenvectors of a 3x3
    covariance), with a right-handed frame either way."""
    raw, _ = sequence
    jbatch = jax_prepare_batch(jax_mano(), jax.tree.map(jnp.asarray, raw),
                               jax.random.PRNGKey(3), NUM_POINTS, include_obb=True)
    tbatch = prepare_batch(synthetic_mano_model(), raw, NUM_POINTS, include_obb=True)
    got, want = tbatch["OBB_pose"], jbatch["OBB_pose"]
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), atol=1e-6)
    np.testing.assert_allclose(got["translation"].numpy(), np.asarray(want["translation"]),
                               atol=1e-6)
    r, rj = got["rotation"].numpy(), np.asarray(want["rotation"])
    for col in (0, 2):
        sign = np.sign(np.sum(r[:, :, col] * rj[:, :, col], axis=-1, keepdims=True))
        np.testing.assert_allclose(r[:, :, col], sign * rj[:, :, col], atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)
    assert "OBB_pose" not in batches[1]


_CLI_SCRIPT = r"""
import os, sys
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.ops import kernels, pointops
from hotrack_tpu_torch.train.cli import load_config, test_main
from hotrack_tpu_torch.train.run_hand_track import build_handnet
from hotrack_tpu_torch.utils.convert import save_reference_checkpoint
root = os.environ["HOTRACK_DATA_ROOT"]
generate_simgrasp_dataset(root, num_instances=2, num_frames=4, points_per_part=200)
avg, stats = test_main(["--config", "handtracknet_test_SimGrasp.yml", "--device", "cpu",
                        "--pointnet_cfg/camera", "pointnet2_tiny.yml",
                        "--num_points", "64", "--network/backbone_out_dim", "48"])
seq = stats["sequences"][0]
assert seq["pred_kp"].shape == (4, 21, 3), seq["pred_kp"].shape
assert stats["n_frames"] == 4
bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu")
             or m.startswith(("jax.", "jaxlib", "flax", "hotrack_tpu.")))
assert not bad, bad
print("NO_JAX_OK", avg["hand_pred_kp_diff"])
"""


def test_cli_runs_the_slice_without_jax(tmp_path):
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, HOTRACK_DATA_ROOT=str(tmp_path), PYTHONPATH=path)
    out = subprocess.run([sys.executable, "-c", _CLI_SCRIPT], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout
    assert "using random init" in out.stdout


@pytest.mark.parametrize("overrides", [
    [],
    ["--num_points", "64", "--network/backbone_out_dim", "48",
     "--pointnet_cfg/camera", "pointnet2_tiny.yml"],
    ["--data_cfg/basepath", "Elsewhere", "--device", "cpu"],
])
def test_config_matches_the_jax_package(tmp_path, monkeypatch, overrides):
    """The port's carried-over config loader resolves a command line exactly
    as hotrack_tpu.config does (exact equality of the nested dicts)."""
    from hotrack_tpu.config import get_config as jax_get_config
    from hotrack_tpu_torch.train.cli import build_arg_parser, parse_with_overrides
    from hotrack_tpu_torch.config import get_config

    monkeypatch.setenv("HOTRACK_DATA_ROOT", str(tmp_path))
    argv = ["--config", "handtracknet_test_SimGrasp.yml", *overrides]
    args = parse_with_overrides(build_arg_parser("test"), argv)
    want = jax_get_config(dict(args), save=False)
    assert get_config(dict(args), save=False) == want
    assert get_config(dict(args), save=True) == want


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero with no result line when CUDA is missing
    (always so on a CPU-only torch)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout
    assert "cuda.is_available() is false" in out.stderr
