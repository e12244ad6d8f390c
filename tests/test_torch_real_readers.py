"""The port's HO3D and DexYCB readers against the JAX package's, on trees
that hotrack_tpu_torch/data/real_trees.py writes from a synthetic scene, and
the five HO3D / DexYCB configs through the port's test entry.

- data/image.py against OpenCV and Pillow, bitwise: `imread` is
  `cv2.imread`, `read_png` is `np.array(PIL.Image.open(...))`, on files
  written by cv2 and by the port's own writer with each of the five row
  filters; `resize_nearest` is cv2's INTER_NEAREST.
- HO3D: every RawFrame field of every frame bitwise the JAX reader's (the
  JAX reader decodes with cv2 and the JAX package's native library, the
  port with data/image.py and its own library), the sequence grouping
  equal, the predicted-pose pickles read alike.
- DexYCB: the radius filter's centre is the middle MCP of a host MANO call,
  float32 on the CPU in both packages (XLA's and torch's sums), so the
  annotated keypoints are held at KP_ATOL; the test tree's hand points lie
  at least RADIUS_CLEARANCE from the filter's 0.15 m radius (asserted), so
  that no such difference moves a point across it, and everything else is
  held bitwise.
- The pipeline: objopt_test_HO3D (the tiny DeepSDF decoder of SPECS, a
  random flax decoder exported with utils/convert.sdf_decoder_state_dict_from_flax
  and shaped into an object by real_trees.decoder_object) writes its pose
  pickles, handopt_test_HO3D reads them (use_pred_obj_pose), and
  handtracknet / handiknet on HO3D and handtracknet on DexYCB track; finite
  metrics, and pickles with the JAX runners' keys and dtypes. Sizes are cut
  (volumes, particle banks, distillation, nets) as the other runner tests
  cut them.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.data.dataset import SequenceData as JaxSequenceData
from hotrack_tpu.data.dexycb import DexYCBDataset as JaxDexYCB
from hotrack_tpu.data.ho3d import HO3DDataset as JaxHO3D
from hotrack_tpu.sdf.assets import load_obj_for_opt as jax_load_obj_for_opt
from hotrack_tpu.sdf.assets import load_torch_decoder as jax_load_torch_decoder
from hotrack_tpu.sdf.decoder import SDFDecoder as JaxSDFDecoder
from hotrack_tpu_torch.data import SequenceData, image, real_trees
from hotrack_tpu_torch.data.dexycb import DexYCBDataset
from hotrack_tpu_torch.data.ho3d import HO3DDataset, read_depth_img, read_seg_mask
from hotrack_tpu_torch.sdf import assets, distill
from hotrack_tpu_torch.train import cli, run_hand_track, run_obj_track
from hotrack_tpu_torch.utils.convert import sdf_decoder_state_dict_from_flax

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

FRAMES = 3
KP_ATOL = 1e-5
RADIUS_CLEARANCE = 1e-4
SPECS = {"dims": [32, 288, 32, 32], "dropout": [0, 1, 2, 3], "dropout_prob": 0.2,
         "norm_layers": [0, 1, 2, 3], "latent_in": [2], "xyz_in_all": False,
         "use_tanh": False, "latent_dropout": False, "weight_norm": True}
TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48", "--device", "cpu"]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small operations: the
    suite runs beside other processes, and threads that wait for work spin
    on the cores the others need. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ------------------------------------------------------------------ images

def _image(kind, rng):
    if kind == "rgb":
        return rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
    if kind == "rgba":
        return rng.randint(0, 256, (23, 31, 4)).astype(np.uint8)
    if kind == "gray":
        return rng.randint(0, 256, (23, 31)).astype(np.uint8)
    return rng.randint(0, 65536, (23, 31)).astype(np.uint16)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray16"])
@pytest.mark.parametrize("writer", ["cv2", "filters"])
def test_image_reads_as_opencv_and_pillow_do(tmp_path, kind, writer):
    img = _image(kind, np.random.RandomState(len(kind)))
    # a smooth ramp beside the noise, so that every filter has work to do
    img[:, :10] = np.arange(10, dtype=img.dtype)[None, :, None][..., 0] if img.ndim == 2 \
        else np.arange(10, dtype=img.dtype)[None, :, None]
    path = str(tmp_path / "img.png")
    if writer == "cv2":
        cv2.imwrite(path, img)
    else:
        image.write_png(path, img, filters=(0, 1, 2, 3, 4))
    np.testing.assert_array_equal(image.imread(path), cv2.imread(path))
    with Image.open(path) as f:
        want = np.array(f)
    got = image.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((240, 320), (480, 640)), ((37, 53), (100, 77)),
                                     ((100, 77), (37, 53))])
def test_resize_nearest_picks_opencvs_pixels(src, dst):
    img = np.random.RandomState(1).randint(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        image.resize_nearest(img, (dst[1], dst[0])),
        cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))


# ------------------------------------------------------------------ the trees

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """HO3D (two sequences: intrinsics from calibration/ and from camMat)
    and DexYCB trees under one data root, with the tiny flax decoder."""
    root = str(tmp_path_factory.mktemp("real"))
    jdec = JaxSDFDecoder(latent_size=256, dims=tuple(SPECS["dims"]),
                         dropout=tuple(SPECS["dropout"]), norm_layers=tuple(SPECS["norm_layers"]),
                         latent_in=tuple(SPECS["latent_in"]), weight_norm=True)
    params = jax.tree_util.tree_map(np.asarray, jdec.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 259)))["params"])
    decoder = assets.build_decoder(SPECS).eval()
    decoder.load_state_dict(sdf_decoder_state_dict_from_flax(params), strict=True)
    latent = torch.from_numpy(np.random.RandomState(3).randn(256).astype(np.float32) * 0.01)
    ho3d = real_trees.write_ho3d_tree(root, FRAMES, seqs=("ABF10", "BOXY"),
                                      decoder=decoder, latent=latent)
    dex = real_trees.write_dexycb_tree(root, FRAMES)
    return {"root": root, "ho3d": ho3d, "dex": dex, "decoder": decoder, "latent": latent}


def _cfg(trees, name, **extra):
    base = trees["ho3d" if name == "HO3D" else "dex"]["basepath"]
    return {"data_cfg": {"basepath": base, "dataset_name": name}, "num_points": 64,
            "obj_category": ["bottle"], "seed": 0, **extra}


def _same_frames(got, want, kp_atol=0.0):
    for field in got._fields:
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if field == "annot_hand_kp" and kp_atol:
            np.testing.assert_allclose(a, b, atol=kp_atol, rtol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_ho3d_reader_matches_the_jax_reader(trees):
    port, jax_reader = HO3DDataset(_cfg(trees, "HO3D"), "test"), JaxHO3D(_cfg(trees, "HO3D"),
                                                                         "test")
    assert port.seq_start == jax_reader.seq_start == [0, FRAMES] and len(port) == 2 * FRAMES
    for i in range(len(port)):
        (frame, meta), (jframe, jmeta) = port[i], jax_reader[i]
        assert bool(frame.valid) and meta == jmeta
        assert frame.hand_valid.sum() > 100 and frame.obj_valid.sum() > 20
        _same_frames(frame, jframe)
    assert SequenceData(port).sequences == JaxSequenceData(jax_reader).sequences
    assert SequenceData(port)[1][0].hand_points.shape[0] == FRAMES


def test_ho3d_tree_annotates_what_it_renders(trees):
    """The annotated object pose maps the reader's object cloud onto the
    object's surface (the tree's frames are HO3D's: y and z negated), and
    the annotated keypoints lie in the hand's cloud."""
    from scipy.spatial import cKDTree
    surface = cKDTree(trees["ho3d"]["object"])
    ds = HO3DDataset(_cfg(trees, "HO3D"), "test")
    for i in range(len(ds)):
        frame = ds[i][0]
        obj = frame.obj_points[frame.obj_valid].astype(np.float64)
        rot = frame.obj_rotation.astype(np.float64)
        in_object = (obj - frame.obj_translation[:, 0]) @ rot
        assert np.median(surface.query(in_object)[0]) < 2e-3
        hand = frame.hand_points[frame.hand_valid]
        assert np.median(np.linalg.norm(hand - frame.annot_hand_kp[9], axis=-1)) < 0.1


def test_ho3d_decode_and_seg_match_opencv(trees):
    from hotrack_tpu import native as jax_native
    base = trees["ho3d"]["basepath"]
    depth = os.path.join(base, "train", "ABF10", "depth", "0001.png")
    seg = os.path.join(base, "train", "ABF10", "seg", "0001.png")
    np.testing.assert_array_equal(
        read_depth_img(depth),
        jax_native.decode_ho3d_depth(cv2.imread(depth), 0.00012498664727900177))
    want = cv2.resize(cv2.imread(seg), (640, 480), interpolation=cv2.INTER_NEAREST)
    got = read_seg_mask(seg)
    assert cv2.imread(seg).shape == (240, 320, 3) and got.shape == (480, 640, 3)
    np.testing.assert_array_equal(got, want)
    # blue marks the hand, green the object, as the readers take them
    assert (got[..., 0] == 255).sum() > 100 and (got[..., 1] == 255).sum() > 100


def test_ho3d_pred_obj_pose_pickles_are_read_alike(trees, tmp_path):
    rng = np.random.RandomState(1)
    poses = [{"rotation": np.linalg.qr(rng.randn(3, 3))[0], "translation": rng.randn(3, 1)}
             for _ in range(FRAMES)]
    for seq in ("ABF10", "BOXY"):
        with open(tmp_path / f"{seq}_0000.pkl", "wb") as f:
            pickle.dump({"pred_obj_poses": poses}, f)
    cfg = _cfg(trees, "HO3D", use_pred_obj_pose=True, pred_obj_pose_dir=str(tmp_path))
    port, jax_reader = HO3DDataset(cfg, "test"), JaxHO3D(cfg, "test")
    for i in (1, FRAMES + 2):
        frame, jframe = port[i][0], jax_reader[i][0]
        np.testing.assert_array_equal(frame.pred_obj_rotation,
                                      poses[i % FRAMES]["rotation"].astype(np.float32))
        _same_frames(frame, jframe)


def test_dexycb_reader_matches_the_jax_reader(trees):
    from hotrack_tpu_torch import native
    port, jax_reader = DexYCBDataset(_cfg(trees, "DexYCB"), "test"), JaxDexYCB(
        _cfg(trees, "DexYCB"), "test")
    assert port.seq_start == jax_reader.seq_start == [0] and len(port) == FRAMES
    k = real_trees.INTRINSICS
    for i in range(FRAMES):
        (frame, meta), (jframe, jmeta) = port[i], jax_reader[i]
        assert bool(frame.valid) and meta == jmeta and frame.hand_valid.sum() > 100
        # the hand's points lie clear of the filter's radius around either MCP
        labels = np.load(os.path.join(trees["dex"]["basepath"], *trees["dex"]["sequence"].split(
            "+"), "labels_%06d.npz" % i))["seg"]
        depth = image.read_png(os.path.join(
            trees["dex"]["basepath"], *trees["dex"]["sequence"].split("+"),
            "aligned_depth_to_color_%06d.png" % i)) / 1000.0
        hand = native.backproject_filter(depth.astype(np.float32), labels, 255, k["fx"], k["fy"],
                                         k["cx"], k["cy"], stride=2)
        for kp in (frame.annot_hand_kp, jframe.annot_hand_kp):
            d = np.linalg.norm(hand.astype(np.float64) - kp[9].astype(np.float64), axis=-1)
            assert np.abs(d - 0.15).min() > RADIUS_CLEARANCE
        _same_frames(frame, jframe, kp_atol=KP_ATOL)


def test_the_decoder_file_loads_in_both_packages(trees):
    meta = {"file_name": "ABF10/0000", "category": real_trees.HO3D_OBJECT}
    base = trees["ho3d"]["basepath"]
    port = assets.load_obj_for_opt(base, "HO3D", "pred", meta["file_name"], meta["category"])
    want = jax_load_obj_for_opt(base, "HO3D", "pred", meta["file_name"], meta["category"])
    assert port.model_pth == want.model_pth and port.latent_code_pth == want.latent_code_pth
    tdec = assets.load_torch_decoder(port.model_pth, SPECS)
    jdec, variables = jax_load_torch_decoder(want.model_pth, SPECS)
    latent = assets.load_torch_latent(port.latent_code_pth)
    torch.testing.assert_close(latent, trees["latent"], rtol=0, atol=0)
    # the decoder's object: its surface points lie on the zero level
    surface = trees["ho3d"]["object"]
    norm = trees["ho3d"]["normalization"]
    ins = torch.from_numpy(((surface + norm["offset"]) * norm["scale"]).astype(np.float32))
    x = torch.cat([latent.expand(len(ins), -1), ins], -1)
    with torch.no_grad():
        got = tdec(x)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jdec.apply(variables, jnp.asarray(
        x.numpy())))[:, 0], atol=2e-6, rtol=0)
    # a unit gradient across a closed surface: the crossings lie within a
    # fine-grid step of it
    assert float(got.abs().max()) < 0.05 * float(norm["scale"][0])
    extent = surface.max(0) - surface.min(0)
    assert 0.02 < extent.min() and extent.max() <= 0.08 + 1e-6


# ------------------------------------------------------------------ the configs

@pytest.fixture
def small(trees, monkeypatch):
    """The runners at a size the CPU tests can afford: volumes, banks, the
    distillation and the decoder's width cut; nothing else."""
    monkeypatch.setenv("HOTRACK_DATA_ROOT", trees["root"])
    monkeypatch.setattr(run_obj_track, "VOLUME_SIZE", 41)
    monkeypatch.setattr(run_obj_track, "VOXEL_SCALE", 0.005)
    monkeypatch.setattr(run_obj_track, "NUM_PARTICLES", 64)
    monkeypatch.setattr(run_hand_track, "HAND_VOLUME_SIZE", 33)
    monkeypatch.setattr(run_hand_track, "HAND_VOXEL_SCALE", 0.006)
    monkeypatch.setattr(run_hand_track, "NUM_PARTICLES", 96)
    monkeypatch.setattr(run_obj_track, "load_torch_decoder",
                        lambda path, specs: assets.load_torch_decoder(path, SPECS))
    small_fit = dict(steps=100, batch=512, hidden=32, depth=2, pool_batches=4)
    for module in (run_obj_track, run_hand_track):
        monkeypatch.setattr(module, "distill_sdf_volume",
                            lambda vol, scale, gen, **kw: distill.distill_sdf_volume(
                                vol, scale, gen, **small_fit))
    return trees


def _pickles(cfg_name) -> dict:
    cfg = cli.load_config(["--config", cfg_name, *TINY])
    out = {}
    for name in sorted(os.listdir(cfg["save_dir"])):
        with open(os.path.join(cfg["save_dir"], name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def _types(tree):
    if isinstance(tree, dict):
        return {k: _types(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_types(tree[0])] if tree else []
    a = np.asarray(tree)
    return (a.dtype.str, a.ndim) if not isinstance(tree, str) else "str"


def test_objopt_then_handopt_on_ho3d_through_the_pose_pickles(small):
    from hotrack_tpu.train.run_obj_track import _save_sequence as jax_save_obj
    avg, stats = cli.test_main(["--config", "objopt_test_HO3D.yml", *TINY, "--save"])
    assert stats["n_frames"] == 2 * FRAMES and all(np.isfinite(v) for v in avg.values())
    assert sorted(_pickles("objopt_test_HO3D.yml")) == ["ABF10_0000.pkl", "BOXY_0000.pkl"]
    # the JAX runner's writer on the same results: the same keys and dtypes
    seq = stats["sequences"][0]
    cfg = cli.load_config(["--config", "objopt_test_HO3D.yml", *TINY])
    jcfg = dict(cfg, save_dir=str(small["root"]) + "/jax_obj")
    metas = [{"file_name": f"ABF10/{i:04d}", "category": real_trees.HO3D_OBJECT}
             for i in range(FRAMES)]
    res = type("R", (), {"rotation": jnp.asarray(seq["rotation"]),
                         "translation": jnp.asarray(seq["translation"])})
    jax_save_obj(jcfg, metas, res, {"gt_obj_pose": {
        "rotation": jnp.asarray(seq["gt_rotation"]),
        "translation": jnp.asarray(seq["gt_translation"])}},
        {"rdiff_0": jnp.asarray(seq["rdiff"]), "tdiff_0": jnp.asarray(seq["tdiff"])})
    with open(os.path.join(jcfg["save_dir"], "ABF10_0000.pkl"), "rb") as f:
        want = pickle.load(f)
    saved = _pickles("objopt_test_HO3D.yml")["ABF10_0000.pkl"]
    assert _types(saved) == _types(want) and saved["file_name"] == want["file_name"]

    # the hand stage reads those poses
    avg, stats = cli.test_main(["--config", "handopt_test_HO3D.yml", *TINY, "--save"])
    assert stats["n_frames"] == 2 * FRAMES and all(np.isfinite(v) for v in avg.values())
    cfg = cli.load_config(["--config", "handopt_test_HO3D.yml", *TINY])
    assert cfg["use_pred_obj_pose"] and cfg["pred_obj_pose_dir"].endswith(
        os.path.join("objopt_bottle_HO3D", "results"))
    frame = HO3DDataset(dict(cfg, num_points=64), "test")[1][0]
    np.testing.assert_array_equal(frame.pred_obj_rotation, saved["pred_obj_poses"][1]["rotation"])
    hands = _pickles("handopt_test_HO3D.yml")
    assert sorted(hands) == ["ABF10_0000.pkl", "BOXY_0000.pkl"]
    hand = hands["ABF10_0000.pkl"]
    assert set(hand) == {"gt_hand_kp", "pred_hand_kp", "file_name", "kp_error", "r_error",
                         "t_error", "pred_hand_poses", "baseline_pred_kp", "CAD_ID"}
    assert hand["CAD_ID"] == real_trees.HO3D_OBJECT
    assert hand["pred_hand_poses"]["mano_pose"].shape == (FRAMES, 48)


@pytest.mark.parametrize("config", ["handtracknet_test_HO3D.yml", "handiknet_test_HO3D.yml",
                                    "handtracknet_test_DexYCB.yml"])
def test_hand_tracking_configs_run_on_the_real_layouts(small, config):
    avg, stats = cli.test_main(["--config", config, *TINY, "--save"])
    sequences = 1 if "DexYCB" in config else 2
    assert stats["n_frames"] == sequences * FRAMES
    assert all(np.isfinite(v) for v in avg.values())
    assert all(np.isfinite(s["pred_kp"]).all() for s in stats["sequences"])
    saved = _pickles(config)
    assert len(saved) == sequences
    saved = saved[sorted(saved)[0]]
    from hotrack_tpu_torch.data.dexycb import YCB_CLASSES
    assert saved["CAD_ID"] == (YCB_CLASSES[real_trees.DEXYCB_OBJECT_ID] if "DexYCB" in config
                               else real_trees.HO3D_OBJECT)
    assert len(saved["pred_hand_kp"]) == FRAMES
