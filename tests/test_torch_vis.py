"""The port's debug figures (hotrack_tpu_torch/utils/vis.py), the
counterparts of tests/test_vis.py, and `--debug_save` through the test
entry: figures written without a display, one a tracked frame; and a clear
error where matplotlib is missing."""

import builtins
import os

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.track.types import HandTrackResult
from hotrack_tpu_torch.train import cli
from hotrack_tpu_torch.train.run_hand_track import _debug_visualize
from hotrack_tpu_torch.utils.dicts import dump_csv
from hotrack_tpu_torch.utils.vis import hand_vis, plot3d_pts

pytest.importorskip("matplotlib")
TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48", "--device", "cpu"]


def test_plot3d_pts(tmp_path):
    rng = np.random.RandomState(0)
    pts = [[rng.randn(50, 3), rng.randn(20, 3)], [rng.randn(30, 3)]]
    plot3d_pts(pts, save_fig=True, save_folder=str(tmp_path), save_name="p")
    assert os.path.exists(tmp_path / "p.png")


def test_hand_vis(tmp_path):
    rng = np.random.RandomState(1)
    points = rng.randn(100, 3) * 0.05
    kp = rng.randn(21, 3) * 0.04
    hand_vis(points, kp, kp + 0.01, kp - 0.01, save_fig=True,
             save_folder=str(tmp_path), save_name="h/a")
    assert os.path.exists(tmp_path / "h_a.png")


def test_dump_csv(tmp_path):
    path = str(tmp_path / "x.csv")
    dump_csv(path, {"a": [1, 2, 3], "b": np.array([0.5, 0.25, 0.125])})
    lines = open(path).read().strip().splitlines()
    assert lines[0] == "a,b"
    assert len(lines) == 4


def test_debug_visualize_saves_figures(tmp_path):
    t = 3
    gen = torch.Generator().manual_seed(0)

    def z(*shape):
        return torch.randn(shape, generator=gen) * 0.05

    eye = torch.eye(3).expand(t, 3, 3)
    result = HandTrackResult(
        pred_kp=z(t, 21, 3), baseline_pred_kp=z(t, 21, 3), canon_rotation=eye,
        canon_translation=torch.zeros(t, 3, 1), global_rotation=eye,
        global_translation=torch.zeros(t, 3, 1), mano_theta=torch.zeros(t, 45),
        pred_beta=torch.zeros(1, 10))
    batch = {"hand_points": z(t, 64, 3), "gt_hand_kp": z(t, 21, 3),
             "jittered_hand_kp": z(t, 21, 3)}
    metas = [{"file_name": f"seq/{i:04d}"} for i in range(t)]
    _debug_visualize({"experiment_dir": str(tmp_path), "debug_save": True}, metas, result, batch)
    assert sorted(p.name for p in (tmp_path / "debug").glob("*.png")) == [
        f"seq_{i:04d}.png" for i in range(t)]


def test_debug_save_through_the_test_entry(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    generate_simgrasp_dataset(root, num_instances=2, num_frames=2, points_per_part=200)
    monkeypatch.setenv("HOTRACK_DATA_ROOT", root)
    avg, stats = cli.test_main(["--config", "handtracknet_test_SimGrasp.yml", "--debug_save",
                                *TINY])
    cfg = cli.load_config(["--config", "handtracknet_test_SimGrasp.yml", *TINY])
    figures = os.listdir(os.path.join(cfg["experiment_dir"], "debug"))
    assert len(figures) == stats["n_frames"] == 2 and all(f.endswith(".png") for f in figures)


def test_a_figure_without_matplotlib_raises_clearly(monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(RuntimeError, match="need matplotlib"):
        plot3d_pts([[np.zeros((2, 3))]])
