"""The training slice through its entry points: `train_main` on a generated
SimGrasp set at a tiny size on the CPU, the checkpoint it writes, `resume()`,
`test_main` tracking with that checkpoint, single-frame evaluation, and the
command line in a subprocess, which must import neither JAX nor the JAX
package and must refuse `--device cuda` when there is no card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.train import cli
from hotrack_tpu_torch.train.cli import load_config, train_main
from hotrack_tpu_torch.train.trainer import Trainer, lr_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48"]
TRAIN = ["--config", "handtracknet_train_SimGrasp.yml", *TINY, "--batch_size", "4",
         "--device", "cpu"]
FRAMES = 7  # per instance: 14 training frames = 3 batches of 4 and a tail of 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of HandTrackNet on 2 training instances (1 test instance)."""
    root = str(tmp_path_factory.mktemp("train_cli"))
    generate_simgrasp_dataset(root, num_instances=3, num_frames=FRAMES,
                              points_per_part=200)
    old = os.environ.get("HOTRACK_DATA_ROOT")
    os.environ["HOTRACK_DATA_ROOT"] = root
    try:
        trainer = train_main([*TRAIN, "--epochs", "2", "--freq/save", "1",
                              "--lr_step_size", "2"])
        yield root, trainer
    finally:
        if old is None:
            os.environ.pop("HOTRACK_DATA_ROOT", None)
        else:
            os.environ["HOTRACK_DATA_ROOT"] = old


def test_train_main_runs_two_epochs_and_consumes_the_ragged_tail(trained):
    _, trainer = trained
    assert trainer.epoch == 2 and trainer.iteration == 8
    assert trainer.cfg["dataset_len"] == 4  # 3 full batches + the tail of 2
    for h in trainer.history:
        assert len(h["step_seconds"]) == 4 and len(h["data_seconds"]) == 4
        assert all(np.isfinite(v) for v in h["train"].values())
        assert all(np.isfinite(v) for v in h["test"].values())
        assert "total_loss" in h["train"] and "total_loss" not in h["test"]
    assert trainer.history[1]["train"]["total_loss"] \
        < 2.0 * trainer.history[0]["train"]["total_loss"]
    assert trainer.device.type == "cpu"


def test_checkpoints_are_reference_format_and_resume_continues(trained):
    root, trainer = trained
    for epoch in (1, 2):
        assert os.path.exists(os.path.join(trainer.ckpt_dir, f"model_{epoch:04d}.pt"))
    ckpt = torch.load(os.path.join(trainer.ckpt_dir, "model_0002.pt"), weights_only=True)
    assert ckpt["epoch"] == 2
    assert ckpt["model"]["bhand.sa1.conv_blocks.0.0.weight"].dim() == 4  # Conv2d layout

    cfg = load_config([*TRAIN, "--lr_step_size", "2"], "train")
    fresh = Trainer(cfg, "cpu")
    assert fresh.epoch == 0 and fresh.lr == lr_schedule(cfg, 0)
    assert fresh.resume()
    assert fresh.epoch == 2
    # the rate of epoch 2: (2 + 1) // 2 = one halving, in every param group
    assert fresh.lr == lr_schedule(cfg, 2) == pytest.approx(5e-5)
    assert all(g["lr"] == fresh.lr for g in fresh.optimizer.param_groups)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k

    pinned = Trainer({**cfg, "resume_epoch": 1}, "cpu")
    assert pinned.resume() and pinned.epoch == 1
    with pytest.raises(FileNotFoundError):
        Trainer({**cfg, "resume_epoch": 7}, "cpu").resume()
    # a third epoch continues from the checkpoint and writes model_0003.pt
    more = train_main([*TRAIN, "--epochs", "3", "--lr_step_size", "2"])
    assert [h["epoch"] for h in more.history] == [2]
    assert more.history[0]["lr"] == pytest.approx(5e-5)
    assert os.path.exists(os.path.join(more.ckpt_dir, "model_0003.pt"))


def test_test_main_tracks_with_the_trained_checkpoint(trained, capsys):
    avg, stats = cli.test_main(["--config", "handtracknet_test_SimGrasp.yml", *TINY,
                            "--device", "cpu", "--experiment_dir", "train_debug",
                            "--resume_epoch", "2"])
    assert "resumed from" in capsys.readouterr().out
    assert stats["n_frames"] == FRAMES
    pred = stats["sequences"][0]["pred_kp"]
    assert pred.shape == (FRAMES, 21, 3) and np.isfinite(pred).all()
    assert np.isfinite(avg["hand_pred_kp_diff"])


def test_single_frame_evaluation(trained):
    avg, stats = cli.test_main([*TRAIN])  # track: False in the training config
    assert stats["n_frames"] == FRAMES
    assert stats["fps_network"] >= stats["fps_all"] > 0
    assert set(avg) >= {"hand_pred_kp_loss", "hand_pred_kp_diff", "hand_pred_r_loss"}
    assert all(np.isfinite(v) for v in avg.values())


def test_iknet_trains_through_the_same_entry(trained):
    trainer = train_main(["--config", "iknet_train_SimGrasp.yml", *TINY,
                          "--batch_size", "4", "--device", "cpu", "--epochs", "1"])
    h = trainer.history[0]
    assert set(h["train"]) == {"quat_loss", "init_gt_kp_diff", "total_loss"}
    assert np.isfinite(h["train"]["total_loss"])
    assert os.path.exists(os.path.join(trainer.ckpt_dir, "model_0001.pt"))
    fresh = Trainer(trainer.cfg, "cpu")
    assert fresh.resume() and fresh.epoch == 1


def test_other_tracking_routes_still_raise(trained):
    """Every route of the JAX package's test entry is ported, several
    sequences through one loop (`eval_batch_seqs`) too; what is left to
    raise is a route neither package has."""
    argv = ["--config", "handtracknet_test_SimGrasp.yml", *TINY, "--device", "cpu"]
    with pytest.raises(ValueError, match="unknown track"):
        cli.test_main([*argv, "--track", "hand_obj"])
    avg, stats = cli.test_main([*argv, "--track", "hand_IKNet", "--eval_batch_seqs", "2"])
    assert stats["n_frames"] == FRAMES and all(np.isfinite(v) for v in avg.values())


def test_cuda_without_a_card_raises(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_main([*TRAIN[:-2], "--epochs", "1"])  # the default device


_CLI_CHECK = r"""
import runpy, sys
sys.argv = ["hotrack_tpu_torch.train", *sys.argv[1:]]
runpy.run_module("hotrack_tpu_torch.train", run_name="__main__")
bad = sorted(m for m in sys.modules if m in ("jax", "hotrack_tpu")
             or m.startswith(("jax.", "jaxlib", "flax", "optax", "hotrack_tpu.")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_train_command_line_runs_without_jax(trained, tmp_path):
    root, _ = trained
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, HOTRACK_DATA_ROOT=root, PYTHONPATH=path)
    out = subprocess.run(
        [sys.executable, "-c", _CLI_CHECK, *TRAIN, "--epochs", "1",
         "--experiment_dir", "cli_subprocess"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout
    assert os.path.exists(os.path.join(root, "exps", "cli_subprocess", "ckpt",
                                       "model_0001.pt"))
