"""`--dp_devices` through the training entry: `train_main --dp_devices 2
--device cpu` trains on two gloo ranks and returns rank 0's Trainer, whose
history equals the one-process run's at the same global batch; the
checkpoint it wrote loads (strict) into the one-process Trainer and into the
tracking entry; `--dp_devices 1` is the one-process path bit for bit
(`--dp_devices 0`: the training split divides by the batch, so the JAX
package's truthy drop_last rule, which `dp_devices 1` turns on, drops
nothing); and asking for more cards than there are raises, with the JAX
trainer's message, before any work.

The history is held at rtol 1e-4, the float32 bound that
tests/test_torch_trainer.py holds a step's Procrustes-of-the-prediction
losses to and that test_multichip_training.py holds the JAX package's dp
step to: in float32 the two runs' forwards differ by the order of the sums
(BatchNorm's statistics over all-reduced sums, the batched products over
fewer rows), and the untrained net's Procrustes terms amplify that (one step
of this net: up to 5.2e-6 relative, with the same index picks;
test_torch_dp_trainer.py holds the dp step in float64 at 1e-10). The
learning rate is 1e-7: Adam's first step is lr * sign(g) whatever the
gradient's size, so a gradient within float32 rounding of 0 moves its
weight by +-lr in one run and not in the other, and at the shipped 1e-4 the
histories part by 3.4e-4 after three steps, as the JAX package's own dp
trajectories part (test_multichip_training.py).

Sizes: pointnet2_tiny.yml, 64 points, backbone_out_dim 48, batch 6: 18
training frames in 3 batches, 9 test frames in a batch of 6 (split over the
ranks) and a ragged one of 3 (whole on each).
"""

import os

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.train import cli
from hotrack_tpu_torch.train.cli import load_config, train_main
from hotrack_tpu_torch.train.trainer import Trainer

TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48"]
TRAIN = ["--config", "handtracknet_train_SimGrasp.yml", *TINY, "--batch_size", "6",
         "--device", "cpu", "--epochs", "1", "--learning_rate", "1e-7"]
FRAMES = 9


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_cli"))
    generate_simgrasp_dataset(root, num_instances=3, num_frames=FRAMES, points_per_part=200)
    old = os.environ.get("HOTRACK_DATA_ROOT")
    os.environ["HOTRACK_DATA_ROOT"] = root
    try:
        yield {name: train_main([*TRAIN, *extra, "--experiment_dir", f"dp_{name}"])
               for name, extra in (("two", ["--dp_devices", "2"]),
                                   ("one", ["--dp_devices", "1"]),
                                   ("zero", ["--dp_devices", "0"]))}
    finally:
        if old is None:
            os.environ.pop("HOTRACK_DATA_ROOT", None)
        else:
            os.environ["HOTRACK_DATA_ROOT"] = old


def test_dp_history_equals_the_one_process_run(runs):
    two, one = runs["two"], runs["zero"]
    assert two.dp is not None and two.dp.world == 2 and one.dp is None
    assert len(two.history) == 1 and len(two.history[0]["step_seconds"]) == 3
    for split in ("train", "test"):
        got, want = two.history[0][split], one.history[0][split]
        assert set(got) == set(want) and "hand_pred_kp_diff" in got
        for k in want:
            assert np.isfinite(got[k]), (split, k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"{split} {k}")


def test_dp_devices_1_is_the_one_process_path_bit_for_bit(runs):
    one, ref = runs["one"], runs["zero"]
    assert one.dp is None
    assert one.history[0]["train"] == ref.history[0]["train"]
    assert one.history[0]["test"] == ref.history[0]["test"]
    for k, v in ref.model.state_dict().items():
        assert torch.equal(one.model.state_dict()[k], v), k


def test_dp_checkpoint_loads_into_one_process_and_the_tracking_entry(runs, capsys):
    two = runs["two"]
    path = os.path.join(two.ckpt_dir, "model_0001.pt")
    assert os.path.exists(path)
    fresh = Trainer(two.cfg, "cpu")   # the one-process trainer, strict load
    assert fresh.resume(path) and fresh.epoch == 1
    for k, v in two.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    avg, stats = cli.test_main(["--config", "handtracknet_test_SimGrasp.yml", *TINY,
                                "--device", "cpu", "--experiment_dir", "dp_two",
                                "--resume_epoch", "1"])
    assert "resumed from" in capsys.readouterr().out
    assert stats["n_frames"] == FRAMES and np.isfinite(avg["hand_pred_kp_diff"])


def test_more_cards_than_there_are_raises_before_any_work(tmp_path):
    """F6: the port used to train on one device whatever --dp_devices said."""
    want = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"dp_devices={want} but only "
                                         f"{want - 1} devices"):
        train_main([*TRAIN[:-6], "--device", "cuda", "--dp_devices", str(want),
                    "--experiment_dir", str(tmp_path / "f6")])
    assert not os.path.exists(os.path.join(str(tmp_path / "f6"), "ckpt"))
    cfg = load_config([*TRAIN, "--dp_devices", str(want)], "train")
    cfg["device"] = "cuda"
    with pytest.raises(ValueError, match="but only"):
        cli._test_single_frame(cfg)
