"""The pieces of data-parallel training (train/dp.py, nn/global_batch.py) on
their own: how `dp_devices` resolves to a world size (F6: more cards than
there are raises, with the JAX trainer's message), how a global batch is
split, the global-batch BatchNorm and dropout against their torch
counterparts in one process, and an indivisible train batch, which raises
on both of two spawned gloo ranks before any collective, so that neither
hangs.

Tolerances: GlobalBatchNorm1d outside a group is nn.BatchNorm1d (bitwise);
inside a group of one it computes the same function by other sums (float64:
1e-12, relative to the output's size); with inputs of mean 1e4 and spread 1
in float32 its two-pass variance keeps 1e-3 where one pass of sum(x^2)
would lose every digit.
"""

import numpy as np
import pytest
import torch
from torch import nn

from hotrack_tpu_torch.nn.global_batch import (GlobalBatchDropout, GlobalBatchNorm1d,
                                               convert_batchnorm, sharding)
from hotrack_tpu_torch.train import dp
from test_torch_dp_trainer import _cfg, _prepared


@pytest.mark.parametrize("asked,device,want", [
    (None, "cpu", 1), (0, "cpu", 1), (1, "cpu", 1), (3, "cpu", 3), ("all", "cpu", 1),
    (-1, "cpu", 1), (0, "cuda", 1)])
def test_world_size_of_dp_devices(asked, device, want):
    assert dp.world_size({"dp_devices": asked, "device": device}) == want


def test_more_cards_than_there_are_raises():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"dp_devices={have + 1} but only {have} devices"):
        dp.world_size({"dp_devices": have + 1, "device": "cuda"})
    with pytest.raises(ValueError, match="no device"):
        dp.world_size({"dp_devices": -3, "device": "cpu"})


def test_shard_rows_splits_every_tensor_or_refuses():
    batch = {"a": torch.arange(8).reshape(4, 2), "b": {"c": torch.arange(4)}, "n": 3}
    got = [dp.shard_rows(batch, r, 2, strict=True) for r in range(2)]
    assert torch.equal(torch.cat([g["a"] for g in got]), batch["a"])
    assert got[1]["b"]["c"].tolist() == [2, 3] and got[0]["n"] == 3
    assert dp.shard_rows(batch, 0, 3, strict=False) is None
    with pytest.raises(ValueError, match=r"dp_devices=3 needs batch_size divisible by it; "
                                         r"got \[4\]"):
        dp.shard_rows(batch, 0, 3, strict=True)


def _bn_pair(c=5, dtype=torch.float64):
    torch.manual_seed(0)
    ref = nn.BatchNorm1d(c, momentum=0.1).to(dtype)
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5)
        ref.bias.uniform_(-0.5, 0.5)
    glob = nn.BatchNorm1d(c, momentum=0.1).to(dtype)
    glob.load_state_dict(ref.state_dict())
    convert_batchnorm(nn.Sequential(glob))
    assert type(glob) is GlobalBatchNorm1d
    return ref, glob


def test_global_batchnorm_outside_a_group_is_torch_batchnorm():
    ref, glob = _bn_pair()
    x = torch.randn(37, 5, dtype=torch.float64)
    assert torch.equal(glob(x), ref(x))
    for k, v in ref.state_dict().items():
        assert torch.equal(glob.state_dict()[k], v), k


def test_global_batchnorm_in_a_group_of_one_computes_batchnorm():
    """Forward, the input's and the affine parameters' gradients, and the
    running statistics (unbiased variance over the count, torch's momentum)."""
    ref, glob = _bn_pair()
    x = torch.randn(37, 5, dtype=torch.float64) * 3 + 2
    dy = torch.randn(37, 5, dtype=torch.float64)
    xr, xg = x.clone().requires_grad_(), x.clone().requires_grad_()
    yr = ref(xr)
    with sharding(0, 1, lambda t: None):
        yg = glob(xg)
    np.testing.assert_allclose(yg.detach().numpy(), yr.detach().numpy(), rtol=0, atol=1e-12)
    (yr * dy).sum().backward()
    (yg * dy).sum().backward()
    for a, b in ((xg.grad, xr.grad), (glob.weight.grad, ref.weight.grad),
                 (glob.bias.grad, ref.bias.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(glob, k).numpy(), getattr(ref, k).numpy(),
                                   rtol=1e-12)
    assert int(glob.num_batches_tracked) == 1


def test_global_batchnorm_variance_survives_a_large_mean():
    _, glob = _bn_pair(dtype=torch.float32)
    x64 = torch.randn(4096, 5, dtype=torch.float64) + 1e4
    with sharding(0, 1, lambda t: None), torch.no_grad():
        y = glob(x64.float())
    want = (x64 - x64.mean(0)) / torch.sqrt(x64.var(0, unbiased=False) + 1e-5)
    want = want * glob.weight.detach().double() + glob.bias.detach().double()
    assert float((y.double() - want).abs().max()) < 1e-3


def test_global_batch_dropout_draws_the_global_mask():
    """Rank r of 2 keeps rows r of the mask one process draws for the whole
    batch from the same seed."""
    drop = GlobalBatchDropout(0.3).train()
    x = torch.randn(6, 4, 5)
    torch.manual_seed(11)
    whole = drop(x)
    assert 0 < int((whole == 0).sum()) < whole.numel()
    for r in range(2):
        torch.manual_seed(11)
        with sharding(r, 2, lambda t: None):
            got = drop(x[3 * r:3 * (r + 1)])
        assert torch.equal(got, whole[3 * r:3 * (r + 1)]), r
    assert torch.equal(drop.eval()(x), x)


def test_indivisible_train_batch_raises_on_every_rank(tmp_path):
    rows = _prepared(str(tmp_path / "data"), 8)
    with pytest.raises(ValueError, match="divisible") as info:
        dp.run_ranks(dp.step_report, 2, "cpu", timeout_s=120.0,
                     args=(_cfg(tmp_path / "exp"), [rows(0, 7)], 1))
    notes = getattr(info.value, "__notes__", [])
    assert any("rank 1" in n and "needs batch_size divisible" in n for n in notes), notes


def test_single_frame_evaluation_on_two_ranks(tmp_path, monkeypatch):
    """`test_main` on a `track: False` config with `--dp_devices 2`: the test
    split in batches of 6 (split over the ranks) and a ragged 3 (whole on
    each); the means equal the one-process evaluation's (rtol 1e-4: float32,
    eval mode, products over fewer rows; the Procrustes terms of the untrained
    prediction amplify their rounding, as tests/test_torch_dp_cli.py says)."""
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    from hotrack_tpu_torch.train import cli
    from hotrack_tpu_torch.train.trainer import Trainer
    generate_simgrasp_dataset(str(tmp_path), num_instances=3, num_frames=9,
                              points_per_part=200)
    monkeypatch.setenv("HOTRACK_DATA_ROOT", str(tmp_path))
    argv = ["--config", "handtracknet_train_SimGrasp.yml", "--pointnet_cfg/camera",
            "pointnet2_tiny.yml", "--num_points", "64", "--network/backbone_out_dim", "48",
            "--batch_size", "6", "--device", "cpu", "--experiment_dir", "dp_eval"]
    Trainer(cli.load_config(argv, "train"), "cpu").save(epoch=1)
    one, stats_one = cli.test_main(argv)
    two, stats_two = cli.test_main([*argv, "--dp_devices", "2"])
    assert stats_one["n_frames"] == stats_two["n_frames"] == 9
    assert set(one) == set(two)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-4, err_msg=k)
