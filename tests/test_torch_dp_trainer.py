"""Data-parallel training (train/dp.py) against the one-process Trainer at
the global batch, in float64 on the CPU: two gloo ranks, spawned, against
one process, on the same seeded weights and prepared batches, dropout on
(every dropout draws its mask for the global batch from the same seed, so
both runs drop the same units).

Bounds, those the float64 step of tests/test_torch_trainer.py holds the port
to against the JAX package: step-0 losses rtol 1e-10; every gradient the
optimizer took within 1e-8 of its largest (plus 1e-10 for the biases whose
gradient is residue); BN running statistics after the step rtol 1e-10; the
state after one Adam step within 1e-7; the parameters without a gradient the
same set on every rank and in one process; after three steps every
parameter and buffer bitwise equal across the ranks. Eval batches: a 7-row
batch (it does not split over 2 ranks, and runs whole on each) and an 8-row
one (split, its means all-reduced) equal the one-process `test` at rtol
1e-12. An indivisible train batch: tests/test_torch_dp_checks.py.

Sizes: pointnet2_tiny.yml, 64 points, backbone_out_dim 48, global batch 8.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.train import dp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL, STEPS, WORLD, TIMEOUT_S = 8, 3, 2, 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread, as each spawned rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(exp_dir):
    with open(os.path.join(REPO, "configs", "pointnet_config", "pointnet2_tiny.yml")) as f:
        net = yaml.safe_load(f)
    cfg = {"device": "cpu", "track": False, "seed": 0, "mano_root": None,
           "experiment_dir": str(exp_dir), "optimizer": "Adam", "learning_rate": 1e-4,
           "weight_decay": 1e-4, "lr_policy": "step", "lr_step_size": 20, "lr_gamma": 0.5,
           "lr_clip": 1e-5, "warm_up": 0, "total_epoch": 300, "momentum_original": 0.1,
           "momentum_decay": 0.5, "momentum_step_size": 20, "momentum_min": 0.01,
           "weight_init": "xavier", "pointnet": {"camera": net}}
    cfg["network"] = {"type": "HandTrackNet", "handframe": "kp", "backbone_out_dim": 48,
                      "loss_weight": {"hand_pred_kp_loss": 10, "hand_pred_r_loss": 1,
                                      "hand_pred_t_loss": 1}}
    return cfg


def _prepared(root, frames):
    generate_simgrasp_dataset(root, num_instances=2, num_frames=frames, points_per_part=300)
    dcfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                         "bottle_sim": {"num_parts": 1}},
            "num_points": 64, "obj_category": ["bottle_sim"], "seed": 0}
    raw, _ = SequenceData(SimGraspDataset(dcfg, "test"), frames)[0]
    full = prepare_batch(synthetic_mano_model(), raw, 64, hand_jitter_scale=0.02,
                         generator=torch.Generator().manual_seed(0))

    def rows(a, b):
        return {"hand_points": full["hand_points"][a:b],
                "jittered_hand_kp": full["jittered_hand_kp"][a:b],
                "gt_hand_kp": full["gt_hand_kp"][a:b],
                "gt_hand_pose": {"palm_template": full["gt_hand_pose"]["palm_template"][a:b]}}
    return rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same steps in one process and on two ranks."""
    tmp = tmp_path_factory.mktemp("dp_trainer")
    rows = _prepared(str(tmp / "data"), GLOBAL * STEPS)
    batches = [rows(i * GLOBAL, (i + 1) * GLOBAL) for i in range(STEPS)]
    evals = (rows(0, 7), rows(8, 16))
    cfg = _cfg(tmp / "exp")
    one = dp.step_report(None, cfg, batches, steps=1, dtype=torch.float64,
                         eval_batches=evals)
    ranks = dp.run_ranks(dp.step_report, WORLD, "cpu", timeout_s=TIMEOUT_S, args=(
        cfg, batches, STEPS, torch.float64, True, False, evals))
    return {"one": one, "ranks": ranks, "cfg": cfg, "rows": rows}


def test_step0_losses_equal_the_one_process_step(runs):
    one, dp0 = runs["one"]["losses"][0], runs["ranks"][0]["losses"][0]
    assert set(one) == set(dp0) and "total_loss" in one
    for k, want in one.items():
        np.testing.assert_allclose(dp0[k], want, rtol=1e-10, err_msg=k)
        assert runs["ranks"][1]["losses"][0][k] == dp0[k], k


def test_gradients_equal_the_one_process_step(runs):
    worst, n = (0.0, ""), 0
    for rank in runs["ranks"]:
        for k, want in runs["one"]["grads"].items():
            g = rank["grads"][k]
            assert (g is None) == (want is None), k
            if want is None:
                continue
            assert g.dtype == torch.float64
            gmax, err = float(want.abs().max()), float((g - want).abs().max())
            assert err <= 1e-8 * gmax + 1e-10, (k, err, gmax)
            if gmax > 1e-6:
                worst, n = max(worst, (err / gmax, k)), n + 1
    print(f"worst live gradient: {worst}")
    assert n >= 200


def test_frozen_parameters_are_the_same_set(runs):
    frozen = [{k for k, g in r["grads"].items() if g is None}
              for r in (runs["one"], *runs["ranks"])]
    assert frozen[0] and frozen[0] == frozen[1] == frozen[2]
    assert all(k.startswith(("transt.s12.", "transt.c12.")) for k in frozen[0])


def test_bn_statistics_and_state_after_one_step(runs):
    one, dp0 = runs["one"]["state1"], runs["ranks"][0]["state1"]
    n_stats = 0
    for k, want in one.items():
        got = dp0[k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(want) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=0,
                                       err_msg=k)
            n_stats += 1
        else:
            assert float((got - want).abs().max()) <= 1e-7, k
    assert n_stats >= 24


def test_ranks_stay_bitwise_equal_over_three_steps(runs):
    a, b = runs["ranks"][0]["state"], runs["ranks"][1]["state"]
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    moved = sum(not torch.equal(a[k], runs["ranks"][0]["state1"][k]) for k in a)
    assert moved > len(a) // 2
    assert [r["total_loss"] for r in runs["ranks"][0]["losses"]] \
        == [r["total_loss"] for r in runs["ranks"][1]["losses"]]


@pytest.mark.parametrize("which", [0, 1], ids=["ragged_7_rows", "split_8_rows"])
def test_eval_batches_equal_the_one_process_test(runs, which):
    want = runs["one"]["evals"][which]
    for rank in runs["ranks"]:
        got = rank["evals"][which]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
