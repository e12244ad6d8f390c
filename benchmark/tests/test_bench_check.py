"""The check that decides `correct`: a sound run passes it, and each fault
a cell can have, planted in the port underneath a run, fails it; the
control (the port's own lower-precision path) fails it too. On the CPU at
small sizes (the port's plain versions); the control at the cells' own size
needs a card (`gpu`)."""

import contextlib
from unittest import mock

import pytest
import torch

from benchmark import calibrate, core, run
from benchmark.tests.conftest import SMALL

SEED = 2**33 + 12345


def _run(cell, patch=None):
    with patch or contextlib.nullcontext():
        return run.run_cell(cell, SEED, 0.01, False, torch.device("cpu"),
                            config_override=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0


def _obj_unchanged():
    import hotrack_tpu_torch.track.obj as track_obj
    real = track_obj.optimize_obj_pose
    return mock.patch.object(track_obj, "optimize_obj_pose",
                             lambda *a, **k: real(*a, **{**k, "iterations": 0}))


def _obj_half_points():
    import hotrack_tpu_torch.opt.obj_pose as obj_pose
    real = obj_pose.fused_obj_sdf_energy_batched

    def half(models, pcld_cf, r, t, *a, **k):   # the sum over half, scaled to the whole
        return real(models, pcld_cf[..., :pcld_cf.shape[-1] // 2].contiguous(), r, t,
                    *a, **k) * 2.0
    return mock.patch.object(obj_pose, "fused_obj_sdf_energy_batched", half)


def _obj_altered():
    import hotrack_tpu_torch.track.obj as track_obj
    real = track_obj.optimize_obj_pose
    c, s = torch.cos(torch.tensor(0.01)), torch.sin(torch.tensor(0.01))
    turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def altered(*a, **k):
        r, t, e = real(*a, **k)
        return torch.matmul(r, turn), t, e
    return mock.patch.object(track_obj, "optimize_obj_pose", altered)


def _hand_unchanged():
    import hotrack_tpu_torch.track.hand as track_hand
    real = track_hand.optimize_hand_pose
    return mock.patch.object(track_hand, "optimize_hand_pose",
                             lambda *a, **k: real(*a, **{**k, "iterations": 0}))


def _hand_half_points():
    from hotrack_tpu_torch.models.hand_network import HandTrackNet
    real = HandTrackNet.forward

    def half(self, hand_points, *a, **k):
        return real(self, hand_points[:, :hand_points.shape[1] // 2], *a, **k)
    return mock.patch.object(HandTrackNet, "forward", half)


def _hand_altered():
    import hotrack_tpu_torch.track.hand as track_hand
    real = track_hand.optimize_hand_pose

    def altered(*a, **k):
        kp, theta, r, t, e = real(*a, **k)
        return kp + 1e-3, theta, r, t, e
    return mock.patch.object(track_hand, "optimize_hand_pose", altered)


FAULTS = {  # one chip, no exchange between chips: that fault has no place here
    ("objopt.s4", "state unchanged"): _obj_unchanged,
    ("objopt.s4", "half the points, mean over the rest"): _obj_half_points,
    ("objopt.s4", "answer altered"): _obj_altered,
    ("handopt.s4", "state unchanged"): _hand_unchanged,
    ("handopt.s4", "half the points"): _hand_half_points,
    ("handopt.s4", "answer altered"): _hand_altered,
}


@pytest.mark.parametrize("cell,fault", list(FAULTS))
def test_fault_fails_the_check(cell, fault):
    r = _run(cell, FAULTS[cell, fault]())
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_the_check(cell):
    r = calibrate.readings(cell, SEED, torch.device("cpu"), config_override=SMALL[cell])
    checks = core.resolve_cell(core.load_spec(core.ROOT), cell)["config"]["checks"]
    numbers = {side: run.reduce_checks(gaps, checks)[0] for side, gaps in r.items()}
    assert all(v <= lim for v, lim in numbers["port"].values()), numbers["port"]
    assert any(not v <= lim for v, lim in numbers["control"].values()), numbers["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    r = calibrate.readings(cell, SEED, torch.device("cuda", 0))
    checks = core.resolve_cell(core.load_spec(core.ROOT), cell)["config"]["checks"]
    numbers = {side: run.reduce_checks(gaps, checks)[0] for side, gaps in r.items()}
    assert all(v <= lim for v, lim in numbers["port"].values()), numbers["port"]
    assert any(not v <= lim for v, lim in numbers["control"].values()), numbers["control"]
