"""The batched hand runner (`--eval_batch_seqs`) prepares its test sequences
chunk by chunk: a chunk's volumes, fits and masks are made after the chunk
before it was tracked, so memory grows with the chunk and not with the test
split. The calls are spied on, with the set-up and the tracker replaced by
cheap stand-ins; the tracking itself is held by test_torch_batched_track.py.
Toy sizes: three 3-frame sequences, 64 points.
"""

import os

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.data.simgrasp import split_dataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.track.types import HandTrackResult
from hotrack_tpu_torch.train import cli, run_hand_track
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from torch_sdf_models import model_arrays

T = 3
ARGS = ["--config", "handopt_test_SimGrasp_synth.yml", "--device", "cpu",
        "--data_cfg/num_frames", str(T), "--pointnet_cfg/camera", "pointnet2_tiny.yml",
        "--num_points", "64", "--network/backbone_out_dim", "48"]


@pytest.fixture(scope="module")
def three_sequences(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chunked"))
    base = generate_simgrasp_dataset(root, num_instances=4, num_frames=T, points_per_part=200)
    split_dataset(os.path.join(base, "splits", "bottle_sim", "seq"),
                  os.path.join(base, "preproc", "bottle_sim", "seq"),
                  ["00000", "00001", "00002"])
    old = os.environ.get("HOTRACK_DATA_ROOT")
    os.environ["HOTRACK_DATA_ROOT"] = root
    yield root
    if old is None:
        os.environ.pop("HOTRACK_DATA_ROOT", None)
    else:
        os.environ["HOTRACK_DATA_ROOT"] = old


def _spy(monkeypatch, events):
    """Replace the runner's set-up and tracker by stand-ins that note their
    calls: (what, the sequence or chunk size)."""
    def volume(cfg, meta0, device):
        events.append(("volume", meta0["file_name"]))
        return torch.zeros(4, 4, 4)

    def distill(volume, scale, generator):
        events.append(("distill", None))
        return distilled_from_numpy(model_arrays(0, widths=(9, 8)))

    def masks(cfg, metas):
        events.append(("masks", metas[0]["file_name"]))
        return np.zeros((len(metas), 1, 1), bool)

    def track(handnet, mano, batch, **kwargs):
        events.append(("track", batch["gt_hand_kp"].shape[0]))
        s, t = batch["gt_hand_kp"].shape[:2]
        eye = torch.eye(3).expand(s, t, 3, 3)
        return HandTrackResult(batch["gt_hand_kp"], batch["gt_hand_kp"], eye,
                               torch.zeros(s, t, 3, 1), eye, torch.zeros(s, t, 3, 1),
                               torch.zeros(s, t, 45), torch.zeros(s, 1, 10))

    monkeypatch.setattr(run_hand_track, "_hand_volume", volume)
    monkeypatch.setattr(run_hand_track, "distill_sdf_volume", distill)
    monkeypatch.setattr(run_hand_track, "load_background_masks", masks)
    monkeypatch.setattr(run_hand_track, "track_hand_sequences_batched", track)


def test_the_batched_runner_prepares_a_chunk_after_tracking_the_one_before(three_sequences,
                                                                           monkeypatch):
    events = []
    _spy(monkeypatch, events)
    _, stats = cli.test_main([*ARGS, "--eval_batch_seqs", "2", "--sdf_query", "distilled"])
    assert stats["n_frames"] == 3 * T
    kinds = [kind for kind, _ in events]
    assert kinds == ["volume", "distill", "masks"] * 2 + ["track"] \
        + ["volume", "distill", "masks", "track"], events
    assert [n for kind, n in events if kind == "track"] == [2, 1]
    # the three sequences, each prepared once
    assert len({name for kind, name in events if kind == "volume"}) == 3


def test_a_sequence_draws_from_its_own_generator():
    a = run_hand_track.sequence_generator(0, 1)
    b = run_hand_track.sequence_generator(0, 1)
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    draws = {(seed, i): torch.rand(3, generator=run_hand_track.sequence_generator(seed, i))
             for seed in (0, 1) for i in (0, 1, 2)}
    assert len({tuple(v.tolist()) for v in draws.values()}) == len(draws)
