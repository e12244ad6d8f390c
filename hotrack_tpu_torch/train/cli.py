"""Command-line entries for training and evaluation (port of
hotrack_tpu/train/cli.py).

    python -m hotrack_tpu_torch.train --config handtracknet_train_SimGrasp.yml \
        [--device cuda|cpu] [--epochs N] [--key/subkey value ...]
    python -m hotrack_tpu_torch.test --config handtracknet_test_SimGrasp.yml \
        [--device cuda|cpu] [--save] [--key/subkey value ...]

Overrides address nested config keys by '/'-path, as in the JAX package. The
device defaults to `cuda`; without a card that raises, it does not carry on
on the CPU. The epoch loop is the JAX package's: train, a test pass per
epoch, loss accumulation, periodic checkpoints. `test` runs single-frame
evaluation (`track: False`), HandTrackNet sequence tracking (`track: hand`),
the full hand pipeline with IKNet and the MANO shape and pose optimisers
(`track: hand_IKNet`, see run_hand_track.py for its keys `sdf_query` and
`hand_energy`) or object tracking by the SDF particle optimiser (`track:
obj_opt`, see run_obj_track.py for `sdf_query` and `obj_energy`).
"""

from __future__ import annotations

import argparse
import logging
import time
from os.path import join as pjoin

import numpy as np
import torch

from ..config import get_config
from ..data import get_dataloader, prepare_batch
from ..utils.dicts import add_dict, cvt_numpy, divide_dict, log_loss_summary
from .trainer import Trainer, pin_fp32


def build_arg_parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default cuda)")
    p.add_argument("--save", action="store_true", default=None,
                   help="dump per-sequence trajectory pickles")
    p.add_argument("--epochs", type=int, default=None, help="override total_epoch")
    return p


def parse_with_overrides(parser: argparse.ArgumentParser, argv=None) -> dict:
    """Known args + arbitrary --key/subkey value overrides."""
    args, unknown = parser.parse_known_args(argv)
    extra = {}
    if len(unknown) % 2:
        raise SystemExit(f"overrides come in --key value pairs, got {unknown}")
    for tok, val in zip(unknown[::2], unknown[1::2]):
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected arg {tok}")
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                pass
        extra[tok[2:]] = val
    d = vars(args)
    epochs = d.pop("epochs", None)
    if epochs is not None:
        extra["total_epoch"] = epochs
    d.update(extra)
    return d


def load_config(argv=None, name: str = "test", save: bool = False) -> dict:
    """The resolved config of a command line (`--config` and overrides), with
    the device defaulted to `cuda`."""
    cfg = get_config(parse_with_overrides(build_arg_parser(name), argv), save=save)
    if cfg.get("device") is None:
        cfg["device"] = "cuda"
    return cfg


def _jitter_cfg(cfg):
    hj = cfg["hand_jitter_cfg"]
    oj = cfg["obj_jitter_cfg"]
    obj = {"rotation": float(np.deg2rad(oj["r"])), "translation": oj["t"],
           "scale": oj["s"]}
    return hj["rand_scale"], hj["rand_type"], obj, oj["type"]


def prepare(trainer: Trainer, raw, generator: torch.Generator, cfg) -> dict:
    """A raw batch of the loader -> the prepared batch on the trainer's
    device, jittered and sampled as the config says."""
    scale, kind, obj, obj_kind = _jitter_cfg(cfg)
    return prepare_batch(trainer.mano, raw, cfg["num_points"], generator=generator,
                         hand_jitter_scale=scale, jitter_kind=kind, obj_jitter=obj,
                         obj_jitter_kind=obj_kind,
                         include_obb=cfg["network"].get("handframe") == "OBB",
                         sample_kind=cfg.get("point_sample", "fps"),
                         device=trainer.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_main(argv=None) -> Trainer:
    """Train as the config says; returns the Trainer, whose `history` holds
    per epoch the mean train and test losses and the seconds of every step
    (batch preparation, and forward + backward + update, each read after a
    device synchronise)."""
    cfg = load_config(argv, "train", save=True)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train")
    pin_fp32()

    seed = int(cfg.get("seed", 0))
    # dropout takes no generator argument in PyTorch: the process-wide
    # generators (CPU and CUDA) are seeded once, here
    torch.manual_seed(seed)
    # jitter and sampling are drawn on the host: the same on every device
    generator = torch.Generator().manual_seed(seed)

    train_loader = get_dataloader(cfg, "train")
    test_loader = get_dataloader(cfg, "test", shuffle=False)
    # iterations per epoch, consumed by the CyclicLR step size
    cfg["dataset_len"] = len(train_loader)
    trainer = Trainer(cfg, cfg["device"])  # initialised from cfg['seed']
    trainer.resume()
    trainer.history = []

    writer = _tb_writer(cfg)
    for epoch in range(trainer.epoch, cfg["total_epoch"]):
        t0 = time.perf_counter()
        total, cnt, data_s, step_s = {}, 0, [], []
        for raw, _ in train_loader:
            t1 = time.perf_counter()
            batch = prepare(trainer, raw, generator, cfg)
            _sync(trainer.device)
            t2 = time.perf_counter()
            loss = cvt_numpy(trainer.update(batch))  # the fetch waits for the device
            t3 = time.perf_counter()
            data_s.append(t2 - t1)
            step_s.append(t3 - t2)
            add_dict(total, loss)
            cnt += 1
        train_avg = divide_dict(total, cnt)
        log.info("epoch %d train (%d it, %.1fs, lr %.3g): %s", epoch, cnt,
                 time.perf_counter() - t0, trainer.lr,
                 {k: round(v, 5) for k, v in train_avg.items()})
        log_loss_summary(total, cnt,
                         lambda k, v: _tb_add(writer, f"train/{k}", v, epoch))

        total, n_test = {}, 0
        for raw, _ in test_loader:
            add_dict(total, cvt_numpy(trainer.test(prepare(trainer, raw, generator, cfg))))
            n_test += 1
        test_avg = divide_dict(total, n_test)
        log.info("epoch %d test: %s", epoch, {k: round(v, 5) for k, v in test_avg.items()})
        log_loss_summary(total, n_test,
                         lambda k, v: _tb_add(writer, f"test/{k}", v, epoch))
        trainer.history.append({"epoch": epoch, "train": train_avg, "test": test_avg,
                                "lr": trainer.lr, "data_seconds": data_s,
                                "step_seconds": step_s})

        trainer.step_epoch()
        if (epoch + 1) % cfg["freq"]["save"] == 0 or epoch + 1 == cfg["total_epoch"]:
            trainer.save()
    return trainer


def _tb_writer(cfg):
    """A TensorBoard writer when tensorboardX is installed, else None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(pjoin(cfg["experiment_dir"], "log"))


def _tb_add(writer, key, value, step):
    if writer is not None:
        writer.add_scalar(key, value, step)


def test_main(argv=None):
    cfg = load_config(argv)
    save_flag = bool(cfg.pop("save", False))
    pin_fp32()
    track = cfg.get("track")
    if not track:
        return _test_single_frame(cfg)
    if track == "obj_opt":
        from .run_obj_track import run_obj_tracking
        return run_obj_tracking(cfg, save_flag)
    from .run_hand_track import TRACK_ROUTES, run_hand_tracking
    if track not in TRACK_ROUTES:
        raise ValueError(f"unknown track={track!r}: the routes are False (single-frame "
                         f"evaluation), obj_opt and {TRACK_ROUTES}")
    return run_hand_tracking(cfg, save_flag)


def _test_single_frame(cfg):
    """Single-frame evaluation of the experiment's checkpoint over the test
    split: (mean losses, stats with the frames per second of wall time with
    and without data preparation)."""
    loader = get_dataloader(cfg, "test", shuffle=False)
    trainer = Trainer(cfg, cfg["device"])
    trainer.resume()
    generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))

    total, cnt, n_batches = {}, 0, 0
    data_time, net_time = 0.0, 0.0
    t0 = time.perf_counter()
    for raw, _ in loader:
        batch = prepare(trainer, raw, generator, cfg)
        _sync(trainer.device)
        t1 = time.perf_counter()
        loss = cvt_numpy(trainer.test(batch))
        _sync(trainer.device)
        t2 = time.perf_counter()
        data_time += t1 - t0
        net_time += t2 - t1
        add_dict(total, loss)
        cnt += batch["hand_points"].shape[0]
        n_batches += 1
        t0 = time.perf_counter()
    avg = divide_dict(total, n_batches)
    fps_all = cnt / max(data_time + net_time, 1e-9)
    fps_net = cnt / max(net_time, 1e-9)
    print(f"frames {cnt}  FPS(all) {fps_all:.1f}  FPS(network) {fps_net:.1f}"
          f"  device {trainer.device}")
    print({k: round(v, 5) for k, v in avg.items()})
    return avg, {"fps_all": fps_all, "fps_network": fps_net, "n_frames": cnt}
