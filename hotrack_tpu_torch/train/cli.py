"""Command-line entry for evaluation (port of hotrack_tpu/train/cli.py:test_main).

    python -m hotrack_tpu_torch.test --config handtracknet_test_SimGrasp.yml \
        [--device cuda|cpu] [--save] [--key/subkey value ...]

Overrides address nested config keys by '/'-path, as in the JAX package.
Only hand tracking (track: hand) is ported; the other routes raise.
"""

from __future__ import annotations

import argparse

from ..config import get_config


def build_arg_parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default cuda)")
    p.add_argument("--save", action="store_true", default=None,
                   help="dump per-sequence trajectory pickles")
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
    d.update(extra)
    return d


def load_config(argv=None) -> dict:
    """The resolved config of a `test` command line (`--config` and overrides)."""
    return get_config(parse_with_overrides(build_arg_parser("test"), argv),
                      save=False)


def test_main(argv=None):
    cfg = load_config(argv)
    save_flag = bool(cfg.pop("save", False))
    if cfg.get("device") is None:
        cfg["device"] = "cuda"
    track = cfg.get("track")
    if track != "hand":
        raise NotImplementedError(
            f"track={track!r} is not ported yet: only HandTrackNet sequence "
            f"tracking (track: hand) is; see ROADMAP.md, queue 1")
    from .run_hand_track import run_hand_tracking
    return run_hand_tracking(cfg, save_flag)
