"""Split and compose reference-format checkpoints (port of
hotrack_tpu/convert.py).

The port reads and writes the reference's `.pt` files itself
({'model': state dict, 'epoch', 'iteration'}), so what is left to convert is
the layout. A tracking graph's checkpoint holds HandTrackNet under
`handnet.` and IKNet under `IKnet.`; the tracking runners read each net from
its own directory (`<experiment_dir>/ckpt`, `<IKNet_dir>/ckpt`).

Split a composed checkpoint into the two directories (or put a single net's
file with plain keys, as a single net's training writes it, into its own):

    python -m hotrack_tpu_torch.convert --ckpt <composed.pt> \
        --config handopt_test_HO3D.yml [--experiment_dir OUT] [--IKNet_dir OUT_IK] \
        [--epoch N]

Compose the two directories' checkpoints into one file:

    python -m hotrack_tpu_torch.convert --export <out.pt> \
        --config handopt_test_HO3D.yml [--experiment_dir A] [--IKNet_dir B] [--epoch N]

Entries are carried over as they are, so a split and a compose return the
file they started from. Each net is loaded into the model the config builds
(`--key/subkey value` overrides as in the test entry), strictly, before
anything is written: a checkpoint of another architecture is refused. A
bare directory name lies under <root>/exps/, as the config resolves it.
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin

import torch

PREFIXES = {"handnet": "handnet.", "iknet": "IKnet."}
# a file with neither prefix holds one net with plain keys, as a single
# net's training writes it; its keys say which net (the JAX loader's rule)
PLAIN_MARKS = {"handnet": "bhand.", "iknet": "linear."}


def _parse(argv):
    p = argparse.ArgumentParser("convert")
    p.add_argument("--ckpt", type=str, default=None,
                   help="a composed handnet./IKnet. checkpoint to split, or one "
                        "net's with plain keys")
    p.add_argument("--export", type=str, default=None, metavar="OUT_PT",
                   help="compose the checkpoints of --experiment_dir (HandTrackNet) and "
                        "--IKNet_dir (IKNet) into this file")
    p.add_argument("--config", type=str, required=True,
                   help="experiment yml describing the nets")
    p.add_argument("--experiment_dir", type=str, default=None,
                   help="HandTrackNet's directory (split: default <experiment_dir of the "
                        "config>_converted)")
    p.add_argument("--IKNet_dir", type=str, default=None,
                   help="IKNet's directory (split: default <experiment_dir of the "
                        "config>_converted_iknet)")
    p.add_argument("--epoch", type=int, default=None,
                   help="the epoch: split, the one to stamp (default the file's); "
                        "compose, the one to read (default the latest)")
    args, unknown = p.parse_known_args(argv)
    if (args.ckpt is None) == (args.export is None):
        p.error("exactly one of --ckpt (split) or --export OUT_PT (compose) is required")
    return args, unknown


def _check_loads(cfg: dict, name: str, state: dict, what: str) -> None:
    """Load `state` into the config's net `name` (handnet or iknet),
    strictly, as the runners load it."""
    from .train.run_hand_track import build_handnet, build_iknet
    from .utils.convert import load_reference_state
    try:
        load_reference_state((build_handnet if name == "handnet" else build_iknet)(cfg, "cpu"),
                             state)
    except RuntimeError as e:
        raise SystemExit(f"{what} does not fit the net the config builds "
                         f"(check backbone_out_dim, the pointnet config, use_attention): "
                         f"{e}") from e


def split(ckpt: str, cfg: dict, experiment_dir: str, iknet_dir: str,
          epoch: int | None = None) -> list:
    """Write each net of a composed checkpoint into <dir>/ckpt/model_%04d.pt
    of its directory, with plain keys. A file without either prefix is one
    net's with plain keys: HandTrackNet's where a key starts with `bhand.`,
    IKNet's where one starts with `linear.`. Returns the paths written."""
    raw = torch.load(ckpt, map_location="cpu", weights_only=True)
    state = raw.get("model", raw)
    epoch = int(raw.get("epoch", 0)) if epoch is None else int(epoch)
    written = []
    for name, out_dir in (("handnet", experiment_dir), ("iknet", iknet_dir)):
        prefix = PREFIXES[name]
        part = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if not part and any(k.startswith(PLAIN_MARKS[name]) for k in state):
            part = state  # a single net's file with plain keys
        if not part:
            continue
        _check_loads(cfg, name, part, f"{ckpt}'s {prefix} entries")
        path = pjoin(out_dir, "ckpt", f"model_{epoch:04d}.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": part, "epoch": epoch, "iteration": int(raw.get("iteration", 0))},
                   path)
        written.append(path)
    if not written:
        raise SystemExit(f"no handnet. or IKnet. entries in {ckpt}")
    return written


def compose(out: str, cfg: dict, experiment_dir: str | None, iknet_dir: str | None,
            epoch: int | None = None) -> str:
    """One checkpoint of the nets of the given directories: both under their
    prefixes, one with plain keys. It carries HandTrackNet's epoch where
    both are given (a warning where IKNet's differs)."""
    from .train.run_hand_track import find_checkpoint
    dirs = {"handnet": experiment_dir, "iknet": iknet_dir}
    parts, epochs = {}, {}
    for name, d in dirs.items():
        if d is None:
            continue
        path = find_checkpoint(dict(cfg, resume_epoch=epoch), d)
        if path is None:
            raise SystemExit(f"no checkpoint under {d}/ckpt")
        raw = torch.load(path, map_location="cpu", weights_only=True)
        state = raw.get("model", raw)
        state = {k[len(PREFIXES[name]):]: v for k, v in state.items()
                 if k.startswith(PREFIXES[name])} or state
        _check_loads(cfg, name, state, path)
        parts[name], epochs[name] = state, int(raw.get("epoch", 0))
    if not parts:
        raise SystemExit("--export needs --experiment_dir and/or --IKNet_dir")
    if len(parts) == 2:
        model = {PREFIXES[name] + k: v for name in ("handnet", "iknet")
                 for k, v in parts[name].items()}
        stamp = epochs["handnet"]
        if epochs["handnet"] != epochs["iknet"]:
            print(f"WARNING: HandTrackNet epoch {epochs['handnet']} != IKNet epoch "
                  f"{epochs['iknet']}; the composed checkpoint carries HandTrackNet's")
    else:
        (name, model), = parts.items()
        stamp = epochs[name]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({"model": model, "epoch": stamp, "iteration": 0}, out)
    return out


def main(argv=None) -> list:
    from .train.cli import parse_with_overrides
    from .config import get_config
    args, unknown = _parse(argv)
    overrides = parse_with_overrides(argparse.ArgumentParser("overrides"), unknown)
    cfg = get_config({"config": args.config, **overrides}, save=False)

    def resolve(name):
        return name if os.sep in name else pjoin(cfg["root_dir"], "exps", name)

    if args.export is not None:
        out = compose(args.export, cfg,
                      resolve(args.experiment_dir) if args.experiment_dir else None,
                      resolve(args.IKNet_dir) if args.IKNet_dir else None, args.epoch)
        print(f"composed -> {out}")
        return [out]
    written = split(args.ckpt, cfg,
                    resolve(args.experiment_dir) if args.experiment_dir
                    else cfg["experiment_dir"] + "_converted",
                    resolve(args.IKNet_dir) if args.IKNet_dir
                    else cfg["experiment_dir"] + "_converted_iknet", args.epoch)
    for path in written:
        print(f"split -> {path}")
    return written


if __name__ == "__main__":
    main()
