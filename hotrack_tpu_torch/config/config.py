"""Three-tier YAML config system (experiment / data / pointnet).

Carried over from hotrack_tpu/config/config.py with only the docstrings
changed, so the port imports nothing of the JAX package: load
configs/all_config/<name>.yml (the YAML tree both packages read), apply CLI
overrides addressed by '/'-separated key paths, merge the data config and the
per-key pointnet configs, resolve experiment directories under
<root>/exps/..., save the merged config into the experiment dir, and inject
num_parts / obj_sym from the data config.

The data root defaults to ./data and can be set with HOTRACK_DATA_ROOT;
mano_root falls back to None (synthetic rig) when the licensed asset tree is
absent.
"""

from __future__ import annotations

import os
from os.path import join as pjoin

import yaml

CONFIG_BASE = pjoin(os.path.dirname(__file__), "..", "..", "configs")


def overwrite_config(cfg: dict, key: str, key_path, value):
    """Override a nested key addressed by a '/'-split path."""
    cur = key_path[0]
    if len(key_path) == 1:
        old = cfg.get(cur)
        if old != value:
            print(f"{key} (originally {old}) overwritten by arg {value}")
            cfg[cur] = value
    else:
        cfg.setdefault(cur, {})
        overwrite_config(cfg[cur], key, key_path[1:], value)


def _load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def ensure_dirs(*paths):
    for p in paths:
        os.makedirs(p, exist_ok=True)


def get_config(args, save: bool = True, config_base: str | None = None) -> dict:
    """args: argparse.Namespace (or dict) with at least 'config'; any other
    non-None entry overrides the YAML by '/'-path."""
    base = os.path.abspath(config_base or CONFIG_BASE)
    args = dict(vars(args)) if not isinstance(args, dict) else dict(args)
    cfg = _load_yaml(pjoin(base, "all_config", args.pop("config")))

    # '--data_cfg/<key>' paths override the data config (loaded below);
    # everything else overrides the experiment config
    data_overrides = {k: args.pop(k) for k in list(args)
                      if k.startswith("data_cfg/")}
    for key, item in args.items():
        if item is not None:
            overwrite_config(cfg, key, key.split("/"), item)

    data_cfg = _load_yaml(pjoin(base, "data_config", cfg["data_config"]))
    for key, item in data_overrides.items():
        if item is not None:
            overwrite_config(data_cfg, key, key.split("/")[1:], item)

    cfg["pointnet"] = {
        key: _load_yaml(pjoin(base, "pointnet_config", value))
        for key, value in cfg.get("pointnet_cfg", {}).items()
    }

    root = os.environ.get("HOTRACK_DATA_ROOT", "data")
    cfg["root_dir"] = root
    if "save_dir" not in cfg:
        cfg["save_dir"] = pjoin(root, "exps", cfg["experiment_dir"], "results")
    else:
        cfg["save_dir"] = pjoin(root, "exps", cfg["save_dir"], "results")
    cfg["experiment_dir"] = pjoin(root, "exps", cfg["experiment_dir"])
    if "IKNet_dir" in cfg:
        cfg["IKNet_dir"] = pjoin(root, "exps", cfg["IKNet_dir"])
    if "pred_obj_pose_dir" in cfg:
        cfg["pred_obj_pose_dir"] = pjoin(root, "exps", cfg["pred_obj_pose_dir"],
                                         "results")
    ensure_dirs(cfg["save_dir"], cfg["experiment_dir"])

    if save:
        with open(pjoin(cfg["experiment_dir"], "config.yml"), "w") as f:
            yaml.dump(cfg, f, default_flow_style=False)
        with open(pjoin(cfg["experiment_dir"], cfg["data_config"]), "w") as f:
            yaml.dump(data_cfg, f, default_flow_style=False)

    obj_cat = cfg["obj_category"]
    first = obj_cat[0] if isinstance(obj_cat, list) else obj_cat
    cfg["num_parts"] = data_cfg[first]["num_parts"]
    cfg["obj_sym"] = data_cfg[first]["sym"]

    cfg["data_cfg"] = data_cfg
    cfg["data_cfg"]["basepath"] = pjoin(root, data_cfg["basepath"])

    mano_root = "third_party/mano/models"
    cfg["mano_root"] = mano_root if os.path.isdir(mano_root) else None
    return cfg
