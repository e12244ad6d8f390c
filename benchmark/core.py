"""What the harness reads from files, by name alone.

`BENCHMARK.json` at the checkout's root names the cells; each cell names a
configuration (`configs/<name>.json`, whose `system` key names the system module
`systems/<system>.py`) and a traffic mix (`traffic/<name>.json`); each
per-layer metric is a reader `metrics/<name>.py` with a `read(ctx)`. A
metric named `<quantity>.<suffix>` (`mfu.hand`) is the quantity's split for
the cells that report another end-to-end metric; without a reader of its
own it takes the quantity's, `metrics/<quantity>.py`. A later change adds a cell,
a configuration, a mix or a metric as new files and entries: nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

# top-level module names that may not be loaded in a run of the port
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hotrack_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r}")


def resolve_cell(spec: dict, workload: str, here: Path = HERE,
                 traffic_name: str | None = None) -> dict:
    """The cell `workload` with its configuration, traffic mix (or the mix
    `traffic_name` instead) and metrics, each read from its own file."""
    cell = find(spec["workloads"], workload, "workload")
    config_entry = find(spec["configs"], cell["config"], "configuration")
    config = load_json(here.parent / config_entry["file"])
    traffic = load_json(here / "traffic" / f"{traffic_name or cell['traffic']}.json")

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "cell": cell, "config": config, "traffic": traffic,
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def load_module(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def system_module(config: dict, here: Path = HERE) -> ModuleType:
    return load_module(here / "systems" / f"{config['system']}.py",
                       f"benchmark_system_{config['system']}")


def base_name(name: str) -> str:
    """A metric's quantity: its name up to the first dot (`mfu.hand` is the
    quantity `mfu` in the cells that report `frames_per_s.hand`)."""
    return name.split(".", 1)[0]


def metric_reader(name: str, here: Path = HERE) -> ModuleType:
    """metrics/<name>.py, or else the reader of its quantity,
    metrics/<base name>.py."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{base_name(name)}.py"
    return load_module(path, "benchmark_metric_" + re.sub(r"\W", "_", path.stem))


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose whole top-level name is a forbidden one:
    `hotrack_tpu` is, `hotrack_tpu_torch` is not."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if top_level(name) in FORBIDDEN_MODULES)


def check_names(spec: dict) -> list:
    """Every name and unit of the spec that breaks the allowed characters."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[key]:
            if not NAME_RE.match(entry["name"]):
                bad.append(entry["name"])
            if "unit" in entry and not UNIT_RE.match(entry["unit"]):
                bad.append(entry["unit"])
            for k in ("config", "traffic"):
                if k in entry and not NAME_RE.match(entry[k]):
                    bad.append(entry[k])
            for k in entry.get("reduced", ()):
                if not NAME_RE.match(k):
                    bad.append(k)
    return bad
