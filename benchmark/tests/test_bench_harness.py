"""The benchmark's harness on the CPU: what it finds by name, the names it
may use, the yardstick's arithmetic, and the imports it allows."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import core, inputs, work

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
SPEC = core.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name_from_files(cell):
    found = core.resolve_cell(SPEC, cell)
    assert found["config"]["system"]
    system = core.system_module(found["config"]).System
    assert callable(system)
    for m in found["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)
    names = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and found["per_layer"]


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a mix and a metric added as files and entries."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "systems"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "c.json").write_text(json.dumps({"system": "s"}))
    (here / "traffic" / "t.json").write_text(json.dumps({"sequences": 1}))
    (here / "metrics" / "m.py").write_text("def read(ctx):\n    return 1.0\n")
    (here / "systems" / "s.py").write_text("class System:\n    pass\n")
    spec = {"configs": [{"name": "c", "file": "benchmark/configs/c.json"}],
            "workloads": [{"name": "c.t", "config": "c", "traffic": "t", "chips": 1}],
            "end_to_end": [{"name": "setup_s"}],
            "per_layer": [{"name": "m.t", "workloads": ["c.t"]}]}
    found = core.resolve_cell(spec, "c.t", here)
    assert found["traffic"] == {"sequences": 1}
    assert core.system_module(found["config"], here).System
    assert core.metric_reader("m.t", here).read({}) == 1.0


def test_names_and_units_use_allowed_characters():
    assert core.check_names(SPEC) == []
    assert not core.NAME_RE.match("frames per s") and not core.UNIT_RE.match("µs")
    assert core.UNIT_RE.match("launches/frame") and core.UNIT_RE.match("%")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert all(m["bound"] <= 0.25 for m in e2e.values()) and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert set(c["reduced"]) <= set(core.load_json(ROOT / c["file"])["reduced"])


def _chip_smoke_bound_ms(n: float, extra_ops_per_point: float) -> float:
    """chip_smoke._bound's 3xTF32 bound of n SDF points at the shipped net."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    mlp = chip_smoke._mlp_ops((21, 128, 128, 128), n)
    return chip_smoke._bound(0.0, extra_ops_per_point * n, mlp,
                             tensor_cores=True)["bound_3xtf32_ms"]


@pytest.mark.parametrize("sequences", [1, 4])
def test_work_counts_equal_chip_smokes_bound(sequences):
    mlp = {"max_freqs": 3, "hidden": 128, "depth": 3}
    assert work.mlp_ops_per_point(3, 128, 3) == 71168
    obj = 1e3 * work.least_seconds(**work.obj_energy_work(sequences, 2048, 1024, mlp))
    skin = 1e3 * work.least_seconds(**work.skin_energy_work(sequences, 5120, 778, mlp))
    assert obj == pytest.approx(_chip_smoke_bound_ms(sequences * 2048 * 1024, 0.0), rel=1e-12)
    assert skin == pytest.approx(_chip_smoke_bound_ms(sequences * 5120 * 778, 1239.0),
                                 rel=1e-12)
    assert obj == pytest.approx(0.90455 * sequences, rel=1e-4)
    assert skin == pytest.approx(1.79177 * sequences, rel=1e-4)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_port():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    for path in files:
        tops = {core.top_level(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "hotrack_tpu", "hotrack_tpu_torch"}, path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.obj, benchmark.reference.hand.hand_network, "
            "benchmark.reference.hand.hand_pose, benchmark.reference.hand.hand_shape\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "hotrack_tpu", "hotrack_tpu_torch"}


@pytest.mark.parametrize("name,forbidden", [
    ("hotrack_tpu", True), ("hotrack_tpu.sdf.distill", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("hotrack_tpu_torch", False), ("hotrack_tpu_torch.ops.kernels", False),
    ("jaxtyping", False), ("hotrack_tpu2", False)])
def test_import_check_compares_whole_top_level_names(name, forbidden):
    assert bool(core.forbidden_loaded({name: None})) == forbidden


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell, small):
    found = core.resolve_cell(SPEC, cell)
    config = {**found["config"], **small[cell]["config"]}
    traffic = {**found["traffic"], **small[cell]["traffic"]}
    system = core.system_module(config)
    seed = 2**40 + 17

    def made(s):
        d = system.System(config, traffic, s, torch.device("cpu"))
        d.make_inputs()
        return d

    a, b, c = made(seed), made(seed), made(seed + 1)
    for key in ("volume",):
        assert torch.equal(getattr(a, key), getattr(b, key))
    if cell.startswith("objopt"):
        assert torch.equal(a.clouds, b.clouds) and a.clouds.shape == c.clouds.shape
        assert not torch.equal(a.clouds, c.clouds)
    else:
        assert torch.equal(a.masks, b.masks) and a.masks.shape == c.masks.shape
        assert torch.equal(a.frames[0]["hand_points"], b.frames[0]["hand_points"])
        assert not torch.equal(a.frames[0]["hand_points"], c.frames[0]["hand_points"])


def test_sub_seeds_take_large_seeds():
    assert inputs.sub_seed(2**31 + 5, 1) != inputs.sub_seed(2**31 + 6, 1)
    assert 0 <= inputs.sub_seed(2**70, 3) < 2**63
