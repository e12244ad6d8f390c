"""The port's checkpoint CLI (`python -m hotrack_tpu_torch.convert`) and the
test entry's `--profile`.

The port reads reference `.pt` files natively, so its convert splits a
composed `handnet.` / `IKnet.` checkpoint into the two directories the
runners read, and composes them back (`--export`). Held here:
- a composed file written by the port from two single-net files equals,
  entry for entry and bit for bit, the one the JAX package's exporter
  (hotrack_tpu/utils/torch_export.save_reference_checkpoint) writes from the
  same flax variables; so does each half of a split of it;
- split then compose returns the file it started from, and the nets load
  strictly into the models the config builds;
- a checkpoint of another architecture is refused;
- a split prints, after its paths, the note on the Procrustes solver that
  the JAX CLI prints after a conversion, word for word;
- `--profile DIR` writes a Chrome trace of the evaluation.
"""

import ast
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.models import IKNet as JaxIKNet
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu.utils.torch_export import save_reference_checkpoint as jax_save
from hotrack_tpu_torch import convert
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.train import cli
from hotrack_tpu_torch.train.run_hand_track import load_handnet, load_iknet

CONFIG = "handiknet_test_HO3D.yml"
TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX exporter's files from one set of flax variables of the
    config's nets: HandTrackNet alone, IKNet alone, and both composed
    (epoch 7)."""
    root = tmp_path_factory.mktemp("convert")
    old_root = os.environ.get("HOTRACK_DATA_ROOT")
    os.environ["HOTRACK_DATA_ROOT"] = str(root)
    cfg = cli.load_config(["--config", CONFIG, *TINY])
    # the variables' tree from the nets' shapes alone, filled with seeded
    # numbers: the exporters read the tree, they run no net
    pts, kp = jnp.zeros((1, 64, 3)), jnp.zeros((1, 21, 3))
    hand = JaxHandTrackNet(net_cfg=_freeze(cfg["pointnet"]["camera"]), backbone_out_dim=48)
    rng = np.random.default_rng(0)

    def seeded(shapes):
        return jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)

    hvars = seeded(jax.eval_shape(hand.init, jax.random.PRNGKey(0), pts, kp, kp[:, :6]))
    ivars = seeded(jax.eval_shape(JaxIKNet().init, jax.random.PRNGKey(1), kp, kp[:, :6]))
    out = {"root": str(root), "cfg": cfg}
    for name, kwargs in (("hand", {"handnet": hvars}), ("ik", {"iknet": ivars}),
                         ("both", {"handnet": hvars, "iknet": ivars})):
        out[name] = jax_save(str(root / f"{name}.pt"), epoch=7, **kwargs)
    yield out
    if old_root is None:
        os.environ.pop("HOTRACK_DATA_ROOT", None)
    else:
        os.environ["HOTRACK_DATA_ROOT"] = old_root


def _same_file(a, b):
    fa, fb = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    assert fa["epoch"] == fb["epoch"] and set(fa["model"]) == set(fb["model"])
    for k, v in fa["model"].items():
        assert v.dtype == fb["model"][k].dtype, k
        assert torch.equal(v, fb["model"][k]), k


def _argv(*extra):
    return ["--config", CONFIG, *extra, *TINY]


def test_split_gives_the_jax_exporters_single_files(files, tmp_path):
    written = convert.main(_argv("--ckpt", files["both"], "--experiment_dir",
                                 str(tmp_path / "hand"), "--IKNet_dir", str(tmp_path / "ik")))
    assert written == [str(tmp_path / "hand" / "ckpt" / "model_0007.pt"),
                       str(tmp_path / "ik" / "ckpt" / "model_0007.pt")]
    _same_file(written[0], files["hand"])
    _same_file(written[1], files["ik"])
    # the runners load them, strictly
    cfg = dict(files["cfg"], experiment_dir=str(tmp_path / "hand"),
               IKNet_dir=str(tmp_path / "ik"))
    load_handnet(cfg, "cpu")
    load_iknet(cfg, "cpu")


@pytest.mark.parametrize("name,net", [("hand", "handnet"), ("ik", "iknet")])
def test_split_takes_a_single_nets_plain_file(files, tmp_path, name, net):
    """A single net's file with plain keys goes where the JAX loader routes
    it (`bhand.` keys to HandTrackNet, `linear.` keys to IKNet), bitwise."""
    from hotrack_tpu.utils.torch_convert import load_reference_checkpoint as jax_load
    routed = jax_load(files[name], files["cfg"]["pointnet"]["camera"], 48)
    assert set(routed) == {net}
    dirs = {"handnet": tmp_path / "hand", "iknet": tmp_path / "ik"}
    written = convert.main(_argv("--ckpt", files[name], "--experiment_dir",
                                 str(dirs["handnet"]), "--IKNet_dir", str(dirs["iknet"])))
    assert written == [str(dirs[net] / "ckpt" / "model_0007.pt")]
    _same_file(written[0], files[name])
    cfg = dict(files["cfg"], experiment_dir=str(dirs["handnet"]), IKNet_dir=str(dirs["iknet"]))
    (load_handnet if net == "handnet" else load_iknet)(cfg, "cpu")


def _jax_cli_note() -> str:
    """The note hotrack_tpu/convert.py's main prints: the string constant of
    its print call that starts with "NOTE:", read from the source."""
    import hotrack_tpu.convert as jax_convert
    with open(jax_convert.__file__) as f:
        tree = ast.parse(f.read())
    notes = [node.args[0].value for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
             and node.args and isinstance(node.args[0], ast.Constant)
             and str(node.args[0].value).startswith("NOTE:")]
    assert len(notes) == 1, notes
    return notes[0]


def test_split_prints_the_jax_clis_solver_note_after_the_paths(files, tmp_path, capsys):
    written = convert.main(_argv("--ckpt", files["both"], "--experiment_dir",
                                 str(tmp_path / "hand"), "--IKNet_dir", str(tmp_path / "ik")))
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3:] == [*(f"split -> {path}" for path in written), _jax_cli_note()]
    # a compose writes one file and prints no note
    convert.main(_argv("--export", str(tmp_path / "both.pt"), "--experiment_dir",
                       str(tmp_path / "hand"), "--IKNet_dir", str(tmp_path / "ik")))
    assert "NOTE:" not in capsys.readouterr().out


def test_split_refuses_a_file_of_neither_net(files, tmp_path):
    state = torch.load(files["ik"], weights_only=True)
    state["model"] = {"other." + k: v for k, v in state["model"].items()}
    path = str(tmp_path / "other.pt")
    torch.save(state, path)
    with pytest.raises(SystemExit, match="no handnet. or IKnet. entries"):
        convert.main(_argv("--ckpt", path, "--experiment_dir", str(tmp_path / "h"),
                           "--IKNet_dir", str(tmp_path / "i")))


def test_compose_gives_the_jax_exporters_composed_file(files, tmp_path):
    for name in ("hand", "ik"):
        os.makedirs(tmp_path / name / "ckpt")
        os.link(files[name], tmp_path / name / "ckpt" / "model_0007.pt")
    out = str(tmp_path / "composed.pt")
    assert convert.main(_argv("--export", out, "--experiment_dir", str(tmp_path / "hand"),
                              "--IKNet_dir", str(tmp_path / "ik"))) == [out]
    _same_file(out, files["both"])
    # one net alone: its plain keys
    alone = str(tmp_path / "alone.pt")
    convert.main(_argv("--export", alone, "--IKNet_dir", str(tmp_path / "ik")))
    _same_file(alone, files["ik"])


def test_split_and_compose_round_trip(files, tmp_path):
    """Names without a separator resolve under <root>/exps, as the config
    resolves experiment directories."""
    convert.main(_argv("--ckpt", files["both"], "--experiment_dir", "rt_hand", "--IKNet_dir",
                       "rt_ik", "--epoch", "3"))
    exps = os.path.join(files["root"], "exps")
    assert os.path.exists(os.path.join(exps, "rt_hand", "ckpt", "model_0003.pt"))
    back = str(tmp_path / "back.pt")
    convert.main(_argv("--export", back, "--experiment_dir", "rt_hand", "--IKNet_dir",
                       "rt_ik", "--epoch", "3"))
    a = torch.load(back, weights_only=True)
    b = torch.load(files["both"], weights_only=True)
    assert a["epoch"] == 3 and set(a["model"]) == set(b["model"])
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])


def test_convert_refuses_what_does_not_fit(files, tmp_path):
    with pytest.raises(SystemExit, match="does not fit"):
        convert.main(["--config", CONFIG, "--ckpt", files["both"], "--experiment_dir",
                      str(tmp_path / "h"), "--IKNet_dir", str(tmp_path / "i"),
                      "--pointnet_cfg/camera", "pointnet2_tiny.yml",
                      "--network/backbone_out_dim", "96"])
    with pytest.raises(SystemExit):
        convert.main(["--config", CONFIG])          # neither --ckpt nor --export
    with pytest.raises(SystemExit, match="no checkpoint"):
        convert.main(_argv("--export", str(tmp_path / "x.pt"), "--experiment_dir",
                           str(tmp_path / "empty")))


def test_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    generate_simgrasp_dataset(root, num_instances=2, num_frames=2, points_per_part=200)
    monkeypatch.setenv("HOTRACK_DATA_ROOT", root)
    trace_dir = str(tmp_path / "trace")
    avg, stats = cli.test_main(["--config", "handtracknet_test_SimGrasp.yml", "--device", "cpu",
                                "--profile", trace_dir, *TINY])
    assert stats["n_frames"] == 2 and all(np.isfinite(v) for v in avg.values())
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)   # the evaluation's operators
