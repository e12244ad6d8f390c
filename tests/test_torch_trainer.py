"""Port parity for the training slice: the port-owned flax exporters, the
learning-rate and BN-momentum schedules, and the train step of HandTrackNet
and IKNet (hotrack_tpu_torch/train/trainer.py) against the JAX package's
Trainer, on the same weights (flax -> port), the same prepared batches and
with dropout off on both sides (`flax.linen.Dropout` is patched to the
identity in the test; nothing in the JAX package changes).

The step is compared twice. In float64 on both sides (`step64`) the two
packages compute the same function to 1e-12, so losses, every gradient, the BN
statistics, the weights after one Adam step and the loss over ten steps are
held at bounds that a wrong loss weight, BN momentum, tie rule or optimizer
constant cannot pass. In float32 (`step`) the forwards agree to 1e-5 and ReLU
units within that of 0 take different branches, so that run is a loose sanity
bound on the shipped precision (ROADMAP.md, queue 3).

Sizes: pointnet2_tiny.yml, 64 points, backbone_out_dim 48, batch 4; IKNet at
width 64. Tolerances are stated where they are used.
"""

import contextlib
import os
import re
from unittest import mock

import numpy as np
import flax.linen
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from hotrack_tpu.models import IKNet as JaxIKNet
from hotrack_tpu.train import trainer as jtrainer
from hotrack_tpu.utils import torch_export as jax_export
from hotrack_tpu_torch.data import SequenceData
from hotrack_tpu_torch.data.pipeline import prepare_batch
from hotrack_tpu_torch.data.simgrasp import SimGraspDataset
from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import IKNet
from hotrack_tpu_torch.train import trainer as ttrainer
from hotrack_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_POINTS, BATCH, N_STEPS = 64, 4, 10
LR = 1e-4
IKNET_WIDTH = 64


def _tiny_net_cfg():
    with open(os.path.join(REPO, "configs", "pointnet_config", "pointnet2_tiny.yml")) as f:
        return yaml.safe_load(f)


def _trainer_cfg(exp_dir, net_type: str) -> dict:
    """The shipped SimGrasp training hyperparameters at the tiny width."""
    cfg = {
        "device": "cpu", "track": False, "seed": 0, "mano_root": None,
        "experiment_dir": str(exp_dir),
        "optimizer": "Adam", "learning_rate": LR, "weight_decay": 1e-4,
        "lr_policy": "step", "lr_step_size": 20, "lr_gamma": 0.5,
        "lr_clip": 1e-5, "warm_up": 0, "total_epoch": 300,
        "momentum_original": 0.1, "momentum_decay": 0.5,
        "momentum_step_size": 20, "momentum_min": 0.01, "weight_init": "xavier",
        "pointnet": {"camera": _tiny_net_cfg()},
    }
    if net_type == "HandTrackNet":
        cfg["network"] = {"type": "HandTrackNet", "handframe": "kp",
                          "backbone_out_dim": 48,
                          "loss_weight": {"hand_pred_kp_loss": 10, "hand_pred_r_loss": 1,
                                          "hand_pred_t_loss": 1}}
    else:
        cfg["network"] = {"type": "iknet", "iknetframe": "kp",
                          "loss_weight": {"quat_loss": 1}}
    return cfg


class _IdentityDropout:
    """flax.linen.Dropout stand-in: train-time dropout off on the JAX side, as
    `p = 0` turns it off on the torch side."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, x, *a, **k):
        return x


@contextlib.contextmanager
def _no_jax_dropout():
    with mock.patch.object(flax.linen, "Dropout", _IdentityDropout):
        yield


@contextlib.contextmanager
def _jax_float64():
    """The JAX package in float64: x64 on, and `jnp.float32`, to which its
    modules cast what goes into their norms, stands for float64 while it is
    traced (a patch in the test, like Dropout's)."""
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _numpy_variables(jtr, example, seed):
    """Seeded flax variables of the trainer's model without compiling its
    init: the shapes from `jax.eval_shape`, the values from numpy (xavier
    normal kernels, zero biases, unit norm scales, BN statistics 0 / 1)."""
    shapes = jax.eval_shape(lambda: jtr._init_variables(jax.random.PRNGKey(0), example))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in, fan_out = int(np.prod(leaf.shape[:-1])), leaf.shape[-1]
            std = np.sqrt(2.0) * np.sqrt(2.0 / (fan_in + fan_out))
            return (rng.randn(*leaf.shape) * std).astype(np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(leaf.shape, np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def _batches(root):
    """N_STEPS prepared batches of BATCH frames: the port's prepare_batch on
    the CPU (keypoint noise drawn with numpy), and the same arrays for JAX."""
    generate_simgrasp_dataset(root, num_instances=2, num_frames=BATCH * N_STEPS,
                              points_per_part=300)
    dcfg = {"data_cfg": {"basepath": os.path.join(root, "SimGrasp"),
                         "bottle_sim": {"num_parts": 1}},
            "num_points": NUM_POINTS, "obj_category": ["bottle_sim"], "seed": 0}
    raw, _ = SequenceData(SimGraspDataset(dcfg, "test"), BATCH * N_STEPS)[0]
    noise = torch.from_numpy(np.random.RandomState(1).randn(BATCH * N_STEPS, 21, 3)
                             .astype(np.float32))
    full = prepare_batch(synthetic_mano_model(), raw, NUM_POINTS,
                         hand_jitter_scale=0.02, kp_noise=noise)

    def cut(i, conv):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        return {"hand_points": conv(full["hand_points"][sl]),
                "jittered_hand_kp": conv(full["jittered_hand_kp"][sl]),
                "gt_hand_kp": conv(full["gt_hand_kp"][sl]),
                "gt_hand_pose": {
                    "palm_template": conv(full["gt_hand_pose"]["palm_template"][sl]),
                    "mano_pose": conv(full["gt_hand_pose"]["mano_pose"][sl])}}

    tb = [cut(i, lambda t: t.clone()) for i in range(N_STEPS)]
    jb = [cut(i, lambda t: jnp.asarray(t.numpy())) for i in range(N_STEPS)]
    return jb, tb


def _to_port_fn(frm, stats, dtype):
    """flax tree of the parameters' structure (parameters, gradients, a
    mask) -> {port parameter name: tensor}, through the port's exporter."""
    def to_port(tree):
        sd = frm(tree, stats, dtype)
        return {k: v for k, v in sd.items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    return to_port


def _setup(tmp, net_type, dtype=torch.float32):
    """Both trainers on the same initial weights and batches, of `dtype`
    (float64: call it under `_jax_float64`)."""
    jb, tb = _batches(os.path.join(str(tmp), "data"))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    jb = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), np_dtype), jb)
    tb = jax.tree.map(lambda t: t.to(dtype), tb)
    cfg = _trainer_cfg(os.path.join(str(tmp), "exp"), net_type)
    with _no_jax_dropout():
        jtr = jtrainer.Trainer(cfg)
        if net_type == "iknet":  # neither trainer reads a width from the config
            jtr.model = JaxIKNet(width=IKNET_WIDTH)
        params0, stats0 = jax.tree.map(lambda a: a.astype(np_dtype),
                                       _numpy_variables(jtr, jb[0], seed=0))
    jtr.state = jtrainer.TrainState(
        jax.tree.map(jnp.asarray, params0), jax.tree.map(jnp.asarray, stats0),
        jtr.optimizer.init(params0), jnp.asarray(0), jnp.asarray(0))
    frm = (convert.handtracknet_state_dict_from_flax if net_type == "HandTrackNet"
           else convert.iknet_state_dict_from_flax)
    ttr = ttrainer.Trainer(cfg, "cpu")
    if net_type == "iknet":
        ttr.model = IKNet(width=IKNET_WIDTH)
        ttr.optimizer = ttrainer.make_optimizer(cfg, ttr.model.parameters())
        ttr._apply_schedules()
    ttr.model.to(dtype)
    ttr.model.load_state_dict(frm(params0, stats0, dtype), strict=True)
    for m in ttr.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return {"cfg": cfg, "jtr": jtr, "ttr": ttr, "jbatches": jb, "tbatches": tb,
            "params0": params0, "stats0": stats0,
            "to_port": _to_port_fn(frm, stats0, dtype),
            "from_flax": lambda params, stats: frm(params, stats, dtype)}


def _jax_loss_and_grads(jtr, jbatch):
    with _no_jax_dropout():
        loss_fn = jtr._make_loss_fn(jbatch, jtr.state.batch_stats,
                                    jtrainer.bn_momentum_schedule(jtr.cfg, 0),
                                    jax.random.PRNGKey(0))
        return jax.value_and_grad(loss_fn, has_aux=True)(jtr.state.params)


def _port_grads(ttr, tbatch):
    """Train-mode forward + backward of the port (no optimizer step):
    (loss dict, {parameter name: grad or None})."""
    ttr.model.train()
    loss_dict = ttr._losses(tbatch)
    total, loss_dict = ttrainer.summarize_losses(loss_dict, ttr.loss_weights)
    ttr.optimizer.zero_grad(set_to_none=True)
    total.backward()
    return ({k: v.detach() for k, v in loss_dict.items()},
            {k: (None if p.grad is None else p.grad.clone())
             for k, p in ttr.model.named_parameters()})


# ---------------------------------------------------------------- exporter

def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: rng.randn(*np.shape(a)).astype(np.float32), tree)


@pytest.mark.parametrize("net_type", ["HandTrackNet", "iknet"])
def test_exporter_copy_matches_the_jax_package(tmp_path, net_type):
    """The port's own export_handtracknet / export_iknet give, on a seeded
    flax tree, every key and every array of the JAX package's exporter,
    bit-equal."""
    cfg = _trainer_cfg(tmp_path, net_type)
    jtr = jtrainer.Trainer(cfg)
    rng = np.random.RandomState(0)
    kp = jnp.asarray(rng.randn(2, 21, 3).astype(np.float32) * 0.04)
    example = {"hand_points": jnp.asarray(rng.randn(2, NUM_POINTS, 3).astype(np.float32) * 0.05),
               "jittered_hand_kp": kp,
               "gt_hand_pose": {"palm_template": kp[:, :6]}}
    params, stats = _numpy_variables(jtr, example, seed=0)
    params, stats = _random_like(params, rng), _random_like(stats, rng)
    name = "export_handtracknet" if net_type == "HandTrackNet" else "export_iknet"
    want = getattr(jax_export, name)(params, stats)
    got = getattr(convert, name)(params, stats)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_imports_nothing_of_the_jax_package():
    """No module of the port, and neither chip_smoke.py nor a profile script
    of the port, names jax, flax or hotrack_tpu in an import statement; and a
    data-parallel rank spawned by train/dp.py imports none of them."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|hotrack_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
              if n.startswith("profile_torch_")]
    for d, _, names in os.walk(os.path.join(REPO, "hotrack_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 52
    walked = {os.path.relpath(f, REPO)[:-3].replace(os.sep, ".") for f in files}
    assert walked >= {"scripts.profile_torch_obj", "hotrack_tpu_torch.opt.particle",
                      "hotrack_tpu_torch.opt.obj_pose", "hotrack_tpu_torch.ops.sdf_mlp",
                      "hotrack_tpu_torch.ops.obj_energy", "hotrack_tpu_torch.sdf.distill",
                      "hotrack_tpu_torch.sdf.volume", "hotrack_tpu_torch.sdf.decoder",
                      "hotrack_tpu_torch.sdf.assets", "hotrack_tpu_torch.track.obj",
                      "hotrack_tpu_torch.train.run_obj_track",
                      "hotrack_tpu_torch.pose.metrics", "hotrack_tpu_torch.pose.part_dof",
                      "scripts.profile_torch_hand", "hotrack_tpu_torch.opt.hand_shape",
                      "hotrack_tpu_torch.opt.hand_pose", "hotrack_tpu_torch.ops.mask_lookup",
                      "hotrack_tpu_torch.ops.hand_energy",
                      "hotrack_tpu_torch.ops.hand_energy_skin",
                      "hotrack_tpu_torch.track.hand",
                      "hotrack_tpu_torch.train.run_hand_track",
                      "hotrack_tpu_torch.sdf.mesh", "hotrack_tpu_torch.opt.shape_update",
                      "hotrack_tpu_torch.pose.pose_fit", "hotrack_tpu_torch.pose.bbox",
                      "hotrack_tpu_torch.models.losses",
                      "hotrack_tpu_torch.nn.point_transformer",
                      "hotrack_tpu_torch.train.dp", "hotrack_tpu_torch.nn.global_batch",
                      "hotrack_tpu_torch.track.shards"}
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
    from hotrack_tpu_torch.train import dp
    infos = dp.run_ranks(dp.rank_info, 2, "cpu", timeout_s=120.0)
    assert [i["rank"] for i in infos] == [0, 1] and infos[1]["world_seen"] == 2
    child = infos[1]["modules"]
    assert "hotrack_tpu_torch.train.dp" in child
    jaxish = [m for m in child if m in ("jax", "hotrack_tpu")
              or m.startswith(("jax.", "jaxlib", "flax", "optax", "hotrack_tpu."))]
    assert not jaxish, jaxish


# --------------------------------------------------------------- schedules

_SHIPPED = {"learning_rate": 1e-4, "lr_policy": "step", "lr_gamma": 0.5,
            "lr_step_size": 20, "lr_clip": 1e-5, "warm_up": 0, "total_epoch": 300,
            "momentum_original": 0.1, "momentum_decay": 0.5, "momentum_step_size": 20,
            "momentum_min": 0.01}
_SCHEDULE_CFGS = {
    "shipped": _SHIPPED,
    "cyclic": {**_SHIPPED, "lr_policy": "CyclicLR", "total_epoch": 60, "dataset_len": 3},
    "base_below_clip": {**_SHIPPED, "learning_rate": 5e-6},
    "warm_up": {**_SHIPPED, "warm_up": 7},
    "no_clip": {**_SHIPPED, "lr_clip": 0.0, "lr_step_size": 7, "momentum_step_size": 9},
    "constant": {**_SHIPPED, "lr_policy": "constant"},
}


@pytest.mark.parametrize("name", list(_SCHEDULE_CFGS))
def test_schedules_match_jax(name):
    """lr_schedule and bn_momentum_schedule equal the JAX functions for
    epochs 0-130 (rtol 1e-6: float32 on the JAX side)."""
    cfg = _SCHEDULE_CFGS[name]
    for epoch in range(131):
        np.testing.assert_allclose(ttrainer.lr_schedule(cfg, epoch),
                                   float(jtrainer.lr_schedule(cfg, epoch)),
                                   rtol=1e-6, err_msg=f"lr, epoch {epoch}")
        np.testing.assert_allclose(ttrainer.bn_momentum_schedule(cfg, epoch),
                                   float(jtrainer.bn_momentum_schedule(cfg, epoch)),
                                   rtol=1e-6, err_msg=f"momentum, epoch {epoch}")


def test_shipped_lr_freezes_at_1p25e_5_from_epoch_59():
    assert ttrainer.lr_schedule(_SHIPPED, 58) == pytest.approx(2.5e-5)
    for epoch in (59, 60, 99, 299):
        assert ttrainer.lr_schedule(_SHIPPED, epoch) == pytest.approx(1.25e-5)


def test_schedules_reach_the_optimizer_and_every_batchnorm(tmp_path):
    cfg = {**_trainer_cfg(tmp_path, "HandTrackNet"), "lr_step_size": 2,
           "momentum_step_size": 2}
    tr = ttrainer.Trainer(cfg, "cpu")
    bns = [m for m in tr.model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    assert len(bns) > 10
    for epoch in range(5):
        assert tr.epoch == epoch
        assert all(g["lr"] == ttrainer.lr_schedule(cfg, epoch)
                   for g in tr.optimizer.param_groups)
        assert all(m.momentum == ttrainer.bn_momentum_schedule(cfg, epoch) for m in bns)
        tr.step_epoch()
    assert tr.epoch == 5 and tr.lr == pytest.approx(LR * 0.125)  # (5 + 1) // 2 halvings


# -------------------------------------------------------------- train step

# Biases whose Linear feeds straight into a BatchNorm: the mean subtraction
# erases them, so their gradient is mathematically zero and what either
# package computes is float32 cancellation residue. Adam turns the residue's
# sign into a step of +-lr, so after a step they agree only to a few lr.
# r1's bias is shadowed one module on: it shifts f12 by a constant per
# channel, which q2's first BatchNorm erases.
_DEAD = {"HandTrackNet": re.compile(
             r"(conv_blocks\.\d+\.\d+|mlp_convs\.\d+|bhand\.conv1|r1\.linear)\.bias$"),
         "iknet": re.compile(r"linear\.[0-5]\.bias$")}
# Relative bound on a live parameter's gradient, |dg|_inf <= bound * |g|_inf.
# IKNet: float32 round-off. HandTrackNet: the two forwards agree to ~1e-5, and
# a ReLU whose pre-activation lies within that of 0 takes the other branch in
# the other package; with 84 keypoint rows in a batch one such flip moves the
# gradient of everything upstream by about a percent (measured 2.2e-2; the
# units that differ are 2 of the 1024 of transt.c11.linear1). A wrong loss
# weight, BN momentum or tie rule shows as an error of order 1. The absolute
# floor is for a leaf whose whole gradient is residue (q1's last BN bias of
# the 64-neighbour scale: 1.3e-6 against 0.1 to 10 elsewhere, because q2's
# first BatchNorm erases the constant shift it causes).
_GRAD_BOUND = {"HandTrackNet": 6e-2, "iknet": 2e-4}
_GRAD_FLOOR = 5e-6
# hand_pred_r_* go through a Procrustes fit of the untrained net's prediction
# (about 94 degrees off), which amplifies the forward's round-off
_LOSS_RTOL = {"hand_pred_r_loss": 1e-4, "hand_pred_r_diff": 1e-4}
# loss envelope over 10 steps: (step 0, step 1, any step). After the first
# step every sign that differs in a near-zero gradient moves a weight by
# +-lr in one package and not the other, and the HandTrackNet trajectories
# drift apart as the JAX package's own drifts from the reference's
# (tests/test_reference_parity.py bounds it at 0.15; measured here 3.8e-2).
_ENVELOPE = {"HandTrackNet": (1e-5, 5e-3, 0.15), "iknet": (1e-5, 3e-4, 3e-4)}


def _run_steps(tmp, net_type, dtype=torch.float32):
    """One train step of both packages from the same weights on the same
    batch, then nine more: everything the step tests compare."""
    s = _setup(tmp, net_type, dtype)
    jtr, ttr, jb, tb = s["jtr"], s["ttr"], s["jbatches"], s["tbatches"]

    (_, (jloss, _)), jgrads = _jax_loss_and_grads(jtr, jb[0])
    state0 = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    tloss, tgrads = _port_grads(ttr, tb[0])
    ttr.model.load_state_dict(state0)  # the forward above moved the BN statistics

    with _no_jax_dropout():
        jl = [float(jtr.update(jb[0], jax.random.PRNGKey(0))["total_loss"])]
    tl = [float(ttr.update(tb[0])["total_loss"])]
    jstate1 = s["from_flax"](_np_tree(jtr.state.params), _np_tree(jtr.state.batch_stats))
    tstate1 = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    leaves, treedef = jax.tree.flatten(jtr.state.params)
    assert len(leaves) == len(jtr._reach_mask)
    mask_tree = jax.tree.unflatten(treedef, [
        np.full(np.shape(leaf), float(m), np.asarray(leaf).dtype)
        for leaf, m in zip(leaves, jtr._reach_mask)])
    for i in range(1, N_STEPS):
        with _no_jax_dropout():
            jl.append(float(jtr.update(jb[i], jax.random.PRNGKey(0))["total_loss"]))
        tl.append(float(ttr.update(tb[i])["total_loss"]))
    return {"net": net_type, "jloss": {k: float(v) for k, v in jloss.items()},
            "tloss": {k: float(v) for k, v in tloss.items()},
            "jgrads": s["to_port"](_np_tree(jgrads)), "tgrads": tgrads,
            "state0": state0, "jstate1": jstate1, "tstate1": tstate1,
            "jfrozen": {k for k, v in s["to_port"](mask_tree).items()
                        if float(v.abs().max()) == 0.0},
            "jlosses": jl, "tlosses": tl}


@pytest.fixture(scope="module", params=["HandTrackNet", "iknet"])
def step(request, tmp_path_factory):
    """The shipped precision, float32."""
    return _run_steps(tmp_path_factory.mktemp(request.param), request.param)


@pytest.fixture(scope="module", params=["HandTrackNet", "iknet"])
def step64(request, tmp_path_factory):
    """Both packages in float64."""
    with _jax_float64():
        return _run_steps(tmp_path_factory.mktemp(request.param + "64"), request.param,
                          torch.float64)


# ---- float64: the two packages compute the same function

def test_step0_losses_match_jax_in_float64(step64):
    """total_loss and every loss term at rtol 1e-10 (measured 1e-14)."""
    assert set(step64["tloss"]) == set(step64["jloss"])
    for k, want in step64["jloss"].items():
        np.testing.assert_allclose(step64["tloss"][k], want, rtol=1e-10, err_msg=k)


def test_gradients_match_jax_in_float64(step64):
    """Every parameter's gradient, |dg|_inf <= 1e-8 |g|_inf + 1e-10. The floor
    is for the biases that feed a BatchNorm, whose gradient is mathematically
    zero: in float64 the residue is 1e-11 on both sides."""
    worst, n = (0.0, ""), 0
    for k, g in step64["tgrads"].items():
        if g is None:
            continue
        want = step64["jgrads"][k]
        assert g.dtype == want.dtype == torch.float64 and g.shape == want.shape, k
        gmax, err = float(want.abs().max()), float((g - want).abs().max())
        assert err <= 1e-8 * gmax + 1e-10, (k, err, gmax)
        if gmax > 1e-6:
            worst, n = max(worst, (err / gmax, k)), n + 1
    print(f"worst live gradient of {n}: {worst}")
    assert n >= {"HandTrackNet": 100, "iknet": 20}[step64["net"]]


def test_state_after_one_adam_step_matches_jax_in_float64(step64):
    """Weights and BN running statistics after one update. Adam's first step
    is lr g / (|g| + 1e-8): where |g| is far above 1e-8 a gradient error of
    1e-12 does not show, where it is residue (the biases above) it shows as
    lr 1e-12 / 1e-8. Everything within 1e-7, a thousandth of the step lr."""
    moved = 0
    for k, v in step64["tstate1"].items():
        if k.endswith("num_batches_tracked"):
            continue
        d = float((v - step64["jstate1"][k]).abs().max())
        assert d <= 1e-7, (k, d)
        moved += not torch.equal(v, step64["state0"][k])
    frozen = sum(g is None for g in step64["tgrads"].values())
    stats = sum(k.endswith("num_batches_tracked") for k in step64["tstate1"])
    assert moved >= len(step64["tstate1"]) - stats - frozen - 1


def test_ten_step_loss_envelope_in_float64(step64):
    """The loss over ten steps at rtol 1e-9 (measured 8e-13)."""
    rel = np.abs(np.array(step64["tlosses"]) - np.array(step64["jlosses"])) \
        / np.abs(np.array(step64["jlosses"]))
    print("relative loss difference per step:", [f"{x:.1e}" for x in rel])
    assert rel.max() <= 1e-9, rel
    assert step64["tlosses"][-1] < step64["tlosses"][0]


def test_frozen_parameters_equal_the_jax_reach_mask_in_float64(step64):
    tfrozen = {k for k, g in step64["tgrads"].items() if g is None}
    assert tfrozen == step64["jfrozen"]
    for k in tfrozen:
        assert torch.equal(step64["tstate1"][k], step64["state0"][k]), k


# ---- float32: the shipped precision, a loose sanity bound

def test_step0_losses_match_jax(step):
    """Same weights, same batch, BN in train mode: total_loss and every loss
    term at rtol 1e-5 (1e-4 for the two Procrustes-of-the-prediction terms)."""
    assert set(step["tloss"]) == set(step["jloss"])
    for k, want in step["jloss"].items():
        np.testing.assert_allclose(step["tloss"][k], want,
                                   rtol=_LOSS_RTOL.get(k, 1e-5), err_msg=k)


def test_gradients_match_jax(step):
    dead, bound = _DEAD[step["net"]], _GRAD_BOUND[step["net"]]
    worst = (0.0, "")
    for k, g in step["tgrads"].items():
        if g is None:
            continue
        want = step["jgrads"][k]
        assert g.shape == want.shape, k
        gmax = float(want.abs().max())
        err = float((g - want).abs().max())
        if dead.search(k):
            # residue on both sides: nothing to compare but its size
            assert gmax < 1e-2 and float(g.abs().max()) < 1e-2, (k, gmax)
            continue
        if gmax > 100 * _GRAD_FLOOR:
            worst = max(worst, (err / gmax, k))
        assert err <= bound * gmax + _GRAD_FLOOR, (k, err, gmax)
    print(f"worst live gradient: {worst}")


def test_frozen_parameters_equal_the_jax_reach_mask(step):
    """The parameters the port's backward never reaches (`.grad is None`, so
    no step and no decay) are those the JAX trainer's reachability mask
    freezes: in FFN mode transt.s12 and transt.c12, for IKNet none."""
    tfrozen = {k for k, g in step["tgrads"].items() if g is None}
    assert tfrozen == step["jfrozen"]
    if step["net"] == "HandTrackNet":
        assert tfrozen and all(k.startswith(("transt.s12.", "transt.c12."))
                               for k in tfrozen)
        for k in tfrozen:  # and one Adam step with weight decay left them alone
            assert torch.equal(step["tstate1"][k], step["state0"][k]), k
    else:
        assert not tfrozen


def test_bn_running_stats_after_one_step_match_jax(step):
    """Momentum convention (the weight of the new batch, 0.1 at epoch 0),
    unbiased running variance, statistics over all of B*S*K. Tolerance: 5e-6
    of the leaf's largest statistic (at least of 1): the xavier-initialised
    net's activations reach tens, and the two forwards agree to about 1e-5
    of that (measured 2.7e-6 on a leaf of largest value 1.4)."""
    n = 0
    for k, v in step["tstate1"].items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, step["state0"][k]), k
            want = step["jstate1"][k].numpy()
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5, err_msg=k,
                                       atol=5e-6 * max(1.0, float(np.abs(want).max())))
            n += 1
    assert n >= 12


def test_parameters_after_one_adam_step_match_jax(step):
    """Adam's first step is lr * g / (|g| + eps), lr-sized whatever the
    gradient's size, so a live weight agrees to 1e-6 unless its gradient is
    within the packages' disagreement of 0, where the sign, and so 2 lr, is
    at stake. Every element within 2.5 lr; the share of elements beyond 1e-6
    bounded (measured 1.9e-2 for HandTrackNet, whose gradients carry the
    ReLU-flip noise, and 6e-4 for IKNet); frozen parameters untouched."""
    dead = _DEAD[step["net"]]
    off, total = 0, 0
    for k, v in step["tstate1"].items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        d = (v - step["jstate1"][k]).abs()
        assert float(d.max()) <= 2.5 * LR, (k, float(d.max()))
        if not dead.search(k):
            off += int((d > 1e-6).sum())
            total += d.numel()
    share = off / total
    print(f"share of live elements beyond 1e-6: {share:.2e}")
    assert share <= {"HandTrackNet": 6e-2, "iknet": 3e-3}[step["net"]]


def test_ten_step_loss_envelope(step):
    rel = np.abs(np.array(step["tlosses"]) - np.array(step["jlosses"])) \
        / np.abs(np.array(step["jlosses"]))
    print("relative loss difference per step:", [f"{x:.1e}" for x in rel])
    first, second, any_step = _ENVELOPE[step["net"]]
    assert rel[0] <= first and rel[1] <= second and rel.max() <= any_step, rel
    assert all(np.isfinite(step["tlosses"]))


def test_update_skips_parameters_without_gradient_and_decays_the_rest(tmp_path):
    """Coupled L2: a reached weight with zero gradient still decays (Adam's
    first step on g = wd w is lr g / (|g| + eps)); an unreached one does not
    move."""
    cfg = _trainer_cfg(tmp_path / "exp", "HandTrackNet")
    tr = ttrainer.Trainer(cfg, "cpu")
    _, tb = _batches(str(tmp_path / "data"))
    named = dict(tr.model.named_parameters())
    reached = named["final_mlp.2.weight"]
    reached.register_hook(torch.zeros_like)  # reached by the backward, gradient 0
    before = {k: p.detach().clone() for k, p in named.items()}
    tr.update(tb[0])
    assert reached.grad is not None and float(reached.grad.abs().max()) == 0.0
    g = cfg["weight_decay"] * before["final_mlp.2.weight"]
    torch.testing.assert_close(reached.detach(),
                               before["final_mlp.2.weight"] - LR * g / (g.abs() + 1e-8),
                               rtol=1e-6, atol=1e-9)
    assert float((reached.detach() - before["final_mlp.2.weight"]).abs().max()) > 0.5 * LR
    unreached = [k for k, p in named.items() if p.grad is None]
    assert unreached and all(k.startswith(("transt.s12.", "transt.c12.")) for k in unreached)
    assert any(float(before[k].abs().max()) > 0 for k in unreached)
    for k in unreached:
        assert torch.equal(named[k].detach(), before[k]), k
    opt = tr.optimizer
    assert isinstance(opt, torch.optim.Adam)
    g = opt.param_groups[0]
    assert (g["betas"], g["eps"], g["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)
    assert isinstance(ttrainer.make_optimizer({**cfg, "optimizer": "SGD"},
                                              tr.model.parameters()), torch.optim.SGD)
    with pytest.raises(ValueError):
        ttrainer.make_optimizer({**cfg, "optimizer": "LBFGS"}, tr.model.parameters())


def test_xavier_reinit_is_seeded_and_leaves_norms_alone(tmp_path):
    cfg = _trainer_cfg(tmp_path, "HandTrackNet")
    a, b = ttrainer.build_model(cfg), ttrainer.build_model(cfg)
    c = ttrainer.build_model({**cfg, "seed": 1})
    for (k, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), k
        if k.endswith("linear1.weight"):
            assert not torch.equal(pa, pc)
            fan_out, fan_in = pa.shape
            want = np.sqrt(2.0) * np.sqrt(2.0 / (fan_in + fan_out))
            assert abs(float(pa.detach().std()) / want - 1.0) < 0.1, k
        if k.endswith(".bias"):
            assert float(pa.detach().abs().max()) == 0.0, k
        if "bn" in k and k.endswith(".weight") or "norm" in k and k.endswith(".weight"):
            assert float((pa.detach() - 1.0).abs().max()) == 0.0, k


def test_iknet_takes_flax_init_without_xavier_unless_torch_init(tmp_path):
    """Under `weight_init` other than xavier, IKNet's Linear layers take the
    JAX IKNet's default init (`network/torch_init` False): lecun_normal
    kernels, a normal truncated at two standard deviations with std
    1 / sqrt(fan_in), and zero biases; `torch_init: True` keeps torch's
    U(+-1 / sqrt(fan_in)) kernels and biases (std 1 / sqrt(3 fan_in)). Each
    kernel's std within 2% (61,440 to 1,048,576 draws a layer)."""
    cfg = {**_trainer_cfg(tmp_path, "iknet"), "weight_init": "default"}
    lecun, again = ttrainer.build_model(cfg), ttrainer.build_model(cfg)
    torch_init = ttrainer.build_model({**cfg, "network": {**cfg["network"], "torch_init": True}})
    kernels = 0
    for (k, p), q, r in zip(lecun.named_parameters(), torch_init.parameters(),
                            again.parameters()):
        p, q = p.detach(), q.detach()
        assert torch.equal(p, r), k  # seeded
        if k.startswith("linear.") and k.endswith(".weight"):
            fan_in = p.shape[1]
            assert abs(float(p.std()) * np.sqrt(fan_in) - 1.0) < 0.02, k
            assert float(p.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-7
            assert abs(float(q.std()) * np.sqrt(3.0 * fan_in) - 1.0) < 0.02, k
            kernels += 1
        elif k.startswith("linear."):
            assert float(p.abs().max()) == 0.0 and float(q.abs().max()) > 0.0, k
        else:  # BatchNorm: torch's init in both
            assert torch.equal(p, q), k
    assert kernels == 7
    # xavier (every shipped config) overrides either init, as before
    xavier = {**cfg, "weight_init": "xavier"}
    for a, b in zip(ttrainer.build_model(xavier).parameters(), ttrainer.build_model(
            {**xavier, "network": {**xavier["network"], "torch_init": True}}).parameters()):
        assert torch.equal(a, b)


def test_trainer_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrainer.Trainer(_trainer_cfg(tmp_path, "iknet"), "cuda")
