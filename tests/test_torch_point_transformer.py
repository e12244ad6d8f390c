"""nn/backbones.PointNet2Encoder and the six classes of nn/point_transformer.py
against the JAX package's flax modules, on the CPU at toy sizes
(pointnet2_tiny.yml; 64-point clouds, 32 channels, 8 neighbours), with the
flax variables carried over by utils/convert.pointnet2_encoder_state_dict_from_flax
and point_transformer_state_dict_from_flax (strict loads: every port
parameter and buffer has its flax counterpart and no flax leaf is left).

BatchNorm's running statistics are seeded away from their initial values so
that eval mode reads them. Tolerances:
- eval mode: EVAL_ATOL, float32 matrix products and sums in two frameworks'
  orders on activations of order 1 (the same FPS, ball-query and kNN picks:
  the clouds keep every neighbour clear of a radius or a k-th distance tie);
- train mode: BatchNorm over the batch in each framework (the JAX package's
  compensated statistics, nn.BatchNorm1d's), dropout off on both sides:
  TRAIN_ATOL, the per-value rounding divided by standard deviations as
  small as 0.1 of the activations'.
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import flax
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from hotrack_tpu.nn import backbones as jbackbones
from hotrack_tpu.nn import point_transformer as jpt
from hotrack_tpu.train.trainer import _freeze
from hotrack_tpu_torch.nn import PointNet2Encoder
from hotrack_tpu_torch.nn import point_transformer as tpt
from hotrack_tpu_torch.utils.convert import (
    point_transformer_state_dict_from_flax,
    pointnet2_encoder_state_dict_from_flax,
)

EVAL_ATOL = 2e-5
TRAIN_ATOL = 1e-4
CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "pointnet_config",
                   "pointnet2_tiny.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small operations: one intra-op thread, which does not contend with the
    suite's other workers. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _IdentityDropout:
    """flax.linen.Dropout stand-in: train-time dropout off on the JAX side."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, x, *a, **k):
        return x


def _t(a):
    return torch.from_numpy(np.array(a))


def _seeded(variables, seed):
    """Seeded parameters, and running statistics moved off their start."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.randn(*a.shape) * 0.05).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + np.abs(rng.randn(*a.shape)) * 0.2).astype(np.float32),
        variables.get("batch_stats", {}))
    return {"params": params, "batch_stats": stats}


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module


def _cloud(seed, b=2, n=64, c=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, 3 + c) * 0.05).astype(np.float32)


@pytest.mark.parametrize("feat", [0, 2])
def test_pointnet2_encoder_matches_jax(feat):
    with open(CFG) as f:
        net_cfg = yaml.safe_load(f)
    pts = _cloud(1, c=feat)
    jmod = jbackbones.PointNet2Encoder(net_cfg=_freeze(net_cfg), out_dim=24)
    variables = _seeded(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(pts)), 2)
    tmod = _load(PointNet2Encoder(net_cfg, 24, in_channel=feat),
                 pointnet2_encoder_state_dict_from_flax(variables["params"],
                                                        variables["batch_stats"])).eval()
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(pts)))
    with torch.no_grad():
        got = tmod(_t(pts)).numpy()
    assert got.shape == want.shape == (2, 1, 24)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=EVAL_ATOL, rtol=0)
    # train mode (batch statistics, dropout off on both sides)
    with mock.patch.object(flax.linen, "Dropout", _IdentityDropout):
        want, _ = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(pts))
    tmod.train()
    tmod.drop1.p = 0.0
    with torch.no_grad():
        got = tmod(_t(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TRAIN_ATOL, rtol=0)


@pytest.fixture(scope="module")
def stack():
    """The JAX test's stack (tests/test_point_transformer.py): a down block
    on 64 points, a residual block, an up block back onto them, with seeded
    variables in both packages."""
    xyz = _cloud(0)
    feats1 = np.random.RandomState(3).randn(2, 64, 32).astype(np.float32)
    down = jpt.PointTransformerDownBlock(npoint=32, nsample=8, out_channel=32)
    vd = _seeded(jax.jit(down.init)(jax.random.PRNGKey(0), jnp.asarray(xyz)), 10)
    xyz2, feats2 = jax.jit(down.apply)(vd, jnp.asarray(xyz))
    res = jpt.PointTransformerResBlock(dim=32, num_neighbors=8)
    vr = _seeded(jax.jit(res.init)(jax.random.PRNGKey(1), xyz2, feats2), 11)
    up = jpt.PointTransformerUpBlock(nsample=8, high_channel=32)
    vu = _seeded(jax.jit(up.init)(jax.random.PRNGKey(2), xyz2, jnp.asarray(xyz), feats2,
                                  jnp.asarray(feats1)), 12)
    tdown = _load(tpt.PointTransformerDownBlock(32, 8, 32),
                  point_transformer_state_dict_from_flax(vd["params"], vd["batch_stats"]))
    tres = _load(tpt.PointTransformerResBlock(32, num_neighbors=8),
                 point_transformer_state_dict_from_flax(vr["params"]))
    tup = _load(tpt.PointTransformerUpBlock(8, 32, low_channel=32),
                point_transformer_state_dict_from_flax(vu["params"], vu["batch_stats"]))
    return {"xyz": xyz, "feats1": feats1, "jax": (down, vd, res, vr, up, vu),
            "port": (tdown.eval(), tres.eval(), tup.eval())}


def _run_jax(stack, train=False):
    down, vd, res, vr, up, vu = stack["jax"]
    kw = {"mutable": ["batch_stats"]} if train else {}

    def run(xyz, feats1):
        out = down.apply(vd, xyz, train=train, **kw)
        xyz2, feats2 = out[0] if train else out
        feats3 = res.apply(vr, xyz2, feats2)
        out = up.apply(vu, xyz2, xyz, feats3, feats1, train=train, **kw)
        return xyz2, feats2, feats3, out[0] if train else out

    outs = jax.jit(run)(jnp.asarray(stack["xyz"]), jnp.asarray(stack["feats1"]))
    return [np.asarray(a) for a in outs]


def _run_port(stack):
    tdown, tres, tup = stack["port"]
    xyz = _t(stack["xyz"])
    with torch.no_grad():
        xyz2, feats2 = tdown(xyz)
        feats3 = tres(xyz2, feats2)
        out = tup(xyz2, xyz, feats3, _t(stack["feats1"]))
    return [a.numpy() for a in (xyz2, feats2, feats3, out)]


def test_point_transformer_stack_matches_jax(stack):
    want, got = _run_jax(stack), _run_port(stack)
    assert [g.shape for g in got] == [(2, 32, 3), (2, 32, 32), (2, 32, 32), (2, 64, 32)]
    np.testing.assert_array_equal(got[0], want[0])            # the FPS centres, bitwise
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(w).max() > 0.1
        np.testing.assert_allclose(g, w, atol=EVAL_ATOL, rtol=0)


def test_point_transformer_stack_train_mode_matches_jax(stack):
    for module in stack["port"]:
        module.train()
    try:
        got, want = _run_port(stack), _run_jax(stack, train=True)
    finally:
        for module in stack["port"]:
            module.eval()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TRAIN_ATOL, rtol=0)


def test_point_transformer_parts_match_jax(stack):
    """The layer and both transitions alone; a transition up from a single
    coarse point broadcasts it."""
    rng = np.random.RandomState(5)
    xyz, feats = _cloud(6, n=40), rng.randn(2, 40, 12).astype(np.float32)
    layer = jpt.PointTransformerLayer(dim=16, num_neighbors=8)
    vl = _seeded(jax.jit(layer.init)(jax.random.PRNGKey(3), jnp.asarray(xyz),
                                     jnp.asarray(feats)), 13)
    tl = _load(tpt.PointTransformerLayer(16, num_neighbors=8, in_channel=12),
               point_transformer_state_dict_from_flax(vl["params"]))
    with torch.no_grad():
        np.testing.assert_allclose(tl(_t(xyz), _t(feats)).numpy(),
                                   np.asarray(jax.jit(layer.apply)(vl, jnp.asarray(xyz),
                                                                   jnp.asarray(feats))),
                                   atol=EVAL_ATOL, rtol=0)
    td = jpt.PointTransformerTransitionDown(npoint=10, nsample=4, out_channel=8)
    vtd = _seeded(jax.jit(td.init)(jax.random.PRNGKey(4), jnp.asarray(xyz),
                                   jnp.asarray(feats)), 14)
    ttd = _load(tpt.PointTransformerTransitionDown(10, 4, 8, in_channel=12),
                point_transformer_state_dict_from_flax(vtd["params"], vtd["batch_stats"])).eval()
    want = jax.jit(td.apply)(vtd, jnp.asarray(xyz), jnp.asarray(feats))
    with torch.no_grad():
        got = ttd(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=EVAL_ATOL, rtol=0)
    tu = jpt.PointTransformerTransitionUp(high_channel=12)
    low, low_feats = xyz[:, :1], rng.randn(2, 1, 8).astype(np.float32)
    vtu = _seeded(jax.jit(tu.init)(jax.random.PRNGKey(5), jnp.asarray(low), jnp.asarray(xyz),
                                   jnp.asarray(low_feats), jnp.asarray(feats)), 15)
    ttu = _load(tpt.PointTransformerTransitionUp(12, low_channel=8),
                point_transformer_state_dict_from_flax(vtu["params"], vtu["batch_stats"])).eval()
    with torch.no_grad():
        got = ttu(_t(low), _t(xyz), _t(low_feats), _t(feats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(tu.apply)(vtu, jnp.asarray(low),
                                                                 jnp.asarray(xyz),
                                                        jnp.asarray(low_feats),
                                                        jnp.asarray(feats))),
                               atol=EVAL_ATOL, rtol=0)
