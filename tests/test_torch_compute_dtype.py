"""HandTrackNet's reduced-precision compute (`network/compute_dtype`) in the
port against the JAX package, and F7: the port's two model factories and
its entries honour the key, which they used to drop.

Sizes: pointnet2_tiny.yml, 64 points, backbone_out_dim 48, batch 2 (the
forward) and 4 (the train step). The JAX twins are traced under `jax.jit`,
their weights drawn in numpy (xavier kernels, uniform biases, seeded BN
statistics) and carried to the port by `handtracknet_state_dict_from_flax`.
The layer holds feed the port's module the JAX module's own input, taken
from the JAX forward's captured intermediates, so that a rounding flip
upstream cannot show in a layer downstream.

The JAX twins are compiled with `xla_allow_excess_precision` off
(`_strict_jit`). With it on, XLA:CPU's default, the compiler drops the
rounding of a bf16 or fp16 value that goes on into float32 (a Dense's output
into its BatchNorm, for one), so the program does not round where its code
casts; the port rounds where the code casts, and the strict compile is the
JAX program's own arithmetic.

Bounds (the constants below), with what they measured on the CPU (torch
2.13, XLA:CPU at `highest` matmul precision), bf16 / fp16. A product summed
in float32 in another order, or a BatchNorm or LayerNorm taking its float32
arithmetic in another order, now and then puts a value on the other side of
a rounding boundary of the compute dtype: a flip of one ulp.
- the dense helper against flax's `Dense(dtype)`: 4.9e-5 / 1.5e-4 of the
  elements one ulp apart (DENSE_FLIP_SHARE 1e-3), none further;
- a shared MLP, sa1, r1: bitwise / at most 1.2e-4 flipped
  (LAYER_FLIP_SHARE 1e-2, one ulp);
- the backbone (float32 out): 1.2e-7 / 5.2e-4 of 0.63 (BACKBONE_ATOL);
- the FFN in train mode with the same injected dropout masks: 0.012 /
  0.0021 on LayerNorm outputs of unit scale (FFN_ATOL, four ulps at 1);
- the eval-mode forward: pred_kp 3.5e-6 / 2.8e-4 m (FORWARD_KP_ATOL), the
  losses 5.6e-5 / 2.5e-3 relative (FORWARD_LOSS_RTOL);
- one bf16 train step, dropout off: losses up to 2.2e-2 relative
  (STEP_LOSS_RTOL 5e-2), the gradients' cosine 0.966 (STEP_GRAD_COS 0.9),
  biases that feed a BatchNorm left out; the parameters after one Adam step
  equal to float32 rounding where the two gradients agree in sign, 7.5% of
  the elements not (STEP_SIGN_SHARE). The step is ill-conditioned in bf16
  at this random init: either package's bf16 gradient has a cosine near 0
  with its own float32 gradient, so a flip in the forward moves it. Besides,
  the JAX CPU gather's adjoint is XLA's scatter-add in the source dtype, the
  port's sums in float32 and rounds once, as the TPU kernel does.
"""

import contextlib
import functools
import os
import re
import types
from unittest import mock

import numpy as np
import flax.linen
import flax.linen.stochastic
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.models import hand_tracknet_loss as jax_loss
from hotrack_tpu.nn.pointnet2 import SharedMLP as JaxSharedMLP
from hotrack_tpu.nn.transformer import AttnModule as JaxAttnModule
from hotrack_tpu.train import trainer as jtrainer
from hotrack_tpu_torch.models import HandTrackNet, hand_tracknet_loss
from hotrack_tpu_torch.models.hand_utils import handkp2palmkp
from hotrack_tpu_torch.nn import precision
from hotrack_tpu_torch.nn.global_batch import GlobalBatchDropout
from hotrack_tpu_torch.nn.pointnet2 import shared_mlp, shared_mlp_layers
from hotrack_tpu_torch.nn.transformer import AttnModule
from hotrack_tpu_torch.train import trainer as ttrainer
from hotrack_tpu_torch.utils.convert import handtracknet_state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}   # spacing at 1, relative
OUT_DIM, N_POINTS = 48, 64

# bounds (measured on the CPU, bf16 / fp16, in the module's docstring)
LAYER_FLIP_SHARE = 0.01
DENSE_FLIP_SHARE = 1e-3
BACKBONE_ATOL = {"bfloat16": 1e-4, "float16": 2e-3}
FFN_ATOL = {name: 4 * ulp for name, ulp in ULP.items()}
FORWARD_KP_ATOL = {"bfloat16": 1e-4, "float16": 1e-3}     # m
FORWARD_LOSS_RTOL = {"bfloat16": 1e-3, "float16": 1e-2}
STEP_LOSS_RTOL = 5e-2
STEP_GRAD_COS = 0.9
STEP_PARAM_ATOL = 1e-6   # float32 rounding of a parameter near 0.1-1
STEP_SIGN_SHARE = 0.15
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_net_cfg():
    with open(os.path.join(REPO, "configs", "pointnet_config", "pointnet2_tiny.yml")) as f:
        return yaml.safe_load(f)


def _inputs(b, seed):
    """Points (uniform in a 10 cm ball about the keypoints' mean), keypoints,
    ground truth and palm template (numpy float32)."""
    rng = np.random.RandomState(seed)
    kp = (rng.randn(b, 21, 3) * 0.04 + [0, 0, 0.5]).astype(np.float32)
    way = rng.randn(b, N_POINTS, 3)
    way *= 0.1 * rng.rand(b, N_POINTS, 1) ** (1 / 3) / np.linalg.norm(way, axis=-1, keepdims=True)
    points = (kp.mean(1, keepdims=True) + way).astype(np.float32)
    gt = (kp + rng.randn(b, 21, 3) * 0.01).astype(np.float32)
    palm = handkp2palmkp(torch.from_numpy(gt)).numpy()
    return points, kp, gt, palm


def _numpy_variables(shapes, seed):
    """flax variables of `shapes` in numpy: xavier kernels, small uniform
    biases, scales near 1, BN means N(0, 0.1) and variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in, fan_out = int(np.prod(shape[:-1])), shape[-1]
            return (rng.randn(*shape) * np.sqrt(2.0 / (fan_in + fan_out))).astype(np.float32)
        if name == "mean":
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _variable_shapes():
    """The tiny HandTrackNet's variable tree (the same for every compute
    dtype and batch size), traced once."""
    points, kp, _, palm = _inputs(2, 0)
    jmodel = JaxHandTrackNet(net_cfg=_tiny_net_cfg(), backbone_out_dim=OUT_DIM)
    return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), points, kp, palm)


def _strict_jit(fn, *args):
    """fn compiled for args with the casts to bf16 / fp16 kept (see the
    module's docstring), called on them."""
    compiled = jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})
    return compiled(*args)


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flips(got: torch.Tensor, want, dtype: str):
    """(share of elements that differ, largest difference in ulps of the
    compute dtype at the larger magnitude of the two)."""
    g, w = got.detach().float().numpy(), _f32(want)
    assert g.shape == w.shape
    diff = np.abs(g - w)
    _, exp = np.frexp(np.maximum(np.abs(g), np.abs(w)))
    ulps = diff / np.ldexp(2.0 * ULP[dtype], exp - 1)   # the spacing at 2^(exp-1)
    return float((diff > 0).mean()), float(ulps.max(initial=0.0))


def _hold_layer(got, want, dtype, tag):
    share, ulps = _flips(got, want, dtype)
    assert share <= LAYER_FLIP_SHARE and ulps <= 1.0, (tag, share, ulps)


# ------------------------------------------------------------ the forward

def _step_cfg(tmp_path, compute_dtype):
    """The shipped SimGrasp training hyperparameters at the tiny width."""
    return {"device": "cpu", "track": False, "seed": 0, "mano_root": None,
            "experiment_dir": str(tmp_path), "optimizer": "Adam", "learning_rate": LR,
            "weight_decay": 1e-4, "lr_policy": "step", "lr_step_size": 20,
            "lr_gamma": 0.5, "lr_clip": 1e-5, "warm_up": 0, "total_epoch": 300,
            "momentum_original": 0.1, "momentum_decay": 0.5, "momentum_step_size": 20,
            "momentum_min": 0.01, "weight_init": "xavier",
            "pointnet": {"camera": _tiny_net_cfg()},
            "network": {"type": "HandTrackNet", "handframe": "kp",
                        "backbone_out_dim": OUT_DIM, "compute_dtype": compute_dtype,
                        "loss_weight": {"hand_pred_kp_loss": 10, "hand_pred_r_loss": 1,
                                        "hand_pred_t_loss": 1}}}


class _IdentityDropout:
    """flax.linen.Dropout stand-in: dropout off on the JAX side, as p = 0
    turns it off on the port's."""

    def __init__(self, *a, **k):
        pass

    def __call__(self, x, *a, **k):
        return x


@pytest.fixture(scope="module", params=list(DTYPES))
def forward(request):
    """The JAX net and the port's on the same weights in `dtype`, and one
    eval-mode forward of each (with the JAX intermediates of sa1, the
    backbone, q1 and r1, and the losses)."""
    name = request.param
    cfg = _tiny_net_cfg()
    points, kp, gt, palm = _inputs(2, 0)
    jmodel = JaxHandTrackNet(net_cfg=cfg, backbone_out_dim=OUT_DIM, compute_dtype=name)
    variables = _numpy_variables(_variable_shapes(), 1)

    def run(variables, points, kp, palm, gt):
        ret, state = jmodel.apply(
            variables, points, kp, palm, mutable=["intermediates"],
            capture_intermediates=lambda m, _: m.name in ("sa1", "bhand", "q1", "r1"))
        loss, _ = jax_loss(ret, gt, palm)
        return ret, loss, state["intermediates"]

    jret, jloss, inter = _strict_jit(run, variables, points, kp, palm, gt)
    tmodel = HandTrackNet(cfg, backbone_out_dim=OUT_DIM, compute_dtype=name).eval()
    tmodel.load_state_dict(handtracknet_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    t = [torch.from_numpy(a) for a in (points, kp, gt, palm)]
    with torch.no_grad():
        tret = tmodel(t[0], t[1], t[3])
        tloss, _ = hand_tracknet_loss(tret, t[2], t[3])
    return types.SimpleNamespace(name=name, jret=jret, jloss=jloss, inter=inter,
                                 tmodel=tmodel, tret=tret, tloss=tloss)


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """One bf16 train step (dropout off) of both trainers on the same
    weights and batch: losses, gradients and parameters after Adam, the
    JAX ones in the port's names."""
    cfg = _step_cfg(tmp_path_factory.mktemp("step"), "bfloat16")
    points, kp, gt, palm = _inputs(4, 10)
    jb = {"hand_points": points, "jittered_hand_kp": kp, "gt_hand_kp": gt,
          "gt_hand_pose": {"palm_template": palm}}
    variables = _numpy_variables(_variable_shapes(), 11)
    params, stats = variables["params"], variables["batch_stats"]
    with mock.patch.object(flax.linen, "Dropout", _IdentityDropout):
        jtr = jtrainer.Trainer(cfg)

        def jax_step(params, batch):
            loss_fn = jtr._make_loss_fn(batch, stats, jtrainer.bn_momentum_schedule(cfg, 0),
                                        jax.random.PRNGKey(0))
            (_, (losses, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = jtr.optimizer.update(grads, jtr.optimizer.init(params), params)
            return losses, grads, jax.tree.map(lambda p, u: p + u, params, updates)

        jlosses, jgrads, jafter = _strict_jit(jax_step, params, jb)

    ttr = ttrainer.Trainer(cfg, "cpu")
    ttr.model.load_state_dict(handtracknet_state_dict_from_flax(params, stats), strict=True)
    for m in ttr.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    ttr.model.train()
    total, tlosses = ttrainer.summarize_losses(
        ttr._losses(jax.tree.map(torch.from_numpy, jb)), ttr.loss_weights)
    ttr.optimizer.zero_grad(set_to_none=True)
    total.backward()
    tgrads = {k: None if p.grad is None else p.grad.clone()
              for k, p in ttr.model.named_parameters()}
    ttr.optimizer.step()
    to_port = lambda tree: handtracknet_state_dict_from_flax(tree, stats)  # noqa: E731
    return types.SimpleNamespace(
        jlosses=jlosses, tlosses=tlosses, jgrads=to_port(jgrads), tgrads=tgrads,
        jafter=to_port(jafter), before=to_port(params),
        tafter={k: p.detach() for k, p in ttr.model.named_parameters()})


def _captured(inter, *path):
    node = inter
    for key in path:
        node = node[key]
    return node["__call__"][0]


def _torch(x, dtype=None):
    t = torch.from_numpy(_f32(x))
    return t if dtype is None else t.to(dtype)


def test_sa_layer_matches_jax(forward):
    f = forward
    xyz2 = _torch(f.jret["points_handframe"])
    with torch.no_grad():
        new_xyz, feats = f.tmodel.bhand.sa1(xyz2)
    jxyz, jfeats = _captured(f.inter, "bhand", "sa1")
    assert feats.dtype == DTYPES[f.name][0]
    np.testing.assert_array_equal(new_xyz.numpy(), _f32(jxyz))
    _hold_layer(feats, jfeats, f.name, "sa1")


def test_backbone_matches_jax(forward):
    f = forward
    with torch.no_grad():
        src2 = f.tmodel.bhand(_torch(f.jret["points_handframe"]))
    want = _captured(f.inter, "bhand")
    assert src2.dtype == torch.float32 and want.dtype == jnp.float32
    err = np.abs(src2.numpy() - _f32(want))
    assert err.max() <= BACKBONE_ATOL[f.name], err.max()


def test_rearrange_matches_jax(forward):
    f = forward
    cd = DTYPES[f.name][0]
    with torch.no_grad():
        got = f.tmodel.r1(_torch(_captured(f.inter, "q1")[0], cd))
    assert got.dtype == cd
    _hold_layer(got, _captured(f.inter, "r1"), f.name, "r1")


def test_forward_and_loss_match_jax(forward):
    f = forward
    # the canonicalisation is float32 in both packages
    np.testing.assert_allclose(f.tret["points_handframe"].numpy(),
                               _f32(f.jret["points_handframe"]), rtol=0, atol=1e-6)
    err = np.abs(f.tret["pred_kp"].numpy() - _f32(f.jret["pred_kp"])).max()
    assert f.tret["pred_kp"].dtype == torch.float32
    assert err <= FORWARD_KP_ATOL[f.name], err
    assert set(f.tloss) == set(f.jloss)
    for k, v in f.jloss.items():
        np.testing.assert_allclose(float(f.tloss[k]), float(v), err_msg=k,
                                   rtol=FORWARD_LOSS_RTOL[f.name], atol=1e-2
                                   if k == "hand_pred_r_diff" else 1e-6)


# ------------------------------------------------------------ single layers

@pytest.mark.parametrize("name", list(DTYPES))
def test_dense_is_bitwise_flax(name):
    cd, jd = DTYPES[name]
    rng = np.random.RandomState(3)
    x = rng.randn(512, 96).astype(np.float32)
    layer = torch.nn.Linear(96, 40)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng.randn(40, 96).astype(np.float32) * 0.1))
        layer.bias.copy_(torch.from_numpy(rng.randn(40).astype(np.float32)))
    dense = flax.linen.Dense(40, dtype=jd)
    want = _strict_jit(dense.apply, {"params": {"kernel": layer.weight.detach().numpy().T,
                                                "bias": layer.bias.detach().numpy()}}, x)
    got = precision.dense(layer, torch.from_numpy(x), cd)
    assert got.dtype == cd and want.dtype == jd
    share, ulps = _flips(got, want, name)
    assert share <= DENSE_FLIP_SHARE and ulps <= 1.0, (share, ulps)
    # without a compute dtype: the Linear call itself
    assert torch.equal(precision.dense(layer, torch.from_numpy(x), None),
                       layer(torch.from_numpy(x)))


@pytest.mark.parametrize("name", list(DTYPES))
def test_shared_mlp_matches_jax(name):
    cd, _ = DTYPES[name]
    x = np.random.RandomState(4).randn(2, 16, 8, 19).astype(np.float32)
    jmlp = JaxSharedMLP((24, 32), dtype=name)
    variables = _numpy_variables(jax.eval_shape(jmlp.init, jax.random.PRNGKey(0), x), 5)
    want = _strict_jit(jmlp.apply, variables, x)
    convs, bns = shared_mlp_layers(19, (24, 32))
    p, s = variables["params"], variables["batch_stats"]
    with torch.no_grad():
        for i, (conv, bn) in enumerate(zip(convs, bns)):
            conv.weight.copy_(torch.from_numpy(np.asarray(p[f"Dense_{i}"]["kernel"]).T))
            conv.bias.copy_(torch.from_numpy(np.asarray(p[f"Dense_{i}"]["bias"])))
            bn.weight.copy_(torch.from_numpy(np.asarray(p[f"BatchNorm_{i}"]["scale"])))
            bn.bias.copy_(torch.from_numpy(np.asarray(p[f"BatchNorm_{i}"]["bias"])))
            bn.running_mean.copy_(torch.from_numpy(np.asarray(s[f"BatchNorm_{i}"]["mean"])))
            bn.running_var.copy_(torch.from_numpy(np.asarray(s[f"BatchNorm_{i}"]["var"])))
        bns.eval()
        got = shared_mlp(convs, bns, torch.from_numpy(x), cd)
    assert got.dtype == cd
    _hold_layer(got, want, name, "shared_mlp")


@contextlib.contextmanager
def _injected_masks(masks):
    """Both packages' dropout draws replaced by `masks` (bool numpy arrays),
    taken in call order: flax's Bernoulli draw and GlobalBatchDropout's."""
    jax_masks, port_masks = list(masks), list(masks)

    def bernoulli(key, p, shape):
        m = jax_masks.pop(0)
        assert tuple(m.shape) == tuple(shape)
        return jnp.asarray(m)

    def keep_mask(self, x):
        return torch.from_numpy(port_masks.pop(0)).to(x.dtype)

    with mock.patch.object(flax.linen.stochastic, "random",
                           types.SimpleNamespace(bernoulli=bernoulli)), \
            mock.patch.object(GlobalBatchDropout, "keep_mask", keep_mask):
        yield


@pytest.mark.parametrize("name", list(DTYPES))
def test_ffn_in_train_mode_with_injected_masks_matches_jax(name):
    cd, _ = DTYPES[name]
    d, ff = 48, 64
    rng = np.random.RandomState(6)
    src = rng.randn(2, 21, d).astype(np.float32)
    masks = [rng.rand(2, 21, ff) > 0.1, rng.rand(2, 21, d) > 0.1]
    jattn = JaxAttnModule(d, dim_feedforward=ff, dtype=name)
    variables = _numpy_variables(jax.eval_shape(
        lambda: jattn.init(jax.random.PRNGKey(0), src, None, None, None, False)), 7)
    p = variables["params"]
    module = AttnModule(d, dim_feedforward=ff, compute_dtype=cd).train()
    with torch.no_grad():
        for mine, theirs in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
            getattr(module, mine).weight.copy_(torch.from_numpy(np.asarray(p[theirs]["scale"])))
            getattr(module, mine).bias.copy_(torch.from_numpy(np.asarray(p[theirs]["bias"])))
        for mine, theirs in (("linear1", "Dense_0"), ("linear2", "Dense_1")):
            getattr(module, mine).weight.copy_(
                torch.from_numpy(np.asarray(p[theirs]["kernel"]).T))
            getattr(module, mine).bias.copy_(torch.from_numpy(np.asarray(p[theirs]["bias"])))
    with _injected_masks(masks):
        want = _strict_jit(lambda v, s: jattn.apply(v, s, None, None, None, False, True,
                                                    rngs={"dropout": jax.random.PRNGKey(1)}),
                           variables, src)
        with torch.no_grad():
            got = module(torch.from_numpy(src).to(cd))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - _f32(want)).max()
    assert err <= FFN_ATOL[name], err


@pytest.mark.parametrize("name", list(DTYPES))
def test_dropout_divides_in_the_dtype_as_flax(name):
    """flax divides a bf16 input by keep_prob rounded to bf16 (0.8984375 for
    p = 0.1); dividing by the float 0.9 differs in a third of the elements."""
    cd, jd = DTYPES[name]
    rng = np.random.RandomState(8)
    x = rng.randn(100000).astype(np.float32)
    keep = rng.rand(100000) > 0.1
    want = _strict_jit(lambda v, m: jax.lax.select(m, v / 0.9, jnp.zeros_like(v)),
                       jnp.asarray(x, jd), keep)
    drop = GlobalBatchDropout(0.1).train()
    with mock.patch.object(GlobalBatchDropout, "keep_mask",
                           lambda self, t: torch.from_numpy(keep).to(t.dtype)):
        got = drop(torch.from_numpy(x).to(cd))
    if name == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    else:
        # XLA:CPU rewrites an fp16 division by a constant into a product with
        # the reciprocal rounded to fp16 (11% of these elements move by one
        # ulp); the port divides, as the JAX code says
        _, ulps = _flips(got, want, name)
        assert ulps <= 1.0, ulps
        recip = torch.tensor(1.0 / 0.9, dtype=cd)
        np.testing.assert_array_equal((torch.from_numpy(x).to(cd) * torch.from_numpy(keep)
                                       .to(cd) * recip).float().numpy(), _f32(want))


def test_dropout_in_float32_and_float64_is_unchanged():
    """Dividing by 1 - p as a tensor of x's dtype is bitwise the division by
    the Python float that the module took before, in float32 and float64."""
    rng = np.random.RandomState(9)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.randn(10000)).to(dtype)
        keep = torch.from_numpy(rng.rand(10000) > 0.1).to(dtype)
        drop = GlobalBatchDropout(0.1).train()
        with mock.patch.object(GlobalBatchDropout, "keep_mask", lambda self, t: keep):
            assert torch.equal(drop(x), x * keep / (1.0 - 0.1))


# ------------------------------------------------------------ one train step

# biases whose gradient is zero in exact arithmetic (chip_smoke.py's
# DEAD_BIAS): those that feed a BatchNorm, and the bias of sa3's last
# BatchNorm; what each package computes for them is the sum of their
# cotangent's roundings
DEAD_BIAS = (r"(conv_blocks\.\d+\.\d+|mlp_convs\.\d+|bhand\.conv1|r1\.linear"
             r"|bhand\.sa3\.mlp_bns\.2)\.bias$")


def test_train_step_losses_match_jax(step):
    for k, v in step.jlosses.items():
        np.testing.assert_allclose(float(step.tlosses[k]), float(v), rtol=STEP_LOSS_RTOL,
                                   err_msg=k)


def test_train_step_gradients_match_jax(step):
    dot = n_t = n_j = 0.0
    for k, g in step.tgrads.items():
        if g is None:  # FFN mode: transt.s12 / c12 take no part
            assert k.startswith(("transt.s12.", "transt.c12."))
            assert float(step.jgrads[k].abs().max()) == 0.0
            continue
        assert g.dtype == torch.float32
        if re.search(DEAD_BIAS, k):
            continue
        j = step.jgrads[k].double()
        dot += float((g.double() * j).sum())
        n_t += float(g.double().pow(2).sum())
        n_j += float(j.pow(2).sum())
    assert dot / np.sqrt(n_t * n_j) >= STEP_GRAD_COS


def test_state_after_one_adam_step_matches_jax(step):
    """Adam's first step moves a parameter by lr * g' / (|g'| + eps), g' the
    gradient plus the weight decay: lr with g's sign wherever |g'| >> eps.
    Where the two packages' g' agree in sign the parameters agree to their
    float32 rounding; the share where they do not follows the gradients'."""
    wd = 1e-4
    disagree = total = 0
    for k, p in step.tafter.items():
        before = step.before[k]
        if step.tgrads[k] is None:
            assert torch.equal(p, before), k
            continue
        assert float((p - before).abs().max()) <= LR * (1 + 1e-3), k
        if re.search(DEAD_BIAS, k):
            continue
        gt = step.tgrads[k] + wd * before
        gj = step.jgrads[k] + wd * before
        same = (torch.sign(gt) == torch.sign(gj)) & (gt.abs() > 1e-6) & (gj.abs() > 1e-6)
        np.testing.assert_allclose(p[same].numpy(), step.jafter[k][same].numpy(), rtol=0,
                                   atol=STEP_PARAM_ATOL, err_msg=k)
        disagree += int((~same).sum())
        total += same.numel()
    assert disagree / total <= STEP_SIGN_SHARE


# ------------------------------------------------------------ F7 and the key

def test_resolve_compute_dtype_takes_the_jax_packages_values():
    assert precision.resolve_compute_dtype("bfloat16") == torch.bfloat16
    assert precision.resolve_compute_dtype("float16") == torch.float16
    assert precision.resolve_compute_dtype("float32") is None
    assert precision.resolve_compute_dtype(None) is None
    for bad in ("bf16", "float64", "int8", 16):
        with pytest.raises(ValueError, match="network/compute_dtype"):
            precision.resolve_compute_dtype(bad)
    with pytest.raises(ValueError, match="network/compute_dtype"):
        HandTrackNet(_tiny_net_cfg(), backbone_out_dim=OUT_DIM, compute_dtype="half")


def test_float32_and_an_absent_key_are_bitwise_the_default_path(tmp_path):
    """build_model with `compute_dtype: float32`, with the key absent, and the
    model as the factory built it before the key existed (no argument): the
    same forward, loss and gradients, bit for bit, in train mode."""
    points, kp, gt, palm = (torch.from_numpy(a) for a in _inputs(4, 12))
    runs = []
    for value in ("float32", None, "absent"):
        cfg = _step_cfg(tmp_path, value)
        if value == "absent":
            del cfg["network"]["compute_dtype"]
        model = ttrainer.build_model(cfg).train()
        assert model.compute_dtype is None
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        ret = model(points, kp, palm)
        loss, _ = hand_tracknet_loss(ret, gt, palm)
        loss["hand_pred_kp_loss"].backward()
        runs.append((ret["pred_kp"].detach(), {k: p.grad for k, p in model.named_parameters()}))
    torch.manual_seed(0)
    plain = HandTrackNet(_tiny_net_cfg(), backbone_out_dim=OUT_DIM)
    plain.load_state_dict(ttrainer.build_model(cfg).state_dict())
    for m in plain.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    runs.append((plain.train()(points, kp, palm)["pred_kp"].detach(), None))
    for kp_pred, grads in runs[1:]:
        assert torch.equal(kp_pred, runs[0][0])
        for k, g in (grads or {}).items():
            assert (g is None) == (runs[0][1][k] is None), k
            assert g is None or torch.equal(g, runs[0][1][k]), k


def _dtype_probe():
    """Patch RearrangeModule.forward to record its output's dtype: r1 and
    r2 run in the compute dtype, float32 without one."""
    from hotrack_tpu_torch.nn import blocks
    seen = []
    real = blocks.RearrangeModule.forward

    def forward(self, x):
        out = real(self, x)
        seen.append(out.dtype)
        return out

    return seen, mock.patch.object(blocks.RearrangeModule, "forward", forward)


TINY = ["--pointnet_cfg/camera", "pointnet2_tiny.yml", "--num_points", "64",
        "--network/backbone_out_dim", "48", "--device", "cpu"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from hotrack_tpu_torch.data.synthetic import generate_simgrasp_dataset
    root = str(tmp_path_factory.mktemp("f7"))
    generate_simgrasp_dataset(root, num_instances=3, num_frames=4, points_per_part=150)
    with mock.patch.dict(os.environ, {"HOTRACK_DATA_ROOT": root}):
        yield root


@pytest.mark.parametrize("name", ["bfloat16", "float16", "float32"])
def test_f7_every_entry_computes_in_the_configured_dtype(data_root, name):
    """F7: train_main, test_main (`track: hand`), the tracking runner's model
    factory (which the batched runner and the sharded trackers take their
    net from), build_model and the streaming tracker all run HandTrackNet in
    `network/compute_dtype`; before, the key was taken and dropped."""
    from hotrack_tpu_torch.track.stream import HandTracker
    from hotrack_tpu_torch.mano.model import synthetic_mano_model
    from hotrack_tpu_torch.train import cli, run_hand_track

    want = DTYPES[name][0] if name in DTYPES else torch.float32
    key = ["--network/compute_dtype", name]
    exp = f"f7_{name}"
    seen, probe = _dtype_probe()
    with probe:
        trainer = cli.train_main(["--config", "handtracknet_train_SimGrasp.yml", *TINY, *key,
                                  "--batch_size", "4", "--epochs", "1",
                                  "--experiment_dir", exp])
        assert trainer.model.compute_dtype == (None if name == "float32" else want)
        assert seen and set(seen) == {want}, ("train_main", seen)
        seen.clear()
        avg, stats = cli.test_main(["--config", "handtracknet_test_SimGrasp.yml", *TINY,
                                    *key, "--experiment_dir", exp])
        assert stats["sequences"][0]["pred_kp"].dtype == np.float32
        assert seen and set(seen) == {want}, ("test_main", seen)
        seen.clear()
        cfg = cli.load_config(["--config", "handtracknet_test_SimGrasp.yml", *TINY, *key,
                               "--experiment_dir", exp])
        net = run_hand_track.load_handnet(cfg, "cpu")
        tracker = HandTracker(net, synthetic_mano_model())
        points, kp, _, _ = (torch.from_numpy(a) for a in _inputs(1, 13))
        state = tracker.init_state(points[0], kp[0])
        _, out = tracker.step(state, hand_points=points[0])
        assert out["pred_kp"].dtype == torch.float32
        assert set(seen) == {want}, ("HandTracker", seen)


def test_f7_an_unknown_dtype_raises_before_any_data_is_read(tmp_path):
    """The entries refuse an unknown value at once: here no data set exists
    at all, so anything that read one would fail otherwise."""
    from hotrack_tpu_torch.train import cli
    with mock.patch.dict(os.environ, {"HOTRACK_DATA_ROOT": str(tmp_path)}):
        for main, config in ((cli.train_main, "handtracknet_train_SimGrasp.yml"),
                             (cli.test_main, "handtracknet_test_SimGrasp.yml")):
            with pytest.raises(ValueError, match="network/compute_dtype"):
                main(["--config", config, *TINY, "--network/compute_dtype", "bf16"])
