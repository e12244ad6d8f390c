"""Port parity: HandTrackNet of hotrack_tpu_torch against hotrack_tpu's, on
the same weights, carried over by `handtracknet_state_dict_from_flax`.

The net is NET_CFG-sized (tests/test_models.py). BatchNorm running stats are
redrawn from a seed so eval-mode BN is not the identity. Tolerance: 1e-5 m on
the predicted keypoints and 1e-5 on hidden features — float32 reassociation
through ~20 layers of matmuls, with every FPS/kNN/ball-query index identical
(the geometry is held to 1e-6 by test_torch_pointops/test_torch_mano_pose).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.models import HandTrackNet as JaxHandTrackNet
from hotrack_tpu.models import hand_tracknet_loss as jax_loss
from hotrack_tpu.models.hand_utils import handkp2palmkp
from hotrack_tpu.nn.blocks import position_embedding_sine as jax_pos
from hotrack_tpu.utils.torch_export import save_reference_checkpoint as jax_save_ckpt
from hotrack_tpu_torch.models import HandTrackNet, hand_tracknet_loss
from hotrack_tpu_torch.nn.blocks import position_embedding_sine
from hotrack_tpu_torch.nn.transformer import AttnModule
from hotrack_tpu_torch.utils.convert import (
    handtracknet_state_dict_from_flax,
    load_reference_checkpoint,
    port_to_reference_state_dict,
    reference_to_port_state_dict,
    save_reference_checkpoint,
)

NET_CFG = {
    "sa1": {"npoint": 32, "radius_list": [0.1], "nsample_list": [8],
            "mlp_list": [[16, 16, 32]]},
    "sa2": {"npoint": 16, "radius_list": [0.2], "nsample_list": [8],
            "mlp_list": [[32, 32, 64]]},
    "sa3": {"mlp": [64, 64, 128]},
    "fp3": {"mlp": [64, 64]},
    "fp2": {"mlp": [64, 64]},
    "fp1": {"mlp": [64, 64]},
}
OUT_DIM = 48
N_POINTS = 64
KP_TOL = 1e-5  # m


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    points = (rng.randn(b, N_POINTS, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    kp = (rng.randn(b, 21, 3) * 0.04 + [0, 0, 0.5]).astype(np.float32)
    return points, kp


def _randomize_stats(tree, rng):
    """Seeded BN running stats: mean ~ N(0, 0.1), var ~ U(0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_stats(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*np.shape(v)) * 0.1).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
    return out


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)  # writable copies


@pytest.fixture(scope="module")
def nets():
    """(jax model, jax variables (numpy), port model with the same weights,
    palm template (6, 3))."""
    jmodel = JaxHandTrackNet(net_cfg=NET_CFG, backbone_out_dim=OUT_DIM)
    points, kp = _inputs()
    palm = np.array(handkp2palmkp(jnp.asarray(kp))[0])
    variables = _to_numpy(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(points),
                                      jnp.asarray(kp), jnp.asarray(palm)))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"],
                                                np.random.RandomState(1))
    tmodel = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    tmodel.load_state_dict(handtracknet_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return jmodel, variables, tmodel, palm


@pytest.mark.parametrize("seed", [0, 1])
def test_handtracknet_forward_matches_jax(nets, seed):
    jmodel, variables, tmodel, palm = nets
    points, kp = _inputs(seed=seed)
    jret = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(kp),
                        jnp.asarray(palm))
    with torch.no_grad():
        tret = tmodel(torch.from_numpy(points), torch.from_numpy(kp),
                      torch.from_numpy(palm))
    for key in ("points_handframe", "init_kp_handframe", "pred_kp_handframe"):
        np.testing.assert_allclose(tret[key].numpy(), np.asarray(jret[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    np.testing.assert_allclose(tret["pred_kp"].numpy(), np.asarray(jret["pred_kp"]),
                               atol=KP_TOL, rtol=0)


def test_backbone_features_match_jax(nets):
    jmodel, variables, tmodel, palm = nets
    points, kp = _inputs(seed=2)
    _, state = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(kp),
                            jnp.asarray(palm), capture_intermediates=True,
                            mutable=["intermediates"])
    jfeat = np.asarray(state["intermediates"]["bhand"]["__call__"][0])
    with torch.no_grad():
        ret = tmodel(torch.from_numpy(points), torch.from_numpy(kp),
                     torch.from_numpy(palm))
        tfeat = tmodel.bhand(ret["points_handframe"])
    np.testing.assert_allclose(tfeat.numpy(), jfeat, atol=1e-5, rtol=0)


def test_handtracknet_loss_matches_jax(nets):
    jmodel, variables, tmodel, palm = nets
    points, kp = _inputs(seed=3)
    gt = kp + np.random.RandomState(4).randn(*kp.shape).astype(np.float32) * 0.01
    jret = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(kp),
                        jnp.asarray(palm))
    jloss, _ = jax_loss(jret, jnp.asarray(gt), jnp.asarray(palm))
    with torch.no_grad():
        tret = tmodel(torch.from_numpy(points), torch.from_numpy(kp),
                      torch.from_numpy(palm))
        tloss, _ = hand_tracknet_loss(tret, torch.from_numpy(gt), torch.from_numpy(palm))
    assert set(tloss) == set(jloss)
    for k in jloss:
        # r_diff is in degrees and goes through arccos near 1: 1e-2 deg
        tol = 1e-2 if k == "hand_pred_r_diff" else 1e-5
        np.testing.assert_allclose(float(tloss[k]), float(jloss[k]), atol=tol,
                                   rtol=0, err_msg=k)


def test_reference_checkpoint_loads_strict(nets, tmp_path):
    """A .pt written by the JAX package's save_reference_checkpoint loads
    into the port with strict=True and predicts what the JAX net predicts."""
    jmodel, variables, _, palm = nets
    path = jax_save_ckpt(str(tmp_path / "model_0003.pt"), handnet=variables, epoch=3)
    fresh = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).eval()
    assert load_reference_checkpoint(fresh, path) == 3
    points, kp = _inputs(seed=5)
    jret = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(kp),
                        jnp.asarray(palm))
    with torch.no_grad():
        tret = fresh(torch.from_numpy(points), torch.from_numpy(kp),
                     torch.from_numpy(palm))
    np.testing.assert_allclose(tret["pred_kp"].numpy(), np.asarray(jret["pred_kp"]),
                               atol=KP_TOL, rtol=0)


def test_port_checkpoint_round_trip(nets, tmp_path):
    """save -> load is bit-exact, and the file has the reference layout."""
    _, _, tmodel, _ = nets
    path = save_reference_checkpoint(tmodel, str(tmp_path / "ckpt" / "model_0001.pt"))
    sd = torch.load(path, weights_only=True)["model"]
    assert sd["bhand.sa1.conv_blocks.0.0.weight"].dim() == 4   # Conv2d
    assert sd["bhand.fp1.mlp_convs.0.weight"].dim() == 3       # Conv1d
    assert sd["final_mlp.2.weight"].dim() == 3                 # Conv1d
    assert sd["transt.c11.linear1.weight"].dim() == 2          # Linear
    assert "transt.c11.norm1.weight" in sd
    fresh = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM)
    load_reference_checkpoint(fresh, path)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_attention_weights_are_dropped_on_load(nets):
    _, _, tmodel, _ = nets
    ref = port_to_reference_state_dict(tmodel.state_dict())
    ref["transt.s11.attn.in_proj_weight"] = torch.zeros(3 * OUT_DIM, OUT_DIM)
    ref["c3.attn.out_proj.bias"] = torch.zeros(OUT_DIM)
    port = reference_to_port_state_dict(ref)
    assert not any(".attn." in k for k in port)
    HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).load_state_dict(port, strict=True)


def test_attention_mode_is_not_ported():
    """An FFN-mode module carries no attention weights, so asking it for
    attention raises; attention itself is ported (use_attention=True, held
    against the JAX package below)."""
    x = torch.zeros(1, 21, OUT_DIM)
    with pytest.raises(ValueError, match="without attention"):
        AttnModule(OUT_DIM)(x, None, x, None, attn=True)
    assert not any(".attn." in k for k in
                   HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM).state_dict())
    with pytest.raises(ValueError, match="handframe"):
        HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM, handframe="palm")


def _init_variables(jmodel, *args, **kwargs):
    variables = _to_numpy(jmodel.init(jax.random.PRNGKey(0), *args, **kwargs))
    if "batch_stats" in variables:
        variables["batch_stats"] = _randomize_stats(variables["batch_stats"],
                                                    np.random.RandomState(1))
    return variables


def test_attention_mode_forward_matches_jax(tmp_path):
    """use_attention=True: the live MultiheadAttention path of TransT and c3
    (8 heads, sine positional embedding) on converted weights. Tolerance 2e-5
    in the hand frame: the FFN-mode bound with the softmax and the embedding's
    sin/cos of arguments up to pi * 2^7 on top."""
    jmodel = JaxHandTrackNet(net_cfg=NET_CFG, backbone_out_dim=OUT_DIM, use_attention=True)
    points, kp = _inputs()
    palm = np.array(handkp2palmkp(jnp.asarray(kp))[0])
    variables = _init_variables(jmodel, jnp.asarray(points), jnp.asarray(kp),
                                jnp.asarray(palm))
    tmodel = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM, use_attention=True).eval()
    sd = handtracknet_state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert sd["transt.c12.attn.in_proj_weight"].shape == (3 * OUT_DIM, OUT_DIM)
    tmodel.load_state_dict(sd, strict=True)
    points, kp = _inputs(seed=7)
    jret = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(kp), jnp.asarray(palm))
    with torch.no_grad():
        tret = tmodel(torch.from_numpy(points), torch.from_numpy(kp), torch.from_numpy(palm))
    np.testing.assert_allclose(tret["pred_kp_handframe"].numpy(),
                               np.asarray(jret["pred_kp_handframe"]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tret["pred_kp"].numpy(), np.asarray(jret["pred_kp"]),
                               atol=KP_TOL, rtol=0)
    # attention weights survive the checkpoint round trip when the model has them
    path = save_reference_checkpoint(tmodel, str(tmp_path / "model_0001.pt"))
    fresh = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM, use_attention=True)
    load_reference_checkpoint(fresh, path)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # and in training every attention weight is reached
    tmodel.train()
    tmodel(torch.from_numpy(points), torch.from_numpy(kp),
           torch.from_numpy(palm))["pred_kp"].sum().backward()
    assert all(p.grad is not None for p in tmodel.parameters())


def test_obb_handframe_forward_matches_jax(nets):
    """handframe='OBB' takes the canonical pose from the caller (the
    pipeline's OBB_pose); same weights as the 'kp' net."""
    from hotrack_tpu.models.hand_utils import CanonPose as JaxCanonPose
    from hotrack_tpu_torch.models import CanonPose
    _, variables, tmodel, _ = nets
    jmodel = JaxHandTrackNet(net_cfg=NET_CFG, backbone_out_dim=OUT_DIM, handframe="OBB")
    omodel = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM, handframe="OBB").eval()
    omodel.load_state_dict(tmodel.state_dict())
    points, kp = _inputs(seed=8)
    rng = np.random.RandomState(9)
    q, _ = np.linalg.qr(rng.randn(2, 3, 3))
    rot = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)
    trans = points.mean(1)[..., None].astype(np.float32)
    scale = np.array([0.25, 0.3], np.float32)
    jret = jmodel.apply(variables, jnp.asarray(points), jnp.asarray(kp),
                        obb_pose=JaxCanonPose(jnp.asarray(rot), jnp.asarray(trans),
                                              jnp.asarray(scale)))
    with torch.no_grad():
        tret = omodel(torch.from_numpy(points), torch.from_numpy(kp),
                      obb_pose=CanonPose(torch.from_numpy(rot), torch.from_numpy(trans),
                                         torch.from_numpy(scale)))
    np.testing.assert_allclose(tret["pred_kp_handframe"].numpy(),
                               np.asarray(jret["pred_kp_handframe"]), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tret["pred_kp"].numpy(), np.asarray(jret["pred_kp"]),
                               atol=KP_TOL, rtol=0)
    with pytest.raises(ValueError, match="obb_pose"):
        omodel(torch.from_numpy(points), torch.from_numpy(kp))


@pytest.mark.parametrize("frame", ["kp", "camera"])
def test_iknet_forward_and_loss_match_jax(frame):
    """IKNet (width 64) on converted weights: raw_quat and MANO_theta 2e-5,
    the losses 1e-6, predicted keypoints through MANO 1e-5 m; and the
    reference-format checkpoint (coordinate-major first layer) round trip."""
    from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
    from hotrack_tpu.models import IKNet as JaxIKNet
    from hotrack_tpu.models import iknet_loss as jax_iknet_loss
    from hotrack_tpu.models.hand_network import iknet_predict_kp as jax_predict
    from hotrack_tpu_torch.mano.model import synthetic_mano_model
    from hotrack_tpu_torch.models import IKNet, iknet_loss, iknet_predict_kp
    from hotrack_tpu_torch.utils.convert import iknet_state_dict_from_flax

    jmodel = JaxIKNet(width=64, iknetframe=frame)
    _, kp = _inputs(b=3, seed=10)
    palm = np.array(handkp2palmkp(jnp.asarray(kp))[0])
    variables = _init_variables(jmodel, jnp.asarray(kp), jnp.asarray(palm))
    tmodel = IKNet(width=64, iknetframe=frame).eval()
    tmodel.load_state_dict(iknet_state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    _, kp = _inputs(b=3, seed=11)
    rng = np.random.RandomState(12)
    gt_quat = rng.randn(3, 60).astype(np.float32)
    gt_kp = kp + rng.randn(*kp.shape).astype(np.float32) * 0.01
    beta = (rng.randn(3, 10) * 0.1).astype(np.float32)

    jret = jmodel.apply(variables, jnp.asarray(kp), jnp.asarray(palm))
    with torch.no_grad():
        tret = tmodel(torch.from_numpy(kp), torch.from_numpy(palm))
        tloss, _ = iknet_loss(tret, torch.from_numpy(gt_quat), torch.from_numpy(gt_kp))
        tpred = iknet_predict_kp(synthetic_mano_model(), tret, torch.from_numpy(beta))
    jloss, _ = jax_iknet_loss(jret, jnp.asarray(gt_quat), jnp.asarray(gt_kp))
    jpred = jax_predict(jax_mano(), jret, jnp.asarray(beta))
    for k in ("raw_quat", "MANO_theta", "init_kp_handframe"):
        np.testing.assert_allclose(tret[k].numpy(), np.asarray(jret[k]), atol=2e-5,
                                   rtol=0, err_msg=k)
    assert set(tloss) == set(jloss)
    for k in jloss:
        np.testing.assert_allclose(float(tloss[k]), float(jloss[k]), atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-5, rtol=0)

    # the JAX package's checkpoint writer and the port's reader/writer agree
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = jax_save_ckpt(os.path.join(d, "model_0002.pt"), iknet=variables, epoch=2)
        fresh = IKNet(width=64, iknetframe=frame)
        assert load_reference_checkpoint(fresh, path) == 2
        for k, v in tmodel.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(fresh.state_dict()[k], v), k
        ref = torch.load(path, weights_only=True)["model"]
        mine = port_to_reference_state_dict(tmodel.state_dict())
        assert torch.equal(mine["linear.0.weight"], ref["linear.0.weight"])


def test_position_embedding_sine_matches_jax():
    rng = np.random.RandomState(6)
    coor = rng.randn(2, 30, 3).astype(np.float32)
    want = np.asarray(jax_pos(jnp.asarray(coor), num_pos_feats=8))
    got = position_embedding_sine(torch.from_numpy(coor), num_pos_feats=8).numpy()
    # sin/cos of arguments up to pi * 2^7: float32 argument rounding, 1e-4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
