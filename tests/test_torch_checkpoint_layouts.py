"""Reference checkpoints of every layout into the port's nets: a tracking
checkpoint with both nets under 'handnet.' and 'IKnet.' (the reference
trainer's layout, and what the JAX package's `save_reference_checkpoint`
writes for two nets), one net under its prefix alone, and plain keys (a
single-net training checkpoint), written from seeded nets. Each loads into
the port's HandTrackNet or IKNet with strict=True and gives bitwise the
weights the JAX package's `load_reference_checkpoint` reads from the same
file, carried over by `handtracknet_state_dict_from_flax` /
`iknet_state_dict_from_flax`. Toy widths (the NET_CFG of tests/test_models.py,
IKNet 64 wide).
"""

import pytest
import torch

from hotrack_tpu.utils.torch_convert import load_reference_checkpoint as jax_load_ckpt
from hotrack_tpu_torch.models import HandTrackNet, IKNet
from hotrack_tpu_torch.utils.convert import (handtracknet_state_dict_from_flax,
                                             iknet_state_dict_from_flax,
                                             load_reference_checkpoint,
                                             port_to_reference_state_dict)

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
OUT_DIM, IK_WIDTH = 48, 64
LAYOUTS = ("composed", "prefix alone", "plain")


def _seeded(model, seed):
    """The model with seeded weights and BN running statistics (none the
    init's), as a reference-layout state dict."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if v.is_floating_point():
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k
                        else torch.randn(v.shape, generator=gen) * 0.1)
    return port_to_reference_state_dict(model.state_dict())


def _save(path, sd):
    torch.save({"model": sd, "epoch": 7, "iteration": 0}, path)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{layout: {net: path}}: the files each net is loaded from."""
    hand = _seeded(HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM), 1)
    ik = _seeded(IKNet(width=IK_WIDTH), 2)
    prefixed = {"hand": {f"handnet.{k}": v for k, v in hand.items()},
                "ik": {f"IKnet.{k}": v for k, v in ik.items()}}
    root = tmp_path_factory.mktemp("ckpt")
    composed = _save(root / "composed.pt", {**prefixed["hand"], **prefixed["ik"]})
    return {"composed": {"hand": composed, "ik": composed},
            "prefix alone": {net: _save(root / f"{net}_prefixed.pt", sd)
                             for net, sd in prefixed.items()},
            "plain": {"hand": _save(root / "hand.pt", hand), "ik": _save(root / "ik.pt", ik)}}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("net", ["hand", "ik"])
def test_reference_checkpoint_layouts_load_the_jax_loaders_weights(checkpoints, layout, net):
    path = checkpoints[layout][net]
    model = HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM) if net == "hand" \
        else IKNet(width=IK_WIDTH)
    assert load_reference_checkpoint(model, path) == 7   # strict=True inside
    jax_vars = jax_load_ckpt(path, NET_CFG, d_model=OUT_DIM)
    jax_vars = jax_vars["handnet" if net == "hand" else "iknet"]
    to_port = handtracknet_state_dict_from_flax if net == "hand" else iknet_state_dict_from_flax
    want = to_port(jax_vars["params"], jax_vars["batch_stats"])
    got = model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_a_net_missing_from_the_checkpoint_raises(checkpoints):
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(IKNet(width=IK_WIDTH), checkpoints["prefix alone"]["hand"])
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(HandTrackNet(NET_CFG, backbone_out_dim=OUT_DIM),
                                  checkpoints["prefix alone"]["ik"])
