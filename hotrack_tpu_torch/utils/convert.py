"""Weights across packages and checkpoint formats.

The port's modules carry the reference's state-dict key names, with every
1x1 convolution held as an `nn.Linear`, and no attention weights (FFN mode).
A reference-format checkpoint ({'model': state_dict, 'epoch', 'iteration'}:
the original release's, or one written by
hotrack_tpu.utils.torch_export.save_reference_checkpoint) therefore loads
with `strict=True` after two mechanical steps: conv kernels (out, in, 1[, 1])
are squeezed to (out, in), and the never-executed `*.attn.*` entries are
dropped (kept, when the model was built with attention).

`export_handtracknet` / `export_iknet` turn a flax parameter tree of the JAX
package (nested dicts of arrays: params and batch_stats, or any tree of the
same structure, such as a gradient tree) into a reference-format state dict
of numpy arrays. They are the port's own numpy-only copy of
hotrack_tpu/utils/torch_export.py, held equal to it by a test; the copy also
exports attention-mode nets, into `nn.MultiheadAttention`'s layout.
`handtracknet_state_dict_from_flax` / `iknet_state_dict_from_flax` finish the
way into the port's modules.

`distilled_from_numpy` / `distilled_to_numpy` carry a distilled SDF between
the packages as a dict of numpy arrays ({'weights', 'biases', 'freqs',
'scale', 'clamp'}: the fields of either package's `DistilledSDF`); weights
are (in, out) in both, so nothing is transposed.
`sdf_decoder_state_dict_from_flax` turns the JAX package's `SDFDecoder`
params into the port's decoder state dict.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

# reference module kind of each port Linear, by key pattern: set-abstraction
# blocks are Conv2d, feature propagation / conv1 / rearrange / final_mlp are
# Conv1d, the FFN layers are Linear
_CONV2D_PARTS = (".conv_blocks.", "bhand.sa3.mlp_convs.")
_LINEAR_PARTS = (".linear1.", ".linear2.")


def _w(kernel, kind: str):
    """flax Dense kernel (in, out) -> torch weight of the given module kind."""
    w = np.asarray(kernel).T.copy()          # (out, in)
    if kind == "conv2d":
        return w[:, :, None, None]
    if kind == "conv1d":
        return w[:, :, None]
    return w                                  # linear


def _put_dense(sd, prefix, leaf, kind):
    sd[prefix + ".weight"] = _w(leaf["kernel"], kind)
    if "bias" in leaf:
        sd[prefix + ".bias"] = np.asarray(leaf["bias"])


def _put_bn(sd, prefix, p, s):
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])
    sd[prefix + ".running_mean"] = np.asarray(s["mean"])
    sd[prefix + ".running_var"] = np.asarray(s["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _put_shared_mlp(sd, conv_prefix, bn_prefix, p, s, kind):
    n = sum(1 for k in p if k.startswith("Dense_"))
    for j in range(n):
        _put_dense(sd, f"{conv_prefix}.{j}", p[f"Dense_{j}"], kind)
        _put_bn(sd, f"{bn_prefix}.{j}", p[f"BatchNorm_{j}"],
                s[f"BatchNorm_{j}"])


def _put_msg_sa(sd, prefix, p, s):
    n = sum(1 for k in p if k.startswith("SharedMLP_"))
    for i in range(n):
        _put_shared_mlp(sd, f"{prefix}.conv_blocks.{i}",
                        f"{prefix}.bn_blocks.{i}",
                        p[f"SharedMLP_{i}"], s[f"SharedMLP_{i}"], "conv2d")


def _put_plain(sd, prefix, p, s, kind):
    _put_shared_mlp(sd, f"{prefix}.mlp_convs", f"{prefix}.mlp_bns",
                    p["SharedMLP_0"], s["SharedMLP_0"], kind)


def _put_layernorm(sd, prefix, leaf):
    sd[prefix + ".weight"] = np.asarray(leaf["scale"])
    sd[prefix + ".bias"] = np.asarray(leaf["bias"])


_MHA = "MultiHeadDotProductAttention_0"


def _put_mha(sd, prefix, p):
    """flax MultiHeadDotProductAttention {query, key, value: kernel
    (d, H, hd), bias (H, hd); out: kernel (H, hd, d), bias (d)} ->
    nn.MultiheadAttention's packed in_proj (3d, d) and out_proj."""
    d = np.asarray(p["out"]["bias"]).shape[0]
    qkv = [p[name] for name in ("query", "key", "value")]
    sd[prefix + ".in_proj_weight"] = np.concatenate(
        [np.asarray(leaf["kernel"]).reshape(-1, d).T for leaf in qkv], axis=0)
    sd[prefix + ".in_proj_bias"] = np.concatenate(
        [np.asarray(leaf["bias"]).reshape(d) for leaf in qkv], axis=0)
    sd[prefix + ".out_proj.weight"] = np.asarray(p["out"]["kernel"]).reshape(d, d).T.copy()
    sd[prefix + ".out_proj.bias"] = np.asarray(p["out"]["bias"])


def _put_attn_module(sd, prefix, p):
    """attn_module: [attention,] norm1 and the optional FFN. An FFN-mode
    tree (the shipped graph) has no attention entry and exports none, as the
    JAX package's exporter does; an attention-mode tree exports its
    MultiHeadDotProductAttention as `<prefix>.attn.*`."""
    extra = {k for k in p if k not in
             ("LayerNorm_0", "LayerNorm_1", "Dense_0", "Dense_1", _MHA)}
    if extra:
        raise ValueError(f"{prefix} carries parameters this exporter does not "
                         f"know: {sorted(extra)}")
    if _MHA in p:
        _put_mha(sd, prefix + ".attn", p[_MHA])
    _put_layernorm(sd, prefix + ".norm1", p["LayerNorm_0"])
    if "Dense_0" in p:
        _put_dense(sd, prefix + ".linear1", p["Dense_0"], "linear")
        _put_dense(sd, prefix + ".linear2", p["Dense_1"], "linear")
        _put_layernorm(sd, prefix + ".norm2", p["LayerNorm_1"])


def export_handtracknet(params: dict, batch_stats: dict) -> dict:
    """flax HandTrackNet (params, batch_stats) -> reference state dict
    (numpy values)."""
    sd = {}
    bp, bs = params["bhand"], batch_stats["bhand"]
    for name in ("sa1", "sa2"):
        _put_msg_sa(sd, f"bhand.{name}", bp[name], bs[name])
    _put_plain(sd, "bhand.sa3", bp["sa3"], bs["sa3"], "conv2d")
    for name in ("fp3", "fp2", "fp1"):
        _put_plain(sd, f"bhand.{name}", bp[name], bs[name], "conv1d")
    _put_dense(sd, "bhand.conv1", bp["conv1"], "conv1d")
    _put_bn(sd, "bhand.bn1", bp["bn1"], bs["bn1"])

    for name in ("q1", "q2"):
        _put_msg_sa(sd, name, params[name], batch_stats[name])

    for name in ("r1", "r2"):
        # rearrange_module.linear is a Conv1d in the reference
        _put_dense(sd, f"{name}.linear", params[name]["Dense_0"], "conv1d")

    for i, tname in enumerate(("s11", "s12", "c11", "c12")):
        _put_attn_module(sd, f"transt.{tname}", params["transt"][f"AttnModule_{i}"])
    _put_attn_module(sd, "c3", params["c3"])

    _put_dense(sd, "final_mlp.0", params["final_mlp_0"], "conv1d")
    _put_dense(sd, "final_mlp.2", params["final_mlp_2"], "conv1d")
    return sd


def _iknet_input_perm():
    """Column permutation mapping the kp-major flatten of (B, 21, 3) (both
    packages' IKNet) onto the reference's coordinate-major flatten of
    (B, 3, 21), for the keypoint half and the bone half of the input."""
    perm = np.zeros(126, np.int64)
    for half in (0, 1):
        for i in range(21):
            for c in range(3):
                perm[half * 63 + i * 3 + c] = half * 63 + c * 21 + i
    return perm


def export_iknet(params: dict, batch_stats: dict) -> dict:
    """flax IKNet -> reference state dict, inverting the first-layer input
    permutation (kp-major flatten -> coordinate-major)."""
    sd = {}
    perm = _iknet_input_perm()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    n_lin = sum(1 for k in params if k.startswith("linear_"))
    for i in range(n_lin):
        leaf = dict(params[f"linear_{i}"])
        if i == 0:
            leaf["kernel"] = np.asarray(leaf["kernel"])[inv]
        _put_dense(sd, f"linear.{i}", leaf, "linear")
        if f"bn_{i}" in params:
            _put_bn(sd, f"bn.{i}", params[f"bn_{i}"], batch_stats[f"bn_{i}"])
    return sd


def reference_to_port_state_dict(sd: dict, keep_attention: bool = False) -> dict:
    """Reference-format state dict (tensors or arrays) -> the port's: conv
    kernels squeezed to Linear weights; IKNet's first Linear takes the
    port's kp-major input order; the attention entries (`<module>.attn.*`)
    are dropped unless the model was built with attention."""
    out = {}
    iknet = "linear.0.weight" in sd
    for k, v in sd.items():
        if ".attn." in k and not keep_attention:
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        if k.endswith(".weight") and t.dim() > 2:
            t = t.reshape(t.shape[0], t.shape[1])
        if iknet and k == "linear.0.weight":
            t = t[:, torch.from_numpy(_iknet_input_perm())]
        out[k] = t
    return out


def port_to_reference_state_dict(sd: dict) -> dict:
    """The port's state dict -> the reference's layout: Linear weights of
    HandTrackNet's convolution modules unsqueezed to their kernel shapes;
    IKNet (all Linear) gets its first layer's coordinate-major input order
    back."""
    out = {}
    iknet = "linear.0.weight" in sd
    inv = torch.from_numpy(np.argsort(_iknet_input_perm()))
    for k, v in sd.items():
        t = v.detach().cpu().clone()
        if iknet:
            if k == "linear.0.weight":
                t = t[:, inv]
        elif k.endswith(".weight") and t.dim() == 2 and ".attn." not in k:
            if any(p in k for p in _CONV2D_PARTS):
                t = t[:, :, None, None]
            elif not any(p in k for p in _LINEAR_PARTS):
                t = t[:, :, None]
        out[k] = t
    return out


def handtracknet_state_dict_from_flax(params: dict, batch_stats: dict,
                                      dtype: torch.dtype = torch.float32) -> dict:
    """JAX package HandTrackNet (params, batch_stats as numpy arrays) -> the
    port's state_dict (tensors of `dtype`; BN counters int64)."""
    return _typed(reference_to_port_state_dict(
        export_handtracknet(params, batch_stats), keep_attention=True), dtype)


def iknet_state_dict_from_flax(params: dict, batch_stats: dict,
                               dtype: torch.dtype = torch.float32) -> dict:
    """JAX package IKNet (params, batch_stats as numpy arrays) -> the port's
    state_dict. Both packages flatten the input kp-major, so the exporter's
    first-layer permutation is undone on the way."""
    return _typed(reference_to_port_state_dict(export_iknet(params, batch_stats)), dtype)


def _typed(sd: dict, dtype: torch.dtype) -> dict:
    return {k: v.to(torch.int64) if k.endswith("num_batches_tracked")
            else v.to(dtype) for k, v in sd.items()}


def checkpoint_prefix(model: nn.Module) -> str:
    """The key prefix of `model`'s net in a composed reference checkpoint
    (the reference trainer saves HandTrackNet under 'handnet.' and IKNet
    under 'IKnet.')."""
    from ..models.hand_network import HandTrackNet, IKNet
    if isinstance(model, HandTrackNet):
        return "handnet."
    if isinstance(model, IKNet):
        return "IKnet."
    raise TypeError(f"no reference checkpoint layout for {type(model).__name__}")


def load_reference_state(model: nn.Module, sd: dict) -> None:
    """Load a reference-format state dict into `model` (HandTrackNet or
    IKNet) with strict=True. A composed checkpoint's entries under the
    model's prefix are taken ('handnet.' for HandTrackNet, 'IKnet.' for
    IKNet); a state dict with none of them is read as plain keys, as the JAX
    package's loader reads it."""
    prefix = checkpoint_prefix(model)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)} or sd
    keep = any(".attn." in k for k in model.state_dict())
    model.load_state_dict(reference_to_port_state_dict(sd, keep), strict=True)


def load_reference_checkpoint(model: nn.Module, path: str) -> int:
    """Load a reference-format .pt into `model` (`load_reference_state`);
    returns the stored epoch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state(model, ckpt.get("model", ckpt))
    return int(ckpt.get("epoch", 0))


def save_reference_checkpoint(model: nn.Module, path: str, epoch: int = 0) -> str:
    """Write `model` as a reference-format .pt ({'model', 'epoch',
    'iteration'})."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": port_to_reference_state_dict(model.state_dict()),
                "epoch": epoch, "iteration": 0}, path)
    return path


def distilled_to_numpy(model) -> dict:
    """A `DistilledSDF` of either package -> {'weights': tuple of (in, out)
    arrays, 'biases': tuple, 'freqs' (F,), 'scale' (), 'clamp' ()} as
    float32 numpy arrays."""
    def arr(a):
        return np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float32)

    return {"weights": tuple(arr(w) for w in model.weights),
            "biases": tuple(arr(b) for b in model.biases),
            "freqs": arr(model.freqs), "scale": arr(model.scale),
            "clamp": arr(model.clamp)}


def distilled_from_numpy(arrays, device=None, dtype: torch.dtype = torch.float32):
    """The port's `DistilledSDF` from `distilled_to_numpy`'s dict, or from
    any object with those fields as arrays (the JAX package's tuple)."""
    from ..sdf.distill import DistilledSDF
    if not isinstance(arrays, dict):
        arrays = distilled_to_numpy(arrays)

    def ten(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return DistilledSDF(tuple(ten(w) for w in arrays["weights"]),
                        tuple(ten(b) for b in arrays["biases"]),
                        ten(arrays["freqs"]), ten(arrays["scale"]), ten(arrays["clamp"]))


def sdf_decoder_state_dict_from_flax(params: dict,
                                     dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's `SDFDecoder` params ({'lin{i}': {'v', 'g', 'bias'}
    for weight-normalised layers, {'kernel', 'bias'} otherwise, 'bn{i}':
    {'scale', 'bias'}}) -> the port's `SDFDecoder` state dict. The g / v
    split is kept: v (out, in) and g (out, 1) as they are; a plain kernel
    (in, out) is transposed to `weight` (out, in). The inverse of the JAX
    package's sdf/assets.load_torch_decoder."""
    names = {"v": "weight_v", "g": "weight_g", "bias": "bias", "scale": "weight"}
    sd = {}
    for layer, leaves in params.items():
        for key, value in leaves.items():
            a = np.asarray(value)
            if key == "kernel":
                sd[f"{layer}.weight"] = torch.tensor(a.T.copy(), dtype=dtype)
            else:
                sd[f"{layer}.{names[key]}"] = torch.tensor(a, dtype=dtype)
    return sd
