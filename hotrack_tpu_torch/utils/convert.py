"""Weights across packages and checkpoint formats.

The port's modules carry the reference's state-dict key names, with every
1x1 convolution held as an `nn.Linear`, and no attention weights (FFN mode).
A reference-format checkpoint ({'model': state_dict, 'epoch', 'iteration'}:
the original release's, or one written by
hotrack_tpu.utils.torch_export.save_reference_checkpoint) therefore loads
with `strict=True` after two mechanical steps: conv kernels (out, in, 1[, 1])
are squeezed to (out, in), and the never-executed `*.attn.*` entries are
dropped. `handtracknet_state_dict_from_flax` carries the JAX package's
parameters over through its own (numpy-only) exporter, imported only there:
nothing else of the port touches the JAX package.
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


def reference_to_port_state_dict(sd: dict) -> dict:
    """Reference-format HandTrackNet state dict (tensors or arrays) -> the
    port's: conv kernels squeezed to Linear weights, the attention entries
    (`<module>.attn.*`, unused in FFN mode) dropped."""
    out = {}
    for k, v in sd.items():
        if ".attn." in k:
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        if k.endswith(".weight") and t.dim() > 2:
            t = t.reshape(t.shape[0], t.shape[1])
        out[k] = t
    return out


def port_to_reference_state_dict(sd: dict) -> dict:
    """The port's HandTrackNet state dict -> the reference's layout (Linear
    weights of convolution modules unsqueezed to their kernel shapes)."""
    out = {}
    for k, v in sd.items():
        t = v.detach().cpu().clone()
        if k.endswith(".weight") and t.dim() == 2:
            if any(p in k for p in _CONV2D_PARTS):
                t = t[:, :, None, None]
            elif not any(p in k for p in _LINEAR_PARTS):
                t = t[:, :, None]
        out[k] = t
    return out


def handtracknet_state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    """JAX package HandTrackNet (params, batch_stats as numpy arrays) -> the
    port's state_dict (float32 tensors; BN counters int64)."""
    from hotrack_tpu.utils.torch_export import export_handtracknet
    sd = reference_to_port_state_dict(export_handtracknet(params, batch_stats))
    return {k: v.to(torch.int64) if k.endswith("num_batches_tracked")
            else v.to(torch.float32) for k, v in sd.items()}


def load_reference_checkpoint(model: nn.Module, path: str) -> int:
    """Load a reference-format .pt into `model` with strict=True; returns the
    stored epoch. Tracking checkpoints' 'handnet.' prefix is stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    if any(k.startswith("handnet.") for k in sd):
        sd = {k[len("handnet."):]: v for k, v in sd.items()
              if k.startswith("handnet.")}
    model.load_state_dict(reference_to_port_state_dict(sd), strict=True)
    return int(ckpt.get("epoch", 0))


def save_reference_checkpoint(model: nn.Module, path: str, epoch: int = 0) -> str:
    """Write `model` as a reference-format .pt ({'model', 'epoch',
    'iteration'})."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": port_to_reference_state_dict(model.state_dict()),
                "epoch": epoch, "iteration": 0}, path)
    return path
