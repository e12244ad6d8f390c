"""Plain reference (benchmark): a frozen copy of the plain code of
hotrack_tpu_torch/nn/transformer.py, without the kernel dispatch and what the benchmark does not
use; it imports nothing of the port.

Attention / FFN fusion modules (port of hotrack_tpu/nn/transformer.py).

The reference ships a TransT-style attention stack but every call site passes
attn=False, so in the shipped graph only the LayerNorm + FFN path runs. Both
paths are here. A module built with `attention=False` (the default) carries
no attention weights, as a flax FFN-mode tree has none: a reference
checkpoint's unused `*.attn.*` entries are dropped on load
(utils/convert.py), and asking such a module for attention raises. With
`attention=True` it holds an `nn.MultiheadAttention` (8 heads) under the
reference's name `attn`; the JAX package computes its attention outside any
Pallas kernel, so the library module is the counterpart here.

The residual and FFN dropouts draw their masks for the global batch
(nn/global_batch.py), so data-parallel ranks draw what one process draws; the
attention weights' own dropout inside `nn.MultiheadAttention` draws a rank's
rows alone.

In FFN mode `TransT` is two independent chains: s11 -> c11 on the keypoint
features gives `result1`, and s12 -> c12 on the cloud features gives
`result2`, which HandTrackNet only passes to `c3` as the attention source
that FFN mode ignores. So with attn=False `TransT.forward` computes
`result1` only and returns None for `result2`; s12 and c12 keep their weights
so checkpoints load unchanged, and they get no gradient in training, which
is what the JAX trainer's reachability mask freezes.

With a compute dtype (nn/precision.py) the FFN runs as the JAX module's:
LayerNorm on float32, linear1, ReLU, dropout and linear2 in the compute
dtype, then float32 for the second dropout, the residual and LayerNorm. The
attention itself runs on float32 inputs, as flax promotes them.
"""

from __future__ import annotations

import torch
from torch import nn

from .precision import dense, to_f32


class AttnModule(nn.Module):
    """[MHA + residual,] LayerNorm, then (unless no_linear) a residual FFN
    and a second LayerNorm (eps 1e-5). Channels-last: src (B, N, C)."""

    def __init__(self, d_model: int = 384, no_linear: bool = False,
                 dim_feedforward: int = 1024, dropout: float = 0.1,
                 attention: bool = False, nhead: int = 8, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.no_linear = no_linear
        if attention:
            self.attn = nn.MultiheadAttention(d_model, nhead, dropout=dropout,
                                              batch_first=True)
            self.dropout1 = nn.Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        if not no_linear:
            self.linear1 = nn.Linear(d_model, dim_feedforward)
            self.linear2 = nn.Linear(dim_feedforward, d_model)
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
            self.dropout = nn.Dropout(dropout)

    def forward(self, src1: torch.Tensor, pos1=None, src2=None, pos2=None,
                attn: bool = False) -> torch.Tensor:
        cd = self.compute_dtype
        if attn:
            if not hasattr(self, "attn"):
                raise ValueError("this AttnModule was built without attention "
                                 "weights (attention=False)")
            q = src1 if pos1 is None else src1 + pos1
            k = src2 if pos2 is None else src2 + pos2
            out, _ = self.attn(to_f32(q, cd), to_f32(k, cd), to_f32(src2, cd),
                               need_weights=False)
            src1 = src1 + self.dropout1(out)
        src1 = self.norm1(to_f32(src1, cd))
        if not self.no_linear:
            h = self.dropout(torch.relu(dense(self.linear1, src1, cd)))
            h = to_f32(dense(self.linear2, h, cd), cd)
            src1 = self.norm2(src1 + self.dropout(h))
        return src1


class TransT(nn.Module):
    """2x self + 2x cross attention stack -> (result1, result2)."""

    def __init__(self, d_model: int = 384, attention: bool = False, compute_dtype=None):
        super().__init__()
        kw = dict(attention=attention, compute_dtype=compute_dtype)
        self.s11 = AttnModule(d_model, no_linear=True, **kw)
        self.s12 = AttnModule(d_model, no_linear=True, **kw)
        self.c11 = AttnModule(d_model, **kw)
        self.c12 = AttnModule(d_model, **kw)

    def forward(self, src1, pos1=None, src2=None, pos2=None, attn: bool = False):
        src11 = self.s11(src1, pos1, src1, pos1, attn)
        if not attn:
            return self.c11(src11), None
        src12 = self.s12(src2, pos2, src2, pos2, attn)
        return (self.c11(src11, pos1, src12, pos2, attn),
                self.c12(src12, pos2, src11, pos1, attn))
