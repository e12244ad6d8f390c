"""FFN-mode fusion modules (port of hotrack_tpu/nn/transformer.py).

The reference ships a TransT-style attention stack but every call site passes
attn=False, so only the LayerNorm + FFN path runs. This port implements that
path; `attn=True` raises NotImplementedError (ROADMAP.md, queue 1). The
modules carry no attention weights: a reference checkpoint's unused
`*.attn.*` entries are dropped on load (utils/convert.py).

In FFN mode `TransT` is two independent chains: s11 -> c11 on the keypoint
features gives `result1`, and s12 -> c12 on the cloud features gives
`result2`, which HandTrackNet only passes to `c3` as the attention source
that FFN mode ignores. `TransT.forward` therefore computes `result1` only;
s12 and c12 keep their weights so checkpoints load unchanged, and the
outputs are those of the full stack.
"""

from __future__ import annotations

import torch
from torch import nn

ATTENTION_NOT_PORTED = ("attention mode (use_attention=True) is not ported yet: "
              "see ROADMAP.md, queue 1 (nn/transformer.py live-attention path)")


class AttnModule(nn.Module):
    """Residual LayerNorm + FFN block in FFN mode (eps 1e-5; dropout is off
    in eval)."""

    def __init__(self, d_model: int = 384, no_linear: bool = False,
                 dim_feedforward: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.no_linear = no_linear
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        if not no_linear:
            self.linear1 = nn.Linear(d_model, dim_feedforward)
            self.linear2 = nn.Linear(dim_feedforward, d_model)
            self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
            self.dropout = nn.Dropout(dropout)

    def forward(self, src1: torch.Tensor, attn: bool = False) -> torch.Tensor:
        if attn:
            raise NotImplementedError(ATTENTION_NOT_PORTED)
        src1 = self.norm1(src1)
        if not self.no_linear:
            h = self.dropout(torch.relu(self.linear1(src1)))
            src1 = self.norm2(src1 + self.dropout(self.linear2(h)))
        return src1


class TransT(nn.Module):
    """2x self + 2x cross attention stack, FFN mode: returns result1."""

    def __init__(self, d_model: int = 384):
        super().__init__()
        self.s11 = AttnModule(d_model, no_linear=True)
        self.s12 = AttnModule(d_model, no_linear=True)
        self.c11 = AttnModule(d_model)
        self.c12 = AttnModule(d_model)

    def forward(self, src1: torch.Tensor, attn: bool = False) -> torch.Tensor:
        return self.c11(self.s11(src1, attn), attn)
