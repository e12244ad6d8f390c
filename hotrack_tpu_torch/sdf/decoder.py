"""DeepSDF decoder (port of hotrack_tpu/sdf/decoder.py).

An 8x512 weight-normalised MLP over [latent (256), xyz (3)], with the full
input concatenated again at the layers listed in `latent_in` (so the layer
before each is narrower by latent_size + 3), ReLU and dropout between layers
and a final tanh, which the reference applies whatever `use_tanh` says.

Weight norm is explicit, with the parameter names of torch's
`nn.utils.weight_norm` (`lin{i}.weight_g` (out, 1), `lin{i}.weight_v`
(out, in), `lin{i}.bias`), so a reference DeepSDF checkpoint's
`model_state_dict` loads with `load_state_dict` once its `module.` prefix is
stripped (sdf/assets.load_torch_decoder).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class WNLinear(nn.Module):
    """Linear layer with torch-style weight normalisation over output rows:
    W = g * v / ||v||_row."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.normal_(self.weight_v, std=in_features ** -0.5)

    def forward(self, x):
        w = self.weight_g * self.weight_v / torch.linalg.norm(
            self.weight_v, dim=-1, keepdim=True)
        return torch.matmul(x, w.t()) + self.bias


class SDFDecoder(nn.Module):
    """DeepSDF MLP: x (N, latent_size + 3) -> sdf (N, 1)."""

    def __init__(self, latent_size: int = 256,
                 dims: Sequence[int] = (512,) * 8,
                 dropout: Sequence[int] = tuple(range(8)),
                 dropout_prob: float = 0.2,
                 norm_layers: Sequence[int] = tuple(range(8)),
                 latent_in: Sequence[int] = (4,),
                 weight_norm: bool = True, use_tanh: bool = False):
        super().__init__()
        all_dims = [latent_size + 3] + list(dims) + [1]
        self.num_layers = len(all_dims)
        self.latent_in = tuple(latent_in)
        self.dropout = tuple(dropout)
        self.dropout_prob = dropout_prob
        self.use_tanh = use_tanh
        for l in range(self.num_layers - 1):
            out_dim = all_dims[l + 1]
            if l + 1 in self.latent_in:
                out_dim -= all_dims[0]
            in_dim = all_dims[l]  # the concatenation restores the full width
            if weight_norm and l in norm_layers:
                setattr(self, f"lin{l}", WNLinear(in_dim, out_dim))
            else:
                setattr(self, f"lin{l}", nn.Linear(in_dim, out_dim))
                if l in norm_layers:
                    # eps of the JAX package's flax LayerNorm (torch's default is 1e-5)
                    setattr(self, f"bn{l}", nn.LayerNorm(out_dim, eps=1e-6))

    def forward(self, x):
        inp = x
        for l in range(self.num_layers - 1):
            if l in self.latent_in:
                x = torch.cat([x, inp], dim=-1)
            x = getattr(self, f"lin{l}")(x)
            bn = getattr(self, f"bn{l}", None)
            if bn is not None:
                x = bn(x)
            if l == self.num_layers - 2 and self.use_tanh:
                x = torch.tanh(x)
            if l < self.num_layers - 2:
                x = torch.relu(x)
                if l in self.dropout:
                    x = nn.functional.dropout(x, self.dropout_prob, self.training)
        return torch.tanh(x)  # the reference's unconditional final tanh
