"""BatchNorm statistics and dropout masks over the global batch.

Data-parallel training (train/dp.py) splits a global batch of B rows into D
equal shares, one a rank. The JAX package runs the same program under GSPMD,
where BatchNorm reduces over the global batch and dropout draws one mask for
it. The two modules here give a rank that result:

  - `GlobalBatchNorm1d` (the state-dict names of `nn.BatchNorm1d`, so
    checkpoints load and save unchanged) all-reduces, in train mode, the
    count and the sum of its rows, then the centred sum of squares (two
    passes: one pass of sum(x^2) cancels on inputs with a large mean), and in
    the backward sum(dy) and sum(dy * x_hat). The running variance takes the
    unbiased variance over the global count, torch's convention.
    `convert_batchnorm` swaps it in for every BatchNorm1d of a model.
  - `GlobalBatchDropout` draws the mask for the global batch from the
    process-wide generator of the tensor's device and keeps the rank's rows.
    Every model of the port uses it, so one process and D ranks draw the
    same masks from the same seed.

A rank states its share with `sharding(rank, world, all_reduce)`; outside it
the global batch is the local one (rank 0 of 1) and both modules compute what
their torch counterparts compute. The collectives are `all_reduce` (a sum, in
place) alone: with gloo on CUDA tensors only `all_reduce` and `broadcast`
exist.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


@dataclass(frozen=True)
class Share:
    """Rows [rank * b, (rank + 1) * b) of a global batch of world * b rows;
    `all_reduce` sums a tensor over the ranks in place."""
    rank: int = 0
    world: int = 1
    all_reduce: Callable[[torch.Tensor], None] | None = None


_share = Share()


@contextlib.contextmanager
def sharding(rank: int, world: int, all_reduce: Callable[[torch.Tensor], None]):
    """Within the block, the modules of this file see this process as rank
    `rank` of `world` (process-wide: one rank a process)."""
    global _share
    before, _share = _share, Share(rank, world, all_reduce)
    try:
        yield
    finally:
        _share = before


class GlobalBatchDropout(nn.Dropout):
    """nn.Dropout whose mask is drawn for the global batch: a Bernoulli(1 - p)
    draw of shape (world * B, ...) from the default generator of x's device,
    of which this rank keeps its B rows; kept units are divided by 1 - p taken
    in x's dtype, as flax divides (in bf16 by 0.8984375 for p = 0.1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return x * self.keep_mask(x) / torch.tensor(1.0 - self.p, dtype=x.dtype)

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch's mask, 0 or 1 in x's dtype."""
        share = _share
        b = x.shape[0]
        keep = torch.empty((share.world * b, *x.shape[1:]), dtype=x.dtype,
                           device=x.device).bernoulli_(1.0 - self.p)
        return keep[share.rank * b:(share.rank + 1) * b]


class _GlobalBatchNormFn(torch.autograd.Function):
    """Train-mode batch normalisation of x (R, C) over the rows of every rank."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, all_reduce):
        sums = torch.cat([x.sum(0), x.new_full((1,), x.shape[0])])
        all_reduce(sums)
        count = sums[-1]
        mean = sums[:-1] / count
        centred = x - mean
        sq = (centred * centred).sum(0)
        all_reduce(sq)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        x_hat = centred * invstd
        ctx.save_for_backward(x_hat, invstd, weight, count)
        ctx.all_reduce = all_reduce
        ctx.mark_non_differentiable(mean, var, count)
        return x_hat * weight + bias, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        x_hat, invstd, weight, count = ctx.saved_tensors
        c = x_hat.shape[1]
        local = torch.cat([dy.sum(0), (dy * x_hat).sum(0)])
        sums = local.clone()
        ctx.all_reduce(sums)
        sum_dy, sum_dy_xhat = sums[:c], sums[c:]
        dx = (weight * invstd / count) * (count * dy - sum_dy - x_hat * sum_dy_xhat)
        # the affine parameters' gradients stay the rank's own: the trainer's
        # all-reduce of every gradient sums them
        return dx, local[c:], local[:c], None, None


class GlobalBatchNorm1d(nn.BatchNorm1d):
    """nn.BatchNorm1d on (R, C) rows whose train-mode statistics are those of
    the global batch (see the module's docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        share = _share
        if not self.training or share.all_reduce is None:
            return super().forward(x)
        if x.dim() != 2:
            raise ValueError(f"GlobalBatchNorm1d takes (rows, C), got {tuple(x.shape)}")
        y, mean, var, count = _GlobalBatchNormFn.apply(x, self.weight, self.bias, self.eps,
                                                       share.all_reduce)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                     else self.momentum)
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var * (count / (count - 1)), alpha=m)
        return y


def convert_batchnorm(module: nn.Module) -> nn.Module:
    """Every nn.BatchNorm1d of `module` made a GlobalBatchNorm1d, in place:
    the same parameter and buffer objects (an optimizer built on them stays
    valid), the same state-dict names. Returns the module."""
    for m in module.modules():
        if type(m) is nn.BatchNorm1d:
            if not m.affine:
                raise ValueError("GlobalBatchNorm1d needs an affine BatchNorm")
            m.__class__ = GlobalBatchNorm1d  # it adds behaviour, no state
    return module
