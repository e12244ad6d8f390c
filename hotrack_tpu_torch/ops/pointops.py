"""Point-cloud primitive ops in PyTorch.

Port of hotrack_tpu/ops/pointops.py with its semantics (which follow the
reference's CUDA extension):

- FPS seeds at index 0, keeps a running min of the squared distance and
  takes the argmax with ties to the lowest index; masked points are never
  picked while a valid one is left.
- ball query keeps the first <= nsample points with d^2 < r^2 in *index*
  order and pads by repeating the first hit (index 0 when there is none).
- knn returns the k smallest euclidean (sqrt'd) distances ascending, ties to
  the lower index; three_nn returns *squared* distances. Neither distance
  carries a gradient.

Layout is channels-last like the JAX package: points (B, N, 3), features
(B, N, C); `gather_operation`, `group_operation` and `three_interpolate` keep
the reference's channels-first signatures.

`farthest_point_sample` and `index_points` dispatch on the tensor's device: a
CUDA tensor goes to the hand-written kernels (csrc/fps.cu, csrc/gather_rows.cu
via ops/kernels.py), a CPU tensor to the plain versions below, which are also
the kernels' oracles. There is no size threshold: the JAX package's rule for
its gather kernel (rows >= 16384, N <= 1024) is about the TPU's VMEM and
launch latency.
"""

from __future__ import annotations

import torch

from . import kernels


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distances, expanded form (same op order as the JAX
    package). src (B, N, C), dst (B, M, C) -> (B, N, M)."""
    d = -2.0 * torch.matmul(src, dst.transpose(-1, -2))
    d = d + torch.sum(src**2, dim=-1)[..., :, None]
    d = d + torch.sum(dst**2, dim=-1)[..., None, :]
    return d


def _gather_rows_torch(points: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Plain row gather: points (B, N, C), flat_idx (B, S) -> (B, S, C). The
    CPU path and the kernel's oracle (in-range indices only)."""
    c = points.shape[-1]
    return torch.gather(points, 1, flat_idx.long()[..., None].expand(-1, -1, c))


def _scatter_rows_add_torch(dout: torch.Tensor, flat_idx: torch.Tensor, n: int,
                            acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain adjoint of the row gather: dout (B, S, C), flat_idx (B, S) ->
    (B, n, C) of dout's dtype, summed by `index_add_` per batch row in
    `acc_dtype` (default: float32, or dout's own type if that is wider). On
    the CPU `index_add_` adds in ascending s, the kernel's order. As the
    kernel's oracle on the card, where `index_add_` uses atomics in no fixed
    order, pass float64 so the order cannot show at the tolerance."""
    b, _, c = dout.shape
    if acc_dtype is None:
        acc_dtype = torch.promote_types(dout.dtype, torch.float32)
    out = torch.zeros((b, n, c), dtype=acc_dtype, device=dout.device)
    idx = flat_idx.long()
    for i in range(b):
        out[i].index_add_(0, idx[i], dout[i].to(acc_dtype))
    return out.to(dout.dtype)


class _GatherRows(torch.autograd.Function):
    """Row gather whose backward is the deterministic scatter-add; each
    direction runs its CUDA kernel on a CUDA tensor and its plain version on
    a CPU tensor."""

    @staticmethod
    def forward(ctx, points, flat_idx):
        ctx.save_for_backward(flat_idx)
        ctx.n = points.shape[1]
        if points.is_cuda:
            return kernels.gather_rows_cuda(points.contiguous(), flat_idx)
        return _gather_rows_torch(points, flat_idx)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None
        (flat_idx,) = ctx.saved_tensors
        if dout.is_cuda:
            # autograd runs this on the forward's stream; the wrapper takes
            # the current stream itself and keeps its tensors until launched
            return kernels.scatter_rows_add_cuda(dout.contiguous(), flat_idx,
                                                 ctx.n), None
        return _scatter_rows_add_torch(dout, flat_idx, ctx.n), None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S) or (B, S1, .., Sk) -> (B, *idx, C).
    Differentiable in `points`. A CUDA tensor (float32 or bfloat16) runs the
    hand-written kernels; a CPU tensor the plain versions."""
    if points.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no row gather for device {points.device}")
    b, _, c = points.shape
    flat = idx.reshape(b, -1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.long()
    out = _GatherRows.apply(points, flat.contiguous())
    return out.reshape(*idx.shape, c)


def gather_operation(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feature (B, C, N), idx (B, S) -> (B, C, S)."""
    c = feature.shape[1]
    return torch.gather(feature, 2, idx.long()[:, None, :].expand(-1, c, -1))


def group_operation(feature: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feature (B, C, N), idx (B, S, K) -> (B, C, S, K)."""
    b, c, _ = feature.shape
    _, s, k = idx.shape
    flat = idx.long().reshape(b, 1, s * k).expand(-1, c, -1)
    return torch.gather(feature, 2, flat).reshape(b, c, s, k)


def _smallest_k(d: torch.Tensor, k: int):
    """k smallest values along the last axis, ascending, ties to the lower
    index (a stable sort, as jax.lax.top_k on the negated values)."""
    val, idx = torch.sort(d, dim=-1, stable=True)
    return val[..., :k], idx[..., :k]


def knn_point(k: int, query: torch.Tensor, data: torch.Tensor):
    """k nearest neighbours of `query` (B, S, C) among `data` (B, N, C).
    Returns (dist (B, S, k) ascending sqrt'd distances, idx (B, S, k))."""
    d2, idx = _smallest_k(square_distance(query, data), k)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    return dist.detach(), idx


def three_nn(query: torch.Tensor, data: torch.Tensor):
    """3 nearest neighbours: (squared distances ascending, indices)."""
    d2, idx = _smallest_k(square_distance(query, data), 3)
    return torch.clamp(d2, min=0.0).detach(), idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """points (B, C, M), idx (B, N, 3), weight (B, N, 3) -> (B, C, N)."""
    gathered = group_operation(points, idx)  # (B, C, N, 3)
    return torch.sum(gathered * weight[:, None, :, :], dim=-1)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Iterative farthest point sampling. xyz (B, N, 3) -> idx (B, npoint)
    int32. A CUDA tensor runs the hand-written kernel; a CPU tensor the plain
    version."""
    if xyz.is_cuda:
        return kernels.fps_cuda(xyz.contiguous(), npoint,
                                None if valid_mask is None
                                else valid_mask.contiguous())
    if xyz.device.type != "cpu":
        raise ValueError(f"no FPS for device {xyz.device}")
    return _farthest_point_sample_torch(xyz, npoint, valid_mask)


def _farthest_point_sample_torch(xyz: torch.Tensor, npoint: int,
                                 valid_mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch FPS: the CPU path and the kernel's oracle. The distance
    is summed ((dx*dx) + (dy*dy)) + (dz*dz), as the kernel and the JAX
    reference sum it; torch.argmax returns the first maximal index."""
    b, n, _ = xyz.shape
    if valid_mask is None:
        distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    else:
        distance = torch.where(valid_mask.bool(),
                               torch.tensor(1e10, dtype=xyz.dtype, device=xyz.device),
                               torch.tensor(-1.0, dtype=xyz.dtype, device=xyz.device))
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(b, device=xyz.device)
    farthest = torch.zeros(b, dtype=torch.long, device=xyz.device)
    centroids = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, farthest][:, None]
        dy = y - y[rows, farthest][:, None]
        dz = z - z[rows, farthest][:, None]
        dist = (dx * dx + dy * dy) + dz * dz
        distance = torch.minimum(distance, dist)
        farthest = torch.argmax(distance, dim=-1)
        centroids[:, i] = farthest.to(torch.int32)
    return centroids


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ball query: for each centre, the first <= nsample point indices with
    d^2 < radius^2 in index order, padded with the first hit.
    xyz (B, N, 3), new_xyz (B, S, 3) -> (B, S, nsample) int64."""
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    within = square_distance(new_xyz, xyz) < radius * radius
    if valid_mask is not None:
        within = within & valid_mask.bool()[:, None, :]
    iota = torch.arange(n, device=xyz.device).expand(b, s, n)
    cand = torch.where(within, iota, torch.full_like(iota, n))
    group_idx = torch.topk(cand, nsample, dim=-1, largest=False,
                           sorted=True).values
    first = group_idx[:, :, :1]
    first = torch.where(first == n, torch.zeros_like(first), first)
    return torch.where(group_idx == n, first, group_idx)


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """Single global group. xyz (B, N, 3), points (B, N, D) -> new_xyz
    (B, 1, 3) zeros, new_points (B, 1, N, 3+D)."""
    b, n, c = xyz.shape
    new_xyz = torch.zeros((b, 1, c), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz.reshape(b, 1, n, c)
    if points is not None:
        grouped = torch.cat([grouped, points.reshape(b, 1, n, -1)], dim=-1)
    return new_xyz, grouped
