"""Sequences split over devices: the port's counterpart of the JAX package's
`NamedSharding(P("seq"))` on the leading sequence axis of the sharded
trackers (track/hand.py, track/obj.py).

S sequences go in D equal contiguous shares, one a device; each share runs
the batched tracker on its device in a thread of its own, and the results
come back to the first device in sequence order. Sequences are independent,
so no collective runs. A device may repeat: two shares on one card is how a
one-card machine runs the split.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import nn


def resolve_devices(devices) -> list[torch.device]:
    """`devices`, or every visible card when None."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no device list given and no CUDA card visible")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def share_bounds(n_seq: int, n_dev: int) -> list[slice]:
    """The D contiguous shares of S sequences; S must divide by D."""
    if n_dev < 1 or n_seq % n_dev:
        raise ValueError(f"{n_seq} sequences do not split over {n_dev} devices "
                         f"(S must divide by D)")
    per = n_seq // n_dev
    return [slice(i * per, (i + 1) * per) for i in range(n_dev)]


class Mover:
    """Copies of what a tracker takes onto one device: tensors, modules (a
    deep copy a device, made once and shared by the shares on that device),
    the port's NamedTuples of tensors, and lists, tuples and dicts of these."""

    def __init__(self):
        self._modules: dict[tuple[int, torch.device], nn.Module] = {}

    def __call__(self, x, device: torch.device):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, nn.Module):
            key = (id(x), device)
            if key not in self._modules:
                on = {p.device for p in (*x.parameters(), *x.buffers())}
                self._modules[key] = x if on <= {device} else copy.deepcopy(x).to(device)
            return self._modules[key]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(self(v, device) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(self(v, device) for v in x)
        if isinstance(x, dict):
            return {k: self(v, device) for k, v in x.items()}
        return x


def leading_size(x) -> int:
    """S, the leading size of the first tensor of a nested dict."""
    if isinstance(x, dict):
        for v in x.values():
            n = leading_size(v)
            if n is not None:
                return n
        return None
    return x.shape[0] if isinstance(x, torch.Tensor) else None


def slice_tree(x, sl: slice):
    """Sequences `sl` of every tensor (leading S) of a nested dict."""
    if isinstance(x, dict):
        return {k: slice_tree(v, sl) for k, v in x.items()}
    return x[sl] if isinstance(x, torch.Tensor) else x


def run_shares(run, devices: list[torch.device], shares: list) -> list:
    """run(device, share) for each share on its device, a thread each (the
    thread's current card set to its device); the results in share order.
    A share's exception is raised here."""
    def one(device, share):
        if device.type == "cuda":
            with torch.cuda.device(device):
                return run(device, share)
        return run(device, share)

    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(one, d, s) for d, s in zip(devices, shares)]
        return [f.result() for f in futures]


def concat_results(results: list, device: torch.device):
    """The shares' NamedTuple results, each field concatenated on its leading
    (sequence) axis on `device`."""
    return type(results[0])(*(torch.cat([getattr(r, f).to(device) for r in results])
                              for f in results[0]._fields))
