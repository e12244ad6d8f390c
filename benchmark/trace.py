"""Reduction of a torch.profiler trace of the window to what the per-layer
readers take: device intervals, their union (busy time), the idle gaps
between them labelled by what the host was doing, and device time by
kernel name.

An operation on the device is a kernel, a memory copy or a memory set; the
union of their intervals is the time in which the device ran something, not
the sum of their durations (two streams may overlap).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

def collect(prof) -> tuple:
    """(device, host) operations of a finished torch.profiler.profile, each
    a list of (name, start_us, end_us), the device's by start: read from the
    profiler's own event list, without writing a trace file."""
    from torch.autograd import DeviceType

    device, host = [], []
    events = prof.profiler.kineto_results.events()
    # a record_function range is mirrored on the device's timeline; it is no
    # operation of the device
    annotations = {e.name() for e in events
                   if e.device_type() != DeviceType.CUDA and e.is_user_annotation()}
    for e in events:
        start = e.start_ns() * 1e-3
        row = (e.name(), start, start + e.duration_ns() * 1e-3)
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
        elif not e.is_user_annotation() and e.name() not in annotations:
            device.append(row)
    return sorted(device, key=lambda x: x[1]), host


def union(intervals: list) -> list:
    """Merged [start, end] intervals of (name, start, end) sorted by start."""
    merged = []
    for _, s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(intervals: list) -> float:
    return sum(e - s for s, e in union(intervals))


def by_name(intervals: list) -> dict:
    out = defaultdict(float)
    for name, s, e in intervals:
        out[name] += e - s
    return dict(out)


def idle_gaps(device: list, host: list, window: tuple, longest: int = 4000) -> list:
    """The `longest` gaps in the device's union within window (start_us,
    end_us), each (label, seconds): the label is the innermost host
    operation that covers the gap's middle (of nested operations the one
    that started last), or 'no host op' where none does."""
    lo, hi = window
    gaps, cursor = [], lo
    for s, e in union(device):
        if e <= lo or s >= hi:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    host = sorted(host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        out.append((label, (e - s) * 1e-6))
    return out


def top(items: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]
