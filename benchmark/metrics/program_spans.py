"""What the readers of the program's own spans share (hotrack_tpu_torch/utils/trace.py):
the spans of the traced call, and the device's idle gaps laid on them.

A run with --trace 1 traces one whole call on the device alone, ending in a device
synchronise, and then a labelled pass of a few frames with the host's operations. The
spans of the call are those that start within it: after the last device operation's end
less the call's window (the window runs from the call's start to the end of the
synchronise) and by that end (the labelled pass starts after the synchronise). Spans of
an earlier profile ended before the call started. Where the program records no spans
(a checkout without the module), every reader finds nothing and returns None.

An idle gap is a gap in the union of the call's device operations, between the first
and the last. It falls to the innermost span open on the host at its middle, the one that
started last: benchmark/trace.idle_gaps, with the spans in place of the host's
operations. A span's busy time is the union of the device operations clipped to its
start and end: the profiler puts the card's timestamps on the host's clock (within about
0.13 ms), and the kernels a span launches run within it where the host waits on the card
before the span ends.
"""

from __future__ import annotations

import bisect

from benchmark import trace


def call_spans(ctx) -> list:
    """The spans (hotrack_tpu_torch.utils.trace.Span) of the traced call."""
    if not ctx["device_ops"]:
        return []
    try:
        from hotrack_tpu_torch.utils import trace as program_trace
    except ImportError:
        return []
    end_us = max(e for _, _, e in ctx["device_ops"])
    start_us = end_us - ctx["window_s"] * 1e6
    return [s for s in program_trace.recorded() if start_us <= s.start_ns * 1e-3 <= end_us]


def idle_by_span(ctx):
    """[(span or None, idle s)], one a gap, longest first: the innermost span of the
    call open at the gap's middle, or None where none is; None where the call has no
    spans."""
    if "program_idle" not in ctx:   # the readers of one run share it
        spans = {s.id: s for s in call_spans(ctx)}
        ops = ctx["device_ops"]
        window = (ops[0][1], max(e for _, _, e in ops)) if ops else (0.0, 0.0)
        host = [(s.id, s.start_ns * 1e-3, s.end_ns * 1e-3) for s in spans.values()]
        gaps = trace.idle_gaps(ops, host, window, len(ops))
        ctx["program_idle"] = [(spans.get(i), sec) for i, sec in gaps] if spans else None
    return ctx["program_idle"]


def busy_ms_within(ctx, name: str):
    """The device's busy ms a loop frame within the call's spans named `name`: the
    union of the call's device operations, clipped to each span's start and end on the
    host's clock; None where the call has no such span."""
    spans = [s for s in call_spans(ctx) if s.name == name]
    if not spans or not ctx["chunk_frames"]:
        return None
    merged = trace.union(ctx["device_ops"])
    starts = [lo for lo, _ in merged]
    busy_us = 0.0
    for s in spans:
        lo, hi = s.start_ns * 1e-3, s.end_ns * 1e-3
        for a, b in merged[max(bisect.bisect_right(starts, lo) - 1, 0):]:
            if a >= hi:
                break
            busy_us += max(0.0, min(b, hi) - max(a, lo))
    return 1e-3 * busy_us / ctx["chunk_frames"]


def idle_ms_under(ctx, prefix: str):
    """The device's idle ms a loop frame whose gap falls to a span whose name starts
    with `prefix`, or to a span nested under one; None where the call has no spans."""
    idle = idle_by_span(ctx)
    if idle is None or not ctx["chunk_frames"]:
        return None
    by_id = {s.id: s for s in call_spans(ctx)}

    def under(s):
        while s is not None:
            if s.name.startswith(prefix):
                return True
            s = by_id.get(s.parent)
        return False

    return 1e3 * sum(sec for s, sec in idle if under(s)) / ctx["chunk_frames"]
