"""handnet_ms: HandTrackNet's device milliseconds a loop frame (one frame of each of
the S sequences) in the traced call: the device's busy time within the program's
`net.handtracknet` spans (metrics/program_spans.py), summed over the call. The idle
time under those spans is net_idle_ms's, not this metric's."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.busy_ms_within(ctx, "net.handtracknet")
