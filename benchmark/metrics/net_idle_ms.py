"""net_idle_ms: the device's idle milliseconds a loop frame in the traced call whose
gap falls to a net's span (`net.handtracknet`, `net.iknet`, or a span nested under
one): the gaps the host leaves while it runs the nets (metrics/program_spans.py)."""

from benchmark.metrics import program_spans


def read(ctx):
    return program_spans.idle_ms_under(ctx, "net.")
