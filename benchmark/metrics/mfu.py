"""mfu: the least time the window's counted model work needs at the card's
published peaks (benchmark/work.py; the SDF queries of the energy kernels, in
3xTF32 at a third of the TF32 peak) over the traced window's length, in %."""


def read(ctx):
    least = ctx["work"]["model"]["least_s"] * ctx["chunk_frames"]
    if least <= 0 or ctx["window_s"] <= 0 or not ctx["device_ops"]:
        return None
    return 100.0 * least / ctx["window_s"]
