"""device_busy_ms: milliseconds a frame of the loop (one frame of each of the S
sequences) in which the device ran something, from the traced window: the
union of its operations' intervals over the loop's frames. Steadier than the
host-clocked frame rate: the host's speed does not enter it unless the device
waits."""


def read(ctx):
    if not ctx["device_ops"] or not ctx["chunk_frames"]:
        return None
    return 1e3 * ctx["busy_s"] / ctx["chunk_frames"]
