"""launches_per_frame: operations the device ran in the traced window (kernels,
copies, sets; torch.profiler's device events) a frame of the loop (one frame of
each of the S sequences). A count: what fusing the per-iteration chains lowers."""


def read(ctx):
    if not ctx["device_ops"] or not ctx["chunk_frames"]:
        return None
    return len(ctx["device_ops"]) / ctx["chunk_frames"]
