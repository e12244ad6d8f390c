"""device_idle_share: the share of the traced window (%) in which the device
ran nothing: 1 - the union of its operations' intervals over the window."""


def read(ctx):
    if not ctx["device_ops"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
