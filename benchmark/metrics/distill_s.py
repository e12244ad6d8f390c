"""distill_s: seconds of the port's SDF distillation in set-up
(`sdf/distill.distill_sdf_volume`), the benchmark's own span around the call,
on the host's clock, ending in a device synchronise."""


def read(ctx):
    return ctx["spans"].get("distill_s")
