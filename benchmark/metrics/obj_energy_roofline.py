"""obj_energy_roofline: the object energy's (#4b, csrc/obj_energy.cu) share
of its roofline, in %: the least time of the calls' counted work (every
candidate's SDF at every point, from the shapes: benchmark/work.py) over the
device time of the kernels named here in the trace."""

KERNELS = ("obj_energy_wg_kernel",)


def read(ctx):
    device_s = sum(e - s for name, s, e in ctx["device_ops"]
                   if any(k in name for k in KERNELS)) * 1e-6
    if device_s <= 0:
        return None
    return 100.0 * ctx["work"]["obj_energy"]["least_s"] * ctx["chunk_frames"] / device_s
