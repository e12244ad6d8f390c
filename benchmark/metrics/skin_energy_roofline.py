"""skin_energy_roofline: the skinned hand energy's (#7b,
csrc/hand_energy_skin.cu: the skinning pre-pass and the walk) share of its
roofline, in %: the least time of the calls' counted work (every candidate's
778 vertices skinned, their SDF and silhouette hits, from the shapes:
benchmark/work.py) over the device time of the kernels named here."""

KERNELS = ("skin_vertices_kernel", "hand_energy_rows_kernel", "hand_energy_skin_wg_kernel")


def read(ctx):
    device_s = sum(e - s for name, s, e in ctx["device_ops"]
                   if any(k in name for k in KERNELS)) * 1e-6
    if device_s <= 0:
        return None
    return 100.0 * ctx["work"]["skin_energy"]["least_s"] * ctx["chunk_frames"] / device_s
