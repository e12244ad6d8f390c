"""opt_iter_host_ms: the host's mean milliseconds an iteration of the per-frame pose
optimiser in the traced call: the program's `opt.particle.iter` spans opened directly in
`opt.obj_pose` or `opt.hand_pose` (the frame-0 shape optimiser's are left out), from
their start to their end on the host's clock. What a CUDA graph of an iteration
shortens."""

from benchmark.metrics import program_spans

POSE = ("opt.obj_pose", "opt.hand_pose")


def read(ctx):
    spans = program_spans.call_spans(ctx)
    names = {s.id: s.name for s in spans}
    ms = [1e-6 * (s.end_ns - s.start_ns) for s in spans
          if s.name == "opt.particle.iter" and names.get(s.parent) in POSE]
    return sum(ms) / len(ms) if ms else None
